# -*- coding: utf-8 -*-
"""Matrix-free application of Kronecker products (host, numpy; a copy of
:mod:`pyiga_tpu.kronecker`).  Dense factors reduce to
:func:`~pyiga_tpu_torch.tensor.apply_tprod`; sparse matrices and
LinearOperators go through per-axis matricized applications.
"""

import numpy as np
import scipy.sparse.linalg

from . import tensor


def apply_kronecker(ops, x):
    """Apply ``kron(ops[0], ..., ops[-1])`` to the vector or multi-vector
    `x` without forming the Kronecker product."""
    if all(isinstance(A, np.ndarray) for A in ops):
        return _apply_kronecker_dense(ops, x)
    ops = [scipy.sparse.linalg.aslinearoperator(B) for B in ops]
    return _apply_kronecker_linops(ops, x)


def _apply_kronecker_dense(ops, x):
    shape_in = tuple(op.shape[1] for op in ops)
    shape_out = (int(np.prod([op.shape[0] for op in ops])),) + x.shape[1:]
    if x.ndim not in (1, 2):
        raise ValueError('only vectors or matrices allowed as right-hand '
                         'sides')
    if x.ndim == 2 and x.shape[1] > 1:
        shape_in = shape_in + (x.shape[1],)
    X = x.reshape(shape_in)
    return tensor.apply_tprod(ops, X).reshape(shape_out)


def _apply_kronecker_linops(ops, x):
    """Apply a Kronecker product of (possibly sparse) linear operators by
    reshaping into a tensor and applying one mode-k product per factor."""
    if len(ops) < 1:
        raise ValueError('empty Kronecker product')
    shape_in = tuple(op.shape[1] for op in ops)
    shape_out = (int(np.prod([op.shape[0] for op in ops])),) + x.shape[1:]
    if int(np.prod(shape_in)) != x.shape[0]:
        raise ValueError('wrong size for input vector')
    X = np.asarray(x).reshape(shape_in + x.shape[1:])
    for k, op in enumerate(ops):
        X = tensor.modek_tprod(op, k, X)
    return X.reshape(shape_out)
