# -*- coding: utf-8 -*-
"""Mode products of dense tensors (host, numpy): a copy of the part of
:mod:`pyiga_tpu.tensor` that the Kronecker operators, interpolation and
L2 projection use.  :func:`apply_tprod` applies one operator per axis —
a dense or sparse matrix or a LinearOperator — through explicit
matricization (``unfold @ fold``).  The low-rank formats and
approximation algorithms of the JAX module are not ported yet.
"""

import numpy as np


def matricize(X, k):
    """Mode-`k` unfolding: a ``(shape[k], prod(other dims))`` matrix whose
    rows are the mode-`k` fibers, remaining axes kept in original order."""
    return np.moveaxis(X, k, 0).reshape(X.shape[k], -1)


def _fold(M, k, shape):
    """Inverse of :func:`matricize`: fold a ``(m, prod(other))`` matrix back
    into a tensor of the given shape with ``shape[k]`` replaced by `m`."""
    inter = (M.shape[0],) + tuple(shape[:k]) + tuple(shape[k + 1:])
    return np.moveaxis(np.asarray(M).reshape(inter), 0, k)


def modek_tprod(B, k, X):
    """Mode-`k` product: apply the matrix (or sparse matrix /
    LinearOperator) `B` along axis `k` of the tensor `X`."""
    return _fold(B @ matricize(X, k), k, X.shape)


def apply_tprod(ops, A):
    """Apply one operator per axis (``None`` = identity) to the tensor `A`.

    Equivalent to multiplying ``vec(A)`` by ``kron(ops[0], ops[1], ...)``.
    Axes beyond ``len(ops)`` are untouched.  Structured tensors that know
    how to apply per-axis operators to themselves (``nway_prod``) are
    delegated to."""
    if hasattr(A, 'nway_prod'):
        return A.nway_prod(ops)
    Y = np.asanyarray(A)
    for k, B in enumerate(ops):
        if B is not None:
            Y = modek_tprod(B, k, Y)
    return Y


def fro_norm(X):
    """Frobenius norm of an array or structured tensor."""
    try:
        return X.norm()
    except AttributeError:
        return np.linalg.norm(np.ravel(X))


def asarray(X):
    """Densify a structured tensor; pass numpy arrays/scalars through."""
    try:
        return X.asarray()
    except AttributeError:
        return np.asanyarray(X)
