# -*- coding: utf-8 -*-
"""Matrix-free matvec on the compact multilevel data tensor (port of
:mod:`pyiga_tpu.ops.mlmatvec`):

    y[i_1..i_d] = sum_{s: i(s)=i} data[s_1..s_d] * x[j(s_1)..j(s_d)]

as one gather per axis (``index_select``), an elementwise multiply and
one scatter-add per axis (``index_add_``).  The JAX package runs this as
plain XLA ops outside Pallas, so plain torch ops are its counterpart.
"""

import numpy as np
import torch

from ..config import resolve_device


def ml_matvec(data, bidx, shape_out, shape_in, x, sorted_rows=None):
    """Apply the compact multilevel matrix to `x`.

    Args:
        data: compact tensor ``(nnz_1, ..., nnz_d)``.
        bidx: per-level ``(nnz_k, 2)`` (i, j) pairs, as LongTensors on the
            device of `data` or as numpy arrays.
        shape_out / shape_in: per-level output/input sizes.
        x: input tensor of shape `shape_in` (or raveled).
        sorted_rows: the JAX package's per-level hint that the row
            indices are sorted (for its segment sums); accepted for API
            compatibility and ignored: ``index_add_`` takes any order.

    Returns the output tensor of shape `shape_out`."""
    d = len(bidx)
    bidx = [_index(bx, data.device) for bx in bidx]
    t = x.reshape(tuple(shape_in))
    for k in range(d):
        t = torch.index_select(t, k, bidx[k][:, 1])
    t = t * data
    for k in range(d):
        shape = list(t.shape)
        shape[k] = shape_out[k]
        t = torch.zeros(shape, dtype=t.dtype, device=t.device).index_add_(
            k, bidx[k][:, 0], t)
    return t


def _index(bx, device):
    if isinstance(bx, torch.Tensor):
        return bx.to(device)
    return torch.as_tensor(np.asarray(bx, dtype=np.int64), device=device)


class MLMatvecOperator:
    """Matvec over a compact data tensor on its device: a callable on
    raveled vectors with ``shape``, ``ns`` (output dofs per axis),
    ``dtype`` and ``device`` (so that
    :class:`~pyiga_tpu_torch.ops.matfree.RestrictedOperator` can restrict
    it)."""

    def __init__(self, data, structure):
        self.data = data
        self.bidx = [_index(bx, data.device) for bx in structure.bidx]
        self.shape_out = tuple(b[0] for b in structure.bs)
        self.shape_in = tuple(b[1] for b in structure.bs)
        self.shape = structure.shape
        self.ns = self.shape_out
        self.dtype, self.device = data.dtype, data.device

    def matvec(self, x):
        return ml_matvec(self.data, self.bidx, self.shape_out,
                         self.shape_in, x).reshape(-1)

    __call__ = matvec


def make_ml_matvec(mlm, device=None, dtype=torch.float64):
    """Device matvec operator over a host
    :class:`~pyiga_tpu_torch.mlmatrix.MLMatrix` (its data uploaded to
    `device`)."""
    data = torch.as_tensor(mlm.data, dtype=dtype,
                           device=resolve_device(device))
    return MLMatvecOperator(data, mlm.structure)
