# -*- coding: utf-8 -*-
"""Restriction of an operator to a free-dof subset (port of the parts of
:mod:`pyiga_tpu.ops.matfree` the solver path needs).

A box-shaped free set — the interior dofs of an all-Dirichlet problem —
restricts by slicing, with no index tensor at all.
"""

import numpy as np
import torch


def box_restriction(free_dofs, ns):
    """If the raveled `free_dofs` indices form an axis-aligned box in the
    `ns` grid (e.g. the interior dofs of an 'all'-Dirichlet problem), return
    ``(los, box_shape)``; else None."""
    free = np.asarray(free_dofs)
    if free.ndim != 1 or len(free) == 0:
        return None
    idx = np.unravel_index(free, ns)
    axes = [np.unique(ix) for ix in idx]
    shape = tuple(len(a) for a in axes)
    if len(free) != int(np.prod(shape)):
        return None
    for a in axes:
        if a[-1] - a[0] + 1 != len(a):
            return None
    grid = np.stack(np.meshgrid(*axes, indexing='ij'), 0).reshape(len(ns), -1)
    if not np.array_equal(free, np.ravel_multi_index(tuple(grid), ns)):
        return None
    return tuple(int(a[0]) for a in axes), shape


class RestrictedOperator:
    """Restrict an operator on the full TP space (a callable on raveled
    vectors with attributes ``ns``, ``dtype`` and ``device``) to the
    `free_dofs` subset: the input is placed into a zero full vector, the
    operator applied, and the free rows taken — ``A[free][:, free]`` for a
    homogeneous Dirichlet elimination."""

    def __init__(self, op, free_dofs, n_full=None):
        self.op = op
        self.ns = tuple(op.ns)
        self.n_full = int(np.prod(self.ns)) if n_full is None else n_full
        self.shape = (len(free_dofs), len(free_dofs))
        self.dtype, self.device = op.dtype, op.device
        box = box_restriction(free_dofs, self.ns)
        if box is not None:
            los, bshape = box
            self._box = tuple(slice(lo, lo + s) for lo, s in zip(los, bshape))
            self._free = None
        else:
            self._box = None
            self._free = torch.as_tensor(np.asarray(free_dofs, np.int64),
                                         device=op.device)

    def matvec(self, x):
        if self._box is not None:
            xf = torch.zeros(self.ns, dtype=x.dtype, device=x.device)
            xf[self._box] = x.reshape(xf[self._box].shape)
            y = self.op(xf.reshape(-1))
            return y.reshape(self.ns)[self._box].reshape(-1)
        xf = torch.zeros(self.n_full, dtype=x.dtype, device=x.device)
        xf[self._free] = x
        return self.op(xf)[self._free]

    __call__ = matvec
