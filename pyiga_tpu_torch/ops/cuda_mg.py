# -*- coding: utf-8 -*-
"""Kernel K6: one whole local-multigrid V-cycle plus the masked residual
norm (counterpart of :mod:`pyiga_tpu.ops.mg_pallas`), beside its plain
PyTorch version.

:class:`VCycleOperands` holds a hierarchy's operands on one device: per
level the padded-ELL matrix ``A``; above the coarsest level the smoothing
set ``S``, the ELL rows ``A[S, :]``, the dense triangular inverses ``T``
of the pre- and post-smoothing sweep directions and the ELL prolongator
``P`` into the level with its transpose ``PT``; on the coarsest level the
smoothing set ``ind0`` and the dense inverse ``Cinv`` of its block.

:func:`vcycle` maps ``(x, f)`` to the next iterate and ``||(f - A x) *
mask||^2``.  On a CPU tensor it runs :func:`vcycle_plain`; on a CUDA
tensor it launches ``vcycle_kernel`` (``csrc/mg.cu``) once, or raises.
"""

import ctypes

import numpy as np
import torch

from .. import _cuda
from ..config import DTYPE

# layout of the int64 descriptor the kernel reads (csrc/mg.cu)
_HDR, _LV = 16, 32


def _ell(cols, vals, device):
    return (torch.as_tensor(np.ascontiguousarray(cols), dtype=torch.int32,
                            device=device),
            torch.as_tensor(np.ascontiguousarray(vals), dtype=DTYPE,
                            device=device))


class VCycleOperands:
    """The operands of one V-cycle hierarchy on `device` (see the module
    docstring; `levels` as built by :class:`~pyiga_tpu_torch.ops.mg.
    DeviceMGSolver`).  On a CUDA device it also holds the kernel's
    descriptor: the operands' addresses and sizes, and the offsets of
    the per-level vectors in the work buffer."""

    def __init__(self, levels, ind0, Cinv, mask, steps, device):
        self.device = device
        self.L = len(levels)
        self.steps = int(steps)
        self.n = [lev['A'][0].shape[0] for lev in levels]

        def dense(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=DTYPE,
                                   device=device)
        self.levels = []
        for lev in levels:
            dl = {'A': _ell(*lev['A'], device)}
            if 'S' in lev:
                dl['S'] = torch.as_tensor(lev['S'], dtype=torch.int32,
                                          device=device)
                dl['AS'] = _ell(*lev['AS'], device)
                uploaded = {}       # a T shared by pre and post goes once
                for T in lev['pre'] + lev['post']:
                    if id(T) not in uploaded:
                        uploaded[id(T)] = dense(T)
                for key in ('pre', 'post'):
                    dl[key] = [uploaded[id(T)] for T in lev[key]]
                dl['P'] = _ell(*lev['P'], device)
                dl['PT'] = _ell(*lev['PT'], device)
            self.levels.append(dl)
        self.ind0 = torch.as_tensor(ind0, dtype=torch.int32, device=device)
        self.Cinv = dense(Cinv)
        self.mask = dense(mask)
        self.npre = len(self.levels[1]['pre']) if self.L > 1 else 0
        self.npost = len(self.levels[1]['post']) if self.L > 1 else 0
        self.desc = self.work_size = None
        if device.type == 'cuda':
            self._build_desc()

    def _build_desc(self):
        """The kernel's descriptor (int64 words, see ``csrc/mg.cu``) and
        the work buffer size.  Work layout: ``x`` and ``rhs`` of every
        level below the finest, then ``rS`` (the largest smoothing set)
        and ``r`` (the largest level)."""
        L = self.L
        w = [0] * (_HDR + _LV * L)
        off = 0
        offsets = []
        for lv in range(L - 1):
            offsets.append((off, off + self.n[lv]))
            off += 2 * self.n[lv]
        m_max = max([int(lev['S'].shape[0]) for lev in self.levels[1:]]
                    + [1])
        w[0:10] = [L, self.steps, self.npre, self.npost,
                   int(self.ind0.shape[0]), self.ind0.data_ptr(),
                   self.Cinv.data_ptr(), self.mask.data_ptr(), off,
                   off + m_max]
        self.work_size = off + m_max + max(self.n)
        for lv, lev in enumerate(self.levels):
            b = _HDR + _LV * lv
            cols, vals = lev['A']
            w[b:b + 4] = [self.n[lv], cols.data_ptr(), vals.data_ptr(),
                          cols.shape[1]]
            if lv > 0:
                cols, vals = lev['AS']
                w[b + 4:b + 9] = [lev['S'].shape[0], lev['S'].data_ptr(),
                                  cols.data_ptr(), vals.data_ptr(),
                                  cols.shape[1]]
                for k, T in enumerate(lev['pre']):
                    w[b + 9 + k] = T.data_ptr()
                for k, T in enumerate(lev['post']):
                    w[b + 11 + k] = T.data_ptr()
                for j, key in ((13, 'P'), (16, 'PT')):
                    cols, vals = lev[key]
                    w[b + j:b + j + 3] = [cols.data_ptr(), vals.data_ptr(),
                                          cols.shape[1]]
            if lv < L - 1:
                w[b + 19:b + 21] = offsets[lv]
        self.desc = torch.tensor(w, dtype=torch.int64, device=self.device)


################################################################################
# the plain version
################################################################################

def _ell_mv(ell, x):
    cols, vals = ell
    return (vals * x.index_select(0, cols.reshape(-1)).reshape(cols.shape)
            ).sum(dim=-1)


def _smooth(ops, lev, Ts, x, b):
    """`steps` applications of the sweep passes `Ts` over the level's
    smoothing set, in place: ``x_S += T (b_S - A[S, :] x)``."""
    S = lev['S']
    for _ in range(ops.steps):
        for T in Ts:
            r = b.index_select(0, S) - _ell_mv(lev['AS'], x)
            x.index_add_(0, S, T @ r)


def vcycle_plain(ops, x, f):
    """Plain PyTorch version of :func:`vcycle` (same inputs and
    outputs), in the V-cycle's order of steps."""
    L = ops.L
    xs, rhss = [None] * L, [None] * L
    xs[L - 1], rhss[L - 1] = x.clone(), f
    for lv in range(L - 1, 0, -1):
        lev = ops.levels[lv]
        _smooth(ops, lev, lev['pre'], xs[lv], rhss[lv])
        r = rhss[lv] - _ell_mv(lev['A'], xs[lv])
        rhss[lv - 1] = _ell_mv(lev['PT'], r)
        xs[lv - 1] = torch.zeros_like(rhss[lv - 1])
    xs[0] = torch.zeros_like(rhss[0]).index_copy_(
        0, ops.ind0.long(), ops.Cinv @ rhss[0].index_select(0, ops.ind0))
    for lv in range(1, L):
        lev = ops.levels[lv]
        xs[lv] += _ell_mv(lev['P'], xs[lv - 1])
        _smooth(ops, lev, lev['post'], xs[lv], rhss[lv])
    r = (f - _ell_mv(ops.levels[L - 1]['A'], xs[L - 1])) * ops.mask
    return xs[L - 1], torch.dot(r, r)


################################################################################
# the kernel
################################################################################

_GRID = {}


def _grid_blocks(device):
    """Blocks of the cooperative grid on `device` (all co-resident),
    cached per device."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _GRID:
        blocks = ctypes.c_int(0)
        with torch.cuda.device(idx):
            err = _cuda.library().pyiga_vcycle_grid(idx,
                                                    ctypes.byref(blocks))
        _cuda.check(err, 'vcycle')
        _GRID[idx] = blocks.value
    return _GRID[idx]


def vcycle(ops, x, f):
    """K6: one V-cycle of the hierarchy `ops` (a :class:`VCycleOperands`)
    from the iterate `x` for the right-hand side `f` (both ``(n,)``
    float64 on the operands' device).  Returns the new iterate and the
    masked squared residual norm ``||(f - A x) * mask||^2`` (a 0-dim
    tensor).  A CPU tensor runs :func:`vcycle_plain`; a CUDA tensor
    launches the kernel once."""
    if x.device.type == 'cpu':
        return vcycle_plain(ops, x, f)
    if not x.is_cuda:
        raise ValueError('vcycle: unsupported device %s' % x.device)
    _cuda.require(x, 'x', DTYPE, 1)
    _cuda.require(f, 'f', DTYPE, 1)
    n = ops.n[-1]
    if x.shape != (n,) or f.shape != (n,) or ops.desc is None \
            or x.device != ops.desc.device or f.device != x.device:
        raise ValueError('vcycle: x %s / f %s on %s do not match the '
                         'hierarchy (n=%d on %s)'
                         % (tuple(x.shape), tuple(f.shape), x.device, n,
                            ops.device))
    xo = x.clone()
    work = torch.empty(ops.work_size, dtype=DTYPE, device=x.device)
    res2 = torch.empty(1, dtype=DTYPE, device=x.device)
    blocks = _grid_blocks(x.device)
    with torch.cuda.device(x.device):
        err = _cuda.library().pyiga_vcycle_f64(
            ops.desc.data_ptr(), xo.data_ptr(), f.data_ptr(),
            work.data_ptr(), res2.data_ptr(), blocks, _cuda.stream_of(x))
    _cuda.check(err, 'vcycle')
    _cuda.LAUNCHES['vcycle'] += 1
    return xo, res2[0]
