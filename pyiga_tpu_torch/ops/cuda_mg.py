# -*- coding: utf-8 -*-
"""Kernel K6: the local-multigrid solve loop, whole V-cycles and the
masked residual norm in one launch (counterpart of
:mod:`pyiga_tpu.ops.mg_pallas`), beside its plain PyTorch version.

:class:`VCycleOperands` holds a hierarchy's operands on one device: per
level the padded-ELL matrix ``A``; above the coarsest level the smoothing
set ``S``, the ELL rows ``A[S, :]``, the triangular inverses ``T`` of the
pre- and post-smoothing sweep directions (each a :class:`DenseRows`: the
rows zero-padded to a multiple of 4, each row's nonzero extent and the
rows ordered longest first) and the ELL prolongator ``P`` into the level
with its transpose ``PT``; on the coarsest level the smoothing set
``ind0`` and the dense inverse ``Cinv`` of its block.

:func:`vcycle_solve` runs cycles from zero until the masked residual
drops by ``tol`` (the test of :meth:`~pyiga_tpu_torch.ops.mg.
DeviceMGSolver.solve`); :func:`vcycle` maps ``(x, f)`` to the next iterate
and ``||(f - A x) * mask||^2``.  On a CPU tensor each runs its plain
version (:func:`vcycle_solve_plain`, :func:`vcycle_plain`); on a CUDA
tensor each launches ``vcycle_kernel`` (``csrc/mg.cu``) once, or raises.
"""

import ctypes
import math

import numpy as np
import torch

from .. import _cuda
from ..config import DTYPE

# layout of the int64 descriptor the kernel reads (csrc/mg.cu)
_HDR, _LV = 16, 40
_V_SPOS, _V_PRE, _V_POST = 17, 20, 28
# 32-byte sectors of float64: row strides and extents are multiples of it
_SECTOR = 4


def _ell(cols, vals, device):
    return (torch.as_tensor(np.ascontiguousarray(cols), dtype=torch.int32,
                            device=device),
            torch.as_tensor(np.ascontiguousarray(vals), dtype=DTYPE,
                            device=device))


def row_extents(T):
    """Per row of the dense ``(m, ld)`` array `T` (``ld`` a multiple of
    4) the column range ``[lo, hi)`` that holds its nonzeros, widened to
    32-byte sectors (multiples of 4); an all-zero row (a dead row of
    :func:`~pyiga_tpu_torch.ops.mg._tri_inverse`) gets ``[0, 0)``.
    Returns ``(ext (m, 2) int32, entries)``: ``entries`` counts the
    entries between each row's first and last nonzero, the occupied part
    the kernel cannot skip."""
    nz = T != 0
    m, ld = T.shape
    live = nz.any(axis=1)
    first = np.argmax(nz, axis=1)
    last = ld - 1 - np.argmax(nz[:, ::-1], axis=1)
    lo = np.where(live, first // _SECTOR * _SECTOR, 0)
    hi = np.where(live, -(-(last + 1) // _SECTOR) * _SECTOR, 0)
    entries = int(np.where(live, last + 1 - first, 0).sum())
    return np.stack([lo, hi], axis=1).astype(np.int32), entries


class DenseRows:
    """A dense matrix as K6 reads it: ``vals`` ``(m, ld)`` with the rows
    zero-padded to ``ld``, a multiple of 4, and ``rows`` ``(m, 4)`` int32,
    one ``(row, lo, hi, x index)`` per row in the order the kernel takes
    them.  With `extents`, ``[lo, hi)`` is the row's nonzero extent
    (:func:`row_extents`) and the rows come longest first (stable), so the
    kernel reads only the occupied part and deals the rows out evenly;
    without, every row is ``[0, ld)`` in order.  ``dst[row]`` is the
    entry of x the row updates.  ``mat`` is the ``(m, m)`` matrix itself;
    ``entries`` counts the occupied entries."""

    def __init__(self, A, dst, device, extents=True):
        m = A.shape[0]
        ld = -(-m // _SECTOR) * _SECTOR
        host = np.zeros((m, ld))
        host[:, :m] = A
        self.m, self.ld = m, ld
        self.vals = torch.as_tensor(host, dtype=DTYPE, device=device)
        self.mat = self.vals[:, :m]
        if extents:
            ext, self.entries = row_extents(host)
            order = np.argsort(ext[:, 0] - ext[:, 1], kind='stable')
        else:
            ext = np.tile(np.array([0, ld], dtype=np.int32), (m, 1))
            self.entries, order = m * m, np.arange(m)
        rows = np.stack([order, ext[order, 0], ext[order, 1],
                         np.asarray(dst)[order]], axis=1)
        self.rows = torch.as_tensor(rows.astype(np.int32), device=device)

    def words(self):
        """The kernel's four descriptor words."""
        return [self.vals.data_ptr(), self.ld, self.rows.data_ptr(), 0]


class VCycleOperands:
    """The operands of one V-cycle hierarchy on `device` (see the module
    docstring; `levels` as built by :class:`~pyiga_tpu_torch.ops.mg.
    DeviceMGSolver`).  On a CUDA device it also holds the kernel's
    descriptor (the operands' addresses and sizes, and the offsets of the
    per-level vectors in the work buffer) and the work buffer."""

    def __init__(self, levels, ind0, Cinv, mask, steps, device):
        self.device = device
        self.L = len(levels)
        self.steps = int(steps)
        self.n = [lev['A'][0].shape[0] for lev in levels]
        self.levels = []
        for lev in levels:
            dl = {'A': _ell(*lev['A'], device)}
            if 'S' in lev:
                dl['S'] = torch.as_tensor(lev['S'], dtype=torch.int32,
                                          device=device)
                # each dof's position in S (-1: not smoothed)
                spos = np.full(lev['A'][0].shape[0], -1, dtype=np.int32)
                spos[lev['S']] = np.arange(len(lev['S']), dtype=np.int32)
                dl['spos'] = torch.as_tensor(spos, device=device)
                dl['AS'] = _ell(*lev['AS'], device)
                uploaded = {}       # a T shared by pre and post goes once
                for T in lev['pre'] + lev['post']:
                    if id(T) not in uploaded:
                        uploaded[id(T)] = DenseRows(T, lev['S'], device)
                for key in ('pre', 'post'):
                    dl[key] = [uploaded[id(T)] for T in lev[key]]
                dl['P'] = _ell(*lev['P'], device)
                dl['PT'] = _ell(*lev['PT'], device)
            self.levels.append(dl)
        self.ind0 = torch.as_tensor(ind0, dtype=torch.int32, device=device)
        self.Cinv = DenseRows(Cinv, ind0, device, extents=False)
        self.mask = torch.as_tensor(np.ascontiguousarray(mask), dtype=DTYPE,
                                    device=device)
        self.npre = len(self.levels[1]['pre']) if self.L > 1 else 0
        self.npost = len(self.levels[1]['post']) if self.L > 1 else 0
        self.desc = self.work = None
        if device.type == 'cuda':
            self._build_desc()

    def _build_desc(self):
        """The kernel's descriptor (int64 words, see ``csrc/mg.cu``) and
        the work buffer.  Work layout: ``x`` and ``rhs`` of every level
        below the finest, then ``rS`` (the largest smoothing set) and
        ``r`` (the largest level)."""
        L = self.L
        w = [0] * (_HDR + _LV * L)
        off = 0
        offsets = []
        for lv in range(L - 1):
            offsets.append((off, off + self.n[lv]))
            off += 2 * self.n[lv]
        m_max = max([int(lev['S'].shape[0]) for lev in self.levels[1:]]
                    + [1])
        # the longest vector a dense pass stages in shared memory
        self.vec = max([T.ld for lev in self.levels
                        for T in lev.get('pre', []) + lev.get('post', [])]
                       + [self.Cinv.ld])
        w[0:10] = [L, self.steps, self.npre, self.npost,
                   int(self.ind0.shape[0]), self.ind0.data_ptr(),
                   self.mask.data_ptr(), off, off + m_max, self.vec]
        w[10:14] = self.Cinv.words()
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
                w[b + _V_SPOS] = lev['spos'].data_ptr()
                for j, key in ((9, 'P'), (12, 'PT')):
                    cols, vals = lev[key]
                    w[b + j:b + j + 3] = [cols.data_ptr(), vals.data_ptr(),
                                          cols.shape[1]]
                for base, key in ((_V_PRE, 'pre'), (_V_POST, 'post')):
                    for k, T in enumerate(lev[key]):
                        w[b + base + 4 * k:b + base + 4 * k + 4] = T.words()
            if lv < L - 1:
                w[b + 15:b + 17] = offsets[lv]
        self.desc = torch.tensor(w, dtype=torch.int64, device=self.device)
        self.work = torch.empty(off + m_max + max(self.n), dtype=DTYPE,
                                device=self.device)


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
            x.index_add_(0, S, T.mat @ r)


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
        0, ops.ind0.long(), ops.Cinv.mat @ rhss[0].index_select(0, ops.ind0))
    for lv in range(1, L):
        lev = ops.levels[lv]
        xs[lv] += _ell_mv(lev['P'], xs[lv - 1])
        _smooth(ops, lev, lev['post'], xs[lv], rhss[lv])
    r = (f - _ell_mv(ops.levels[L - 1]['A'], xs[L - 1])) * ops.mask
    return xs[L - 1], torch.dot(r, r)


def vcycle_solve_plain(ops, f, res0, tol, maxiter):
    """Plain version of :func:`vcycle_solve`: the host loop over
    :func:`vcycle_plain`, one host read of the residual a cycle."""
    x = torch.zeros_like(f)
    hist = []
    res, it = np.float64(res0), 0
    with np.errstate(divide='ignore', invalid='ignore'):
        while not (res / res0 < tol) and it < maxiter:
            x, res2 = vcycle_plain(ops, x, f)
            hist.append(res2.item())
            res = np.float64(math.sqrt(hist[-1]))
            it += 1
    return x, it, res, torch.tensor(hist, dtype=DTYPE, device=f.device)


################################################################################
# the kernel
################################################################################

_BLOCKS = {}


def _launch_shape(ops, device):
    """Blocks and shared-memory bytes of a launch of `ops` on `device`,
    cached per (device, shared memory)."""
    lib = _cuda.library()
    smem = lib.pyiga_vcycle_smem(ops.vec)
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if (idx, smem) not in _BLOCKS:
        blocks = ctypes.c_int(0)
        with torch.cuda.device(idx):
            err = lib.pyiga_vcycle_blocks(idx, smem, ctypes.byref(blocks))
        _cuda.check(err, 'vcycle')
        _BLOCKS[idx, smem] = blocks.value
    return _BLOCKS[idx, smem], smem


def phase_names(ops, first=False):
    """Names of the barriers of one cycle of `ops` (the first cycle of a
    launch with `first`), in the order the kernel's trace records them
    (``csrc/mg.cu`` ``cycle``): each names the step that ends at it."""
    fuse = ops.steps > 0 and ops.npre > 0
    names = []
    for lv in range(ops.L - 1, 0, -1):
        for s in range(ops.steps):
            for k in range(ops.npre):
                if not (fuse and (lv < ops.L - 1 or not first) and s == 0
                        and k == 0):
                    names.append('L%d pre rS' % lv)
                names.append('L%d pre T' % lv)
        names += ['L%d residual' % lv, 'L%d restrict' % lv]
    if ops.L == 1:
        names.append('L0 zero')
    names.append('L0 Cinv')
    for lv in range(1, ops.L):
        names.append('L%d prolong' % lv)
        for s in range(ops.steps):
            for k in range(ops.npost):
                names += ['L%d post rS' % lv, 'L%d post T' % lv]
    names.append('final residual')
    if ops.L > 1 and not fuse:
        names.append('res2 sum')
    return names


def _check(ops, x, f):
    _cuda.require(x, 'x', DTYPE, 1)
    _cuda.require(f, 'f', DTYPE, 1)
    n = ops.n[-1]
    if x.shape != (n,) or f.shape != (n,) or ops.desc is None \
            or x.device != ops.desc.device or f.device != x.device:
        raise ValueError('vcycle: x %s / f %s on %s do not match the '
                         'hierarchy (n=%d on %s)'
                         % (tuple(x.shape), tuple(f.shape), x.device, n,
                            ops.device))


def launch_solve(ops, x, f, res0, tol, maxiter, trace=None):
    """Launch K6 once on CUDA tensors, without reading anything back:
    cycles on `x` in place from its value until ``res / res0 < tol`` or
    `maxiter` cycles.  Returns ``(hist, info)``: the ``(maxiter,)``
    per-cycle ``res2`` (written up to the cycle count) and ``info = [cycles,
    res]`` on the device.  `trace`, an int64 tensor, receives the
    ``%globaltimer`` (ns) of block 0 at the start and after each barrier,
    as far as it reaches (:func:`phase_names` names one cycle's)."""
    _check(ops, x, f)
    maxiter = int(maxiter)
    if maxiter < 0 or maxiter >= 2 ** 31:
        raise ValueError('vcycle: maxiter %d out of range' % maxiter)
    if trace is not None:
        _cuda.require(trace, 'trace', torch.int64, 1)
    hist = torch.empty(max(maxiter, 1), dtype=DTYPE, device=x.device)
    info = torch.empty(2, dtype=DTYPE, device=x.device)
    blocks, smem = _launch_shape(ops, x.device)
    with _cuda.device_of(x):
        err = _cuda.library().pyiga_vcycle_f64(
            ops.desc.data_ptr(), x.data_ptr(), f.data_ptr(),
            ops.work.data_ptr(), hist.data_ptr(), info.data_ptr(),
            float(res0), float(tol), maxiter,
            0 if trace is None else trace.data_ptr(),
            0 if trace is None else trace.numel(), blocks, smem,
            _cuda.stream_of(x))
    _cuda.check(err, 'vcycle')
    _cuda.LAUNCHES['vcycle'] += 1
    return hist, info


def vcycle_solve(ops, f, res0, tol, maxiter):
    """K6: the local-MG solve of the hierarchy `ops` (a
    :class:`VCycleOperands`) for the right-hand side `f` ((n,) float64 on
    the operands' device) from zero: cycles until the masked residual
    ``res = sqrt(res2)`` satisfies ``res / res0 < tol`` or `maxiter`
    cycles have run (``res0``: the masked norm of `f`).  Returns ``(x,
    cycles, res, hist)``: the iterate, the cycle count and the last
    ``res`` (host numbers) and the ``(cycles,)`` per-cycle ``res2``.  A
    CPU tensor runs :func:`vcycle_solve_plain`; a CUDA tensor launches the
    kernel once, and the host reads the count and ``res`` once."""
    if f.device.type == 'cpu':
        return vcycle_solve_plain(ops, f, res0, tol, maxiter)
    if not f.is_cuda:
        raise ValueError('vcycle_solve: unsupported device %s' % f.device)
    x = torch.zeros_like(f)
    hist, info = launch_solve(ops, x, f, res0, tol, maxiter)
    it, res = info.tolist()
    return x, int(it), np.float64(res), hist[:int(it)]


def vcycle(ops, x, f):
    """K6, one V-cycle of the hierarchy `ops` (a :class:`VCycleOperands`)
    from the iterate `x` for the right-hand side `f` (both ``(n,)``
    float64 on the operands' device).  Returns the new iterate and the
    masked squared residual norm ``||(f - A x) * mask||^2`` (a 0-dim
    tensor).  A CPU tensor runs :func:`vcycle_plain`; a CUDA tensor
    launches the solve kernel once for one cycle, with no convergence
    exit."""
    if x.device.type == 'cpu':
        return vcycle_plain(ops, x, f)
    if not x.is_cuda:
        raise ValueError('vcycle: unsupported device %s' % x.device)
    xo = x.clone()
    hist, _ = launch_solve(ops, xo, f, 1.0, -math.inf, 1)
    return xo, hist[0]
