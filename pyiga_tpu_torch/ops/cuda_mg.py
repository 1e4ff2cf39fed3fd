# -*- coding: utf-8 -*-
"""Kernel K6: the local-multigrid solve loop, whole V-cycles and the
masked residual norm in one launch (counterpart of
:mod:`pyiga_tpu.ops.mg_pallas`), and the order-exact wavefront
Gauss-Seidel kernel (the JAX package's XLA loop ``ops/mg.py`` ``_smooth``
and ``ops/relax.py`` ``_smooth_fn``), each beside its plain PyTorch
version.

:class:`VCycleOperands` holds a hierarchy's operands on one device: per
level the padded-ELL matrix ``A``; above the coarsest level the ELL
prolongator ``P`` into the level with its transpose ``PT`` and the
smoothing operands of one of two modes: the dense mode's smoothing set
``S``, ELL rows ``A[S, :]`` and triangular inverses ``T`` of the pre- and
post-smoothing sweep directions (each a :class:`DenseRows`: the rows
zero-padded to a multiple of 4, each row's nonzero extent and the rows
ordered longest first), or the wavefront mode's :class:`WavefrontSweeps`
(the sweeps' level schedules, no dense matrix); on the coarsest level
the smoothing set ``ind0`` and the dense inverse ``Cinv`` of its block.

:func:`vcycle_solve` runs cycles from zero until the masked residual
drops by ``tol`` (the test of :meth:`~pyiga_tpu_torch.ops.mg.
DeviceMGSolver.solve`); :func:`vcycle` maps ``(x, f)`` to the next iterate
and ``||(f - A x) * mask||^2``; :func:`wavefront_gs` applies sweeps over
one smoothing set.  On a CPU tensor each runs its plain version
(:func:`vcycle_solve_plain`, :func:`vcycle_plain`,
:func:`wavefront_gs_plain`); on a CUDA tensor each launches its kernel
(``csrc/mg.cu`` ``vcycle_kernel`` or ``wavefront_gs_kernel``) once, or
raises.
"""

import ctypes
import math

import numpy as np
import torch

from .. import _cuda
from ..config import DTYPE

# layout of the int64 descriptor the kernel reads (csrc/mg.cu)
_HDR, _LV = 16, 40
_V_SPOS, _V_WAVE, _V_PRE, _V_POST = 17, 18, 20, 28
_H_MODE = 14
# the wavefront kernel's shared-memory ring (csrc/mg.cu kWfStages,
# kWfTable) and the bytes it may use of a block's 227 KB (K6 keeps 320
# bytes for its sums)
WF_STAGES, WF_TABLE = 3, 8
WF_SMEM_BYTES = 232_448 - 512
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


class WavefrontSweeps:
    """The sweeps of one smoothing set as the wavefront kernel and its
    plain version read them, on `device`.

    `groups` lists groups of sweep passes (the pre- and post-smoothing
    directions of a level, or the passes of one
    :class:`~pyiga_tpu_torch.ops.relax.DeviceIndexedGS`), each pass the
    rectangular pack ``(rows, cols, vals, diag)`` of
    :func:`~pyiga_tpu_torch.ops.relax._pack_sweep` over a matrix of
    `n` rows and the set `indices`.  A pack object shared by two passes
    is built and uploaded once.

    * ``plain[g]``: the packs of group `g` as tensors (the plain version
      writes the pad rows to a dead slot ``n``);
    * ``compact[g]``: per pass of group `g` the kernel's host arrays.  The
      entries of ``x`` that the set's rows touch get a local numbering,
      the set first (``l2g``, local to global).  A pass keeps only its
      live rows (a row whose diagonal is zero or missing never changes),
      level by level (a level whose rows all drop is dropped, one too
      large for a shared-memory slot is split into consecutive levels
      when no row of it reads what another writes): ``lvl`` rows
      ``(first row, first entry, width, rows)``, the first row a
      multiple of 4; per row ``dst`` (local index), ``gid`` (global
      index, for ``b``), ``diag``; per row ``width`` entries ``col``
      (local) / ``val``, the row's off-diagonal entries zero padded, the
      width a multiple of 4; ``war`` flags a pass in which a row reads an
      entry that another row of its level writes (only for a
      structurally nonsymmetric matrix); ``nlev``, ``pmax`` (most rows of
      a level), ``entries`` (stored nonzeros);
    * the launch layout (``csrc/mg.cu`` ``wavefront_smooth``): a ring of
      :data:`WF_STAGES` shared-memory slots of ``slot_entries`` entries
      and ``slot_rows`` rows, a level table ring, a stage of
      ``slot_rows`` values and, when it fits (``xs_shared``), the local
      x; ``smem_bytes`` in all;
    * ``words``: an int64 tensor of the operands' addresses and sizes, on
      a CUDA device."""

    def __init__(self, n, indices, groups, device):
        self.device = device
        self.n = int(n)
        S = np.asarray(indices, dtype=np.int64).reshape(-1)
        self.m = len(S)
        packs = {}
        for group in groups:
            for pack in group:
                packs.setdefault(id(pack), pack)
        # the local numbering: S first, then every other entry of x that
        # a live row reads, in ascending order
        touched = [S]
        for rows, cols, vals, _diag in packs.values():
            live = (rows != n)[..., None] & (vals != 0)
            touched.append(cols[live].astype(np.int64))
        extra = np.setdiff1d(np.concatenate(touched), S)
        self.l2g = np.concatenate([S, extra]).astype(np.int32)
        self.nloc = len(self.l2g)
        g2l = np.full(self.n, -1, dtype=np.int64)
        g2l[self.l2g] = np.arange(self.nloc)

        def tensor(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)

        plain, levels = {}, {}
        for key, (rows, cols, vals, diag) in packs.items():
            plain[key] = (tensor(rows, torch.int64),
                          tensor(cols, torch.int64), tensor(vals, DTYPE),
                          tensor(diag, DTYPE))
            levels[key] = _wave_levels(rows, cols, vals, diag, g2l)
        self.plain = [[plain[id(p)] for p in group] for group in groups]
        self.groups = [len(group) for group in groups]
        self._layout(levels)
        compact = {key: _wave_pack(lv, self.slot_entries, self.slot_rows)
                   for key, lv in levels.items()}
        self.compact = [[compact[id(p)] for p in group] for group in groups]
        self.words = self._scratch = None
        if device.type == 'cuda':
            ops = {key: {k: tensor(c[k], dt) for k, dt in (
                ('lvl', torch.int32), ('dst', torch.int32),
                ('gid', torch.int32), ('diag', DTYPE), ('col', torch.int32),
                ('val', DTYPE))} for key, c in compact.items()}
            for key, c in compact.items():     # b in the pass's row order
                ops[key]['bl'] = torch.empty(len(c['dst']), dtype=DTYPE,
                                             device=device)
            self._ops = ops
            self._l2g = tensor(self.l2g, torch.int32)
            if not self.xs_shared:
                self._scratch = torch.empty(self.nloc, dtype=DTYPE,
                                            device=device)
            w = [self.nloc, self._l2g.data_ptr(), self.m] + \
                (self.groups + [0, 0])[:2] + [
                    self.slot_entries, self.slot_rows,
                    0 if self.xs_shared else self._scratch.data_ptr(),
                    self.smem_bytes, 0]
            for group in groups:
                for pack in group:
                    o, c = ops[id(pack)], compact[id(pack)]
                    w += [c['nlev']] + [o[k].data_ptr() for k in (
                        'lvl', 'dst', 'gid', 'diag', 'col', 'val')] \
                        + [int(c['war']), o['bl'].data_ptr(), len(c['dst'])]
            self.words = torch.tensor(w, dtype=torch.int64, device=device)

    def _layout(self, levels):
        """Choose the shared-memory layout: slots that hold the largest
        level, with the local x in shared memory if it fits, else in a
        global scratch vector; past that, levels are split (never those of
        a write-after-read pass) so that a slot fits."""
        def need(entries, rows, xs):
            return (WF_STAGES * (12 * entries + 20 * rows)
                    + 16 * WF_TABLE + 8 * rows + (8 * self.nloc if xs else 0))
        lvs = [l for lv in levels.values() for l in lv['levels']]
        rows = _up4(max([len(l[0]) for l in lvs] + [1]))
        entries = max([len(l[0]) * l[1] for l in lvs] + [4])
        self.xs_shared = need(entries, rows, True) <= WF_SMEM_BYTES
        if need(entries, rows, self.xs_shared) > WF_SMEM_BYTES:
            # a slot of E entries: split the levels of each pass to fit
            cap = (WF_SMEM_BYTES - 16 * WF_TABLE - (WF_STAGES * 20 + 8)
                   * rows) // (WF_STAGES * 12) // 4 * 4
            for lv in levels.values():
                lv['levels'] = _split_levels(lv, cap)
            lvs = [l for lv in levels.values() for l in lv['levels']]
            entries = max(len(l[0]) * l[1] for l in lvs)
        self.slot_entries, self.slot_rows = int(entries), int(rows)
        self.smem_bytes = need(entries, rows, self.xs_shared)


def _up4(k):
    return -(-int(k) // 4) * 4


def _wave_levels(rows, cols, vals, diag, g2l):
    """One pass's live rows by level: ``levels`` a list of ``(dst, width)``
    with ``dst`` the rows' local indices, per row its entries' local
    columns and values (``cols``, ``vals``, lists of arrays), its global
    index and diagonal, and ``war`` (see :class:`WavefrontSweeps`)."""
    n = len(g2l)
    live = rows != n
    out, war = [], False
    for l in range(rows.shape[0]):
        ps = np.nonzero(live[l])[0]
        if not len(ps):
            continue
        keep = vals[l, ps] != 0
        d = g2l[rows[l, ps]]
        c = [g2l[cols[l, p][k]] for p, k in zip(ps, keep)]
        v = [vals[l, p][k] for p, k in zip(ps, keep)]
        # a row reading an entry that another row of its level writes
        war = war or bool(np.isin(np.concatenate(c), d).any())
        width = _up4(max(len(ci) for ci in c))
        out.append((d, width, c, v, rows[l, ps], diag[l, ps]))
    return {'levels': out, 'war': war}


def _split_levels(lv, cap):
    """The levels of one pass with each level's rows cut into runs of at
    most ``cap // width`` (consecutive levels compute the same sweep: no
    row of a level reads what another writes, checked by ``war``)."""
    out = []
    for d, width, c, v, gid, dg in lv['levels']:
        if width > cap:
            raise ValueError('wavefront: a row of %d entries exceeds the '
                             'shared-memory slot (%d)' % (width, cap))
        step = cap // width if width else len(d)
        if len(d) > step and lv['war']:
            raise ValueError('wavefront: a level of a structurally '
                             'nonsymmetric sweep exceeds the shared-memory '
                             'slot')
        for a in range(0, len(d), step):
            out.append((d[a:a + step], width, c[a:a + step], v[a:a + step],
                        gid[a:a + step], dg[a:a + step]))
    return out


def _wave_pack(lv, slot_entries, slot_rows):
    """The kernel's arrays of one pass (see :class:`WavefrontSweeps`)."""
    lvl, row0, ent = [], 0, 0
    nrows = sum(_up4(len(l[0])) for l in lv['levels'])
    nent = sum(len(l[0]) * l[1] for l in lv['levels'])
    dst = np.zeros(nrows + 4, np.int32)
    gid = np.zeros(nrows + 4, np.int32)
    diag = np.ones(nrows + 4)
    col = np.zeros(nent + 4, np.int32)
    val = np.zeros(nent + 4)
    stored = 0
    for d, width, c, v, g, dg in lv['levels']:
        k = len(d)
        assert k <= slot_rows and k * width <= slot_entries
        dst[row0:row0 + k], gid[row0:row0 + k] = d, g
        diag[row0:row0 + k] = dg
        for p, (ci, vi) in enumerate(zip(c, v)):
            col[ent + p * width:ent + p * width + len(ci)] = ci
            val[ent + p * width:ent + p * width + len(vi)] = vi
            stored += len(vi)
        lvl.append((row0, ent, width, k))
        row0 += _up4(k)
        ent += k * width
    if ent >= 2 ** 31:
        raise ValueError('wavefront pack of %d entries exceeds int32' % ent)
    return dict(nlev=len(lvl),
                lvl=np.asarray(lvl, dtype=np.int32).reshape(-1, 4),
                dst=dst, gid=gid, diag=diag, col=col, val=val,
                war=lv['war'], pmax=max([t[3] for t in lvl] + [0]),
                entries=stored)


class DenseRows:
    """A dense matrix as K6 reads it: ``vals`` ``(m, ld)`` with the rows
    zero-padded to ``ld``, a multiple of 4, and ``rows`` ``(m, 4)`` int32,
    one ``(row, lo, hi, x index)`` per row in the order the kernel takes
    them.  With `extents`, ``[lo, hi)`` is the row's nonzero extent
    (:func:`row_extents`) and the rows come longest first (stable), so the
    kernel reads only the occupied part and deals the rows out evenly;
    without, every row is ``[0, ld)`` in order.  ``dst[row]`` is the
    entry of x the row updates.  ``mat`` is the ``(m, m)`` matrix itself;
    ``entries`` counts the occupied entries.  `A` is a host array or,
    without `extents`, also a tensor (padded where it lies)."""

    def __init__(self, A, dst, device, extents=True):
        m = A.shape[0]
        ld = -(-m // _SECTOR) * _SECTOR
        self.m, self.ld = m, ld
        if isinstance(A, torch.Tensor):
            assert not extents
            self.vals = torch.zeros((m, ld), dtype=DTYPE, device=device)
            self.vals[:, :m] = A
        else:
            host = np.zeros((m, ld))
            host[:, :m] = A
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
        self.wave = self.L > 1 and 'wave' in levels[1]
        self.levels = []
        for lev in levels:
            dl = {'A': _ell(*lev['A'], device)}
            if 'wave' in lev:
                S, groups = lev['wave']
                dl['wave'] = WavefrontSweeps(self.n[len(self.levels)], S,
                                             groups, device)
                dl['P'] = _ell(*lev['P'], device)
                dl['PT'] = _ell(*lev['PT'], device)
            elif 'S' in lev:
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
        if self.wave:
            self.npre, self.npost = self.levels[1]['wave'].groups
        else:
            self.npre = len(self.levels[1]['pre']) if self.L > 1 else 0
            self.npost = len(self.levels[1]['post']) if self.L > 1 else 0
        self.desc = self.work = None
        if device.type == 'cuda':
            self._build_desc()

    def _build_desc(self):
        """The kernel's descriptor (int64 words, see ``csrc/mg.cu``) and
        the work buffer.  Work layout: ``x`` and ``rhs`` of every level
        below the finest, then ``rS`` (the largest smoothing set), ``r``
        (the largest level) and, in the wavefront mode where the largest
        local x exceeds shared memory, that local x."""
        L = self.L
        w = [0] * (_HDR + _LV * L)
        off = 0
        offsets = []
        for lv in range(L - 1):
            offsets.append((off, off + self.n[lv]))
            off += 2 * self.n[lv]
        waves = [lev['wave'] for lev in self.levels[1:] if 'wave' in lev]
        m_max = max([int(lev['S'].shape[0]) for lev in self.levels[1:]
                     if 'S' in lev] + [1])
        # the longest vector a dense pass stages in shared memory, and the
        # wavefront's shared-memory layout
        self.vec = max([T.ld for lev in self.levels
                        for T in lev.get('pre', []) + lev.get('post', [])]
                       + [self.Cinv.ld]
                       + [-(-wv.smem_bytes // 8) for wv in waves])
        work_n = off + m_max + max(self.n)
        w[0:10] = [L, self.steps, self.npre, self.npost,
                   int(self.ind0.shape[0]), self.ind0.data_ptr(),
                   self.mask.data_ptr(), off, off + m_max, self.vec]
        w[10:14] = self.Cinv.words()
        w[_H_MODE] = int(self.wave)
        for lv, lev in enumerate(self.levels):
            b = _HDR + _LV * lv
            cols, vals = lev['A']
            w[b:b + 4] = [self.n[lv], cols.data_ptr(), vals.data_ptr(),
                          cols.shape[1]]
            if 'wave' in lev:
                w[b + _V_WAVE] = lev['wave'].words.data_ptr()
                for j, key in ((9, 'P'), (12, 'PT')):
                    cols, vals = lev[key]
                    w[b + j:b + j + 3] = [cols.data_ptr(), vals.data_ptr(),
                                          cols.shape[1]]
            elif lv > 0:
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
        self.work = torch.empty(work_n, dtype=DTYPE, device=self.device)


################################################################################
# the plain version
################################################################################

def _ell_mv(ell, x):
    cols, vals = ell
    return (vals * x.index_select(0, cols.reshape(-1)).reshape(cols.shape)
            ).sum(dim=-1)


def _smooth(ops, lev, key, x, b):
    """`steps` applications of the level's pre- or post-smoothing passes
    (`key`) over its smoothing set, in place: in the dense mode ``x_S +=
    T (b_S - A[S, :] x)`` a pass, in the wavefront mode the plain
    wavefront sweeps."""
    if 'wave' in lev:
        wavefront_gs_plain(lev['wave'], int(key == 'post'), ops.steps, x, b)
        return
    S = lev['S']
    for _ in range(ops.steps):
        for T in lev[key]:
            r = b.index_select(0, S) - _ell_mv(lev['AS'], x)
            x.index_add_(0, S, T.mat @ r)


def wavefront_gs_plain(sweeps, group, iterations, x, b):
    """Plain version of :func:`wavefront_gs`: per pass a loop over its
    levels, each one gather of the rows' entries and one scatter of their
    new values (the arithmetic of the JAX package's ``ops/mg.py``
    ``_smooth``); the pad rows write a dead slot ``n``.  Updates `x` in
    place and returns it."""
    _check_wave(sweeps, group, iterations, x, b)
    xe = torch.cat([x, x.new_zeros(1)])
    be = torch.cat([b, b.new_zeros(1)])
    for _ in range(iterations):
        for rows, cols, vals, diag in sweeps.plain[group]:
            for l in range(rows.shape[0]):
                r = rows[l]
                z = (vals[l] * xe[cols[l]]).sum(dim=-1)
                xe[r] = (be[r] - z) / diag[l]
    x.copy_(xe[:-1])
    return x


def vcycle_plain(ops, x, f):
    """Plain PyTorch version of :func:`vcycle` (same inputs and
    outputs), in the V-cycle's order of steps."""
    L = ops.L
    xs, rhss = [None] * L, [None] * L
    xs[L - 1], rhss[L - 1] = x.clone(), f
    for lv in range(L - 1, 0, -1):
        lev = ops.levels[lv]
        _smooth(ops, lev, 'pre', xs[lv], rhss[lv])
        r = rhss[lv] - _ell_mv(lev['A'], xs[lv])
        rhss[lv - 1] = _ell_mv(lev['PT'], r)
        xs[lv - 1] = torch.zeros_like(rhss[lv - 1])
    xs[0] = torch.zeros_like(rhss[0]).index_copy_(
        0, ops.ind0.long(), ops.Cinv.mat @ rhss[0].index_select(0, ops.ind0))
    for lv in range(1, L):
        lev = ops.levels[lv]
        xs[lv] += _ell_mv(lev['P'], xs[lv - 1])
        _smooth(ops, lev, 'post', xs[lv], rhss[lv])
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
    fuse = ops.steps > 0 and ops.npre > 0 and not ops.wave
    names = []
    for lv in range(ops.L - 1, 0, -1):
        if ops.wave:
            if ops.steps > 0 and ops.npre > 0:
                names.append('L%d pre wavefront' % lv)
            names += ['L%d residual' % lv, 'L%d restrict' % lv]
            continue
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
        if ops.wave:
            if ops.steps > 0 and ops.npost > 0:
                names.append('L%d post wavefront' % lv)
            continue
        for s in range(ops.steps):
            for k in range(ops.npost):
                names += ['L%d post rS' % lv, 'L%d post T' % lv]
    names.append('final residual')
    if ops.L > 1 and not (ops.steps > 0 and ops.npre > 0):
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
    _cuda.LAUNCHES['vcycle_wavefront' if ops.wave else 'vcycle'] += 1
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


def _check_wave(sweeps, group, iterations, x, b):
    """Argument checks of :func:`wavefront_gs` on either device."""
    n = sweeps.n
    for t, name in ((x, 'x'), (b, 'b')):
        if t.dtype != DTYPE or t.dim() != 1 or t.shape[0] != n:
            raise ValueError('wavefront_gs: %s must be (%d,) float64, got %s '
                             '%s' % (name, n, tuple(t.shape), t.dtype))
        if t.device != sweeps.device and not (
                t.device.type == sweeps.device.type == 'cuda'
                and sweeps.device.index is None):
            raise ValueError('wavefront_gs: %s on %s, the sweeps on %s'
                             % (name, t.device, sweeps.device))
    if not 0 <= group < len(sweeps.groups):
        raise ValueError('wavefront_gs: no pass group %d' % group)
    if not 0 <= int(iterations) < 2 ** 31:
        raise ValueError('wavefront_gs: iterations %d out of range'
                         % iterations)


def wavefront_gs(sweeps, group, iterations, x, b):
    """The wavefront Gauss-Seidel kernel: `iterations` times the passes of
    group `group` of `sweeps` (a :class:`WavefrontSweeps`) over its
    smoothing set, for ``A x = b``, updating `x` in place (both ``(n,)``
    float64 on the sweeps' device).  A CPU tensor runs
    :func:`wavefront_gs_plain`; a CUDA tensor launches
    ``wavefront_gs_kernel`` once, one block that runs every level of
    every pass, or raises.  Returns `x`."""
    _check_wave(sweeps, group, iterations, x, b)
    if x.device.type == 'cpu':
        return wavefront_gs_plain(sweeps, group, iterations, x, b)
    if not x.is_cuda or sweeps.words is None:
        raise ValueError('wavefront_gs: unsupported device %s' % x.device)
    _cuda.require(x, 'x', DTYPE, 1)
    _cuda.require(b, 'b', DTYPE, 1)
    first = sum(sweeps.groups[:group])
    with _cuda.device_of(x):
        err = _cuda.library().pyiga_wavefront_gs_f64(
            sweeps.words.data_ptr(), first, sweeps.groups[group],
            int(iterations), x.data_ptr(), b.data_ptr(), sweeps.smem_bytes,
            _cuda.stream_of(x))
    _cuda.check(err, 'wavefront_gs')
    _cuda.LAUNCHES['wavefront_gs'] += 1
    return x
