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
raises.  The kernels are float64 only (``config.DTYPE``), under either
compute dtype: the JAX package's local MG computes in float64 whatever
``get_dtype`` says (``pyiga_tpu/ops/mg.py``, ``pyiga_tpu/solvers.py``).
"""

import ctypes
import math

import numpy as np
import torch

from .. import _cuda
from ..config import DTYPE

# layout of the int64 descriptor the kernel reads (csrc/mg.cu)
_HDR, _LV = 16, 40
_WF_HDR, _WF_GROUP = 10, 6
_V_SPOS, _V_WAVE, _V_PRE, _V_POST = 17, 18, 20, 28
_H_MODE = 14
# the wavefront kernel (csrc/mg.cu wf::): a level's stale entries are
# copied into a ring of WF_STAGES shared-memory slots, its chain operands
# into a ring of WF_CHAIN slots; an entry is fresh (read by the chain
# warp) if its pass writes its column in the WF_FRESH levels before its
# row's, else stale (summed by one of two groups of WF_LANES producer
# threads, which take the levels in turn); WF_QUADS bounds the 4-entry
# quads a producer lane sums for a row when a level's lane split is
# chosen; WF_SMEM_BYTES is what the kernel may use of a block's 227 KB
# (K6 keeps 320 bytes for its sums)
WF_STAGES = 4
WF_FRESH = 2
WF_CHAIN = WF_STAGES + WF_FRESH + 1
WF_LANES = 128
WF_QUADS = 6
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
    * ``compact[g]``: per pass of group `g` the kernel's host arrays
      (:func:`_wave_pack`).  The entries of ``x`` that the set's rows
      touch get a local numbering, the set first (``l2g``, local to
      global).  A pass keeps only its live rows (a row whose diagonal is
      zero or missing never changes), level by level (a level whose rows
      all drop is dropped; when the shared memory does not hold the
      largest level, levels are split into consecutive levels, never in a
      pass where a row reads what another row of its level writes:
      ``war``, only for a structurally nonsymmetric matrix).  Each row's
      entries are split by age: *fresh* if the pass writes the column in
      the :data:`WF_FRESH` levels before the row's, else *stale*;
    * the launch layout (``csrc/mg.cu`` ``wf::Smem``): the local x when
      it fits (``xs_shared``), else a global scratch vector; a ring of
      :data:`WF_STAGES` slots of ``slot_entries`` stale entries; a ring of
      :data:`WF_CHAIN` chain slots of ``slot_rows`` partial sums and
      ``slot_chain`` bytes of chain operands; ``smem_bytes`` in all;
    * ``words``: on a CUDA device, an int64 tensor of the sizes and the
      addresses of each group's device layout (:func:`_group_blocks`)."""

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
        compact = self._layout(levels)
        self.compact = [[compact[id(p)] for p in group] for group in groups]
        self.words = self._scratch = None
        if device.type == 'cuda':
            self._l2g = tensor(self.l2g, torch.int32)
            if not self.xs_shared:
                self._scratch = torch.empty(self.nloc, dtype=DTYPE,
                                            device=device)
            w = [self.nloc, self._l2g.data_ptr(), self.m,
                 self.slot_entries, self.slot_rows, self.slot_chain,
                 0 if self.xs_shared else self._scratch.data_ptr(),
                 self.smem_bytes, 0, 0]
            self._dev = []
            for cs in self.compact:
                blk = _group_blocks(cs)
                d = {k: tensor(blk[k], dt) for k, dt in (
                    ('sblk', torch.uint8), ('cblk', torch.uint8),
                    ('gid', torch.int32), ('boff', torch.int32))}
                tab = blk['table'].copy()
                tab[:, 0] += d['sblk'].data_ptr()
                tab[:, 1] += d['cblk'].data_ptr()
                d['table'] = tensor(tab, torch.int64)
                self._dev.append(d)
                w += [len(tab), d['table'].data_ptr(), len(blk['gid']),
                      d['gid'].data_ptr(), d['boff'].data_ptr(),
                      d['cblk'].data_ptr()]
            self.words = torch.tensor(w, dtype=torch.int64, device=device)

    def set_trace(self, trace):
        """Record the SM clock (``clock64``) at the steps of the first
        ``trace.numel() // 16`` levels of the next launches into the int64
        CUDA tensor `trace` (None: stop), 16 a level: the chain warp's
        lane 0 in words 0-4 (the level's start, its store, its arrive,
        the next level ready, read), its producers' thread 0 in words 8-12
        (start, copies in, the chain seen, sums, arrive).  Only a kernel
        built with ``PYIGA_WF_TRACE`` records (``csrc/mg.cu``;
        ``scripts/torch_wavefront_probe.py --micro``)."""
        self._trace = trace
        self.words[8] = 0 if trace is None else trace.numel() // 16
        self.words[9] = 0 if trace is None else trace.data_ptr()

    def _need(self, packs, xs):
        """Slot sizes and shared-memory bytes of a launch over `packs`
        (``csrc/mg.cu`` ``wf::smem_of``), with the local x in it if
        `xs`."""
        E = max([c['slot_entries'] for c in packs] + [4])
        R = max([c['slot_rows'] for c in packs] + [4])
        C = max([c['slot_chain'] for c in packs] + [16])
        return (E, R, C, WF_STAGES * (12 * E + 8)
                + WF_CHAIN * (32 + 8 * R + C + 16)
                + (8 * self.nloc if xs else 0))

    def _layout(self, levels):
        """Pack every pass and choose the shared-memory layout: the local
        x in shared memory if it fits beside the rings, else in a global
        scratch vector; past that, the levels are split into runs of fewer
        entries until the rings fit.  Returns the packs by key."""
        compact = {key: _wave_pack(lv) for key, lv in levels.items()}
        self.xs_shared = self._need(compact.values(), True)[3] \
            <= WF_SMEM_BYTES
        cap = max([len(l[0]) * l[1] for lv in levels.values()
                   for l in lv['levels']] + [4])
        while self._need(compact.values(), self.xs_shared)[3] \
                > WF_SMEM_BYTES:
            cap = cap // 2 // 4 * 4
            compact = {key: _wave_pack(dict(lv, levels=_split_levels(
                lv, cap))) for key, lv in levels.items()}
        self.slot_entries, self.slot_rows, self.slot_chain, \
            self.smem_bytes = self._need(compact.values(), self.xs_shared)
        return compact


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


def lane_split(width, rows):
    """The producer lanes ``L`` a row (a power of two, at most 32) and
    4-entry quads a lane ``T`` over which the kernel sums a level of
    `rows` rows whose stale entries are at most `width` a row, each row
    padded to ``4 L T`` entries: the fewest padded entries with ``T <=
    WF_QUADS`` (32 lanes if none) and, where possible, ``rows L`` within
    one round of a producer group's WF_LANES threads; then the most
    lanes."""
    if width == 0:
        return 1, 0
    best = None
    for L in (1, 2, 4, 8, 16, 32):
        T = -(-width // (4 * L))
        if T <= WF_QUADS or L == 32:
            key = (rows * L > WF_LANES and L > 1, L * T, -L)
            if best is None or key < best[0]:
                best = (key, L, T)
    return best[1], best[2]


def stale_positions(k, L, T):
    """Where entry ``e`` of row ``p`` of a level's stale entries (``k``
    rows, lane split ``L``, ``T``) lies in its ``4 k L T`` values and
    columns: lane-major, so that a warp's 16-byte loads are contiguous.
    Entry ``e = 4 (t L + j) + q`` is summed by lane ``u = p L + j`` in
    quad ``t``; with ``U = k L`` its value is double ``2 ((2 t + q // 2) U
    + u) + q % 2`` and its column int ``4 (t U + u) + q``.  Returns two
    ``(k, 4 L T)`` index arrays (values, columns)."""
    U = k * L
    e = np.arange(4 * L * T)
    t, j, q = e // (4 * L), e // 4 % L, e % 4
    u = np.arange(k)[:, None] * L + j[None, :]
    return (2 * ((2 * t + q // 2) * U + u) + q % 2,
            4 * (t * U + u) + q)


def _wave_pack(lv):
    """The kernel's arrays of one pass.  Per level ``l`` a row of the
    level table ``lvl``: ``(first row, first stale entry, first fresh
    entry, rows k, stale width Ws, lanes L, quads T, fresh width F)``.
    Rows are padded to a multiple of 4 a level (``Rp``): per row ``dst``
    (local index), ``gid`` (global index, for ``b``), ``diag`` and its
    reciprocal ``rcp``.  A row's stale entries (``scol`` local columns /
    ``sval``, in the row's order, zero padded to ``Ws = 4 L T``, placed by
    :func:`stale_positions`) are summed by ``L`` producer lanes, lane
    ``j`` taking quads ``t L + j``; its fresh entries (``fcol`` /
    ``fval``, ``F`` a row, entry-major: entry ``i`` of row ``p`` at ``i Rp
    + p``) by the chain warp, which finds the value by ``fsrc``: ``~(32 (a
    - 1) + q)`` for row ``q < 32`` of the level ``a`` back (in its lane
    ``q``'s registers), else the local column.  An entry is fresh if the pass writes its column at a level in
    ``[l - WF_FRESH, l - 1]``.  Also ``nlev``, ``pmax`` (most rows of a
    level), ``entries`` (stored nonzeros), ``fresh`` (fresh entries),
    ``war`` and the slot sizes its levels need (``slot_entries``,
    ``slot_rows``, ``slot_chain``: see :func:`_group_blocks`)."""
    levels = lv['levels']
    written, wpos = {}, {}            # local column -> level, row there
    for l, (d, *_rest) in enumerate(levels):
        written.update(zip(d.tolist(), [l] * len(d)))
        wpos.update(zip(d.tolist(), range(len(d))))
    split, nrows, nstale, nfresh = [], 0, 0, 0
    for l, (d, _w, c, v, g, dg) in enumerate(levels):
        fresh = [np.array([l - WF_FRESH <= written.get(j, -WF_FRESH - 1)
                           < l for j in ci.tolist()], dtype=bool)
                 for ci in c]
        k, Rp = len(d), _up4(len(d))
        L, T = lane_split(max(int((~f).sum()) for f in fresh), k)
        F = max(int(f.sum()) for f in fresh)
        split.append((fresh, L, T, F))
        nrows += Rp
        nstale += k * 4 * L * T
        nfresh += F * Rp
    dst = np.zeros(nrows + 4, np.int32)
    gid = np.zeros(nrows + 4, np.int32)
    diag = np.ones(nrows + 4)
    scol = np.zeros(nstale + 4, np.int32)
    sval = np.zeros(nstale + 4)
    fcol = np.zeros(nfresh + 4, np.int32)
    fsrc = np.full(nfresh + 4, -1, np.int32)     # a pad reads lane 0
    fval = np.zeros(nfresh + 4)
    lvl, row0, s0, f0, stored, nf = [], 0, 0, 0, 0, 0
    E = R = Cb = 0
    for (d, _w, c, v, g, dg), (fresh, L, T, F) in zip(levels, split):
        k, Rp, Ws = len(d), _up4(len(d)), 4 * L * T
        dst[row0:row0 + k], gid[row0:row0 + k] = d, g
        diag[row0:row0 + k] = dg
        pv, pc = stale_positions(k, L, T)
        for p, (ci, vi, fi) in enumerate(zip(c, v, fresh)):
            ns = int((~fi).sum())
            scol[s0 + pc[p, :ns]] = ci[~fi]
            sval[s0 + pv[p, :ns]] = vi[~fi]
            e = f0 + np.arange(int(fi.sum())) * Rp + p
            fcol[e], fval[e] = ci[fi], vi[fi]
            # written a levels back by row q of that level: from the chain
            # warp's registers (lane q) where q < 32, else the local x
            li = len(lvl)
            fsrc[e] = [~(32 * (li - written[j] - 1) + wpos[j])
                       if wpos[j] < 32 else j for j in ci[fi].tolist()]
            stored += len(vi)
            nf += int(fi.sum())
        lvl.append((row0, s0, f0, k, Ws, L, T, F))
        E, R = max(E, k * Ws), max(R, Rp)
        Cb = max(Cb, (28 + 12 * F) * Rp)
        row0 += Rp
        s0 += k * Ws
        f0 += F * Rp
    if max(s0, f0) >= 2 ** 31:
        raise ValueError('wavefront pack of %d entries exceeds int32' % s0)
    return dict(nlev=len(lvl),
                lvl=np.asarray(lvl, dtype=np.int32).reshape(-1, 8),
                dst=dst, gid=gid, diag=diag, rcp=1.0 / diag, scol=scol,
                sval=sval, fcol=fcol, fsrc=fsrc, fval=fval, war=lv['war'],
                pmax=max([t[3] for t in lvl] + [0]), entries=stored,
                fresh=nf, slot_entries=E, slot_rows=R, slot_chain=Cb)


def _group_blocks(packs):
    """The device layout of a group of passes (:func:`_wave_pack` packs,
    in order): per level two contiguous byte blocks, each a bulk copy into
    a shared-memory slot.  The stale block holds the level's ``k Ws``
    values then their columns; the chain block its rows' ``b`` (written
    at each launch), ``rcp`` and ``diag`` (``Rp`` doubles each), ``dst``
    (``Rp`` ints), then the fresh values and columns (``F Rp`` each).
    Returns ``sblk`` and ``cblk`` (uint8), ``table`` ``(levels, 4)``
    int64 rows ``(stale block offset, chain block offset, k + Ws 2**32,
    L + T 2**8 + F 2**16 + l 2**32)`` with ``l`` the level in its pass
    (``csrc/mg.cu`` ``wf::level_of``), and per row of the group (padding
    included)
    ``gid`` (global index) and ``boff`` (where its ``b`` goes in ``cblk``,
    in doubles)."""
    sblk, cblk, table, gid, boff = [], [], [], [], []
    so = co = 0
    for c in packs:
        for l, (row0, s0, f0, k, Ws, L, T, F) in enumerate(
                c['lvl'].tolist()):
            Rp = _up4(k)
            ks = k * Ws
            sblk += [c['sval'][s0:s0 + ks].view(np.uint8),
                     c['scol'][s0:s0 + ks].view(np.uint8)]
            rows = slice(row0, row0 + Rp)
            fr = slice(f0, f0 + F * Rp)
            cblk += [np.zeros(8 * Rp, np.uint8),
                     c['rcp'][rows].view(np.uint8),
                     c['diag'][rows].view(np.uint8),
                     c['dst'][rows].view(np.uint8),
                     c['fval'][fr].view(np.uint8),
                     c['fsrc'][fr].view(np.uint8)]
            if not (L < 2 ** 8 and T < 2 ** 8 and F < 2 ** 16):
                raise ValueError('wavefront level of lane split (%d, %d) '
                                 'and %d fresh entries a row' % (L, T, F))
            table.append((so, co, k + (Ws << 32),
                          L + (T << 8) + (F << 16) + (l << 32)))
            gid.append(c['gid'][rows])
            boff.append(co // 8 + np.arange(Rp))
            so += 12 * ks
            co += (28 + 12 * F) * Rp
    if max(so, co) >= 2 ** 31:
        raise ValueError('wavefront group of %d bytes exceeds int32'
                         % max(so, co))
    cat = (lambda a, dt: np.concatenate(a).astype(dt) if a
           else np.zeros(0, dt))
    return dict(sblk=np.concatenate(sblk + [np.zeros(16, np.uint8)]),
                cblk=np.concatenate(cblk + [np.zeros(16, np.uint8)]),
                table=np.asarray(table, dtype=np.int64).reshape(-1, 4),
                gid=cat(gid, np.int32), boff=cat(boff, np.int32))


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
    _cuda.no_grad_operands('vcycle', x, f)
    _check(ops, x, f)
    maxiter = int(maxiter)
    if maxiter < 0 or maxiter >= 2 ** 31:
        raise ValueError('vcycle: maxiter %d out of range' % maxiter)
    if trace is not None:
        _cuda.require(trace, 'trace', torch.int64, 1)
    hist = torch.empty(max(maxiter, 1), dtype=DTYPE, device=x.device)
    info = torch.empty(2, dtype=DTYPE, device=x.device)
    if ops.wave:
        _check_wf_layout()
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


_WF_LAYOUT_OK = []


def _check_wf_layout():
    """Raise unless the built kernel's wavefront layout is the host
    pack's (``csrc/mg.cu`` ``pyiga_wavefront_layout``)."""
    if not _WF_LAYOUT_OK:
        lib = _cuda.library()
        got = [lib.pyiga_wavefront_layout(i) for i in range(6)]
        want = [WF_STAGES, WF_FRESH, WF_CHAIN, _WF_HDR, _WF_GROUP, WF_LANES]
        if got != want:
            raise RuntimeError('wavefront kernel layout %s, host pack %s'
                               % (got, want))
        _WF_LAYOUT_OK.append(True)


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
    levels = sum(c['nlev'] for c in sweeps.compact[group])
    if not 0 <= int(iterations) * max(levels, 1) < 2 ** 31:
        raise ValueError('wavefront_gs: iterations %d out of range'
                         % iterations)


def wavefront_quotient(num, d, r):
    """The wavefront kernel's quotient ``num / d`` from ``r = 1 / d``
    (``csrc/mg.cu`` ``wf::quotient``: ``q = num r`` corrected once by the
    exact residual), elementwise on CUDA float64 tensors of one shape,
    for checking it against the division.  Not on any solve's path: it
    counts no launch."""
    for t, name in ((num, 'num'), (d, 'd'), (r, 'r')):
        _cuda.require(t, name, DTYPE, 1)
        if t.shape != num.shape or t.device != num.device:
            raise ValueError('wavefront_quotient: %s does not match num'
                             % name)
    out = torch.empty_like(num)
    with _cuda.device_of(num):
        err = _cuda.library().pyiga_wavefront_quotient_f64(
            num.data_ptr(), d.data_ptr(), r.data_ptr(), out.data_ptr(),
            num.numel(), _cuda.stream_of(num))
    _cuda.check(err, 'wavefront_quotient')
    return out


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
    _cuda.no_grad_operands('wavefront_gs', x, b)
    _cuda.require(x, 'x', DTYPE, 1)
    _cuda.require(b, 'b', DTYPE, 1)
    _check_wf_layout()
    with _cuda.device_of(x):
        err = _cuda.library().pyiga_wavefront_gs_f64(
            sweeps.words.data_ptr(), int(group), int(iterations),
            x.data_ptr(), b.data_ptr(), sweeps.smem_bytes,
            _cuda.stream_of(x))
    _cuda.check(err, 'wavefront_gs')
    _cuda.LAUNCHES['wavefront_gs'] += 1
    return x
