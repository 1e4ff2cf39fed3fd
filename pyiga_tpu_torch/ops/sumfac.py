# -*- coding: utf-8 -*-
"""Sum-factorization assembly: pair tables, fold plans and the exact
contraction chain (port of :mod:`pyiga_tpu.ops.sumfac`, float64 'exact'
mode only — the Ozaki and two-float ``*_pair`` paths exist for the TPU's
missing f64 and are not ported).

A matrix over a tensor-product space is computed as a chain of per-axis
contractions of a coefficient field on the Gauss grid against basis-pair
tables:

    data[s_1, ..., s_d] = sum_q  C(q_1, ..., q_d) * prod_k P_k[s_k, q_k]

The hot path runs these chains through the CUDA stage kernels of
:mod:`.cuda_sumfac`; :func:`contract_chain` and
:func:`assemble_terms_folded` here are the plain tensordot form, kept as
the in-package reference.

The windowed route (:func:`contract_chain_windowed`,
:func:`assemble_terms_windowed`, :func:`run_windowed_assembly`)
contracts each basis pair over only the ``(p+1)*nqp`` Gauss points of
its support window (:meth:`SpaceTables.windowed_pair_table`) and yields
the banded-flat tensor, axis k at ``o_k*n_k + i_k``; its plain form is
here, its kernels (K8, K8f) in :mod:`.cuda_sumfac`.
"""

import numpy as np
import torch

from ..config import no_tf32
from ..quadrature import make_boundary_quadrature, make_tensor_quadrature
from .basis import dense_basis_table


def contract_chain(tables, field):
    """Contract ``field (Q_1 x ... x Q_d)`` against per-axis tables
    ``tables[k] (m_k, Q_k)``; returns an ``(m_1, ..., m_d)`` tensor."""
    X = field
    for k, T in enumerate(tables):
        X = torch.movedim(torch.tensordot(X, T, dims=([k], [1])), -1, k)
    return X


def last_table_groups(term_tables):
    """Canonical group id of each term's LAST table, by object identity
    (:class:`SpaceTables` interns shared tables)."""
    seen, out = {}, []
    for tabs in term_tables:
        out.append(seen.setdefault(id(tabs[-1]), len(seen)))
    return tuple(out)


def _sum_chains_merged(term_tables, fields, idxs, last_idx):
    """Sum of chains over the term subset `idxs`; terms sharing their last
    table (`last_idx`) sum their stage-(d-1) results first and run the
    final contraction once."""
    groups = {}
    for t in idxs:
        groups.setdefault(last_idx[t], []).append(t)
    out = None
    for ts in groups.values():
        partial = None
        for t in ts:
            Y = contract_chain(term_tables[t][:-1], fields[t])
            partial = Y if partial is None else partial + Y
        d = partial.dim() - 1
        Y = torch.movedim(torch.tensordot(partial, term_tables[ts[0]][-1],
                                          dims=([d], [1])), -1, d)
        out = Y if out is None else out + Y
    return out


def assemble_terms(term_tables, fields, mode='exact', last_idx=None):
    """Sum of the contraction chains of all terms, on the fields' device:
    K2 stages and one K3 fold (:func:`~pyiga_tpu_torch.ops.cuda_sumfac.
    chain_folded`; their plain versions on the CPU).  Terms sharing their
    last table (`last_idx`, default :func:`last_table_groups`) share one
    final contraction.  `term_tables` are tensors of the fields' dtype on
    their device.  `mode` is accepted for the reference's signature and
    ignored (the port contracts exactly)."""
    from .cuda_sumfac import chain_folded
    if last_idx is None:
        last_idx = last_table_groups(term_tables)
    return chain_folded(term_tables, fields, last_idx)


def assemble_terms_folded(term_tables, fields, fold_plan, tperms,
                          mode='exact', last_idx=None):
    """Symmetric-term folding: one chain per mirrored term pair; the
    mirrored sum's transpose is a separable per-axis index permutation
    (`tperms`, LongTensors).  `fold_plan` is a sequence of
    ``(term_index, mirrored)``.  `mode` is accepted for the reference's
    signature and ignored: every mode contracts exactly (the port has no
    Ozaki route)."""
    if last_idx is None:
        last_idx = last_table_groups(term_tables)
    direct = [t for t, m in fold_plan if not m]
    mirrored = [t for t, m in fold_plan if m]
    if mirrored and not tperms:
        raise ValueError('fold_plan has mirrored terms but no tperms — '
                         'the untransposed sum would be silently wrong')
    out = (_sum_chains_merged(term_tables, fields, direct, last_idx)
           if direct else None)
    if mirrored:
        sym = _sum_chains_merged(term_tables, fields, mirrored, last_idx)
        symT = sym
        for k, p in enumerate(tperms):
            symT = torch.index_select(symT, k, p)
        sym = sym + symT
        out = sym if out is None else out + sym
    return out


def symmetric_fold_plan(terms):
    """Fold plan for arity-2 `terms` ``[(du, dv), ...]`` of a *symmetric*
    bilinear form: each ``du != dv`` pair is computed once (mirrored);
    returns None if the terms are not closed under derivative swap."""
    index = {t: i for i, t in enumerate(terms)}
    plan = []
    for i, (du, dv) in enumerate(terms):
        if du == dv:
            plan.append((i, False))
        elif (dv, du) not in index:
            return None
        elif index[(dv, du)] > i:     # keep the first of each pair
            plan.append((i, True))
    return plan


def windowed_stage_plain(X, P, fs, nqp):
    """One windowed contraction stage (the reference's
    ``_windowed_stage``): contract the leading (quadrature) axis of `X`
    against the windowed pair table ``P (n, b, wsz)``, dof i over the
    ``wsz`` points from ``fs[i]*nqp``; the banded-flat result axis
    ``o*n + i`` is appended last (cyclic chaining).  Materializes every
    span window: the plain version of
    :func:`~pyiga_tpu_torch.ops.cuda_sumfac.windowed_stage`, in the
    operands' dtype (float32 products in full float32)."""
    n, b, wsz = P.shape
    pspan = wsz // nqp
    nspans = X.shape[0] // nqp
    nwin = nspans - pspan + 1
    rest = tuple(X.shape[1:])
    X4 = X.reshape((nspans, nqp) + rest)
    # all length-(p+1) span windows, stacked: (nwin, pspan, nqp, *rest)
    W = torch.stack([X4[c:c + nwin] for c in range(pspan)], dim=1)
    G = W.reshape((nwin, wsz) + rest)[torch.as_tensor(fs, device=X.device)]
    with no_tf32(X.dtype):
        Y = torch.einsum('iw...,iow->...oi', G, P)
    return Y.reshape(rest + (b * n,))


def contract_chain_windowed(wtabs, fss, nqps, field):
    """Windowed contraction chain; returns the *banded-flat* data tensor
    ``(s_1, ..., s_d)`` with ``s_k = o_k*n_k + i_k`` (band offset major,
    zeros on the clipped-band padding)."""
    X = field
    for k in range(len(wtabs)):
        X = windowed_stage_plain(X, wtabs[k], fss[k], nqps[k])
    return X


def assemble_terms_windowed(wterm_tables, fss, nqps, fields, fold_plan=None,
                            tperms=None):
    """Sum of windowed chains (plain form), with optional symmetric
    folding: the mirrored terms are summed and their banded-flat
    transpose (`tperms`, :func:`banded_transpose_perm` per axis) is added;
    the direct terms are added as they are."""
    out = None
    sym = None
    plan = (fold_plan if fold_plan is not None
            else [(t, False) for t in range(len(wterm_tables))])
    for t, mirrored in plan:
        Y = contract_chain_windowed(wterm_tables[t], fss, nqps, fields[t])
        if mirrored:
            sym = Y if sym is None else sym + Y
        else:
            out = Y if out is None else out + Y
    if sym is not None:
        if not tperms:
            raise ValueError('fold_plan has mirrored terms but no tperms')
        symT = sym
        for k, p in enumerate(tperms):
            symT = torch.index_select(symT, k, torch.as_tensor(
                p, device=sym.device))
        sym = sym + symT
        out = sym if out is None else out + sym
    return out


def run_windowed_assembly(field_fn, geo_inputs, wterm_tables, fss, nqps,
                          fold_plan=None, tperms=None):
    """The windowed assembly (the reference's signature): the coefficient
    fields ``field_fn(geo_inputs)``, then the windowed chains of every
    term and the mirror on the fields' device
    (:func:`~pyiga_tpu_torch.ops.cuda_sumfac.assemble_terms_windowed`:
    kernels K8 and K8f on the card, their plain versions on the CPU).
    Tables, window starts and permutations may be numpy arrays or
    tensors; returns the *banded-flat* tensor (``s_k = o_k*n_k + i_k``)
    on the fields' device."""
    from .cuda_sumfac import assemble_terms_windowed as device_route
    fields = field_fn(geo_inputs)
    wtabs, idx = _upload(fields, wterm_tables,
                         list(fss) + list(tperms or ()))
    fss, perms = idx[:len(fss)], idx[len(fss):]
    return device_route(wtabs, fss, tuple(nqps), fields, fold_plan,
                        perms if tperms is not None else None)


def _upload(fields, term_tables, extra=()):
    """The `term_tables` (numpy or tensors; each distinct array once) in
    the dtype and on the device of `fields`, and the index arrays `extra`
    as int64 tensors there."""
    dev, dtype = fields[0].device, fields[0].dtype
    uploaded = {}

    def up(a, dt):
        if id(a) not in uploaded:
            uploaded[id(a)] = torch.as_tensor(
                np.ascontiguousarray(a) if isinstance(a, np.ndarray) else a,
                dtype=dt, device=dev)
        return uploaded[id(a)]
    return ([[up(T, dtype) for T in tabs] for tabs in term_tables],
            [up(p, torch.int64) for p in extra])


def _device_geo_inputs(geo_inputs, device):
    """`geo_inputs` as tensors: a dict already holding tensors stays as
    it is; numpy arrays go to `device` (default: the card) in the compute
    dtype (:func:`~pyiga_tpu_torch.convert.geo_inputs`)."""
    w = geo_inputs['weights'][0]
    if isinstance(w, torch.Tensor):
        return geo_inputs
    from ..convert import geo_inputs as to_device
    return to_device(geo_inputs, device=device)


def run_matrix_assembly(field_fn, geo_inputs, term_tables, fold_plan=None,
                        tperms=None, mode='exact', device=None):
    """The compact assembly with the reference's signature: the
    coefficient fields ``field_fn(geo_inputs)`` (e.g.
    :func:`~pyiga_tpu_torch.assemblers.stiffness_fields`: K2 and K1 on
    the card), then the chains of every term (K2 stages, one K3 fold per
    last-table group) and, with `fold_plan` / `tperms`, the transpose of
    the mirrored terms (:func:`~pyiga_tpu_torch.ops.cuda_sumfac.
    assemble_terms_folded`).  Tables and permutations may be numpy arrays
    or tensors; numpy `geo_inputs` go to `device` (default: the card).
    Returns the compact data tensor on the fields' device (the JAX
    package returns it as numpy).  `mode` is ignored (one exact route)."""
    from .cuda_sumfac import assemble_terms_folded as device_route
    last_idx = last_table_groups(term_tables)
    fields = field_fn(_device_geo_inputs(geo_inputs, device))
    tabs, tperms = _upload(fields, term_tables, tperms or ())
    plan = (fold_plan if fold_plan is not None
            else [(t, False) for t in range(len(term_tables))])
    return device_route(tabs, fields, plan, tperms or None, last_idx)


def run_banded_assembly(field_fn, geo_inputs, banded_tables, bsz, ns,
                        device=None):
    """Like :func:`run_matrix_assembly` with banded pair tables
    (:meth:`SpaceTables.banded_term_tables`), every term chained (no
    folding), and the result reordered into the regular banded layout
    ``(b_1, ..., b_d, n_1, ..., n_d)`` on the fields' device, the data
    of :class:`~pyiga_tpu_torch.ops.banded.BandedOperator`."""
    fields = field_fn(_device_geo_inputs(geo_inputs, device))
    last_idx = last_table_groups(banded_tables)
    tabs, _ = _upload(fields, banded_tables)
    return banded_reorder(assemble_terms(tabs, fields, last_idx=last_idx),
                          bsz, ns)


def banded_transpose_perm(n, bw):
    """Permutation of the banded-flat axis ``s = o*n + i`` mapping each valid
    pair (i, j=i+o-bw) to its transpose (j, i); padding entries (zero) map to
    themselves."""
    s = np.arange((2 * bw + 1) * n)
    o, i = s // n, s % n
    j = i + o - bw
    valid = (j >= 0) & (j < n)
    return np.where(valid, (2 * bw - o) * n + j, s)


def compact_from_banded_maps(structure, bws):
    """Per-level index maps: compact data position -> banded-flat position
    ``(j-i+bw)*n + i`` (separable takes convert banded-flat to compact)."""
    maps = []
    for (m, n), bidx, bw in zip(structure.bs, structure.bidx, bws):
        i = bidx[:, 0].astype(np.int64)
        j = bidx[:, 1].astype(np.int64)
        maps.append((j - i + bw) * n + i)
    return maps


def banded_fibers_exact(asm, rows):
    """Banded fibers of a Gauss assembler's matrix, evaluated on the host
    in plain float64 with no kernel in them: the parity spot check of the
    JAX package's bench (``bench.py:165-195`` ``_SPOT_SRC``), the
    rank-1-restricted chain of every term.

    A fiber fixes the banded rows ``rows[f] = (s_1, ..., s_{d-1})`` of
    the trailing axes (``s_k = mu_k n_k + i_k``, the position in the
    banded pair table, :meth:`SpaceTables.banded_pair_table`) and runs
    over the leading axis: ``fiber[mu_0 n_0 + i_0]``, the regular layout's
    entry ``D[mu_0, ..., i_0, ...]``.  Per term, the coefficient field is
    evaluated only at the Gauss points where the trailing rows' pair
    tables are nonzero (the geometry's Jacobian on that sub-grid, from the
    assembler's host tables and coefficients, then ``W (J^-1 J^-T)_ab`` or
    ``W``), contracted with those rows, then with the leading axis's
    table.  Takes the stiffness and mass assemblers (spline, NURBS or
    host-evaluated geometries).  Returns ``(len(rows), b_0 n_0)`` float64
    numpy; a row on the band's padding gives a zero fiber."""
    from . import geom
    from .banded import band_info
    d = asm.dim
    bws = band_info(asm.structure)
    btabs = asm.tables.banded_term_tables(asm.terms, bws)
    gi = asm._geo_inputs
    mass = len(asm.terms) == 1 and asm.terms[0] == (d * (0,), d * (0,))
    f64 = torch.float64
    out = np.zeros((len(rows), btabs[0][0].shape[0]))
    for f, row in enumerate(rows):
        # per trailing axis: the table rows of every term, and the Gauss
        # points where any of them is nonzero
        trow = [[np.asarray(tabs[k][row[k - 1]]) for tabs in btabs]
                for k in range(1, d)]
        pts = [np.flatnonzero(np.any(np.stack(tr) != 0, axis=0))
               for tr in trow]
        if any(len(p) == 0 for p in pts):
            continue
        sub = [np.arange(len(gi['weights'][0]))] + pts
        w = [torch.as_tensor(np.asarray(gi['weights'][k])[sub[k]], dtype=f64)
             for k in range(d)]
        if 'jac' in gi:
            jac = torch.as_tensor(np.asarray(gi['jac'])[
                (slice(None), slice(None)) + np.ix_(*sub)], dtype=f64)
        else:
            nurbs = 'geo_tables_nurbs' in gi
            tabs = gi['geo_tables_nurbs' if nurbs else 'geo_tables_bsp']
            _, jac = geom.geo_jacobian_field(
                [torch.as_tensor(np.asarray(t)[:, sub[k]], dtype=f64)
                 for k, t in enumerate(tabs)],
                torch.as_tensor(np.asarray(gi['geo_coeffs']), dtype=f64),
                nurbs, d)
        det, inv = geom.det_and_inv(jac)
        W = geom.gauss_weight_field(w) * torch.abs(det)
        if mass:
            fields = [W]
        else:
            fields = [W * sum(inv[a, m] * inv[b, m] for m in range(d))
                      for a in range(d) for b in range(d)]
        fib = torch.zeros(out.shape[1], dtype=f64)
        for t, C in enumerate(fields):
            for k in range(d - 1, 0, -1):       # the trailing axes
                C = torch.tensordot(C, torch.as_tensor(
                    trow[k - 1][t][pts[k - 1]], dtype=f64), dims=([k], [0]))
            fib = fib + torch.as_tensor(btabs[t][0], dtype=f64) @ C
        out[f] = fib.numpy()
    return out


def banded_fibers(D, bws, ns, rows):
    """The fibers of :func:`banded_fibers_exact` gathered from a flat
    banded layout ``D (C, F)`` (:class:`~pyiga_tpu_torch.ops.banded.
    FlatBandedOperator`'s data) on its device: ``(len(rows), b_0 n_0)``."""
    bsz = tuple(2 * b + 1 for b in bws)
    R = D.reshape(bsz + tuple(ns))
    out = []
    for row in rows:
        mus = tuple(int(s) // n for s, n in zip(row, ns[1:]))
        iis = tuple(int(s) % n for s, n in zip(row, ns[1:]))
        idx = (slice(None),) + mus + (slice(None),) + iis
        out.append(R[idx].reshape(-1))
    return torch.stack(out)


def banded_reorder(data, bsz, ns):
    """Reorder an assembly result over banded tables, shaped
    ``(b_1*n_1, ..., b_d*n_d)``, into ``(b_1, ..., b_d, n_1, ..., n_d)``."""
    d = len(ns)
    X = data.reshape([x for b, n in zip(bsz, ns) for x in (b, n)])
    perm = list(range(0, 2 * d, 2)) + list(range(1, 2 * d, 2))
    return X.permute(perm)


class SpaceTables:
    """Per-axis dense basis tables for a trial/test space pair on a Gauss
    grid, with cached pair tables per derivative combination (host numpy,
    float64)."""

    def __init__(self, kvs0, kvs1, grids, bidx, numderiv):
        self.d = len(kvs0)
        self.bidx = bidx
        self.kvs0, self.kvs1 = tuple(kvs0), tuple(kvs1)
        self.nqps = tuple(len(g) // (len(kv.mesh) - 1)
                          for kv, g in zip(kvs0, grids))
        self.trial = [dense_basis_table(kv, g, numderiv)
                      for kv, g in zip(kvs0, grids)]
        if kvs1 is kvs0 or all(a == b for a, b in zip(kvs0, kvs1)):
            self.test = self.trial
        else:
            self.test = [dense_basis_table(kv, g, numderiv)
                         for kv, g in zip(kvs1, grids)]
        self._pair_cache = {}

    def pair_table(self, k, du, dv):
        """Pair table ``(nnz_k, Q_k)`` for axis `k`: trial deriv `du` (column
        index of the pair) times test deriv `dv` (row index)."""
        key = (k, du, dv)
        tab = self._pair_cache.get(key)
        if tab is None:
            bx = self.bidx[k]
            tab = (self.test[k][dv][bx[:, 0].astype(np.int64), :]
                   * self.trial[k][du][bx[:, 1].astype(np.int64), :])
            self._pair_cache[key] = tab
        return tab

    def term_tables(self, terms):
        """Per term, the per-axis pair tables for derivative combos
        ``terms[t] = (du_tuple, dv_tuple)``."""
        return [[self.pair_table(k, du[k], dv[k]) for k in range(self.d)]
                for (du, dv) in terms]

    def banded_pair_table(self, k, du, dv, bw):
        """Pair table in regular banded layout: shape ``((2bw+1)*n, Q)`` with
        row ``mu*n + i`` = test-deriv(i) * trial-deriv(i + mu - bw)
        (zero where the column index falls outside the matrix)."""
        key = ('banded', k, du, dv, bw)
        tab = self._pair_cache.get(key)
        if tab is None:
            Bt = self.test[k][dv]
            Bu = self.trial[k][du]
            n, Q = Bt.shape
            if Bu.shape[0] != n:
                raise ValueError('banded layout requires square blocks')
            rows = np.zeros((2 * bw + 1, n, Q))
            for mu in range(2 * bw + 1):
                off = mu - bw
                i0, i1 = max(0, -off), min(n, n - off)
                rows[mu, i0:i1] = Bt[i0:i1] * Bu[i0 + off:i1 + off]
            tab = rows.reshape((2 * bw + 1) * n, Q)
            self._pair_cache[key] = tab
        return tab

    def banded_term_tables(self, terms, bws):
        """Banded pair tables for every term (see :meth:`banded_pair_table`)."""
        return [[self.banded_pair_table(k, du[k], dv[k], bws[k])
                 for k in range(self.d)] for (du, dv) in terms]

    def windowed_pair_table(self, k, du, dv):
        """Windowed pair table ``(n, 2p+1, (p+1)*nqp)`` for axis `k` (square
        single-knot spaces of equal trial and test degree): entry
        ``[i, o, w]`` is the test(dv)(i) * trial(du)(i+o-p) product at the
        `w`-th quadrature point of dof i's (p+1)-span support window (zero
        where ``i+o-p`` leaves the matrix).  Returns ``(table, fs)`` with
        `fs` the per-dof window start (span index, clipped at both ends:
        the first and last p dofs share a window)."""
        key = ('win', k, du, dv)
        cached = self._pair_cache.get(key)
        if cached is None:
            p = self.kvs0[k].p
            nqp = self.nqps[k]
            Bt, Bu = self.test[k][dv], self.trial[k][du]
            n, Q = Bt.shape
            if Bu.shape[0] != n:
                raise ValueError('windowed layout requires square blocks')
            # the (p+1)-span window is sized by the TRIAL degree; a
            # higher-degree test space would be silently truncated
            if self.kvs1[k].p != p:
                raise ValueError('windowed layout requires equal '
                                 'trial/test degrees')
            nwin = Q // nqp - p
            if nwin < 1:
                raise ValueError('windowed layout needs more spans than '
                                 'degree')
            wsz = (p + 1) * nqp
            fs = np.clip(np.arange(n) - p, 0, nwin - 1)
            tab = np.zeros((n, 2 * p + 1, wsz))
            for o in range(2 * p + 1):
                j = np.arange(n) + o - p
                for i in np.nonzero((j >= 0) & (j < n))[0]:
                    g0 = fs[i] * nqp
                    tab[i, o] = Bt[i, g0:g0 + wsz] * Bu[j[i], g0:g0 + wsz]
            cached = (tab, fs)
            self._pair_cache[key] = cached
        return cached

    def vector_term_tables(self, terms):
        """Per-axis *test* basis tables ``(n_k, Q_k)`` for arity-1 terms
        ``terms[t] = dv_tuple``."""
        return [[self.test[k][dv[k]] for k in range(self.d)] for dv in terms]

    def windowed_term_tables(self, terms):
        """Windowed pair tables for every term; returns ``(tables, fss)``."""
        tabs = [[self.windowed_pair_table(k, du[k], dv[k])[0]
                 for k in range(self.d)] for (du, dv) in terms]
        fss = [self.windowed_pair_table(k, 0, 0)[1] for k in range(self.d)]
        return tabs, fss


def quadrature_for(kvs, nqp=None, bdspec=None):
    """Tensor Gauss rule over the mesh of `kvs` with the reference's
    ``nqp = max(p) + 1`` convention; optionally restricted to the
    boundary face `bdspec` ``(axis, side)``."""
    if nqp is None:
        nqp = max(kv.p for kv in kvs) + 1
    meshes = [kv.mesh for kv in kvs]
    if bdspec is None:
        return make_tensor_quadrature(meshes, nqp)
    return make_boundary_quadrature(meshes, nqp, bdspec)
