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
"""

import numpy as np
import torch

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


def assemble_terms_folded(term_tables, fields, fold_plan, tperms,
                          last_idx=None):
    """Symmetric-term folding: one chain per mirrored term pair; the
    mirrored sum's transpose is a separable per-axis index permutation
    (`tperms`, LongTensors).  `fold_plan` is a sequence of
    ``(term_index, mirrored)``."""
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


def banded_transpose_perm(n, bw):
    """Permutation of the banded-flat axis ``s = o*n + i`` mapping each valid
    pair (i, j=i+o-bw) to its transpose (j, i); padding entries (zero) map to
    themselves."""
    s = np.arange((2 * bw + 1) * n)
    o, i = s // n, s % n
    j = i + o - bw
    valid = (j >= 0) & (j < n)
    return np.where(valid, (2 * bw - o) * n + j, s)


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
