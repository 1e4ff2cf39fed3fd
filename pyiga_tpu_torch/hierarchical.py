# -*- coding: utf-8 -*-
"""Hierarchical spline spaces: HB- and THB-spline bases over adaptively
refined tensor-product meshes (host, numpy/scipy; a copy of
:mod:`pyiga_tpu.hierarchical`, held equal to it by
``tests/test_torch_hierarchical.py``).

Algorithms after Garau & Vazquez 2018 (GeoPDEs) and Bracco, Giannelli &
Vazquez 2018.  Cells and basis functions are tracked as **sorted flat
(raveled) index arrays** per level, and every combinatorial operation
(supports, dyadic parent/child relations, refinement marking, smoothing
index sets) is a vectorized box computation on those arrays.
Multi-index tuples appear only at the public API boundary.

This index logic runs at setup time; the device work (bounding-box
restricted assembly, the local-multigrid V-cycle) lives in
:class:`HDiscretization` and the solvers.

Conventions:

* the **canonical order** of dofs is level-major, with each level's active
  functions in lexicographic (= raveled C-order) order;
* in the *virtual hierarchy* for level ``lv``, the dofs are the active
  functions of levels ``< lv`` plus the active-then-deactivated functions
  of level ``lv`` (each group sorted).
"""

import copy
import hashlib

import numpy as np
import scipy.sparse

from . import bspline, utils
from ._hdiscr import HDiscretization  # noqa: F401  (re-export)

_EMPTY = np.empty(0, dtype=np.intp)


def _strong_digest(a):
    """Strong content digest of an array's bytes for cache keys (Python's
    64-bit ``hash`` can collide silently)."""
    return hashlib.blake2b(np.ascontiguousarray(a).tobytes(),
                           digest_size=16).digest()


################################################################################
# flat-index primitives
################################################################################

def _as_flat(indices, shape):
    """Sorted unique flat indices from an iterable of multi-index tuples
    (or an already-flat integer array)."""
    if isinstance(indices, np.ndarray) and indices.ndim == 1:
        return np.unique(indices.astype(np.intp))
    seq = list(indices)
    if not seq:
        return _EMPTY
    multi = np.asarray(seq, dtype=np.intp).reshape(len(seq), len(shape))
    return np.unique(np.ravel_multi_index(tuple(multi.T), shape))


def _as_tuples(flat, shape):
    """Set of multi-index tuples from flat indices."""
    return set(_as_tuple_list(flat, shape))


def _as_tuple_list(flat, shape):
    """Multi-index tuples from flat indices, input order preserved."""
    return list(zip(*(ax.tolist() for ax in np.unravel_index(flat, shape))))


def _expand_boxes(lo, hi, shape):
    """Enumerate the cells of N axis-aligned half-open boxes.

    `lo`, `hi` are ``(N, d)`` integer arrays.  Returns ``(flat, valid)``
    where `flat` has shape ``(N, W_1, ..., W_d)`` (W_k = widest box on axis
    k) holding flat indices and `valid` masks the cells actually inside
    each box."""
    N, d = lo.shape
    widths = np.maximum((hi - lo).max(axis=0), 0) if N else np.zeros(d, int)
    flat = np.zeros((N,) + (1,) * d, dtype=np.intp)
    valid = np.ones((N,) + (1,) * d, dtype=bool)
    for k in range(d):
        offs = np.arange(widths[k], dtype=np.intp)
        rs = (1,) * k + (-1,) + (1,) * (d - 1 - k)
        coord = lo[:, k].reshape((N,) + (1,) * d) + offs.reshape((1,) + rs)
        inside = coord < hi[:, k].reshape((N,) + (1,) * d)
        flat = flat * shape[k] + np.where(inside, coord, 0)
        valid = valid & inside
    return flat, valid


def _box_union(lo, hi, shape):
    """Sorted unique flat indices covered by the union of the boxes."""
    if lo.shape[0] == 0:
        return _EMPTY
    flat, valid = _expand_boxes(lo, hi, shape)
    return np.unique(flat[valid])


def _boxes_subset_of(lo, hi, shape, target_flat):
    """Per box: is every cell of the box contained in the sorted flat
    index set `target_flat`?"""
    if lo.shape[0] == 0:
        return np.zeros(0, dtype=bool)
    flat, valid = _expand_boxes(lo, hi, shape)
    member = np.isin(flat, target_flat, assume_unique=False)
    ok = member | ~valid
    return ok.reshape(lo.shape[0], -1).all(axis=1)


def _boxes_intersect(lo, hi, shape, target_flat):
    """Per box: does any cell of the box lie in `target_flat`?"""
    if lo.shape[0] == 0:
        return np.zeros(0, dtype=bool)
    flat, valid = _expand_boxes(lo, hi, shape)
    member = np.isin(flat, target_flat) & valid
    return member.reshape(lo.shape[0], -1).any(axis=1)


def _range_boxes(tables, flat, shape):
    """Per-axis contiguous-range lookup: `tables[k]` is an ``(n_k, 2)``
    array of half-open ranges; returns the ``(N, d)`` `lo`/`hi` box arrays
    of the given flat indices."""
    multi = np.unravel_index(flat, shape)
    lo = np.stack([t[m, 0] for t, m in zip(tables, multi)], axis=-1)
    hi = np.stack([t[m, 1] for t, m in zip(tables, multi)], axis=-1)
    return lo.reshape(-1, len(shape)), hi.reshape(-1, len(shape))


def _contiguous_ranges_csc(P):
    """Per column of the CSC matrix `P`: the (contiguous) half-open row
    range of its nonzeros (spline refinement masks are interval-supported)."""
    n = P.shape[1]
    out = np.zeros((n, 2), dtype=np.intp)
    for j in range(n):
        rows = P.indices[P.indptr[j]:P.indptr[j + 1]]
        if len(rows):
            a, b = rows.min(), rows.max() + 1
            assert b - a == len(rows), 'non-contiguous refinement mask'
            out[j] = a, b
    return out


################################################################################
# Tensor-product mesh
################################################################################

class TPMesh:
    """A tensor-product mesh given by a tuple of knot vectors."""

    def __init__(self, kvs):
        self.kvs = tuple(kvs)
        self.dim = len(kvs)
        self.numspans = [kv.numspans for kv in kvs]
        self.numel = int(np.prod(self.numspans))
        self.numdofs = [kv.numdofs for kv in kvs]
        self.numbf = int(np.prod(self.numdofs))
        # function -> span range, and its inverse cell -> function range
        self.meshsupp = tuple(kv.mesh_support_idx_all() for kv in self.kvs)
        self.suppfunc = tuple(self._invert_ranges(ms, n)
                              for ms, n in zip(self.meshsupp, self.numspans))

    @staticmethod
    def _invert_ranges(ms, ncells):
        """Invert a monotone set of half-open ranges: per cell, the range of
        functions whose range contains it.  Both range endpoints of `ms` are
        nondecreasing, so searchsorted gives the bounds directly."""
        spans = np.arange(ncells)
        first = np.searchsorted(ms[:, 1], spans, side='right')
        last = np.searchsorted(ms[:, 0], spans, side='right')
        return np.column_stack((first, last))

    def __eq__(self, other):
        return self.kvs == other.kvs

    def refine(self):
        return TPMesh([kv.refine() for kv in self.kvs])

    def cells(self):
        """All cell multi-indices of this mesh (lexicographic order)."""
        return _as_tuple_list(np.arange(self.numel), self.numspans)

    def functions(self):
        """All basis-function multi-indices (lexicographic order)."""
        return _as_tuple_list(np.arange(self.numbf), self.numdofs)

    def cell_extents(self, c):
        """Min/max pairs per axis for the cell `c`."""
        return tuple((kv.mesh[ci], kv.mesh[ci + 1])
                     for kv, ci in zip(self.kvs, c))

    # -- flat-index core ---------------------------------------------------

    def support_ix(self, funcs):
        """Flat cells on which any of the given flat functions is nonzero."""
        lo, hi = _range_boxes(self.meshsupp, funcs, self.numdofs)
        return _box_union(lo, hi, self.numspans)

    def supported_in_ix(self, cells):
        """Flat functions whose support intersects the given flat cells."""
        lo, hi = _range_boxes(self.suppfunc, cells, self.numspans)
        return _box_union(lo, hi, self.numdofs)

    def funcs_with_support_inside(self, funcs, cellset):
        """Subset of the flat functions whose entire support lies inside
        the sorted flat cell set."""
        lo, hi = _range_boxes(self.meshsupp, funcs, self.numdofs)
        return funcs[_boxes_subset_of(lo, hi, self.numspans, cellset)]

    def funcs_with_support_intersecting(self, funcs, cellset):
        """Subset of the flat functions whose support intersects the sorted
        flat cell set."""
        lo, hi = _range_boxes(self.meshsupp, funcs, self.numdofs)
        return funcs[_boxes_intersect(lo, hi, self.numspans, cellset)]

    # -- tuple API -------------------------------------------------------------

    def support(self, indices):
        """Cells on which any of the given functions is nonzero."""
        return _as_tuples(self.support_ix(_as_flat(indices, self.numdofs)),
                          self.numspans)

    def supported_in(self, cells):
        """Functions whose support intersects the given cells."""
        return _as_tuples(
            self.supported_in_ix(_as_flat(cells, self.numspans)),
            self.numdofs)

    def neighbors(self, indices):
        """Functions with nontrivial support intersection with the given
        ones."""
        return _as_tuples(self.supported_in_ix(
            self.support_ix(_as_flat(indices, self.numdofs))), self.numdofs)


################################################################################
# Hierarchical mesh
################################################################################

class HMesh:
    """Hierarchy of dyadically refined TP meshes with per-level active /
    deactivated cell index arrays (implementation detail of
    :class:`HSpace`)."""

    def __init__(self, mesh):
        self.dim = mesh.dim
        self.meshes = [mesh]
        self._act = [np.arange(mesh.numel, dtype=np.intp)]
        self._deact = [_EMPTY]
        self.P = []
        self._child_rng = []        # per level: per-axis (n, 2) child ranges
        self._parent_rng = []       # per level: per-axis (n, 2) parent ranges

    # -- construction --------------------------------------------------------

    @staticmethod
    def _axis_prolongators(coarse, fine):
        return tuple(bspline.prolongation(k0, k1).tocsc()
                     for k0, k1 in zip(coarse.kvs, fine.kvs))

    def _append_prolongators(self, Ps):
        self.P.append(Ps)
        self._child_rng.append(tuple(_contiguous_ranges_csc(P) for P in Ps))
        self._parent_rng.append(tuple(
            _contiguous_ranges_csc(P.T.tocsc()) for P in Ps))

    @staticmethod
    def init_from_kvs(kvs, active, deactivated, P=None):
        """Build an HMesh from per-level knot vectors and cell sets (tuple
        sets or flat arrays)."""
        out = HMesh(TPMesh(kvs[0]))
        out.meshes = [TPMesh(kv) for kv in kvs]
        out._act = [_as_flat(a, m.numspans)
                    for a, m in zip(active, out.meshes)]
        out._deact = [_as_flat(d, m.numspans)
                      for d, m in zip(deactivated, out.meshes)]
        out.P, out._child_rng, out._parent_rng = [], [], []
        for a, b in zip(out.meshes[:-1], out.meshes[1:]):
            out._append_prolongators(
                P.pop(0) if P else HMesh._axis_prolongators(a, b))
        return out

    def add_level(self):
        self.meshes.append(self.meshes[-1].refine())
        self._act.append(_EMPTY)
        self._deact.append(_EMPTY)
        self._append_prolongators(self._axis_prolongators(*self.meshes[-2:]))

    def ensure_levels(self, L):
        while len(self.meshes) < L:
            self.add_level()

    # -- tuple-set views ------------------------------------------------------

    @property
    def active(self):
        return [_as_tuples(a, m.numspans)
                for a, m in zip(self._act, self.meshes)]

    @property
    def deactivated(self):
        return [_as_tuples(d, m.numspans)
                for d, m in zip(self._deact, self.meshes)]

    # -- dyadic cell hierarchy (flat) ------------------------------------------

    def cell_children_ix(self, lv, cells):
        if not 0 <= lv < len(self.meshes) - 1:
            raise ValueError('level %d has no finer level' % lv)
        multi = np.unravel_index(cells, self.meshes[lv].numspans)
        lo = 2 * np.stack(multi, axis=-1).reshape(-1, self.dim)
        return _box_union(lo, lo + 2, self.meshes[lv + 1].numspans)

    def cell_parent_ix(self, lv, cells):
        if not 1 <= lv < len(self.meshes):
            raise ValueError('level %d has no coarser level' % lv)
        multi = [m // 2 for m in
                 np.unravel_index(cells, self.meshes[lv].numspans)]
        return np.unique(np.ravel_multi_index(
            tuple(multi), self.meshes[lv - 1].numspans))

    def _cells_across(self, lv, cells, targetlv):
        """Flat cells at `targetlv` descended from / containing the given
        flat level-`lv` cells."""
        while lv < targetlv:
            cells = self.cell_children_ix(lv, cells)
            lv += 1
        while lv > targetlv:
            cells = self.cell_parent_ix(lv, cells)
            lv -= 1
        return cells

    # -- function hierarchy (flat, via refinement-mask ranges) -------------------

    def fn_children_ix(self, lv, funcs):
        assert 0 <= lv < len(self.meshes) - 1, 'invalid level'
        lo, hi = _range_boxes(self._child_rng[lv], funcs,
                              self.meshes[lv].numdofs)
        return _box_union(lo, hi, self.meshes[lv + 1].numdofs)

    def fn_parents_ix(self, lv, funcs):
        # negative-index wraparound at lv=0 would silently return garbage
        assert 0 < lv < len(self.meshes), 'invalid level'
        lo, hi = _range_boxes(self._parent_rng[lv - 1], funcs,
                              self.meshes[lv].numdofs)
        return _box_union(lo, hi, self.meshes[lv - 1].numdofs)

    def _funcs_across(self, lv, funcs, targetlv):
        while lv < targetlv:
            funcs = self.fn_children_ix(lv, funcs)
            lv += 1
        while lv > targetlv:
            funcs = self.fn_parents_ix(lv, funcs)
            lv -= 1
        return funcs

    def child_pattern(self, lv):
        """Sparse binary (numbf_lv, numbf_lv+1) function-children incidence
        (the sparsity pattern of the TP prolongator)."""
        factors = []
        for P in self.P[lv]:
            B = P.copy().T.tocsr()
            B.data = np.ones_like(B.data)
            factors.append(B)
        return utils.multi_kron_sparse(factors, format='csr')

    # -- tuple APIs -------------------------------------------------------------

    def _cells_flat(self, lv, cells):
        return _as_flat(cells, self.meshes[lv].numspans)

    def cell_children(self, lv, cells):
        return list(_as_tuples(
            self.cell_children_ix(lv, self._cells_flat(lv, cells)),
            self.meshes[lv + 1].numspans))

    def cell_grandchildren(self, lv, cells, targetlv=None):
        targetlv = targetlv or (len(self.meshes) - 1)
        if not 0 <= lv < targetlv < len(self.meshes):
            raise ValueError('invalid level pair (%d, %d)' % (lv, targetlv))
        return list(_as_tuples(
            self._cells_across(lv, self._cells_flat(lv, cells), targetlv),
            self.meshes[targetlv].numspans))

    def cell_parent(self, lv, cells):
        return _as_tuples(self.cell_parent_ix(lv, self._cells_flat(lv, cells)),
                          self.meshes[lv - 1].numspans)

    def cell_grandparent(self, lv, cells, targetlv=None):
        targetlv = targetlv or 0
        if not 0 <= targetlv < lv < len(self.meshes):
            raise ValueError('invalid level pair (%d, %d)' % (lv, targetlv))
        return _as_tuples(
            self._cells_across(lv, self._cells_flat(lv, cells), targetlv),
            self.meshes[targetlv].numspans)

    def function_children(self, lv, indices):
        return _as_tuples(self.fn_children_ix(
            lv, _as_flat(indices, self.meshes[lv].numdofs)),
            self.meshes[lv + 1].numdofs)

    def function_grandchildren(self, lv, indices, targetlv=None):
        if not targetlv:
            targetlv = len(self.meshes) - 1
        assert 0 <= lv < targetlv < len(self.meshes), 'Invalid levels'
        return _as_tuples(self._funcs_across(
            lv, _as_flat(indices, self.meshes[lv].numdofs), targetlv),
            self.meshes[targetlv].numdofs)

    def function_parents(self, lv, indices):
        return _as_tuples(self.fn_parents_ix(
            lv, _as_flat(indices, self.meshes[lv].numdofs)),
            self.meshes[lv - 1].numdofs)

    def function_grandparents(self, lv, indices, targetlv=None):
        if not targetlv:
            targetlv = 0
        assert 0 <= targetlv < lv < len(self.meshes), 'Invalid levels'
        return _as_tuples(self._funcs_across(
            lv, _as_flat(indices, self.meshes[lv].numdofs), targetlv),
            self.meshes[targetlv].numdofs)

    # -- hierarchical cell resolution ---------------------------------------------

    def resolve_ix(self, lv, cells):
        """Distribute flat level-`lv` cells onto the active hierarchical
        cells covering them: cells already refined away descend to their
        active children, cells inside a coarser active region ascend."""
        known = np.union1d(self._act[lv], self._deact[lv])
        out = {}

        pending = np.intersect1d(cells, known)
        for l in range(lv, len(self.meshes)):
            found = np.intersect1d(pending, self._act[l])
            out[l] = np.union1d(out.get(l, _EMPTY), found)
            pending = np.setdiff1d(pending, found)
            if not len(pending):
                break
            if l == len(self.meshes) - 1:
                raise ValueError('Invalid cells detected: %s' % pending)
            pending = self.cell_children_ix(l, pending)

        pending = np.setdiff1d(cells, known)
        for l in range(lv, -1, -1):
            found = np.intersect1d(pending, self._act[l])
            out[l] = np.union1d(out.get(l, _EMPTY), found)
            pending = np.setdiff1d(pending, found)
            if not len(pending):
                break
            if l == 0:
                raise ValueError('Invalid cells detected: %s' % pending)
            pending = self.cell_parent_ix(l, pending)
        return out

    def hmesh_cells(self, cells):
        """Smallest dict-of-sets of active hierarchical cells containing the
        given per-level cells (list or dict of tuple sets / flat arrays)."""
        if isinstance(cells, dict):
            items = cells.items()
        else:
            items = enumerate(cells)
        acc = {}
        for lv, cls in items:
            flat = self._cells_flat(lv, cls)
            if not len(flat):
                continue
            for l, found in self.resolve_ix(lv, flat).items():
                acc[l] = np.union1d(acc.get(l, _EMPTY), found)
        return {l: _as_tuples(c, self.meshes[l].numspans)
                for l, c in acc.items() if len(c)}

    # -- refinement -------------------------------------------------------------

    def refine_ix(self, marked):
        """Deactivate the marked flat cells (dict lv -> flat array) and
        activate their children; returns dict of newly activated flat
        cells."""
        max_lv = max(lv for lv, cells in marked.items() if len(cells))
        self.ensure_levels(max_lv + 2)

        born = {}
        for lv in range(len(self.meshes) - 1):
            cells = marked.get(lv, _EMPTY)
            cells = np.intersect1d(np.asarray(cells, dtype=np.intp),
                                   self._act[lv])
            self._act[lv] = np.setdiff1d(self._act[lv], cells)
            self._deact[lv] = np.union1d(self._deact[lv], cells)
            kids = (self.cell_children_ix(lv, cells) if len(cells)
                    else _EMPTY)
            born[lv + 1] = kids
            self._act[lv + 1] = np.union1d(self._act[lv + 1], kids)
        return born

    def refine(self, marked):
        """Tuple-level wrapper around :meth:`refine_ix`."""
        flat = {lv: self._cells_flat(lv, cells)
                for lv, cells in marked.items()}
        born = self.refine_ix(flat)
        return {lv: list(_as_tuples(c, self.meshes[lv].numspans))
                for lv, c in born.items()}

    def get_virtual_mesh(self, level):
        """The hierarchical mesh truncated at the given level (refinements
        of deeper levels undone)."""
        assert 0 <= level < len(self.meshes)
        out = HMesh(self.meshes[0])
        for i in range(level + 1):
            if len(self._deact[i]):
                out.refine_ix({i: self._deact[i]})
            else:
                out.ensure_levels(i + 1)
        return out


################################################################################
# HSpace
################################################################################

class HSpace:
    """An HB-/THB-spline space over an adaptively refined mesh.

    Args:
        kvs: knot vectors of the coarsest tensor-product level.
        truncate: True for THB-splines, False (default) for HB-splines.
        disparity: maximum level distance of interacting functions
            (``np.inf`` = unrestricted); respected by :meth:`refine`.
        bdspecs: boundaries on which dofs are eliminated (Dirichlet).

    """

    def __init__(self, kvs, truncate=False, disparity=np.inf, bdspecs=None):
        hmesh = HMesh(TPMesh(kvs))
        self.dim = hmesh.dim
        self.hmesh = hmesh
        self.truncate = bool(truncate)
        self._af = [np.arange(hmesh.meshes[0].numbf, dtype=np.intp)]
        self._df = [_EMPTY]
        self.disparity = disparity
        if bdspecs is not None:
            bdspecs = [bspline._parse_bdspec(bd, self.dim) for bd in bdspecs]
        self.bdspecs = bdspecs
        self._invalidate()

    def _invalidate(self):
        self._cache = {}

    @staticmethod
    def init_from_kvs(kvs, active_cells, deactivated_cells, active_funcs,
                      deactivated_funcs, P=None, truncate=False,
                      disparity=np.inf, bdspecs=None):
        """Build an HSpace from explicit per-level data (tuple sets or flat
        arrays)."""
        out = HSpace(kvs[0], truncate=truncate, disparity=disparity,
                     bdspecs=bdspecs)
        out.hmesh = HMesh.init_from_kvs(kvs, active_cells, deactivated_cells,
                                        P=list(P) if P else None)
        out._af = [_as_flat(a, m.numdofs)
                   for a, m in zip(active_funcs, out.hmesh.meshes)]
        out._df = [_as_flat(d, m.numdofs)
                   for d, m in zip(deactivated_funcs, out.hmesh.meshes)]
        out._invalidate()
        return out

    def _ensure_levels(self, L):
        while self.numlevels < L:
            self.hmesh.add_level()
            self._af.append(_EMPTY)
            self._df.append(_EMPTY)

    # -- basic queries ---------------------------------------------------------

    @property
    def numlevels(self):
        return len(self.hmesh.meshes)

    @property
    def numdofs(self):
        """Total number of active basis functions."""
        return sum(self.numactive)

    @property
    def numactive(self):
        """Number of active basis functions per level."""
        return tuple(len(a) for a in self._af)

    @property
    def actfun(self):
        """Per level, the set of active function multi-indices (view)."""
        return [_as_tuples(a, m.numdofs)
                for a, m in zip(self._af, self.hmesh.meshes)]

    @property
    def deactfun(self):
        """Per level, the set of deactivated function multi-indices (view)."""
        return [_as_tuples(d, m.numdofs)
                for d, m in zip(self._df, self.hmesh.meshes)]

    def mesh(self, lv):
        return self.hmesh.meshes[lv]

    def knotvectors(self, lv):
        return self.hmesh.meshes[lv].kvs

    def active_cells(self, lv=None, flat=False):
        """Active cells on one level, per level, or flat in canonical
        order."""
        if lv is not None:
            return _as_tuples(self.hmesh._act[lv], self.mesh(lv).numspans)
        if flat:
            return [(l, c) for l in range(self.numlevels)
                    for c in sorted(self.active_cells(l))]
        return [self.active_cells(l) for l in range(self.numlevels)]

    @property
    def total_active_cells(self):
        return sum(len(a) for a in self.hmesh._act)

    def active_functions(self, lv=None, flat=False):
        """Active functions on one level, per level, or flat canonical."""
        if lv is not None:
            return _as_tuples(self._af[lv], self.mesh(lv).numdofs)
        if flat:
            return [(l, f) for l in range(self.numlevels)
                    for f in sorted(self.active_functions(l))]
        return self.actfun

    def deactivated_cells(self, lv=None):
        if lv is not None:
            return _as_tuples(self.hmesh._deact[lv], self.mesh(lv).numspans)
        return [self.deactivated_cells(l) for l in range(self.numlevels)]

    def cell_extents(self, lv, c):
        return self.hmesh.meshes[lv].cell_extents(c)

    def function_support(self, lv, jj):
        """Support of the function `jj` on level `lv` as min/max pairs."""
        out = []
        for kv, j in zip(self.mesh(lv).kvs, jj):
            lo, hi = kv.mesh_support_idx(j)
            out.append((kv.mesh[lo], kv.mesh[hi]))
        return tuple(out)

    # -- index conversion --------------------------------------------------------

    def ravel_indices(self, indices):
        """Per level: multi-index collections become raveled index arrays;
        already-flat arrays pass through (order preserved for arrays, sorted
        for sets)."""
        out = []
        for lv in range(self.numlevels):
            ix = indices[lv]
            if isinstance(ix, np.ndarray):
                out.append(ix.astype(np.intp))
            else:
                # sets have no order; anything order-carrying passes
                # through unchanged (sweep orders are contractual)
                seq = sorted(ix) if isinstance(ix, (set, frozenset)) \
                    else list(ix)
                if seq:
                    out.append(np.ravel_multi_index(
                        np.asarray(seq, dtype=np.intp).T,
                        self.mesh(lv).numdofs))
                else:
                    out.append(_EMPTY)
        return tuple(out)

    def active_indices(self):
        return tuple(self._af)

    def deactivated_indices(self):
        return tuple(self._df)

    def _virtual_avail(self, lv):
        """Canonical availability arrays of virtual level `lv`: per level i,
        the flat dofs present, in canonical segment order."""
        return [self._af[i] if i < lv
                else (np.concatenate((self._af[lv], self._df[lv]))
                      if i == lv else _EMPTY)
                for i in range(self.numlevels)]

    def raveled_to_virtual_canonical_indices(self, lv, indices):
        """Map per-level raveled TP indices to canonical matrix indices
        within the virtual hierarchy level `lv` (input order preserved)."""
        avail = self._virtual_avail(lv)
        offset = 0
        out = []
        for i in range(self.numlevels):
            ix = np.asarray(indices[i], dtype=np.intp)
            if len(ix):
                lut = np.full(self.mesh(i).numbf, -1, dtype=np.intp)
                lut[avail[i][::-1]] = offset + np.arange(len(avail[i]))[::-1]
                pos = lut[ix]
                assert (pos >= 0).all(), 'index not present in virtual level'
                out.append(pos)
            offset += len(avail[i])
        return (np.concatenate(out) if out else _EMPTY)

    def _levelwise_to_canonical(self, indices, raveled=False):
        if not raveled:
            indices = self.ravel_indices(indices)
        return self.raveled_to_virtual_canonical_indices(
            self.numlevels - 1, indices)

    @property
    def ravel_global(self):
        if 'ravel_global' not in self._cache:
            self._cache['ravel_global'] = [
                self._virtual_avail(lv) for lv in range(self.numlevels)]
        return self._cache['ravel_global']

    # -- Dirichlet handling --------------------------------------------------------

    def _boundary_cells_lv(self, lv, bdspec):
        from .assemble import boundary_cells
        return _as_flat(map(tuple, boundary_cells(self.mesh(lv).kvs, bdspec)),
                        self.mesh(lv).numspans)

    def _boundary_funcs_lv(self, lv, bdspec):
        from .assemble import boundary_dofs
        return _as_flat(map(tuple, boundary_dofs(self.mesh(lv).kvs, bdspec)),
                        self.mesh(lv).numdofs)

    def _boundary_funcs_all(self, lv):
        out = _EMPTY
        for bdspec in (self.bdspecs or []):
            out = np.union1d(out, self._boundary_funcs_lv(lv, bdspec))
        return out

    def _compute_dirichlet(self):
        """Per virtual level lv and per level i: the boundary dofs present
        in virtual level lv, as flat arrays in canonical segment order
        (active part, then at i == lv the deactivated part)."""
        bd = [self._boundary_funcs_all(lv) for lv in range(self.numlevels)]
        per_vl = []
        for lv in range(self.numlevels):
            row = []
            for i in range(self.numlevels):
                if i < lv:
                    row.append(np.intersect1d(self._af[i], bd[i]))
                elif i == lv:
                    row.append(np.concatenate((
                        np.intersect1d(self._af[lv], bd[lv]),
                        np.intersect1d(self._df[lv], bd[lv]))))
                else:
                    row.append(_EMPTY)
            per_vl.append(row)
        return per_vl

    @property
    def ravel_dirichlet(self):
        if 'dirichlet' not in self._cache:
            self._cache['dirichlet'] = self._compute_dirichlet()
        return self._cache['dirichlet']

    # backward-compatible alias (same flat arrays serve both purposes)
    index_dirichlet = ravel_dirichlet

    def dirichlet_dofs(self, lv=None):
        """Canonical indices lying on the Dirichlet boundaries."""
        if lv is None:
            lv = self.numlevels - 1
        return self.raveled_to_virtual_canonical_indices(
            lv, self.ravel_dirichlet[lv])

    def non_dirichlet_dofs(self):
        """Canonical indices away from the Dirichlet boundaries."""
        return np.setdiff1d(np.arange(self.numdofs), self.dirichlet_dofs())

    # -- virtual hierarchy index sets (local MG smoothing sets) ----------------------

    def _empty_grid(self):
        return [[_EMPTY for _ in range(self.numlevels)]
                for _ in range(self.numlevels)]

    def new_indices(self):
        """Per virtual level, the newly added functions (active +
        deactivated of that level), Dirichlet dofs removed."""
        out = self._empty_grid()
        for lv in range(self.numlevels):
            D = self.ravel_dirichlet[lv][lv]
            out[lv][lv] = np.concatenate((
                np.setdiff1d(self._af[lv], D),
                np.setdiff1d(self._df[lv], D)))
        return out

    def _disparity_window(self, lv):
        lo = lv - self.disparity
        return range(int(max(0, lo)), lv)

    def trunc_indices(self):
        """Per virtual level, the coarse functions interacting through
        truncation: function j of level i is included at virtual level lv
        if some descendant of j (not yet absorbed by an intermediate level)
        is active or deactivated on level lv."""
        out = self.new_indices()
        desc = {}       # level i -> (row functions, descendant incidence)
        for lv in range(self.numlevels):
            desc[lv] = (self._af[lv], _selection_rows(
                self._af[lv], self.mesh(lv).numbf))
            pattern = (self.hmesh.child_pattern(lv - 1)
                       if self._disparity_window(lv) else None)
            for i in self._disparity_window(lv):
                funcs, D = desc[i]
                D = (D @ pattern).tocsr()
                D.data = np.ones_like(D.data)
                hit_cols = np.union1d(self._af[lv], self._df[lv])
                mask = np.zeros(D.shape[1], dtype=bool)
                mask[hit_cols] = True
                hits = (D @ mask.astype(D.dtype)) > 0
                found = funcs[hits]
                # absorbed descendants are dropped from further tracking
                keep = scipy.sparse.diags((~mask).astype(D.dtype))
                desc[i] = (funcs, (D @ keep).tocsr())
                out[lv][i] = np.setdiff1d(found, self.ravel_dirichlet[lv][i])
        return out

    def func_supp_indices(self):
        """Per virtual level, coarse active functions that are
        (grand)parents of the active fine functions."""
        out = self.new_indices()
        for lv in range(self.numlevels):
            for i in self._disparity_window(lv):
                anc = self.hmesh._funcs_across(lv, self._af[lv], i)
                funcs = np.intersect1d(anc, self._af[i])
                out[lv][i] = np.setdiff1d(funcs, self.ravel_dirichlet[lv][i])
        return out

    def cell_supp_indices(self, remove_dirichlet=True):
        """Per virtual level, coarse active functions whose support
        intersects the support of the new fine functions."""
        out = self.new_indices()
        for lv in range(self.numlevels):
            supp = self.mesh(lv).support_ix(self._af[lv])
            for i in self._disparity_window(lv):
                up = self.hmesh._cells_across(lv, supp, i)
                funcs = np.intersect1d(self.mesh(i).supported_in_ix(up),
                                       self._af[i])
                if remove_dirichlet:
                    funcs = np.setdiff1d(funcs, self.ravel_dirichlet[lv][i])
                out[lv][i] = funcs
        return out

    def global_indices(self, vlvl=None):
        """Per virtual level, all functions of that virtual space (canonical
        segment order)."""
        if vlvl is None:
            return [self.global_indices(j) for j in range(self.numlevels)]
        return self._virtual_avail(vlvl)

    def indices_to_smooth(self, strategy='func_supp'):
        """Smoothing index sets (canonical, per virtual level) for the local
        multigrid solver."""
        if strategy not in ('new', 'trunc', 'func_supp', 'cell_supp'):
            raise ValueError('Invalid smoothing strategy')
        chosen = getattr(self, strategy + '_indices')()
        return [self.raveled_to_virtual_canonical_indices(lv, chosen[lv])
                for lv in range(self.numlevels)]

    # -- supports -------------------------------------------------------------------

    def compute_supports(self, functions):
        """Active hierarchical cells covering the supports of the given
        per-level function collections.  Levels beyond this (possibly
        virtual, hence truncated) space's depth are structurally empty and
        are skipped."""
        supports = [self.mesh(l).support_ix(_as_flat(fs, self.mesh(l).numdofs))
                    for l, fs in enumerate(functions)
                    if l < self.numlevels]
        return self.hmesh.hmesh_cells(supports)

    def compute_virtual_supports(self, per_level):
        return tuple(self.get_virtual_space(lv).compute_supports(functions)
                     for lv, functions in enumerate(per_level))

    @property
    def cell_dirichlet(self):
        return self.compute_virtual_supports(self.ravel_dirichlet)

    @property
    def cell_new(self):
        return self.compute_virtual_supports(self.new_indices())

    @property
    def cell_trunc(self):
        return self.compute_virtual_supports(self.trunc_indices())

    @property
    def cell_func_supp(self):
        return self.compute_virtual_supports(self.func_supp_indices())

    @property
    def cell_cell_supp(self):
        return self.compute_virtual_supports(self.cell_supp_indices())

    @property
    def cell_global(self):
        return self.compute_virtual_supports(self.global_indices())

    # -- refinement -------------------------------------------------------------------

    def _functions_to_deactivate(self, marked):
        """Per level: active functions with no remaining active cell in
        their support after the marked flat cells are deactivated."""
        out = {}
        for lv in range(self.numlevels):
            m = marked.get(lv, _EMPTY)
            if not len(m):
                out[lv] = _EMPTY
                continue
            msh = self.mesh(lv)
            cand = np.intersect1d(msh.supported_in_ix(m), self._af[lv])
            alive = msh.funcs_with_support_intersecting(
                cand, self.hmesh._act[lv])
            out[lv] = np.setdiff1d(cand, alive)
        return out

    def _support_extension_cells(self, l, cells, k):
        """Support extension: cells at level `k` <= `l` covered by the
        supports of all level-`k` functions living on (the ancestors of)
        the given flat level-`l` cells."""
        up = cells if k == l else self.hmesh._cells_across(l, cells, k)
        msh = self.mesh(k)
        return msh.support_ix(msh.supported_in_ix(up))

    def cell_support_extension(self, l, cells, k):
        assert 0 <= k <= l, 'Invalid level.'
        flat = self.hmesh._cells_flat(l, cells)
        return _as_tuples(self._support_extension_cells(l, flat, k),
                          self.mesh(k).numspans)

    def function_support_extension(self, l, functions, k):
        assert 0 <= k <= l, 'Invalid level.'
        supp = self.mesh(l).support_ix(
            _as_flat(functions, self.mesh(l).numdofs))
        if k != l:
            supp = self.hmesh._cells_across(l, supp, k)
        return _as_tuples(self.mesh(k).supported_in_ix(supp),
                          self.mesh(k).numdofs)

    def _neighborhood_ix(self, l, cells, truncate):
        """Active coarse cells (level l - disparity) whose refinement the
        disparity condition forces when the given level-`l` cells refine."""
        k = l - self.disparity
        if k < 0 or not len(cells):
            return _EMPTY
        if truncate:
            ext = self._support_extension_cells(l, cells, k + 1)
            near = self.hmesh.cell_parent_ix(k + 1, ext)
        else:
            near = self._support_extension_cells(l, cells, k)
        return np.intersect1d(self.hmesh._act[k], near)

    def refine(self, marked, truncate=False):
        """Refine the marked cells (dict level -> cells), preserving the
        mesh-level disparity [Bracco, Giannelli & Vazquez 2018].  Returns
        the cells actually refined."""
        max_lv = max(lv for lv, cells in marked.items() if len(cells))
        self._ensure_levels(max_lv + 2)

        flat = {lv: self.hmesh._cells_flat(lv, cells)
                for lv, cells in marked.items()}
        if self.disparity < np.inf:
            # propagate marks downward until the disparity condition holds
            for l in range(self.numlevels):
                lv, cur = l, flat.get(l, _EMPTY)
                while True:
                    forced = self._neighborhood_ix(lv, cur, truncate)
                    forced = np.setdiff1d(
                        forced, flat.get(lv - self.disparity, _EMPTY))
                    if not len(forced):
                        break
                    lv -= self.disparity
                    flat[lv] = np.union1d(flat.get(lv, _EMPTY), forced)
                    cur = flat[lv]

        born = self.hmesh.refine_ix(flat)
        dying = self._functions_to_deactivate(flat)

        for lv in range(self.numlevels - 1):
            self._af[lv] = np.setdiff1d(self._af[lv], dying[lv])
            self._df[lv] = np.union1d(self._df[lv], dying[lv])
            msh = self.mesh(lv + 1)
            cand = np.setdiff1d(msh.supported_in_ix(born[lv + 1]),
                                self._af[lv + 1])
            covered = np.union1d(self.hmesh._act[lv + 1],
                                 self.hmesh._deact[lv + 1])
            newly = msh.funcs_with_support_inside(cand, covered)
            self._af[lv + 1] = np.union1d(self._af[lv + 1], newly)

        self._invalidate()
        return {lv: _as_tuples(c, self.mesh(lv).numspans)
                for lv, c in flat.items()}

    def refine_region(self, lv, region_function):
        """Refine all active cells on level `lv` whose center satisfies
        `region_function` (arguments in XYZ order)."""
        self._ensure_levels(lv + 2)
        msh = self.mesh(lv)
        centers = [0.5 * (kv.mesh[:-1] + kv.mesh[1:]) for kv in msh.kvs]
        multi = np.unravel_index(self.hmesh._act[lv], msh.numspans)
        pts = [c[m] for c, m in zip(centers, multi)]     # per-axis, ZYX
        hit = np.array([bool(region_function(*xyz))
                        for xyz in zip(*reversed(pts))])
        return self.refine({lv: self.hmesh._act[lv][hit]})

    # -- space relations -----------------------------------------------------------

    def get_virtual_space(self, lv):
        """The virtual-hierarchy space at level `lv` (deeper refinements
        undone)."""
        if lv is None:
            lv = self.numlevels - 1
        assert 0 <= lv < self.numlevels, 'Invalid level.'
        out = self.copy()
        if lv != self.numlevels - 1:
            hm = out.hmesh
            out._af = out._af[:lv + 1]
            out._df = out._df[:lv + 1]
            hm._act = hm._act[:lv + 1]
            hm._deact = hm._deact[:lv + 1]
            hm.meshes = hm.meshes[:lv + 1]
            hm.P = hm.P[:lv]
            hm._child_rng = hm._child_rng[:lv]
            hm._parent_rng = hm._parent_rng[:lv]
            out._af[lv] = np.union1d(out._af[lv], out._df[lv])
            out._df[lv] = _EMPTY
            hm._act[lv] = np.union1d(hm._act[lv], hm._deact[lv])
            hm._deact[lv] = _EMPTY
            out._invalidate()
        return out

    def copy(self):
        return copy.deepcopy(self)

    def is_subspace_of(self, other, check_kv=True):
        """Whether `self` is a subspace of `other`."""
        if self.numlevels > other.numlevels:
            return False
        if check_kv and self.hmesh.meshes != \
                other.hmesh.meshes[:self.numlevels]:
            return False
        return all(len(np.setdiff1d(d, od)) == 0
                   for d, od in zip(self._df, other._df))

    def spans_same_space_as(self, other, check_kv=True):
        """Whether `self` and `other` span the same space."""
        if self.numlevels != other.numlevels:
            return False
        if check_kv and self.hmesh.meshes != \
                other.hmesh.meshes[:self.numlevels]:
            return False
        return all(np.array_equal(a, oa) and np.array_equal(d, od)
                   for a, oa, d, od in zip(self._af, other._af,
                                           self._df, other._df))

    def __eq__(self, other):
        return self.spans_same_space_as(other)

    def boundary(self, bdspec):
        """Restriction of this space to a boundary face as a (dim-1)-dim
        HSpace plus the canonical indices of the boundary functions."""
        bdspec = bspline._parse_bdspec(bdspec, self.dim)
        ax = bdspec[0]

        def drop_axis(tuples):
            return set(t[:ax] + t[ax + 1:] for t in tuples)

        act_f, act_c, deact_f, deact_c, mapping = [], [], [], [], []
        for lv in range(self.numlevels):
            bfuncs = self._boundary_funcs_lv(lv, bdspec)
            bcells = self._boundary_cells_lv(lv, bdspec)
            on_bd = np.intersect1d(self._af[lv], bfuncs)
            mapping.append(on_bd)
            nd, ns = self.mesh(lv).numdofs, self.mesh(lv).numspans
            act_f.append(drop_axis(_as_tuples(on_bd, nd)))
            deact_f.append(drop_axis(_as_tuples(
                np.intersect1d(self._df[lv], bfuncs), nd)))
            act_c.append(drop_axis(_as_tuples(
                np.intersect1d(self.hmesh._act[lv], bcells), ns)))
            deact_c.append(drop_axis(_as_tuples(
                np.intersect1d(self.hmesh._deact[lv], bcells), ns)))

        mapping_can = self._levelwise_to_canonical(mapping, raveled=True)
        kvs = [tuple(kv for j, kv in enumerate(self.mesh(lv).kvs) if j != ax)
               for lv in range(self.numlevels)]

        while act_c and not act_c[-1]:
            act_c.pop(); deact_c.pop(); act_f.pop(); deact_f.pop()
        bd_space = HSpace.init_from_kvs(
            kvs[:len(act_c)], act_c, deact_c, act_f, deact_f,
            truncate=self.truncate, disparity=self.disparity)
        return bd_space, mapping_can

    def prolongate_to(self, fine, check_nestedness=False,
                      check_nestedness_kv=False):
        """Prolongation matrix from `self` into the refined HSpace `fine`
        (``self.is_subspace_of(fine)`` assumed)."""
        if check_nestedness and not self.is_subspace_of(
                fine, check_kv=check_nestedness_kv):
            raise RuntimeError('HSpace is not a subspace')
        disparity = max(self.disparity, fine.disparity)
        cL, fL = self.numlevels, fine.numlevels

        f_offsets = np.concatenate([[0], np.cumsum(fine.numactive)])
        f_can = [np.arange(f_offsets[l], f_offsets[l + 1]) for l in range(fL)]

        # coarse-active functions replaced by finer ones in `fine`
        replaced = [np.setdiff1d(self._af[l], fine._af[l]) for l in range(cL)]
        replaced_can = []
        for lv in range(cL):
            per_level = [replaced[lv] if i == lv else _EMPTY
                         for i in range(cL)]
            replaced_can.append(self._levelwise_to_canonical(
                per_level, raveled=True))

        # shared active functions map by identity
        common = [np.intersect1d(self._af[l], fine._af[l]) for l in range(cL)]
        common_c = self._levelwise_to_canonical(common, raveled=True)
        common_f = fine._levelwise_to_canonical(
            common + [_EMPTY] * (fL - cL), raveled=True)

        out = scipy.sparse.lil_matrix((fine.numdofs, self.numdofs))
        out[np.ix_(common_f, common_c)] = scipy.sparse.eye(len(common_c))

        # prolongator rows needed: the fine-space functions of each level
        need = [np.union1d(fine._af[l], fine._df[l])
                for l in range(1, fL)]
        P = [utils.kron_partial(fine.tp_prolongation(lv), need[lv])
             for lv in range(fL - 1)]

        top = cL if cL < fL else cL - 1
        for lv in range(top):
            chain, deact_prev = None, None
            for l in range(lv + 1, min(fL, lv + disparity + 1)):
                fa, fd = fine._af[l], fine._df[l]
                if chain is None:
                    to_act = P[l - 1][np.ix_(fa, replaced[lv])]
                    to_deact = P[l - 1][np.ix_(fd, replaced[lv])]
                else:
                    to_act = P[l - 1][np.ix_(fa, deact_prev)] @ chain
                    to_deact = P[l - 1][np.ix_(fd, deact_prev)] @ chain
                out[np.ix_(f_can[l], replaced_can[lv])] += to_act
                if not len(fd):
                    break
                chain, deact_prev = to_deact, fd
        return out.tocsr()

    # -- basis representation -------------------------------------------------------

    def _initial_row_selector(self, N, rows, restrict):
        if rows is None:
            return scipy.sparse.eye(N, format='csc'), None
        rows = np.asarray(rows, dtype=np.intp)
        n = len(rows)
        if restrict:
            sel = scipy.sparse.coo_matrix(
                (np.ones(n), (np.arange(n), rows)), shape=(n, N))
        else:
            sel = scipy.sparse.coo_matrix(
                (np.ones(n), (rows, rows)), shape=(N, N))
        return sel.tocsc(), rows

    def represent_fine(self, lv=None, truncate=None, rows=None,
                       restrict=False):
        """Matrix representing the active HB/THB functions (up to level
        `lv`) by their coefficients in the TP space of level `lv`.

        `rows` optionally restricts which TP coefficients are computed
        (zero-filled unless `restrict=True`, in which case the matrix is
        shrunk to those rows).  Partial rows go through the row-wise
        Kronecker :func:`~pyiga_tpu_torch.utils.kron_partial`."""
        if lv is None:
            lv = self.numlevels - 1
        assert 0 <= lv < self.numlevels, 'Invalid level.'
        if truncate is None:
            truncate = self.truncate
        # memoized on the refinement-invalidated space cache: repeated
        # assembly over one hierarchy (mass + stiffness, rhs, iterated
        # HDiscretization builds) re-requests identical representations;
        # key on dtype + bytes: int32/int64 rows with identical byte
        # strings must not collide.  Callers must treat the result as
        # immutable (truncate_one_level copies before its resize).
        key = ('represent_fine', lv, bool(truncate), bool(restrict),
               None if rows is None
               else (np.asarray(rows).dtype.str,
                     _strong_digest(rows)))
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        act = list(self._af[:lv + 1])
        act[lv] = np.concatenate((act[lv], self._df[lv]))
        fmt = 'lil' if truncate else 'csr'

        P, needed = self._initial_row_selector(self.mesh(lv).numbf, rows,
                                               restrict)
        blocks = [None] * (lv + 1)
        blocks[lv] = P[:, act[lv]]
        for k in range(lv - 1, -1, -1):
            if needed is not None and len(needed) > 0.5 * P.shape[1]:
                needed = None       # dense enough: full Kronecker is cheaper
            if needed is None:
                Pj = utils.multi_kron_sparse(self.hmesh.P[k], format=fmt)
            else:
                Pj = utils.kron_partial(self.hmesh.P[k], needed, format=fmt)
            if truncate:
                Pj[act[k + 1], :] = 0
            P = P @ Pj
            needed = P.getnnz(axis=0).nonzero()[0]
            blocks[k] = P[:, act[k]]
        out = scipy.sparse.bmat([blocks], format='csr')
        self._cache[key] = out
        return out

    def truncate_one_level(self, k, num_rows=None, inverse=False):
        """Truncation operator from level `k` to `k+1`
        (``I - A`` or its inverse ``I + A``)."""
        nt = np.cumsum(self.numactive)
        if num_rows is None:
            num_rows = nt[-1]
        A = self.represent_fine(lv=k + 1, rows=self._af[k + 1],
                                truncate=False, restrict=True)
        A = A.copy()    # represent_fine results are cached; resize mutates
        nA = A.shape[0]
        A.resize(nA, nt[k])
        A.resize(nA, num_rows)
        A = scipy.sparse.vstack(
            (scipy.sparse.csr_matrix((nt[k], num_rows)), A))
        A.resize(num_rows, num_rows)
        eye = scipy.sparse.eye(num_rows, format='csr')
        return eye + A if inverse else eye - A

    def thb_to_hb(self):
        """Square matrix mapping THB coefficients to HB coefficients."""
        T = scipy.sparse.eye(self.numdofs, format='csr')
        for k in range(self.numlevels - 1):
            T = self.truncate_one_level(k) @ T
        return T

    def hb_to_thb(self):
        """Square matrix mapping HB coefficients to THB coefficients."""
        T = scipy.sparse.eye(self.numdofs, format='csr')
        for k in range(self.numlevels - 1):
            T = T @ self.truncate_one_level(k, inverse=True)
        return T

    def split_coeffs(self, x):
        """Split a canonical coefficient vector into per-level pieces."""
        bounds = np.concatenate([[0], np.cumsum(self.numactive)])
        assert bounds[-1] == x.shape[0], 'Wrong length of input vector'
        return [x[a:b] for a, b in zip(bounds[:-1], bounds[1:])]

    def tp_prolongation(self, lv, kron=False):
        """TP prolongation from level `lv` to `lv+1` (per-axis factors or
        the full Kronecker product)."""
        Ps = self.hmesh.P[lv]
        return utils.multi_kron_sparse(Ps) if kron else Ps

    def incidence_matrix(self):
        """0/1 matrix of (active function, active cell) incidences in
        canonical order: function f of level k is incident to every active
        cell (of level >= k) that descends from f's support cells."""
        L = self.numlevels
        nac = [len(a) for a in self.hmesh._act]
        col_off = np.concatenate([[0], np.cumsum(nac)])
        row_off = np.concatenate([[0], np.cumsum(self.numactive)])

        rows, cols = [], []
        for k in range(L):
            funcs = self._af[k]
            if not len(funcs):
                continue
            msh = self.mesh(k)
            lo, hi = _range_boxes(msh.meshsupp, funcs, msh.numdofs)
            for l in range(k, L):
                act_l = self.hmesh._act[l]
                if not len(act_l):
                    continue
                scale = 2 ** (l - k)
                flat, valid = _expand_boxes(lo * scale, hi * scale,
                                            self.mesh(l).numspans)
                pos = np.searchsorted(act_l, flat)
                pos = np.clip(pos, 0, len(act_l) - 1)
                hit = valid & (act_l[pos] == flat)
                f_ix = np.broadcast_to(
                    np.arange(len(funcs)).reshape((-1,) + (1,) * self.dim),
                    flat.shape)
                rows.append(row_off[k] + f_ix[hit])
                cols.append(col_off[l] + pos[hit])
        Z = scipy.sparse.coo_matrix(
            (np.ones(sum(map(len, rows)), dtype=int),
             (np.concatenate(rows), np.concatenate(cols))),
            shape=(row_off[-1], col_off[-1]))
        Z.sum_duplicates()
        Z.data = np.minimum(Z.data, 1)
        return Z.tocsr()

    def virtual_hierarchy_prolongators(self, truncate=None):
        """Prolongators between consecutive virtual-hierarchy spaces
        (the multigrid transfer operators)."""
        if truncate is None:
            truncate = self.truncate
        nt = np.cumsum(self.numactive)

        prolongators = []
        for lv in range(self.numlevels - 1):
            fine_rows = np.concatenate((self._af[lv + 1], self._df[lv + 1]))
            P_rd = utils.kron_partial(self.hmesh.P[lv], rows=fine_rows,
                                      restrict=True)[:, self._df[lv]]
            prolongators.append(scipy.sparse.bmat(
                ((scipy.sparse.eye(nt[lv]), None), (None, P_rd)),
                format='csc'))

        if truncate:
            prolongators = [
                self.truncate_one_level(k, num_rows=P.shape[0], inverse=True)
                @ P for k, P in enumerate(prolongators)]
        return prolongators

    # -- evaluation -------------------------------------------------------------------

    def coeffs_to_levelwise_funcs(self, coeffs, truncate=None):
        """Per-level :class:`.BSplineFunc` contributions of a hierarchical
        function given in canonical coefficients."""
        if truncate is None:
            truncate = self.truncate
        if truncate:
            coeffs = self.thb_to_hb() @ coeffs
        from .geometry import BSplineFunc
        out = []
        for lv, u in enumerate(self.split_coeffs(coeffs)):
            full = np.zeros(self.mesh(lv).numbf, dtype=u.dtype)
            full[self._af[lv]] = u
            out.append(BSplineFunc(self.knotvectors(lv), full))
        return tuple(out)

    def grid_eval(self, coeffs, gridaxes, truncate=None):
        """Evaluate a hierarchical function on a tensor grid."""
        if truncate is None:
            truncate = self.truncate
        return sum(f.grid_eval(gridaxes)
                   for f in self.coeffs_to_levelwise_funcs(
                       coeffs, truncate=truncate))


def _selection_rows(rows, n):
    """Sparse binary matrix whose i-th row selects flat index ``rows[i]``."""
    m = len(rows)
    return scipy.sparse.csr_matrix(
        (np.ones(m), (np.arange(m), rows)), shape=(m, n))


class HSplineFunc:
    """A (scalar) function in a hierarchical spline space, following the
    :class:`.BSplineFunc` interface."""

    def __init__(self, hspace, u, truncate=None):
        self.hs = hspace
        self.coeffs = u
        self.sdim = hspace.dim
        self.dim = 1
        self.truncate = hspace.truncate if truncate is None else truncate

    def output_shape(self):
        return ()

    def is_scalar(self):
        return True

    def is_vector(self):
        return False

    def __call__(self, *x):
        return self.eval(*x)

    def _levelwise(self):
        return self.hs.coeffs_to_levelwise_funcs(self.coeffs,
                                                 truncate=self.truncate)

    def eval(self, *x):
        return sum(f.eval(*x) for f in self._levelwise())

    def grid_eval(self, gridaxes):
        return self.hs.grid_eval(self.coeffs, gridaxes,
                                 truncate=self.truncate)

    def grid_jacobian(self, gridaxes):
        return sum(f.grid_jacobian(gridaxes) for f in self._levelwise())

    def grid_hessian(self, gridaxes):
        return sum(f.grid_hessian(gridaxes) for f in self._levelwise())

    @property
    def support(self):
        return tuple((kv.kv[0], kv.kv[-1]) for kv in self.hs.knotvectors(0))
