# -*- coding: utf-8 -*-
"""Discretization of variational problems over hierarchical spline spaces
(a copy of :mod:`pyiga_tpu._hdiscr`).

The HB-spline system matrix is built level by level from partial-row TP
assemblies restricted to the bounding box of the needed functions (the
on-demand ``bbox`` assembler of :mod:`~pyiga_tpu_torch.compile`, which
runs the device kernels of the VForm path), with inter-level coupling
through two-sided products with ``represent_fine`` on the host; the THB
matrix is the HB matrix transformed by the truncation operator.  Every
level assembles on the device given to :class:`HDiscretization`."""

import hashlib

import numpy as np
import scipy.sparse

from . import compile as compile_mod
from .config import resolve_device

_EMPTY = np.empty(0, dtype=np.intp)


def _digest(a):
    """Strong content digest of an array's bytes (a 64-bit Python ``hash``
    can collide silently)."""
    return hashlib.blake2b(np.ascontiguousarray(a).tobytes(),
                           digest_size=16).digest()


def _inputs_fingerprint(args):
    """Value fingerprint of assembler inputs for the per-level assembler
    cache, or None when any input is not fingerprintable (e.g. a user
    callable, which may close over changing state)."""
    parts = []
    for name in sorted(args):
        v = args[name]
        coeffs = getattr(v, 'coeffs', None)
        kvs = getattr(v, 'kvs', None)
        if coeffs is not None and kvs is not None:    # spline function
            parts.append((name, type(v).__name__, kvs, _digest(coeffs)))
        elif isinstance(v, (int, float, complex, str, bool)):
            parts.append((name, v))
        elif isinstance(v, np.ndarray):
            parts.append((name, v.dtype.str, v.shape, _digest(v)))
        else:
            return None
    return tuple(parts)


def _assemble_partial_rows(asm, row_indices):
    """The given rows of the full TP matrix (zeros elsewhere).

    The assembler evaluates over its bbox-restricted Gauss grid; the
    requested rows are then lifted straight out of the compact data tensor
    through a structural template (CSR order + row selection are fixed per
    (structure, rows), so rebuilds — adaptive loops, repeated
    discretizations — cost one fancy-index + one csr_matrix wrap instead
    of the former full coo->csr sort and two-pass row slice)."""
    ml = asm.assemble()
    rows = np.asarray(row_indices, dtype=np.intp)
    key = (ml.datashape, _digest(rows))
    tpl = getattr(asm, '_partial_rows_tpl', None)
    if tpl is None or tpl[0] != key:
        I, J = ml.nonzero()
        order = np.lexsort((J, I))          # canonical CSR entry order
        in_rows = np.zeros(ml.shape[0], dtype=bool)
        in_rows[rows] = True
        sel = order[in_rows[I[order]]]      # kept entries, CSR order
        counts = np.bincount(I[sel], minlength=ml.shape[0])
        indptr = np.concatenate(([0], np.cumsum(counts)))
        indices = J[sel]
        asm._partial_rows_tpl = tpl = (key, sel, indices, indptr)
    _, sel, indices, indptr = tpl
    data = np.asarray(ml.data, dtype=np.float64).ravel()[sel]
    return scipy.sparse.csr_matrix((data, indices, indptr), shape=ml.shape)


class HDiscretization:
    """Discretizes a variational problem over an HB-/THB-spline space.

    Args:
        hspace: the :class:`~pyiga_tpu_torch.hierarchical.HSpace`.
        vform: the bilinear :class:`~pyiga_tpu_torch.vform.VForm`.
        asm_args: named assembler inputs (at least ``{'geo': geo}``).
        device: where the per-level assemblies run (default: the CPU,
            where the kernels' plain versions run).
    """

    def __init__(self, hspace, vform, asm_args, device=None):
        self.hs = hspace
        self.truncate = hspace.truncate
        self.vf = vform
        self.asm_args = asm_args
        self.device = resolve_device(device)
        self._compiled = None

    # -- assembler plumbing ----------------------------------------------------

    def _inputs_for(self, vf):
        args = {inp.name: self.asm_args[inp.name]
                for inp in vf.inputs if inp.name in self.asm_args}
        args['geo'] = self.asm_args['geo']
        return args

    def _bbox_for_functions(self, lv, funcs):
        """Per-axis cell bounding box of the supports of the given flat
        functions — directly from the per-axis support ranges, without
        enumerating cells."""
        from .hierarchical import _range_boxes
        msh = self.hs.mesh(lv)
        funcs = np.asarray(funcs, dtype=np.intp)
        if funcs.size == 0:
            return tuple((0, 0) for _ in range(self.hs.dim))
        lo, hi = _range_boxes(msh.meshsupp, funcs, msh.numdofs)
        return tuple(zip(lo.min(axis=0).tolist(), hi.max(axis=0).tolist()))

    def _tp_matrix_rows(self, k, rows, bbox, symmetric):
        """Partial rows of the level-`k` TP matrix, assembled over the
        bbox-restricted Gauss grid.

        The per-level assembler INSTANCES are memoized on the space's
        refinement-invalidated cache keyed by a value fingerprint of the
        inputs: repeated discretizations over the same space — adaptive
        loops, the bench's rebuild — skip quadrature/table/prune setup and
        the host->device operand transfer (the numeric assembly itself
        always runs)."""
        n = int(np.prod(self.hs.mesh(k).numdofs))
        if rows is not None and len(rows) == 0:
            return scipy.sparse.csr_matrix((n, n))
        if self._compiled is None:
            self._compiled = compile_mod.compile_vform(self.vf,
                                                       on_demand=True)
        ikey = _inputs_fingerprint(self._inputs_for(self.vf))
        asm = None
        if ikey is not None:
            key = ('tp_asm', self.vf.hash(), k, bbox, ikey, str(self.device))
            asm = self.hs._cache.get(key)
        if asm is None:
            asm = self._compiled(self.hs.knotvectors(k), bbox=bbox,
                                 device=self.device,
                                 **self._inputs_for(self.vf))
            if ikey is not None:
                self.hs._cache[key] = asm
        if rows is None:
            return asm.assemble().asmatrix('csr')
        return _assemble_partial_rows(asm, rows)

    # -- system matrix ----------------------------------------------------------

    def assemble_matrix(self, symmetric=False):
        """The system matrix over the hierarchical space (size
        ``hs.numdofs``), sparse CSR."""
        if self.truncate:
            try:
                self.truncate = False
                A_hb = self.assemble_matrix(symmetric=symmetric)
            finally:
                self.truncate = True
            T = self.hs.thb_to_hb()
            return (T.T @ A_hb @ T).tocsr()

        hs = self.hs
        L = hs.numlevels
        act = hs.active_indices()
        offsets = np.concatenate([[0], np.cumsum([len(a) for a in act])])

        # per level k: the coarse-function canonical columns it couples to
        # (support-extension neighbors of lower levels), the fine-level
        # representations of those coarse functions, and the row set to
        # assemble
        coupling = hs.cell_supp_indices(remove_dirichlet=False)
        triplets = ([], [], [])

        def emit(B, rows, cols):
            B = B.tocoo()
            triplets[0].append(rows[B.row])
            triplets[1].append(cols[B.col])
            triplets[2].append(B.data)

        for k in range(L):
            lower = [coupling[k][lv] if lv < k else _EMPTY for lv in range(L)]
            # level-k footprint of the coarse neighbor functions
            rep = _EMPTY
            for lv in range(max(0, k - hs.disparity), k):
                if len(lower[lv]):
                    rep = np.union1d(rep, hs.hmesh._funcs_across(
                        lv, lower[lv], k))
            needed = np.union1d(rep, act[k])

            A_k = self._tp_matrix_rows(
                k, rows=needed, bbox=self._bbox_for_functions(k, needed),
                symmetric=symmetric)
            R_k = hs.represent_fine(lv=k, truncate=False, rows=needed)

            can_new = np.arange(offsets[k], offsets[k + 1])
            can_low = hs.raveled_to_virtual_canonical_indices(k, lower)

            # new x new interactions are plain TP entries
            emit(A_k[act[k]][:, act[k]], can_new, can_new)

            # coarse x new couplings ride the fine-level representation
            R_low = R_k[rep][:, can_low]
            R_new = R_k[act[k]][:, can_new]
            low_new = R_low.T @ A_k[rep][:, act[k]] @ R_new
            emit(low_new, can_low, can_new)
            if symmetric:
                emit(low_new.T, can_new, can_low)
            else:
                emit(R_new.T @ A_k[act[k]][:, rep] @ R_low,
                     can_new, can_low)

        return scipy.sparse.csr_matrix(
            (np.concatenate(triplets[2]),
             (np.concatenate(triplets[0]), np.concatenate(triplets[1]))),
            shape=(hs.numdofs, hs.numdofs))

    # -- right-hand sides ---------------------------------------------------------

    def assemble_rhs(self, vf=None):
        """Right-hand-side vector (default: L2 product with
        ``asm_args['f']`` in physical coordinates)."""
        if vf is None:
            from .vform import L2functional_vf
            # updatable=True so repeated discretizations reuse the cached
            # per-level assemblers and only re-evaluate f on the grid
            vf = L2functional_vf(dim=self.hs.dim, physical=True,
                                 updatable=True)
        return self.assemble_functional(vf)

    def assemble_functional(self, vf):
        """Assemble an arity-1 functional over the hierarchical space.

        Per-level assembler instances are memoized on the space's
        refinement-invalidated cache like :meth:`_tp_matrix_rows`'s;
        updatable inputs (e.g. the default rhs functional's ``f``) are
        refreshed on the cached instance via ``update`` — non-updatable,
        non-fingerprintable inputs force a fresh instantiation."""
        if vf.arity != 1:
            raise ValueError('vf must be a linear functional (arity=1)')
        RhsAsm = compile_mod.compile_vform(vf, on_demand=True)
        args = self._inputs_for(vf)

        if vf.vec:
            raise NotImplementedError(
                'vector-valued hierarchical discretization is not supported'
                ' (the component axis would fold into the flat dof index)')
        hs = self.hs
        upd_names = {i.name for i in vf.inputs if i.updatable}
        fixed = {n: v for n, v in args.items() if n not in upd_names}
        fkey = _inputs_fingerprint(fixed)
        pieces = []
        for k, rows in enumerate(hs.active_indices()):
            if len(rows) == 0:
                pieces.append(np.zeros(0))
                continue
            bbox = self._bbox_for_functions(k, rows)
            asm = None
            if fkey is not None:
                key = ('rhs_asm', vf.hash(), k, bbox, fkey, str(self.device))
                asm = hs._cache.get(key)
            if asm is None:
                asm = RhsAsm(hs.knotvectors(k), bbox=bbox, device=self.device,
                             **args)
                if fkey is not None:
                    hs._cache[key] = asm
            elif upd_names:
                asm.update(**{n: args[n] for n in upd_names if n in args})
            pieces.append(asm.assemble_vector().ravel()[rows])
        rhs = np.concatenate(pieces)

        if self.truncate:
            rhs = hs.thb_to_hb().T @ rhs
        return rhs
