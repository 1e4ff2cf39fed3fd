# -*- coding: utf-8 -*-
"""Lowering of variational forms to assembly plans (port of
:mod:`pyiga_tpu.compile`).

:func:`compile_vform` produces an assembler class whose ``run_device()``
evaluates the form's integrand on the device:

1. the physical geometry values and Jacobian on the Gauss grid (kernels
   K2 and K1's ``jac`` kind, :func:`~pyiga_tpu_torch.ops.cuda_sumfac.
   geometry_fields`);
2. one coefficient field per basis-derivative/component combination
   ("combo"), the integrand evaluated with that basis *seed* set to one
   (linearity makes this exact), all combos in one generated kernel K5
   (:mod:`pyiga_tpu_torch.ops.cuda_vform`); structurally zero combos are
   pruned at setup by a random probe on a tiny grid, and mirrored
   derivative pairs of symmetric forms folded;
3. the fields contracted against per-axis basis-pair tables by the
   sum-factorization chains (K2 stages, K3 fold), yielding the compact
   multilevel data tensor directly.

The JAX package offers an 'exact' and an 'ozaki' (two-float) f64 mode
because the TPU has no f64; the port computes the 'exact' semantics
natively, so ``mode`` is accepted for API compatibility and selects
nothing.  Compiled assembler classes are cached by ``vf.hash()``.

On-demand assembly (``bbox=``, the hierarchical spaces' per-level
assembly) restricts the Gauss grid to a box of cells and drops the
per-axis basis pairs without support there; :meth:`VFormAssembler.update`
swaps updatable inputs, parameters or the geometry and drops the device
operands that the change makes stale.

Not ported yet (each raises :class:`NotImplementedError` naming the
piece): vector-valued forms, surface integrals, two-space forms,
geometry Hessians and second physical derivatives, derivatives of input
fields, host-evaluated (non-spline) geometry, ``compact_slice`` /
``multi_entries``.
"""

import itertools

import numpy as np
import torch

from . import geometry, utils
from .bspline import KnotVector
from .config import DTYPE, resolve_device
from .mlmatrix import MLStructure, transpose_idx_for_bidx
from .ops import cuda_sumfac, cuda_vform, geom, sumfac
from .quadrature import make_tensor_quadrature


################################################################################
# Seed enumeration
################################################################################

def _derivs_upto(dim, order):
    """All derivative multi-indices (XYZ order) with total order <= order,
    sorted by total order then lexicographically."""
    out = []
    for total in range(order + 1):
        for D in itertools.product(range(total + 1), repeat=dim):
            if sum(D) == total:
                out.append(D)
    return out


def _seeds_for(numcomp, dim, order):
    """Seed list for one basis function: (component, D) pairs."""
    comps = [None] if numcomp is None else list(range(numcomp))
    return [(c, D) for c in comps for D in _derivs_upto(dim, order)]


################################################################################
# Evaluation context
################################################################################

class AsmContext:
    """Resolves field keys and basis seeds during integrand evaluation.

    `arrays` maps string keys to grid tensors (``weights``,
    ``geo_val_lvl``, ``geo_jac_lvl``, ``input:*``, ``param:*``) — or, for
    the K5 generator, to symbolic scalars in nested lists and object
    arrays; every lookup below indexes one axis at a time so that both
    work.  Geometry-derived fields are computed lazily and cached."""

    def __init__(self, vf, arrays, seed_u=None, seed_v=None):
        self.vf = vf
        self.arrays = arrays
        self.seed_u = seed_u    # (component, D) or None
        self.seed_v = seed_v
        self._cache = {}

    def basis_seed(self, bfun, D):
        slot = 0 if bfun.name == 'u' else 1
        if self.vf.arity == 1:
            seed = self.seed_v      # single function: the test function
        else:
            seed = self.seed_u if slot == 0 else self.seed_v
        if seed is None:
            return 0.0
        comp, Ds = seed
        if bfun.component is not None and bfun.component != comp:
            return 0.0
        return 1.0 if tuple(D) == tuple(Ds) else 0.0

    def field(self, key):
        val = self._cache.get(key)
        if val is None:
            val = self._compute(key)
            self._cache[key] = val
        return val

    def _compute(self, key):
        vf, arrays = self.vf, self.arrays
        kind = key[0]
        d = vf.dim
        gd = vf.geo_dim

        if kind == 'gw':
            return geom.gauss_weight_field(arrays['weights'])

        if kind == '_measure':
            if key[1] == 'dx':
                return vf.W.eval(self)
            raise NotImplementedError('surface integrals (ds) are not '
                                      'ported yet')

        if kind == 'jacinv':
            m, k = key[1], key[2]
            return self.field(('_jacinv_lvl',))[d - 1 - m][d - 1 - k]

        if kind == '_jacinv_lvl':
            _, inv_lvl = geom.det_and_inv(arrays['geo_jac_lvl'])
            return inv_lvl

        if kind == 'param':
            _, name, idx = key
            arr = arrays['param:' + name]
            return arr[idx] if idx != () else arr

        if kind == 'input':
            _, name, comp = key
            if name == 'geo':
                return arrays['geo_val_lvl'][gd - 1 - comp[0]]
            return arrays['input:' + name][comp]

        if kind == 'input_deriv':
            _, name, comp, D = key
            if name == 'geo' and sum(D) == 1:
                return arrays['geo_jac_lvl'][gd - 1 - comp[0]][
                    d - 1 - D.index(1)]
            raise NotImplementedError(
                'geometry Hessians and derivatives of input fields are not '
                'ported yet (field key %r)' % (key,))

        raise KeyError('unknown field key %r' % (key,))


################################################################################
# Assembler class
################################################################################

# probe results (pruned combos + symmetric-fold plan) per (form, input
# signature); the probe runs on a tiny fixed grid, so one entry serves
# every space size
_PRUNE_CACHE = {}


class VFormAssembler:
    """Assembler for a compiled :class:`~pyiga_tpu_torch.vform.VForm`.

    Subclassed per form by :func:`compile_vform`; instantiate with the
    spline space, the geometry and any named inputs/parameters, and
    ``device=`` (default: the CPU, where the kernels' plain versions
    run)."""

    vf = None   # set by compile_vform

    @classmethod
    def inputs(cls):
        return {inp.name: inp.shape for inp in cls.vf.inputs}

    @classmethod
    def parameters(cls):
        return {p.name: p.shape for p in cls.vf.params}

    def __init__(self, kvs, kvs2=None, boundary=None, bbox=None,
                 device=None, **args):
        vf = self.vf
        if kvs2 is not None or vf.num_spaces() == 2:
            raise NotImplementedError('two-space forms (kvs2) are not '
                                      'ported yet')
        if boundary is not None or 'boundary' in args or vf.is_boundary \
                or vf.is_surface_integral():
            raise NotImplementedError(
                'surface integrals (ds, boundary=, Jac_to_boundary) are not '
                'ported yet')
        if vf.vec:
            raise NotImplementedError('vector-valued forms (vf.vec) are not '
                                      'ported yet: the next slice')
        if isinstance(kvs, KnotVector):
            kvs = (kvs,)
        kvs = tuple(kvs)
        self.kvs0 = kvs                     # trial = test space
        self.arity = vf.arity
        self.dim = len(kvs)
        if self.dim != vf.dim:
            raise ValueError('space dimension %d does not match the form '
                             '(%d)' % (self.dim, vf.dim))
        self.device = resolve_device(device)

        self.geo = self._checked_geo(args.pop('geo'))
        self.bbox = args.pop('bbox', bbox)

        nqp = max(kv.p for kv in kvs) + 1
        self.structure = MLStructure.from_kvs(kvs, kvs)
        if self.bbox is None:
            self.grid, self.gweights = sumfac.quadrature_for(kvs, nqp)
        else:
            # on-demand mode: the Gauss grid covers only the cells of the
            # bbox, so entries whose test function is supported inside it
            # are exact and the others partial
            self.grid, self.gweights = make_tensor_quadrature(
                [kv.mesh[bb[0]:bb[1] + 1] for kv, bb in zip(kvs, self.bbox)],
                nqp)
            self._restrict_to_bbox()
        self.maxderiv = vf.max_deriv_order()
        self.tables = sumfac.SpaceTables(kvs, kvs, self.grid,
                                         self.structure.bidx, self.maxderiv)

        ncomp = tuple(bf.numcomp for bf in vf.basis_funs)
        if vf.arity == 2:
            seeds_u = _seeds_for(ncomp[0], vf.dim, self.maxderiv)
            seeds_v = _seeds_for(ncomp[1], vf.dim, self.maxderiv)
            self.combos = [(su, sv) for su in seeds_u for sv in seeds_v]
        else:
            seeds_v = _seeds_for(ncomp[0], vf.dim, self.maxderiv)
            self.combos = [(None, sv) for sv in seeds_v]

        self._input_values = {}
        for inp in vf.inputs:
            if inp.name == 'geo':
                continue
            if inp.name not in args:
                raise ValueError("required input '%s' missing" % inp.name)
            self._input_values[inp.name] = args[inp.name]
        self._param_values = {}
        for p in vf.params:
            if p.name not in args:
                raise ValueError("required parameter '%s' missing" % p.name)
            self._param_values[p.name] = args[p.name]

        self._needed_keys = vf.used_field_keys()
        for key in self._needed_keys:
            if key[0] == 'input_deriv' and (key[1] != 'geo'
                                            or sum(key[3]) != 1):
                raise NotImplementedError(
                    'geometry Hessians, second physical derivatives and '
                    'derivatives of input fields are not ported yet '
                    '(field key %r)' % (key,))
        if self.maxderiv >= 2 and any(key[0] == 'jacinv'
                                      for key in self._needed_keys):
            raise NotImplementedError('second physical derivatives need '
                                      'geometry Hessians, not ported yet')
        self._build_arrays()
        self._num_combos_total = len(self.combos)
        self._prune_combos()
        self._operands = None
        self._program_cache = None

    def _checked_geo(self, geo):
        if not isinstance(geo, (geometry.BSplineFunc, geometry.NurbsFunc)):
            raise NotImplementedError(
                'host-evaluated (non-spline) geometry needs kernel K1\', '
                'which is not ported yet')
        if tuple(geo.output_shape()) != (self.dim,):
            raise NotImplementedError(
                'geometry output shape %s differs from the space dimension '
                '%d' % (geo.output_shape(), self.dim))
        return geo

    def _restrict_to_bbox(self):
        """Drop the per-axis dof pairs with no support inside the bbox:
        their basis-table rows vanish on the restricted Gauss grid, so
        their compact entries are structural zeros, and the contraction
        cost scales with the stored entries (hierarchical windows are
        small corners of large levels).  Records per axis the half-open
        range of test functions supported in the bbox
        (``_bbox_win_test``)."""
        bidx = []
        self._bbox_win_test = []
        for kv, bb, bx in zip(self.kvs0, self.bbox, self.structure.bidx):
            supp = kv.mesh_support_idx_all()
            win = (supp[:, 0] < bb[1]) & (supp[:, 1] > bb[0])
            ij = bx.astype(np.intp)
            keep = win[ij[:, 0]] & win[ij[:, 1]]
            bidx.append(bx[keep])
            nz = np.nonzero(win)[0]     # contiguous for B-splines
            self._bbox_win_test.append(
                (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0))
        self.structure = MLStructure(self.structure.bs, bidx)

    # -- array setup -------------------------------------------------------------

    def _build_arrays(self):
        """Host setup of the grid arrays; the geometry stays as tables and
        coefficients, its fields are computed on the device."""
        arrays = {'weights': [np.asarray(w) for w in self.gweights]}
        self._geo_tables, self._geo_coeffs, self._geo_is_nurbs = \
            geom.geo_eval_tables(self.geo, self.grid, numderiv=1)
        for inp in self.vf.inputs:
            if inp.name != 'geo':
                arrays.update(self._eval_input(
                    inp, self._input_values[inp.name]))
        for p in self.vf.params:
            arrays['param:' + p.name] = np.asarray(
                self._param_values[p.name], dtype=float)
        self._host_arrays = arrays

    def _eval_input(self, inp, f):
        """Values of one input field on the Gauss grid (component axes
        leading)."""
        if inp.physical:
            vals = utils.grid_eval_transformed(f, self.grid, self.geo)
        else:
            vals = utils.grid_eval(f, self.grid)
        n = len(inp.shape)
        vals = np.moveaxis(np.asarray(vals, dtype=float),
                           tuple(range(-n, 0)), tuple(range(n)))
        return {'input:' + inp.name: np.ascontiguousarray(vals)}

    def update(self, **upd):
        """Update updatable input fields and/or parameters, or the geometry
        (which also re-evaluates physically given inputs).  Drops the
        cached device operands that the change makes stale: after a new
        geometry all of them and the generated K5 program; after new
        input or parameter values the changed tensors, and the program
        only if a changed value has a new shape."""
        geo_changed = False
        changed = {}
        for name, f in upd.items():
            if name == 'geo':
                self.geo = self._checked_geo(f)
                geo_changed = True
                continue
            inp = [i for i in self.vf.inputs if i.name == name]
            if inp and inp[0].updatable:
                self._input_values[name] = f
                changed.update(self._eval_input(inp[0], f))
                continue
            if name in self._param_values:
                self._param_values[name] = f
                changed['param:' + name] = np.asarray(f, dtype=float)
                continue
            raise ValueError('%r is not an updatable input' % name)
        if geo_changed:
            self._build_arrays()
            self._operands = None
            self._program_cache = None
            return
        if any(np.shape(a) != np.shape(self._host_arrays[k])
               for k, a in changed.items()):
            self._program_cache = None
        self._host_arrays.update(changed)
        if self._operands is not None:
            inputs = dict(self._operands['inputs'])
            for k, a in changed.items():
                inputs[k] = torch.as_tensor(np.ascontiguousarray(a),
                                            dtype=DTYPE, device=self.device)
            self._operands = dict(self._operands, inputs=inputs)

    def compact_slice(self, fixed):
        raise NotImplementedError('compact_slice (ACA) is not ported yet')

    def multi_entries(self, indices):
        raise NotImplementedError('multi_entries (ACA) is not ported yet')

    # -- evaluation ----------------------------------------------------------------

    def _make_context(self, arrays, seed_u, seed_v):
        return AsmContext(self.vf, arrays, seed_u, seed_v)

    def _program(self, combos):
        """The generated K5 program of `combos` (cached)."""
        key = tuple(combos)
        if self._program_cache is None or self._program_cache[0] != key:
            self._program_cache = (key, cuda_vform.generate(self, combos))
        return self._program_cache[1]

    def _prune_key(self):
        """Cache key for the probe results: everything the probe values
        depend on except the space sizes."""
        def sig(k, a):
            shape = tuple(np.shape(a))
            if k.startswith('param:'):
                return (k, shape)
            return (k, shape[:max(len(shape) - self.dim, 0)])

        hsig = tuple(sorted(sig(k, a) for k, a in self._host_arrays.items()
                            if k != 'weights'))
        return (self.vf.hash(), self.dim, self.vf.geo_dim, self.arity, hsig)

    def _prune_combos(self):
        """Drop structurally-zero seed combinations using a random probe on
        a tiny grid, evaluated in float64 and in float32 on the CPU with
        the plain fields (setup, as in the JAX package).  Results are
        cached per (form, input signature)."""
        cache_key = self._prune_key()
        cached = _PRUNE_CACHE.get(cache_key)
        if cached is not None and len(cached[0]) == len(self.combos):
            keep, plan = cached
            self.combos = [c for c, k in zip(self.combos, keep) if k]
            self._fold_plan = self._fold_tperms = None
            if plan is not None:
                self._fold_plan = list(plan)
                self._fold_tperms = [transpose_idx_for_bidx(bx)
                                     for bx in self.structure.bidx]
            return

        rng = np.random.RandomState(987123)
        tiny_grid = 2
        gshape = self.dim * (tiny_grid,)

        def rnd(shape):
            return rng.rand(*shape) + 0.5

        # the draws follow the JAX package's order, so both probe alike
        probe = {'weights': [rnd((tiny_grid,)) for _ in range(self.dim)]}
        probe['geo_val_lvl'] = rnd((self.vf.geo_dim,) + gshape)
        probe['geo_jac_lvl'] = rnd((self.vf.geo_dim, self.dim) + gshape)
        for key, arr in self._host_arrays.items():
            if key == 'weights':
                continue
            if key.startswith('param:'):
                probe[key] = rnd(np.shape(arr)) if np.shape(arr) else \
                    np.asarray(rng.rand() + 0.5)
            else:
                lead = arr.shape[:arr.ndim - self.dim]
                probe[key] = rnd(lead + gshape)

        def run(dtype):
            arrays = {k: ([torch.as_tensor(w, dtype=dtype) for w in v]
                          if k == 'weights' else
                          torch.as_tensor(v, dtype=dtype))
                      for k, v in probe.items()}
            fields = cuda_vform.combo_fields_plain(self, arrays, self.combos)
            return np.stack([F.reshape(-1).numpy().astype(np.float64)
                             for F in fields])

        values = run(torch.float64)
        # a structural zero is cancellation noise, so its f32 and f64
        # probe values are uncorrelated; a genuine term, however small,
        # agrees to ~1e-6 relative (per-combo and scale-free)
        values32 = run(torch.float32)

        maxima = np.abs(values).max(axis=1)
        scale = max(maxima.max(), 1e-300)
        keep = np.empty(len(self.combos), dtype=bool)
        for i in range(len(self.combos)):
            if maxima[i] > 1e-13 * scale:
                keep[i] = True          # clearly above cancellation noise
                continue
            v64, v32 = values[i], values32[i]
            if maxima[i] == 0.0 and np.abs(v32).max() == 0.0:
                keep[i] = False         # exact structural zero
                continue
            if not np.all(np.isfinite(v32)):
                keep[i] = True          # f32 overflow: keep conservatively
                continue
            ref = max(maxima[i], np.abs(v32).max(), 1e-300)
            keep[i] = np.abs(v64 - v32).max() < 1e-3 * ref
        self.combos = [c for c, k in zip(self.combos, keep) if k]
        if not self.combos:
            raise ValueError('variational form is identically zero')
        self._detect_symmetry(values[keep], maxima[keep])
        _PRUNE_CACHE[cache_key] = (
            tuple(bool(k) for k in keep),
            tuple(self._fold_plan) if self._fold_plan is not None else None)

    def _detect_symmetry(self, probe_values, probe_maxima):
        """Probe-based symmetric-term folding (scalar bilinear forms): a
        combo (su, sv) whose swapped partner (sv, su) has a numerically
        equal probe field contributes the transpose of its partner's
        chain, so one chain of each pair runs and the compact-layout
        transpose gather mirrors it."""
        self._fold_plan = self._fold_tperms = None
        if self.arity != 2:
            return
        index = {c: i for i, c in enumerate(self.combos)}
        plan = []
        any_mirror = False
        for i, (su, sv) in enumerate(self.combos):
            if su == sv:
                plan.append((i, False))
                continue
            j = index.get((sv, su))
            pair_scale = max(probe_maxima[i], probe_maxima[j]
                             if j is not None else 0.0, 1e-300)
            if j is not None and np.abs(
                    probe_values[i] - probe_values[j]).max() \
                    < 1e-10 * pair_scale:
                if j > i:
                    plan.append((i, True))
                    any_mirror = True
                # j < i: mirrored by its partner
            else:
                plan.append((i, False))
        if any_mirror:
            self._fold_plan = plan
            self._fold_tperms = [transpose_idx_for_bidx(bx)
                                 for bx in self.structure.bidx]

    # -- assembly ------------------------------------------------------------------

    def _term_tables_for(self, combos):
        """Per-combo per-axis pair tables (matrix) or test tables (vector),
        host numpy.  Derivative multi-indices go XYZ -> level order here."""
        tabs = []
        for su, sv in combos:
            Dv_lvl = tuple(reversed(sv[1]))
            if self.arity == 2:
                Du_lvl = tuple(reversed(su[1]))
                tabs.append([self.tables.pair_table(k, Du_lvl[k], Dv_lvl[k])
                             for k in range(self.dim)])
            else:
                tabs.append([self.tables.test[k][Dv_lvl[k]]
                             for k in range(self.dim)])
        return tabs

    def _device_operands(self):
        """Device tensors of the assembly (memoized): input arrays, geometry
        tables and coefficients, term tables (each distinct host table
        uploaded once), their last-table groups, and the transpose
        permutations of a folded plan."""
        if self._operands is not None:
            return self._operands
        dev = self.device

        def tensor(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=DTYPE,
                                   device=dev)
        inputs = {k: [tensor(w) for w in v] if k == 'weights' else tensor(v)
                  for k, v in self._host_arrays.items()}
        host_tabs = self._term_tables_for(self.combos)
        uploaded = {}
        for tabs in host_tabs:
            for T in tabs:
                if id(T) not in uploaded:
                    uploaded[id(T)] = tensor(T)
        tperms = None
        if self._fold_plan is not None:
            tperms = [torch.as_tensor(p, dtype=torch.int64, device=dev)
                      for p in self._fold_tperms]
        self._operands = dict(
            inputs=inputs,
            geo_tables=[tensor(t) for t in self._geo_tables],
            geo_coeffs=tensor(self._geo_coeffs),
            term_tables=[[uploaded[id(T)] for T in tabs]
                         for tabs in host_tabs],
            last_idx=sumfac.last_table_groups(host_tabs),
            tperms=tperms)
        return self._operands

    def device_arrays(self):
        """The device tensors K5 evaluates on: the inputs, parameters and
        Gauss weights, plus the physical geometry values ``geo_val_lvl``
        ``(d,) + grid`` and Jacobian ``geo_jac_lvl`` ``(d, d) + grid``
        (level order) from K2 and K1's ``jac`` kind."""
        ops = self._device_operands()
        arrays = dict(ops['inputs'])
        arrays['geo_val_lvl'], arrays['geo_jac_lvl'] = \
            cuda_sumfac.geometry_fields(ops['geo_tables'], ops['geo_coeffs'],
                                        self._geo_is_nurbs)
        return arrays

    def run_device(self, mode=None):
        """Assemble to a device-resident compact data tensor on the
        assembler's device: geometry fields (K2 + K1 ``jac``), coefficient
        fields (K5), folded chains (K2 + K3) and the transpose gather of
        mirrored terms.  Returns ``{(None, None): data}`` with data of
        shape ``(nnz_1, ..., nnz_d)`` (matrix) or ``(n_1, ..., n_d)``
        (vector), float64.  `mode` ('exact', 'ozaki' or None) is accepted
        for API compatibility: the port has one f64 mode, the exact
        one."""
        if mode not in (None, 'exact', 'ozaki'):
            raise ValueError("mode must be 'exact' or 'ozaki'")
        ops = self._device_operands()
        plan = (self._fold_plan if self._fold_plan is not None
                else [(t, False) for t in range(len(self.combos))])
        # only the plan's terms: a mirrored term's partner is never needed
        terms = [t for t, _m in plan]
        fields = [None] * len(self.combos)
        for t, F in zip(terms, cuda_vform.combo_fields(
                self, self.device_arrays(), [self.combos[t] for t in terms])):
            fields[t] = F
        data = cuda_sumfac.assemble_terms_folded(
            ops['term_tables'], fields, plan, ops['tperms'], ops['last_idx'])
        return {(None, None): data}

    def assemble(self, mode=None):
        """Assemble and return the matrix as a host
        :class:`~pyiga_tpu_torch.mlmatrix.MLMatrix`."""
        if self.arity != 2:
            raise ValueError('assemble() needs a bilinear form; use '
                             'assemble_vector()')
        data = self.run_device(mode)[(None, None)]
        return self.structure.make_mlmatrix(data=data.cpu().numpy())

    def assemble_vector(self):
        """Assemble an arity-1 functional; returns the host array of shape
        per-axis dofs."""
        if self.arity != 1:
            raise ValueError('assemble_vector() needs a linear functional')
        return self.run_device()[(None, None)].cpu().numpy()


_COMPILE_CACHE = {}


def compile_vform(vf, on_demand=False, verbose=False):
    """Compile a VForm into an assembler class (cached by ``vf.hash()``)."""
    key = (vf.hash(), on_demand)
    cls = _COMPILE_CACHE.get(key)
    if cls is None:
        cls = type('VFormAssembler_%x' % (vf.hash() & 0xffffffff),
                   (VFormAssembler,), {'vf': vf})
        _COMPILE_CACHE[key] = cls
    return cls


def compile_vforms(vfs, verbose=False):
    """Compile several vforms at once."""
    return [compile_vform(vf, verbose=verbose) for vf in vfs]
