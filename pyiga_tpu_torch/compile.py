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

Every step runs in the compute dtype
(:func:`~pyiga_tpu_torch.config.get_dtype`), as the JAX package casts
its operands to it (``pyiga_tpu/compile.py:1250-1262``): under float32
the operands are uploaded in float32 (memoized per dtype, so that a
:func:`~pyiga_tpu_torch.config.set_dtype` between two calls never
reuses the other dtype's), K1's ``jac`` kind, the generated K5 and the
chains (K2, K3) run their float32 instances, and the host matrices and
vectors are float64 holding the float32 results.

On-demand assembly (``bbox=``, the hierarchical spaces' per-level
assembly) restricts the Gauss grid to a box of cells and drops the
per-axis basis pairs without support there; :meth:`VFormAssembler.update`
swaps updatable inputs, parameters or the geometry and drops the device
operands that the change makes stale.

:meth:`VFormAssembler.compact_slice` evaluates a slice of the compact
data tensor with some axes pinned (the entry callback of the low-rank
ACA assembly, :mod:`~pyiga_tpu_torch.lowrank`): the coefficient fields
of every combo, computed once on the device (K2 + K1 ``jac`` + K5) and
kept, contracted against the per-axis tables in tensordot chains (in
the compute dtype, TF32 off), the pinned axes first.  The JAX package's
two-float ``'pair'`` slices exist for the TPU and are not ported.  Under
float32 the slices are float32 (fields and tables keyed by the dtype),
as the JAX package's ``'exact'`` slices (``pyiga_tpu/compile.py:1473``,
``:1608``).

Vector-valued forms assemble one compact tensor per component block
``(cu, cv)`` (the seeds carry the component; each block's chains run K2
stages and one K3 fold); two-space forms take the trial space ``kvs``
and the test space ``kvs2``; first and second derivatives of input fields
are evaluated on the host at setup and by :meth:`VFormAssembler.update`
(``ideriv:<name>:1`` and ``:2``, the latter in the symmetric XYZ layout
of :func:`_sym_index`; a physical input is differentiated by
``torch.func`` where it traces and by central differences otherwise,
:func:`_physical_field_derivs`), or passed as device tensors to
:meth:`VFormAssembler.run_device` (``inputs=``), which a time stepper
uses to reassemble a convection term from its state on the card.

Surface integrals: ``ds`` over a face of the space (``boundary=``) runs
on the boundary Gauss grid, the face's axis collapsed to one point and
reduced to its one boundary dof, the measure through the
``Jac_to_boundary`` parameter; ``ds`` on a surface (a geometry of one
more output dimension than the space, ``VForm(dim, geo_dim=dim + 1)``)
runs on the space's own grid.  Forms with second physical derivatives
or ``hess`` of the geometry read its parametric Hessian ``geo_hess_lvl``
``(geo_dim, d, d) + grid`` (level order), formed by K2 stages over the
second-derivative tables (:func:`~pyiga_tpu_torch.ops.cuda_sumfac.
geometry_hessian`).  A geometry that is no spline (a
:class:`~pyiga_tpu_torch.geometry.UserFunction`) is evaluated on the
host once, its values and Jacobian uploaded for K5 to read.
"""

import itertools

import numpy as np
import torch

from . import utils
from .bspline import KnotVector
from .config import get_dtype, no_tf32, resolve_device
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
            return vf.SW.eval(self)

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
            order = sum(D)
            if order not in (1, 2):
                raise NotImplementedError('derivatives of order > 2')
            if name == 'geo':           # level order
                m = gd - 1 - comp[0]
                if order == 1:
                    return arrays['geo_jac_lvl'][m][d - 1 - D.index(1)]
                i, j = [k for k, nk in enumerate(D) for _ in range(nk)]
                return arrays['geo_hess_lvl'][m][d - 1 - i][d - 1 - j]
            # the derivative axis of an input field is XYZ order, its
            # Hessian the symmetric pairs i <= j (pyiga_tpu/compile.py:
            # 146-169)
            arr = arrays['ideriv:%s:%d' % (name, order)]
            if order == 1:
                return arr[comp + (D.index(1),)]
            i, j = sorted(k for k, nk in enumerate(D) for _ in range(nk))
            return arr[comp + (_sym_index(d, i, j),)]

        raise KeyError('unknown field key %r' % (key,))


def _sym_index(d, i, j):
    """Index of (i, j), i <= j, in the linearized symmetric Hessian layout
    (xx, xy, xz, yy, yz, zz for d=3)."""
    # number of entries before row i: d + (d-1) + ... + (d-i+1)
    before = i * d - (i * (i - 1)) // 2
    return before + (j - i)


def _physical_field_derivs(f, geo, grid, comp_shape, with_hessian=False):
    """Physical gradient (and optionally Hessian) of the physical-coordinate
    field `f` at the mapped Gauss points of `grid`
    (``pyiga_tpu/compile.py:269-366``).

    Differentiates `f` itself: with ``torch.func`` forward mode when `f`
    traces on tensors, else by central finite differences on the physical
    coordinates (a function that calls numpy or :mod:`math` on its
    arguments does not trace, in either package).  Returns ``(grad,
    hess)`` with shapes ``grid + comp_shape + (sdim,)`` and ``grid +
    comp_shape + (nsym,)`` (symmetric pairs i <= j in XYZ order); `hess`
    is None unless requested."""
    pts = np.asarray(geo.grid_eval(grid))       # grid + (sdim,), XYZ comps
    grid_shape, sdim = pts.shape[:-1], pts.shape[-1]
    flat_pts = pts.reshape(-1, sdim)

    def fd_derivs():
        coords = [flat_pts[:, k] for k in range(sdim)]
        scale = [max(1.0, float(np.abs(c).max())) for c in coords]

        def ev(shifts):
            c = [ck + dk for ck, dk in zip(coords, shifts)]
            vals = f(*c)
            if isinstance(vals, tuple):
                vals = np.stack([np.broadcast_to(v, coords[0].shape)
                                 for v in vals], axis=-1)
            return np.broadcast_to(np.asarray(vals, dtype=float),
                                   coords[0].shape + comp_shape)

        zero = sdim * (0.0,)

        def shift(k, h):
            s = list(zero)
            s[k] = h
            return s

        g = np.empty((flat_pts.shape[0],) + comp_shape + (sdim,))
        steps = [1e-6 * s for s in scale]
        for k in range(sdim):
            h = steps[k]
            g[..., k] = (ev(shift(k, h)) - ev(shift(k, -h))) / (2 * h)
        if not with_hessian:
            return g, None
        nsym = (sdim * (sdim + 1)) // 2
        H = np.empty((flat_pts.shape[0],) + comp_shape + (nsym,))
        f0 = ev(zero)
        for i in range(sdim):
            hi = 1e-4 * scale[i]        # larger step: 2nd differences
            for j in range(i, sdim):
                hj = 1e-4 * scale[j]
                if i == j:
                    val = (ev(shift(i, hi)) - 2 * f0
                           + ev(shift(i, -hi))) / hi ** 2
                else:
                    spp = [0.0] * sdim
                    spp[i], spp[j] = hi, hj
                    smm = [-v for v in spp]
                    spm = [0.0] * sdim
                    spm[i], spm[j] = hi, -hj
                    smp = [-v for v in spm]
                    val = (ev(spp) - ev(spm) - ev(smp) + ev(smm)) \
                        / (4 * hi * hj)
                H[..., _sym_index(sdim, i, j)] = val
        return g, H

    def f_at(p):
        vals = f(*(p[k] for k in range(sdim)))
        if isinstance(vals, tuple):
            vals = torch.stack([torch.as_tensor(v, dtype=torch.float64)
                                for v in vals], dim=-1)
        return torch.as_tensor(vals, dtype=torch.float64)

    try:
        from torch.func import jacfwd, vmap
        P = torch.as_tensor(flat_pts, dtype=torch.float64)
        g = vmap(jacfwd(f_at))(P).numpy()
        H = None
        if with_hessian:
            Hfull = vmap(jacfwd(jacfwd(f_at)))(P).numpy()
            H = np.stack([0.5 * (Hfull[..., i, j] + Hfull[..., j, i])
                          for i in range(sdim) for j in range(i, sdim)],
                         axis=-1)
    except Exception:
        g, H = fd_derivs()

    g = g.reshape(grid_shape + comp_shape + (sdim,))
    if H is not None:
        H = H.reshape(grid_shape + comp_shape + (H.shape[-1],))
    return g, H


################################################################################
# Assembler class
################################################################################

def check_mode(mode):
    """The JAX package's assembly modes, accepted for API compatibility:
    the port has one float64 mode, the exact one."""
    if mode not in (None, 'exact', 'ozaki'):
        raise ValueError("mode must be 'exact' or 'ozaki'")


# probe results (pruned combos + symmetric-fold plan) per (form, input
# signature); the probe runs on a tiny fixed grid, so one entry serves
# every space size
_PRUNE_CACHE = {}


class VFormAssembler:
    """Assembler for a compiled :class:`~pyiga_tpu_torch.vform.VForm`.

    Subclassed per form by :func:`compile_vform`; instantiate with the
    spline space(s), the geometry and any named inputs/parameters, and
    ``device=`` (default: the card; ``'cpu'`` runs the kernels' plain
    versions).  A form whose basis functions live on two spaces takes the
    trial space `kvs` (matrix columns) and the test space ``kvs2`` (rows),
    the latter also as the first positional argument
    (``pyiga_tpu/compile.py:413-440``)."""

    vf = None   # set by compile_vform

    @classmethod
    def inputs(cls):
        return {inp.name: inp.shape for inp in cls.vf.inputs}

    @classmethod
    def parameters(cls):
        return {p.name: p.shape for p in cls.vf.params
                if p.name != 'Jac_to_boundary'}

    def __init__(self, kvs, *posargs, kvs2=None, boundary=None, bbox=None,
                 device=None, **args):
        vf = self.vf
        # the reference's generated assemblers are fully positional:
        # (kvs0[, kvs1], geo, inputs..., params...) binds in that order,
        # skipping what is given by keyword
        if posargs:
            posargs = list(posargs)
            if kvs2 is None and vf.num_spaces() == 2:
                kvs2 = posargs.pop(0)
            names = (['geo'] if 'geo' not in args else []) \
                + [inp.name for inp in vf.inputs
                   if inp.name not in args and inp.name != 'geo'] \
                + [p.name for p in vf.params
                   if p.name not in args and p.name != 'Jac_to_boundary']
            if len(posargs) > len(names):
                raise TypeError('too many positional arguments')
            args.update(zip(names, posargs))
        if isinstance(kvs, KnotVector):
            kvs = (kvs,)
        kvs = tuple(kvs)
        if kvs2 is not None:
            kvs2 = (kvs2,) if isinstance(kvs2, KnotVector) else tuple(kvs2)
            if len(kvs2) != len(kvs):
                raise ValueError('the two spaces differ in dimension')
        self.kvs0 = kvs                     # trial space (matrix columns)
        self.kvs1 = kvs2 if kvs2 is not None else kvs   # test space (rows)
        self.arity = vf.arity
        self.dim = len(kvs)
        if self.dim != vf.dim:
            raise ValueError('space dimension %d does not match the form '
                             '(%d)' % (self.dim, vf.dim))
        self.device = resolve_device(device)

        self.geo = args.pop('geo')
        self.bdspec = bdspec = args.pop('boundary', boundary)
        self.bbox = args.pop('bbox', bbox)
        if bdspec is not None and self.bbox is not None:
            raise ValueError('bbox and boundary exclude each other')

        # quadrature on the trial space's mesh, nqp = max(p) + 1 over both
        nqp = max(kv.p for kv in self.kvs0 + self.kvs1) + 1
        self.structure = MLStructure.from_kvs(self.kvs0, self.kvs1)
        if self.bbox is None:
            self.grid, self.gweights = sumfac.quadrature_for(
                kvs, nqp, bdspec=bdspec)
        else:
            # on-demand mode: the Gauss grid covers only the cells of the
            # bbox, so entries whose test function is supported inside it
            # are exact and the others partial
            self.grid, self.gweights = make_tensor_quadrature(
                [kv.mesh[bb[0]:bb[1] + 1] for kv, bb in zip(kvs, self.bbox)],
                nqp)
            self._restrict_to_bbox()
        self.maxderiv = vf.max_deriv_order()
        if bdspec is not None:
            # a boundary integral: the normal axis keeps the one boundary
            # basis function that does not vanish there
            # (pyiga_tpu/compile.py:490-507)
            bdax = bdspec[0]
            bs, bidx = list(self.structure.bs), list(self.structure.bidx)
            bs[bdax] = (1, 1)
            bidx[bdax] = np.zeros((1, 2), dtype=np.uint32)
            self.structure = MLStructure(bs, bidx)
        self.tables = sumfac.SpaceTables(self.kvs0, self.kvs1, self.grid,
                                         self.structure.bidx, self.maxderiv)
        if bdspec is not None:
            sl = slice(0, 1) if bdspec[1] == 0 else slice(-1, None)
            shared = self.tables.test is self.tables.trial
            self.tables.trial[bdax] = self.tables.trial[bdax][:, sl, :]
            if not shared:
                self.tables.test[bdax] = self.tables.test[bdax][:, sl, :]

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
        self._build_arrays()
        self._num_combos_total = len(self.combos)
        self._prune_combos()
        self._operands = {}         # compute dtype -> device operands
        self._program_cache = {}
        self._slice_cache = self._full_mlm = None
        self._slice_dtype = None

    def _restrict_to_bbox(self):
        """Drop the per-axis dof pairs with no support inside the bbox:
        their basis-table rows vanish on the restricted Gauss grid, so
        their compact entries are structural zeros, and the contraction
        cost scales with the stored entries (hierarchical windows are
        small corners of large levels).  Records per axis the half-open
        range of test functions supported in the bbox
        (``_bbox_win_test``)."""
        def window(kv, bb):
            supp = kv.mesh_support_idx_all()
            return (supp[:, 0] < bb[1]) & (supp[:, 1] > bb[0])

        bidx = []
        self._bbox_win_test = []
        for k, bx in enumerate(self.structure.bidx):
            wi = window(self.kvs1[k], self.bbox[k])     # test / rows
            wj = window(self.kvs0[k], self.bbox[k])     # trial / columns
            ij = bx.astype(np.intp)
            keep = wi[ij[:, 0]] & wj[ij[:, 1]]
            bidx.append(bx[keep])
            nz = np.nonzero(wi)[0]      # contiguous for B-splines
            self._bbox_win_test.append(
                (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0))
        self.structure = MLStructure(self.structure.bs, bidx)

    # -- array setup -------------------------------------------------------------

    def _needs_geo_hessian(self):
        """Whether the form reads the geometry's second derivatives: a
        ``hess`` of the geometry, or second physical derivatives (outside
        space-time forms, whose transform names them itself)."""
        for key in self._needed_keys:
            if key[0] == 'input_deriv' and key[1] == 'geo' \
                    and sum(key[3]) >= 2:
                return True
        return self.maxderiv >= 2 and not self.vf.spacetime and \
            any(key[0] == 'jacinv' for key in self._needed_keys)

    def _build_arrays(self):
        """Host setup of the grid arrays.  A spline geometry stays as
        tables (with second derivatives where the form needs its Hessian)
        and coefficients, its fields computed on the device; any other is
        evaluated here, its values and Jacobian kept as host arrays
        (``pyiga_tpu/compile.py:548-575``)."""
        arrays = {'weights': [np.asarray(w) for w in self.gweights]}
        geo_derivs = 2 if self._needs_geo_hessian() else 1
        setup = geom.geo_eval_tables(self.geo, self.grid,
                                     numderiv=geo_derivs)
        if setup is None:
            if geo_derivs >= 2:
                raise NotImplementedError(
                    'this form needs second geometry derivatives, which are '
                    'only available for spline/NURBS geometries; wrap the '
                    'geometry as a BSplineFunc/NurbsFunc (e.g. via '
                    'approx.interpolate) to use it here')
            arrays['geo_jac_lvl'] = geom.host_jacobian_levelorder(
                self.geo, self.grid)
            val = geom.host_eval(self.geo, self.grid)       # grid x dim
            arrays['geo_val_lvl'] = np.ascontiguousarray(
                np.moveaxis(val[..., ::-1], -1, 0))
            self._geo_tables = self._geo_coeffs = None
            self._geo_is_nurbs = False
        else:
            self._geo_tables, self._geo_coeffs, self._geo_is_nurbs = setup
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
        leading) and, for each derivative order the form takes of it, its
        derivatives ``ideriv:<name>:<order>`` (``comp + (XYZ axis,) +
        grid``, or the symmetric pairs for order 2): a spline input's
        ``grid_jacobian`` / ``grid_hessian``, a physical input's
        :func:`_physical_field_derivs` (``pyiga_tpu/compile.py:
        577-637``)."""
        if inp.physical:
            vals = utils.grid_eval_transformed(f, self.grid, self.geo)
        else:
            vals = utils.grid_eval(f, self.grid)
        n = len(inp.shape)
        vals = np.moveaxis(np.asarray(vals, dtype=float),
                           tuple(range(-n, 0)), tuple(range(n)))
        out = {'input:' + inp.name: np.ascontiguousarray(vals)}
        orders = {sum(key[3]) for key in self._needed_keys
                  if key[0] == 'input_deriv' and key[1] == inp.name}
        for order in sorted(orders):
            if order > 2:
                raise NotImplementedError('input derivs of order > 2')
            if inp.physical:
                grad, hess = _physical_field_derivs(
                    f, self.geo, self.grid, inp.shape,
                    with_hessian=order == 2)
                arr = grad if order == 1 else hess
            elif order == 1:
                arr = f.grid_jacobian(self.grid)
            else:
                arr = f.grid_hessian(self.grid)
            # grid x comp... x (XYZ axis or pair), moved to the front
            arr = np.moveaxis(np.asarray(arr, dtype=float),
                              tuple(range(-(n + 1), 0)), tuple(range(n + 1)))
            out['ideriv:%s:%d' % (inp.name, order)] = \
                np.ascontiguousarray(arr)
        return out

    def update(self, **upd):
        """Update updatable input fields (their values and derivatives
        are evaluated anew) and/or parameters, or the geometry (which
        also re-evaluates physically given inputs).  Drops the cached
        device operands that the change makes stale: after a new geometry
        all of them and the generated K5 program; after new input or
        parameter values the changed tensors (a parameter also refreshes
        the flat parameter vector), and the program only if a changed
        value has a new shape (``pyiga_tpu/compile.py:639-695``)."""
        geo_changed = False
        changed = {}
        for name, f in upd.items():
            if name == 'geo':
                self.geo = f
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
        self._slice_cache = self._full_mlm = None
        if geo_changed:
            self._build_arrays()
            self._operands = {}
            self._program_cache = {}
            return
        if any(np.shape(a) != np.shape(self._host_arrays[k])
               for k, a in changed.items()):
            self._program_cache = {}
        self._host_arrays.update(changed)
        for dtype, ops in list(self._operands.items()):
            inputs = dict(ops['inputs'])
            for k, a in changed.items():
                inputs[k] = torch.as_tensor(np.ascontiguousarray(a),
                                            dtype=dtype, device=self.device)
            if any(k.startswith('param:') for k in changed):
                inputs['params'] = self._param_tensor(dtype)
            self._operands[dtype] = dict(ops, inputs=inputs)

    def _param_tensor(self, dtype):
        """The flat parameter vector K5 reads, on the device in `dtype`."""
        return torch.as_tensor(cuda_vform.param_vector(self._host_arrays),
                               dtype=dtype, device=self.device)

    # -- slices of the compact tensor (low-rank assembly) ----------------------

    def _make_slice_fn(self, fixed_axes):
        """The slice evaluator of a pinned-axes pattern: ``fn(fields,
        term_tables, idx)`` with `idx` an int64 tensor of the pinned pair
        indices (in `fixed_axes` order) on the fields' device.  Each
        combo's field is contracted against its per-axis tables in f64,
        the pinned axes first, the last of them first: a pinned ``(1, Q)``
        table collapses its grid axis at once, so the free axes' stages
        run on a thin intermediate, and the full field is contracted over
        its first or last axis, which needs no transposed copy of it.  The
        contractions run in the fields' dtype (float32 in full float32,
        never TF32)."""
        d = self.dim
        order = sorted(fixed_axes, reverse=True) + [
            k for k in range(d) if k not in fixed_axes]

        def contract(X, T, k):
            if k == 0:
                return torch.tensordot(T, X, dims=([1], [0]))
            return torch.movedim(torch.tensordot(X, T, dims=([k], [1])),
                                 -1, k)

        def slice_fn(fields, term_tables, idx):
            with no_tf32(fields[0].dtype):
                return chains(fields, term_tables, idx)

        def chains(fields, term_tables, idx):
            out = None
            for C, tabs in zip(fields, term_tables):
                tabs = list(tabs)
                for pos, ax in enumerate(fixed_axes):
                    tabs[ax] = tabs[ax].index_select(0, idx[pos:pos + 1])
                X = C
                for k in order:
                    X = contract(X, tabs[k], k)
                out = X if out is None else out + X
            return out.reshape([out.shape[k] for k in range(d)
                                if k not in fixed_axes])
        return slice_fn

    def _slice_fn_cached(self, fixed_axes):
        """The slice evaluator of a pinned-axes pattern (cached)."""
        fns = self.__dict__.setdefault('_slice_fns', {})
        fn = fns.get(fixed_axes)
        if fn is None:
            fn = fns[fixed_axes] = self._make_slice_fn(fixed_axes)
        return fn

    def _slice_operands(self):
        """``(fields, term_tables)`` of the slice evaluators on the
        assembler's device: the coefficient field of EVERY combo (not
        only those of the fold plan that ``run_device`` evaluates), from
        K2 + K1 ``jac`` + K5 once, and each combo's per-axis tables, in
        the compute dtype; cached until :meth:`update` or a change of the
        compute dtype (one dtype's slices kept at a time, as the JAX
        package's ``_tables_cache``)."""
        dtype = get_dtype()
        if self._slice_cache is None or self._slice_dtype != dtype:
            ops = self._device_operands()
            fields = cuda_vform.combo_fields(self, self.device_arrays(),
                                             self.combos)
            self._slice_cache = (fields, ops['term_tables'])
            self._slice_dtype = dtype
        return self._slice_cache

    def compact_slice(self, fixed):
        """A slice of the compact data tensor with the axes of the dict
        `fixed` (axis -> pair index) pinned: the dense host array over the
        free axes, computed on the assembler's device by tensordot chains
        in the compute dtype over the cached coefficient fields (the ACA's
        entry callback; float32 under float32, as the JAX package's)."""
        if self.vf.vec or self.arity != 2:
            raise ValueError('compact_slice needs a scalar bilinear form')
        fixed_axes = tuple(sorted(fixed.keys()))
        fn = self._slice_fn_cached(fixed_axes)
        fields, tables = self._slice_operands()
        idx = torch.tensor([int(fixed[ax]) for ax in fixed_axes],
                           dtype=torch.int64, device=self.device)
        return fn(fields, tables, idx).cpu().numpy()

    def multi_entries(self, indices):
        """Entries ``(i, j) -> value`` for a list of global index pairs:
        the matrix is assembled once (kept until :meth:`update`) and
        gathered."""
        if self.vf.vec:
            raise ValueError('multi_entries needs a scalar form')
        if self._full_mlm is None:
            self._full_mlm = self.assemble().asmatrix('csr')
        indices = np.asarray(indices)
        return np.asarray(
            self._full_mlm[indices[:, 0], indices[:, 1]]).ravel()

    def num_components(self):
        """Components per basis function space (vector forms only;
        ``pyiga_tpu/compile.py:1640``)."""
        if not self.vf.vec:
            raise ValueError('num_components needs a vector-valued form')
        return self.vf.num_components()

    def multi_blocks(self, indices):
        """Per-dof component blocks for a list of (i, j) global block index
        pairs; returns an array of shape ``(len(indices), ncv, ncu)``
        (``pyiga_tpu/compile.py:1657-1671``)."""
        if not self.vf.vec or self.arity != 2:
            raise ValueError('multi_blocks needs a vector-valued bilinear '
                             'form')
        ncu, ncv = self.vf.num_components()
        indices = np.asarray(indices)
        out = np.zeros((len(indices), ncv, ncu))
        for (cu, cv), blk in self.assemble().items():
            mat = blk.asmatrix('csr')
            out[:, cv, cu] = np.asarray(
                mat[indices[:, 0], indices[:, 1]]).ravel()
        return out

    # -- evaluation ----------------------------------------------------------------

    def _make_context(self, arrays, seed_u, seed_v):
        return AsmContext(self.vf, arrays, seed_u, seed_v)

    def _program(self, combos, dtype=torch.float64):
        """The generated K5 program of `combos` in `dtype` (cached per
        combos and dtype: one form in both dtypes builds two
        libraries)."""
        key = (tuple(combos), dtype)
        if key not in self._program_cache:
            self._program_cache[key] = cuda_vform.generate(self, combos,
                                                           dtype)
        return self._program_cache[key]

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
        return (self.vf.hash(), self.dim, self.vf.geo_dim, self.arity,
                bool(self.vf.vec), repr(self.bdspec),
                self._needs_geo_hessian(), hsig, self.kvs0 == self.kvs1)

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
        if self._needs_geo_hessian():
            H = rnd((self.vf.geo_dim, self.dim, self.dim) + gshape)
            probe['geo_hess_lvl'] = 0.5 * (H + H.swapaxes(1, 2))
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
        """Probe-based symmetric-term folding (scalar bilinear forms on one
        space): a combo (su, sv) whose swapped partner (sv, su) has a
        numerically equal probe field contributes the transpose of its
        partner's chain, so one chain of each pair runs and the
        compact-layout transpose gather mirrors it.  Off for vector and
        two-space forms and for boundary integrals
        (``pyiga_tpu/compile.py:1119``)."""
        self._fold_plan = self._fold_tperms = None
        if self.arity != 2 or self.vf.vec or self.kvs0 != self.kvs1 \
                or self.bdspec is not None:
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
        """Device tensors of the assembly in the compute dtype (memoized
        per dtype, as the JAX package keys its operands by ``(mode,
        dtype)``): input arrays and the flat parameter vector
        (``params``), geometry tables and coefficients, term tables (each
        distinct host table uploaded once), their last-table groups, and
        the transpose permutations of a folded plan."""
        dtype = get_dtype()
        if dtype in self._operands:
            return self._operands[dtype]
        dev = self.device

        def tensor(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=dev)
        inputs = {k: [tensor(w) for w in v] if k == 'weights' else tensor(v)
                  for k, v in self._host_arrays.items()}
        inputs['params'] = self._param_tensor(dtype)
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
        spline = self._geo_tables is not None
        self._operands[dtype] = dict(
            inputs=inputs,
            geo_tables=[tensor(t) for t in self._geo_tables]
            if spline else None,
            geo_coeffs=tensor(self._geo_coeffs) if spline else None,
            term_tables=[[uploaded[id(T)] for T in tabs]
                         for tabs in host_tabs],
            last_idx=sumfac.last_table_groups(host_tabs),
            tperms=tperms)
        return self._operands[dtype]

    def _geometry_fields(self, coeffs):
        """Physical geometry values and Jacobian ``(geo_val_lvl,
        geo_jac_lvl)`` on the Gauss grid, from K2 and K1's ``jac`` kind
        on the spline coefficients `coeffs`; for a host-evaluated
        geometry its uploaded arrays."""
        ops = self._device_operands()
        if ops['geo_tables'] is None:
            return ops['inputs']['geo_val_lvl'], ops['inputs']['geo_jac_lvl']
        return cuda_sumfac.geometry_fields(ops['geo_tables'], coeffs,
                                           self._geo_is_nurbs)

    def device_arrays(self, inputs=None, geo_coeffs=None):
        """The device tensors K5 evaluates on: the inputs, parameters (per
        name and as the flat ``params`` vector) and per-axis Gauss
        weights, plus the physical geometry values ``geo_val_lvl``
        ``(gd,) + grid`` and Jacobian ``geo_jac_lvl`` ``(gd, d) + grid``
        (level order; ``gd`` the geometry's output dimension) from K2 and
        K1's ``jac`` kind and, where the form needs it, the parametric
        Hessian ``geo_hess_lvl`` ``(gd, d, d) + grid`` from K2 stages
        (:func:`~pyiga_tpu_torch.ops.cuda_sumfac.geometry_hessian`),
        computed anew on every call and not kept: held beside the cached
        operands they would add ``gd (d + 1)`` or more grid-sized fields
        to every assembler for the life of its operands.  A
        host-evaluated geometry's values and Jacobian are uploaded once
        with the operands.

        `inputs` maps ``input:<name>`` / ``ideriv:<name>:1`` keys to
        device tensors of the cached operands' shapes that replace them
        for this call only (the in-loop reassembly of a stepper, whose
        velocity fields are formed on the device), and ``param:<name>``
        keys to parameter values (the flat ``params`` vector is formed
        from them anew).  `geo_coeffs` replaces the spline geometry's
        coefficients (level order, component axis leading, as the cached
        ones) for this call.  Every replacement may carry autograd
        history: the fields are differentiable in them
        (:mod:`~pyiga_tpu_torch.diff`).  Every tensor is of the compute
        dtype."""
        ops = self._device_operands()
        arrays = dict(ops['inputs'])
        coeffs = ops['geo_coeffs']
        if geo_coeffs is not None:
            geom.check_replacement(coeffs, geo_coeffs, get_dtype(),
                                   arrays['weights'][0].device)
            coeffs = geo_coeffs
        arrays['geo_val_lvl'], arrays['geo_jac_lvl'] = \
            self._geometry_fields(coeffs)
        if self._needs_geo_hessian():
            arrays['geo_hess_lvl'] = cuda_sumfac.geometry_hessian(
                ops['geo_tables'], coeffs, self._geo_is_nurbs)
        if inputs is None:
            return arrays
        for key, t in inputs.items():
            old = arrays.get(key)
            if not key.startswith(('input:', 'ideriv:', 'param:')) \
                    or old is None or t.shape != old.shape \
                    or t.dtype != old.dtype or t.device != old.device:
                raise ValueError('run_device: input %r does not replace an '
                                 'operand of the same shape, dtype and '
                                 'device' % key)
            arrays[key] = t
        if any(key.startswith('param:') for key in inputs):
            # the layout of cuda_vform.param_vector
            arrays['params'] = torch.cat(
                [arrays[k].reshape(-1) for k in self._host_arrays
                 if k.startswith('param:')])
        return arrays

    def _block_plans(self):
        """Per component block ``(cu, cv)`` (``(None, None)`` for a scalar
        form, ``(None, cv)`` for a functional) the non-folded plan of its
        combos."""
        blocks = {}
        for t, (su, sv) in enumerate(self.combos):
            key = (None if su is None else su[0], sv[0])
            blocks.setdefault(key, []).append((t, False))
        return blocks

    def run_device(self, mode=None, inputs=None):
        """Assemble to device-resident compact data tensors on the
        assembler's device: geometry fields (K2 + K1 ``jac``), coefficient
        fields (K5), chains (K2 stages, then one K3 fold per block) and,
        for a folded symmetric form, the transpose gather of mirrored
        terms.  Returns a dict of blocks: ``{(None, None): data}`` for a
        scalar form, ``{(cu, cv): data}`` for a vector form (``(None,
        cv)`` for a functional; pruned blocks are absent), data of shape
        ``(nnz_1, ..., nnz_d)`` (matrix) or ``(n_1, ..., n_d)`` (vector),
        in the compute dtype (``pyiga_tpu/compile.py:1227-1238``).

        `inputs` replaces input fields for this call (see
        :meth:`device_arrays`); everything else comes from the cached
        operands.  `mode` ('exact', 'ozaki' or None) is accepted for API
        compatibility: the port has one f64 mode, the exact one."""
        check_mode(mode)
        return self._assemble_blocks(self.device_arrays(inputs))

    def _assemble_blocks(self, arrays):
        """The blocks of :meth:`run_device` from the device tensors
        `arrays` (:meth:`device_arrays`); with replaced operands there
        this is the differentiable route of :mod:`~pyiga_tpu_torch.diff`
        (the counterpart of the JAX package's ``_assembly_fn``)."""
        ops = self._device_operands()
        if self._fold_plan is not None:
            plan = self._fold_plan
            # only the plan's terms: a mirrored term's partner is never
            # needed
            terms = [t for t, _m in plan]
            fields = [None] * len(self.combos)
            for t, F in zip(terms, cuda_vform.combo_fields(
                    self, arrays, [self.combos[t] for t in terms])):
                fields[t] = F
            return {(None, None): cuda_sumfac.assemble_terms_folded(
                ops['term_tables'], fields, plan, ops['tperms'],
                ops['last_idx'])}
        fields = cuda_vform.combo_fields(self, arrays, self.combos)
        return {key: cuda_sumfac.assemble_terms_folded(
                    ops['term_tables'], fields, plan, None, ops['last_idx'])
                for key, plan in self._block_plans().items()}

    def assemble(self, mode=None):
        """Assemble and return the matrix as a host
        :class:`~pyiga_tpu_torch.mlmatrix.MLMatrix` (scalar forms) or a
        dict of ``(cu, cv) -> MLMatrix`` blocks (vector forms), float64
        data (under float32 holding the float32 results, as the JAX
        package's ``_run``)."""
        if self.arity != 2:
            raise ValueError('assemble() needs a bilinear form; use '
                             'assemble_vector()')
        blocks = {k: self.structure.make_mlmatrix(
                      data=v.cpu().numpy().astype(np.float64))
                  for k, v in self.run_device(mode).items()}
        return blocks if self.vf.vec else blocks[(None, None)]

    def assemble_vector(self):
        """Assemble an arity-1 functional; returns the host array of shape
        per-axis dofs, with a trailing component axis for a vector-valued
        test function (zero for a pruned component;
        ``pyiga_tpu/compile.py:1433-1466``)."""
        if self.arity != 1:
            raise ValueError('assemble_vector() needs a linear functional')
        blocks = {k: v.cpu().numpy().astype(np.float64)
                  for k, v in self.run_device().items()}
        if not self.vf.vec:
            return blocks[(None, None)]
        zero = np.zeros_like(next(iter(blocks.values())))
        return np.stack([blocks.get((None, c), zero)
                         for c in range(self.vf.basis_funs[0].numcomp)],
                        axis=-1)


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
