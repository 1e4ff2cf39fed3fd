# -*- coding: utf-8 -*-
"""High-level assembly API (port of the VForm part of
:mod:`pyiga_tpu.assemble`): :func:`assemble` of a form string, a
:class:`~pyiga_tpu_torch.vform.VForm`, a compiled assembler class or an
assembler instance; :func:`mass` and :func:`stiffness` over a TP space
(the 1D builders, the Kronecker route for ``geo=None`` and the Gauss
assemblers of :mod:`pyiga_tpu_torch.assemblers` for a geometry), and
their low-rank ACA counterparts :func:`mass_fast` and
:func:`stiffness_fast`; vector-valued forms in the blocked and packed
layouts (:func:`assemble_entries_vec`, :func:`divdiv`), forms on two
spaces, and :class:`Assembler`, which reassembles after updating its
inputs.

Matrix conventions as in the JAX package: rows are test functions,
columns trial functions.  The device is explicit (``device=``; omitted
means the card, ``'cpu'`` the CPU): problems are never rerouted to
another device by size.
Also here, as host copies: load vectors and integrals by the
assemblers' Gauss rule (:func:`inner_products`, :func:`integrate`), the
boundary index sets of a tensor-product space (:func:`boundary_dofs`,
:func:`boundary_cells`), Dirichlet data by interpolation on the boundary
faces (:func:`compute_dirichlet_bcs`, :func:`combine_bcs`) and
:class:`RestrictedLinearSystem` for eliminating Dirichlet dofs.
Boundary integrals are not ported yet.
"""

import numpy as np
import scipy.sparse

from . import assemblers, bspline, operators, tensor, utils
from . import vform as vform_mod
from .bspline import KnotVector
from .compile import compile_vform
from .mlmatrix import MLStructure
from .quadrature import make_iterated_quadrature, make_tensor_quadrature


################################################################################
# 1D assemblers (host copies of the JAX package's)
################################################################################

def _quad_biform_1d(kv_trial, kv_test, du, dv, quadgrid=None, nqp=None,
                    weightfunc=None):
    """Core 1D quadrature bilinear form ``C_test^(dv)^T diag(w)
    C_trial^(du)`` over per-span Gauss nodes (Galerkin and
    Petrov-Galerkin)."""
    if quadgrid is None:
        quadgrid = kv_trial.mesh
    if nqp is None:
        # exact for the polynomial integrand degree
        degree = kv_trial.p + kv_test.p - du - dv
        nqp = (degree + 2) // 2
    nodes, weights = make_iterated_quadrature(quadgrid, nqp)
    if weightfunc is not None:
        weights = weights * utils.grid_eval(weightfunc, (nodes,))
    Du = bspline.collocation_derivs(kv_trial, nodes, derivs=du)[du]
    Dv = bspline.collocation_derivs(kv_test, nodes, derivs=dv)[dv]
    return (Dv.T @ scipy.sparse.diags(weights) @ Du).tocsr()


def bsp_mixed_deriv_biform_1d(knotvec, du, dv, nqp=None, weightfunc=None):
    """1D matrix for ``a(u,v) = int weight * u^(du) v^(dv)``."""
    return _quad_biform_1d(knotvec, knotvec, du, dv, nqp=nqp,
                           weightfunc=weightfunc)


def bsp_mass_1d(knotvec, weightfunc=None):
    """1D mass matrix (optionally weighted)."""
    return _quad_biform_1d(knotvec, knotvec, 0, 0, weightfunc=weightfunc)


def bsp_stiffness_1d(knotvec, weightfunc=None):
    """1D stiffness (Laplace) matrix (optionally weighted)."""
    return _quad_biform_1d(knotvec, knotvec, 1, 1, weightfunc=weightfunc)


def bsp_mixed_deriv_biform_1d_asym(knotvec1, knotvec2, du, dv,
                                   quadgrid=None, nqp=None):
    """Petrov-Galerkin 1D matrix relating trial space `knotvec1` (`du`
    derivatives) and test space `knotvec2` (`dv` derivatives); shape
    ``knotvec2.numdofs x knotvec1.numdofs``."""
    return _quad_biform_1d(knotvec1, knotvec2, du, dv, quadgrid=quadgrid,
                           nqp=nqp)


def bsp_mass_1d_asym(knotvec1, knotvec2, quadgrid=None):
    return _quad_biform_1d(knotvec1, knotvec2, 0, 0, quadgrid=quadgrid)


def bsp_stiffness_1d_asym(knotvec1, knotvec2, quadgrid=None):
    return _quad_biform_1d(knotvec1, knotvec2, 1, 1, quadgrid=quadgrid)


################################################################################
# Multi-dimensional mass/stiffness: Kronecker route and Gauss assemblers
################################################################################

def _separable_mass(kvs, format):
    """geo=None: the mass matrix is an exact Kronecker product of 1D mass
    matrices."""
    out = bsp_mass_1d(kvs[-1])
    for kv in reversed(kvs[:-1]):
        out = scipy.sparse.kron(bsp_mass_1d(kv), out, format=format)
    return out


def _separable_stiffness(kvs, format):
    """geo=None: Laplace = sum over axes of (mass (x) ... (x)
    stiffness_at_axis (x) ... (x) mass), with nested grouping per axis."""
    M = [bsp_mass_1d(kv) for kv in kvs]
    K = [bsp_stiffness_1d(kv) for kv in kvs]

    def kron(A, B):
        return scipy.sparse.kron(A, B, format=format)

    def build(lo):
        # sum of Kronecker terms for axes lo..d-1 (exactly one K factor)
        if lo == len(kvs) - 1:
            return K[lo], M[lo]
        K_rest, M_rest = build(lo + 1)
        return kron(K[lo], M_rest) + kron(M[lo], K_rest), kron(M[lo], M_rest)

    return build(0)[0]


def _geometry_assembler_entries(asm_class, knotvecs, geo, format,
                                device=None):
    return assemble_entries(asm_class(knotvecs, geo, device=device),
                            symmetric=True, format=format)


def bsp_mass_2d(knotvecs, geo=None, format='csr', device=None):
    if geo is None:
        return _separable_mass(knotvecs, format)
    return _geometry_assembler_entries(assemblers.MassAssembler2D,
                                       knotvecs, geo, format, device)


def bsp_stiffness_2d(knotvecs, geo=None, format='csr', device=None):
    if geo is None:
        return _separable_stiffness(knotvecs, format)
    return _geometry_assembler_entries(assemblers.StiffnessAssembler2D,
                                       knotvecs, geo, format, device)


def bsp_mass_3d(knotvecs, geo=None, format='csr', device=None):
    if geo is None:
        return _separable_mass(knotvecs, format)
    return _geometry_assembler_entries(assemblers.MassAssembler3D,
                                       knotvecs, geo, format, device)


def bsp_stiffness_3d(knotvecs, geo=None, format='csr', device=None):
    if geo is None:
        return _separable_stiffness(knotvecs, format)
    return _geometry_assembler_entries(assemblers.StiffnessAssembler3D,
                                       knotvecs, geo, format, device)


def mass(kvs, geo=None, format='csr', device=None):
    """Mass matrix over a TP spline space: the 1D builder for one axis,
    the Kronecker route for ``geo=None``, else the
    :class:`~pyiga_tpu_torch.assemblers.MassAssembler` on `device`
    (default: the card)."""
    kvs = (kvs,) if isinstance(kvs, KnotVector) else tuple(kvs)
    if len(kvs) == 1:
        return bsp_mass_1d(kvs[0])
    if geo is None:
        return _separable_mass(kvs, format)
    return _geometry_assembler_entries(assemblers.MassAssembler, kvs, geo,
                                       format, device)


def stiffness(kvs, geo=None, format='csr', device=None):
    """Stiffness matrix over a TP spline space (routes as :func:`mass`;
    the Gauss assembler is the
    :class:`~pyiga_tpu_torch.assemblers.StiffnessAssembler`)."""
    kvs = (kvs,) if isinstance(kvs, KnotVector) else tuple(kvs)
    if len(kvs) == 1:
        return bsp_stiffness_1d(kvs[0])
    builders = {2: bsp_stiffness_2d, 3: bsp_stiffness_3d}
    if len(kvs) not in builders:
        raise ValueError('dimension %d not supported' % len(kvs))
    return builders[len(kvs)](kvs, geo=geo, format=format, device=device)


################################################################################
# Right-hand sides and integration
################################################################################

def _weighted_gauss_values(kvs, f, f_physical, geo, caller):
    """Evaluate `f` on the assembler Gauss grid (nqp = max(p)+1 per axis)
    and fold in the quadrature weights and, with geometry, |det J|.
    Returns ``(kvs, gaussgrid, weighted values)``."""
    if isinstance(kvs, KnotVector):
        kvs = (kvs,)
    nqp = max(kv.p for kv in kvs) + 1
    grid, gw = make_tensor_quadrature([kv.mesh for kv in kvs], nqp)

    if f_physical:
        if geo is None:
            raise ValueError('%s in physical domain requires geometry'
                             % caller)
        vals = utils.grid_eval_transformed(f, grid, geo)
    else:
        vals = utils.grid_eval(f, grid)

    vals = tensor.apply_tprod(
        [operators.DiagonalOperator(w) for w in gw], vals)
    if geo is not None:
        det = np.abs(np.linalg.det(geo.grid_jacobian(grid)))
        # trailing component axes broadcast against the grid-shaped det
        vals = vals * det.reshape(det.shape
                                  + (vals.ndim - det.ndim) * (1,))
    return kvs, grid, vals


def inner_products(kvs, f, f_physical=False, geo=None):
    """L2 inner products of all TP basis functions with `f` (the load
    vector), as an array of shape ``numdofs(kv) per axis`` (+
    components)."""
    kvs, grid, vals = _weighted_gauss_values(kvs, f, f_physical, geo,
                                             'inner_products')
    basis_T = [bspline.collocation(kv, g).T for kv, g in zip(kvs, grid)]
    return tensor.apply_tprod(basis_T, vals)


def integrate(kvs, f, f_physical=False, geo=None):
    """Integral of `f` over the domain described by `geo` (or the
    parameter domain), using the same Gauss rule as the assemblers."""
    kvs, _, vals = _weighted_gauss_values(kvs, f, f_physical, geo,
                                          'integrate')
    return vals.sum(axis=tuple(range(len(kvs))))


################################################################################
# Boundary index sets, restricted systems and the VForm entry points
################################################################################


def slice_indices(ax, idx, shape, ravel=False, flip=None):
    """Dof indices of the slice at index `idx` along axis `ax` of a TP
    basis with the given `shape`; as multi-indices or raveled
    (`ravel=True`).  `flip` optionally reverses the traversal of the
    remaining axes."""
    shape = tuple(shape)
    per_axis = [np.arange(n) for n in shape]
    per_axis[ax] = np.array([range(shape[ax])[idx]])    # negative idx wraps
    if flip is not None:
        rest = [k for k in range(len(shape)) if k != ax]
        for k, flp in zip(rest, flip):
            if flp:
                per_axis[k] = per_axis[k][::-1]
    mesh = np.meshgrid(*per_axis, indexing='ij')
    multi = np.stack([m.ravel() for m in mesh], axis=-1)
    if ravel:
        return np.ravel_multi_index(tuple(multi.T), shape)
    return multi


def boundary_dofs(kvs, bdspec, ravel=False, flip=None):
    """Indices of the dofs lying on the given boundary face."""
    ax, side = bspline._parse_bdspec(bdspec, len(kvs))
    return slice_indices(ax, -side, tuple(kv.numdofs for kv in kvs),
                         ravel=ravel, flip=flip)


def boundary_cells(kvs, bdspec, ravel=False):
    """Indices of the cells lying on the given boundary face."""
    ax, side = bspline._parse_bdspec(bdspec, len(kvs))
    return slice_indices(ax, -side, tuple(kv.numspans for kv in kvs),
                         ravel=ravel)


def _drop_nans(indices, values):
    ok = ~np.isnan(values)
    return (indices, values) if ok.all() else (indices[ok], values[ok])


def _face_space(kvs, bdspec):
    """The (d-1)-dim knot vectors of a boundary face plus the face's dof
    indices in the full space (raveled, face-lexicographic order)."""
    bdax, bdside = bdspec
    face_kvs = tuple(kv for k, kv in enumerate(kvs) if k != bdax)
    N = tuple(kv.numdofs for kv in kvs)
    face_dofs = slice_indices(bdax, -bdside, N, ravel=True)
    return face_kvs, face_dofs


def compute_dirichlet_bc(kvs, geo, bdspec, dir_func):
    """Indices and values of the Dirichlet dofs on one boundary face,
    computed by interpolating `dir_func` (given in physical coordinates;
    scalars mean constant functions; vector-valued functions produce
    blocked numbering).  NaN values drop the dof from the BC (mixed
    conditions on one face)."""
    from .approx import interpolate
    bdspec = bspline._parse_bdspec(bdspec, len(kvs))
    if len(kvs) != geo.sdim:
        raise ValueError('invalid dimension of geometry')
    face_kvs, face_dofs = _face_space(kvs, bdspec)

    if np.isscalar(dir_func):
        value = dir_func

        def dir_func(*x):
            return value
    coeffs = interpolate(face_kvs, dir_func, geo=geo.boundary(bdspec))

    ncomp_dims = coeffs.ndim - len(face_kvs)
    if ncomp_dims == 0:
        return _drop_nans(face_dofs, coeffs.ravel())
    if ncomp_dims == 1:
        # vector problem, blocked numbering: component j offset by j*N
        stride = np.prod([kv.numdofs for kv in kvs])
        per_comp = [(face_dofs + j * stride, coeffs[..., j].ravel())
                    for j in range(coeffs.shape[-1])]
        return _drop_nans(*combine_bcs(per_comp))
    raise ValueError('invalid dimension of Dirichlet coefficients: %s'
                     % (coeffs.shape,))


def compute_dirichlet_bcs(kvs, geo, bdconds):
    """Combined (indices, values) for several boundary conditions; the
    shorthand ``("all", g)`` applies `g` on every boundary face."""
    if len(bdconds) == 2 and bdconds[0] == 'all':
        g = bdconds[1]
        bdconds = [((ax, side), g)
                   for ax in range(len(kvs)) for side in (0, 1)]
    return combine_bcs([compute_dirichlet_bc(kvs, geo, bdspec, g)
                        for (bdspec, g) in bdconds])


def compute_initial_condition_01(kvs, geo, bdspec, g0, g1, physical=True):
    """Indices/values fixing function value `g0` and first derivative `g1`
    at one face of a space-time cylinder with constant-in-time geometry.

    Only the two outermost basis functions along the time axis are
    nonzero (with their derivative) at the face, so a 2x2 collocation
    solve per spatial dof yields the coefficients."""
    from .approx import interpolate
    bdspec = bspline._parse_bdspec(bdspec, len(kvs))
    bdax, bdside = bdspec
    face_kvs = tuple(kv for k, kv in enumerate(kvs) if k != bdax)

    bdgeo = geo.boundary(bdspec) if physical else None
    rhs = np.stack([interpolate(face_kvs, g, geo=bdgeo).ravel()
                    for g in (g0, g1)])

    kv_t = kvs[bdax]
    t_face = kv_t.support()[bdside]
    tab = bspline.active_deriv(kv_t, t_face, 1)     # (derivs, p+1) table
    C = tab[:2, :2] if bdside == 0 else tab[:2, -2:]
    coeffs = np.linalg.solve(C, rhs)

    N = tuple(kv.numdofs for kv in kvs)
    layers = (0, 1) if bdside == 0 else (-2, -1)
    dofs = np.concatenate([slice_indices(bdax, layer, N, ravel=True)
                           for layer in layers])
    return dofs, coeffs.ravel()


def combine_bcs(bcs):
    """Merge several (indices, values) pairs; on duplicate indices the
    first occurrence wins."""
    pairs = list(bcs)
    indices = np.concatenate([p[0] for p in pairs])
    values = np.concatenate([p[1] for p in pairs])
    if indices.shape != values.shape:
        raise ValueError('inconsistent BC sizes')
    unique, first_pos = np.unique(indices, return_index=True)
    return unique, values[first_pos]


class RestrictedLinearSystem:
    """A linear system with some dofs eliminated (fixed to given values).

    ``R_free``/``R_elim`` restrict to the free/eliminated dofs; the updated
    right-hand side is ``R_free (b - A R_elim^T values)``.  `elim_rows`
    supports Petrov-Galerkin systems where the eliminated equations differ
    from the eliminated dofs."""

    @staticmethod
    def _splitting(n, eliminated):
        """(R_keep, R_drop) 0/1 restriction matrices for a dof splitting."""
        drop = np.zeros(n, dtype=bool)
        drop[np.asarray(eliminated, dtype=np.int64)] = True
        eye = scipy.sparse.eye(n, format='csr')
        return eye[~drop], eye[drop]

    def __init__(self, A, b, bcs, elim_rows=None):
        indices, values = bcs
        if np.isscalar(b):
            b = np.broadcast_to(b, A.shape[0])
        if np.isscalar(values):
            values = np.broadcast_to(values, np.shape(indices)[0])
        # R_elim's rows are in ascending dof order, so the values are
        # sorted the same way; duplicate indices keep their first value
        indices = np.asarray(indices, dtype=np.int64)
        values = np.asarray(values)
        uniq, first = np.unique(indices, return_index=True)
        indices, values = uniq, values[first]
        self.values = values

        self.R_free, self.R_elim = self._splitting(A.shape[1], indices)
        if elim_rows is None:
            self.R_free_v, self.R_elim_v = self.R_free, self.R_elim
        else:
            self.R_free_v, self.R_elim_v = self._splitting(
                A.shape[0], sorted(elim_rows))

        self.A = self.restrict_matrix(A)
        self.b = self.restrict_rhs(b - A.dot(self.R_elim.T.dot(values)))

    def restrict(self, u):
        """Restrict a full-dof vector to the free dofs."""
        return self.R_free @ u

    def restrict_rhs(self, f):
        """Restrict a right-hand side to the non-eliminated rows."""
        return self.R_free_v @ f

    def restrict_matrix(self, B):
        """Restrict a full matrix to the free dofs (rows and columns)."""
        if not scipy.sparse.issparse(B):
            B = scipy.sparse.csr_matrix(B)
        return self.R_free_v @ B @ self.R_free.T

    def extend(self, u):
        """Zero-pad a free-dof vector to all dofs."""
        return self.R_free.T @ u

    def complete(self, u):
        """Extend a restricted solution with the eliminated dof values."""
        return self.extend(u) + self.R_elim.T @ self.values


def instantiate_assembler(problem, kvs, args, bfuns, boundary=None,
                          updatable=(), device=None):
    """Normalize `problem` (string / VForm / assembler class / instance)
    into an assembler object on `device`; a form on two spaces gets the
    pair ``kvs = (trial, test)`` (``pyiga_tpu/assemble.py:550-591``)."""
    if boundary:
        raise NotImplementedError('boundary integrals (boundary=) are not '
                                  'ported yet')
    if isinstance(problem, str):
        problem = vform_mod.parse_vf(problem, kvs, args=args, bfuns=bfuns,
                                     updatable=updatable)
    num_spaces = 1
    if isinstance(problem, vform_mod.VForm):
        num_spaces = problem.num_spaces()
        problem = compile_vform(problem)
    if isinstance(problem, type):
        wanted = list(problem.inputs()) + list(problem.parameters())
        missing = [inp for inp in wanted if inp not in args]
        if missing:
            raise ValueError("required input parameter '%s' missing"
                             % missing[0])
        used = {inp: args[inp] for inp in wanted}
        if num_spaces <= 1:
            return problem(kvs, device=device, **used)
        if num_spaces != 2:
            raise ValueError('no more than two spaces allowed')
        return problem(kvs[0], kvs2=kvs[1], device=device, **used)
    if hasattr(problem, 'assemble') or hasattr(problem, 'assemble_vector'):
        return problem
    raise TypeError("invalid type for 'problem': %s" % type(problem))


def assemble_entries(asm, symmetric=False, format='csr', layout='blocked',
                     mode=None):
    """Assemble all entries of the given assembler (a VForm assembler or
    a Gauss assembler of :mod:`pyiga_tpu_torch.assemblers`) and return the
    matrix (scipy sparse in `format`, or the compact
    :class:`~pyiga_tpu_torch.mlmatrix.MLMatrix` for ``format='mlb'``) or,
    for arity-1 assemblers, the vector.  `symmetric` is accepted for API
    compatibility.

    A vector-valued form comes in one of the reference's two layouts:
    'blocked' (component-major numbering; a functional's component axis
    leads) or 'packed' (components interleaved per dof, the only layout
    with ``format='mlb'``)."""
    if layout not in ('blocked', 'packed'):
        raise ValueError("layout must be 'blocked' or 'packed'")
    vec = getattr(getattr(asm, 'vf', None), 'vec', False)
    if asm.arity == 1:
        result = asm.assemble_vector()
        return np.moveaxis(result, -1, 0) if vec and layout == 'blocked' \
            else result
    if vec:
        return _combine_vector_blocks(asm, asm.assemble(mode=mode), format,
                                      layout)
    mlm = asm.assemble(mode=mode)
    if format == 'mlb':
        return mlm
    return mlm.asmatrix(format)


def assemble_entries_vec(asm, symmetric=False, format='csr',
                         layout='blocked'):
    """Assemble a vector-valued problem (the reference's API; here
    :func:`assemble_entries`, which dispatches on the form)."""
    return assemble_entries(asm, symmetric=symmetric, format=format,
                            layout=layout)


def _combine_vector_blocks(asm, blocks, format, layout):
    """Combine the ``(cu, cv) -> MLMatrix`` blocks of a vector form into
    one matrix: 'blocked' stacks them component-major (a pruned block is
    an explicit zero matrix), 'packed' joins a trailing dense ``(ncv,
    ncu)`` component level to the structure
    (``pyiga_tpu/assemble.py:463-506``)."""
    ncu, ncv = (n or 1 for n in asm.vf.num_components()[:2])
    if layout == 'blocked':
        if format == 'mlb':
            raise ValueError("format='mlb' requires layout='packed' for "
                             'vector-valued problems')
        zero = scipy.sparse.csr_matrix(asm.structure.shape)
        return scipy.sparse.bmat(
            [[blocks[(cu, cv)].asmatrix() if (cu, cv) in blocks else zero
              for cu in range(ncu)] for cv in range(ncv)], format=format)
    S = asm.structure.join(MLStructure.dense((ncv, ncu)))
    some = next(iter(blocks.values()))
    data = np.zeros(some.data.shape + (ncv * ncu,), dtype=some.data.dtype)
    for (cu, cv), blk in blocks.items():
        data[..., cv * ncu + cu] = blk.data
    X = S.make_mlmatrix(data=data)
    return X if format == 'mlb' else X.asmatrix(format)


def assemble(problem, kvs, args=None, bfuns=None, boundary=None,
             symmetric=False, format='csr', layout='blocked', mode=None,
             device=None, **kwargs):
    """Assemble a matrix or vector in a function space.

    `problem` may be a string (parsed by
    :func:`pyiga_tpu_torch.vform.parse_vf`), a
    :class:`~pyiga_tpu_torch.vform.VForm`, a compiled assembler class or an
    assembler instance; `kvs` is a TP spline space (tuple of
    KnotVectors).  Named inputs (the geometry ``geo``, coefficient
    functions, parameters) are passed in `args` or as keyword arguments.
    The assembly runs on `device` (default: the card).  `layout`
    ('blocked' or 'packed') orders the components of a vector-valued
    form; a form on two spaces takes ``kvs = (trial, test)``.  Structural
    zeros
    and symmetric term pairs are found by the JAX package's numeric
    probes (``VFormAssembler._prune_combos``)."""
    args = dict(args) if args is not None else dict()
    args.update(kwargs)
    asm = instantiate_assembler(problem, kvs, args, bfuns, boundary,
                                device=device)
    return assemble_entries(asm, symmetric=symmetric, format=format,
                            layout=layout, mode=mode)


def assemble_vf(vf, kvs, symmetric=False, format='csr', layout='blocked',
                args=None, device=None, **kwargs):
    """Assemble a :class:`~pyiga_tpu_torch.vform.VForm` into a matrix or
    vector."""
    args = dict(args) if args is not None else dict()
    args.update(kwargs)
    return assemble(vf, kvs, symmetric=symmetric, format=format,
                    layout=layout, args=args, device=device)


class Assembler:
    """Assembler wrapper with updatable inputs (``pyiga_tpu/assemble.py:
    662-694``): instantiate once on `device`, then call :meth:`assemble`,
    optionally with new values of the inputs named in `updatable`."""

    def __init__(self, problem, kvs, args=None, bfuns=None, boundary=None,
                 symmetric=False, updatable=(), device=None, **kwargs):
        args = dict(args) if args is not None else dict()
        args.update(kwargs)
        self.symmetric = bool(symmetric)
        self.updatable = tuple(updatable)
        self.asm = instantiate_assembler(problem, kvs, args, bfuns, boundary,
                                         self.updatable, device=device)
        if not all(u in self.asm.inputs() or u in self.asm.parameters()
                   for u in self.updatable):
            raise ValueError('Assembler received an updatable argument '
                             'which is not an assembler input')

    def update(self, **kwargs):
        """Update input fields declared as updatable."""
        if not all(name in self.updatable for name in kwargs):
            raise RuntimeError('update() received an argument which was '
                               'not specified as updatable')
        self.asm.update(**kwargs)

    def assemble(self, format='csr', layout='blocked', **upd_fields):
        """Assemble, updating the given fields first."""
        if upd_fields:
            self.update(**upd_fields)
        return assemble_entries(self.asm, symmetric=self.symmetric,
                                format=format, layout=layout)


def divdiv(kvs, geo=None, layout='blocked', format='csr', device=None):
    """The div-div operator of a vector-valued TP space
    (``pyiga_tpu/assemble.py:697-706``; the unit cube without a
    geometry)."""
    from . import geometry
    from .vform import divdiv_vf
    dim = 1 if isinstance(kvs, KnotVector) else len(kvs)
    if geo is None:
        geo = geometry.unit_cube(dim=dim)
    asm = compile_vform(divdiv_vf(dim))(kvs, geo=geo, device=device)
    return assemble_entries(asm, symmetric=True, layout=layout,
                            format=format)


################################################################################
# Fast low-rank (ACA) assembling
################################################################################

def _fast_asm(vf_factory, kvs, geo, tol, maxiter, skipcount, tolcount,
              verbose, device):
    from .lowrank import fast_assemble
    dim = len(kvs)
    asm = compile_vform(vf_factory(dim))(kvs, geo=geo, device=device)
    return fast_assemble(asm, kvs, tol=tol, maxiter=maxiter,
                         skipcount=skipcount, tolcount=tolcount,
                         verbose=verbose)


def mass_fast(kvs, geo=None, tol=1e-10, maxiter=100, skipcount=3,
              tolcount=3, verbose=2, device=None):
    """Assemble the mass matrix by low-rank ACA over its compact tensor
    (:func:`~pyiga_tpu_torch.lowrank.fast_assemble`; slices on `device`,
    default the card).  Without a geometry, the Kronecker :func:`mass`."""
    if geo is None:
        return mass(kvs)
    from .vform import mass_vf
    return _fast_asm(mass_vf, kvs, geo, tol, maxiter, skipcount, tolcount,
                     verbose, device)


def stiffness_fast(kvs, geo=None, tol=1e-10, maxiter=100, skipcount=3,
                   tolcount=3, verbose=2, device=None):
    """Assemble the stiffness matrix by low-rank ACA over its compact
    tensor (:func:`~pyiga_tpu_torch.lowrank.fast_assemble`; slices on
    `device`, default the card).  Without a geometry, the Kronecker
    :func:`stiffness`."""
    if geo is None:
        return stiffness(kvs)
    from .vform import stiffness_vf
    return _fast_asm(stiffness_vf, kvs, geo, tol, maxiter, skipcount,
                     tolcount, verbose, device)
