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
spaces, boundary integrals (``boundary=``), the assembly over a
hierarchical space (``kvs`` an :class:`~pyiga_tpu_torch.hierarchical.
HSpace`), and :class:`Assembler`, which reassembles after updating its
inputs.  :class:`Multipatch` joins tensor-product patches into one
conforming space (interfaces given or found by
:func:`detect_interfaces`) and assembles its global system patch by
patch.

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
"""

import itertools

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


def _Jac_to_boundary_matrix(bdspec, dim):
    """dim x (dim-1) matrix restricting a volumetric Jacobian to the
    boundary `bdspec`, with signs chosen so that the computed normal points
    outward for positively oriented patches
    (``pyiga_tpu/assemble.py:536-547``)."""
    ax, side = bdspec
    ax = dim - 1 - ax       # vform coordinate axes are in XYZ order
    I = np.eye(dim)
    I[:, 0::2] *= -1
    B = np.hstack((I[:, :ax], I[:, ax + 1:]))
    if side != 0:
        B[:, 0] *= -1
    return B


def instantiate_assembler(problem, kvs, args, bfuns, boundary=None,
                          updatable=(), device=None):
    """Normalize `problem` (string / VForm / assembler class / instance)
    into an assembler object on `device`; a form on two spaces gets the
    pair ``kvs = (trial, test)``; `boundary` (a bdspec) makes it a
    boundary integral over that face, with its ``Jac_to_boundary``
    (``pyiga_tpu/assemble.py:550-591``)."""
    if isinstance(problem, str):
        problem = vform_mod.parse_vf(problem, kvs, args=args, bfuns=bfuns,
                                     boundary=bool(boundary),
                                     updatable=updatable)
    num_spaces = 1
    if isinstance(problem, vform_mod.VForm):
        num_spaces = problem.num_spaces()
        problem = compile_vform(problem)
    if isinstance(problem, type):
        used = {}
        if boundary:
            bdspec = bspline._parse_bdspec(boundary, len(kvs))
            used['boundary'] = bdspec
            args = dict(args)
            args['Jac_to_boundary'] = _Jac_to_boundary_matrix(bdspec,
                                                              len(kvs))
        wanted = list(problem.inputs()) + list(problem.parameters())
        missing = [inp for inp in wanted if inp not in args]
        if missing:
            raise ValueError("required input parameter '%s' missing"
                             % missing[0])
        used.update((inp, args[inp]) for inp in wanted)
        if 'Jac_to_boundary' in args:
            used['Jac_to_boundary'] = args['Jac_to_boundary']
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
    KnotVectors) or an :class:`~pyiga_tpu_torch.hierarchical.HSpace`.
    Named inputs (the geometry ``geo``, coefficient functions,
    parameters) are passed in `args` or as keyword arguments.  The
    assembly runs on `device` (default: the card).  `layout` ('blocked'
    or 'packed') orders the components of a vector-valued form; a form
    on two spaces takes ``kvs = (trial, test)``; `boundary` (a bdspec
    such as ``'left'`` or ``(axis, side)``) integrates a ``ds`` form over
    that face of the space.  Structural zeros and symmetric term pairs
    are found by the JAX package's numeric probes
    (``VFormAssembler._prune_combos``)."""
    args = dict(args) if args is not None else dict()
    args.update(kwargs)
    from .hierarchical import HSpace
    if isinstance(kvs, HSpace):
        return _assemble_hspace(problem, kvs, args=args, bfuns=bfuns,
                                symmetric=symmetric, format=format,
                                device=device)
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


def _assemble_hspace(problem, hs, args, bfuns=None, symmetric=False,
                     format='csr', device=None):
    """Assemble over a hierarchical spline space: a bilinear form's matrix
    or a functional's vector in the space's canonical numbering, through
    :class:`~pyiga_tpu_torch._hdiscr.HDiscretization`'s per-level
    assemblies on `device` (``pyiga_tpu/assemble.py:646-659``)."""
    from ._hdiscr import HDiscretization
    if isinstance(problem, str):
        problem = vform_mod.parse_vf(problem, hs.knotvectors(0), args=args,
                                     bfuns=bfuns)
    if problem.arity == 2:
        hdiscr = HDiscretization(hs, problem, args, device=device)
        return hdiscr.assemble_matrix(symmetric=symmetric).asformat(format)
    hdiscr = HDiscretization(hs, None, args, device=device)
    return hdiscr.assemble_functional(problem)


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


################################################################################
# Multipatch (conforming patches with shared-dof union numbering)
################################################################################

class _UnionFind:
    """Minimal disjoint-set structure (path halving + size union)."""

    def __init__(self, n):
        self.parent = list(range(n))
        self.size = n * [1]

    def find(self, i):
        p = self.parent
        while p[i] != i:
            p[i] = p[p[i]]
            i = p[i]
        return i

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        if self.size[ra] < self.size[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        self.size[ra] += self.size[rb]


def _patch_boxes(patches):
    """(lo, hi) corner arrays of every patch's bounding box."""
    boxes = [np.asarray(geo.bounding_box()) for (_, geo) in patches]
    lo = np.stack([b[:, 0] for b in boxes])
    hi = np.stack([b[:, 1] for b in boxes])
    return lo, hi


def _check_geo_match(G1, G2, grid=4):
    """Check whether two boundary geometries coincide under any combination
    of per-axis coordinate flips; returns (match, flip)."""
    if G1.sdim != G2.sdim or G1.dim != G2.dim:
        return False, None
    if not np.allclose(G1.support, G2.support):
        return False, None
    axes = [np.linspace(lo, hi, grid) for (lo, hi) in G1.support]
    target = G1.grid_eval(axes)
    for flip in itertools.product((False, True), repeat=G2.sdim):
        probe = [ax[::-1].copy() if f else ax for ax, f in zip(axes, flip)]
        if np.allclose(target, G2.grid_eval(probe)):
            return True, flip
    return False, None


def _find_matching_boundaries(G1, G2):
    """Every pair of faces of `G1` and `G2` that coincide, with the flips
    of the second: ``[(bd1, bd2, flip), ...]``."""
    if G1.sdim != G2.sdim or G1.dim != G2.dim:
        raise ValueError('patches of different dimensions')
    faces = list(itertools.product(range(G1.sdim), (0, 1)))
    matches = []
    for bd1 in faces:
        B1 = G1.boundary(bd1)
        for bd2 in faces:
            ok, flip = _check_geo_match(B1, G2.boundary(bd2))
            if ok:
                matches.append((bd1, bd2, flip))
    return matches


def detect_interfaces(patches):
    """Detect matching interfaces between the patches ``(kvs, geo)``.
    Returns ``(connected, interfaces)`` where each interface is suitable
    for :meth:`Multipatch.join_boundaries`; patches whose bounding boxes
    are apart are not compared, and the patch graph's connectivity comes
    from a union-find (``pyiga_tpu/assemble.py:812-840``)."""
    interfaces = []
    lo, hi = _patch_boxes(patches)
    diam = np.linalg.norm(hi - lo, axis=1)
    uf = _UnionFind(len(patches))

    for p1 in range(len(patches)):
        for p2 in range(p1 + 1, len(patches)):
            gap = np.maximum(0.0, np.maximum(lo[p1] - hi[p2],
                                             lo[p2] - hi[p1]))
            if np.linalg.norm(gap) >= 1e-10 * max(diam[p1], diam[p2]):
                continue
            matches = _find_matching_boundaries(patches[p1][1],
                                                patches[p2][1])
            for bd1, bd2, flip in matches:
                interfaces.append((p1, bd1, p2, bd2, flip))
            if matches:
                uf.union(p1, p2)

    roots = {uf.find(p) for p in range(len(patches))}
    return len(roots) <= 1, interfaces


class Multipatch:
    """A conforming multipatch discretization: per-patch TP spaces with
    shared dofs identified along matching interfaces
    (``pyiga_tpu/assemble.py:843-990``).

    The global numbering puts the non-shared (interior) dofs of each patch
    first (patch by patch), followed by the shared dofs in order of first
    appearance.  With ``automatch=True`` the interfaces are found by
    :func:`detect_interfaces` and the numbering is final at once;
    otherwise join boundaries or dofs and call :meth:`finalize`."""

    def __init__(self, patches, automatch=False):
        self.patches = patches
        self.N = [bspline.numdofs(kvs) for (kvs, _) in self.patches]
        self.N_ofs = np.concatenate(([0], np.cumsum(self.N)))
        self.shared_per_patch = [dict() for _ in range(len(self.patches))]
        self.shared_dofs = []
        self._pairs = []        # recorded (p1, i1, p2, i2) identifications

        if automatch:
            connected, interfaces = detect_interfaces(self.patches)
            if not connected:
                print('WARNING: patch graph is not connected - '
                      'interface detection may have failed')
            for intf in interfaces:
                self.join_boundaries(*intf)
            self.finalize()

    @property
    def numpatches(self):
        return len(self.patches)

    @property
    def numdofs(self):
        """Global dof count (shared dofs counted once); requires
        :meth:`finalize`."""
        return self.M_ofs[-1] + len(self.shared_dofs)

    def join_dofs(self, p1, I1, p2, I2):
        """Identify the dofs `I1` of patch `p1` with `I2` of patch `p2`
        (effective after :meth:`finalize`)."""
        if len(I1) != len(I2):
            raise ValueError('dof arrays must have the same length')
        if p1 == p2:
            raise ValueError('patches must be different')
        self._pairs.extend(
            (p1, int(i1), p2, int(i2)) for i1, i2 in zip(I1, I2))

    def join_boundaries(self, p1, bdspec1, p2, bdspec2, flip=None):
        """Identify the dofs along two matching patch boundaries (with
        optional per-axis flips of the second boundary)."""
        dofs1 = boundary_dofs(self.patches[p1][0], bdspec1, ravel=True)
        dofs2 = boundary_dofs(self.patches[p2][0], bdspec2, ravel=True,
                              flip=flip)
        self.join_dofs(p1, dofs1, p2, dofs2)

    def finalize(self):
        """Resolve the recorded identifications into shared-dof groups
        (union-find over (patch, dof) pairs, merging chains across any
        number of patches) and set up the global numbering: interior dofs
        patch by patch, then the shared groups in the order in which each
        first appears among the recorded pairs."""
        node_id = {}

        def node(p, i):
            return node_id.setdefault((p, i), len(node_id))

        links = [(node(p1, i1), node(p2, i2))
                 for (p1, i1, p2, i2) in self._pairs]
        uf = _UnionFind(len(node_id))
        for a, b in links:
            uf.union(a, b)

        group_of_root = {}
        self.shared_dofs = []
        for (p, i), n in node_id.items():   # insertion = appearance order
            root = uf.find(n)
            if root not in group_of_root:
                group_of_root[root] = len(self.shared_dofs)
                self.shared_dofs.append(set())
        self.shared_per_patch = [dict() for _ in range(self.numpatches)]
        for (p, i), n in node_id.items():
            g = group_of_root[uf.find(n)]
            self.shared_dofs[g].add((p, i))
            self.shared_per_patch[p][i] = g

        num_shared = [len(spp) for spp in self.shared_per_patch]
        self.M = [n - s for n, s in zip(self.N, num_shared)]
        self.M_ofs = np.concatenate(([0], np.cumsum(self.M)))

    def patch_to_global_idx(self, p):
        """Array mapping local TP indices of patch `p` to global indices."""
        tpdofs = np.arange(self.N[p])
        sdofs = np.array(sorted(self.shared_per_patch[p].items()))
        if len(sdofs):
            local = np.setdiff1d(tpdofs, sdofs[:, 0], assume_unique=True)
        else:
            local = tpdofs.copy()
        m_ofs = self.M_ofs[p]
        tpdofs[local] = np.arange(m_ofs, m_ofs + local.shape[0])
        if len(sdofs):
            tpdofs[sdofs[:, 0]] = self.M_ofs[-1] + sdofs[:, 1]
        return tpdofs

    def patch_to_global(self, p, j_global=False):
        """Sparse 0/1 matrix mapping patch-`p` dofs to global dofs."""
        shape = (self.numdofs,
                 self.N_ofs[-1] if j_global else self.N[p])
        n_ofs = self.N_ofs[p] if j_global else 0
        I = self.patch_to_global_idx(p)
        J = np.arange(n_ofs, n_ofs + self.N[p])
        return scipy.sparse.coo_matrix(
            (np.ones(len(I)), (I, J)), shape=shape).tocsr()

    def global_to_patch(self, p):
        """Transpose (and left-inverse) of :meth:`patch_to_global`."""
        return self.patch_to_global(p).T

    def assemble_system(self, problem, rhs, args=None, bfuns=None,
                        symmetric=False, format='csr', layout='blocked',
                        device=None, **kwargs):
        """Assemble the global system matrix and right-hand side by
        accumulating the per-patch contributions ``X A_p X^T`` and ``X
        b_p``, each patch assembled on `device` (default: the card) and
        scattered on the host."""
        n = self.numdofs
        A = scipy.sparse.csr_matrix((n, n)).asformat(format)
        b = np.zeros(n)
        args = dict(args) if args is not None else dict()
        for p in range(self.numpatches):
            X = self.patch_to_global(p)
            kvs, geo = self.patches[p]
            args.update(geo=geo)
            A_p = assemble(problem, kvs, args=args, bfuns=bfuns,
                           symmetric=symmetric, format=format, layout=layout,
                           device=device, **kwargs)
            A = A + X @ A_p @ X.T
            b_p = assemble(rhs, kvs, args=args, bfuns=bfuns,
                           symmetric=symmetric, format=format, layout=layout,
                           device=device, **kwargs).ravel()
            b += X @ b_p
        return A, b

    def compute_dirichlet_bcs(self, bdconds):
        """Dirichlet (indices, values) over the global numbering;
        `bdconds` contains (patch, bdspec, dir_func) triples."""
        bcs = []
        p2g = dict()
        for p, bdspec, g in bdconds:
            kvs, geo = self.patches[p]
            bc = compute_dirichlet_bc(kvs, geo, bdspec, g)
            if p not in p2g:
                p2g[p] = self.patch_to_global_idx(p)
            bcs.append((p2g[p][bc[0]], bc[1]))
        return combine_bcs(bcs)
