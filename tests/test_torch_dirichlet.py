"""The 3D Dirichlet Poisson path of the PyTorch port held against the JAX
package on the CPU: the host copies (``tensor.apply_tprod``,
``kronecker``, the operators, ``boundary`` / ``ComposedFunction`` /
pointwise evaluation, ``interpolate`` / ``project_L2``,
``inner_products`` / ``integrate``, ``compute_dirichlet_bcs``), the
matrix-free operator in float64 and float32, the whole slice at the
setup of ``tests/test_solvers.py::test_cg_ir`` (identical ``cg_ir``
counts), and the harmonic Dirichlet problem, whose discrete solution is
the interpolant of the data."""

import numpy as np
import pytest
import scipy.sparse
import scipy.sparse.linalg
import torch

import jax.numpy as jnp

import pyiga_tpu.bspline as jbspline
import pyiga_tpu.geometry as jgeometry
from pyiga_tpu import approx as japprox
from pyiga_tpu import assemble as jassemble
from pyiga_tpu import kronecker as jkronecker
from pyiga_tpu import operators as joperators
from pyiga_tpu import solvers as jsolvers
from pyiga_tpu import tensor as jtensor
from pyiga_tpu.assemblers import MassAssembler as JMassAssembler
from pyiga_tpu.assemblers import StiffnessAssembler as JStiffnessAssembler
from pyiga_tpu.ops import fastdiag as jfastdiag
from pyiga_tpu.ops import matfree as jmatfree

from pyiga_tpu_torch import (approx, assemble, bspline, geometry, kronecker,
                             operators, solvers, tensor)
from pyiga_tpu_torch.assemblers import MassAssembler, StiffnessAssembler
from pyiga_tpu_torch.hierarchical import HSpace
from pyiga_tpu_torch.ops import fastdiag
from pyiga_tpu_torch.ops.matfree import MatrixFreeOperator

torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def harmonic(x, y, z):
    return x + 2 * y + 3 * z


def _g2(x, y):
    return np.sin(x) + y * y


def _ops(rng):
    """Per-axis operators of every kind apply_tprod takes."""
    dense = rng.rand(4, 5)
    sparse = scipy.sparse.random(3, 6, 0.5, format='csr', random_state=rng)
    linop = scipy.sparse.linalg.aslinearoperator(rng.rand(2, 7))
    return [dense, sparse, None, linop]


def test_apply_tprod_and_helpers():
    rng = np.random.RandomState(0)
    X = rng.rand(5, 6, 3, 7)
    ops = _ops(rng)
    got, ref = tensor.apply_tprod(ops, X), jtensor.apply_tprod(ops, X)
    assert got.shape == (4, 3, 3, 2) and _rel(got, ref) < 1e-14
    for k in range(4):
        assert np.array_equal(tensor.matricize(X, k),
                              jtensor.matricize(X, k))
        M = tensor.matricize(X, k)
        assert np.array_equal(tensor._fold(M, k, X.shape), X)
    assert np.array_equal(tensor.modek_tprod(ops[0], 0, X),
                          jtensor.modek_tprod(ops[0], 0, X))
    assert tensor.fro_norm(X) == jtensor.fro_norm(X)
    assert np.array_equal(tensor.asarray(X), jtensor.asarray(X))


@pytest.mark.parametrize('kind', ['dense', 'sparse'])
def test_apply_kronecker(kind):
    rng = np.random.RandomState(1)
    mats = [rng.rand(3, 4), rng.rand(5, 5), rng.rand(2, 3)]
    if kind == 'sparse':
        mats = [scipy.sparse.csr_matrix(A) for A in mats]
    K = scipy.sparse.kron(scipy.sparse.kron(mats[0], mats[1]),
                          mats[2]).toarray()
    for x in (rng.rand(60), rng.rand(60, 3)):
        got = kronecker.apply_kronecker(mats, x)
        assert _rel(got, jkronecker.apply_kronecker(mats, x)) < 1e-14
        assert _rel(got, K @ x) < 1e-14


def test_operators():
    rng = np.random.RandomState(2)
    x, X = rng.rand(12), rng.rand(12, 2)
    d = rng.rand(12)
    pairs = [(operators.NullOperator((5, 12)),
              joperators.NullOperator((5, 12))),
             (operators.IdentityOperator(12),
              joperators.IdentityOperator(12)),
             (operators.DiagonalOperator(d), joperators.DiagonalOperator(d))]
    A, B = rng.rand(3, 3) + 3 * np.eye(3), rng.rand(4, 4) + 4 * np.eye(4)
    for fa, fb in ((A, B), (scipy.sparse.csr_matrix(A),
                            scipy.sparse.csr_matrix(B))):
        pairs.append((operators.KroneckerOperator(fa, fb),
                      joperators.KroneckerOperator(fa, fb)))
    for op, jop in pairs:
        assert op.shape == jop.shape
        for v in (x, X):
            ref = jop @ v
            assert np.abs(op @ v - ref).max() <= 1e-14 * max(
                np.abs(ref).max(), 1.0)
            assert np.abs(op.T @ (op @ v)
                          - jop.T @ ref).max() <= 1e-13 * max(
                np.abs(jop.T @ ref).max(), 1.0)
    S = operators.make_kronecker_solver(A, B)
    jS = joperators.make_kronecker_solver(A, B)
    assert _rel(S @ x, jS @ x) < 1e-14
    assert _rel(np.kron(A, B) @ (S @ x), x) < 1e-13
    with pytest.raises(ValueError):
        operators.DiagonalOperator(np.ones((2, 2)))


def _composed(pkg):
    """A NURBS quarter annulus composed with a bilinear B-spline map of the
    unit square into itself (non-symmetric Jacobians on both)."""
    kv1 = pkg[0].make_knots(1, 0.0, 1.0, 1)
    inner = pkg[1].BSplineFunc((kv1, kv1), np.array(
        [[[0.0, 0.0], [1.0, 0.1]], [[0.2, 1.0], [0.9, 0.8]]]))
    return pkg[1].ComposedFunction(pkg[1].quarter_annulus(), inner)


def test_geometry_boundary_and_composition():
    T, J = (bspline, geometry), (jbspline, jgeometry)
    grid = [np.linspace(0, 1, 5), np.linspace(0, 1, 4)]
    geo, jgeo = _composed(T), _composed(J)
    assert (geo.sdim, geo.dim) == (jgeo.sdim, jgeo.dim)
    assert _rel(geo.grid_eval(grid), jgeo.grid_eval(grid)) < 1e-14
    assert _rel(geo.grid_jacobian(grid), jgeo.grid_jacobian(grid)) < 1e-14
    assert _rel(geo(0.3, 0.6), jgeo(0.3, 0.6)) < 1e-14
    for spec in ('left', 'right', 'top', 'bottom'):
        b, jb = geo.boundary(spec), jgeo.boundary(spec)
        g1 = [np.linspace(0, 1, 6)]
        assert _rel(b.grid_eval(g1), jb.grid_eval(g1)) < 1e-14
        assert _rel(b.grid_jacobian(g1), jb.grid_jacobian(g1)) < 1e-14
    # spline boundaries by coefficient slicing, a support override through
    # _BoundaryFunction; pointwise evaluation of both spline classes
    g3 = [np.linspace(0, 1, 3), np.linspace(0, 1, 4), np.linspace(0, 1, 5)]
    for name in ('twisted_box', 'quarter_annulus'):
        f, jf = getattr(geometry, name)(), getattr(jgeometry, name)()
        grd = g3[:f.sdim]
        for ax in range(f.sdim):
            for side in (0, 1):
                b, jb = f.boundary((ax, side)), jf.boundary((ax, side))
                assert type(b).__name__ == type(jb).__name__
                assert _rel(b.grid_eval(grd[1:]), jb.grid_eval(grd[1:])) \
                    < 1e-14
        pts = [np.random.RandomState(3).rand(2, 3) for _ in range(f.sdim)]
        assert _rel(f.pointwise_eval(pts), jf.pointwise_eval(pts)) < 1e-14
        assert _rel(f.pointwise_jacobian(pts),
                    jf.pointwise_jacobian(pts)) < 1e-14
        assert _rel(f.grid_jacobian(grd), jf.grid_jacobian(grd)) < 1e-14
    f, jf = geometry.twisted_box(), jgeometry.twisted_box()
    f.support = jf.support = ((0.0, 1.0), (0.0, 0.5), (0.0, 1.0))
    b, jb = f.boundary('top'), jf.boundary('top')
    assert type(b).__name__ == '_BoundaryFunction'
    assert _rel(b.grid_eval(g3[1:]), jb.grid_eval(g3[1:])) < 1e-14
    assert _rel(b.grid_jacobian(g3[1:]), jb.grid_jacobian(g3[1:])) < 1e-14
    assert _rel(b(0.2, 0.7), jb(0.2, 0.7)) < 1e-14
    ident = geometry.identity([(0.0, 2.0), bspline.make_knots(2, 1.0, 3.0, 4)])
    jident = jgeometry.identity([(0.0, 2.0),
                                 jbspline.make_knots(2, 1.0, 3.0, 4)])
    assert ident.support == jident.support
    assert np.array_equal(ident.coeffs, jident.coeffs)


@pytest.mark.parametrize('geo_name', [None, 'quarter_annulus',
                                      'bspline_quarter_annulus'])
def test_interpolate_project_inner_products_integrate(geo_name):
    kvs = (bspline.make_knots(3, 0.0, 1.0, 5),
           bspline.make_knots(2, 0.0, 1.0, 4))
    jkvs = (jbspline.make_knots(3, 0.0, 1.0, 5),
            jbspline.make_knots(2, 0.0, 1.0, 4))
    geo = getattr(geometry, geo_name)() if geo_name else None
    jgeo = getattr(jgeometry, geo_name)() if geo_name else None
    phys = geo is not None
    assert _rel(approx.interpolate(kvs, _g2, geo=geo),
                japprox.interpolate(jkvs, _g2, geo=jgeo)) < 1e-13
    got = approx.project_L2(kvs, _g2, f_physical=phys, geo=geo,
                            device='cpu')
    assert _rel(got, japprox.project_L2(jkvs, _g2, f_physical=phys,
                                        geo=jgeo)) < 1e-13
    assert _rel(assemble.inner_products(kvs, _g2, f_physical=phys, geo=geo),
                jassemble.inner_products(jkvs, _g2, f_physical=phys,
                                         geo=jgeo)) < 1e-13
    vol = assemble.integrate(kvs, _g2, f_physical=phys, geo=geo)
    assert abs(vol - jassemble.integrate(jkvs, _g2, f_physical=phys,
                                         geo=jgeo)) <= 1e-13 * abs(vol)
    # onto a hierarchical space (one level): the hierarchical assembly of
    # its mass matrix and load vector
    from pyiga_tpu.hierarchical import HSpace as JHSpace
    assert _rel(approx.project_L2(HSpace(kvs), _g2, device='cpu'),
                japprox.project_L2(JHSpace(jkvs), _g2)) < 1e-13


@pytest.mark.parametrize('name,p,n', [('twisted_box', 3, 4),
                                      ('quarter_annulus', 2, 6)])
def test_compute_dirichlet_bcs(name, p, n):
    geo, jgeo = getattr(geometry, name)(), getattr(jgeometry, name)()
    kvs = geo.sdim * (bspline.make_knots(p, 0.0, 1.0, n),)
    jkvs = geo.sdim * (jbspline.make_knots(p, 0.0, 1.0, n),)
    g = harmonic if geo.sdim == 3 else _g2
    for conds in (('all', g), [('left', 2.5), ((0, 1), g)]):
        idx, vals = assemble.compute_dirichlet_bcs(kvs, geo, conds)
        jidx, jvals = jassemble.compute_dirichlet_bcs(jkvs, jgeo, conds)
        assert np.array_equal(idx, jidx)
        assert np.abs(vals - jvals).max() <= 1e-13 * np.abs(jvals).max()
    # NaN data drop dofs; vector data number blocked
    nan_g = lambda *x: np.where(x[0] > 0.5, np.nan, 1.0)    # noqa: E731
    vec_g = lambda *x: (x[0], 2.0 * x[-1])                  # noqa: E731
    for fn in (nan_g, vec_g):
        a = assemble.compute_dirichlet_bc(kvs, geo, 'bottom', fn)
        b = jassemble.compute_dirichlet_bc(jkvs, jgeo, 'bottom', fn)
        assert np.array_equal(a[0], b[0]) and np.allclose(a[1], b[1],
                                                          rtol=1e-13)
    one = lambda *x: 1.0                                    # noqa: E731
    a = assemble.compute_initial_condition_01(kvs, geo, 'bottom', g, one)
    b = jassemble.compute_initial_condition_01(jkvs, jgeo, 'bottom', g, one)
    assert np.array_equal(a[0], b[0]) and _rel(a[1], b[1]) < 1e-13


def _vform_pair(dtype):
    from pyiga_tpu import compile as jcompile
    from pyiga_tpu import vform as jvform
    from pyiga_tpu_torch import compile as tcompile
    from pyiga_tpu_torch import vform
    form = '(inner(grad(u), grad(v)) + dot(b, grad(u)) * v + u * v) * dx'
    b = np.array([3.0, -2.0])
    kvs = 2 * (bspline.make_knots(2, 0.0, 1.0, 6),)
    jkvs = 2 * (jbspline.make_knots(2, 0.0, 1.0, 6),)
    asm = tcompile.compile_vform(vform.parse_vf(form, kvs, args={'b': b}))(
        kvs, geo=geometry.quarter_annulus(), b=b, device='cpu')
    jasm = jcompile.compile_vform(jvform.parse_vf(form, jkvs, args={'b': b}))(
        jkvs, geo=jgeometry.quarter_annulus(), b=b)
    return asm, jasm


@pytest.mark.parametrize('dtype', ['float64', 'float32'])
@pytest.mark.parametrize('kind', ['stiffness', 'mass', 'vform'])
def test_matrix_free_operator_matches_jax(kind, dtype):
    """Matvec of the full and the restricted operator (box and general
    free sets) against JAX's ``MatrixFreeOperator``: f64 1e-13, f32
    1e-5."""
    tdt, tol = ((torch.float64, 1e-13) if dtype == 'float64'
                else (torch.float32, 1e-5))
    if kind == 'vform':
        asm, jasm = _vform_pair(dtype)
        kvs = asm.kvs0
    else:
        kvs = 3 * (bspline.make_knots(2, 0.0, 1.0, 4),)
        jkvs = 3 * (jbspline.make_knots(2, 0.0, 1.0, 4),)
        cls, jcls = ((StiffnessAssembler, JStiffnessAssembler)
                     if kind == 'stiffness'
                     else (MassAssembler, JMassAssembler))
        asm = cls(kvs, geometry.twisted_box(), device='cpu')
        jasm = jcls(jkvs, jgeometry.twisted_box())
    n = int(np.prod([kv.numdofs for kv in kvs]))
    rng = np.random.RandomState(4)
    box = fastdiag.interior_dofs(kvs)
    for free in (None, box, np.sort(rng.permutation(n)[:n // 2])):
        op = MatrixFreeOperator(asm, free_dofs=free, dtype=tdt)
        jop = jmatfree.MatrixFreeOperator(jasm, free_dofs=free,
                                          dtype=np.dtype(dtype))
        x = rng.rand(op.shape[1])
        y = op(torch.as_tensor(x, dtype=tdt))
        ref = np.asarray(jop(jnp.asarray(x, dtype=dtype)))
        assert y.dtype == tdt and op.shape == jop.shape
        assert _rel(y.numpy(), ref) < tol
    full = MatrixFreeOperator(asm)
    A = asm.assemble().asmatrix()
    x = rng.rand(n)
    assert _rel(full(torch.as_tensor(x)).numpy(), A @ x) < 1e-13


def test_cg_ir_slice_matches_jax():
    """The setup of ``tests/test_solvers.py::test_cg_ir`` (3D p=2 n=6 on
    the twisted box, matrix-free f64/f32 operators, unweighted fastdiag in
    f32): identical outer and inner counts, solutions 1e-10."""
    kvs = 3 * (bspline.make_knots(2, 0.0, 1.0, 6),)
    jkvs = 3 * (jbspline.make_knots(2, 0.0, 1.0, 6),)
    asm = StiffnessAssembler(kvs, geometry.twisted_box(), device='cpu')
    jasm = JStiffnessAssembler(jkvs, jgeometry.twisted_box())
    free = fastdiag.interior_dofs(kvs)
    b = np.random.RandomState(5).rand(len(free))
    x, info = solvers.cg_ir(
        MatrixFreeOperator(asm, free_dofs=free, dtype=torch.float64),
        MatrixFreeOperator(asm, free_dofs=free, dtype=torch.float32),
        torch.as_tensor(b), tol=1e-10,
        precond_lo=fastdiag.fastdiag_precond(kvs, dirichlet=True,
                                             dtype=torch.float32,
                                             device='cpu'))
    jx, jinfo = jsolvers.cg_ir(
        jmatfree.MatrixFreeOperator(jasm, free_dofs=free, dtype=np.float64),
        jmatfree.MatrixFreeOperator(jasm, free_dofs=free, dtype=np.float32),
        jnp.asarray(b), tol=1e-10,
        precond_lo=jfastdiag.fastdiag_precond(jkvs, dirichlet=True,
                                              dtype=np.float32))
    assert info['outer'] == jinfo['outer']
    assert info['inner_iters'] == jinfo['inner_iters']
    assert info['residual'] < 1e-10
    assert _rel(x.numpy(), np.asarray(jx)) < 1e-10


class _SquaredError:
    """``(u_h - g)^2`` on a tensor grid, `g` taken at the mapped points."""

    def __init__(self, uh, geo, g):
        self.uh, self.geo, self.g = uh, geo, g

    def grid_eval(self, grid):
        X = self.geo.grid_eval(grid)
        ref = self.g(*np.moveaxis(X, -1, 0))
        return (ref if self.uh is None else self.uh.grid_eval(grid) - ref) ** 2


def test_harmonic_dirichlet_problem():
    """The path of ``examples/poisson_3d.py`` with the harmonic data
    ``g = x + 2y + 3z`` on the twisted box (a B-spline map of degrees
    (1, 3, 1), so ``g o geo`` lies in the p=3 space): the lifted
    right-hand side through a full ``MatrixFreeOperator``, ``cg_ir`` to
    1e-10, the completed solution's relative L2 error <= 1e-8."""
    kvs = 3 * (bspline.make_knots(3, 0.0, 1.0, 5),)
    geo = geometry.twisted_box()
    asm = StiffnessAssembler(kvs, geo, device='cpu')
    bd, vals = assemble.compute_dirichlet_bcs(kvs, geo, ('all', harmonic))
    n = int(np.prod([kv.numdofs for kv in kvs]))
    free = np.setdiff1d(np.arange(n), bd)
    assert np.array_equal(free, fastdiag.interior_dofs(kvs))
    ext = torch.zeros(n, dtype=torch.float64)
    ext[torch.as_tensor(bd)] = torch.as_tensor(vals)
    b = -MatrixFreeOperator(asm)(ext)[torch.as_tensor(free)]
    x, info = solvers.cg_ir(
        MatrixFreeOperator(asm, free_dofs=free, dtype=torch.float64),
        MatrixFreeOperator(asm, free_dofs=free, dtype=torch.float32), b,
        tol=1e-10, precond_lo=fastdiag.fastdiag_precond_weighted(
            asm, dirichlet=True, dtype=torch.float32))
    assert info['residual'] <= 1e-10
    u = np.zeros(n)
    u[free], u[bd] = x.numpy(), vals
    uh = geometry.BSplineFunc(kvs, u.reshape([kv.numdofs for kv in kvs]))
    err = assemble.integrate(kvs, _SquaredError(uh, geo, harmonic), geo=geo)
    norm = assemble.integrate(kvs, _SquaredError(None, geo, harmonic),
                              geo=geo)
    assert np.sqrt(err / norm) <= 1e-8
    # the same data by the JAX package's assembled restricted system
    A = assemble.stiffness(kvs, geo, device='cpu')
    rls = assemble.RestrictedLinearSystem(A, 0.0, (bd, vals))
    assert _rel(rls.b, b.numpy()) < 1e-12
