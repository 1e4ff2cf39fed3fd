"""Hierarchical spaces and their on-demand assembly in the PyTorch port,
held against the JAX package on the CPU: the host copies (knot-vector
helpers, Kronecker products, geometry factories, boundary index sets,
``RestrictedLinearSystem``, ``HSpace``), the ``bbox`` assembler and
``update()``, and ``HDiscretization``.  Integers must be identical,
matrices agree to 1e-14 (host copies) or 1e-13 relative (assembly)."""

import numpy as np
import pytest
import scipy.sparse
import torch

import pyiga_tpu.assemble as jassemble
import pyiga_tpu.bspline as jbspline
import pyiga_tpu.compile as jcompile
import pyiga_tpu.geometry as jgeometry
import pyiga_tpu.hierarchical as jhier
import pyiga_tpu.utils as jutils
import pyiga_tpu.vform as jvform

from pyiga_tpu_torch import (assemble, bspline, compile as tcompile,
                             geometry, hierarchical, utils, vform)

torch.set_num_threads(1)

STRATEGIES = ('new', 'trunc', 'func_supp', 'cell_supp')
BDSPECS = [(0, 0), (0, 1), (1, 0), (1, 1)]


def example_hspace(hmod, bmod, p=3, n0=6, disparity=np.inf, truncate=False,
                   num_levels=3):
    """``tests/test_hierarchical.create_example_hspace`` (2D) for either
    package (`hmod`, `bmod`: its hierarchical and bspline modules)."""
    hs = hmod.HSpace(2 * (bmod.make_knots(p, 0.0, 1.0, n0),),
                     truncate=truncate, disparity=disparity, bdspecs=BDSPECS)
    for lv in range(num_levels):
        hs.refine_region(lv, lambda *X: min(X) > 1 - 0.5 ** (lv + 1))
    return hs


def both_hspaces(**kw):
    return (example_hspace(hierarchical, bspline, **kw),
            example_hspace(jhier, jbspline, **kw))


def assert_sparse_close(A, B, tol):
    A, B = scipy.sparse.csr_matrix(A), scipy.sparse.csr_matrix(B)
    assert A.shape == B.shape
    scale = max(abs(B).max(), 1e-300)
    assert abs(A - B).max() <= tol * scale


def test_bspline_helpers_match_jax():
    for p, n in ((1, 3), (2, 5), (3, 6)):
        kv, jkv = bspline.make_knots(p, 0.0, 1.0, n), \
            jbspline.make_knots(p, 0.0, 1.0, n)
        assert np.array_equal(kv.mesh_span_indices(), jkv.mesh_span_indices())
        assert np.array_equal(kv.greville(), jkv.greville())
        assert np.array_equal(kv.refine().kv, jkv.refine().kv)
        assert np.array_equal(kv.refine([0.1, 0.35]).kv,
                              jkv.refine([0.1, 0.35]).kv)
        assert hash(kv) == hash(bspline.make_knots(p, 0.0, 1.0, n))
        nodes = np.random.RandomState(p).rand(11)
        assert_sparse_close(bspline.collocation(kv, nodes),
                            jbspline.collocation(jkv, nodes), 0.0)
        assert_sparse_close(bspline.prolongation(kv, kv.refine()),
                            jbspline.prolongation(jkv, jkv.refine()), 0.0)
    for spec in ('left', 'right', 'bottom', 'top', 'front', 'back', (1, 0)):
        assert bspline._parse_bdspec(spec, 3) == \
            jbspline._parse_bdspec(spec, 3)
    with pytest.raises(ValueError):
        bspline._parse_bdspec((3, 0), 2)


def test_kron_helpers_match_jax():
    rng = np.random.RandomState(0)
    As = [scipy.sparse.random(m, n, 0.4, format='csr', random_state=rng)
          for m, n in ((4, 3), (5, 2), (3, 4))]
    rows = np.array([0, 7, 13, 59, 31])
    assert_sparse_close(utils.multi_kron_sparse(As),
                        jutils.multi_kron_sparse(As), 0.0)
    for restrict in (False, True):
        assert_sparse_close(utils.kron_partial(As, rows, restrict=restrict),
                            jutils.kron_partial(As, rows, restrict=restrict),
                            0.0)


def test_geometry_factories_match_jax():
    grid = (np.linspace(0.0, 1.0, 5), np.linspace(0.0, 1.0, 4))
    for name, args in (('unit_square', ()), ('unit_square', (3,)),
                       ('unit_cube', ()), ('unit_cube', (2, 2))):
        G, J = getattr(geometry, name)(*args), getattr(jgeometry, name)(*args)
        assert type(G).__name__ == type(J).__name__
        assert np.array_equal(G.coeffs, J.coeffs)
        assert [kv.kv.tolist() for kv in G.kvs] == \
            [kv.kv.tolist() for kv in J.kvs]
    seg = geometry.line_segment([0.0, 1.0], [2.0, 3.0], intervals=2)
    jseg = jgeometry.line_segment([0.0, 1.0], [2.0, 3.0], intervals=2)
    assert np.array_equal(seg.coeffs, jseg.coeffs)
    # a NURBS factor makes the product rational
    T = geometry.tensor_product(geometry.line_segment(0.0, 2.0),
                                geometry.quarter_annulus())
    jT = jgeometry.tensor_product(jgeometry.line_segment(0.0, 2.0),
                                  jgeometry.quarter_annulus())
    assert isinstance(T, geometry.NurbsFunc)
    g3 = 3 * (np.linspace(0.0, 1.0, 4),)
    assert np.allclose(T.grid_eval(g3), jT.grid_eval(g3), rtol=1e-14,
                       atol=1e-14)
    kv = bspline.make_knots(3, 0.0, 1.0, 4)
    C = np.random.RandomState(1).rand(7, 7)
    F = geometry.BSplineFunc((kv, kv), C)
    jF = jgeometry.BSplineFunc(2 * (jbspline.make_knots(3, 0.0, 1.0, 4),), C)
    for meth in ('grid_eval', 'grid_jacobian', 'grid_hessian'):
        assert np.allclose(getattr(F, meth)(grid), getattr(jF, meth)(grid),
                           rtol=1e-13, atol=1e-13)


def test_boundary_sets_and_restricted_system():
    kvs = (bspline.make_knots(2, 0.0, 1.0, 3),
           bspline.make_knots(3, 0.0, 1.0, 4))
    jkvs = (jbspline.make_knots(2, 0.0, 1.0, 3),
            jbspline.make_knots(3, 0.0, 1.0, 4))
    for spec in ('left', 'right', 'top', 'bottom'):
        for ravel in (False, True):
            assert np.array_equal(
                assemble.boundary_dofs(kvs, spec, ravel=ravel),
                jassemble.boundary_dofs(jkvs, spec, ravel=ravel))
            assert np.array_equal(
                assemble.boundary_cells(kvs, spec, ravel=ravel),
                jassemble.boundary_cells(jkvs, spec, ravel=ravel))
    rng = np.random.RandomState(2)
    A = scipy.sparse.random(12, 12, 0.5, format='csr', random_state=rng) \
        + scipy.sparse.eye(12)
    b = rng.rand(12)
    bcs = (np.array([7, 0, 3]), np.array([1.0, 2.0, 3.0]))
    R, jR = (assemble.RestrictedLinearSystem(A, b, bcs),
             jassemble.RestrictedLinearSystem(A, b, bcs))
    assert_sparse_close(R.A, jR.A, 0.0)
    assert np.array_equal(R.b, jR.b)
    u = rng.rand(9)
    assert np.array_equal(R.complete(u), jR.complete(u))


@pytest.mark.parametrize('disparity', [np.inf, 1])
@pytest.mark.parametrize('truncate', [False, True])
def test_hspace_matches_jax(disparity, truncate):
    hs, jhs = both_hspaces(disparity=disparity, truncate=truncate)
    assert hs.numactive == jhs.numactive
    assert hs.numdofs == jhs.numdofs
    assert hs.deactfun == jhs.deactfun
    assert np.array_equal(hs.dirichlet_dofs(), jhs.dirichlet_dofs())
    assert np.array_equal(hs.non_dirichlet_dofs(), jhs.non_dirichlet_dofs())
    for P, jP in zip(hs.virtual_hierarchy_prolongators(),
                     jhs.virtual_hierarchy_prolongators()):
        assert_sparse_close(P, jP, 1e-14)
    for strategy in STRATEGIES:
        got, ref = hs.indices_to_smooth(strategy), \
            jhs.indices_to_smooth(strategy)
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            assert np.array_equal(a, b), strategy
    assert_sparse_close(hs.thb_to_hb(), jhs.thb_to_hb(), 1e-14)
    assert_sparse_close(hs.represent_fine(), jhs.represent_fine(), 1e-14)
    # a refinement of the same marked cells keeps the two in step
    cells = {1: list(hs.active_cells(1))[:3]}
    hs.refine(cells)
    jhs.refine(cells)
    assert hs.numactive == jhs.numactive


def test_hsplinefunc_matches_jax():
    hs, jhs = both_hspaces(disparity=1, truncate=True)
    u = np.random.RandomState(3).rand(hs.numdofs)
    grid = 2 * (np.linspace(0.0, 1.0, 7),)
    F, jF = hierarchical.HSplineFunc(hs, u), jhier.HSplineFunc(jhs, u)
    assert np.allclose(F.grid_eval(grid), jF.grid_eval(grid),
                       rtol=1e-13, atol=1e-13)
    assert np.allclose(F.grid_jacobian(grid), jF.grid_jacobian(grid),
                       rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize('bbox', [((0, 8), (0, 8)), ((2, 5), (3, 8)),
                                  ((5, 8), (0, 3))])
def test_bbox_assembly_matches_jax(bbox):
    kv, jkv = bspline.make_knots(3, 0.0, 1.0, 8), \
        jbspline.make_knots(3, 0.0, 1.0, 8)
    asm = tcompile.compile_vform(vform.stiffness_vf(2), on_demand=True)(
        (kv, kv), bbox=bbox, geo=geometry.unit_square())
    jasm = jcompile.compile_vform(jvform.stiffness_vf(2), on_demand=True)(
        (jkv, jkv), bbox=bbox, geo=jgeometry.unit_square())
    assert asm._bbox_win_test == jasm._bbox_win_test
    for bx, jbx in zip(asm.structure.bidx, jasm.structure.bidx):
        assert np.array_equal(bx, jbx)
    A, J = asm.assemble(), jasm.assemble()
    assert_sparse_close(A.asmatrix(), J.asmatrix(), 1e-13)


def test_update_matches_fresh_assembler():
    kv = bspline.make_knots(3, 0.0, 1.0, 6)
    vf = vform.L2functional_vf(2, physical=True, updatable=True)
    cls = tcompile.compile_vform(vf, on_demand=True)
    bbox = ((1, 4), (2, 6))
    f1 = lambda x, y: np.sin(x) * y          # noqa: E731
    f2 = lambda x, y: 1.0 + x * x            # noqa: E731
    asm = cls((kv, kv), bbox=bbox, geo=geometry.unit_square(), f=f1)
    first = asm.assemble_vector()
    asm.update(f=f2)
    fresh = cls((kv, kv), bbox=bbox, geo=geometry.unit_square(), f=f2)
    assert np.array_equal(asm.assemble_vector(), fresh.assemble_vector())
    assert not np.allclose(first, fresh.assemble_vector())
    # a new geometry drops every device operand
    geo2 = geometry.unit_square(2)
    geo2.coeffs = geo2.coeffs * 2.0
    asm.update(geo=geo2)
    fresh = cls((kv, kv), bbox=bbox, geo=geo2, f=f2)
    assert np.allclose(asm.assemble_vector(), fresh.assemble_vector(),
                       rtol=1e-14, atol=1e-16)
    with pytest.raises(ValueError):
        asm.update(nothing=1.0)


@pytest.mark.parametrize('truncate', [False, True])
def test_hdiscretization_matches_jax(truncate):
    hs, jhs = both_hspaces(disparity=1, truncate=truncate)
    f = lambda *x: 1.0 + x[0] * x[1]         # noqa: E731
    hd = hierarchical.HDiscretization(
        hs, vform.stiffness_vf(dim=2), {'geo': geometry.unit_square(), 'f': f})
    jhd = jhier.HDiscretization(
        jhs, jvform.stiffness_vf(dim=2),
        {'geo': jgeometry.unit_square(), 'f': f})
    assert_sparse_close(hd.assemble_matrix(), jhd.assemble_matrix(), 1e-13)
    rhs, jrhs = hd.assemble_rhs(), jhd.assemble_rhs()
    assert np.abs(rhs - jrhs).max() <= 1e-13 * np.abs(jrhs).max()
    # the second build reuses the cached per-level assemblers
    assert np.array_equal(hd.assemble_rhs(), rhs)
