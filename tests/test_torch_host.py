"""Host layer of the PyTorch port held equal to the JAX package:
knot vectors, quadrature, geometry, sparsity structures, basis tables and
the geometry evaluation tables (all numpy copies in pyiga_tpu_torch)."""

import numpy as np
import pytest
import torch

import pyiga_tpu.bspline as jbspline
import pyiga_tpu.geometry as jgeometry
import pyiga_tpu.mlmatrix as jmlmatrix
import pyiga_tpu.quadrature as jquadrature
from pyiga_tpu.assemblers import StiffnessAssembler as JStiffnessAssembler
from pyiga_tpu.ops import basis as jbasis
from pyiga_tpu.ops import geom as jgeom
from pyiga_tpu.ops import sumfac as jsumfac

from pyiga_tpu_torch import bspline, convert, geometry, mlmatrix, quadrature
from pyiga_tpu_torch.assemblers import StiffnessAssembler
from pyiga_tpu_torch.ops import basis, geom, sumfac

torch.set_num_threads(1)

GEOMETRIES = ['twisted_box', 'quarter_annulus', 'bspline_quarter_annulus']
KNOTS = [(1, 1), (2, 5), (3, 8), (4, 3)]


@pytest.mark.parametrize('p,n', KNOTS)
def test_knots_and_basis(p, n):
    kv, jkv = bspline.make_knots(p, 0.0, 1.0, n), jbspline.make_knots(p, 0.0, 1.0, n)
    assert kv.p == jkv.p and np.array_equal(kv.kv, jkv.kv)
    assert kv.numdofs == jkv.numdofs and np.array_equal(kv.mesh, jkv.mesh)
    assert np.array_equal(kv.mesh_support_idx_all(), jkv.mesh_support_idx_all())
    u = np.random.RandomState(p).rand(50)
    u[:2] = (0.0, 1.0)
    assert np.array_equal(bspline.findspans(kv, u), jbspline.findspans(jkv, u))
    assert np.array_equal(bspline.active_deriv(kv, u, 2),
                          jbspline.active_deriv(jkv, u, 2))
    assert np.array_equal(basis.dense_basis_table(kv, u, 1),
                          jbasis.dense_basis_table(jkv, u, 1))
    assert kv == convert.knot_vector(jkv)


def test_quadrature():
    mesh = np.array([0.0, 0.2, 0.5, 1.0])
    for deg in (1, 3, 4):
        a = quadrature.gauss_rule(deg, mesh[:-1], mesh[1:])
        b = jquadrature.gauss_rule(deg, mesh[:-1], mesh[1:])
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    kvs = [bspline.make_knots(3, 0.0, 1.0, 4), bspline.make_knots(2, 0.0, 1.0, 3)]
    jkvs = [jbspline.make_knots(3, 0.0, 1.0, 4), jbspline.make_knots(2, 0.0, 1.0, 3)]
    a = sumfac.quadrature_for(kvs)
    b = jsumfac.quadrature_for(jkvs)
    for x, y in zip(a, b):
        assert all(np.array_equal(u, v) for u, v in zip(x, y))


@pytest.mark.parametrize('name', GEOMETRIES)
def test_geometry(name):
    geo, jgeo = getattr(geometry, name)(), getattr(jgeometry, name)()
    assert type(geo).__name__ == type(jgeo).__name__
    assert geo.sdim == jgeo.sdim and geo.dim == jgeo.dim
    for kv, jkv in zip(geo.kvs, jgeo.kvs):
        assert kv.p == jkv.p and np.array_equal(kv.kv, jkv.kv)
    assert np.array_equal(geo.coeffs, jgeo.coeffs)
    conv = convert.geometry_from(jgeo)
    assert type(conv) is type(geo) and np.array_equal(conv.coeffs, geo.coeffs)


@pytest.mark.parametrize('p,n', KNOTS[1:])
def test_mlstructure(p, n):
    kvs = (bspline.make_knots(p, 0.0, 1.0, n), bspline.make_knots(p, 0.0, 1.0, n + 2))
    jkvs = tuple(jbspline.make_knots(kv.p, 0.0, 1.0, kv.numspans) for kv in kvs)
    S = mlmatrix.MLStructure.from_kvs(kvs, kvs)
    jS = jmlmatrix.MLStructure.from_kvs(jkvs, jkvs)
    assert S.bs == jS.bs and S.shape == jS.shape
    for bx, jbx in zip(S.bidx, jS.bidx):
        assert bx.dtype == jbx.dtype and np.array_equal(bx, jbx)
        assert np.array_equal(mlmatrix.transpose_idx_for_bidx(bx),
                              jmlmatrix.transpose_idx_for_bidx(jbx))


@pytest.mark.parametrize('name', GEOMETRIES)
def test_geo_eval_tables(name):
    geo, jgeo = getattr(geometry, name)(), getattr(jgeometry, name)()
    grids = [np.linspace(0.0, 1.0, 7 + k) for k in range(geo.sdim)]
    tabs, coeffs, nurbs = geom.geo_eval_tables(geo, grids)
    jtabs, jcoeffs, jnurbs = jgeom.geo_eval_tables(jgeo, grids)
    assert nurbs == jnurbs and np.array_equal(coeffs, jcoeffs)
    assert all(np.array_equal(a, b) for a, b in zip(tabs, jtabs))


@pytest.mark.parametrize('name,p,n', [('twisted_box', 3, 4),
                                      ('quarter_annulus', 3, 6)])
def test_assembler_host_state(name, p, n):
    """The port's assembler sets up the same quadrature, pair tables, fold
    plan and geometry inputs as the JAX assembler; convert.geo_inputs
    carries the JAX dict over unchanged."""
    geo, jgeo = getattr(geometry, name)(), getattr(jgeometry, name)()
    kvs = geo.sdim * (bspline.make_knots(p, 0.0, 1.0, n),)
    jkvs = jgeo.sdim * (jbspline.make_knots(p, 0.0, 1.0, n),)
    asm = StiffnessAssembler(kvs, geo, device='cpu')
    jasm = JStiffnessAssembler(jkvs, jgeo)
    assert asm.terms == jasm.terms
    assert asm._fold() == jasm._fold()[0]
    bws = [p] * geo.sdim
    for T, jT in zip(sum(asm.tables.banded_term_tables(asm.terms, bws), []),
                     sum(jasm.tables.banded_term_tables(jasm.terms, bws), [])):
        assert np.array_equal(T, jT)
    ours = asm.geo_inputs()
    theirs = convert.geo_inputs(jasm._geo_inputs, device='cpu')
    assert ours.keys() == theirs.keys()
    for key in ours:
        a = ours[key] if isinstance(ours[key], list) else [ours[key]]
        b = theirs[key] if isinstance(theirs[key], list) else [theirs[key]]
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize('n,bw', [(5, 1), (9, 3), (12, 2)])
def test_banded_fold_helpers(n, bw):
    assert np.array_equal(sumfac.banded_transpose_perm(n, bw),
                          jsumfac.banded_transpose_perm(n, bw))
    d = 3
    e = [tuple(int(i == k) for i in range(d)) for k in range(d)]
    terms = [(e[a], e[b]) for a in range(d) for b in range(d)]
    assert sumfac.symmetric_fold_plan(terms) == jsumfac.symmetric_fold_plan(terms)
    assert sumfac.symmetric_fold_plan(terms[:2]) is None
