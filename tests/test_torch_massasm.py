"""The port's mass assembler, host-evaluated geometries and the
``assemble.mass`` / ``assemble.stiffness`` routes, held against the JAX
package on its native-f64 paths: kernel K1's ``mass`` kind and K1' (the
stiffness fields of a host Jacobian) by their plain versions, the compact
and banded assemblies, the golden fixtures, ``UserFunction`` and the
weighted fast-diagonalization preconditioner on a ``UserFunction``
assembler."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pyiga_tpu.bspline as jbspline
import pyiga_tpu.geometry as jgeometry
from pyiga_tpu import assemble as jassemble
from pyiga_tpu import assemblers as jassemblers
from pyiga_tpu.ops import banded as jbanded
from pyiga_tpu.ops import fastdiag as jfastdiag
from pyiga_tpu.ops import geom as jgeom

from pyiga_tpu_torch import assemble, assemblers, bspline, convert, geometry
from pyiga_tpu_torch import utils
from pyiga_tpu_torch.ops import cuda_sumfac, fastdiag, geom

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), 'fixtures')


def _stack_jac(rows):
    """Jacobian rows ``rows[i][j] = dF_i/dx_j`` as one array shaped
    ``grid x dim x sdim`` (entry ``[..., i, j]``)."""
    flat = np.broadcast_arrays(*[c for row in rows for c in row])
    d = len(rows)
    return np.stack([np.stack(flat[i * d:(i + 1) * d], axis=-1)
                     for i in range(d)], axis=-2)


def _skew2d():
    """The map of the JAX package's ``test_diff`` (non-symmetric Jacobian,
    given as the nested tuple of that test)."""
    return (lambda x, y: (x + 0.1 * y * y, y), [[0, 1], [0, 1]],
            lambda x, y: ((np.ones_like(x), 0.2 * y),
                          (np.zeros_like(x), np.ones_like(y))))


def _polar2d():
    """The quarter annulus in polar parametrization, Jacobian as an array."""
    h = 0.5 * np.pi

    def f(x, y):
        return ((1 + x) * np.cos(h * y), (1 + x) * np.sin(h * y))

    def jac(x, y):
        c, s = np.cos(h * y), np.sin(h * y)
        return _stack_jac([[c, -h * (1 + x) * s], [s, h * (1 + x) * c]])
    return f, [[0, 1], [0, 1]], jac


def _user3d():
    def f(x, y, z):
        return (x + 0.1 * y * z, y + 0.2 * x * x, z + 0.05 * x * y)

    def jac(x, y, z):
        one, zero = np.ones_like(x), np.zeros_like(x)
        return _stack_jac([[one, 0.1 * z, 0.1 * y],
                           [0.4 * x, one, zero],
                           [0.05 * y, 0.05 * x, one]])
    return f, [[0, 1]] * 3, jac


USER_GEOS = {'skew2d': _skew2d, 'polar2d': _polar2d, 'user3d': _user3d}


def _geos(name):
    """The same geometry in both packages: a named factory of theirs or
    one of the user maps above."""
    if name in USER_GEOS:
        f, support, jac = USER_GEOS[name]()
        return (geometry.UserFunction(f, support, jac=jac),
                jgeometry.UserFunction(f, support, jac=jac))
    return getattr(geometry, name)(), getattr(jgeometry, name)()


def _kvs(p, n, d):
    return (d * (bspline.make_knots(p, 0.0, 1.0, n),),
            d * (jbspline.make_knots(p, 0.0, 1.0, n),))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _jax_inputs(gi):
    return {k: [jnp.asarray(a) for a in v] if isinstance(v, list)
            else jnp.asarray(v) for k, v in gi.items()}


# (geometry, degree, spans)
SPLINE_CASES = [('quarter_annulus', 3, 10), ('twisted_box', 3, 5),
                ('twisted_box', 2, 4), ('bspline_quarter_annulus', 2, 7)]
USER_CASES = [('skew2d', 2, 6), ('polar2d', 3, 8), ('user3d', 2, 4)]


@pytest.mark.parametrize('name,p,n', SPLINE_CASES)
def test_mass_fields_plain(name, p, n):
    """K1 ``mass`` (plain) against the JAX ``assemblers.mass_fields``."""
    _geo, jgeo = _geos(name)
    gi = jassemblers.MassAssembler(_kvs(p, n, jgeo.sdim)[1],
                                   jgeo)._geo_inputs
    ref = jassemblers.mass_fields(_jax_inputs(gi))
    got = assemblers.mass_fields(convert.geo_inputs(gi, device='cpu'))
    assert len(got) == 1 and got[0].dtype == torch.float64
    assert got[0].shape == ref[0].shape
    assert _rel(got[0], ref[0]) < 1e-13


@pytest.mark.parametrize('name,p,n', USER_CASES)
def test_host_jac_fields_plain(name, p, n):
    """K1' (plain) and the host-Jacobian mass field against the JAX field
    functions on a ``'jac'`` input."""
    geo, jgeo = _geos(name)
    gi = jassemblers.StiffnessAssembler(_kvs(p, n, jgeo.sdim)[1],
                                        jgeo)._geo_inputs
    assert 'jac' in gi
    tgi = convert.geo_inputs(gi, device='cpu')
    for fn, jfn in ((assemblers.stiffness_fields,
                     jassemblers.stiffness_fields),
                     (assemblers.mass_fields, jassemblers.mass_fields)):
        got, ref = fn(tgi), jfn(_jax_inputs(gi))
        assert len(got) == len(ref)
        scale = max(np.abs(np.asarray(R)).max() for R in ref)
        for F, R in zip(got, ref):
            assert F.dtype == torch.float64 and F.shape == R.shape
            assert np.abs(np.asarray(F) - np.asarray(R)).max() / scale < 1e-13


@pytest.mark.parametrize('d,Q12,QL', [(2, 5, 37), (2, 3, 301),
                                      (3, 12, 45), (3, 1, 7)])
def test_host_jac_fields_layout(d, Q12, QL):
    """K1' returns the unique ``B_ab`` (a <= b) flattened over the points,
    the order ``stiffness_fields`` expands, with ``gw = w12 (x) wL``, for
    any point count (ragged: QL not a multiple of a warp, above the
    block's 256 columns, a single row)."""
    rng = np.random.RandomState(d + QL)
    N = Q12 * QL
    J = torch.as_tensor(np.eye(d)[:, :, None] + 0.2 * rng.rand(d, d, N))
    w12, wL = torch.as_tensor(rng.rand(Q12)), torch.as_tensor(rng.rand(QL))
    out = cuda_sumfac.host_jac_fields(J, w12, wL)
    assert out.shape == (d * (d + 1) // 2, N)
    Jn = J.numpy().transpose(2, 0, 1)
    inv = np.linalg.inv(Jn)
    gw = np.outer(w12.numpy(), wL.numpy()).ravel()
    B = (gw * np.abs(np.linalg.det(Jn)))[:, None, None] \
        * inv @ inv.transpose(0, 2, 1)
    ref = np.stack([B[:, a, b] for a in range(d) for b in range(a, d)])
    assert _rel(out, ref) < 1e-14


@pytest.mark.parametrize('d', [1, 2, 3])
def test_split_weights_give_gauss_weight_field(d):
    """K1' and K1 take ``w12`` and ``wL``; their product is
    ``gauss_weight_field`` bit for bit, (w0 w1) w2."""
    rng = np.random.RandomState(d)
    W = [torch.as_tensor(rng.rand(n)) for n in (4, 5, 6)[:d]]
    w12, wL = geom.gauss_weight_factors(W)
    assert torch.equal((w12[:, None] * wL).reshape(-1),
                       geom.gauss_weight_field(W).reshape(-1))


@pytest.mark.parametrize('name,p,n', [('skew2d', 2, 5), ('user3d', 2, 3)])
def test_user_function_matches_jax(name, p, n):
    """``UserFunction`` values, Jacobians and the level-ordered host
    Jacobian equal the JAX package's (the skew map's Jacobian is not
    symmetric, so the ``[..., ::-1, ::-1]`` reversal shows)."""
    geo, jgeo = _geos(name)
    assert (geo.dim, geo.sdim, geo.output_shape()) == \
        (jgeo.dim, jgeo.sdim, jgeo.output_shape())
    grid = [np.linspace(0, 1, n + k) for k in range(geo.sdim)]
    assert np.array_equal(geo.grid_eval(grid), jgeo.grid_eval(grid))
    assert np.array_equal(geo.grid_jacobian(grid), jgeo.grid_jacobian(grid))
    assert np.array_equal(geom.host_jacobian_levelorder(geo, grid),
                          jgeom.host_jacobian_levelorder(jgeo, grid))
    assert np.array_equal(geom.host_eval(geo, grid),
                          jgeom.host_eval(jgeo, grid))
    pt = tuple(0.3 + 0.1 * k for k in range(geo.sdim))
    assert np.array_equal(geo(*pt), jgeo(*pt))
    assert np.array_equal(geo.pointwise_eval(pt), jgeo.pointwise_eval(pt))
    assert geom.geo_eval_tables(geo, grid) is None
    with pytest.raises(ValueError):
        geometry.UserFunction(USER_GEOS[name]()[0],
                              geo.support).grid_jacobian(grid)
    assert isinstance(convert.geometry_from(jgeo), geometry.UserFunction)


def test_host_jacobian_levelorder_orientation():
    """Level order reverses both axes and keeps the orientation: entry
    ``[a, b]`` is d(component a)/d(axis b), both in ZYX order."""
    f, support, jac = _polar2d()
    geo = geometry.UserFunction(f, support, jac=jac)
    grid = [np.array([0.25, 0.5]), np.array([0.1, 0.6, 0.9])]   # (y, x)
    J = geom.host_jacobian_levelorder(geo, grid)
    assert J.shape == (2, 2, 2, 3)
    yy, xx = np.meshgrid(*grid, indexing='ij')
    h = 0.5 * np.pi
    # level order: component 0 is Y, axis 0 is y
    assert np.allclose(J[0, 0], h * (1 + xx) * np.cos(h * yy), rtol=1e-15)
    assert np.allclose(J[0, 1], np.sin(h * yy), rtol=1e-15)
    assert np.allclose(J[1, 0], -h * (1 + xx) * np.sin(h * yy), rtol=1e-15)
    assert np.allclose(J[1, 1], np.cos(h * yy), rtol=1e-15)


def test_user_function_equals_spline_map():
    """An affine map with a non-symmetric Jacobian given as a
    ``UserFunction`` assembles the same mass and stiffness matrices as the
    bilinear B-spline geometry of that map."""
    A = np.array([[1.0, 0.3], [-0.2, 0.7]])        # [i, j] = dF_i/dx_j

    def f(x, y):
        return (A[0, 0] * x + A[0, 1] * y, A[1, 0] * x + A[1, 1] * y)

    def jac(x, y):
        one = np.ones_like(x + y)
        return _stack_jac([[A[0, 0] * one, A[0, 1] * one],
                           [A[1, 0] * one, A[1, 1] * one]])
    ufun = geometry.UserFunction(f, [[0, 1], [0, 1]], jac=jac)
    kv1 = bspline.make_knots(1, 0.0, 1.0, 1)
    corners = np.array([[f(x, y) for x in (0.0, 1.0)] for y in (0.0, 1.0)])
    spline = geometry.BSplineFunc((kv1, kv1), corners)
    kvs = 2 * (bspline.make_knots(2, 0.0, 1.0, 5),)
    for build in (assemble.mass, assemble.stiffness):
        M_user = build(kvs, ufun, device='cpu')
        M_spline = build(kvs, spline, device='cpu')
        assert abs(M_user - M_spline).max() / abs(M_spline).max() < 1e-13


@pytest.mark.parametrize('kind', ['mass', 'stiffness'])
@pytest.mark.parametrize('name,p,n', SPLINE_CASES + USER_CASES)
def test_assemble_compact_matches_jax(kind, name, p, n):
    """Compact ``assemble()`` data against JAX ``assemble(mode='exact')``
    (the stiffness form folds its mirrored terms)."""
    geo, jgeo = _geos(name)
    kvs, jkvs = _kvs(p, n, geo.sdim)
    cls = {'mass': 'MassAssembler', 'stiffness': 'StiffnessAssembler'}[kind]
    mlm = getattr(assemblers, cls)(kvs, geo,
                                   device='cpu').assemble(mode='ozaki')
    jmlm = getattr(jassemblers, cls)(jkvs, jgeo).assemble(mode='exact')
    assert mlm.data.shape == jmlm.data.shape
    assert _rel(mlm.data, jmlm.data) < 1e-13
    assert abs(mlm.asmatrix() - jmlm.asmatrix()).max() \
        / np.abs(jmlm.data).max() < 1e-13


@pytest.mark.parametrize('name,p,n', [('quarter_annulus', 3, 8),
                                      ('twisted_box', 2, 4),
                                      ('polar2d', 2, 6)])
def test_mass_assemble_banded_matches_jax(name, p, n):
    """``MassAssembler.assemble_banded()`` (one unmirrored term: no 0.5
    prescale) matvec against the JAX exact banded operator."""
    geo, jgeo = _geos(name)
    kvs, jkvs = _kvs(p, n, geo.sdim)
    op = assemblers.MassAssembler(kvs, geo, device='cpu').assemble_banded()
    jop = jassemblers.MassAssembler(jkvs, jgeo).assemble_banded(mode='exact')
    x = np.random.RandomState(5).rand(op.shape[0])
    y = op(torch.as_tensor(x)).numpy()
    y_ref = np.asarray(jbanded.banded_matvec_static(
        jnp.asarray(jop.D), jnp.asarray(x), jop.bws, jop.ns))
    assert np.abs(y - y_ref).max() / np.abs(y_ref).max() < 1e-14
    M = assemblers.MassAssembler(kvs, geo,
                                 device='cpu').assemble().asmatrix()
    assert np.abs(y - M @ x).max() / np.abs(y_ref).max() < 1e-14


@pytest.mark.parametrize('kind,fixture,geo_name,p,n,d', [
    ('mass', 'poisson_neu_d2_p3_n15_mass', 'bspline_quarter_annulus', 3,
     15, 2),
    ('stiffness', 'poisson_neu_d2_p3_n15_stiff', 'bspline_quarter_annulus',
     3, 15, 2),
    ('mass', 'poisson_neu_d3_p2_n10_mass', 'twisted_box', 2, 10, 3),
    ('stiffness', 'poisson_neu_d3_p2_n10_stiff', 'twisted_box', 2, 10, 3)])
def test_golden_fixtures(kind, fixture, geo_name, p, n, d):
    from pyiga_tpu.utils import read_sparse_matrix
    ref = read_sparse_matrix(os.path.join(FIXTURES, fixture + '.mtx.gz'))
    A = getattr(assemble, kind)(_kvs(p, n, d)[0],
                                getattr(geometry, geo_name)(), device='cpu')
    assert A.format == 'csr'
    assert abs(A - ref).max() < 1e-14


@pytest.mark.parametrize('kind', ['mass', 'stiffness'])
@pytest.mark.parametrize('d', [1, 2, 3])
def test_assemble_separable_and_1d_match_jax(kind, d):
    """``geo=None`` (Kronecker route) and one axis (1D builder)."""
    kvs = (bspline.make_knots(3, 0.0, 1.0, 5),
           bspline.make_knots(2, 0.0, 1.0, 4),
           bspline.make_knots(2, 0.0, 1.0, 3))[:d]
    jkvs = (jbspline.make_knots(3, 0.0, 1.0, 5),
            jbspline.make_knots(2, 0.0, 1.0, 4),
            jbspline.make_knots(2, 0.0, 1.0, 3))[:d]
    A = getattr(assemble, kind)(kvs if d > 1 else kvs[0])
    ref = getattr(jassemble, kind)(jkvs if d > 1 else jkvs[0])
    assert abs(A - ref).max() == 0.0
    if d > 1:
        G = getattr(assemble, kind)(kvs, geometry.unit_cube(d)
                                    if d == 3 else geometry.unit_square(),
                                    device='cpu')
        assert abs(A - G).max() < 1e-14


def test_1d_builders_match_jax():
    kv1, kv2 = (bspline.make_knots(4, 0.0, 1.0, 10),
                bspline.make_knots(1, 0.0, 1.0, 20))
    jkv1, jkv2 = (jbspline.make_knots(4, 0.0, 1.0, 10),
                  jbspline.make_knots(1, 0.0, 1.0, 20))
    w = lambda x: 1.0 + x * x
    pairs = [
        (assemble.bsp_mass_1d(kv1, w), jassemble.bsp_mass_1d(jkv1, w)),
        (assemble.bsp_stiffness_1d(kv1), jassemble.bsp_stiffness_1d(jkv1)),
        (assemble.bsp_mixed_deriv_biform_1d(kv1, 2, 1),
         jassemble.bsp_mixed_deriv_biform_1d(jkv1, 2, 1)),
        (assemble.bsp_mass_1d_asym(kv1, kv2, quadgrid=kv2.mesh),
         jassemble.bsp_mass_1d_asym(jkv1, jkv2, quadgrid=jkv2.mesh)),
        (assemble.bsp_stiffness_1d_asym(kv1, kv2, quadgrid=kv2.mesh),
         jassemble.bsp_stiffness_1d_asym(jkv1, jkv2, quadgrid=jkv2.mesh)),
        (assemble.bsp_mixed_deriv_biform_1d_asym(kv1, kv2, 1, 0,
                                                 quadgrid=kv2.mesh),
         jassemble.bsp_mixed_deriv_biform_1d_asym(jkv1, jkv2, 1, 0,
                                                  quadgrid=jkv2.mesh))]
    for A, ref in pairs:
        assert A.shape == ref.shape and abs(A - ref).max() == 0.0
    for kv, jkv in ((kv1, jkv1), (kv2, jkv2)):
        for k, (C, jC) in enumerate(zip(
                bspline.collocation_derivs(kv, kv.mesh, 2),
                jbspline.collocation_derivs(jkv, jkv.mesh, 2))):
            assert abs(C - jC).max() == 0.0, k


def test_dimension_aliases():
    kvs = _kvs(2, 4, 2)[0]
    geo = geometry.quarter_annulus()
    cpu = dict(device='cpu')
    M = assemblers.MassAssembler2D(kvs, geo, **cpu).assemble()
    K = assemblers.StiffnessAssembler2D(kvs, geo, **cpu).assemble()
    assert np.array_equal(M.data, assemblers.MassAssembler(kvs, geo, **cpu)
                          .assemble().data)
    assert np.array_equal(K.data, assemblers.StiffnessAssembler(
        kvs, geo, **cpu).assemble().data)
    A = assemble.assemble_entries(assemblers.MassAssembler(kvs, geo, **cpu),
                                  format='mlb')
    assert np.array_equal(A.data, M.data)
    for cls in (assemblers.MassAssembler3D, assemblers.StiffnessAssembler3D):
        with pytest.raises(ValueError):
            cls(kvs, geo, **cpu)


@pytest.mark.parametrize('name,p,n', [('polar2d', 3, 8), ('user3d', 2, 4)])
def test_fastdiag_weighted_user_function(name, p, n):
    """The weighted preconditioner reads a host Jacobian (``'jac'``)."""
    geo, jgeo = _geos(name)
    kvs, jkvs = _kvs(p, n, geo.sdim)
    asm = assemblers.StiffnessAssembler(kvs, geo, device='cpu')
    jasm = jassemblers.StiffnessAssembler(jkvs, jgeo)
    P = fastdiag.fastdiag_precond_weighted(asm, dirichlet=True,
                                           dtype=torch.float64)
    jP = jfastdiag.fastdiag_precond_weighted(jasm, dirichlet=True,
                                             dtype=np.float64)
    r = np.random.RandomState(3).rand(len(fastdiag.interior_dofs(kvs)))
    z, jz = P(torch.as_tensor(r)).numpy(), np.asarray(jP(jnp.asarray(r)))
    assert np.abs(z - jz).max() / np.abs(jz).max() < 1e-12


def test_host_jacobian_uploaded_once():
    """The host Jacobian is uploaded once, and K1' reads it in place: the
    stiffness route passes a view of it and the per-axis weights."""
    geo, _ = _geos('polar2d')
    asm = assemblers.StiffnessAssembler(_kvs(2, 4, 2)[0], geo, device='cpu')
    gi = asm.geo_inputs()
    assert gi['jac'] is asm.geo_inputs()['jac']
    assert asm.geo_inputs(torch.float32)['jac'].dtype == torch.float32
    jac, grid = cuda_sumfac._host_jacobian(gi)
    assert jac.data_ptr() == gi['jac'].data_ptr()
    assert jac.shape == (2, 2, int(np.prod(grid)))
    w12, wL = geom.gauss_weight_factors(gi['weights'])
    assert w12.data_ptr() == gi['weights'][0].data_ptr()
    assert wL.data_ptr() == gi['weights'][1].data_ptr()
    out = cuda_sumfac.host_jac_fields(jac, w12, wL)
    fields = cuda_sumfac.stiffness_fields(gi)
    assert torch.equal(fields[0].reshape(-1), out[0])
    assert torch.equal(fields[3].reshape(-1), out[2])


def test_progress_bar_stand_in():
    bar = utils.progress_bar(False)
    assert bar is utils._SilentPbar
    with bar(total=1.0) as pbar:
        pbar.update(0.5)
        pbar.set_postfix({'tau': 0.5})
    assert list(bar(range(3))) == [0, 1, 2]
    assert utils.progress_bar(True) is not None


def test_new_kernel_wrappers_refuse_other_devices():
    """K1 ``mass`` and K1' run their plain versions only for CPU tensors;
    any other device launches the kernel or raises."""
    meta = torch.empty((3, 3, 4, 2), dtype=torch.float64, device='meta')
    with pytest.raises(ValueError):
        cuda_sumfac.fields_mass(meta, meta[0], meta[0, 0, :, 0],
                                meta[0, 0, 0], False)
    with pytest.raises(ValueError):
        cuda_sumfac.host_jac_fields(meta[:, :, :, 0], meta[0, 0, :2, 0],
                                    meta[0, 0, :2, 0])
