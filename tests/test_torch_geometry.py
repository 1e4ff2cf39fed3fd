"""The port's geometry factories and methods (``pyiga_tpu_torch.geometry``)
held against ``pyiga_tpu.geometry``: every factory's control points and
weights equal the JAX package's bitwise and ``convert.geometry_from``
carries the JAX geometry over bitwise; evaluations, Jacobians and
Hessians agree to 1e-14; the host ``NurbsFunc.grid_hessian`` agrees with
the device route ``cuda_sumfac.geometry_hessian`` (its plain version on
the CPU) to 1e-12; the cases of ``tests/test_geometry.py`` for the names
the port carries."""

import numpy as np
import pytest
import torch

import pyiga_tpu.bspline as jbspline
import pyiga_tpu.geometry as jg

from pyiga_tpu_torch import approx, bspline, convert, geometry as tg
from pyiga_tpu_torch.ops import cuda_sumfac, geom

torch.set_num_threads(1)

FACTORIES = [
    ('disk', ()), ('disk', (1.5,)), ('circle', (0.5,)),
    ('semicircle', (1.5,)), ('circular_arc', (2.0 / 3.0 * np.pi, 2.0)),
    ('circular_arc', (1.5 * np.pi, 0.7)),
    ('circular_arc_3pt', (np.pi / 2,)), ('circular_arc_5pt', (np.pi, 2.0)),
    ('circular_arc_7pt', (2 * np.pi,)),
]


def _grid(geo, n=9):
    return tuple(np.linspace(s[0], s[1], n) for s in geo.support)


def _close(got, ref, tol=1e-14):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * max(np.abs(ref).max(), 1.0)


def _same_spline(port, jax_geo):
    assert type(port).__name__ == type(jax_geo).__name__
    assert np.array_equal(port.coeffs, jax_geo.coeffs)
    assert all(np.array_equal(a.kv, b.kv) and a.p == b.p
               for a, b in zip(port.kvs, jax_geo.kvs))


@pytest.mark.parametrize('name,args', FACTORIES)
def test_factory_equals_jax_and_converts(name, args):
    geo, jgeo = getattr(tg, name)(*args), getattr(jg, name)(*args)
    _same_spline(geo, jgeo)
    _same_spline(convert.geometry_from(jgeo), jgeo)
    grid = _grid(geo)
    _close(geo.grid_eval(grid), jgeo.grid_eval(grid))
    _close(geo.grid_jacobian(grid), jgeo.grid_jacobian(grid))


def test_perturbed_square_seeded():
    np.random.seed(3)
    geo = tg.perturbed_square(noise=0.05)
    np.random.seed(3)
    jgeo = jg.perturbed_square(noise=0.05)
    _same_spline(geo, jgeo)
    _same_spline(convert.geometry_from(jgeo), jgeo)
    assert geo.dim == 2


@pytest.mark.parametrize('combine', ['outer_sum', 'outer_product'])
@pytest.mark.parametrize('nurbs', [False, True])
def test_outer_combinators(combine, nurbs):
    rng = np.random.RandomState(4)
    c1, c2 = rng.rand(5), rng.rand(5)
    kv1, kv2 = (2, 0.0, 1.0, 3), (1, 0.0, 1.0, 4)
    f1 = tg.BSplineFunc(bspline.make_knots(*kv1), c1)
    f2 = tg.BSplineFunc(bspline.make_knots(*kv2), c2)
    j1 = jg.BSplineFunc(jbspline.make_knots(*kv1), c1)
    j2 = jg.BSplineFunc(jbspline.make_knots(*kv2), c2)
    if nurbs:
        f2, j2 = f2.as_nurbs(), j2.as_nurbs()
    g, jgeo = getattr(tg, combine)(f1, f2), getattr(jg, combine)(j1, j2)
    _same_spline(g, jgeo)
    _same_spline(convert.geometry_from(jgeo), jgeo)
    y, x = np.linspace(0, 1, 6), np.linspace(0, 1, 7)
    v1, v2 = f1.grid_eval((y,)), f2.grid_eval((x,))
    ref = (v1[:, None] + v2[None, :] if combine == 'outer_sum'
           else v1[:, None] * v2[None, :])
    assert np.allclose(np.squeeze(g.grid_eval((y, x))), ref)


def test_nurbs_circles():
    kv = bspline.make_knots(2, 0.0, 1.0, 1)
    r = 2.0
    coeffs = np.array([[r, 0.0, 1.0], [r, r, 1.0 / np.sqrt(2.0)],
                       [0.0, r, 1.0]])
    grid = (np.linspace(0.0, 1.0, 20),)
    for arc_geo, radius in ((tg.semicircle(1.5), 1.5), (tg.circle(0.5), 0.5)):
        vals = arc_geo.grid_eval((np.linspace(0, 1, 30),))
        assert abs(radius - np.linalg.norm(vals, axis=-1)).max() < 1e-12
    nurbs = tg.NurbsFunc((kv,), coeffs[:, :2], weights=coeffs[:, -1])
    nx = nurbs[0]
    assert nx.output_shape() == () and nx.is_scalar()
    assert nx.grid_jacobian(grid).shape[1:] == (1,)
    assert nx.grid_hessian(grid).shape[1:] == (1,)
    jx = jg.NurbsFunc((jbspline.make_knots(2, 0.0, 1.0, 1),), coeffs[:, :2],
                      weights=coeffs[:, -1])[0]
    _close(nx.grid_hessian(grid), jx.grid_hessian(grid))


def test_circular_arc_endpoints():
    for alpha, r in ((2. / 3. * np.pi, 2.0), (1.5 * np.pi, 0.7)):
        vals = tg.circular_arc(alpha, r=r).grid_eval(
            (np.linspace(0, 1, 25),))
        assert abs(np.linalg.norm(vals, axis=-1) - r).max() < 1e-12
        assert np.allclose(vals[0], (r, 0))
        assert np.allclose(vals[-1], (r * np.cos(alpha), r * np.sin(alpha)))
    with pytest.raises(ValueError):
        tg.circular_arc(3 * np.pi)


def _num_hess(f, x, h=1e-3):
    def pd2(i, j):
        def at(di, dj):
            y = list(x)
            y[i] += di
            y[j] += dj
            return f(y)
        return (at(h, h) + at(-h, -h) - at(h, -h) - at(-h, h)) / (4 * h * h)
    return np.array([pd2(0, 0), pd2(1, 0), pd2(1, 1)])


@pytest.mark.parametrize('name', ['quarter_annulus', 'disk'])
def test_nurbs_hessian(name):
    """Against finite differences, the JAX package's quotient rule (1e-14)
    and the device route's plain version (1e-12)."""
    geo, jgeo = getattr(tg, name)(), getattr(jg, name)()
    X = np.linspace(0, 1, 5)[1:-1]
    H = geo.grid_hessian((X, X))
    H_num = np.array([[[_num_hess(lambda xy: geo.eval(*xy)[c],
                                  (X[i], X[j])) for c in range(2)]
                       for i in range(len(X))] for j in range(len(X))])
    assert np.allclose(H, H_num, atol=1e-5)
    grid = 2 * (np.linspace(0.05, 0.95, 13),)
    _close(geo.grid_hessian(grid), jgeo.grid_hessian(grid))
    tables, coeffs, nurbs = geom.geo_eval_tables(geo, grid, numderiv=2)
    Hd = cuda_sumfac.geometry_hessian([torch.as_tensor(t) for t in tables],
                                      torch.as_tensor(coeffs), nurbs).numpy()
    Hh = geo.grid_hessian(grid)
    for m, (i, j) in enumerate([(1, 1), (1, 0), (0, 0)]):
        for c in range(2):
            _close(Hd[1 - c, i, j], Hh[..., c, m], 1e-12)


def test_transformed_jacobian():
    geo = tg.bspline_quarter_annulus()
    u = tg.BSplineFunc(geo.kvs, approx.interpolate(
        geo.kvs, lambda x, y: x - y, geo=geo))
    grads = u.transformed_jacobian(geo).grid_eval(2 * (np.linspace(0, 1, 10),))
    assert np.allclose(grads[:, :, 0], 1) and np.allclose(grads[:, :, 1], -1)
    jgeo = jg.bspline_quarter_annulus()
    ju = jg.BSplineFunc(jgeo.kvs, u.coeffs)
    grid = 2 * (np.linspace(0, 1, 7),)
    _close(u.transformed_jacobian(geo).grid_eval(grid),
           ju.transformed_jacobian(jgeo).grid_eval(grid))
    assert u.transformed_jacobian(geo).output_shape() == (2,)


def test_convert_gradient_and_composed_functions():
    """``convert.geometry_from`` carries a physical gradient and a
    composition over part by part; their values equal the JAX
    package's."""
    jgeo = jg.quarter_annulus()
    ju = jg.BSplineFunc(jgeo.kvs, np.random.RandomState(5).rand(3, 2))
    grid = 2 * (np.linspace(0.1, 0.9, 6),)
    for jf in (ju.transformed_jacobian(jgeo),
               jg.ComposedFunction(jg.unit_square(), jgeo.scale(0.25))):
        f = convert.geometry_from(jf)
        assert type(f).__name__ == type(jf).__name__
        _close(f.grid_eval(grid), jf.grid_eval(grid))


def test_find_inverse():
    geo = tg.quarter_annulus()
    target = (1.5 / np.sqrt(2), 1.5 / np.sqrt(2))
    xi = geo.find_inverse(target)
    assert np.allclose(geo.eval(*xi), target, atol=1e-6)
    assert np.allclose(xi, jg.quarter_annulus().find_inverse(target))
    with pytest.raises(ValueError):
        geo.find_inverse((10.0, 10.0))


def test_getitem_and_perturb():
    geo, jgeo = tg.bspline_quarter_annulus(), jg.bspline_quarter_annulus()
    grid = 2 * (np.linspace(0, 1, 8),)
    assert np.allclose(geo[0].grid_eval(grid), geo.grid_eval(grid)[..., 0])
    assert np.array_equal(geo[1].coeffs, jgeo[1].coeffs)
    assert np.array_equal(tg.quarter_annulus()[1].coeffs,
                          jg.quarter_annulus()[1].coeffs)
    np.random.seed(7)
    p = geo.perturb(0.1)
    np.random.seed(7)
    assert np.array_equal(p.coeffs, jgeo.perturb(0.1).coeffs)
