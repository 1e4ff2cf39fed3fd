"""The port's B-spline layer (``pyiga_tpu_torch.bspline``) held against
``pyiga_tpu.bspline`` on the same inputs made from a seed: the cases of
``tests/test_bspline.py`` for the names the port carries, each also
compared with the JAX package's result (bitwise, or to 1e-14 where a sum
runs in another order)."""

import numpy as np
import pytest

import pyiga_tpu.bspline as jb

from pyiga_tpu_torch import bspline as tb

KNOTS = np.array([0., 0., 0., 0., 0., 0.05, 0.12, 0.33, 0.51, 0.51, 0.51,
                  0.74, 0.88, 0.91, 1., 1., 1., 1., 1.])


def _both(p, a, b, n, mult=1):
    return tb.make_knots(p, a, b, n, mult), jb.make_knots(p, a, b, n, mult)


def test_eval_consistency():
    kv, jkv = _both(4, 0.0, 1.0, 25)
    coeffs = np.random.RandomState(0).rand(kv.numdofs)
    x = np.linspace(0.0, 1.0, 100)
    by_single = sum(coeffs[j] * tb.single_ev(kv, j, x)
                    for j in range(kv.numdofs))
    assert np.linalg.norm(by_single - tb.ev(kv, coeffs, x)) < 1e-10
    assert np.linalg.norm(by_single - tb.collocation(kv, x).dot(coeffs)) \
        < 1e-10
    assert np.array_equal(tb.ev(kv, coeffs, x), jb.ev(jkv, coeffs, x))
    assert np.array_equal(tb.single_ev(kv, 7, x), jb.single_ev(jkv, 7, x))


def test_partition_of_unity_and_active_ev():
    kv, jkv = _both(3, 0.0, 1.0, 12, mult=2)
    x = np.linspace(0.0, 1.0, 57)
    vals = tb.active_ev(kv, x)
    assert np.allclose(vals.sum(axis=0), 1.0)
    assert np.array_equal(vals, jb.active_ev(jkv, x))
    assert np.array_equal(tb.active_ev(kv, 0.3), jb.active_ev(jkv, 0.3))


def test_deriv_matches_splev_and_jax():
    kv, jkv = tb.KnotVector(KNOTS, 4), jb.KnotVector(KNOTS, 4)
    coeffs = np.random.RandomState(1).rand(kv.numdofs)
    x = np.linspace(0.0, 1.0, 200)
    Cs = tb.collocation_derivs(kv, x, derivs=3)
    for d in range(4):
        ref = tb.deriv(kv, coeffs, d, x)
        assert np.array_equal(ref, jb.deriv(jkv, coeffs, d, x))
        assert np.linalg.norm(Cs[d].dot(coeffs) - ref, np.inf) < 1e-8 * max(
            1.0, np.abs(ref).max())


def test_findspan_first_active():
    kv, jkv = _both(2, 0.0, 1.0, 4)
    assert kv.findspan(0.0) == 2
    assert kv.findspan(1.0) == 5
    assert kv.findspan(0.3) == 3
    for u in np.linspace(0.0, 1.0, 17):
        assert kv.findspan(u) == jkv.findspan(u)
        assert kv.first_active_at(u) == jkv.first_active_at(u)
    assert kv.first_active(4) == jkv.first_active(4) == 2


def test_knot_vector_introspection():
    kv, jkv = tb.KnotVector(KNOTS, 4), jb.KnotVector(KNOTS, 4)
    assert str(kv) == str(jkv) == '<KnotVector p=4 sz=19>'
    assert kv.numknots == jkv.numknots == 19
    assert kv.meshsize_avg() == jkv.meshsize_avg()


@pytest.mark.parametrize('p', [0, 3])
def test_interpolation(p):
    kv, jkv = _both(p, 0.0, 1.0, 10)
    coeffs = np.random.RandomState(2).rand(kv.numdofs)
    result = tb.interpolate(kv, lambda x: tb.ev(kv, coeffs, x))
    assert np.allclose(coeffs, result)
    assert np.array_equal(result, jb.interpolate(
        jkv, lambda x: jb.ev(jkv, coeffs, x)))


def test_collocation_info():
    kv, jkv = tb.KnotVector(KNOTS, 4), jb.KnotVector(KNOTS, 4)
    x = np.random.RandomState(3).rand(31)
    for got, ref in zip(tb.collocation_info(kv, x),
                        jb.collocation_info(jkv, x)):
        assert np.array_equal(got, ref)


def test_L2_projection_and_load_vector():
    kv, jkv = _both(3, 0.0, 1.0, 10)

    def f(x):
        return np.sin(2 * np.pi * x ** 2)
    x = np.linspace(0.0, 1.0, 100)
    coeffs = tb.project_L2(kv, f)
    assert np.linalg.norm(f(x) - tb.ev(kv, coeffs, x)) / np.sqrt(len(x)) \
        < 1e-3
    ref = jb.project_L2(jkv, f)
    assert np.abs(coeffs - ref).max() <= 1e-14 * np.abs(ref).max()
    assert np.array_equal(tb.load_vector(kv, f), jb.load_vector(jkv, f))


def test_deriv_of_interpolant():
    kv, _ = _both(4, 0.0, 1.0, 25)
    coeffs = tb.interpolate(kv, lambda x: 1.0 + 2.5 * x)
    x = np.linspace(0.0, 1.0, 100)
    assert np.linalg.norm(tb.deriv(kv, coeffs, 1, x) - 2.5) < 1e-10
    coeffs = np.random.RandomState(4).rand(kv.numdofs)
    allders = tb.collocation_derivs(kv, x, derivs=2)
    for d in (1, 2):
        assert np.linalg.norm(tb.deriv(kv, coeffs, d, x)
                              - allders[d].dot(coeffs), np.inf) < 1e-10


@pytest.mark.parametrize('newknot', [0.01, 0.2, 0.33, 0.44, 0.6, 0.99])
def test_knot_insertion(newknot):
    kv, jkv = tb.KnotVector(KNOTS, 4), jb.KnotVector(KNOTS, 4)
    u = np.random.RandomState(5).rand(kv.numdofs)
    x = np.linspace(0, 1, 100)
    P = tb.knot_insertion(kv, newknot)
    kv1 = kv.refine([newknot])
    assert np.allclose(tb.ev(kv, u, x), tb.ev(kv1, P @ u, x))
    assert (P != jb.knot_insertion(jkv, newknot)).nnz == 0


def test_prolongation_by_ev():
    kv, _ = _both(3, 0.0, 1.0, 10)
    coeffs = np.random.RandomState(6).rand(kv.numdofs)
    kv2 = kv.refine()
    P = tb.prolongation(kv, kv2)
    x = np.linspace(0.0, 1.0, 100)
    assert np.linalg.norm(tb.ev(kv, coeffs, x)
                          - tb.ev(kv2, P.dot(coeffs), x)) < 1e-10
