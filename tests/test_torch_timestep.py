"""The port's implicit time integrators (Newton, every DIRK and Rosenbrock
method and tableau), its direct solvers and the device Rosenbrock scheme,
held against the JAX package: identical step sequences on the stiff test
ODE of the JAX package's ``test_solvers`` and on the heat equation
``M u' = f - K u`` of a mapped domain, assembled by each package."""

import numpy as np
import pytest
import scipy.sparse
import torch

import pyiga_tpu.bspline as jbspline
import pyiga_tpu.geometry as jgeometry
from pyiga_tpu import assemble as jassemble
from pyiga_tpu import operators as joperators
from pyiga_tpu import solvers as jsolvers

from pyiga_tpu_torch import assemble, bspline, geometry, operators, solvers
from pyiga_tpu_torch.ops import fastdiag
from pyiga_tpu_torch.ops.rosw import DeviceRosenbrockScheme

torch.set_num_threads(1)

CONSTANT = ['crank_nicolson', 'sdirk3', 'sdirk3_b']
ADAPTIVE = ['sdirk21', 'dirk34', 'esdirk23', 'esdirk34', 'ros3p', 'ros3pw',
            'rowdaind2', 'rodasp', 'rosi2p1']
TABLEAUS = ['sdirk3', 'sdirk3_b', 'sdirk21', 'dirk34', 'esdirk23',
            'esdirk34', 'ros3p', 'ros3pw', 'rowdaind2', 'rodasp', 'rosi2p1']


def _stiff_ode():
    A = np.array([[0.0, 1.0], [-1000.0, -1001.0]])
    return np.eye(2), (lambda x: A.dot(x)), (lambda x: A), \
        np.array([1.0, 0.0])


def _heat(pkg, n=6, p=3):
    """Restricted heat equation of one package on the NURBS quarter
    annulus: ``(M_ff, F, J, x0, K_ff, f_f)``, scaled by ``n**2`` so that
    M's entries are O(1) (the DIRK stage Newton stops at an absolute
    residual of 1e-4)."""
    bs, geo, asm = ((bspline, geometry, assemble) if pkg == 'torch'
                    else (jbspline, jgeometry, jassemble))
    kw = dict(device='cpu') if pkg == 'torch' else {}
    kvs = 2 * (bs.make_knots(p, 0.0, 1.0, n),)
    scale = float(n * n)
    M = scale * asm.mass(kvs, geo.quarter_annulus(), **kw)
    K = scale * asm.stiffness(kvs, geo.quarter_annulus(), **kw)
    free = fastdiag.interior_dofs(kvs)
    Mf, Kf = M[free][:, free].tocsr(), K[free][:, free].tocsr()
    f = (M @ np.ones(M.shape[0]))[free]
    return Mf, (lambda x: f - Kf @ x), (lambda x: -Kf), \
        np.zeros(len(free)), Kf, f


def _run(pkg_solvers, name, problem, tau, tol):
    M, F, J, x0 = problem[:4]
    method = getattr(pkg_solvers, name)
    if name in CONSTANT:
        return method(M, F, J, x0, tau, 0.1 if tol else 1.0)
    return method(M, F, J, x0, tau, 0.1 if tol else 1.0, tol)


def test_newton():
    x = solvers.newton(lambda x: np.array([np.sin(x[0]) - 0.5]),
                       lambda x: np.array([[np.cos(x[0])]]), [0.0])
    assert np.allclose(x, np.pi / 6)
    with pytest.raises(solvers.NoConvergenceError) as info:
        solvers.newton(lambda x: np.array([x[0] ** 2 + 1.0]),
                       lambda x: np.array([[2.0 * x[0] + 1e-3]]), [1.0],
                       maxiter=5)
    assert info.value.num_iter == 5 and info.value.last_iterate.shape == (1,)


def test_ode():
    M, F, J, x0 = _stiff_ode()
    exsol = lambda t: -1 / 999 * np.exp(-1000 * t) + 1000 / 999 * np.exp(-t)
    t_end = 1.0
    sol_1 = exsol(t_end)
    sols = solvers.crank_nicolson(M, F, J, x0, 1e-2, t_end)
    assert np.isclose(sols[1][-1][0], sol_1, rtol=1e-4)
    sols = solvers.sdirk3(M, F, J, x0, 1e-2, t_end)
    assert np.isclose(sols[1][-1][0], sol_1, rtol=1e-4)
    sols = solvers.ros3p(M, F, J, x0, 1e-2, t_end, tol=None)
    assert np.isclose(sols[1][-1][0], sol_1, rtol=1e-4)
    sols = solvers.rodasp(M, F, J, x0, 1e-2, t_end, tol=None)
    assert np.isclose(sols[1][-1][0], sol_1, rtol=1e-3)
    ts, xs = solvers.esdirk34(M, F, J, x0, 1e-2, t_end, tol=1e-5)
    assert ts[-2] <= t_end <= ts[-1]
    from scipy.interpolate import interp1d
    x_end = interp1d(ts, xs, kind='cubic', axis=0)(t_end)
    assert np.isclose(x_end[0], sol_1, rtol=1e-4)


@pytest.mark.parametrize('name', TABLEAUS)
def test_tableaus_equal_jax(name):
    got = getattr(solvers, 'coeffs_' + name)()
    ref = getattr(jsolvers, 'coeffs_' + name)()
    got, ref = (got, ref) if isinstance(ref, tuple) else ((got,), (ref,))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert np.array_equal(np.asarray(a, dtype=float),
                              np.asarray(b, dtype=float))


@pytest.mark.parametrize('problem', ['stiff', 'heat'])
@pytest.mark.parametrize('name', CONSTANT + ADAPTIVE)
def test_methods_equal_jax(name, problem):
    """Every exported method against the JAX method on the same problem
    (the same host matrices): identical step counts, times to 1e-14."""
    if problem == 'stiff':
        prob, tau, tol = _stiff_ode(), 1e-2, None
    else:
        prob, tau, tol = _heat('torch'), 1e-3, 1e-5
    ts, xs = _run(solvers, name, prob, tau, tol)
    jts, jxs = _run(jsolvers, name, prob, tau, tol)
    assert getattr(solvers, name).__name__ == name
    assert len(ts) == len(jts) > 1
    assert np.abs(np.subtract(ts, jts)).max() <= 1e-14
    scale = np.abs(jxs[-1]).max()
    assert np.abs(xs[-1] - jxs[-1]).max() <= 1e-12 * scale


def test_step_wrappers_equal_jax():
    M, F, J, x0 = _stiff_ode()
    tab = solvers.coeffs_esdirk34()[0]
    a = solvers.dirk_step(tab, M, F, J, x0, 1e-2)
    b = jsolvers.dirk_step(tab, M, F, J, x0, 1e-2)
    for u, v in zip(a[:2], b[:2]):
        assert np.array_equal(u, v)
    A, G, bb, bh, _ = solvers.coeffs_ros3p()
    a = solvers.rosenbrock_step(A, G, bb, bh, M, F, J, x0, 1e-2, {})
    b = jsolvers.rosenbrock_step(A, G, bb, bh, M, F, J, x0, 1e-2, {})
    for u, v in zip(a[:2], b[:2]):
        assert np.array_equal(u, v)


@pytest.mark.parametrize('kind', ['sparse', 'spd', 'general'])
def test_make_solver_equals_jax(kind):
    rng = np.random.RandomState(7)
    B = rng.rand(12, 12) + 12 * np.eye(12)
    if kind == 'spd':
        B = B + B.T
    if kind == 'sparse':
        B = scipy.sparse.csr_matrix(np.where(np.abs(B) > 0.7, B, 0.0))
    kw = {'spd': kind == 'spd'}
    S, jS = operators.make_solver(B, **kw), joperators.make_solver(B, **kw)
    rhs = rng.rand(12, 3)
    assert isinstance(S, operators.SolverWrapper) and S.shape == (12, 12)
    assert np.array_equal(S.dot(rhs[:, 0]), jS.dot(rhs[:, 0]))
    assert np.array_equal(S.matmat(rhs), jS.matmat(rhs))
    assert np.abs(B @ S.dot(rhs[:, 0]) - rhs[:, 0]).max() < 1e-12
    assert solvers.make_solver is operators.make_solver


@pytest.mark.parametrize('name', ['esdirk34', 'ros3p'])
def test_heat_slice_matches_jax(name):
    """The small heat slice, each package assembling its own matrices:
    step times to 1e-12, final states to 1e-10."""
    Mf, F, J, x0 = _heat('torch')[:4]
    jMf, jF, jJ, jx0 = _heat('jax')[:4]
    ts, xs = getattr(solvers, name)(Mf, F, J, x0, 1e-3, 0.1, 1e-5)
    jts, jxs = getattr(jsolvers, name)(jMf, jF, jJ, jx0, 1e-3, 0.1, 1e-5)
    assert len(ts) == len(jts)
    assert np.abs(np.subtract(ts, jts)).max() <= 1e-12
    assert np.abs(xs[-1] - jxs[-1]).max() <= 1e-10 * np.abs(jxs[-1]).max()
    assert ts[-1] >= 0.1 and np.all(np.isfinite(xs[-1]))


class _Counting:
    """A scheme proxy that counts step attempts."""

    def __init__(self, scheme):
        self.scheme, self.attempts = scheme, 0

    def step(self, *args, **kwargs):
        self.attempts += 1
        return self.scheme.step(*args, **kwargs)

    def truncated(self):
        return self.scheme.truncated()


def _device_scheme(name, prob, **kwargs):
    Mf, F, J, x0, Kf, f = prob
    A, G, b, bh, order = getattr(solvers, 'coeffs_' + name)()
    ops = {'K': torch.as_tensor(Kf.toarray()), 'f': torch.as_tensor(f)}
    return DeviceRosenbrockScheme(
        (A, G, b, bh), lambda x, o: o['f'] - o['K'] @ x,
        lambda x, o: -o['K'], Mf.toarray(), ops,
        host_scheme=solvers._RosenbrockScheme(A, G, b, bh), device='cpu',
        **kwargs), order


@pytest.mark.parametrize('name,tol', [('ros3p', 1e-5), ('rodasp', 1e-7)])
def test_device_rosenbrock_matches_jax_host(name, tol):
    """``DeviceRosenbrockScheme`` on CPU tensors against the JAX package's
    host ``_RosenbrockScheme`` on the same matrices: the same accepted
    times (1e-12) and the same number of rejected attempts, no host
    fallback; also through the per-step protocol of
    ``_integrate_adaptive`` and the constant-step ``truncated`` form."""
    prob = _heat('torch')
    Mf, F, J, x0 = prob[:4]
    A, G, b, bh, order = jsolvers.__dict__['coeffs_' + name]()
    host = _Counting(jsolvers._RosenbrockScheme(A, G, b, bh))
    jts, jxs = jsolvers._integrate_adaptive(host, order, Mf, F, J, x0, 1e-3,
                                            0.1, tol)
    dev, order = _device_scheme(name, prob)
    ts, xs = dev.integrate_adaptive((Mf, F, J), x0, 1e-3, 0.1, tol, order)
    assert len(ts) == len(jts) and dev.n_attempts == host.attempts
    assert np.abs(np.subtract(ts, jts)).max() <= 1e-12
    assert np.abs(xs[-1] - jxs[-1]).max() <= 1e-9 * np.abs(jxs[-1]).max()
    ts2, xs2 = solvers._integrate_adaptive(dev, order, Mf, F, J, x0, 1e-3,
                                           0.1, tol)
    assert len(ts2) == len(jts)
    assert np.abs(np.subtract(ts2, jts)).max() <= 1e-12
    const = dev.truncated()
    cts, cxs = solvers._integrate_constant(const, Mf, F, J, x0, 1e-2, 0.05)
    jcts, jcxs = jsolvers._integrate_constant(host.truncated(), Mf, F, J,
                                              x0, 1e-2, 0.05)
    assert len(cts) == len(jcts)
    assert np.abs(cxs[-1] - jcxs[-1]).max() <= 1e-9 * np.abs(jcxs[-1]).max()
    assert dev.host_fallbacks == 0 and const.host_fallbacks == 0


def test_device_rosenbrock_counts_host_fallback():
    """A stage solve that cannot reach ``solve_tol`` hands the step to the
    host scheme, and the hand-over is counted."""
    prob = _heat('torch')
    Mf, F, J, x0 = prob[:4]
    dev, _ = _device_scheme('ros3p', prob, solve_tol=0.0, refine_maxiter=2)
    xnew, xhat, _ = dev.step(Mf, F, J, x0, 1e-3)
    assert dev.host_fallbacks == 1
    ref = solvers._RosenbrockScheme(*solvers.coeffs_ros3p()[:4]).step(
        Mf, F, J, x0, 1e-3)
    assert np.array_equal(xnew, ref[0]) and np.array_equal(xhat, ref[1])
    no_host = DeviceRosenbrockScheme(
        solvers.coeffs_ros3p()[:4], lambda x, o: o['f'] - o['K'] @ x,
        lambda x, o: -o['K'], Mf.toarray(), dev._ops, solve_tol=0.0,
        refine_maxiter=1, device='cpu')
    with pytest.raises(RuntimeError):
        no_host.step(Mf, F, J, x0, 1e-3)
