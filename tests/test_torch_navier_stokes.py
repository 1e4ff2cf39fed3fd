"""The port's Navier-Stokes and Stokes examples
(``examples/torch_navier_stokes.py``, ``examples/torch_stokes.py``) held
against the JAX package's (``examples/navier_stokes.py``) in float64 on
the CPU at ``n_el=(5, 8)``: the blocks, the initial state, ``F`` and
``J`` on the host and by the device stepper's functions, and the
ROWDAIND2 step sequence of the port's host and device schemes against
JAX's host scheme."""

import functools
import importlib.util as ilu
import os

import numpy as np
import pytest
import scipy.sparse
import torch

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(__file__), '..', 'examples')
N_EL = (5, 8)


def _load(name, fname):
    spec = ilu.spec_from_file_location(name, os.path.join(EXAMPLES, fname))
    mod = ilu.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _pair():
    """(port NS on the CPU, JAX NS, JAX's initial state)."""
    jns = _load('jax_navier_stokes', 'navier_stokes.py').NavierStokes(
        n_el=N_EL, p=2, Re=20.0)
    ns = _load('torch_navier_stokes', 'torch_navier_stokes.py').NavierStokes(
        n_el=N_EL, p=2, Re=20.0, device='cpu')
    return ns, jns, jns.initial_state()


def _rel(got, ref):
    got = got.toarray() if scipy.sparse.issparse(got) else np.asarray(got)
    ref = ref.toarray() if scipy.sparse.issparse(ref) else np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


def _state(x0):
    return x0 + 0.01 * np.random.RandomState(0).rand(len(x0))


@pytest.mark.parametrize('name', ['A_grad', 'M_vel', 'A_div', 'M_pre',
                                  'A_stokes', 'ns_M'])
def test_blocks_match_jax(name):
    ns, jns, _ = _pair()
    assert _rel(getattr(ns, name), getattr(jns, name)) <= 1e-13


def test_setup_matches_jax():
    ns, jns, x0 = _pair()
    assert (ns.n_u, ns.n_p) == (jns.n_u, jns.n_p) == (2 * 7 * 10, 6 * 9)
    assert ns.A_div.shape == (ns.n_p, ns.n_u)
    for a, b in zip(ns.bcs, jns.bcs):
        assert np.array_equal(a, b) if a.dtype.kind in 'iu' \
            else np.abs(a - b).max() < 1e-14
    assert _rel(ns.initial_state(), x0) <= 1e-12
    assert ns.divergence_norm(x0) < 1e-10


@pytest.mark.parametrize('route', ['host', 'device'])
def test_F_and_J_match_jax(route):
    """``F`` to 1e-13 and ``J`` to 1e-12 at a seeded state, by the host
    methods and by the device stepper's ``F_fn`` / ``J_fn`` (on CPU
    tensors)."""
    ns, jns, x0 = _pair()
    x = _state(x0)
    Fref, Jref = jns.F(x), jns.J(x)
    if route == 'host':
        F, J = ns.F(x), ns.J(x)
    else:
        F_fn, J_fn, ops = ns._traceable_ops()
        xt = torch.as_tensor(x)
        F, J = F_fn(xt, ops).numpy(), J_fn(xt, ops).numpy()
    assert _rel(F, Fref) <= 1e-13
    assert _rel(J, Jref) <= 1e-12


@pytest.mark.parametrize('backend', ['host', 'device'])
def test_rowdaind2_step_sequence_matches_jax(backend):
    """ROWDAIND2 to t_end 0.25 (tau 5e-2, tol 1e-2): JAX's host step
    count and times to 1e-9, on the port's host scheme and on its device
    scheme (run on the CPU) with no host fallback."""
    ns, jns, x0 = _pair()
    th, sh = jns.integrate(x0=x0, tau=5e-2, t_end=0.25, backend='host')
    t, s = ns.integrate(x0=x0, tau=5e-2, t_end=0.25, backend=backend)
    assert ns.last_backend == backend
    assert len(t) == len(th) and max(abs(a - b) for a, b in zip(t, th)) \
        < 1e-9
    for a, b in zip(s, sh):
        assert np.linalg.norm(a - b) / np.linalg.norm(b) < 1e-10
    assert ns.divergence_norm(s[-1]) < 1e-10
    if backend == 'device':
        assert ns._dev_scheme[1].host_fallbacks == 0


@pytest.mark.parametrize('host_fallback', [False, True])
def test_device_scheme_host_fallback_is_opt_in(host_fallback):
    """Stage solves that can never reach ``solve_tol``: by default the
    device scheme raises (it never leaves the device); with
    ``host_fallback=True`` every step goes to the host scheme, is
    counted, and gives the host's step sequence."""
    ns, _, x0 = _pair()
    scheme, _ = ns._device_scheme('rowdaind2', host_fallback)
    assert (scheme._host_scheme is not None) == host_fallback
    saved = scheme.solve_tol, scheme.refine_maxiter
    scheme.solve_tol, scheme.refine_maxiter = -1.0, 0
    try:
        if not host_fallback:
            with pytest.raises(RuntimeError, match='no host fallback'):
                ns.integrate(x0=x0, tau=5e-2, t_end=0.1, backend='device')
            return
        t, s = ns.integrate(x0=x0, tau=5e-2, t_end=0.1, backend='device',
                            host_fallback=True)
    finally:
        scheme.solve_tol, scheme.refine_maxiter = saved
    th, sh = ns.integrate(x0=x0, tau=5e-2, t_end=0.1, backend='host')
    assert scheme.host_fallbacks == len(t) - 1 > 0
    assert t == th
    for a, b in zip(s, sh):
        assert np.array_equal(a, b)


@pytest.mark.parametrize('backend', ['host', 'device'])
def test_ros3pw_constant_step_matches_jax(backend):
    ns, jns, x0 = _pair()
    th, sh = jns.integrate(x0=x0, tau=0.1, t_end=0.2, method='ros3pw',
                           tol=None, backend='host')
    t, s = ns.integrate(x0=x0, tau=0.1, t_end=0.2, method='ros3pw',
                        tol=None, backend=backend)
    assert t == th
    for a, b in zip(s, sh):
        assert np.linalg.norm(a - b) / np.linalg.norm(b) < 1e-10
    assert ns.divergence_norm(s[-1]) < 1e-10


def test_auto_backend_on_the_cpu_is_host():
    ns, _, x0 = _pair()
    ns.integrate(x0=x0, tau=5e-2, t_end=5e-2)
    assert ns.last_backend == 'host'
    with pytest.raises(ValueError):
        ns.integrate(x0=x0, backend='tpu')


def test_torch_stokes_main():
    """``torch_stokes.main`` on the CPU: divergence below 1e-10, the
    Poiseuille profile to 1e-6 and a linear pressure (its asserts), and
    the velocity of the JAX example's Stokes solve."""
    import sys
    sys.path.insert(0, os.path.abspath(EXAMPLES))
    try:
        stokes = _load('torch_stokes', 'torch_stokes.py')
    finally:
        sys.path.remove(os.path.abspath(EXAMPLES))
    vel, pres = stokes.main(p=2, n_el=(4, 6), device='cpu')
    jns = _load('jax_navier_stokes', 'navier_stokes.py').NavierStokes(
        n_el=(4, 6), p=2, Re=1.0)
    jvel, _ = jns.get_components(jns.LS.complete(jns.initial_state()))
    assert np.abs(vel.coeffs - jvel.coeffs).max() < 1e-12
