"""The PyTorch port's convection-diffusion slice — VForm assembly,
Dirichlet restriction, the fast-diagonalization preconditioner and
restarted GMRES — held against the JAX package: identical GMRES
iteration counts, and the solution of ``examples/convection_diffusion.py``.
Also checks that the slice runs without loading jax."""

import os
import subprocess
import sys

import numpy as np
import torch

import jax.numpy as jnp

import pyiga_tpu.bspline as jbspline
from pyiga_tpu import solvers as jsolvers
from pyiga_tpu.ops import fastdiag as jfastdiag

from pyiga_tpu_torch import assemble, bspline, geometry, solvers
from pyiga_tpu_torch.ops import fastdiag, matfree
from pyiga_tpu_torch.ops.mlmatvec import make_ml_matvec

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BENCH_FORM = '(inner(grad(u), grad(v)) + dot(b, grad(u)) * v + u * v) * dx'
EXAMPLE_FORM = '(eps * inner(grad(u), grad(v)) + dot(b, grad(u)) * v) * dx'


def _solve(form, n, p=3, **args):
    """The port's slice: assemble A and f, restrict to the interior dofs,
    GMRES(30) to 1e-10 with the fastdiag preconditioner."""
    kvs = 2 * (bspline.make_knots(p, 0.0, 1.0, n),)
    geo = geometry.quarter_annulus()
    A = assemble.assemble(form, kvs, geo=geo, format='mlb', device='cpu',
                          **args)
    f = assemble.assemble('v * dx', kvs, geo=geo, device='cpu')
    free = fastdiag.interior_dofs(kvs)
    op = matfree.RestrictedOperator(make_ml_matvec(A, device='cpu'), free)
    b = torch.as_tensor(f.ravel()[free])
    P = fastdiag.fastdiag_precond(kvs, dirichlet=True, device='cpu')
    x, it = solvers.gmres(op, b, tol=1e-10, restart=30, precond=P)
    return A, f, free, x, it


def test_gmres_iterations_match_jax():
    """Same restricted operator and right-hand side in both packages:
    the same total count of inner iterations, x within 1e-9."""
    n = 10
    A, f, free, x, it = _solve(BENCH_FORM, n, b=np.array([3.0, -2.0]))
    Aff = A.asmatrix()[free][:, free]
    ff = f.ravel()[free]
    K = jnp.asarray(Aff.toarray())
    jP = jfastdiag.fastdiag_precond(
        2 * (jbspline.make_knots(3, 0.0, 1.0, n),), dirichlet=True)
    jx, jit = jsolvers.gmres_jit(lambda v: K @ v, jnp.asarray(ff),
                                 tol=1e-10, restart=30, precond=jP)
    assert it == int(jit) and it > 30         # more than one restart cycle
    jx = np.asarray(jx)
    assert np.abs(x.numpy() - jx).max() <= 1e-9 * np.abs(jx).max()
    assert np.linalg.norm(Aff @ x.numpy() - ff) <= 1e-10 * np.linalg.norm(ff)
    r = np.random.RandomState(2).rand(len(free))
    z = fastdiag.fastdiag_precond(2 * (bspline.make_knots(
        3, 0.0, 1.0, n),), dirichlet=True,
        device='cpu')(torch.as_tensor(r)).numpy()
    jz = np.asarray(jP(jnp.asarray(r)))
    assert np.abs(z - jz).max() <= 1e-12 * np.abs(jz).max()


def test_slice_matches_convection_diffusion_example(monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(REPO, 'examples'))
    import convection_diffusion
    u_ref = convection_diffusion.main(n=12)
    A, f, free, x, it = _solve(EXAMPLE_FORM, 12, eps=0.05,
                               b=np.array([3.0, -1.0]))
    u = np.zeros(A.shape[0])
    u[free] = x.numpy()
    u = u.reshape(u_ref.shape)
    assert np.abs(u - u_ref).max() <= 1e-9 * np.abs(u_ref).max()


def test_slice_runs_without_jax():
    code = ('import sys, numpy as np\n'
            'from pyiga_tpu_torch import assemble, bspline, geometry, '
            'solvers\n'
            'from pyiga_tpu_torch.ops import fastdiag, matfree\n'
            'from pyiga_tpu_torch.ops.mlmatvec import make_ml_matvec\n'
            'kvs = 2 * (bspline.make_knots(2, 0.0, 1.0, 4),)\n'
            'geo = geometry.quarter_annulus()\n'
            'A = assemble.assemble(%r, kvs, geo=geo, b=np.ones(2), '
            'format="mlb", device="cpu")\n'
            'f = assemble.assemble("v * dx", kvs, geo=geo, device="cpu")\n'
            'free = fastdiag.interior_dofs(kvs)\n'
            'import torch\n'
            'x, it = solvers.gmres(matfree.RestrictedOperator('
            'make_ml_matvec(A, device="cpu"), free), '
            'torch.as_tensor(f.ravel()[free]), '
            'precond=fastdiag.fastdiag_precond(kvs, dirichlet=True, '
            'device="cpu"))\n'
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "pyiga_tpu")]\n'
            'assert not bad and it > 0, bad\n' % BENCH_FORM)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, '-c', code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
