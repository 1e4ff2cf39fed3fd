# -*- coding: utf-8 -*-
"""Steady convection-diffusion on a quarter annulus over
:mod:`pyiga_tpu_torch` (the port of ``examples/convection_diffusion.py``):
VForm assembly on `device` (K1 ``jac``, K5, K2 and K3 on the card) and
right-preconditioned restarted GMRES (:func:`~pyiga_tpu_torch.solvers.
gmres_jit`) on the card.

    -eps * div(grad(u)) + b . grad(u) = 1   in Omega,   u = 0 on bd(Omega)

Run ``python examples/torch_convection_diffusion.py`` on a machine with a
CUDA card, or ``python examples/torch_convection_diffusion.py cpu`` on the
CPU."""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from pyiga_tpu_torch import assemble, bspline, geometry, solvers  # noqa
from pyiga_tpu_torch.config import resolve_device  # noqa: E402
from pyiga_tpu_torch.ops.fastdiag import (  # noqa: E402
    fastdiag_precond, interior_dofs)


def main(p=3, n=24, eps=0.05, b=(3.0, -1.0), device=None):
    """Solve with `n` elements per axis and degree `p`; returns the
    solution on the full dof grid (numpy) and the two GMRES counts."""
    device = resolve_device(device)
    kvs = 2 * (bspline.make_knots(p, 0.0, 1.0, n),)
    geo = geometry.quarter_annulus()
    b = np.asarray(b, dtype=float)

    A = assemble.assemble(
        '(eps * inner(grad(u), grad(v)) + dot(b, grad(u)) * v) * dx',
        kvs, geo=geo, eps=eps, b=b, device=device)
    f = assemble.assemble('v * dx', kvs, geo=geo, device=device)

    # homogeneous Dirichlet: restrict to the interior dofs
    free = interior_dofs(kvs)
    Aff = A.tocsr()[free][:, free]
    ff = np.asarray(f).ravel()[free]

    Adj = torch.as_tensor(Aff.toarray(), device=device)

    def matvec(v):
        return Adj @ v
    # fast diagonalization of the symmetric part as right preconditioner
    P = fastdiag_precond(kvs, dirichlet=True, device=device)

    fd = torch.as_tensor(ff, device=device)
    x, it = solvers.gmres_jit(matvec, fd, tol=1e-10, restart=30, precond=P)
    xu, itu = solvers.gmres_jit(matvec, fd, tol=1e-10, restart=30)
    x = x.cpu().numpy()
    res = np.linalg.norm(Aff @ x - ff) / np.linalg.norm(ff)
    print('dofs: %d   GMRES iters: %s (preconditioned) vs %s (plain)'
          % (len(free), it, itu))
    print('relative residual: %.2e' % res)
    assert res < 1e-9
    assert it < itu

    u = np.zeros(A.shape[0])
    u[free] = x
    umax = u.max()
    print('max u = %.5f (boundary layer at the outflow side)' % umax)
    return u.reshape(tuple(kv.numdofs for kv in kvs)), (it, itu)


if __name__ == '__main__':
    main(device=sys.argv[1] if len(sys.argv) > 1 else None)
