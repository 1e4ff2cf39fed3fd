# -*- coding: utf-8 -*-
"""Nonlinear Poisson with a Jacobian by automatic differentiation of the
assembly, over :mod:`pyiga_tpu_torch` (the port of
``examples/nonlinear_poisson.py``; it assembles on `device`, the card
unless ``'cpu'`` is given).

    -div((1 + u^2) grad u) = 1   in the quarter annulus,   u = 0 on bd.

The Newton residual is the assembled functional
``(1 + w*w) * inner(grad(w), grad(v)) * dx`` (w = current iterate), and
the Jacobian is **torch.func.jacfwd of the assembly itself**
(pyiga_tpu_torch.diff.assembly_input_fn), as the JAX example's
``jax.jacfwd``: forward mode, one tangent per dof, through the kernels'
forward-mode rules (on the card K5's generated tangent program, K2 and K3
on the tangents).  No hand-derived linearized form, and Newton converges
quadratically on the exact discrete Jacobian.

Run ``python examples/torch_nonlinear_poisson.py`` on a machine with a
CUDA card, or ``python examples/torch_nonlinear_poisson.py cpu``."""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))


def main(p=2, n=8, tol=1e-12, device=None):
    from pyiga_tpu_torch import assemble, bspline, geometry, solvers
    from pyiga_tpu_torch.diff import assembly_input_fn
    from pyiga_tpu_torch.ops.fastdiag import interior_dofs

    kvs = 2 * (bspline.make_knots(p, 0.0, 1.0, n),)
    geo = geometry.quarter_annulus()
    N = int(np.prod([kv.numdofs for kv in kvs]))
    free = np.asarray(interior_dofs(kvs))

    # residual R(c) = A(c) c - f, assembled as one nonlinear functional
    w0 = geometry.BSplineFunc(kvs, np.zeros([kv.numdofs for kv in kvs]))
    asm = assemble.instantiate_assembler(
        '(1 + w*w) * inner(grad(w), grad(v)) * dx', kvs,
        {'geo': geo, 'w': w0}, None, None, device=device)
    dev = asm.device
    resid_fn, c0 = assembly_input_fn(asm, 'w')
    f = np.asarray(assemble.inner_products(
        kvs, lambda *x: np.ones_like(x[0]), geo=geo)).reshape(-1)

    shape = c0.shape

    def full(xf):
        c = torch.zeros(N, dtype=torch.float64, device=dev)
        c[torch.as_tensor(free, device=dev)] = torch.as_tensor(
            xf, dtype=torch.float64, device=dev)
        return c

    def F_free(xf):
        with torch.no_grad():
            r = resid_fn(full(xf).reshape(shape))
        return r.cpu().numpy().reshape(-1)[free] - f[free]

    def J_free(xf):
        jac = torch.func.jacfwd(
            lambda c: resid_fn(c.reshape(shape)).reshape(-1))(full(xf))
        return jac.cpu().numpy()[np.ix_(free, free)]

    # quadratic convergence from the exact discrete Jacobian
    norms = []

    def F_logged(xf):
        r = F_free(xf)
        norms.append(float(np.linalg.norm(r)))
        return r

    u_free = solvers.newton(F_logged, J_free, np.zeros(len(free)),
                            atol=tol, rtol=0.0, maxiter=25)
    res_norm = float(np.linalg.norm(F_free(u_free)))
    print('newton residual norms:',
          ' '.join('%.2e' % r for r in norms + [res_norm]))
    assert res_norm < tol

    u = np.zeros(N)
    u[free] = u_free
    ufun = geometry.BSplineFunc(kvs, u.reshape(shape))
    umax = float(np.abs(ufun.grid_eval(2 * (np.linspace(0, 1, 30),))).max())
    print('max |u| = %.6f' % umax)
    assert 0.01 < umax < 1.0
    return norms, umax


if __name__ == '__main__':
    main(device=sys.argv[1] if len(sys.argv) > 1 else None)
