# -*- coding: utf-8 -*-
"""Krylov solvers of the port (counterparts of :func:`pyiga_tpu.solvers.
cg_jit` and :func:`pyiga_tpu.solvers.cg_ir`).

The loops run eagerly: each iteration reads its convergence test back to
the host (one synchronization per iteration).  Operators and
preconditioners are callables on raveled tensors.  The iteration logic —
test before each step, the same updates, the same stopping rules — is the
JAX package's, so iteration counts agree.
"""

import torch


def cg(matvec, b, tol=1e-8, maxiter=1000, precond=None):
    """Preconditioned conjugate gradients from a zero start; stops when
    ``||r|| <= tol * ||b||`` or after `maxiter` steps.  Works in the dtype
    of `b`.  Returns ``(x, iterations)``."""
    pc = precond if precond is not None else (lambda r: r)
    x, r = torch.zeros_like(b), b
    stop = tol * torch.linalg.vector_norm(r)
    z = pc(r)
    p = z
    rz = torch.dot(r, z)
    it = 0
    while it < maxiter and bool(torch.linalg.vector_norm(r) > stop):
        Ap = matvec(p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = pc(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        it += 1
    return x, it


def cg_ir(op_hi, op_lo, b, tol=1e-8, maxiter_inner=200, max_outer=10,
          precond_lo=None, inner_tol=1e-3):
    """Mixed-precision CG with iterative refinement: float32 Krylov solves
    with `op_lo` (and `precond_lo`) correct a float64 iterate whose
    residuals `op_hi` computes in float64.

    Args:
        op_hi: float64 operator.
        op_lo: float32 operator for the inner solves.
        b: float64 right-hand side.
        tol: relative residual target in float64.
        inner_tol: residual reduction per inner solve (a loose one is
            usually optimal: each outer step's gain is capped by float32).

    Returns ``(x, info)`` with ``info = {'outer', 'inner_iters',
    'residual'}`` (``residual`` relative to ``||b||``)."""
    b = b.to(torch.float64)
    norm_b = torch.linalg.vector_norm(b)
    x = torch.zeros_like(b)
    r = b
    res = norm_b
    outer, inner_iters = 0, []
    while bool(res > tol * norm_b) and outer < max_outer:
        d, it = cg(op_lo, r.to(torch.float32), tol=inner_tol,
                   maxiter=maxiter_inner, precond=precond_lo)
        x = x + d.to(torch.float64)
        r = b - op_hi(x)
        res = torch.linalg.vector_norm(r)
        inner_iters.append(it)
        outer += 1
    return x, {'outer': outer, 'inner_iters': inner_iters,
               'residual': float(res / norm_b)}
