# -*- coding: utf-8 -*-
"""Krylov solvers of the port (counterparts of :func:`pyiga_tpu.solvers.
cg_jit`, :func:`pyiga_tpu.solvers.cg_ir` and
:func:`pyiga_tpu.solvers.gmres_jit`).

The loops run eagerly: each iteration reads its convergence test back to
the host (one synchronization per iteration).  Operators and
preconditioners are callables on raveled tensors.  The iteration logic —
test before each step, the same updates, the same stopping rules — is the
JAX package's, so iteration counts agree.
"""

import math

import numpy as np
import scipy.linalg
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


def gmres(matvec, b, x0=None, tol=1e-8, restart=30, max_restarts=100,
          precond=None):
    """Right-preconditioned restarted GMRES(m): Arnoldi with classical
    Gram-Schmidt and one reorthogonalization pass (CGS2), Givens
    rotations, and the TRUE residual checked after every restart cycle.

    Each inner iteration sends its Hessenberg column to the host (one
    synchronization), where the rotations run in float64 and the cycle
    exits once ``|g_{j+1}| <= tol * ||b||``.  Returns ``(x, iterations)``
    with the total count of inner iterations (``inf`` if `tol` was not
    reached within `max_restarts` cycles)."""
    pc = precond if precond is not None else (lambda r: r)
    x = torch.zeros_like(b) if x0 is None else x0
    abs_tol = tol * float(torch.linalg.vector_norm(b))
    total = 0
    for _ in range(max_restarts):
        x, j_eff, res = _gmres_cycle(matvec, pc, b, x, restart, abs_tol)
        total += j_eff
        if res <= abs_tol:
            return x, total
    return x, math.inf


def _gmres_cycle(matvec, pc, b, x0, m, abs_tol, eps_break=1e-30):
    """One GMRES(m) cycle from `x0`; returns ``(x, inner iterations, true
    residual norm)``."""
    r0 = b - matvec(x0)
    beta = float(torch.linalg.vector_norm(r0))
    V = torch.zeros((m + 1, b.shape[0]), dtype=b.dtype, device=b.device)
    V[0] = r0 / max(beta, eps_break)
    H = np.zeros((m + 1, m))
    cs, sn = np.ones(m), np.zeros(m)
    g = np.zeros(m + 1)
    g[0] = beta
    j_eff = 0
    done = beta <= abs_tol
    while not done and j_eff < m:
        j = j_eff
        w = matvec(pc(V[j]))
        Vj = V[:j + 1]
        h = Vj @ w
        w = w - Vj.T @ h
        h2 = Vj @ w
        w = w - Vj.T @ h2
        wnorm = torch.linalg.vector_norm(w)
        V[j + 1] = w / wnorm.clamp_min(eps_break)
        hcol = np.zeros(m + 1)
        hcol[:j + 2] = torch.cat([h + h2, wnorm.reshape(1)]).tolist()
        for i in range(j):          # the previous rotations
            hi = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
            hcol[i + 1] = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
            hcol[i] = hi
        denom = math.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
        cs[j] = hcol[j] / max(denom, eps_break)
        sn[j] = hcol[j + 1] / max(denom, eps_break)
        hcol[j], hcol[j + 1] = denom, 0.0
        H[:, j] = hcol
        g[j + 1] = -sn[j] * g[j]
        g[j] = cs[j] * g[j]
        j_eff = j + 1
        done = abs(g[j + 1]) <= abs_tol
    x = x0
    if j_eff:
        y = scipy.linalg.solve_triangular(H[:j_eff, :j_eff], g[:j_eff])
        x = x0 + pc(V[:j_eff].T @ torch.as_tensor(y, dtype=b.dtype,
                                                  device=b.device))
    res = float(torch.linalg.vector_norm(b - matvec(x)))
    return x, j_eff, res
