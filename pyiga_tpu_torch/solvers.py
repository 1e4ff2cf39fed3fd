# -*- coding: utf-8 -*-
"""Solvers of the port: the Krylov solvers (counterparts of
:func:`pyiga_tpu.solvers.cg_jit`, :func:`pyiga_tpu.solvers.cg_ir` and
:func:`pyiga_tpu.solvers.gmres_jit`) and the local multigrid solver of
hierarchical spaces (:func:`solve_hmultigrid`, with its host path
:func:`local_mg_step` + :func:`iterative_solve` and its device path
:class:`~pyiga_tpu_torch.ops.mg.DeviceMGSolver`).

The loops run eagerly: each iteration reads its convergence test back to
the host (one synchronization per iteration).  Operators and
preconditioners are callables on raveled tensors.  The iteration logic —
test before each step, the same updates, the same stopping rules — is the
JAX package's, so iteration counts agree.
"""

import hashlib
import math

import numpy as np
import scipy.linalg
import scipy.sparse
import scipy.sparse.linalg
import torch

from . import native
from .config import resolve_device
from .ops.mg import _SWEEP_DIRS, DeviceMGSolver


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


################################################################################
# Smoothers and the local multigrid solver of hierarchical spaces
################################################################################

def gauss_seidel(A, x, b, iterations=1, indices=None, sweep='forward'):
    """Gauss-Seidel relaxation on ``Ax = b``, updating `x` in place.

    Forward/backward full sweeps, or sweeps restricted to `indices` in the
    given order (reversed for a backward sweep); the sequential visit
    order is the numerical contract.  A sparse `A` runs the native C++
    sweep (:mod:`pyiga_tpu_torch.native`)."""
    try:
        passes = _SWEEP_DIRS[sweep]
    except KeyError:
        raise ValueError("valid sweep directions are 'forward', 'backward',"
                         " and 'symmetric'")

    if scipy.sparse.issparse(A):
        A = scipy.sparse.csr_matrix(A)
        for _ in range(iterations):
            for reverse in passes:
                if indices is not None:
                    native.gauss_seidel_sweep_indexed(A, x, b, indices,
                                                      reverse=reverse)
                else:
                    native.gauss_seidel_sweep(A, x, b, reverse=reverse)
        return

    # dense matrix: strictly sequential update, same visit order
    order = list(range(A.shape[0]) if indices is None else indices)
    for _ in range(iterations):
        for reverse in passes:
            for i in (reversed(order) if reverse else order):
                diag = A[i, i]
                if diag == 0.0:         # zero diagonal: skip the row
                    continue
                off_diag = A[i].dot(x) - diag * x[i]
                x[i] = (b[i] - off_diag) / diag


def make_solver(B):
    """A :class:`scipy.sparse.linalg.LinearOperator` applying ``B^{-1}`` by
    a sparse LU factorization (SuperLU, COLAMD ordering): the coarse
    solves of :func:`local_mg_step`."""
    solve = scipy.sparse.linalg.splu(scipy.sparse.csc_matrix(B),
                                     permc_spec='COLAMD').solve
    return scipy.sparse.linalg.LinearOperator(B.shape, matvec=solve,
                                              matmat=solve, dtype=B.dtype)


# Smoother catalog of the local MG V-cycle: the sweep directions of the
# pre- and post-smoothing halves.  'exact' replaces smoothing by an
# additive exact solve on the smoothing index set.
_MG_SWEEPS = {
    'gs': ('forward', 'backward'),
    'forward_gs': ('forward', 'forward'),
    'backward_gs': ('backward', 'backward'),
    'symmetric_gs': ('symmetric', 'symmetric'),
    'exact': (None, None),
}


def galerkin_hierarchy(A, Ps):
    """The Galerkin matrices ``As[L-1] = A``, ``As[lv] = Ps[lv]^T
    As[lv+1] Ps[lv]`` (CSR) of the virtual hierarchy with prolongators
    `Ps`."""
    L = len(Ps) + 1
    As = [None] * L
    As[L - 1] = scipy.sparse.csr_matrix(A)
    for lv in range(L - 2, -1, -1):
        As[lv] = (Ps[lv].T @ As[lv + 1] @ Ps[lv]).tocsr()
    return As


def local_mg_step(hs, A, f, Ps, lv_inds, smoother='symmetric_gs',
                  smooth_steps=2, relax_backend='host'):
    """One V-cycle of the local multigrid method on the virtual hierarchy
    of the HB/THB space `hs`; smoothing is restricted to the per-level
    index sets `lv_inds`.  Returns a function ``step(x)`` (host numpy).

    Explicit descend/ascend passes over the Galerkin coarse matrices;
    the operation order (pre-smooth, restrict, coarse solve, prolongate,
    post-smooth, with strictly sequential Gauss-Seidel sweeps) fixes the
    iteration counts.  `relax_backend` ``'host'`` runs the native CSR
    sweeps; the stepwise device smoother (``'device'``, the JAX package's
    ``ops/relax.DeviceIndexedGS``) is not ported yet: the device path of
    this solver is the whole-solve :func:`solve_hmultigrid`."""
    if smoother not in _MG_SWEEPS:
        raise ValueError('Invalid smoother')
    if relax_backend not in ('host', 'device', 'auto'):
        raise ValueError("relax_backend must be 'host', 'device' or 'auto'")
    if relax_backend == 'device' and smoother != 'exact':
        raise NotImplementedError(
            "the stepwise device smoother of local_mg_step "
            "(ops/relax.DeviceIndexedGS) is not ported yet; "
            "solve_hmultigrid(relax_backend='device') runs the whole "
            "solve on the device")
    pre_sweep, post_sweep = _MG_SWEEPS[smoother]
    L = hs.numlevels
    As = galerkin_hierarchy(A, Ps)

    exact_on = range(L) if smoother == 'exact' else (0,)
    direct = {lv: make_solver(As[lv][lv_inds[lv]][:, lv_inds[lv]])
              for lv in exact_on}

    def relax(lv, x, rhs, sweep):
        if sweep is not None:
            gauss_seidel(As[lv], x, rhs, indices=lv_inds[lv],
                         iterations=smooth_steps, sweep=sweep)

    def vcycle(x, rhs):
        # descend: smooth and collect restricted residuals per level
        xs, rhss = [None] * L, [None] * L
        xs[L - 1], rhss[L - 1] = x.copy(), rhs
        for lv in range(L - 1, 0, -1):
            if smoother == 'exact':
                ind = lv_inds[lv]
                r = (rhss[lv] - As[lv] @ xs[lv])[ind]
                xs[lv][ind] += direct[lv] @ r
            else:
                relax(lv, xs[lv], rhss[lv], pre_sweep)
            rhss[lv - 1] = Ps[lv - 1].T @ (rhss[lv] - As[lv] @ xs[lv])
            xs[lv - 1] = np.zeros_like(rhss[lv - 1])

        # coarsest level: exact solve on its smoothing set
        ind0 = lv_inds[0]
        xs[0][ind0] = direct[0] @ rhss[0][ind0]

        # ascend: prolongate corrections and post-smooth
        for lv in range(1, L):
            xs[lv] += Ps[lv - 1] @ xs[lv - 1]
            relax(lv, xs[lv], rhss[lv], post_sweep)
        return xs[L - 1]

    return lambda x: vcycle(x, f)


def iterative_solve(step, A, f, x0=None, active_dofs=None, tol=1e-8,
                    maxiter=5000):
    """Run the iteration ``x <- step(x)`` until the residual of ``Ax = f``
    (restricted to `active_dofs`) is reduced by `tol`.  Returns
    ``(x, iterations)`` with ``iterations = inf`` on non-convergence."""
    sel = slice(None) if active_dofs is None else active_dofs
    x = np.zeros(A.shape[0]) if x0 is None else x0
    r = f if x0 is None else f - A @ x
    res0 = scipy.linalg.norm(r[sel])
    for it in range(1, maxiter + 1):
        x = step(x)
        res = scipy.linalg.norm((f - A @ x)[sel])
        # keep the exact comparison form: iteration counts are a contract
        if res / res0 < tol:
            return x, it
    print('Warning: iterative solver did not converge in'
          ' {} iterations'.format(maxiter))
    return x, np.inf


# device MG solvers keyed by problem identity (bounded; entries pin their
# hs/A so the ids stay valid): a repeated solve of one system skips the
# host build of the triangular inverses and the operand uploads
_DEVICE_MG_CACHE = {}


def _device_mg_solver(hs, A, strategy, smoother, smooth_steps, device):
    Acsr = scipy.sparse.csr_matrix(A)
    # key on the matrix CONTENT, not just its identity: a matrix changed
    # in place between solves must not reuse the stale uploaded hierarchy
    h = hashlib.blake2b(digest_size=16)
    for part in (Acsr.indptr, Acsr.indices, Acsr.data):
        h.update(np.ascontiguousarray(part).tobytes())
    key = (id(hs), h.digest(), strategy, smoother, smooth_steps, str(device))
    hit = _DEVICE_MG_CACHE.get(key)
    if hit is not None and hit[0] is hs:
        return hit[2]
    Ps = hs.virtual_hierarchy_prolongators()
    solver = DeviceMGSolver(galerkin_hierarchy(Acsr, Ps), Ps,
                            hs.indices_to_smooth(strategy),
                            _MG_SWEEPS[smoother], smooth_steps,
                            active_dofs=hs.non_dirichlet_dofs(),
                            device=device)
    if len(_DEVICE_MG_CACHE) >= 4:
        _DEVICE_MG_CACHE.pop(next(iter(_DEVICE_MG_CACHE)))
    _DEVICE_MG_CACHE[key] = (hs, A, solver)
    return solver


def solve_hmultigrid(hs, A, f, strategy='cell_supp', smoother='gs',
                     smooth_steps=2, tol=1e-8, maxiter=5000,
                     relax_backend='auto', device=None):
    """Solve a scalar problem on an HB-/THB-spline space by local multigrid.

    `strategy` selects the smoothing index sets ('new', 'trunc',
    'func_supp', 'cell_supp'); `smoother` one of 'gs', 'forward_gs',
    'backward_gs', 'symmetric_gs', 'exact'.  `relax_backend` ``'host'``
    runs :func:`local_mg_step` under :func:`iterative_solve` on the host;
    ``'device'`` runs the whole solve as a
    :class:`~pyiga_tpu_torch.ops.mg.DeviceMGSolver` on `device` (one K6
    launch per V-cycle on a GPU, the plain cycle on the CPU); ``'auto'``
    means ``'device'`` when `device` is a CUDA device and ``'host'``
    otherwise.  The 'exact' smoother always runs on the host.  Returns
    ``(x, iterations)``; both paths give the same iteration counts."""
    if relax_backend not in ('host', 'device', 'auto'):
        raise ValueError("relax_backend must be 'host', 'device' or 'auto'")
    device = resolve_device(device)
    if relax_backend == 'auto':
        relax_backend = 'device' if device.type == 'cuda' else 'host'
    if relax_backend == 'device' and smoother != 'exact':
        solver = _device_mg_solver(hs, A, strategy, smoother, smooth_steps,
                                   device)
        return solver.solve(f, tol=tol, maxiter=maxiter)
    Ps = hs.virtual_hierarchy_prolongators()
    mg_step = local_mg_step(hs, A, f, Ps, hs.indices_to_smooth(strategy),
                            smoother, smooth_steps, relax_backend='host')
    return iterative_solve(mg_step, A, f, active_dofs=hs.non_dirichlet_dofs(),
                           tol=tol, maxiter=maxiter)
