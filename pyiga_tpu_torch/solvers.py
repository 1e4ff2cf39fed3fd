# -*- coding: utf-8 -*-
"""Solvers of the port: the Krylov solvers (:func:`cg`, :func:`cg_jit` and
:func:`cg_jit_traceable`, :func:`cg_ir` and :func:`cg_ir_traceable`,
:func:`gmres` and :func:`gmres_jit`, counterparts of the JAX package's),
the fast-diagonalization inverse :func:`fastdiag_solver`, the host
smoothers and :func:`twogrid`, the local multigrid solver of
hierarchical spaces (:func:`solve_hmultigrid`, with its host path
:func:`local_mg_step` + :func:`iterative_solve` and its device path
:class:`~pyiga_tpu_torch.ops.mg.DeviceMGSolver`), and the implicit time
integrators (Newton, DIRK and Rosenbrock schemes with constant or
adaptive steps: a host copy of the JAX package's, whose step sequences
are the contract; :class:`~pyiga_tpu_torch.ops.rosw.
DeviceRosenbrockScheme` runs a Rosenbrock step on the device).

The loops run eagerly: each iteration reads its convergence test back to
the host (one synchronization per iteration).  Operators and
preconditioners are callables on raveled tensors; the ``*_jit`` and
``*_traceable`` entries also take objects with the JAX package's operand
protocol (``operands`` and ``apply_with_operands``).  Nothing is traced
or compiled, so nothing is cached per operator.  The iteration logic —
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

from . import native, utils
from .config import resolve_device
from .operators import DiagonalOperator, KroneckerOperator, make_solver
from .ops.mg import _SWEEP_DIRS, DeviceMGSolver
from .ops.relax import DeviceIndexedGS


def _asdense(X):
    return X.toarray() if scipy.sparse.issparse(X) else X


################################################################################
# Fast diagonalization [Sangalli, Tani 2016]
################################################################################

def fastdiag_solver(KM):
    """Fast-diagonalization inverse of ``sum_d K_d (x) M_1 ... M_d ...``
    (host scipy operators): per-axis generalized eigendecompositions give
    a Kronecker eigenbasis in which the operator is diagonal.  `KM` is
    the list of ``(K_i, M_i)`` pairs."""
    dim = len(KM)
    evs = [scipy.linalg.eigh(_asdense(K), _asdense(M)) for K, M in KM]
    # eigenvalues of the full operator: the outer sum of the per-axis
    # eigenvalues over the tensor grid (C order matches the Kronecker basis)
    lam = np.zeros(dim * (1,))
    for d, (w, _) in enumerate(evs):
        lam = lam + w.reshape((1,) * d + (-1,) + (1,) * (dim - 1 - d))
    to_eigen = KroneckerOperator(*(U.T for _, U in evs))
    from_eigen = KroneckerOperator(*(U for _, U in evs))
    return from_eigen * DiagonalOperator(1.0 / lam.ravel()) * to_eigen


################################################################################
# Krylov solvers
################################################################################

def _norm(v, dot):
    """The 2-norm of `v` (``sqrt(dot(v, v))`` with a `dot` of its own)."""
    if dot is None:
        return torch.linalg.vector_norm(v)
    return torch.sqrt(dot(v, v))


def _pcg(matvec, pc, x, r, stop, maxiter, dot=None):
    """The preconditioned CG loop from the iterate `x` with residual `r`
    until ``||r|| <= stop`` or `maxiter` steps; returns ``(x,
    iterations)``.  `dot` replaces ``torch.dot`` (and the norm with it):
    the multi-device layer passes a dot product reduced over its ranks."""
    vdot = torch.dot if dot is None else dot
    z = pc(r)
    p = z
    rz = vdot(r, z)
    it = 0
    while it < maxiter and bool(_norm(r, dot) > stop):
        Ap = matvec(p)
        alpha = rz / vdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = pc(r)
        rz_new = vdot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        it += 1
    return x, it


def _as_operand_fn(op):
    """``(operands, fn)`` with ``fn(operands, x)`` applying `op`: the
    operand protocol (attributes ``operands`` and
    ``apply_with_operands``, as :class:`~pyiga_tpu_torch.ops.banded.
    BandedOperator` and :class:`~pyiga_tpu_torch.ops.fastdiag.
    FastDiagPrecond` carry) or a plain callable (no operands)."""
    fn = getattr(op, 'apply_with_operands', None)
    if fn is not None:
        return op.operands, fn
    return None, (lambda operands, v: op(v))


def _identity_fn(operands, r):
    return r


def cg_jit_traceable(matvec, tol=1e-8, maxiter=1000, precond=None):
    """The CG program behind :func:`cg_jit`, taking its operands as
    arguments: returns ``(run, mv_ops, pc_ops)`` with ``run(b, x0,
    mv_ops, pc_ops) -> (x, iterations)``.  A caller may pass other
    operand tensors (e.g. freshly assembled data) to `run`.  `x0=None`
    starts from zero.  Stops when ``||r|| <= tol * ||b - A x0||``."""
    mv_ops, mv_fn = _as_operand_fn(matvec)
    if precond is None:
        pc_ops, pc_fn = None, _identity_fn
    else:
        pc_ops, pc_fn = _as_operand_fn(precond)

    def run(b, x0, mv_ops, pc_ops):
        if x0 is None:              # r0 = b - A 0 = b
            x, r = torch.zeros_like(b), b
        else:
            x, r = x0, b - mv_fn(mv_ops, x0)
        return _pcg(lambda v: mv_fn(mv_ops, v),
                    lambda v: pc_fn(pc_ops, v), x, r,
                    tol * torch.linalg.vector_norm(r), maxiter)

    return run, mv_ops, pc_ops


def cg_jit(matvec, b, x0=None, tol=1e-8, maxiter=1000, precond=None):
    """Preconditioned conjugate gradients from `x0` (zero by default), the
    counterpart of :func:`pyiga_tpu.solvers.cg_jit`: `matvec` and
    `precond` are callables on raveled tensors or objects with the
    operand protocol.  Stops when ``||r|| <= tol * ||b - A x0||`` or after
    `maxiter` steps; one host synchronization per iteration.  Nothing is
    cached: no reference to `matvec` or `precond` outlives the call.
    Returns ``(x, iterations)``, `x` on `b`'s device."""
    b = torch.as_tensor(b)
    run, mv_ops, pc_ops = cg_jit_traceable(matvec, tol=tol, maxiter=maxiter,
                                           precond=precond)
    return run(b, x0, mv_ops, pc_ops)


def cg(matvec, b, tol=1e-8, maxiter=1000, precond=None):
    """Preconditioned conjugate gradients from a zero start
    (:func:`cg_jit` without `x0`); stops when ``||r|| <= tol * ||b||`` or
    after `maxiter` steps.  Works in the dtype of `b`.  Returns ``(x,
    iterations)``."""
    return cg_jit(matvec, b, tol=tol, maxiter=maxiter, precond=precond)


def cg_ir_traceable(op_hi, op_lo, tol=1e-8, maxiter_inner=200, max_outer=10,
                    precond_lo=None, inner_tol=1e-3, dot=None):
    """The refinement program behind :func:`cg_ir`, taking its operands
    as arguments: returns ``(run, hi_ops, lo_ops, pc_ops)`` with
    ``run(b, hi_ops, lo_ops, pc_ops) -> (x, packed_info)``, the info
    packed into one float64 tensor on `b`'s device (``[residual, outer,
    inner_iters...]``, decoded by :func:`cg_ir_info`).  The operators
    follow the operand protocol or are plain callables.  `dot` replaces
    ``torch.dot`` in every dot product and norm (the multi-device layer's
    reduction over its ranks, :mod:`~pyiga_tpu_torch.parallel.flagship`;
    None: torch's)."""
    hi_ops, hi_fn = _as_operand_fn(op_hi)
    lo_ops, lo_fn = _as_operand_fn(op_lo)
    if precond_lo is None:
        pc_ops, pc_fn = None, _identity_fn
    else:
        pc_ops, pc_fn = _as_operand_fn(precond_lo)

    def run(b, hi_ops, lo_ops, pc_ops):
        b = b.to(torch.float64)
        norm_b = _norm(b, dot)
        x = torch.zeros_like(b)
        r = b
        res = norm_b
        outer, inner_iters = 0, []
        while bool(res > tol * norm_b) and outer < max_outer:
            r32 = r.to(torch.float32)
            d, it = _pcg(lambda v: lo_fn(lo_ops, v),
                         lambda v: pc_fn(pc_ops, v), torch.zeros_like(r32),
                         r32, inner_tol * _norm(r32, dot), maxiter_inner,
                         dot)
            x = x + d.to(torch.float64)
            r = b - hi_fn(hi_ops, x)
            res = _norm(r, dot)
            inner_iters.append(it)
            outer += 1
        iters = torch.zeros(max_outer, dtype=torch.float64, device=b.device)
        iters[:outer] = torch.tensor(inner_iters, dtype=torch.float64)
        return x, torch.cat([(res / norm_b).reshape(1),
                             torch.full((1,), outer, dtype=torch.float64,
                                        device=b.device), iters])

    return run, hi_ops, lo_ops, pc_ops


def cg_ir(op_hi, op_lo, b, tol=1e-8, maxiter_inner=200, max_outer=10,
          precond_lo=None, inner_tol=1e-3, fetch_info=True):
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
        fetch_info: as in the JAX package: ``False`` returns the info
            packed into one float64 tensor on `b`'s device
            (``[residual, outer, inner_iters...]``), which
            :func:`cg_ir_info` decodes.  The loop reads its convergence
            test on the host either way, so this saves no sync here.

    Returns ``(x, info)`` with ``info = {'outer', 'inner_iters',
    'residual'}`` (``residual`` relative to ``||b||``)."""
    run, hi_ops, lo_ops, pc_ops = cg_ir_traceable(
        op_hi, op_lo, tol=tol, maxiter_inner=maxiter_inner,
        max_outer=max_outer, precond_lo=precond_lo, inner_tol=inner_tol)
    x, info = run(b, hi_ops, lo_ops, pc_ops)
    return x, (cg_ir_info(info) if fetch_info else info)


def cg_ir_info(info):
    """Decode the packed info tensor of ``cg_ir(..., fetch_info=False)``
    into the usual dict (one host read)."""
    info = info.cpu().numpy() if isinstance(info, torch.Tensor) \
        else np.asarray(info)
    outer = int(info[1])
    return {'outer': outer,
            'inner_iters': [int(i) for i in info[2:2 + outer]],
            'residual': float(info[0])}


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


def gmres_jit(matvec, b, x0=None, tol=1e-8, restart=30, max_restarts=100,
              precond=None):
    """Right-preconditioned restarted GMRES(m), the counterpart of
    :func:`pyiga_tpu.solvers.gmres_jit`: :func:`gmres` on `matvec` and
    `precond` given as callables or with the operand protocol.  The
    absolute target is ``tol * ||b||`` also from a nonzero `x0`.  Returns
    ``(x, iterations)``: the total count of inner iterations, ``inf`` if
    `tol` was not reached."""
    b = torch.as_tensor(b)
    mv_ops, mv_fn = _as_operand_fn(matvec)
    pc_ops, pc_fn = ((None, _identity_fn) if precond is None
                     else _as_operand_fn(precond))
    return gmres(lambda v: mv_fn(mv_ops, v), b, x0=x0, tol=tol,
                 restart=restart, max_restarts=max_restarts,
                 precond=lambda r: pc_fn(pc_ops, r))


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


def OperatorSmoother(S):
    r"""Smoother ``u <- u + S (f - A u)`` for an arbitrary operator `S`."""
    def apply(A, u, f):
        u += S.dot(f - A.dot(u))
    return apply


def GaussSeidelSmoother(iterations=1, sweep='forward'):
    """Gauss-Seidel smoother with the given sweep direction."""
    def apply(A, u, f):
        gauss_seidel(A, u, f, iterations=iterations, sweep=sweep)
    return apply


def SequentialSmoother(smoothers):
    """Apply several smoothers in sequence."""
    def apply(A, u, f):
        for S in smoothers:
            S(A, u, f)
    return apply


def twogrid(A, f, P, smoother, u0=None, tol=1e-8, smooth_steps=2,
            maxiter=1000):
    """Two-grid iteration (host scipy) with the Galerkin coarse matrix
    ``P^T A P``; prints the iteration count as the JAX package's does."""
    coarse_inv = make_solver(P.T @ A @ P)
    u = np.array(u0) if u0 is not None else np.zeros(A.shape[0])
    res0 = np.linalg.norm(f - A @ u)

    for numiter in range(1, maxiter + 2):
        for _ in range(smooth_steps):
            smoother(A, u, f)
        r = f - A @ u
        res = np.linalg.norm(r)
        u += P @ (coarse_inv * (P.T @ r))
        if res < tol * res0:
            break
        if res > 20 * res0:
            print('Diverged')
            break
    else:
        print('too many iterations, aborting. reduction =', res / res0)
    print(numiter, 'iterations')
    return u


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
                  smooth_steps=2, relax_backend='auto', device=None):
    """One V-cycle of the local multigrid method on the virtual hierarchy
    of the HB/THB space `hs`; smoothing is restricted to the per-level
    index sets `lv_inds`.  Returns a function ``step(x)`` (host numpy).

    Explicit descend/ascend passes over the Galerkin coarse matrices;
    the operation order (pre-smooth, restrict, coarse solve, prolongate,
    post-smooth, with strictly sequential Gauss-Seidel sweeps) fixes the
    iteration counts.  `relax_backend` ``'host'`` runs the native CSR
    sweeps; ``'device'`` the order-exact wavefront smoother
    :class:`~pyiga_tpu_torch.ops.relax.DeviceIndexedGS` on `device`
    (default: the card), one per level and sweep direction, each
    smoothing application one kernel launch (its plain version on the
    CPU); ``'auto'`` takes ``'device'`` unless `device` resolves to the
    CPU, where it takes ``'host'``.  `A` is float64 under either compute
    dtype (the float32 hierarchical assembly returns float64 entries), and
    the cycle runs in float64, as the JAX package's."""
    if smoother not in _MG_SWEEPS:
        raise ValueError('Invalid smoother')
    if relax_backend not in ('host', 'device', 'auto'):
        raise ValueError("relax_backend must be 'host', 'device' or 'auto'")
    if relax_backend == 'auto':
        relax_backend = ('host' if resolve_device(device).type == 'cpu'
                         else 'device')
    pre_sweep, post_sweep = _MG_SWEEPS[smoother]
    L = hs.numlevels
    As = galerkin_hierarchy(A, Ps)

    exact_on = range(L) if smoother == 'exact' else (0,)
    direct = {lv: make_solver(As[lv][lv_inds[lv]][:, lv_inds[lv]])
              for lv in exact_on}

    if relax_backend == 'device' and smoother != 'exact':
        dev_gs = {(lv, sweep): DeviceIndexedGS(As[lv], lv_inds[lv],
                                               sweep=sweep,
                                               iterations=smooth_steps,
                                               device=device)
                  for lv in range(1, L)
                  for sweep in {pre_sweep, post_sweep}}

        def relax(lv, x, rhs, sweep):
            if sweep is not None:
                dev_gs[(lv, sweep)].apply(x, rhs)
    else:
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
    parts = (Acsr.indptr, Acsr.indices, Acsr.data)
    options = (strategy, smoother, smooth_steps, str(device))
    # an entry's key ends with the route its solver took ('fused' or
    # 'wavefront'), which follows from the matrix and the options
    # the same matrix object again: compare its arrays with the copies
    # the entry keeps (a memory compare, several times faster than the
    # digest below, which is host time of every solve)
    for key, (hs_c, A_c, solver, saved) in _DEVICE_MG_CACHE.items():
        if hs_c is hs and A_c is A and key[2:-1] == options and all(
                np.array_equal(p, q) for p, q in zip(parts, saved)):
            return solver
    # key on the matrix CONTENT, not just its identity: a matrix changed
    # in place between solves must not reuse the stale uploaded hierarchy
    h = hashlib.blake2b(digest_size=16)
    for part in parts:
        h.update(np.ascontiguousarray(part).tobytes())
    key = (id(hs), h.digest()) + options
    for k, hit in _DEVICE_MG_CACHE.items():
        if k[:-1] == key and hit[0] is hs:
            return hit[2]
    Ps = hs.virtual_hierarchy_prolongators()
    solver = DeviceMGSolver(galerkin_hierarchy(Acsr, Ps), Ps,
                            hs.indices_to_smooth(strategy),
                            _MG_SWEEPS[smoother], smooth_steps,
                            active_dofs=hs.non_dirichlet_dofs(),
                            device=device)
    key += (solver.smoother_impl,)
    if len(_DEVICE_MG_CACHE) >= 4:
        _DEVICE_MG_CACHE.pop(next(iter(_DEVICE_MG_CACHE)))
    _DEVICE_MG_CACHE[key] = (hs, A, solver,
                             tuple(np.array(p, copy=True) for p in parts))
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
    launch per solve on a GPU, the plain cycle on the CPU); ``'auto'``
    means ``'device'`` when `device` is a CUDA device and ``'host'``
    otherwise.  The 'exact' smoother always runs on the host.  Returns
    ``(x, iterations)``; both paths give the same iteration counts.  Under
    a float32 compute dtype `A` is the float32 assembly's matrix (float64
    entries) and the solve runs in float64 on either path, as the JAX
    package's local MG does whatever the dtype."""
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


################################################################################
# Nonlinear problems
################################################################################

class NoConvergenceError(Exception):
    """Raised by :func:`newton` on non-convergence; carries the last
    iterate."""

    def __init__(self, method, num_iter, last_iterate):
        super().__init__('%s did not converge in %d iterations'
                         % (method, num_iter))
        self.method = method
        self.num_iter = num_iter
        self.last_iterate = last_iterate


def newton(F, J, x0, atol=1e-6, rtol=1e-6, maxiter=100, freeze_jac=1):
    """Newton iteration for ``F(x) = 0`` with optional frozen Jacobian
    (`freeze_jac` > 1 re-factorizes only every so many steps)."""
    x = np.array(x0)
    res = F(x)
    target = max(atol, rtol * np.linalg.norm(res))
    jac_inv = None
    for num_it in range(maxiter):
        if np.linalg.norm(res) < target:
            return x
        if num_it % freeze_jac == 0 or jac_inv is None:
            jac_inv = make_solver(J(x))
        x -= jac_inv.dot(res)
        res = F(x)
    raise NoConvergenceError('newton', maxiter, x)


################################################################################
# Implicit Runge-Kutta time stepping (DIRK and Rosenbrock schemes)
#
# A *scheme* object computes one step; the constant/adaptive *loops* below
# handle step control and are shared by both families.
################################################################################

class _DIRKScheme:
    """A diagonally-implicit RK scheme from an extended Butcher array
    (`s` stage rows, then the weight row `b`, optionally the embedded
    row `b_hat`)."""

    def __init__(self, tableau):
        tableau = np.asarray(tableau)
        self.s = s = tableau.shape[1]
        self.A = tableau[:s]
        self.b = tableau[s]
        self.b_hat = tableau[s + 1] if tableau.shape[0] > s + 1 else None
        # stiffly accurate: the last stage IS the new iterate
        self.stiffly_accurate = np.allclose(self.b, self.A[s - 1])

    def truncated(self):
        """The same scheme without its embedded error estimator."""
        return _DIRKScheme(np.vstack([self.A, self.b]))

    def _implicit_stage(self, M, F, J, tau, a_ii, rhs, x_start):
        """Solve ``M y - tau a_ii F(y) = rhs`` by Newton, returning the
        stage value and the F evaluation at it."""
        cache = {}

        def res_fn(z):
            cache['F'] = F(z)
            return M @ z - tau * a_ii * cache['F'] - rhs

        y = newton(res_fn, lambda z: M - tau * a_ii * J(z), x_start,
                   atol=1e-4, freeze_jac=2)
        return y, cache['F']

    def step(self, M, F, J, x, tau, data=None, Fx=None):
        if M is None:
            M = scipy.sparse.eye(x.shape[0])
        if data is None:
            data = {}
        A, s = self.A, self.s
        stage_vals, stage_F = [], []
        for i in range(s):
            if A[i, i] == 0:
                if i != 0:
                    raise ValueError('explicit stage only allowed first')
                stage_vals.append(x)
                stage_F.append(Fx if Fx is not None else F(x))
                continue
            rhs = M @ x + tau * sum(A[i, j] * stage_F[j] for j in range(i))
            guess = stage_vals[-1] if stage_vals else x
            y, Fy = self._implicit_stage(M, F, J, tau, A[i, i], rhs, guess)
            stage_vals.append(y)
            stage_F.append(Fy)

        def combine(weights):
            if 'M_inv' not in data:
                data['M_inv'] = make_solver(M, spd=True)
            acc = M @ x + tau * sum(w * Fi
                                    for w, Fi in zip(weights, stage_F))
            return data['M_inv'] @ acc

        if self.stiffly_accurate:
            x_new, F_new = stage_vals[-1], stage_F[-1]
        else:
            x_new, F_new = combine(self.b), None

        if self.b_hat is not None:
            return x_new, combine(self.b_hat), F_new
        return x_new, F_new


class _RosenbrockScheme:
    """A Rosenbrock(-W) scheme: one Jacobian evaluation and one
    factorization of ``M - tau gamma J`` per step, `s` linear stage
    solves."""

    def __init__(self, A, Gamma, b, b_hat):
        self.A, self.Gamma = np.asarray(A), np.asarray(Gamma)
        self.b, self.b_hat = b, b_hat

    def truncated(self):
        return _RosenbrockScheme(self.A, self.Gamma, self.b, None)

    def step(self, M, F, J, x, tau, data=None, Fx=None):
        A, Gamma = self.A, self.Gamma
        jac = J(x)
        solve = make_solver(M - tau * Gamma[0, 0] * jac)

        ks = []
        for i in range(A.shape[0]):
            y = x + tau * sum(A[i, j] * ks[j] for j in range(i))
            rhs = F(y)
            if i > 0:
                rhs = rhs + tau * jac.dot(
                    sum(Gamma[i, j] * ks[j] for j in range(i)))
            ks.append(solve.dot(rhs))

        def combine(weights):
            return x + tau * sum(w * k for w, k in zip(weights, ks))

        if self.b_hat is not None:
            return combine(self.b), combine(self.b_hat), None
        return combine(self.b), None


def dirk_step(tableau, M, F, J, x, tau, data=None, Fx=None):
    """One step of the (embedded) DIRK method given by the extended Butcher
    array (compatibility wrapper around :class:`_DIRKScheme`)."""
    return _DIRKScheme(tableau).step(M, F, J, x, tau, data=data, Fx=Fx)


def rosenbrock_step(A, Gamma, b, b_hat, M, F, J, x, tau, data, Fx=None):
    """One Rosenbrock(-W) step (compatibility wrapper around
    :class:`_RosenbrockScheme`)."""
    return _RosenbrockScheme(A, Gamma, b, b_hat).step(M, F, J, x, tau,
                                                      data=data, Fx=Fx)


def _integrate_constant(scheme, M, F, J, x, tau, t_end, *, t0=0.0,
                        progress=False):
    """Integrate with constant steps; returns (times, solutions)."""
    times, solutions = [t0], [x]
    Fx, data = None, {}
    nsteps = int(np.ceil((t_end - t0) / tau))
    for i in utils.progress_bar(progress)(range(nsteps)):
        try:
            x, Fx = scheme.step(M, F, J, x, tau, data, Fx=Fx)
        except NoConvergenceError:
            print('Nonlinear solve failed; returning partial results')
            break
        times.append(t0 + (i + 1) * tau)
        solutions.append(x)
    return times, solutions


def _integrate_adaptive(scheme, err_order, M, F, J, x, tau0, t_end, tol, *,
                        t0=0.0, step_factor=0.9, progress=False):
    """Integrate with embedded-error adaptive step control; returns
    (times, solutions)."""
    if tol is None:
        return _integrate_constant(scheme.truncated(), M, F, J, x, tau0,
                                   t_end, t0=t0, progress=progress)
    times, solutions = [t0], [x]
    Fx, data, tau, t = None, {}, tau0, t0
    with utils.progress_bar(progress)(total=t_end - t0) as pbar:
        while t < t_end:
            try:
                xnew, xhat, Fxnew = scheme.step(M, F, J, x, tau, data, Fx=Fx)
            except NoConvergenceError:
                tau *= 0.5          # reject: halve the step and retry
                continue
            # scaled RMS error of the embedded estimate
            weight = tol + tol * abs(x)
            r = np.linalg.norm((xhat - xnew) / weight) / np.sqrt(len(x))
            r = max(r, 1e-15)
            if r <= 1:              # accept
                t += tau
                x, Fx = xnew, Fxnew
                times.append(t)
                solutions.append(x)
                pbar.update(tau)
                pbar.set_postfix({'tau': tau})
            tau *= min(5.0, max(0.2, step_factor * r ** (-1.0 / err_order)))
    return times, solutions


def _export_method(scheme, name, displayname, err_order=None):
    """Public integrator function for a scheme: constant-step when it has
    no embedded estimator, adaptive otherwise."""
    if err_order is None:
        def method(M, F, J, x, tau, t_end, *, t0=0.0, progress=False):
            return _integrate_constant(scheme, M, F, J, x, tau, t_end,
                                       t0=t0, progress=progress)
    else:
        def method(M, F, J, x, tau0, t_end, tol, *, t0=0.0,
                   step_factor=0.9, progress=False):
            return _integrate_adaptive(scheme, err_order, M, F, J, x, tau0,
                                       t_end, tol, t0=t0,
                                       step_factor=step_factor,
                                       progress=progress)
    method.__name__ = method.__qualname__ = name
    method.__doc__ = ('Solve a time-dependent problem using the %s method.'
                      % displayname)
    return method


def dirk_method(tableau, name, displayname):
    return _export_method(_DIRKScheme(tableau), name, displayname)


def adaptive_dirk_method(tableau, err_order, name, displayname):
    return _export_method(_DIRKScheme(tableau), name, displayname,
                          err_order=err_order)


# -- Butcher tableaus (published coefficients) --------------------------------

def coeffs_sdirk3():
    # Alexander 1977 / Skvortsov 2006
    gamma = 0.435866521508
    b2 = 0.25 * (5 - 20 * gamma + 6 * gamma ** 2)
    return np.array([
        [gamma, 0.0, 0.0],
        [(1 - gamma) / 2, gamma, 0.0],
        [1 - b2 - gamma, b2, gamma],
        [1 - b2 - gamma, b2, gamma],
    ])


def coeffs_sdirk3_b():
    # Norsett's three-stage, 4th-order DIRK (not stiffly accurate)
    xi = 0.128886400515
    return np.array([
        [xi, 0.0, 0.0],
        [0.5 - xi, xi, 0.0],
        [2 * xi, 1 - 4 * xi, xi],
        [1 / (6 * (2 * xi - 1) ** 2),
         2 * (6 * xi ** 2 - 6 * xi + 1) / (3 * (2 * xi - 1) ** 2),
         1 / (6 * (2 * xi - 1) ** 2)],
    ])


def coeffs_sdirk21():
    # Ellsiepen: order 2, embedded order 1
    alpha = 1 - np.sqrt(2) / 2
    alp_hat = 2 - 1.25 * np.sqrt(2)
    A = np.array([
        [alpha, 0.0],
        [1 - alpha, alpha],
        [1 - alpha, alpha],
        [1 - alp_hat, alp_hat],
    ])
    return A, 1


def coeffs_dirk34():
    # 4 stages, order 3, L-stable, stiffly accurate; embedded order 2
    a21 = a22 = a33 = a44 = 0.1558983899988677
    a32 = 1.072486270734370
    a31 = 1 - a32 - a22
    a42 = 0.7685298292769537
    a43 = 0.09666483609791597
    A = np.array([
        [0.0, 0.0, 0.0, 0.0],
        [a21, a22, 0.0, 0.0],
        [a31, a32, a33, 0.0],
        [0.0, a42, a43, a44],
        [0.0, a42, a43, a44],
        [a31, a32, a33, 0.0],
    ])
    return A, 2


def coeffs_esdirk23():
    # Jorgensen et al 2018 (arXiv:1803.01613)
    gamma = (2 - np.sqrt(2)) / 2
    return np.array([
        [0.0, 0.0, 0.0],
        [gamma, gamma, 0.0],
        [(1 - gamma) / 2, (1 - gamma) / 2, gamma],
        [(1 - gamma) / 2, (1 - gamma) / 2, gamma],
        [(6 * gamma - 1) / (12 * gamma),
         1 / (12 * gamma * (1 - 2 * gamma)),
         (1 - 3 * gamma) / (3 * (1 - 2 * gamma))],
    ]), 3


def coeffs_esdirk34():
    # Jorgensen et al 2018 (arXiv:1803.01613)
    a21 = 0.43586652150845899942
    a31 = 0.14073777472470619619
    a32 = -0.1083655513813208000
    gam = 0.43586652150845899942
    b = [0.10239940061991099768, -0.3768784522555561061,
         0.83861253012718610911, gam]
    b_hat = [0.15702489786032493710, 0.11733044137043884870,
             0.61667803039212146434, 0.10896663037711474985]
    return np.array([
        [0.0, 0.0, 0.0, 0.0],
        [a21, gam, 0.0, 0.0],
        [a31, a32, gam, 0.0],
        b, b, b_hat,
    ]), 4


crank_nicolson = dirk_method(np.array([
    [0.0, 0.0],
    [0.5, 0.5],
    [0.5, 0.5],
]), 'crank_nicolson', 'Crank-Nicolson')

sdirk3 = dirk_method(coeffs_sdirk3(), 'sdirk3', 'SDIRK3 Runge-Kutta')
sdirk3_b = dirk_method(coeffs_sdirk3_b(), 'sdirk3_b',
                       'SDIRK3 (alternate) Runge-Kutta')
sdirk21 = adaptive_dirk_method(*coeffs_sdirk21(), 'sdirk21',
                               'SDIRK21 (Ellsiepen) Runge-Kutta')
dirk34 = adaptive_dirk_method(*coeffs_dirk34(), 'dirk34', 'DIRK34 Runge-Kutta')
esdirk23 = adaptive_dirk_method(*coeffs_esdirk23(), 'esdirk23',
                                'ESDIRK23 Runge-Kutta')
esdirk34 = adaptive_dirk_method(*coeffs_esdirk34(), 'esdirk34',
                                'ESDIRK34 Runge-Kutta')


################################################################################
# Rosenbrock methods (see doi:10.1016/j.cma.2009.10.005)
################################################################################

def coeffs_ros3p():
    A = np.array([
        [0.0, 0.0, 0.0],
        [1.0, 0.0, 0.0],
        [1.0, 0.0, 0.0],
    ])
    gam = 0.7886751347
    Gamma = np.array([
        [gam, 0.0, 0.0],
        [-1.0, gam, 0.0],
        [-0.7886751347, -1.077350269, gam],
    ])
    b = np.array([2 / 3, 0, 1 / 3])
    b_hat = np.array([1 / 3, 1 / 3, 1 / 3])
    return A, Gamma, b, b_hat, 2


def coeffs_ros3pw():
    A = np.array([
        [0.0, 0.0, 0.0],
        [1.5773502691896257e+00, 0.0, 0.0],
        [0.5, 0.0, 0.0],
    ])
    gam = 7.8867513459481287e-01
    Gamma = np.array([
        [gam, 0.0, 0.0],
        [-1.5773502691896257e+00, gam, 0.0],
        [-6.7075317547305480e-01, -1.7075317547305482e-01, gam],
    ])
    b = np.array([1.0566243270259355e-01, 4.9038105676657971e-02,
                  8.4529946162074843e-01])
    b_hat = np.array([-1.7863279495408180e-01, 1 / 3, 8.4529946162074843e-01])
    return A, Gamma, b, b_hat, 2


def coeffs_rowdaind2():
    A = np.array([
        [0.0, 0.0, 0.0, 0.0],
        [0.5, 0.0, 0.0, 0.0],
        [0.28, 0.72, 0.0, 0.0],
        [0.28, 0.72, 0.0, 0.0],
    ])
    gam = 0.3
    Gamma = np.array([
        [gam, 0.0, 0.0, 0.0],
        [-1.121794871794876e-1, gam, 0.0, 0.0],
        [2.54, -3.84, gam, 0.0],
        [29.0 / 75.0, -0.72, 1.0 / 30.0, gam],
    ])
    b = np.array([2.0 / 3.0, 0.0, 1.0 / 30.0, 0.3])
    b_hat = np.array([4.799002800355166e-1, 5.176203811215082e-1,
                      2.479338842975209e-3, 0.0])
    return A, Gamma, b, b_hat, 2


def coeffs_rodasp():
    gamma = 0.25
    A = np.array([
        [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        [0.75, 0.0, 0.0, 0.0, 0.0, 0.0],
        [8.6120400814152190e-2, 0.1238795991858478, 0.0, 0.0, 0.0, 0.0],
        [0.7749345355073236, 0.1492651549508680, -0.2941996904581916,
         0.0, 0.0, 0.0],
        [5.308746682646142, 1.330892140037269, -5.374137811655562,
         -0.2655010110278497, 0.0, 0.0],
        [-1.764437648774483, -0.4747565572063027, 2.369691846915802,
         0.6195023590649829, 0.25, 0.0],
    ])
    B = np.array([
        [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        [-0.049392, -0.014112, 0.0, 0.0, 0.0, 0.0],
        [-0.4820494693877561, -0.1008795555555556, 0.9267290249433117,
         0.0, 0.0, 0.0],
        [-1.764437648774483, -0.4747565572063027, 2.369691846915802,
         0.6195023590649829, 0.0, 0.0],
        [-8.0368370789113464e-2, -5.6490613592447572e-2, 0.4882856300427991,
         0.5057162114816189, -0.1071428571428569, 0.0],
    ])
    np.fill_diagonal(B, gamma)
    Gamma = B - A
    b = np.array([-8.0368370789113464e-2, -5.6490613592447572e-2,
                  0.4882856300427991, 0.5057162114816189,
                  -0.1071428571428569, gamma])
    b_hat = np.array([-1.764437648774483, -0.4747565572063027,
                      2.369691846915802, 0.6195023590649829, gamma, 0])
    return A, Gamma, b, b_hat, 3


def coeffs_rosi2p1():
    A = np.array([
        [0.0, 0.0, 0.0, 0.0],
        [5.0000000000000000e-1, 0.0, 0.0, 0.0],
        [5.5729261836499822e-1, 1.9270738163500176e-1, 0.0, 0.0],
        [-3.0084516445435860e-1, 1.8995581939026787e+0,
         -5.9871302944832006e-1, 0.0],
    ])
    gam = 4.3586652150845900e-1
    Gamma = np.array([
        [gam, 0.0, 0.0, 0.0],
        [-5.0000000000000000e-1, gam, 0.0, 0.0],
        [-6.4492162993321323e-1, 6.3491801247597734e-2, gam, 0.0],
        [9.3606009252719842e-3, -2.5462058718013519e-1,
         -3.2645441930944352e-1, gam],
    ])
    b = np.array([5.2900072579103834e-2, 1.3492662311920438e+0,
                  -9.1013275270050265e-1, 5.0796644892935516e-1])
    b_hat = np.array([1.4974465479289098e-1, 7.0051069041421810e-1, 0.0,
                      1.4974465479289098e-1])
    return A, Gamma, b, b_hat, 2


def rosenbrock_method(A, Gamma, b, name, displayname):
    return _export_method(_RosenbrockScheme(A, Gamma, b, None), name,
                          displayname)


def adaptive_rosenbrock_method(A, Gamma, b, b_hat, err_order, name,
                               displayname):
    return _export_method(_RosenbrockScheme(A, Gamma, b, b_hat), name,
                          displayname, err_order=err_order)


ros3p = adaptive_rosenbrock_method(*coeffs_ros3p(), 'ros3p',
                                   'ROS3P Rosenbrock')
ros3pw = adaptive_rosenbrock_method(*coeffs_ros3pw(), 'ros3pw',
                                    'ROS3PW Rosenbrock')
rowdaind2 = adaptive_rosenbrock_method(*coeffs_rowdaind2(), 'rowdaind2',
                                       'ROWDAIND2 Rosenbrock')
rodasp = adaptive_rosenbrock_method(*coeffs_rodasp(), 'rodasp',
                                    'RODASP Rosenbrock')
rosi2p1 = adaptive_rosenbrock_method(*coeffs_rosi2p1(), 'rosi2p1',
                                     'ROSI2P1 Rosenbrock')
