# -*- coding: utf-8 -*-
"""Rosenbrock(-W) stepping on the device for dense restricted systems
(port of :mod:`pyiga_tpu.ops.rosw`).

Behavior contract: one step of
:class:`pyiga_tpu_torch.solvers._RosenbrockScheme` — one Jacobian
evaluation and one factorization-equivalent of ``W = M - tau*gamma*J``
per step, ``s`` linear stage solves, the embedded pair for the adaptive
controller — with every dense operand on the scheme's device in float64.

The JAX package carries these operands as two-float f32 pairs, inverts
``W`` in f32 and polishes the inverse by Newton-Schulz iterations,
because the TPU it targets has no f64 arithmetic.  A GPU computes f64
natively, so here ``P = W^-1`` is one :func:`torch.linalg.inv` in f64,
cached per step size tau as the JAX code caches its ``P``, and every
stage system is still solved by Richardson refinement against ``P`` to
``solve_tol`` (relative residual), so a stale ``P`` (tau or Jacobian
drift) costs refinement sweeps, not accuracy.  A stage solve that misses
``solve_tol`` rebuilds ``P`` at the current state and retries once; then
the optional host scheme takes the step, and every such step is counted
in the scheme's ``host_fallbacks``.  These are torch operations (dense
matrix products and the inverse), not kernels of this repository: the
JAX package left them to XLA as well.  The scheme computes in float64
(``config.DTYPE``) under either compute dtype, as the JAX package's
``ops/rosw.py``.
"""

import math

import numpy as np
import torch

from ..config import DTYPE, resolve_device


class DeviceRosenbrockScheme:
    """Drop-in scheme object for
    :func:`pyiga_tpu_torch.solvers._integrate_adaptive` /
    ``_integrate_constant`` whose ``step`` runs on the device.

    Args:
        coeffs: ``(A, Gamma, b, b_hat)`` Rosenbrock arrays (``b_hat`` may
            be None for the constant-step form).
        F_fn: ``F_fn(x, ops) -> (n,)`` float64 tensor (the right-hand side
            on the restricted dofs).
        J_fn: ``J_fn(x, ops) -> (n, n)`` dense float64 Jacobian tensor.
        M: dense ``(n, n)`` mass matrix (restricted; numpy or tensor).
        ops: device operands threaded into ``F_fn`` / ``J_fn``.
        solve_tol: relative residual every stage solve reaches.
        refine_maxiter: bound on the Richardson sweeps of one stage solve.
        host_scheme: optional fallback with the ``step(M, F, J, x, tau,
            data, Fx)`` protocol for a step whose stage solves miss
            `solve_tol` twice; pass the matching ``_RosenbrockScheme``.
        device: where the scheme runs (default: `M`'s device for a
            tensor, else the card).
    """

    def __init__(self, coeffs, F_fn, J_fn, M, ops, *, solve_tol=1e-11,
                 refine_maxiter=60, host_scheme=None, device=None):
        A, Gamma, b, b_hat = coeffs
        self.A, self.Gamma = np.asarray(A), np.asarray(Gamma)
        self.b, self.b_hat = b, b_hat
        self.solve_tol = float(solve_tol)
        self.refine_maxiter = int(refine_maxiter)
        self._host_scheme = host_scheme
        self._F_fn, self._J_fn, self._ops = F_fn, J_fn, ops
        if device is None and isinstance(M, torch.Tensor):
            device = M.device
        self.device = resolve_device(device)
        self._Mdev = torch.as_tensor(M, dtype=DTYPE, device=self.device)
        self._n = self._Mdev.shape[0]
        self._gamma = float(self.Gamma[0, 0])
        self._P = {}                       # tau -> W^-1
        self.n_host_reads = 0
        # steps this scheme handed to its host_scheme
        self.host_fallbacks = 0

    def truncated(self):
        """Constant-step form (no embedded estimate), as in
        :meth:`pyiga_tpu_torch.solvers._RosenbrockScheme.truncated`."""
        out = object.__new__(DeviceRosenbrockScheme)
        out.__dict__.update(self.__dict__)
        out.b_hat = None
        if self._host_scheme is not None:
            out._host_scheme = self._host_scheme.truncated()
        return out

    def _W(self, x, tau):
        J = self._J_fn(x, self._ops)
        return J, self._Mdev - (tau * self._gamma) * J

    def _precond(self, x, tau):
        P = self._P.get(float(tau))
        if P is None:
            P = torch.linalg.inv(self._W(x, float(tau))[1])
            if len(self._P) >= 8:
                self._P.pop(next(iter(self._P)))
            self._P[float(tau)] = P
        return P

    def _solve(self, W, P, b):
        """``W k = b`` by Richardson refinement with ``P ~ W^-1`` until
        ``||b - W k|| <= solve_tol ||b||`` (one host read per test);
        returns ``(k, relres)``."""
        nb = max(float(torch.linalg.vector_norm(b)), 1e-300)
        k = P @ b
        r = b - W @ k
        it = 0
        while True:
            res = float(torch.linalg.vector_norm(r))
            self.n_host_reads += 1
            if not (res > self.solve_tol * nb and it < self.refine_maxiter
                    and math.isfinite(res)):
                return k, res / nb
            k = k + P @ r
            r = b - W @ k
            it += 1

    def _stages(self, x, tau, P):
        """All `s` stage solves and the solution / embedded combinations
        of one step; returns ``(xnew, xhat, relres_max)`` (``xhat`` is
        None without embedded weights)."""
        Ac, Gc = self.A, self.Gamma
        J, W = self._W(x, tau)
        ks, relres_max = [], 0.0
        for i in range(Ac.shape[0]):
            y = x
            for j in range(i):
                if Ac[i, j] != 0.0:
                    y = y + (tau * Ac[i, j]) * ks[j]
            rhs = self._F_fn(y, self._ops)
            g = None
            for j in range(i):
                if Gc[i, j] != 0.0:
                    t = Gc[i, j] * ks[j]
                    g = t if g is None else g + t
            if g is not None:
                rhs = rhs + tau * (J @ g)
            k, relres = self._solve(W, P, rhs)
            relres_max = max(relres_max, relres)
            ks.append(k)

        def combine(weights):
            out = x
            for w, k in zip(np.asarray(weights, dtype=np.float64), ks):
                if w != 0.0:
                    out = out + (tau * w) * k
            return out

        xhat = None if self.b_hat is None else combine(self.b_hat)
        return combine(self.b), xhat, relres_max

    def _attempt(self, x, tau):
        """One step attempt at `x` (device tensor) with a cached or
        rebuilt ``P``: ``(xnew, xhat, ok)``."""
        for _ in range(2):
            xnew, xhat, relres = self._stages(x, tau, self._precond(x, tau))
            if (math.isfinite(relres) and relres <= 10 * self.solve_tol
                    and bool(torch.isfinite(xnew).all())):
                return xnew, xhat, True
            # stale or defective P: rebuild at the CURRENT state and
            # step size, then retry once
            self._P.pop(float(tau), None)
        return xnew, xhat, False

    def step(self, M, F, J, x, tau, data=None, Fx=None):
        """One step; same protocol and returns as
        ``_RosenbrockScheme.step`` (numpy `x` in, numpy out; ``M`` /
        ``F`` / ``J`` are used only by the host fallback)."""
        x = np.asarray(x, dtype=np.float64)
        xnew, xhat, ok = self._attempt(
            torch.as_tensor(x, dtype=DTYPE, device=self.device), float(tau))
        if ok:
            xnew = xnew.cpu().numpy()
            if self.b_hat is None:
                return xnew, None
            return xnew, xhat.cpu().numpy(), None
        if self._host_scheme is not None:
            self.host_fallbacks += 1
            return self._host_scheme.step(M, F, J, x, tau, data=data, Fx=Fx)
        raise RuntimeError('device Rosenbrock stage solve did not reach '
                           'solve_tol and no host fallback was provided')

    def integrate_adaptive(self, MFJ, x0, tau0, t_end, tol, err_order, *,
                           t0=0.0, step_factor=0.9, chunk=8,
                           progress=False):
        """Adaptive integration with the state on the device: the same
        (times, solutions) as :func:`pyiga_tpu_torch.solvers.
        _integrate_adaptive` over this scheme, in the controller's exact
        arithmetic.

        Unlike the JAX package, which fuses chunks of up to `chunk` step
        attempts into one device loop, this runs ONE step attempt per
        host read of its error norm (`chunk` is accepted and ignored):
        the accept/reject decision and the new step size are taken on the
        host, the state never leaves the device until the end, where the
        accepted states come back in one copy as numpy arrays.  A step
        whose stage solves fail twice hands the rest of the interval to
        the per-step path (:meth:`step`, whose host fallback is counted).
        `MFJ` is the ``(M, F, J)`` triple of the host path, used only
        there.  :attr:`n_attempts` counts the device's step attempts
        (accepted and rejected)."""
        from .. import solvers, utils

        n = self._n
        sqrt_n = np.sqrt(n)
        times = [float(t0)]
        xd = torch.as_tensor(np.asarray(x0, dtype=np.float64), dtype=DTYPE,
                             device=self.device)
        sols = [xd]
        t, tau = float(t0), float(tau0)
        tail = None
        self.n_attempts = 0
        with utils.progress_bar(progress)(total=t_end - t0) as pbar:
            while t < t_end:
                self.n_attempts += 1
                xnew, xhat, ok = self._attempt(xd, tau)
                if not ok:
                    tail = solvers._integrate_adaptive(
                        self, err_order, *MFJ, xd.cpu().numpy(), tau, t_end,
                        tol, t0=t, step_factor=step_factor,
                        progress=progress)
                    break
                weight = tol + tol * torch.abs(xd)
                r = float(torch.linalg.vector_norm((xhat - xnew) / weight))
                self.n_host_reads += 1
                r = max(r / sqrt_n, 1e-15)
                if r <= 1:              # accept
                    t += tau
                    xd = xnew
                    times.append(t)
                    sols.append(xd)
                    pbar.update(tau)
                    pbar.set_postfix({'tau': tau})
                tau *= min(5.0, max(0.2,
                                    step_factor * r ** (-1.0 / err_order)))
        sols = list(torch.stack(sols).cpu().numpy())
        if tail is not None:
            times += tail[0][1:]
            sols += tail[1][1:]
        return times, sols
