# -*- coding: utf-8 -*-
"""Instationary Navier-Stokes channel flow by a mixed spline discretization
with Rosenbrock (ROWDAIND2) time stepping, over :mod:`pyiga_tpu_torch`
(the port of ``examples/navier_stokes.py``: the same class, methods and
defaults, plus ``device=``; omitted, the card).

Discretization: Taylor-Hood-like spline pair (velocity degree p, 2
components; pressure degree p-1) on a channel; parabolic inflow on the
left, no-slip walls top/bottom, open outflow right.  The saddle-point DAE

    [M 0] d/dt [u]     [ nu*A + N(u)  B^T ] [u]
    [0 0]      [p]  = -[ B            0   ] [p]

is integrated by the index-2-capable ROWDAIND2 Rosenbrock method.  On the
host path the convection terms are reassembled through updatable
Assemblers; on the device path (:meth:`NavierStokes.integrate` with
``backend='device'``) the velocity fields are formed from the state on the
device and handed to the assemblers' ``run_device(inputs=...)``, which
runs the geometry fields (K2, K1), K5 and the K2/K3 chains on them with
the term tables kept from the first evaluation.

Run ``python examples/torch_navier_stokes.py`` on a machine with a CUDA
card, or ``python examples/torch_navier_stokes.py cpu`` on the CPU."""

import os
import sys

import numpy as np
import scipy.sparse
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from pyiga_tpu_torch import assemble, bspline, geometry, solvers  # noqa: E402
from pyiga_tpu_torch.config import DTYPE, resolve_device  # noqa: E402
from pyiga_tpu_torch.geometry import BSplineFunc  # noqa: E402


class NavierStokes:
    """Channel-flow Navier-Stokes setup (inflow left, outflow right)."""

    def __init__(self, n_el=(8, 16), p=2, Re=20.0, geo=None, device=None):
        self.device = resolve_device(device)
        self.Re = Re
        self.kvs_u = tuple(bspline.make_knots(p, 0.0, 1.0, n)
                           for n in n_el)
        self.kvs_p = tuple(bspline.make_knots(p - 1, 0.0, 1.0, n)
                           for n in n_el)
        self.geo = geo if geo is not None else \
            geometry.unit_square().scale([2, 1])

        self.m_u = tuple(kv.numdofs for kv in self.kvs_u)
        self.m_p = tuple(kv.numdofs for kv in self.kvs_p)
        self.n_u1 = int(np.prod(self.m_u))
        self.n_u = 2 * self.n_u1
        self.n_p = int(np.prod(self.m_p))

        # blocks
        dev = self.device
        self.A_grad = assemble.assemble(
            'inner(grad(u), grad(v)) * dx', self.kvs_u,
            bfuns=[('u', 2), ('v', 2)], geo=self.geo, device=dev)
        self.M_vel = assemble.assemble(
            'inner(u, v) * dx', self.kvs_u,
            bfuns=[('u', 2), ('v', 2)], geo=self.geo, device=dev)
        self.A_div = assemble.assemble(
            'div(u) * q * dx', (self.kvs_u, self.kvs_p),
            bfuns=[('u', 2, 0), ('q', 1, 1)], geo=self.geo, device=dev)
        self.M_pre = assemble.assemble('u * v * dx', self.kvs_p,
                                       geo=self.geo, device=dev)

        # steady Stokes operator over the full (u, p) vector
        self.A_stokes = scipy.sparse.bmat(
            [[self.A_grad / Re, self.A_div.T],
             [self.A_div, None]], format='csr')

        # updatable convection assemblers (nonlinear term and linearization)
        zero_vel = BSplineFunc(self.kvs_u, np.zeros(self.m_u + (2,)))
        self.asm_nlconv = assemble.Assembler(
            'grad(vel).dot(vel).dot(v) * dx', self.kvs_u,
            bfuns=[('v', 2)], geo=self.geo, vel=zero_vel, updatable=['vel'],
            device=dev)
        self.asm_linconv = assemble.Assembler(
            'grad(u).dot(vel).dot(v) * dx', self.kvs_u,
            bfuns=[('u', 2), ('v', 2)], geo=self.geo, vel=zero_vel,
            updatable=['vel'], device=dev)

        # boundary conditions: inflow left, no-slip walls, open right
        def g_inflow(x, y):
            return (4 * y * (1 - y), 0.0 * x)

        def g_zero(x, y):
            return (0.0 * x, 0.0 * x)

        self.bcs = assemble.compute_dirichlet_bcs(
            self.kvs_u, self.geo,
            [('bottom', g_zero), ('top', g_zero), ('left', g_inflow)])

        # restricted system over the combined (u, p) vector (the BC
        # indices only touch the velocity part)
        self.LS = assemble.RestrictedLinearSystem(self.A_stokes, 0.0,
                                                  self.bcs)

        # mass matrix over the full vector (zero pressure block), restricted
        M_full = scipy.sparse.bmat(
            [[self.M_vel, None],
             [None, scipy.sparse.csr_matrix((self.n_p, self.n_p))]],
            format='csr')
        self.ns_M = self.LS.restrict_matrix(M_full).tocsc()

    # -- helpers --------------------------------------------------------------

    def get_components(self, u_p):
        """Velocity and pressure of a full (u, p) vector as spline
        functions."""
        u1 = u_p[:self.n_u1].reshape(self.m_u)
        u2 = u_p[self.n_u1:self.n_u].reshape(self.m_u)
        U = np.stack((u1, u2), axis=-1)
        prs = u_p[self.n_u:].reshape(self.m_p)
        return (BSplineFunc(self.kvs_u, U), BSplineFunc(self.kvs_p, prs))

    def _apply_navier_stokes(self, u_p):
        vel, _ = self.get_components(u_p)
        z = self.asm_nlconv.assemble(vel=vel)
        nl = np.concatenate((np.asarray(z).ravel(), np.zeros(self.n_p)))
        return nl + self.A_stokes.dot(u_p)

    def _linearized_ns(self, u_p):
        vel, _ = self.get_components(u_p)
        A_lc = self.asm_linconv.assemble(vel=vel)
        return scipy.sparse.bmat(
            [[self.A_grad / self.Re + A_lc, self.A_div.T],
             [self.A_div, 1e-10 * self.M_pre]], format='csr')

    # -- DAE interface --------------------------------------------------------

    def F(self, x):
        u_p = self.LS.complete(x)
        return -self.LS.restrict(self._apply_navier_stokes(u_p))

    def J(self, x):
        u_p = self.LS.complete(x)
        return -self.LS.restrict_matrix(self._linearized_ns(u_p))

    def initial_state(self):
        """Restricted Stokes solution as the initial value."""
        from pyiga_tpu_torch.operators import make_solver
        return make_solver(self.LS.A).dot(self.LS.b)

    # -- stepping on the device -----------------------------------------------

    def _traceable_ops(self):
        """Device operands and ``F_fn(x, ops)`` / ``J_fn(x, ops)`` over the
        restricted dofs, float64 tensors on the setup's device: the
        velocity values and XYZ first derivatives on the Gauss grid by
        per-axis collocation tables (:func:`~pyiga_tpu_torch.ops.geom.
        tp_apply`), the convection blocks by the assemblers'
        ``run_device(inputs=...)``, everything else as precomputed dense
        blocks (see :class:`~pyiga_tpu_torch.ops.rosw.
        DeviceRosenbrockScheme` for why dense).  Each evaluation forms the
        geometry fields (two K2 stages, one K1 ``jac`` launch); then one
        ``F_fn`` launches K5 once and per velocity component one K2 stage
        and one K3 fold, one ``J_fn`` K5 once and per diagonal block two
        K2 stages and one K3 fold.  The linearized blocks are added into
        the dense ``K0`` at (row, column) pairs that are checked to be
        distinct, so the scatter is deterministic."""
        from pyiga_tpu_torch.ops.basis import dense_collocation_tables

        dev = self.device
        lin, nl = self.asm_linconv.asm, self.asm_nlconv.asm
        lin_keys = sorted(lin._block_plans())
        nl_keys = sorted(nl._block_plans())
        n_u1 = self.n_u1
        if any(len(g1) != len(g2) for g1, g2 in zip(lin.grid, nl.grid)):
            raise ValueError('the convection assemblers differ in grid')

        def tensor(a, dtype=DTYPE):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=dev)

        # per-axis collocation tables (Q_k, n_k) of the velocity space on
        # the (shared) Gauss grid, value and first derivative
        tabs = dense_collocation_tables(self.kvs_u, lin.grid, numderiv=1)
        val_tabs = [tensor(t[0].T) for t in tabs]
        der_tabs = [tensor(t[1].T) for t in tabs]

        # restricted dof bookkeeping
        N = self.n_u + self.n_p
        free = np.asarray(self.LS.R_free.nonzero()[1], dtype=np.int64)
        n = len(free)
        u_elim = self.LS.complete(np.zeros(n))
        pos = np.full(N, -1, dtype=np.int64)
        pos[free] = np.arange(n)

        # scatter plan: linearized-convection block entries -> dense (n, n)
        I, J = lin.structure.nonzero()
        flat, keep_idx = [], []
        for (cu, cv) in lin_keys:
            gr, gc = cv * n_u1 + I, cu * n_u1 + J
            keep = (pos[gr] >= 0) & (pos[gc] >= 0)
            flat.append(pos[gr[keep]] * n + pos[gc[keep]])
            keep_idx.append(np.nonzero(keep)[0])
        flat = np.concatenate(flat)
        if np.unique(flat).size != flat.size:
            raise ValueError('the linearized blocks overlap in the dense '
                             'Jacobian')

        # fixed dense blocks
        K0 = self.LS.restrict_matrix(scipy.sparse.bmat(
            [[self.A_grad / self.Re, self.A_div.T],
             [self.A_div, 1e-10 * self.M_pre]], format='csr')).toarray()

        ops = {
            'val_tabs': val_tabs, 'der_tabs': der_tabs,
            'K0': tensor(K0), 'Ast': tensor(self.A_stokes.toarray()),
            'uelim': tensor(u_elim), 'free': tensor(free, torch.int64),
            'flat': tensor(flat, torch.int64),
            'keep': [tensor(k, torch.int64) for k in keep_idx],
            'zeros_p': torch.zeros(self.n_p, dtype=DTYPE, device=dev),
        }

        def complete(x, ops):
            u_p = ops['uelim'].clone()
            u_p[ops['free']] = x
            return u_p

        def J_fn(x, ops):
            vals, _ = self.velocity_fields(complete(x, ops), ops, False)
            blocks = lin.run_device(inputs={'input:vel': vals})
            data = torch.cat([blocks[key].reshape(-1)[k]
                              for key, k in zip(lin_keys, ops['keep'])])
            K = ops['K0'].clone().reshape(-1)
            K[ops['flat']] += data
            return -K.reshape(ops['K0'].shape)

        def F_fn(x, ops):
            u_p = complete(x, ops)
            vals, ders = self.velocity_fields(u_p, ops)
            bn = nl.run_device(inputs={'input:vel': vals,
                                       'ideriv:vel:1': ders})
            zero = torch.zeros(n_u1, dtype=DTYPE, device=dev)
            nlvec = torch.cat(
                [bn[(None, c)].reshape(-1) if (None, c) in nl_keys else zero
                 for c in range(2)] + [ops['zeros_p']])
            return -(nlvec + ops['Ast'] @ u_p)[ops['free']]

        return F_fn, J_fn, ops

    def velocity_fields(self, u_p, ops, with_deriv=True):
        """The velocity of a full (u, p) tensor on the Gauss grid, ``(2,)
        + grid``, and its first derivatives ``(2, d) + grid`` (derivative
        axis in XYZ order) or None: the ``input:vel`` and ``ideriv:vel:1``
        operands of the convection assemblers, formed with the
        collocation tables of :meth:`_traceable_ops`' `ops`."""
        from pyiga_tpu_torch.ops.geom import tp_apply
        vt, dt = ops['val_tabs'], ops['der_tabs']
        d, n_u1 = len(self.kvs_u), self.n_u1
        comps = [u_p[c * n_u1:(c + 1) * n_u1].reshape(self.m_u)
                 for c in range(2)]
        vals = torch.stack([tp_apply(vt, c) for c in comps])
        if not with_deriv:
            return vals, None
        # coordinate k differentiates level axis d-1-k
        ders = torch.stack([
            torch.stack([tp_apply([dt[j] if j == d - 1 - k else vt[j]
                                   for j in range(d)], c)
                         for k in range(d)])
            for c in comps])
        return vals, ders

    def _device_scheme(self, method, host_fallback=False):
        """(scheme, err_order) for the device stepper (cached per method
        and fallback choice)."""
        cached = getattr(self, '_dev_scheme', None)
        if cached is not None and cached[0] == (method, host_fallback):
            return cached[1], cached[2]
        from pyiga_tpu_torch.ops.rosw import DeviceRosenbrockScheme
        A, Gamma, b, b_hat, err_order = getattr(
            solvers, 'coeffs_' + method)()
        F_fn, J_fn, ops = self._traceable_ops()
        host = (solvers._RosenbrockScheme(A, Gamma, b, b_hat)
                if host_fallback else None)
        scheme = DeviceRosenbrockScheme((A, Gamma, b, b_hat), F_fn, J_fn,
                                        self.ns_M.toarray(), ops,
                                        host_scheme=host, device=self.device)
        self._dev_scheme = ((method, host_fallback), scheme, err_order)
        return scheme, err_order

    def integrate(self, x0=None, tau=5e-2, t_end=0.5, method='rowdaind2',
                  tol=1e-2, progress=False, backend='auto',
                  device_cutoff=4096, host_fallback=False):
        """Integrate; returns (times, restricted states).

        ``backend='device'`` runs the Rosenbrock steps on the setup's
        device (:class:`~pyiga_tpu_torch.ops.rosw.DeviceRosenbrockScheme`:
        the convection terms reassembled from the state there, dense f64
        stage algebra); a step whose stage solves miss the scheme's
        ``solve_tol`` twice raises there, unless `host_fallback` is set,
        which hands such a step to the host scheme and counts it in the
        scheme's ``host_fallbacks``.  ``'host'`` is the reference path
        (sparse LU per step); ``'auto'`` takes 'device' on a CUDA device
        for restricted systems up to `device_cutoff` dofs (the dense
        stage algebra is O(n^2) memory).  Both give the same step
        sequence."""
        if x0 is None:
            x0 = self.initial_state()
        if backend == 'auto':
            n_free = self.LS.R_free.shape[0]
            backend = ('device'
                       if self.device.type == 'cuda'
                       and n_free <= device_cutoff
                       and hasattr(solvers, 'coeffs_' + method)
                       else 'host')
        if backend not in ('host', 'device'):
            raise ValueError("backend must be 'auto', 'host' or 'device'")
        self.last_backend = backend
        if backend == 'device':
            scheme, err_order = self._device_scheme(method, host_fallback)
            if tol is not None:
                return scheme.integrate_adaptive(
                    (self.ns_M, self.F, self.J), x0, tau, t_end, tol,
                    err_order, progress=progress)
            return solvers._integrate_adaptive(
                scheme, err_order, self.ns_M, self.F, self.J, x0, tau,
                t_end, tol, progress=progress)
        stepper = getattr(solvers, method)
        return stepper(self.ns_M, self.F, self.J, x0, tau, t_end, tol=tol,
                       progress=progress)

    def divergence_norm(self, x):
        u_p = self.LS.complete(x)
        return np.linalg.norm(self.A_div @ u_p[:self.n_u])


if __name__ == '__main__':
    ns = NavierStokes(n_el=(8, 16), p=2, Re=20.0,
                      device=sys.argv[1] if len(sys.argv) > 1 else None)
    times, states = ns.integrate(tau=5e-2, t_end=0.5, progress=True)
    print('steps:', len(times) - 1, '(%s)' % ns.last_backend)
    print('final divergence norm:', ns.divergence_norm(states[-1]))
    vel, pre = ns.get_components(ns.LS.complete(states[-1]))
    print('velocity magnitude range:', float(np.abs(vel.coeffs).max()))
