# -*- coding: utf-8 -*-
"""Fast-diagonalization preconditioner [Sangalli, Tani 2016] (port of
:mod:`pyiga_tpu.ops.fastdiag`).

The parameter-domain operator ``sum_k K_k (x) M_...`` is diagonalized by
per-axis generalized eigendecompositions ``K_k U_k = M_k U_k diag(lam_k)``
(host scipy, tiny 1D matrices); its inverse applies as

    P^{-1} = (U_1 (x) ... (x) U_d) D^{-1} (U_1^T (x) ... (x) U_d^T)

— 2d small dense tensordots plus a diagonal scale on the device.
"""

import warnings

import numpy as np
import scipy.linalg
import torch

from ..config import get_dtype, no_tf32, resolve_device
from ..quadrature import make_iterated_quadrature
from . import geom
from .basis import dense_basis_table
from .matfree import box_restriction


def _build_precond(KM, full_shape, free_dofs, dirichlet, dtype, mass_shift,
                   device):
    """Per-axis restriction, eigendecomposition and the eigenvalue-sum
    diagonal.  `KM` is the list of full per-axis ``(K_k, M_k)`` dense
    matrices.  A box-shaped `free_dofs` set restricts the per-axis
    eigenproblems exactly; any other set applies the unrestricted
    diagonalization between an extension and a restriction."""
    if dirichlet and free_dofs is not None:
        raise ValueError('pass either dirichlet=True or free_dofs, not both')
    slices = None
    free = None
    if free_dofs is not None:
        free_np = np.asarray(free_dofs, dtype=np.int64)
        n_full = int(np.prod(full_shape))
        if free_np.size and (free_np.min() < 0 or free_np.max() >= n_full):
            raise ValueError('free_dofs out of range for the space '
                             '(did you combine it with dirichlet=True?)')
        box = box_restriction(free_np, full_shape)
        if box is not None:
            lo, box_shape = box
            slices = [slice(l, l + s) for l, s in zip(lo, box_shape)]
        else:
            free = torch.as_tensor(free_np, device=device)
    if dirichlet:
        slices = [slice(1, -1)] * len(KM)

    Us, lams, ns = [], [], []
    for k, (K, M) in enumerate(KM):
        if slices is not None:
            K = K[slices[k], slices[k]]
            M = M[slices[k], slices[k]]
        lam, U = scipy.linalg.eigh(K, M)
        Us.append(U)
        lams.append(lam)
        ns.append(U.shape[0])

    d = len(KM)
    diag = np.full(tuple(ns), float(mass_shift))
    for k in range(d):
        shape = [1] * d
        shape[k] = -1
        diag = diag + lams[k].reshape(shape)
    if np.min(np.abs(diag)) < 1e-12 * np.max(np.abs(diag)):
        warnings.warn(
            'fastdiag preconditioner is nearly singular: the pure-Neumann '
            'operator has a zero eigenvalue on an unrestricted space. Pass '
            'dirichlet=True or a box-shaped free_dofs set for a Dirichlet '
            'problem, or mass_shift>0 for an operator with a mass term.')

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)
    return FastDiagPrecond([dev(U) for U in Us], [dev(U.T) for U in Us],
                           dev(1.0 / diag), tuple(ns),
                           int(np.prod(full_shape)), free)


class FastDiagPrecond:
    """Callable preconditioner ``r -> P^{-1} r`` on raveled vectors.  It
    carries the operand protocol of :func:`~pyiga_tpu_torch.solvers.
    cg_jit` (``operands`` with the tensors ``Us``, ``UTs``, ``inv_diag``
    and ``free``, and ``apply_with_operands(operands, r)``), as the JAX
    package's preconditioner does."""

    def __init__(self, Us, UTs, inv_diag, ns, n_total, free):
        self.operands = {'Us': Us, 'UTs': UTs, 'inv_diag': inv_diag,
                         'free': free}
        self.ns, self.n_total = ns, n_total

    Us = property(lambda self: self.operands['Us'])
    UTs = property(lambda self: self.operands['UTs'])
    inv_diag = property(lambda self: self.operands['inv_diag'])
    free = property(lambda self: self.operands['free'])

    def apply_with_operands(self, operands, r):
        free = operands['free']
        if free is not None:
            rf = r
            r = torch.zeros(self.n_total, dtype=rf.dtype, device=rf.device)
            r[free] = rf
        X = r.reshape(self.ns)
        with no_tf32(X.dtype):
            for k, UT in enumerate(operands['UTs']):
                X = torch.movedim(torch.tensordot(UT, X, dims=([1], [k])),
                                  0, k)
            X = X * operands['inv_diag']
            for k, U in enumerate(operands['Us']):
                X = torch.movedim(torch.tensordot(U, X, dims=([1], [k])),
                                  0, k)
        out = X.reshape(-1)
        if free is not None:
            out = out[free]
        return out

    def __call__(self, r):
        return self.apply_with_operands(self.operands, r)


def _biform_1d(kv, deriv):
    """1D matrix ``int B_i^(deriv) B_j^(deriv)`` by the Gauss rule exact
    for its degree (``bsp_mass_1d`` / ``bsp_stiffness_1d`` of the JAX
    package), dense."""
    nodes, weights = make_iterated_quadrature(kv.mesh, kv.p - deriv + 1)
    B = dense_basis_table(kv, nodes, deriv)[deriv]          # (n, Q)
    return (B * weights) @ B.T


def fastdiag_precond(kvs, free_dofs=None, dirichlet=False, dtype=None,
                     mass_shift=0.0, device=None):
    """Fast-diagonalization preconditioner of the parameter-domain
    Laplacian (+ `mass_shift` identity) over the TP space `kvs`: per axis
    the unweighted 1D stiffness and mass matrices.

    `free_dofs` / `dirichlet` / `mass_shift` as in
    :func:`fastdiag_precond_weighted`; `dtype` defaults to the compute
    dtype, the preconditioner lives on `device` (default: the card).
    Returns a callable ``r -> P^{-1} r`` on raveled vectors (a float32
    one applies its products in full float32,
    :func:`~pyiga_tpu_torch.config.no_tf32`)."""
    KM = [(_biform_1d(kv, 1), _biform_1d(kv, 0)) for kv in kvs]
    full_shape = tuple(kv.numdofs for kv in kvs)
    return _build_precond(KM, full_shape, free_dofs, dirichlet,
                          get_dtype() if dtype is None else dtype,
                          mass_shift, resolve_device(device))


def interior_dofs(kvs):
    """Raveled indices of the per-axis interior dofs (all-Dirichlet case)."""
    ranges = [np.arange(1, kv.numdofs - 1) for kv in kvs]
    shape = tuple(kv.numdofs for kv in kvs)
    grid = np.meshgrid(*ranges, indexing='ij')
    return np.ravel_multi_index([g.ravel() for g in grid], shape)


def _axis_means(gi, d):
    """Per axis k: the means over the other axes of ``B_kk / Wg`` and
    ``W / Wg`` (``Wg`` the Gauss weight product), scaled by the axis-k
    Gauss weights — the 1D coefficient vectors of the weighted
    preconditioner.  `gi` holds float64 tensors: a spline geometry's
    tables and coefficients, or a host-evaluated Jacobian ``jac``
    (as ``_geo_weight_jacinv`` of the JAX package reads either)."""
    if 'jac' in gi:
        jac = gi['jac']
    else:
        nurbs = 'geo_tables_nurbs' in gi
        tables = gi['geo_tables_nurbs' if nurbs else 'geo_tables_bsp']
        _, jac = geom.geo_jacobian_field(tables, gi['geo_coeffs'], nurbs,
                                         len(tables))
    det, jacinv = geom.det_and_inv(jac)
    gw = gi['weights']
    Wg = geom.gauss_weight_field(gw)
    W = Wg * torch.abs(det)
    outs = []
    for k in range(d):
        axes = tuple(j for j in range(d) if j != k)
        Bkk = W * sum(jacinv[k][m] ** 2 for m in range(d))
        c = (Bkk / Wg).mean(dim=axes) * gw[k]
        m = (W / Wg).mean(dim=axes) * gw[k]
        outs.append((c, m))
    return outs


def fastdiag_precond_weighted(asm, free_dofs=None, dirichlet=False,
                              dtype=None, mass_shift=0.0):
    """Fast-diagonalization preconditioner with *geometry-averaged* 1D
    coefficients (cf. Montardini-Sangalli-Tani): for each axis k the 1D
    stiffness matrix is weighted by the mean of the diffusion field
    ``B_kk = W (J^-1 J^-T)_kk`` over the other axes, and the 1D mass matrix
    by the mean of the weight field ``W``.

    Args:
        asm: a Gauss assembler over the space (its geometry inputs,
            quadrature and device are used).
        free_dofs / dirichlet / mass_shift: as in the JAX package.
        dtype: the preconditioner's torch dtype; default the compute
            dtype (:func:`~pyiga_tpu_torch.config.get_dtype`), as the JAX
            package (pass float32 for the inner solves of
            :func:`~pyiga_tpu_torch.solvers.cg_ir`).

    The axis means are computed in float64 whatever `dtype` is, as the
    JAX package computes them (no kernel runs there).
    """
    d = asm.dim
    cms = _axis_means(asm.geo_inputs(torch.float64), d)
    KM = []
    for k in range(d):
        c = cms[k][0].cpu().numpy()
        m = cms[k][1].cpu().numpy()
        Bt = asm.tables.trial[k]        # 1D basis tables (derivs >= 1)
        KM.append(((Bt[1] * c) @ Bt[1].T, (Bt[0] * m) @ Bt[0].T))
    full_shape = tuple(kv.numdofs for kv in asm.kvs)
    return _build_precond(KM, full_shape, free_dofs, dirichlet,
                          get_dtype() if dtype is None else dtype,
                          mass_shift, asm.device)
