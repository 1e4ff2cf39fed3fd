# -*- coding: utf-8 -*-
"""Geometry fields on tensor-product Gauss grids (port of
:mod:`pyiga_tpu.ops.geom`, float64 only — the two-float ``*_df``
variants exist for the TPU's missing f64 and are not ported).

Layout: component axes lead, grid axes trail — values ``(C, Q_1, ..., Q_d)``,
Jacobians ``(C, sdim, Q_1, ..., Q_d)``.  Everything is in *level order*:
axis k of the grid belongs to ``kvs[k]``, and :func:`geo_eval_tables`
reverses the geometry's XYZ components into that order so that Jacobians
are square matrices in one consistent ordering (determinants are invariant
under the simultaneous row/column reversal).

These plain tensor functions serve the fast-diagonalization coefficient
means and the reference path; the assembly's own fields come from kernel
K1 (:func:`~pyiga_tpu_torch.ops.cuda_sumfac.fields`).
"""

import numpy as np
import torch

from .. import geometry, utils
from .basis import dense_collocation_tables


def geo_eval_tables(geo, grids, numderiv=1):
    """Host-side setup: dense per-axis basis tables of the geometry space on
    the given grids, plus the (homogeneous, level-ordered, component-leading)
    coefficients.

    Returns ``(tables, coeffs, is_nurbs)`` where tables[k] has shape
    ``(numderiv+1, Q_k, n_k)`` and coeffs has shape ``(C, n_1, ..., n_d)``
    (numpy float64), or None for a geometry that is no spline (a
    :class:`~pyiga_tpu_torch.geometry.UserFunction`): the caller then
    evaluates its Jacobian on the host (:func:`host_jacobian_levelorder`)."""
    if isinstance(geo, geometry.NurbsFunc):
        coeffs, is_nurbs = geo.coeffs, True      # homogeneous incl. weight
    elif isinstance(geo, geometry.BSplineFunc):
        coeffs, is_nurbs = geo.coeffs, False
        if coeffs.ndim == geo.sdim:              # scalar-valued: add axis
            coeffs = coeffs[..., None]
    else:
        return None
    tables = [np.ascontiguousarray(B.swapaxes(-2, -1))     # (nd+1, Q, n)
              for B in dense_collocation_tables(geo.kvs, grids, numderiv)]
    # reverse vector components into level order (weight stays last)
    if is_nurbs:
        coeffs = np.concatenate(
            (coeffs[..., -2::-1], coeffs[..., -1:]), axis=-1)
    else:
        coeffs = coeffs[..., ::-1]
    coeffs = np.ascontiguousarray(np.moveaxis(coeffs, -1, 0))
    return tables, coeffs, is_nurbs


def tp_apply(tables, coeffs, lead=0):
    """Contract per-axis tables ``T_k (Q_k, n_k)`` against axes
    ``lead..lead+d-1`` of `coeffs`; the contracted axes become the trailing
    grid axes ``(Q_1, ..., Q_d)`` in order."""
    X = coeffs
    for k, T in enumerate(tables):
        X = torch.movedim(torch.tensordot(T, X, dims=([1], [lead + k])),
                          0, lead + k)
    return X


def deriv_1(val_tabs, der_tabs, coeffs, k, sdim):
    """The first partial derivative along level axis `k` of the
    tensor-product function with `coeffs` ``(C, n_1, ..., n_d)``: the
    derivative table on axis `k`, the value tables elsewhere; returns
    ``(C,) + grid``."""
    ops = [der_tabs[j] if j == k else val_tabs[j] for j in range(sdim)]
    return tp_apply(ops, coeffs, lead=1)


def geo_jacobian_field(tables, coeffs, is_nurbs, sdim):
    """Values and Jacobians of the geometry on the TP grid.

    `tables` are the per-axis ``(nd+1, Q_k, n_k)`` tensors of
    :func:`geo_eval_tables`.  Returns ``(val, jac)`` with shapes
    ``(dim,) + grid`` and ``(dim, sdim) + grid``, level order."""
    val_tabs = [t[0] for t in tables]
    der_tabs = [t[1] for t in tables]
    val = tp_apply(val_tabs, coeffs, lead=1)        # (C, Q...)
    jac = torch.stack([deriv_1(val_tabs, der_tabs, coeffs, k, sdim)
                       for k in range(sdim)], dim=1)  # (C, sdim, Q...)
    if is_nurbs:
        V, W = val[:-1], val[-1:]
        Vj, Wj = jac[:-1], jac[-1:]
        val = V / W
        jac = (Vj * W[:, None] - V[:, None] * Wj) / (W[:, None] ** 2)
    return val, jac


def hessian_from_chains(chain, sdim, is_nurbs):
    """The parametric Hessian ``(dim, sdim, sdim) + grid`` from `chain`,
    which maps per-axis derivative orders ``D`` to the coefficients
    contracted with them, ``(C,) + grid``: the ``sdim (sdim + 1) / 2``
    second-derivative combinations, mirrored, and for NURBS the value and
    the first derivatives through the quotient rule."""
    H = [[None] * sdim for _ in range(sdim)]
    for i in range(sdim):
        for j in range(i, sdim):
            D = sdim * [0]
            D[i] += 1
            D[j] += 1
            H[i][j] = H[j][i] = chain(D)
    hess = torch.stack([torch.stack(row, dim=1) for row in H], dim=1)
    if not is_nurbs:
        return hess
    val = chain(sdim * [0])
    jac = torch.stack([chain([int(j == k) for j in range(sdim)])
                       for k in range(sdim)], dim=1)
    return nurbs_hessian(val, jac, hess)


def geo_hessian_field(tables, coeffs, is_nurbs, sdim):
    """Parametric Hessians of the geometry on the TP grid.

    Requires tables with ``numderiv >= 2``.  Returns ``(dim, sdim, sdim) +
    grid`` (symmetric in the two derivative axes), level order, components
    leading; for NURBS the second-order quotient rule
    (``pyiga_tpu/ops/geom.py:91-130``)."""
    return hessian_from_chains(
        lambda D: tp_apply([tables[j][D[j]] for j in range(sdim)], coeffs,
                           lead=1), sdim, is_nurbs)


def nurbs_hessian(val, jac, hess):
    """The second-order quotient rule: the Hessian of ``V / W`` from the
    homogeneous values ``(C,) + grid``, Jacobian ``(C, sdim) + grid`` and
    Hessian ``(C, sdim, sdim) + grid`` (weight last)."""
    V, W = val[:-1], val[-1:]
    Vj, Wj = jac[:-1], jac[-1:]
    Nj = (Vj * W[:, None] - V[:, None] * Wj) / (W[:, None] ** 2)
    Vh, Wh = hess[:-1], hess[-1:]
    W2 = W[:, None, None]
    part1 = Vh / W2 - V[:, None, None] * Wh / (W2 ** 2)
    # sym(jac(V/W) (x) jac(W)) / W
    mat = (Nj[:, :, None] * Wj[:, None, :]) / W2
    mat = mat + torch.swapaxes(mat, 1, 2)
    return part1 - mat


def det_and_inv(J):
    """Determinant and inverse of small (1x1/2x2/3x3) matrices stored
    component-leading: ``J (d, d) + grid``.  Explicit adjugate formulas.

    Returns ``(det, inv)`` with shapes ``grid`` and ``(d, d) + grid``."""
    d = J.shape[0]
    if d == 1:
        det = J[0, 0]
        return det, (1.0 / det)[None, None]
    if d == 2:
        a, b = J[0, 0], J[0, 1]
        c, e = J[1, 0], J[1, 1]
        det = a * e - b * c
        inv = torch.stack([torch.stack([e, -b]), torch.stack([-c, a])]) / det
        return det, inv
    if d == 3:
        c00 = J[1, 1] * J[2, 2] - J[1, 2] * J[2, 1]
        c01 = J[1, 2] * J[2, 0] - J[1, 0] * J[2, 2]
        c02 = J[1, 0] * J[2, 1] - J[1, 1] * J[2, 0]
        det = J[0, 0] * c00 + J[0, 1] * c01 + J[0, 2] * c02
        adj = torch.stack([
            torch.stack([c00,
                         J[0, 2] * J[2, 1] - J[0, 1] * J[2, 2],
                         J[0, 1] * J[1, 2] - J[0, 2] * J[1, 1]]),
            torch.stack([c01,
                         J[0, 0] * J[2, 2] - J[0, 2] * J[2, 0],
                         J[0, 2] * J[1, 0] - J[0, 0] * J[1, 2]]),
            torch.stack([c02,
                         J[0, 1] * J[2, 0] - J[0, 0] * J[2, 1],
                         J[0, 0] * J[1, 1] - J[0, 1] * J[1, 0]]),
        ])
        return det, adj / det
    raise NotImplementedError('det_and_inv only implemented for d <= 3')


def host_jacobian_levelorder(geo, grids):
    """Geometry Jacobian on the grid, evaluated on the host: level-ordered
    and component-leading, shape ``(dim, sdim) + grid`` (numpy).  Both
    trailing axes of ``geo.grid_jacobian`` are reversed into level order
    (XYZ -> ZYX), which transposes nothing: a non-symmetric Jacobian
    keeps its orientation."""
    jac = np.asarray(geo.grid_jacobian(grids))[..., ::-1, ::-1]
    return np.ascontiguousarray(np.moveaxis(jac, (-2, -1), (0, 1)))


def host_eval(geo, grids):
    """Geometry values on the grid, evaluated on the host (XYZ component
    order, numpy)."""
    return np.asarray(utils.grid_eval(geo, grids))


def check_replacement(old, new, dtype, device):
    """Raise unless `new` can replace a spline geometry's coefficients
    `old` (None for a host-evaluated geometry, which has none to
    replace): the same shape, `dtype`, on `device`."""
    if old is None:
        raise ValueError('the assembler was set up with a host-evaluated '
                         'geometry, which has no coefficients to replace')
    if tuple(new.shape) != tuple(old.shape) or new.dtype != dtype \
            or new.device != device:
        raise ValueError('geo_coeffs %s does not replace the coefficients '
                         '%s of the same dtype and device'
                         % (tuple(new.shape), tuple(old.shape)))


def gauss_weight_field(weights):
    """Outer product of per-axis Gauss weight vectors over the TP grid."""
    W = weights[0]
    for w in weights[1:]:
        W = W[..., None] * w
    return W


def gauss_weight_factors(weights):
    """The Gauss weight field as two factors, the flattened product
    ``w12`` of the leading axes' weight vectors (a one on a 1D grid) and
    the last axis' ``wL``: ``w12[:, None] * wL`` is
    :func:`gauss_weight_field` bit for bit, ``(w0 w1) w2``."""
    wL = weights[-1]
    w12 = (gauss_weight_field(weights[:-1]).reshape(-1) if len(weights) > 1
           else torch.ones(1, dtype=wL.dtype, device=wL.device))
    return w12.contiguous(), wL.contiguous()
