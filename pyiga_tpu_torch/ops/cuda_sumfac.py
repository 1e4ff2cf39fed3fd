# -*- coding: utf-8 -*-
"""CUDA kernels of the sum-factorization assembly and the pipeline built
on them (counterpart of :mod:`pyiga_tpu.ops.pallas_sumfac`).

Five kernels (sources in ``csrc/fields.cu`` for K1 and K1',
``csrc/sumfac.cu`` for the rest), each beside its plain PyTorch version:

* K1 :func:`fields` — geometry fields ``B_ab = W (J^-1 J^-T)_ab`` per
  Gauss point, fusing the last-axis Jacobian contraction, the NURBS
  quotient rule, det/inverse and the weight (``_fields_fused``);
  :func:`fields_mass`, its ``mass`` kind: the mass field ``W``; and
  :func:`geo_jac_fields`, its ``jac`` kind: physical geometry values and
  Jacobian for the generic VForm fields;
* K1' :func:`host_jac_fields` — the stiffness fields from a Jacobian
  evaluated on the host (``stiffness_fields_pallas``'s non-spline
  branch);
* K2 :func:`stage` — one contraction stage ``(K, R) x (M, K) -> (R, M)``
  (``_stage_call``);
* K3 :func:`fold` — the final stage of all terms summed into one output
  written once, the terms that share a table summed before it
  (``_stage_call_fold``);
* K7 :func:`stage_T` — one stage with the transposed output
  (``_stage_call_T``), and :func:`tail_fused` — stage 2 and the folded
  final stage of all terms of a 3-axis chain in one kernel
  (``_tail_fused_call``), taken by :func:`chain_folded` when
  :data:`TAIL_FUSED` is on.

Each wrapper dispatches on the device of its input: a CPU tensor runs the
plain version, a CUDA tensor launches the kernel (and raises if it cannot);
nothing falls back.  Chain convention (as on the TPU): every stage
contracts the CURRENT leading axis and appends the band axis last, so a
d-stage chain maps ``(K_1, ..., K_d)`` to ``(M_1, ..., M_d)`` without
transposes.
"""

import ctypes
import os

import numpy as np
import torch

from .. import _cuda
from . import geom
from .banded import flat_banded_from_padded_chain


def _kernel_device(t, name):
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.is_cuda:
        return True
    if t.device.type == 'cpu':
        return False
    raise ValueError('%s: unsupported device %s' % (name, t.device))


################################################################################
# K1: geometry fields
################################################################################

def _jacobian_plain(Y, T, nurbs):
    """Physical Jacobian ``(d, d, Q12, QL)`` from the stage-1/2 partials:
    the last-axis contraction and, for NURBS, the quotient rule (the part
    the K1 kinds share)."""
    d, C = Y.shape[0], Y.shape[1]
    Tv, Td = T[0], T[1]

    def contract(t, c, tab):            # (Q12, nL) x (QL, nL) -> (Q12, QL)
        return torch.tensordot(Y[t, c], tab, dims=([1], [1]))

    jac = [[contract(min(k, d - 1), c, Td if k == d - 1 else Tv)
            for k in range(d)] for c in range(C)]
    if nurbs:
        val = [contract(d - 1, c, Tv) for c in range(C)]
        W = val[-1]
        jac = [[(jac[c][k] * W - val[c] * jac[-1][k]) / (W * W)
                for k in range(d)] for c in range(d)]
    return torch.stack([torch.stack(row) for row in jac])


def _unique_stiffness(inv, W):
    """``W (J^-1 J^-T)_ab`` for ``a <= b`` row-major, stacked."""
    d = inv.shape[0]
    return torch.stack([W * sum(inv[a, m] * inv[b, m] for m in range(d))
                        for a in range(d) for b in range(a, d)])


def fields_plain(Y, T, w12, wL, nurbs):
    """Plain PyTorch version of :func:`fields` (same inputs and output)."""
    det, inv = geom.det_and_inv(_jacobian_plain(Y, T, nurbs))
    return _unique_stiffness(inv, w12[:, None] * wL[None, :] * torch.abs(det))


def _check_fields_args(name, Y, T, w12, wL, nurbs):
    """Validate K1's operands; returns ``(d, Q12, QL, nL)``."""
    f64 = torch.float64
    _cuda.require(Y, 'Y', f64, 4)
    _cuda.require(T, 'T', f64, 3)
    _cuda.require(w12, 'w12', f64, 1)
    _cuda.require(wL, 'wL', f64, 1)
    d, C, Q12, nL = Y.shape
    QL = T.shape[1]
    if d not in (2, 3) or C != d + int(bool(nurbs)):
        raise ValueError('%s: need d in (2, 3) and C = d (+1 for NURBS)'
                         ', got d=%d C=%d' % (name, d, C))
    if T.shape != (2, QL, nL) or w12.shape != (Q12,) or wL.shape != (QL,):
        raise ValueError('%s: shapes Y %s, T %s, w12 %s, wL %s disagree'
                         % (name, tuple(Y.shape), tuple(T.shape),
                            tuple(w12.shape), tuple(wL.shape)))
    return d, Q12, QL, nL


def fields(Y, T, w12, wL, nurbs):
    """K1: unique stiffness fields on the Gauss grid.

    Args:
        Y: ``(d, C, Q12, nL)`` stage-1/2 geometry partials
            (:func:`geo_stage12`); ``C = d`` (B-spline) or ``d + 1``
            (NURBS, weight last).
        T: ``(2, QL, nL)`` last-axis value and derivative tables.
        w12: ``(Q12,)`` product of the leading axes' Gauss weights.
        wL: ``(QL,)`` last-axis Gauss weights.
        nurbs: whether `Y` carries homogeneous NURBS components.

    Returns ``(d(d+1)/2, Q12, QL)``: ``B_ab`` for ``a <= b`` row-major."""
    if not _kernel_device(Y, 'fields'):
        return fields_plain(Y, T, w12, wL, nurbs)
    d, Q12, QL, nL = _check_fields_args('fields', Y, T, w12, wL, nurbs)
    out = torch.empty((d * (d + 1) // 2, Q12, QL), dtype=torch.float64,
                      device=Y.device)
    with _cuda.device_of(Y):
        err = _cuda.library().pyiga_stiff_fields_f64(
            Y.data_ptr(), T.data_ptr(), w12.data_ptr(), wL.data_ptr(),
            out.data_ptr(), d, int(bool(nurbs)), Q12, QL, nL,
            _cuda.stream_of(Y))
    _cuda.check(err, 'fields')
    _cuda.LAUNCHES['fields'] += 1
    return out


def fields_mass_plain(Y, T, w12, wL, nurbs):
    """Plain PyTorch version of :func:`fields_mass`."""
    det, _ = geom.det_and_inv(_jacobian_plain(Y, T, nurbs))
    return w12[:, None] * wL[None, :] * torch.abs(det)


def fields_mass(Y, T, w12, wL, nurbs):
    """K1, ``mass`` kind: the mass field ``W = w12 (x) wL |det J|`` on the
    Gauss grid, from the same inputs as :func:`fields` (for NURBS the
    quotient rule runs before the determinant).  Returns ``(Q12, QL)``,
    float64."""
    if not _kernel_device(Y, 'fields_mass'):
        return fields_mass_plain(Y, T, w12, wL, nurbs)
    d, Q12, QL, nL = _check_fields_args('fields_mass', Y, T, w12, wL, nurbs)
    out = torch.empty((Q12, QL), dtype=torch.float64, device=Y.device)
    with _cuda.device_of(Y):
        err = _cuda.library().pyiga_mass_fields_f64(
            Y.data_ptr(), T.data_ptr(), w12.data_ptr(), wL.data_ptr(),
            out.data_ptr(), d, int(bool(nurbs)), Q12, QL, nL,
            _cuda.stream_of(Y))
    _cuda.check(err, 'fields_mass')
    _cuda.LAUNCHES['mass_fields'] += 1
    return out


def host_jac_fields_plain(jac, gw):
    """Plain PyTorch version of :func:`host_jac_fields`."""
    det, inv = geom.det_and_inv(jac)
    return _unique_stiffness(inv, gw * torch.abs(det))


def host_jac_fields(jac, gw):
    """K1': unique stiffness fields from a Jacobian evaluated on the host.

    Args:
        jac: ``(d, d, N)`` level-ordered Jacobian at the N Gauss points
            (:func:`~pyiga_tpu_torch.ops.geom.host_jacobian_levelorder`,
            flattened).
        gw: ``(N,)`` Gauss weight product.

    Returns ``(d(d+1)/2, N)``: ``B_ab = gw |det J| (J^-1 J^-T)_ab`` for
    ``a <= b`` row-major, the order :func:`stiffness_fields` expands.
    Any N: the TPU kernel's lane-multiple gate is a tiling rule of its
    own."""
    if not _kernel_device(jac, 'host_jac_fields'):
        return host_jac_fields_plain(jac, gw)
    _cuda.require(jac, 'jac', torch.float64, 3)
    _cuda.require(gw, 'gw', torch.float64, 1)
    d, N = jac.shape[0], jac.shape[2]
    if d not in (2, 3) or jac.shape[1] != d or gw.shape != (N,):
        raise ValueError('host_jac_fields: need jac (d, d, N) with d in '
                         '(2, 3) and gw (N,), got %s and %s'
                         % (tuple(jac.shape), tuple(gw.shape)))
    out = torch.empty((d * (d + 1) // 2, N), dtype=torch.float64,
                      device=jac.device)
    with _cuda.device_of(jac):
        err = _cuda.library().pyiga_host_jac_fields_f64(
            jac.data_ptr(), gw.data_ptr(), out.data_ptr(), d, N,
            _cuda.stream_of(jac))
    _cuda.check(err, 'host_jac_fields')
    _cuda.LAUNCHES['host_jac_fields'] += 1
    return out


def geo_jac_fields_plain(Y, T, nurbs):
    """Plain PyTorch version of :func:`geo_jac_fields`."""
    d, C = Y.shape[0], Y.shape[1]
    Tv, Td = T[0], T[1]

    def contract(t, c, tab):            # (Q12, nL) x (QL, nL) -> (Q12, QL)
        return torch.tensordot(Y[t, c], tab, dims=([1], [1]))

    jac = [[contract(min(k, d - 1), c, Td if k == d - 1 else Tv)
            for k in range(d)] for c in range(C)]
    val = [contract(d - 1, c, Tv) for c in range(C)]
    if nurbs:
        W = val[-1]
        jac = [[(jac[c][k] * W - val[c] * jac[-1][k]) / (W * W)
                for k in range(d)] for c in range(d)]
        val = [v / W for v in val[:-1]]
    return torch.stack(val + [x for row in jac for x in row])


def geo_jac_fields(Y, T, nurbs):
    """K1, ``jac`` kind: physical geometry values and Jacobian on the
    Gauss grid.

    Args:
        Y: ``(d, C, Q12, nL)`` stage-1/2 geometry partials
            (:func:`geo_stage12`), ``C = d`` (+1 for NURBS, weight last).
        T: ``(2, QL, nL)`` last-axis value and derivative tables.
        nurbs: whether `Y` carries homogeneous NURBS components.

    Returns ``(d + d*d, Q12, QL)``: the values ``x_c`` (level order), then
    the Jacobian ``J[c][k]`` row-major."""
    if not _kernel_device(Y, 'geo_jac_fields'):
        return geo_jac_fields_plain(Y, T, nurbs)
    f64 = torch.float64
    _cuda.require(Y, 'Y', f64, 4)
    _cuda.require(T, 'T', f64, 3)
    d, C, Q12, nL = Y.shape
    QL = T.shape[1]
    if d not in (1, 2, 3) or C != d + int(bool(nurbs)):
        raise ValueError('geo_jac_fields: need d in (1, 2, 3) and C = d '
                         '(+1 for NURBS), got d=%d C=%d' % (d, C))
    if T.shape != (2, QL, nL) or T.device != Y.device:
        raise ValueError('geo_jac_fields: T %s disagrees with Y %s'
                         % (tuple(T.shape), tuple(Y.shape)))
    out = torch.empty((d + d * d, Q12, QL), dtype=f64, device=Y.device)
    with _cuda.device_of(Y):
        err = _cuda.library().pyiga_geo_jac_fields_f64(
            Y.data_ptr(), T.data_ptr(), out.data_ptr(), d, int(bool(nurbs)),
            Q12, QL, nL, _cuda.stream_of(Y))
    _cuda.check(err, 'geo_jac_fields')
    _cuda.LAUNCHES['geo_jac_fields'] += 1
    return out


################################################################################
# K2: one contraction stage
################################################################################

def stage_plain(X, T):
    """Plain PyTorch version of :func:`stage`."""
    return torch.tensordot(X, T, dims=([0], [1]))


def _check_stage_args(name, X, T):
    """Shapes and devices of one stage's operands (both devices)."""
    if X.dim() != 2 or T.dim() != 2 or T.shape[1] != X.shape[0]:
        raise ValueError('%s: X %s and T %s disagree in K'
                         % (name, tuple(X.shape), tuple(T.shape)))
    if T.device != X.device:
        raise ValueError('%s: X on %s but T on %s'
                         % (name, X.device, T.device))


def stage(X, T):
    """K2: ``out[r, m] = sum_k X[k, r] T[m, k]`` for ``X (K, R)`` and a
    table ``T (M, K)``; returns ``(R, M)``, float64.  On the card it runs
    on the f64 tensor cores."""
    _check_stage_args('stage', X, T)
    if not _kernel_device(X, 'stage'):
        return stage_plain(X, T)
    _cuda.require(X, 'X', torch.float64, 2)
    _cuda.require(T, 'T', torch.float64, 2)
    K, R = X.shape
    M = T.shape[0]
    out = torch.empty((R, M), dtype=torch.float64, device=X.device)
    with _cuda.device_of(X):
        err = _cuda.library().pyiga_stage_f64(
            X.data_ptr(), T.data_ptr(), out.data_ptr(), K, R, M,
            _cuda.stream_of(X))
    _cuda.check(err, 'stage')
    _cuda.LAUNCHES['stage'] += 1
    return out


################################################################################
# K3: folded final stage
################################################################################

def fold_plain(xs, tables, term_idx):
    """Plain PyTorch version of :func:`fold`."""
    out = None
    for X, i in zip(xs, term_idx):
        Y = stage_plain(X, tables[i])
        out = Y if out is None else out + Y
    return out


_FOLD_MAX_TERMS = 16     # kMaxTerms in csrc/sumfac.cu


def fold(xs, tables, term_idx):
    """K3: ``sum_t stage(xs[t], tables[term_idx[t]])`` as one ``(R, M)``
    output written once; every ``xs[t]`` is ``(K, R)``, every table
    ``(M, K)`` (deduplicated: `term_idx` maps terms to tables).

    On the card it runs on the f64 tensor cores, and the terms that share
    a table are summed before it is applied (groups in order of first
    appearance, terms in their given order: the association of
    :func:`~pyiga_tpu_torch.ops.sumfac.assemble_terms_folded`), so the
    product runs once per distinct table; the result is deterministic and
    equals :func:`fold_plain` to rounding.  More than 16 terms run as
    several launches, summed."""
    if not xs or len(xs) != len(term_idx):
        raise ValueError('fold: %d fields but %d table indices'
                         % (len(xs), len(term_idx)))
    K, R = xs[0].shape
    M = tables[0].shape[0]
    dev = xs[0].device
    for t, X in enumerate(xs):
        if X.shape != (K, R) or X.device != dev:
            raise ValueError('fold: xs[%d] is %s on %s, expected %s on %s'
                             % (t, tuple(X.shape), X.device, (K, R), dev))
    for i, T in enumerate(tables):
        if T.shape != (M, K) or T.device != dev:
            raise ValueError('fold: tables[%d] is %s on %s, expected %s on '
                             '%s' % (i, tuple(T.shape), T.device, (M, K),
                                     dev))
    if not all(0 <= i < len(tables) for i in term_idx):
        raise ValueError('fold: table indices %s outside [0, %d)'
                         % (list(term_idx), len(tables)))
    if not _kernel_device(xs[0], 'fold'):
        return fold_plain(xs, tables, term_idx)
    if len(xs) > _FOLD_MAX_TERMS:       # the kernel's term-table capacity
        k = _FOLD_MAX_TERMS
        return (fold(xs[:k], tables, term_idx[:k])
                + fold(xs[k:], tables, term_idx[k:]))
    for t, X in enumerate(xs):
        _cuda.require(X, 'xs[%d]' % t, torch.float64, 2)
    for i, T in enumerate(tables):
        _cuda.require(T, 'tables[%d]' % i, torch.float64, 2)
    n = len(xs)
    xp = (ctypes.c_uint64 * n)(*[X.data_ptr() for X in xs])
    tp = (ctypes.c_uint64 * n)(*[tables[i].data_ptr() for i in term_idx])
    out = torch.empty((R, M), dtype=torch.float64, device=dev)
    with _cuda.device_of(out):
        err = _cuda.library().pyiga_fold_f64(
            ctypes.cast(xp, ctypes.c_void_p), ctypes.cast(tp, ctypes.c_void_p),
            n, out.data_ptr(), K, R, M, _cuda.stream_of(out))
    _cuda.check(err, 'fold')
    _cuda.LAUNCHES['fold'] += 1
    return out


################################################################################
# K7: transposed stage and the fused stage-2 + fold tail
################################################################################

def stage_T_plain(X, T):
    """Plain PyTorch version of :func:`stage_T`."""
    return torch.tensordot(T, X, dims=([1], [0]))


def stage_T(X, T):
    """K7a: ``out[m, r] = sum_k X[k, r] T[m, k]`` for ``X (K, R)`` and a
    table ``T (M, K)``; returns ``(M, R)``, float64 (K2 with the band axis
    first, so that :func:`tail_fused` reads each row as a ``(K2, K3)``
    slab).  On the card it runs on the f64 tensor cores."""
    _check_stage_args('stage_T', X, T)
    if not _kernel_device(X, 'stage_T'):
        return stage_T_plain(X, T)
    _cuda.require(X, 'X', torch.float64, 2)
    _cuda.require(T, 'T', torch.float64, 2)
    K, R = X.shape
    M = T.shape[0]
    out = torch.empty((M, R), dtype=torch.float64, device=X.device)
    with _cuda.device_of(X):
        err = _cuda.library().pyiga_stage_T_f64(
            X.data_ptr(), T.data_ptr(), out.data_ptr(), K, R, M,
            _cuda.stream_of(X))
    _cuda.check(err, 'stage_T')
    _cuda.LAUNCHES['stage_T'] += 1
    return out


def tail_fused_plain(x1T, tc2, tc3, idx2, idx3):
    """Plain PyTorch version of :func:`tail_fused`: per term, two
    tensordots, summed."""
    out = None
    for X, i2, i3 in zip(x1T, idx2, idx3):
        Y = torch.tensordot(X, tc2[i2], dims=([1], [1]))    # (M1, K3, M2)
        Z = torch.tensordot(Y, tc3[i3], dims=([1], [1]))    # (M1, M2, M3)
        out = Z if out is None else out + Z
    return out


def tail_fused(x1T, tc2, tc3, idx2, idx3):
    """K7b: ``out[a, b, c] = sum_t sum_{j,k} x1T[t][a, j, k]
    tc2[idx2[t]][b, j] tc3[idx3[t]][c, k]``.

    Args:
        x1T: per term, its :func:`stage_T` output viewed as
            ``(M1, K2, K3)``.
        tc2 / tc3: the deduplicated stage-2 ``(M2, K2)`` and final
            ``(M3, K3)`` tables.
        idx2 / idx3: per term, its tables' positions in `tc2` / `tc3`.

    Returns ``(M1, M2, M3)``, float64, written once: the stage-2
    intermediate never reaches device memory.  On the card both
    contractions run on the f64 tensor cores, and the terms that share a
    final table are summed before it is applied (a fixed order, so the
    result is deterministic; it equals the plain version to rounding)."""
    n = len(x1T)
    if not n == len(idx2) == len(idx3):
        raise ValueError('tail_fused: %d terms but %d / %d table indices'
                         % (n, len(idx2), len(idx3)))
    if not _kernel_device(x1T[0], 'tail_fused'):
        return tail_fused_plain(x1T, tc2, tc3, idx2, idx3)
    if n > _FOLD_MAX_TERMS:             # the kernel's term-table capacity
        raise ValueError('tail_fused: %d terms, the kernel takes at most %d'
                         % (n, _FOLD_MAX_TERMS))
    M1, K2, K3 = x1T[0].shape
    M2, M3 = tc2[0].shape[0], tc3[0].shape[0]
    dev = x1T[0].device
    for t, X in enumerate(x1T):
        _cuda.require(X, 'x1T[%d]' % t, torch.float64, 3)
        if X.shape != (M1, K2, K3) or X.device != dev:
            raise ValueError('tail_fused: x1T[%d] is %s on %s, expected %s '
                             'on %s' % (t, tuple(X.shape), X.device,
                                        (M1, K2, K3), dev))
    for name, tabs, shape in (('tc2', tc2, (M2, K2)), ('tc3', tc3, (M3, K3))):
        for i, T in enumerate(tabs):
            _cuda.require(T, '%s[%d]' % (name, i), torch.float64, 2)
            if T.shape != shape or T.device != dev:
                raise ValueError('tail_fused: %s[%d] is %s, expected %s'
                                 % (name, i, tuple(T.shape), shape))
    xp = (ctypes.c_uint64 * n)(*[X.data_ptr() for X in x1T])
    t2 = (ctypes.c_uint64 * n)(*[tc2[i].data_ptr() for i in idx2])
    t3 = (ctypes.c_uint64 * n)(*[tc3[i].data_ptr() for i in idx3])
    out = torch.empty((M1, M2, M3), dtype=torch.float64, device=dev)
    with _cuda.device_of(out):
        err = _cuda.library().pyiga_tail_fused_f64(
            ctypes.cast(xp, ctypes.c_void_p), ctypes.cast(t2, ctypes.c_void_p),
            ctypes.cast(t3, ctypes.c_void_p), n, out.data_ptr(), M1, K2, K3,
            M2, M3, _cuda.stream_of(out))
    _cuda.check(err, 'tail_fused')
    _cuda.LAUNCHES['tail_fused'] += 1
    return out


# The JAX package's switch for the fused tail (pallas_sumfac._TAIL_FUSED),
# read once at import from the same variable with the same values; off by
# default, as there.  Tests and chip_smoke.py set the attribute.
TAIL_FUSED = os.environ.get('PYIGA_TAIL_FUSED', '').lower() \
    in ('1', 'true', 'yes', 'on')


def tail_supported(term_tables, fields_):
    """Static gate of the tail route (counterpart of
    ``pallas_sumfac._tail_supported``): the switch is on, every term has
    3 axes and, per stage, all terms' tables have one shape.  The TPU's
    VMEM budget and K-block rule have no counterpart here."""
    if not TAIL_FUSED:
        return False
    shapes = [set(), set(), set()]
    for tabs, F in zip(term_tables, fields_):
        if len(tabs) != 3 or F.dim() != 3:
            return False
        for k, T in enumerate(tabs):
            if T.shape[1] != F.shape[k]:
                return False
            shapes[k].add(tuple(T.shape))
    return all(len(s) == 1 for s in shapes)


def _dedup(tables):
    """Distinct tables by tensor identity, and each term's position
    (counterpart of one stage of ``pallas_sumfac.stage_table_dedup_idx``:
    the fused tail shares its stage-2 and final tables across terms)."""
    uniq, idx, seen = [], [], {}
    for T in tables:
        if id(T) not in seen:
            seen[id(T)] = len(uniq)
            uniq.append(T)
        idx.append(seen[id(T)])
    return uniq, idx


def chain_tail_fused(term_tables, fields_):
    """The tail route of :func:`chain_folded` for 3-axis chains
    (counterpart of ``pallas_sumfac._chain_group_tail_fused``): per term
    the first stage by K7a, then ONE K7b launch for stage 2 and the folded
    final stage, over tables deduplicated by tensor identity.  Returns
    ``(M_1, M_2, M_3)``."""
    x1T = []
    for tabs, F in zip(term_tables, fields_):
        Q1, Q2, Q3 = F.shape
        x1T.append(stage_T(F.reshape(Q1, Q2 * Q3), tabs[0])
                   .reshape(-1, Q2, Q3))
    tc2, idx2 = _dedup([tabs[1] for tabs in term_tables])
    tc3, idx3 = _dedup([tabs[2] for tabs in term_tables])
    return tail_fused(x1T, tc2, tc3, idx2, idx3)


################################################################################
# Pipeline: geometry fields and the folded chain
################################################################################

def _run_stage(X, T):
    """Contract the leading axis of `X` (any rank) with ``T (M, K)`` and
    append the band axis last."""
    K = X.shape[0]
    out = stage(X.reshape(K, -1), T)
    return out.reshape(tuple(X.shape[1:]) + (T.shape[0],))


def geo_stage12(tables, coeffs, d):
    """Stage-1/2 geometry-Jacobian contraction over the leading ``d - 1``
    axes through K2 (counterpart of ``pallas_sumfac.geo_stage12_mxu``),
    leaving the last coefficient axis open for K1.

    Returns ``(Y, shape12)``: ``Y (d, C, Q12, n_last)`` where ``Y[t]`` has
    the derivative table on axis ``t`` (``t = d - 1``: all values)."""
    C, n_last = coeffs.shape[0], coeffs.shape[d]
    shape12 = tuple(t.shape[1] for t in tables[:d - 1])
    Q12 = int(np.prod(shape12))
    # contraction axes leading, (C, n_last) flattened trailing
    X0 = torch.movedim(coeffs, 0, d - 1)
    X0 = X0.reshape(tuple(X0.shape[:d - 1]) + (C * n_last,))
    Ys = []
    for t in range(d):
        X = X0
        for k in range(d - 1):
            X = _run_stage(X, tables[k][1 if k == t else 0].contiguous())
        # (C * n_last, Q_1, .., Q_{d-1}) -> (C, Q12, n_last)
        Ys.append(X.reshape(C, n_last, Q12).transpose(1, 2))
    return torch.stack(Ys).contiguous(), shape12


def geometry_fields(tables, coeffs, nurbs):
    """Physical geometry values and Jacobian on the Gauss grid through K2
    (geometry stages) and K1's ``jac`` kind: the device counterpart of
    :func:`~pyiga_tpu_torch.ops.geom.geo_jacobian_field`, with the same
    ``(val, jac)`` shapes ``(d,) + grid`` and ``(d, d) + grid`` (level
    order).  `tables` are per-axis ``(nd+1, Q_k, n_k)`` tensors."""
    d = len(tables)
    Y, shape12 = geo_stage12(tables, coeffs, d)
    T = tables[d - 1][:2].contiguous()
    out = geo_jac_fields(Y, T, nurbs)
    grid = shape12 + (T.shape[1],)
    return (out[:d].reshape((d,) + grid),
            out[d:].reshape((d, d) + grid))


def _host_jacobian(geo_inputs):
    """The uploaded host Jacobian ``(d, d, N)``, the Gauss weight product
    ``(N,)`` and the grid shape."""
    jac = geo_inputs['jac']
    d, grid = jac.shape[0], tuple(jac.shape[2:])
    gw = geom.gauss_weight_field(geo_inputs['weights']).reshape(-1)
    return jac.reshape(d, d, -1).contiguous(), gw.contiguous(), grid


def _spline_stages(geo_inputs):
    """K1's inputs from a spline or NURBS geometry: the stage-1/2
    partials through K2, the last-axis tables and the Gauss weights."""
    nurbs = 'geo_tables_nurbs' in geo_inputs
    tables = geo_inputs['geo_tables_nurbs' if nurbs else 'geo_tables_bsp']
    weights = geo_inputs['weights']
    d = len(tables)
    if d < 2:
        raise ValueError('the field kernels need dimension 2 or 3')
    Y, shape12 = geo_stage12(tables, geo_inputs['geo_coeffs'], d)
    w12 = geom.gauss_weight_field(weights[:d - 1]).reshape(-1).contiguous()
    T = tables[d - 1][:2].contiguous()
    grid = shape12 + (T.shape[1],)
    return (Y, T, w12, weights[d - 1].contiguous(), nurbs), grid


def stiffness_fields(geo_inputs):
    """Stiffness coefficient fields ``B_ab = W (J^-1 J^-T)_ab``.
    `geo_inputs` holds tensors: ``weights`` and either the spline
    geometry (``geo_tables_bsp`` or ``geo_tables_nurbs``, per-axis
    ``(2, Q_k, n_k)``, and ``geo_coeffs``), which runs K2 (geometry
    stages) and K1, or a host-evaluated Jacobian ``jac`` ``(d, d) +
    grid``, which runs K1'.  Returns the ``d*d`` term-field list in
    ``(a, b)`` row-major order (mirrored pairs share one tensor), each on
    the Gauss grid."""
    if 'jac' in geo_inputs:
        jac, gw, grid = _host_jacobian(geo_inputs)
        out = host_jac_fields(jac, gw)
    else:
        args, grid = _spline_stages(geo_inputs)
        out = fields(*args)
    d = len(grid)
    uniq, k = {}, 0
    for a in range(d):
        for b in range(a, d):
            uniq[(a, b)] = out[k].reshape(grid)
            k += 1
    return [uniq[(min(a, b), max(a, b))] for a in range(d) for b in range(d)]


def mass_fields(geo_inputs):
    """The mass coefficient field ``W = gauss_weight |det J|`` as a
    one-term list on the Gauss grid.  A spline geometry runs K2 (geometry
    stages) and K1's ``mass`` kind.  A host-evaluated Jacobian (``jac``
    in `geo_inputs`) runs the plain torch expression on the Jacobian's
    device: the JAX package has no Pallas kernel there either (its
    ``mass_fields_pallas`` hands that input to XLA), so there is no TPU
    kernel to port."""
    if 'jac' in geo_inputs:
        jac, gw, grid = _host_jacobian(geo_inputs)
        det, _ = geom.det_and_inv(jac)
        return [(gw * torch.abs(det)).reshape(grid)]
    args, grid = _spline_stages(geo_inputs)
    return [fields_mass(*args).reshape(grid)]


def chain_folded(term_tables, fields_, last_idx):
    """Sum over terms of full contraction chains, with every term's final
    contraction folded into one K3 launch.  ``term_tables[t]`` is the list
    of per-axis ``(M_k, Q_k)`` tables of term t, ``fields_[t]`` its field;
    `last_idx` gives each term's deduplicated last-table slot.  Returns
    ``(M_1, ..., M_d)``.

    With :data:`TAIL_FUSED` on, chains that pass :func:`tail_supported`
    take :func:`chain_tail_fused` (K7) instead of K2 stages + K3; a K7
    kernel that fails to build or launch raises there."""
    if tail_supported(term_tables, fields_):
        return chain_tail_fused(term_tables, fields_)
    flats, shape_mid = [], None
    for tabs, F in zip(term_tables, fields_):
        X = F
        for T in tabs[:-1]:
            X = _run_stage(X, T)
        shape_mid = tuple(X.shape[1:])
        flats.append(X.reshape(X.shape[0], -1))
    tables, slot = [], {}
    for tabs, i in zip(term_tables, last_idx):
        if i not in slot:
            slot[i] = len(tables)
            tables.append(tabs[-1])
    out = fold(flats, tables, [slot[i] for i in last_idx])
    return out.reshape(shape_mid + (out.shape[1],))


def assemble_flat_banded(term_tables, fields_, fold_plan, bws, ns, last_idx):
    """Fused solver-layout assembly (counterpart of
    ``pallas_sumfac.assemble_flat_banded_pair_pallas``, in f64): every plan
    term chains into ONE accumulator, then the flat matvec layout
    ``(C, F)`` falls out of two box slices per band combo
    (:func:`~pyiga_tpu_torch.ops.banded.flat_banded_from_padded_chain`).

    `term_tables` / `fields_` / `last_idx` are aligned with `fold_plan`
    positions.  With mirrored terms present the caller must prescale the
    direct terms' first table by 0.5: the two slices then evaluate
    direct + sym + sym^T (each direct term is symmetric, so half of it
    arrives from each slice)."""
    any_mirror = any(m for _t, m in fold_plan)
    Z = chain_folded(term_tables, fields_, last_idx)
    return flat_banded_from_padded_chain(Z, bws, ns, add_transpose=any_mirror)


def assemble_terms_folded(term_tables, fields_, fold_plan, tperms, last_idx):
    """Compact-layout assembly of a sum of terms (counterpart of
    ``pallas_sumfac.assemble_terms_folded_pallas``, in f64): the direct
    terms and the mirrored terms each run as one :func:`chain_folded`
    (K2 stages, one K3 fold); the mirrored sum's transpose is added by a
    per-axis ``index_select`` with the `tperms` permutations
    (:func:`~pyiga_tpu_torch.mlmatrix.transpose_idx_for_bidx`, as
    LongTensors on the fields' device).  No 0.5 prescale: both halves of
    a mirrored pair come from the one chain.

    `term_tables[t]` / `fields_[t]` / `last_idx[t]` are indexed by term;
    `fold_plan` lists ``(term, mirrored)``.  Returns ``(nnz_1, ...,
    nnz_d)``."""
    def group(mirrored):
        ts = [t for t, m in fold_plan if m == mirrored]
        if not ts:
            return None
        return chain_folded([term_tables[t] for t in ts],
                            [fields_[t] for t in ts],
                            [last_idx[t] for t in ts])

    out = group(False)
    sym = group(True)
    if sym is not None:
        if not tperms:
            raise ValueError('fold_plan has mirrored terms but no tperms')
        symT = sym
        for k, p in enumerate(tperms):
            symT = torch.index_select(symT, k, p)
        sym = sym + symT
        out = sym if out is None else out + sym
    return out
