# -*- coding: utf-8 -*-
"""CUDA kernels of the sum-factorization assembly and the pipeline built
on them (counterpart of :mod:`pyiga_tpu.ops.pallas_sumfac`).

The kernels (sources in ``csrc/fields.cu`` for K1 and K1',
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
  :data:`TAIL_FUSED` is on;
* K2-bwd / K3-bwd :func:`stage_bwd`, :func:`fold_bwd` — the backward of
  a stage for one or all of a fold's distinct tables in one launch
  (no Pallas site: the JAX package differentiates the XLA forms);
* K8 :func:`windowed_stage` and K8f :func:`windowed_fold` (source
  ``csrc/windowed.cu``) — the windowed route's stage and its folded
  final stage over support windows, and :func:`assemble_terms_windowed`
  on them (no Pallas site: the JAX package runs that route in XLA).

K1 (all three kinds), K1', K2, K3, K8, K8f and the backward kernels
(K1-bwd, K2-bwd / K3-bwd) also take float32 (the f32 line,
:func:`~pyiga_tpu_torch.config.set_dtype`): a float32 CUDA tensor
launches their float32 instances (``csrc/fields.cu`` and
``csrc/windowed.cu`` templated on the scalar, ``csrc/sumfac_f32.cu``),
which compute in float32 throughout.  K7 is float64 only; it raises on
float32 on every device, and :func:`chain_folded` never routes float32
to it (the JAX package's f32 line runs no fused tail either).

Each wrapper dispatches on the device of its input: a CPU tensor runs the
plain version, a CUDA tensor launches the kernel (and raises if it cannot);
nothing falls back.  The plain versions of the f32 kernels run their
products in full float32 (:func:`~pyiga_tpu_torch.config.no_tf32`).
Chain convention (as on the TPU): every stage contracts the CURRENT
leading axis and appends the band axis last, so a d-stage chain maps
``(K_1, ..., K_d)`` to ``(M_1, ..., M_d)`` without transposes.
"""

import ctypes
import functools
import os

import numpy as np
import torch

from .. import _cuda
from ..config import no_tf32
from . import geom
from .banded import flat_banded_from_padded_chain
from .sumfac import windowed_stage_plain


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

def _jacobian_parts(Y, T, nurbs, with_values):
    """The last-axis contraction of K1: ``jh[c][k]`` (homogeneous
    Jacobian, derivative axis k) and, where asked or for NURBS, the values
    ``val[c]``, each ``(Q12, QL)``."""
    d, C = Y.shape[0], Y.shape[1]
    Tv, Td = T[0], T[1]

    def contract(t, c, tab):            # (Q12, nL) x (QL, nL) -> (Q12, QL)
        return torch.tensordot(Y[t, c], tab, dims=([1], [1]))

    jh = [[contract(min(k, d - 1), c, Td if k == d - 1 else Tv)
           for k in range(d)] for c in range(C)]
    val = ([contract(d - 1, c, Tv) for c in range(C)]
           if nurbs or with_values else None)
    return jh, val


def _quotient(jh, val, G):
    """The NURBS quotient rule: ``J[c][k] = (jh[c][k] W - val[c] jh[W][k])
    / W^2`` for the first `G` components, W the last."""
    W = val[-1]
    WW = W * W
    return [[(jh[c][k] * W - val[c] * jh[-1][k]) / WW
             for k in range(len(jh[0]))] for c in range(G)]


def _jacobian_plain(Y, T, nurbs):
    """Physical Jacobian ``(d, d, Q12, QL)`` from the stage-1/2 partials:
    the last-axis contraction and, for NURBS, the quotient rule (the part
    the K1 kinds share)."""
    d = Y.shape[0]
    jh, val = _jacobian_parts(Y, T, nurbs, False)
    jac = _quotient(jh, val, d) if nurbs else jh
    return torch.stack([torch.stack(row) for row in jac])


def _unique_stiffness(inv, W):
    """``W (J^-1 J^-T)_ab`` for ``a <= b`` row-major, stacked."""
    d = inv.shape[0]
    return torch.stack([W * sum(inv[a, m] * inv[b, m] for m in range(d))
                        for a in range(d) for b in range(a, d)])


def fields_plain(Y, T, w12, wL, nurbs):
    """Plain PyTorch version of :func:`fields` (same inputs and output)."""
    with no_tf32(Y.dtype):
        det, inv = geom.det_and_inv(_jacobian_plain(Y, T, nurbs))
        return _unique_stiffness(inv, w12[:, None] * wL[None, :]
                                 * torch.abs(det))


def _check_fields_args(name, Y, T, w12, wL, nurbs):
    """Validate K1's operands (float64, or float32 for the stiffness and
    ``mass`` kinds: all of one dtype); returns ``(d, Q12, QL, nL)``."""
    dt = Y.dtype if Y.dtype == torch.float32 else torch.float64
    _cuda.require(Y, 'Y', dt, 4)
    _cuda.require(T, 'T', dt, 3)
    _cuda.require(w12, 'w12', dt, 1)
    _cuda.require(wL, 'wL', dt, 1)
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


def _check_jac_args(name, Y, T, nurbs):
    """Validate the ``jac`` kind's operands (float64, or float32: both of
    one dtype); returns ``(d, G, Q12, QL, nL)``."""
    dt = Y.dtype if Y.dtype == torch.float32 else torch.float64
    _cuda.require(Y, 'Y', dt, 4)
    _cuda.require(T, 'T', dt, 3)
    d, C, Q12, nL = Y.shape
    G = C - int(bool(nurbs))
    QL = T.shape[1]
    if (d, G) not in ((1, 1), (1, 2), (2, 2), (2, 3), (3, 3)):
        raise ValueError('%s: need d in (1, 2, 3) and C = d or d + 1 (d < '
                         '3; +1 for NURBS), got d=%d C=%d' % (name, d, C))
    if T.shape != (2, QL, nL) or T.device != Y.device:
        raise ValueError('%s: T %s disagrees with Y %s'
                         % (name, tuple(T.shape), tuple(Y.shape)))
    return d, G, Q12, QL, nL


# K1's kinds: the C entry's kind code, the launch counters of the forward
# and backward kernels (float64; the float32 backward's counter is the
# latter's with '_f32')
_FIELD_KINDS = {'stiffness': (0, 'fields', 'fields_bwd'),
                'mass': (1, 'mass_fields', 'mass_fields_bwd'),
                'jac': (2, 'geo_jac_fields', 'geo_jac_fields_bwd')}
# the forward's C entry and launch counter of each kind, per dtype (the
# float32 instances are the f32 line's)
_FIELD_ENTRIES = {
    ('stiffness', torch.float64): ('pyiga_stiff_fields_f64', 'fields'),
    ('mass', torch.float64): ('pyiga_mass_fields_f64', 'mass_fields'),
    ('jac', torch.float64): ('pyiga_geo_jac_fields_f64', 'geo_jac_fields'),
    ('stiffness', torch.float32): ('pyiga_stiff_fields_f32', 'fields_f32'),
    ('mass', torch.float32): ('pyiga_mass_fields_f32', 'mass_fields_f32'),
    ('jac', torch.float32): ('pyiga_geo_jac_fields_f32',
                             'geo_jac_fields_f32')}


def _fields_kernel(kind, Y, T, w12, wL, nurbs):
    """K1's forward of `kind` on CUDA tensors (``w12``/``wL`` None for
    ``jac``): checks, one launch."""
    lib = _cuda.library()
    if kind == 'jac':
        d, G, Q12, QL, nL = _check_jac_args('geo_jac_fields', Y, T, nurbs)
        out = torch.empty((G + G * d, Q12, QL), dtype=Y.dtype,
                          device=Y.device)
        fn, counter = _FIELD_ENTRIES[kind, Y.dtype]
        with _cuda.device_of(Y):
            err = getattr(lib, fn)(
                Y.data_ptr(), T.data_ptr(), out.data_ptr(), d, G,
                int(bool(nurbs)), Q12, QL, nL, _cuda.stream_of(Y))
    else:
        name = 'fields' if kind == 'stiffness' else 'fields_mass'
        d, Q12, QL, nL = _check_fields_args(name, Y, T, w12, wL, nurbs)
        shape = ((d * (d + 1) // 2, Q12, QL) if kind == 'stiffness'
                 else (Q12, QL))
        out = torch.empty(shape, dtype=Y.dtype, device=Y.device)
        fn, counter = _FIELD_ENTRIES[kind, Y.dtype]
        with _cuda.device_of(Y):
            err = getattr(lib, fn)(Y.data_ptr(), T.data_ptr(), w12.data_ptr(),
                        wL.data_ptr(), out.data_ptr(), d, int(bool(nurbs)),
                        Q12, QL, nL, _cuda.stream_of(Y))
    _cuda.check(err, counter)
    _cuda.LAUNCHES[counter] += 1
    return out


def _fields_forward(kind, Y, T, w12, wL, nurbs):
    if not _kernel_device(Y, 'fields'):
        if kind == 'stiffness':
            return fields_plain(Y, T, w12, wL, nurbs)
        if kind == 'mass':
            return fields_mass_plain(Y, T, w12, wL, nurbs)
        return geo_jac_fields_plain(Y, T, nurbs)
    return _fields_kernel(kind, Y, T, w12, wL, nurbs)


class _GeoFields(torch.autograd.Function):
    """K1 of one kind as a function of `Y`; its backward is K1's backward
    kernel (:func:`fields_bwd`), which recomputes each point from `Y` and
    `T`.  The tables and weights are constants."""

    @staticmethod
    def forward(kind, Y, T, w12, wL, nurbs):
        return _fields_forward(kind, Y, T, w12, wL, nurbs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        kind, Y, T, w12, wL, nurbs = inputs
        ctx.kind, ctx.nurbs = kind, nurbs
        ctx.save_for_backward(Y, T, w12, wL)

    @staticmethod
    def backward(ctx, g):
        Y, T, w12, wL = ctx.saved_tensors
        gY = (fields_bwd(ctx.kind, Y, T, w12, wL, ctx.nurbs, g)
              if ctx.needs_input_grad[1] else None)
        return None, gY, None, None, None, None

    vmap = _cuda.loop_vmap(lambda *a: _GeoFields.apply(*a))


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

    Returns ``(d(d+1)/2, Q12, QL)``: ``B_ab`` for ``a <= b`` row-major,
    in the operands' dtype (float64, or float32: K1's float32 instance,
    the per-point inverse and det J in float32 too).  Differentiable in
    `Y` (:func:`fields_bwd`, in the operands' dtype on the card)."""
    _cuda.constant_operands('fields', T, w12, wL)
    return _GeoFields.apply('stiffness', Y, T, w12, wL, nurbs)


def fields_mass_plain(Y, T, w12, wL, nurbs):
    """Plain PyTorch version of :func:`fields_mass`."""
    with no_tf32(Y.dtype):
        det, _ = geom.det_and_inv(_jacobian_plain(Y, T, nurbs))
        return w12[:, None] * wL[None, :] * torch.abs(det)


def fields_mass(Y, T, w12, wL, nurbs):
    """K1, ``mass`` kind: the mass field ``W = w12 (x) wL |det J|`` on the
    Gauss grid, from the same inputs as :func:`fields` (for NURBS the
    quotient rule runs before the determinant).  Returns ``(Q12, QL)`` in
    the operands' dtype (float64 or float32); differentiable in `Y`."""
    _cuda.constant_operands('fields_mass', T, w12, wL)
    return _GeoFields.apply('mass', Y, T, w12, wL, nurbs)


def host_jac_fields_plain(jac, w12, wL):
    """Plain PyTorch version of :func:`host_jac_fields` (in the operands'
    dtype)."""
    det, inv = geom.det_and_inv(jac)
    gw = (w12[:, None] * wL[None, :]).reshape(-1)
    return _unique_stiffness(inv, gw * torch.abs(det))


def host_jac_fields(jac, w12, wL):
    """K1': unique stiffness fields from a Jacobian evaluated on the host.

    Args:
        jac: ``(d, d, N)`` level-ordered Jacobian at the ``N = Q12 QL``
            Gauss points (:func:`~pyiga_tpu_torch.ops.geom.
            host_jacobian_levelorder`, flattened).
        w12: ``(Q12,)`` product of the leading axes' Gauss weights.
        wL: ``(QL,)`` last-axis Gauss weights (K1's weight operands: the
            kernel forms ``gw = w12 (x) wL``, ``gauss_weight_field``'s
            product bit for bit).

    Returns ``(d(d+1)/2, N)``: ``B_ab = gw |det J| (J^-1 J^-T)_ab`` for
    ``a <= b`` row-major, the order :func:`stiffness_fields` expands, in
    the operands' dtype (float64, or float32: the float32 instance of
    K1').
    Any N: the TPU kernel's lane-multiple gate is a tiling rule of its
    own.  The kernel has no backward: on CUDA an operand that requires
    grad raises."""
    if not _kernel_device(jac, 'host_jac_fields'):
        return host_jac_fields_plain(jac, w12, wL)
    _cuda.no_grad_operands('host_jac_fields', jac, w12, wL)
    dt = jac.dtype if jac.dtype == torch.float32 else torch.float64
    _cuda.require(jac, 'jac', dt, 3)
    _cuda.require(w12, 'w12', dt, 1)
    _cuda.require(wL, 'wL', dt, 1)
    d, Q12, QL = jac.shape[0], w12.shape[0], wL.shape[0]
    if d not in (2, 3) or jac.shape != (d, d, Q12 * QL):
        raise ValueError('host_jac_fields: need jac (d, d, Q12 QL) with d in '
                         '(2, 3), got %s with w12 %s and wL %s'
                         % (tuple(jac.shape), tuple(w12.shape),
                            tuple(wL.shape)))
    out = torch.empty((d * (d + 1) // 2, Q12 * QL), dtype=dt,
                      device=jac.device)
    f32 = dt == torch.float32
    counter = 'host_jac_fields_f32' if f32 else 'host_jac_fields'
    fn = (_cuda.library().pyiga_host_jac_fields_f32 if f32
          else _cuda.library().pyiga_host_jac_fields_f64)
    with _cuda.device_of(jac):
        err = fn(jac.data_ptr(), w12.data_ptr(), wL.data_ptr(),
                 out.data_ptr(), d, Q12, QL, _cuda.stream_of(jac))
    _cuda.check(err, counter)
    _cuda.LAUNCHES[counter] += 1
    return out


def geo_jac_fields_plain(Y, T, nurbs):
    """Plain PyTorch version of :func:`geo_jac_fields` (in the operands'
    dtype; float32 contractions in full float32)."""
    G = Y.shape[1] - int(bool(nurbs))
    with no_tf32(Y.dtype):
        jh, val = _jacobian_parts(Y, T, nurbs, True)
    if nurbs:
        jh = _quotient(jh, val, G)
        val = [v / val[-1] for v in val[:-1]]
    return torch.stack(val + [x for row in jh for x in row])


def geo_jac_fields(Y, T, nurbs):
    """K1, ``jac`` kind: physical geometry values and Jacobian on the
    Gauss grid.

    Args:
        Y: ``(d, C, Q12, nL)`` stage-1/2 geometry partials
            (:func:`geo_stage12`), ``C = G`` (+1 for NURBS, weight last)
            for a geometry of output dimension ``G``: ``d`` for a volume
            map, ``d + 1`` for a surface (``d = 2``) or a plane curve
            (``d = 1``).
        T: ``(2, QL, nL)`` last-axis value and derivative tables; a
            boundary Gauss grid may give ``QL = 1``.
        nurbs: whether `Y` carries homogeneous NURBS components.

    Returns ``(G + G*d, Q12, QL)``: the values ``x_c`` (level order), then
    the Jacobian ``J[c][k]`` row-major, in the operands' dtype (float64,
    or float32: K1's float32 instance).  Differentiable in `Y`
    (:func:`fields_bwd`, in the operands' dtype)."""
    _cuda.constant_operands('geo_jac_fields', T)
    return _GeoFields.apply('jac', Y, T, None, None, nurbs)


def _fields_vjp_plain(kind, Y, T, w12, wL, nurbs, g):
    """The backward of K1's `kind` written as formulas (not autograd of
    the plain forward): ``gY (d, C, Q12, nL)`` from the output's gradient
    `g`.  Per point, with ``s = gw |det J|``:

    * stiffness ``B = s J^-1 J^-T`` (unique a <= b, the off-diagonal
      gradient split between the two mirrored entries into a symmetric
      ``Gs``): ``gJ = s ((Gs : M) J^-T - 2 J^-T Gs M)``, ``M = J^-1
      J^-T``;
    * mass ``s``: ``gJ = g s J^-T``;
    * jac: the gradients of the values and of J as they come;

    then the NURBS quotient rule's VJP (homogeneous Jacobian, values and
    weight) and the last-axis contraction's: ``gY[t, c] = a_v[t][c] Tv +
    a_d[c] Td`` over the last axis's points, ``a_d`` only at ``t = d -
    1``.  Float32 operands: every product in full float32
    (:func:`~pyiga_tpu_torch.config.no_tf32`)."""
    with no_tf32(Y.dtype):
        return _fields_vjp(kind, Y, T, w12, wL, nurbs, g)


def _fields_vjp(kind, Y, T, w12, wL, nurbs, g):
    d, C = Y.shape[0], Y.shape[1]
    G = C - int(bool(nurbs))
    jh, val = _jacobian_parts(Y, T, nurbs, kind == 'jac')
    gx = None
    if kind == 'jac':
        gx = [g[c] for c in range(G)]
        gJ = [[g[G + c * d + k] for k in range(d)] for c in range(G)]
    else:
        J = _quotient(jh, val, d) if nurbs else jh
        det, inv = geom.det_and_inv(torch.stack([torch.stack(r) for r in J]))
        s = w12[:, None] * wL[None, :] * torch.abs(det)
        if kind == 'mass':
            gJ = [[g * s * inv[k, c] for k in range(d)] for c in range(d)]
        else:
            Gs, o = [[None] * d for _ in range(d)], 0
            for a in range(d):
                for b in range(a, d):
                    Gs[a][b] = Gs[b][a] = g[o] if a == b else 0.5 * g[o]
                    o += 1
            M = [[sum(inv[a, m] * inv[b, m] for m in range(d))
                  for b in range(d)] for a in range(d)]
            GM = sum(Gs[a][b] * M[a][b] for a in range(d) for b in range(d))
            GMm = [[sum(Gs[a][b] * M[b][j] for b in range(d))
                    for j in range(d)] for a in range(d)]
            gJ = [[s * (GM * inv[j, i] - 2.0 * sum(inv[a, i] * GMm[a][j]
                                                   for a in range(d)))
                   for j in range(d)] for i in range(d)]
    if nurbs:
        W = val[-1]
        WW = W * W
        gjh = [[gJ[c][k] / W for k in range(d)] for c in range(G)]
        gjh.append([-sum(gJ[c][k] * val[c] for c in range(G)) / WW
                    for k in range(d)])
        gv = [-sum(gJ[c][k] * jh[-1][k] for k in range(d)) / WW
              for c in range(G)]
        gW = sum(gJ[c][k] * (2.0 * val[c] * jh[-1][k] / (WW * W)
                             - jh[c][k] / WW)
                 for c in range(G) for k in range(d))
        if gx is not None:
            gv = [gv[c] + gx[c] / W for c in range(G)]
            gW = gW - sum(gx[c] * val[c] for c in range(G)) / WW
        gv.append(gW)
    else:
        gjh, gv = gJ, gx
    Tv, Td = T[0], T[1]
    rows = []
    for t in range(d):
        for c in range(C):
            if t < d - 1:
                rows.append(gjh[c][t] @ Tv)
            else:
                r = gjh[c][d - 1] @ Td
                rows.append(r if gv is None else gv[c] @ Tv + r)
    return torch.stack(rows).reshape(Y.shape)


def fields_bwd_plain(Y, T, w12, wL, nurbs, g):
    """Plain version of K1's stiffness backward (:func:`fields_bwd`)."""
    return _fields_vjp_plain('stiffness', Y, T, w12, wL, nurbs, g)


def fields_mass_bwd_plain(Y, T, w12, wL, nurbs, g):
    """Plain version of K1's mass backward (:func:`fields_bwd`)."""
    return _fields_vjp_plain('mass', Y, T, w12, wL, nurbs, g)


def geo_jac_fields_bwd_plain(Y, T, nurbs, g):
    """Plain version of K1's ``jac`` backward (:func:`fields_bwd`)."""
    return _fields_vjp_plain('jac', Y, T, None, None, nurbs, g)


def fields_bwd(kind, Y, T, w12, wL, nurbs, g):
    """K1's backward kernel (``geo_fields_bwd_kernel`` in
    ``csrc/fields.cu``): the gradient ``gY (d, C, Q12, nL)`` of K1's
    `kind` ('stiffness', 'mass' or 'jac'; ``w12``/``wL`` None for
    'jac') from its output's gradient `g`.  The kernel recomputes each
    Gauss point from `Y` and `T` as the forward does, applies the VJP and
    contracts back over the last axis in a fixed order (no atomics:
    bitwise equal on a repeat).  Float64, or float32 operands: the kernel's
    float32 instance (``pyiga_fields_bwd_f32``, counted under the kind's
    counter with ``_f32``), which computes in float32 throughout.  On the
    card it launches through a Function of its own (:class:`_FieldsBwd`),
    so that ``torch.func.vmap`` of a gradient launches it once a member
    of the batch.  A CPU tensor runs the formulas of
    :func:`_fields_vjp_plain`."""
    g = g.contiguous()
    if not _kernel_device(Y, 'fields_bwd'):
        return _fields_vjp_plain(kind, Y, T, w12, wL, nurbs, g)
    counter = _FIELD_KINDS[kind][2]
    if Y.dtype == torch.float32:
        counter += '_f32'
    _cuda.no_double_backward(counter, Y, g)
    if kind == 'jac':
        d, G, Q12, QL, nL = _check_jac_args(counter, Y, T, nurbs)
        shape = (G + G * d, Q12, QL)
    else:
        d, Q12, QL, nL = _check_fields_args(counter, Y, T, w12, wL, nurbs)
        shape = ((d * (d + 1) // 2, Q12, QL) if kind == 'stiffness'
                 else (Q12, QL))
        G = d
    if g.shape != shape or g.device != Y.device:
        raise ValueError('%s: gradient %s on %s, expected %s on %s'
                         % (counter, tuple(g.shape), g.device, shape,
                            Y.device))
    return _FieldsBwd.apply(kind, (d, G, Q12, QL, nL), Y, T, w12, wL, nurbs,
                            g)


def _fields_bwd_kernel(kind, dims, Y, T, w12, wL, nurbs, g):
    """One launch of K1's backward on CUDA tensors of the sizes `dims`
    ``(d, G, Q12, QL, nL)`` (checked by :func:`fields_bwd`)."""
    code, _fwd, counter = _FIELD_KINDS[kind]
    f32 = Y.dtype == torch.float32
    dt = torch.float32 if f32 else torch.float64
    if f32:
        counter += '_f32'
    d, G, Q12, QL, nL = dims
    if kind == 'jac':
        w12 = wL = torch.empty(0, dtype=dt, device=Y.device)
    _cuda.require(g, 'g', dt, g.dim())
    gY = torch.empty_like(Y)
    fn = (_cuda.library().pyiga_fields_bwd_f32 if f32
          else _cuda.library().pyiga_fields_bwd_f64)
    with _cuda.device_of(Y):
        err = fn(
            code, Y.data_ptr(), T.data_ptr(), w12.data_ptr(), wL.data_ptr(),
            g.data_ptr(), gY.data_ptr(), d, G, int(bool(nurbs)), Q12, QL, nL,
            _cuda.stream_of(Y))
    _cuda.check(err, counter)
    _cuda.LAUNCHES[counter] += 1
    return gY


class _FieldsBwd(torch.autograd.Function):
    """K1's backward kernel as a Function of its operands: a ``vmap``
    rule that launches it once a member of the batch, and no backward of
    its own."""

    @staticmethod
    def forward(kind, dims, Y, T, w12, wL, nurbs, g):
        return _fields_bwd_kernel(kind, dims, Y, T, w12, wL, nurbs, g)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.kind = inputs[0]

    @staticmethod
    def backward(ctx, gg):
        _cuda.refuse_backward(_FIELD_KINDS[ctx.kind][2])

    vmap = _cuda.loop_vmap(lambda *a: _FieldsBwd.apply(*a))


################################################################################
# K2: one contraction stage
################################################################################

def stage_plain(X, T):
    """Plain PyTorch version of :func:`stage`."""
    with no_tf32(X.dtype):
        return torch.tensordot(X, T, dims=([0], [1]))


def _check_stage_args(name, X, T):
    """Shapes and devices of one stage's operands (both devices)."""
    if X.dim() != 2 or T.dim() != 2 or T.shape[1] != X.shape[0]:
        raise ValueError('%s: X %s and T %s disagree in K'
                         % (name, tuple(X.shape), tuple(T.shape)))
    if T.device != X.device:
        raise ValueError('%s: X on %s but T on %s'
                         % (name, X.device, T.device))


def _stage_kernel(X, T):
    """One K2 launch on CUDA tensors (float64: the DMMA kernel, counted
    under ``stage``; float32: the FFMA kernel, ``stage_f32``)."""
    f32 = X.dtype == torch.float32
    dt = torch.float32 if f32 else torch.float64
    _cuda.require(X, 'X', dt, 2)
    _cuda.require(T, 'T', dt, 2)
    K, R = X.shape
    M = T.shape[0]
    out = torch.empty((R, M), dtype=dt, device=X.device)
    name, entry = (('stage_f32', 'pyiga_stage_f32') if f32
                   else ('stage', 'pyiga_stage_f64'))
    with _cuda.device_of(X):
        err = getattr(_cuda.library(), entry)(
            X.data_ptr(), T.data_ptr(), out.data_ptr(), K, R, M,
            _cuda.stream_of(X))
    _cuda.check(err, name)
    _cuda.LAUNCHES[name] += 1
    return out


def stage_bwd_plain(T, g):
    """Plain PyTorch version of :func:`stage_bwd` (float32 operands: the
    product in full float32)."""
    with no_tf32(g.dtype):
        return torch.tensordot(T, g, dims=([0], [1]))


def _check_bwd_args(name, tables, g):
    """Shapes and devices of a backward's tables ``(M, K)`` and gradient
    ``g (R, M)`` (both devices)."""
    shape = tables[0].shape
    for i, T in enumerate(tables):
        if T.dim() != 2 or T.shape != shape or T.device != g.device:
            raise ValueError('%s: table %d is %s on %s, expected 2D %s on '
                             '%s' % (name, i, tuple(T.shape), T.device,
                                     tuple(shape), g.device))
    if g.dim() != 2 or g.shape[1] != shape[0]:
        raise ValueError('%s: gradient %s and table %s disagree in M'
                         % (name, tuple(g.shape), tuple(shape)))


_BWD_F32_SLICE = 16         # m a slice: the chunks' bounds are multiples
_BWD_F32_MIN_SLICES = 4     # slices a chunk at least
_BWD_F32_MAX_CHUNKS = 64    # kMaxChunks in csrc/sumfac_f32.cu


@functools.lru_cache(maxsize=8)
def stage_bwd_f32_tiles(lib):
    """The tiles of `lib`'s ``stage_bwd_f32_kernel`` in its entry's
    numbering, as the library reports them (``pyiga_stage_bwd_f32_tiles``;
    read once a library): per tile ``(bk, br, blocks an SM)``, k rows and
    r columns a block."""
    buf = (ctypes.c_int * 48)()
    n = lib.pyiga_stage_bwd_f32_tiles(ctypes.cast(buf, ctypes.c_void_p), 16)
    if n < 1:
        raise RuntimeError('pyiga_stage_bwd_f32_tiles: %d' % n)
    return tuple(tuple(buf[3 * i:3 * i + 3]) for i in range(n))


def stage_bwd_f32_plan(K, R, M, n_tables, n_sm, tiles):
    """The launch plan of the float32 backward ``stage_bwd_f32_kernel``
    for `n_tables` tables ``(M, K)`` and a gradient ``(R, M)`` on a card of
    `n_sm` SMs, over the library's `tiles` (:func:`stage_bwd_f32_tiles`):
    the tile whose k tiles pad `K` least (the larger on a tie), and a
    split of M into as many ``chunks`` as the unsplit grid (``ceil(K /
    bk) ceil(R / br) n_tables`` blocks) fits into one wave (``n_sm``
    times the tile's blocks an SM), each at least 4 slices of 16 m, at
    most 64: so M splits only where the unsplit grid fills at most half a
    wave (a second wave of shorter chunks would take about as long as one
    of longer ones, plus the second pass).  Chunk c covers m in
    ``[bounds[c], bounds[c + 1])``, every
    inner bound a multiple of 16; only the last chunk may be short.
    Returns a dict with ``tile`` (the entry's index), ``bk``, ``br``,
    ``chunks``, ``bounds``, ``blocks`` (of the first pass) and
    ``waves``."""
    def padded(t):
        bk = tiles[t][0]
        return -(-K // bk) * bk
    tile = 0
    for t in range(1, len(tiles)):
        if padded(t) < padded(tile) or (padded(t) == padded(tile)
                                        and tiles[t][0] > tiles[tile][0]):
            tile = t
    bk, br, per_sm = tiles[tile]
    blocks = -(-K // bk) * -(-R // br) * n_tables
    wave = n_sm * per_sm
    slices = -(-M // _BWD_F32_SLICE)
    chunks = max(1, min(wave // blocks, slices // _BWD_F32_MIN_SLICES,
                        _BWD_F32_MAX_CHUNKS))
    bounds = [_BWD_F32_SLICE * (c * slices // chunks)
              for c in range(chunks)] + [M]
    return dict(tile=tile, bk=bk, br=br, chunks=chunks, bounds=bounds,
                blocks=blocks * chunks, waves=blocks * chunks / wave)


@functools.lru_cache(maxsize=256)
def _stage_bwd_f32_args(K, R, M, n_tables, n_sm, tiles):
    """The plan's arguments of the C entry, built once a shape: the tile,
    the number of chunks and the bounds as a ctypes array."""
    plan = stage_bwd_f32_plan(K, R, M, n_tables, n_sm, tiles)
    S = plan['chunks']
    return plan['tile'], S, (ctypes.c_int * (S + 1))(*plan['bounds'])


def _stage_bwd_kernel(tables, g, counter):
    """K2-bwd on CUDA tensors: ``(G, K, R)``, table i's gradient at [i],
    one launch per 16 tables, counted under `counter` (float64: the DMMA
    kernel ``stage_bwd_kernel``; float32: ``stage_bwd_f32_kernel`` of
    ``csrc/sumfac_f32.cu`` on the plan of :func:`stage_bwd_f32_plan`,
    with a scratch of the chunks' partials where it splits M, counted
    under `counter` with ``_f32``)."""
    f32 = g.dtype == torch.float32
    dt = torch.float32 if f32 else torch.float64
    _cuda.require(g, 'g', dt, 2)
    for i, T in enumerate(tables):
        _cuda.require(T, 'tables[%d]' % i, dt, 2)
    R, M = g.shape
    K = tables[0].shape[1]
    out = torch.empty((len(tables), K, R), dtype=dt, device=g.device)
    if f32:
        counter += '_f32'
    with _cuda.device_of(g):
        for i0 in range(0, len(tables), _FOLD_MAX_TERMS):
            part = tables[i0:i0 + _FOLD_MAX_TERMS]
            tp = (ctypes.c_uint64 * len(part))(*[T.data_ptr() for T in part])
            args = (ctypes.cast(tp, ctypes.c_void_p), len(part),
                    g.data_ptr(), out[i0].data_ptr(), K, R, M)
            if f32:
                tile, S, bounds = _stage_bwd_f32_args(
                    K, R, M, len(part), _cuda.sm_count(g),
                    stage_bwd_f32_tiles(_cuda.library()))
                scratch = (torch.empty((S, len(part), K, R), dtype=dt,
                                       device=g.device) if S > 1 else None)
                err = _cuda.library().pyiga_stage_bwd_f32(
                    *args, tile, S, ctypes.cast(bounds, ctypes.c_void_p),
                    0 if scratch is None else scratch.data_ptr(),
                    _cuda.stream_of(g))
            else:
                err = _cuda.library().pyiga_stage_bwd_f64(
                    *args, _cuda.stream_of(g))
            _cuda.check(err, counter)
            _cuda.LAUNCHES[counter] += 1
    return out


def stage_bwd(T, g, counter='stage_bwd'):
    """The backward of a stage with the table ``T (M, K)``: ``gX[k, r] =
    sum_m T[m, k] g[r, m]`` for the output's gradient ``g (R, M)``,
    returns ``(K, R)`` in the operands' dtype.  On the card one launch of
    ``stage_bwd_kernel`` for float64 (f64 tensor cores; it reads `T`
    transposed and `g` once, and writes `gX` once), counted under
    `counter` (``stage_bwd``, or ``fold_bwd`` for a fold's), or of
    ``stage_bwd_f32_kernel`` for float32 (``csrc/sumfac_f32.cu``: FFMA in
    full float32, no TF32; a tile spanning K, M split in a fixed order
    where the output tiles cannot fill the card,
    :func:`stage_bwd_f32_plan`), counted under `counter` with ``_f32``,
    through :class:`_StageBwd` (once a member of a ``torch.func.vmap``
    batch).  A CPU tensor runs :func:`stage_bwd_plain`."""
    g = g.contiguous()
    _check_bwd_args(counter, [T], g)
    if not _kernel_device(g, counter):
        return stage_bwd_plain(T, g)
    _cuda.no_double_backward(counter, T, g)
    return _StageBwd.apply(counter, g, T)[0]


class _StageBwd(torch.autograd.Function):
    """K2-bwd on CUDA tensors as a Function ``apply(counter, g,
    *tables)`` -> ``(G, K, R)``: a ``vmap`` rule that launches it once a
    member of the batch, and no backward of its own."""

    @staticmethod
    def forward(counter, g, *tables):
        return _stage_bwd_kernel(list(tables), g, counter)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.counter = inputs[0]

    @staticmethod
    def backward(ctx, gg):
        _cuda.refuse_backward(ctx.counter)

    vmap = _cuda.loop_vmap(lambda *a: _StageBwd.apply(*a))


class _Stage(torch.autograd.Function):
    """K2 as a function of the field `X`; saves only the table."""

    @staticmethod
    def forward(X, T):
        if not _kernel_device(X, 'stage'):
            return stage_plain(X, T)
        return _stage_kernel(X, T)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[1])

    @staticmethod
    def backward(ctx, g):
        T, = ctx.saved_tensors
        return (stage_bwd(T, g) if ctx.needs_input_grad[0] else None), None

    vmap = _cuda.loop_vmap(lambda *a: _Stage.apply(*a))


def stage(X, T):
    """K2: ``out[r, m] = sum_k X[k, r] T[m, k]`` for ``X (K, R)`` and a
    table ``T (M, K)``; returns ``(R, M)`` in the operands' dtype.  On the
    card float64 runs on the f64 tensor cores, float32 on the FMA units
    in full float32 (``csrc/sumfac_f32.cu``, no TF32).  Differentiable in
    `X` (:func:`stage_bwd`, in the operands' dtype); the table is a
    constant."""
    _check_stage_args('stage', X, T)
    _cuda.constant_operands('stage', T)
    return _Stage.apply(X, T)


################################################################################
# K3: folded final stage
################################################################################

def fold_plain(xs, tables, term_idx):
    """Plain PyTorch version of :func:`fold` (the products in full
    float32 for float32 operands, :func:`stage_plain`)."""
    out = None
    for X, i in zip(xs, term_idx):
        Y = stage_plain(X, tables[i])
        out = Y if out is None else out + Y
    return out


_FOLD_MAX_TERMS = 16     # kMaxTerms in csrc/sumfac.cu (terms, or tables
                         # of a backward launch)


def _fold_kernel(xs, tables, term_idx):
    """K3 on CUDA tensors: one launch per 16 terms, summed (float64: the
    DMMA kernel, counted under ``fold``; float32: the FFMA kernel,
    ``fold_f32``)."""
    if len(xs) > _FOLD_MAX_TERMS:       # the kernel's term-table capacity
        k = _FOLD_MAX_TERMS
        return (_fold_kernel(xs[:k], tables, term_idx[:k])
                + _fold_kernel(xs[k:], tables, term_idx[k:]))
    f32 = xs[0].dtype == torch.float32
    dt = torch.float32 if f32 else torch.float64
    for t, X in enumerate(xs):
        _cuda.require(X, 'xs[%d]' % t, dt, 2)
    for i, T in enumerate(tables):
        _cuda.require(T, 'tables[%d]' % i, dt, 2)
    K, R = xs[0].shape
    M = tables[0].shape[0]
    n = len(xs)
    xp = (ctypes.c_uint64 * n)(*[X.data_ptr() for X in xs])
    tp = (ctypes.c_uint64 * n)(*[tables[i].data_ptr() for i in term_idx])
    out = torch.empty((R, M), dtype=dt, device=xs[0].device)
    name, entry = (('fold_f32', 'pyiga_fold_f32') if f32
                   else ('fold', 'pyiga_fold_f64'))
    with _cuda.device_of(out):
        err = getattr(_cuda.library(), entry)(
            ctypes.cast(xp, ctypes.c_void_p), ctypes.cast(tp, ctypes.c_void_p),
            n, out.data_ptr(), K, R, M, _cuda.stream_of(out))
    _cuda.check(err, name)
    _cuda.LAUNCHES[name] += 1
    return out


def _fold_bwd_tables(term_idx, need):
    """The distinct tables whose terms need a gradient (`need`, per term;
    None: all), in order of first appearance."""
    if need is None:
        need = [True] * len(term_idx)
    return list(dict.fromkeys(i for i, w in zip(term_idx, need) if w)), need


def _fold_bwd_views(gX, uniq, term_idx, need):
    """Per term the view ``gX[s]`` of its table's gradient, None for a
    term that needs none.  One view object a table: autograd then sees
    that the terms of a table share it and copies before it accumulates
    into a leaf's ``.grad`` in place (a view a term would hand two leaves
    one memory)."""
    views = dict(zip(uniq, gX))
    return [views[i] if w else None for i, w in zip(term_idx, need)]


def fold_bwd_plain(tables, term_idx, g, need=None):
    """Plain version of :func:`fold_bwd`: the same per-term views of one
    stacked ``(G, K, R)`` tensor."""
    uniq, need = _fold_bwd_tables(term_idx, need)
    if not uniq:
        return [None] * len(term_idx)
    gX = torch.stack([stage_bwd_plain(tables[i], g) for i in uniq])
    return _fold_bwd_views(gX, uniq, term_idx, need)


def fold_bwd(tables, term_idx, g, need=None):
    """K3's backward: per term the gradient ``(K, R)`` of its field from
    the output's gradient ``g (R, M)``.  The terms that share a table
    share its gradient: the G distinct tables whose terms need one
    (`need`, per term; default all) go into one ``(G, K, R)`` tensor, on
    the card by one launch of ``stage_bwd_kernel`` (float32:
    ``stage_bwd_f32_kernel``, counted under ``fold_bwd_f32``) for up to
    16 tables, counted under ``fold_bwd`` (through :class:`_StageBwd`, once
    a member of a ``torch.func.vmap`` batch).  Each term gets the view of
    its table's gradient, None if it needs none.  A CPU tensor runs
    :func:`fold_bwd_plain`."""
    uniq, need = _fold_bwd_tables(term_idx, need)
    if not uniq:
        return [None] * len(term_idx)
    g = g.contiguous()
    used = [tables[i] for i in uniq]
    _check_bwd_args('fold_bwd', used, g)
    if not _kernel_device(g, 'fold_bwd'):
        return fold_bwd_plain(tables, term_idx, g, need)
    _cuda.no_double_backward('fold_bwd', *used, g)
    return _fold_bwd_views(_StageBwd.apply('fold_bwd', g, *used), uniq,
                           term_idx, need)


class _Fold(torch.autograd.Function):
    """K3 as a function of the terms' fields ``apply(term_idx, n_terms,
    *xs, *tables)``; saves only the tables.  Its backward
    (:func:`fold_bwd`) runs every distinct table whose terms need a
    gradient in one launch and hands each term its table's view."""

    @staticmethod
    def forward(term_idx, n, *tensors):
        xs, tables = tensors[:n], tensors[n:]
        if not _kernel_device(xs[0], 'fold'):
            return fold_plain(xs, tables, term_idx)
        return _fold_kernel(xs, tables, term_idx)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.term_idx, n = inputs[0], inputs[1]
        ctx.save_for_backward(*inputs[2 + n:])

    @staticmethod
    def backward(ctx, g):
        tables = ctx.saved_tensors
        need = ctx.needs_input_grad[2:2 + len(ctx.term_idx)]
        return ((None, None) + tuple(fold_bwd(tables, ctx.term_idx, g, need))
                + (None,) * len(tables))

    vmap = _cuda.loop_vmap(lambda *a: _Fold.apply(*a))


def fold(xs, tables, term_idx):
    """K3: ``sum_t stage(xs[t], tables[term_idx[t]])`` as one ``(R, M)``
    output written once; every ``xs[t]`` is ``(K, R)``, every table
    ``(M, K)`` (deduplicated: `term_idx` maps terms to tables).

    On the card float64 runs on the f64 tensor cores and float32 on the
    FMA units in full float32 (``csrc/sumfac_f32.cu``), and the terms that
    share a table are summed before it is applied (groups in order of
    first appearance, terms in their given order: the association of
    :func:`~pyiga_tpu_torch.ops.sumfac.assemble_terms_folded`), so the
    product runs once per distinct table; the result is deterministic and
    equals :func:`fold_plain` to rounding.  More than 16 terms run as
    several launches, summed.  Differentiable in the fields: terms that
    share a table share one gradient, all of a fold's in one launch
    (:func:`fold_bwd`)."""
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
    _cuda.constant_operands('fold', *tables)
    return _Fold.apply(tuple(term_idx), len(xs), *xs, *tables)


################################################################################
# K7: transposed stage and the fused stage-2 + fold tail
################################################################################

def stage_T_plain(X, T):
    """Plain PyTorch version of :func:`stage_T`."""
    return torch.tensordot(T, X, dims=([1], [0]))


def _float64_only(name, *tensors):
    """K7 has no float32 instance: raise on any other dtype, on every
    device (its plain version would compute in that dtype on the CPU
    while the card could not)."""
    for t in tensors:
        if t.dtype != torch.float64:
            raise NotImplementedError(
                '%s: K7 is float64 only, got %s (float32 chains take K2 + '
                'K3)' % (name, t.dtype))


def stage_T(X, T):
    """K7a: ``out[m, r] = sum_k X[k, r] T[m, k]`` for ``X (K, R)`` and a
    table ``T (M, K)``; returns ``(M, R)``, float64 (K2 with the band axis
    first, so that :func:`tail_fused` reads each row as a ``(K2, K3)``
    slab).  On the card it runs on the f64 tensor cores; it has no backward
    there (an operand that requires grad raises)."""
    _check_stage_args('stage_T', X, T)
    _float64_only('stage_T', X, T)
    if not _kernel_device(X, 'stage_T'):
        return stage_T_plain(X, T)
    _cuda.no_grad_operands('stage_T', X, T)
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
    result is deterministic; it equals the plain version to rounding).
    The kernel has no backward: on CUDA an operand that requires grad
    raises."""
    n = len(x1T)
    if not n == len(idx2) == len(idx3):
        raise ValueError('tail_fused: %d terms but %d / %d table indices'
                         % (n, len(idx2), len(idx3)))
    _float64_only('tail_fused', *x1T, *tc2, *tc3)
    if not _kernel_device(x1T[0], 'tail_fused'):
        return tail_fused_plain(x1T, tc2, tc3, idx2, idx3)
    if n > _FOLD_MAX_TERMS:             # the kernel's term-table capacity
        raise ValueError('tail_fused: %d terms, the kernel takes at most %d'
                         % (n, _FOLD_MAX_TERMS))
    _cuda.no_grad_operands('tail_fused', *x1T, *tc2, *tc3)
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
    3 axes and float64 fields (K7 has no float32 instance) and, per
    stage, all terms' tables have one shape.  The TPU's VMEM budget and
    K-block rule have no counterpart here."""
    if not TAIL_FUSED:
        return False
    shapes = [set(), set(), set()]
    for tabs, F in zip(term_tables, fields_):
        if len(tabs) != 3 or F.dim() != 3 or F.dtype != torch.float64:
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
# K8 / K8f: the windowed route's stage and folded final stage
################################################################################

def windowed_fold_plain(xs, tables, idx, fs, nqp):
    """Plain PyTorch version of :func:`windowed_fold`, in the kernel's
    association: the fields of the terms that share a table summed in
    term order, one windowed stage a table (tables in order of first
    appearance), the stages added in that order.  (In float32 the
    association is what keeps the two within a few roundings of each
    other: a fold of 16 terms summed term by term would differ from the
    kernel by ~1e-6 relative.)"""
    out = None
    for i in dict.fromkeys(idx):
        S = None
        for X, j in zip(xs, idx):
            if j == i:
                S = X if S is None else S + X
        Y = windowed_stage_plain(S, tables[i], fs, nqp)
        out = Y if out is None else out + Y
    return out


WINDOWED_SMEM = 232448          # shared bytes a block on sm_90
WINDOWED_SMS = 132              # SMs of an H100 SXM


def windowed_plan(Q, R, n, b, wsz, nqp, groups, nsm=WINDOWED_SMS, esize=8):
    """The tiling of a K8 / K8f launch over `groups` distinct tables on
    `nsm` SMs, as ``make_plan`` in ``csrc/windowed.cu`` computes it (the
    card's ``pyiga_windowed_plan`` and ``pyiga_windowed_plan_f32`` are
    held to this in ``chip_smoke.py``), for elements of `esize` bytes (8
    for the float64 kernel, 4 for the float32 one; ``V = 16 / esize`` of
    them a 16-byte copy).

    A tile is ``8 rpt`` consecutive r by a run of ``run`` dofs (4 a
    consumer warp; ``nruns`` balanced runs cover the axis).  CTA ``c`` of
    the ``nruns * cpr`` keeps run ``c // cpr`` and walks the r tiles
    ``c % cpr, c % cpr + cpr, ...`` below ``rtiles``.  Shared memory
    holds every distinct table's rows of the run (dof stride ``ps``
    elements, a multiple of V plus V), ``stages`` X stages of ``cap``
    rows (row stride ``xs = 8 rpt + V`` elements; tensor copies
    of ``box`` rows, at most 256, a multiple of 8) and ``nys`` output
    spans of a tile: r tiles of 3 or 2 r a lane where they give two
    thirds of the SMs a tile (3 first for several tables, 2 first for
    one), else 1, each with the most spans (two at most) that leave two
    stages.  Returns a dict of those numbers and ``smem`` (bytes; 0 where
    nothing fits)."""
    def r128(x):
        return (x + 127) // 128 * 128
    V = 16 // esize
    warps_total = -(-n // 4)
    ps = -(-(wsz * b) // (2 * V)) * (2 * V) + V
    for mw in range(16, 0, -1):
        nruns = -(-warps_total // mw)
        run = -(-warps_total // nruns) * 4
        cap = min(Q, (run - 1) * nqp + wsz)
        nbox = -(-cap // 256)
        box = (-(-cap // nbox) + 7) // 8 * 8     # 128-byte aligned boxes
        cap = nbox * box
        fixed = 128 + r128(groups * run * ps * esize)
        order = [rpt for rpt in ((3, 2) if groups > 1 else (2, 3))
                 if 3 * nruns * -(-R // (8 * rpt)) >= 2 * nsm] + [1]
        for rpt in order:
            rt = 8 * rpt
            xs = rt + V
            stage = r128(cap * xs * esize)
            ys = r128(rt * b * n * esize)
            nys = 2 if nruns == 1 else 0
            while nys and fixed + nys * ys + 2 * stage > WINDOWED_SMEM:
                nys -= 1
            room = WINDOWED_SMEM - fixed - nys * ys
            if room < 2 * stage:
                continue
            stages = min(4, room // stage)
            rtiles = -(-R // rt)
            return dict(rpt=rpt, run=run, nruns=nruns, cap=cap, box=box,
                        ps=ps, xs=xs, stages=stages, nys=nys, rtiles=rtiles,
                        cpr=max(1, min(rtiles, nsm // nruns)),
                        smem=fixed + stages * stage + nys * ys)
    return dict(rpt=0, run=0, nruns=0, cap=0, box=0, ps=0, xs=0, stages=0,
                nys=0, rtiles=0, cpr=0, smem=0)


def _check_window_starts(name, fs, n, nqp, wsz, Q):
    """The kernels size their staged tile by the window starts that
    :meth:`~pyiga_tpu_torch.ops.sumfac.SpaceTables.windowed_pair_table`
    gives: non-decreasing from 0 in steps of at most 1, the last window
    inside X.  Checked on the host once per tensor and shape (one small
    copy; the result is kept on the tensor with its version)."""
    key = (fs._version, n, nqp, wsz, Q)
    if getattr(fs, '_pyiga_window_check', None) == key:
        return
    f = fs.cpu()
    steps = f[1:] - f[:-1]
    if not (int(f[0]) >= 0 and bool(((steps >= 0) & (steps <= 1)).all())
            and int(f[-1]) * nqp + wsz <= Q):
        raise ValueError('%s: window starts %s are not those of a windowed '
                         'pair table over %d points' % (name, f.tolist(), Q))
    fs._pyiga_window_check = key


def _check_windowed_args(name, xs, tables, idx, fs, nqp):
    """Shapes and devices of a windowed stage or fold (both devices)."""
    if not xs or len(xs) != len(idx):
        raise ValueError('%s: %d fields but %d table indices'
                         % (name, len(xs), len(idx)))
    X0 = xs[0]
    dev = X0.device
    n, b, wsz = tables[0].shape if tables[0].dim() == 3 else (0, 0, 0)
    if X0.dim() != 2 or n < 1 or nqp < 1 or wsz % nqp or X0.shape[0] % nqp \
            or X0.shape[0] < wsz:
        raise ValueError('%s: X %s, table %s and nqp %d disagree'
                         % (name, tuple(X0.shape), tuple(tables[0].shape),
                            nqp))
    for t, X in enumerate(xs):
        if X.shape != X0.shape or X.device != dev:
            raise ValueError('%s: xs[%d] is %s on %s, expected %s on %s'
                             % (name, t, tuple(X.shape), X.device,
                                tuple(X0.shape), dev))
    for i, P in enumerate(tables):
        if P.shape != (n, b, wsz) or P.device != dev:
            raise ValueError('%s: tables[%d] is %s on %s, expected %s on %s'
                             % (name, i, tuple(P.shape), P.device,
                                (n, b, wsz), dev))
    if not all(0 <= i < len(tables) for i in idx):
        raise ValueError('%s: table indices %s outside [0, %d)'
                         % (name, list(idx), len(tables)))
    if fs.shape != (n,) or fs.dtype != torch.int64 or fs.device != dev:
        raise ValueError('%s: fs must be (%d,) int64 on %s, got %s %s on %s'
                         % (name, n, dev, tuple(fs.shape), fs.dtype,
                            fs.device))


def _windowed_kernel(name, xs, tables, idx, fs, nqp):
    """One K8 (a term) or K8f launch on CUDA tensors, counted under
    `name` (``name + '_f32'`` for the float32 instance, which float32
    operands launch); more than 16 terms run as several launches,
    summed."""
    if len(xs) > _FOLD_MAX_TERMS:       # kMaxTerms in csrc/windowed.cu
        k = _FOLD_MAX_TERMS
        return (_windowed_kernel(name, xs[:k], tables, idx[:k], fs, nqp)
                + _windowed_kernel(name, xs[k:], tables, idx[k:], fs, nqp))
    dt = xs[0].dtype if xs[0].dtype == torch.float32 else torch.float64
    for t, X in enumerate(xs):
        _cuda.require(X, 'xs[%d]' % t, dt, 2)
    for i, P in enumerate(tables):
        _cuda.require(P, 'tables[%d]' % i, dt, 3)
    _cuda.require(fs, 'fs', torch.int64, 1)
    Q, R = xs[0].shape
    n, b, wsz = tables[0].shape
    if b not in (1, 3, 5, 7, 9):
        raise ValueError('%s: the kernel takes 2p+1 <= 9 band offsets, got '
                         '%d' % (name, b))
    _check_window_starts(name, fs, n, nqp, wsz, Q)
    Y = torch.empty((R, b * n), dtype=dt, device=xs[0].device)
    suffix = '_f32' if dt == torch.float32 else '_f64'
    counter = name + ('_f32' if dt == torch.float32 else '')
    lib = _cuda.library()
    with _cuda.device_of(Y):
        if name == 'windowed_stage':
            err = getattr(lib, 'pyiga_windowed_stage' + suffix)(
                xs[0].data_ptr(), tables[idx[0]].data_ptr(), fs.data_ptr(),
                Y.data_ptr(), Q, R, n, b, wsz, nqp, _cuda.stream_of(Y))
        else:
            k = len(xs)
            xp = (ctypes.c_uint64 * k)(*[X.data_ptr() for X in xs])
            tp = (ctypes.c_uint64 * k)(*[tables[i].data_ptr() for i in idx])
            err = getattr(lib, 'pyiga_windowed_fold' + suffix)(
                ctypes.cast(xp, ctypes.c_void_p),
                ctypes.cast(tp, ctypes.c_void_p), k, fs.data_ptr(),
                Y.data_ptr(), Q, R, n, b, wsz, nqp, _cuda.stream_of(Y))
    _cuda.check(err, counter)
    _cuda.LAUNCHES[counter] += 1
    return Y


def windowed_stage(X, P, fs, nqp):
    """K8: ``Y[r, o*n + i] = sum_{w < wsz} X[fs[i]*nqp + w, r] P[i, o, w]``
    for the field ``X (Q, R)``, a windowed pair table ``P (n, b, wsz)``
    and its window starts ``fs (n,)`` int64
    (:meth:`~pyiga_tpu_torch.ops.sumfac.SpaceTables.windowed_pair_table`);
    returns the banded-flat ``(R, b*n)`` in the operands' dtype (float64,
    or float32: the kernel's float32 instance), every entry written
    (zeros on the band's padding).  A CPU tensor runs
    :func:`~pyiga_tpu_torch.ops.sumfac.windowed_stage_plain`, a CUDA
    tensor launches the kernel; it has no backward there (an operand
    that requires grad raises)."""
    _check_windowed_args('windowed_stage', [X], [P], [0], fs, nqp)
    if not _kernel_device(X, 'windowed_stage'):
        return windowed_stage_plain(X, P, fs, nqp)
    _cuda.no_grad_operands('windowed_stage', X, P)
    return _windowed_kernel('windowed_stage', [X], [P], [0], fs, nqp)


def windowed_fold(xs, tables, idx, fs, nqp):
    """K8f: ``sum_t windowed_stage(xs[t], tables[idx[t]], fs, nqp)`` as one
    ``(R, b*n)`` output written once; the tables are deduplicated (`idx`
    maps terms to tables).  On the card the terms that share a table sum
    their fields before the product (groups in order of first
    appearance, terms in their given order), so the result is
    deterministic and equals :func:`windowed_fold_plain` to rounding.
    More than 16 terms run as several launches, summed.  A CPU tensor
    runs the plain version; no backward on the card."""
    _check_windowed_args('windowed_fold', xs, tables, idx, fs, nqp)
    if not _kernel_device(xs[0], 'windowed_fold'):
        return windowed_fold_plain(xs, tables, idx, fs, nqp)
    _cuda.no_grad_operands('windowed_fold', *xs, *tables)
    return _windowed_kernel('windowed_fold', list(xs), tables, list(idx), fs,
                            nqp)


def assemble_terms_windowed(wterm_tables, fss, nqps, fields, fold_plan=None,
                            tperms=None):
    """The windowed route on the fields' device (the device counterpart
    of :func:`~pyiga_tpu_torch.ops.sumfac.assemble_terms_windowed`):
    every plan term's stages but the last by K8, then ONE K8f over all
    terms (tables deduplicated by tensor identity), then, with mirrored
    terms, the mirror ``Z + Z^T`` as one advanced-index gather with the
    banded-flat permutations `tperms` (LongTensors).  Direct and mirrored
    terms share the one accumulator: with a mirror, each direct term's
    first table enters halved (exact, a power of two), so that
    ``Z + Z^T`` adds it once.  Returns the banded-flat ``(b_1 n_1, ...,
    b_d n_d)``."""
    plan = (fold_plan if fold_plan is not None
            else [(t, False) for t in range(len(wterm_tables))])
    any_mirror = any(m for _t, m in plan)
    if any_mirror and not tperms:
        raise ValueError('fold_plan has mirrored terms but no tperms')
    halves, xs, last, shape_mid = {}, [], [], None
    for t, mirrored in plan:
        tabs = list(wterm_tables[t])
        if any_mirror and not mirrored:
            if id(tabs[0]) not in halves:
                halves[id(tabs[0])] = 0.5 * tabs[0]
            tabs[0] = halves[id(tabs[0])]
        last.append(tabs[-1])
        X = fields[t]
        for k in range(len(tabs) - 1):
            Y = windowed_stage(X.reshape(X.shape[0], -1).contiguous(),
                               tabs[k], fss[k], nqps[k])
            X = Y.reshape(tuple(X.shape[1:]) + (Y.shape[1],))
        shape_mid = tuple(X.shape[1:])
        xs.append(X.reshape(X.shape[0], -1).contiguous())
    last, idx = _dedup(last)
    Z = windowed_fold(xs, last, idx, fss[-1], nqps[-1])
    Z = Z.reshape(shape_mid + (Z.shape[1],))
    if any_mirror:
        d = Z.dim()
        ix = tuple(p.reshape([-1 if a == k else 1 for a in range(d)])
                   for k, p in enumerate(tperms))
        Z = Z + Z[ix]
    return Z


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
    ``(val, jac)`` shapes ``(G,) + grid`` and ``(G, d) + grid`` (level
    order; ``G`` the geometry's output dimension, ``d + 1`` for a
    surface).  `tables` are per-axis ``(nd+1, Q_k, n_k)`` tensors."""
    d = len(tables)
    G = coeffs.shape[0] - int(bool(nurbs))
    Y, shape12 = geo_stage12(tables, coeffs, d)
    T = tables[d - 1][:2].contiguous()
    out = geo_jac_fields(Y, T, nurbs)
    grid = shape12 + (T.shape[1],)
    return (out[:G].reshape((G,) + grid),
            out[G:].reshape((G, d) + grid))


def geometry_hessian(tables, coeffs, nurbs):
    """Parametric Hessian of the geometry on the Gauss grid, ``(G, d, d) +
    grid`` (level order, symmetric): the device counterpart of
    :func:`~pyiga_tpu_torch.ops.geom.geo_hessian_field`.  Each of the
    ``d (d + 1) / 2`` second-derivative combinations (and, for NURBS, the
    value and the d first derivatives of the homogeneous map) is one
    chain of d K2 stages over the second-derivative `tables` (per-axis
    ``(3, Q_k, n_k)``); the NURBS quotient rule runs in torch
    (:func:`~pyiga_tpu_torch.ops.geom.hessian_from_chains`).  The JAX
    package forms the Hessian in XLA, outside any Pallas kernel."""
    def chain(D):                           # (C,) + grid
        X = torch.movedim(coeffs, 0, -1)    # (n_1, ..., n_d, C)
        for k, T in enumerate(tables):
            X = _run_stage(X, T[D[k]].contiguous())
        return X
    return geom.hessian_from_chains(chain, len(tables), nurbs)


def _host_jacobian(geo_inputs):
    """The uploaded host Jacobian ``(d, d, N)`` and the grid shape."""
    jac = geo_inputs['jac']
    d, grid = jac.shape[0], tuple(jac.shape[2:])
    return jac.reshape(d, d, -1), grid


def _spline_stages(geo_inputs):
    """K1's inputs from a spline or NURBS geometry: the stage-1/2
    partials through K2, the last-axis tables and the Gauss weights."""
    nurbs = 'geo_tables_nurbs' in geo_inputs
    tables = geo_inputs['geo_tables_nurbs' if nurbs else 'geo_tables_bsp']
    d = len(tables)
    if d < 2:
        raise ValueError('the field kernels need dimension 2 or 3')
    Y, shape12 = geo_stage12(tables, geo_inputs['geo_coeffs'], d)
    T = tables[d - 1][:2].contiguous()
    grid = shape12 + (T.shape[1],)
    w12, wL = geom.gauss_weight_factors(geo_inputs['weights'])
    return (Y, T, w12, wL, nurbs), grid


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
        jac, grid = _host_jacobian(geo_inputs)
        out = host_jac_fields(jac, *geom.gauss_weight_factors(
            geo_inputs['weights']))
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
        jac, grid = _host_jacobian(geo_inputs)
        gw = geom.gauss_weight_field(geo_inputs['weights']).reshape(-1)
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

    With :data:`TAIL_FUSED` on, float64 chains that pass
    :func:`tail_supported` take :func:`chain_tail_fused` (K7) instead of
    K2 stages + K3; a K7 kernel that fails to build or launch raises
    there.  Float32 chains always take K2 + K3, as the JAX package's f32
    line runs no fused tail.  A chain that
    autograd records (grad mode on and a field that requires grad) keeps
    the two-call chain whatever the switch says: K7 has no backward."""
    recorded = torch.is_grad_enabled() and any(
        F is not None and F.requires_grad for F in fields_)
    if not recorded and tail_supported(term_tables, fields_):
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
    ``pallas_sumfac.assemble_flat_banded_pair_pallas``, in the fields'
    dtype): every plan
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
    ``pallas_sumfac.assemble_terms_folded_pallas``, in the fields'
    dtype): the direct
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
