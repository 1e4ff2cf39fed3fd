# -*- coding: utf-8 -*-
"""Carry state from the JAX package into the port.

The functions take the JAX package's host objects as plain data — knot
arrays, control points, numpy dictionaries — and build the port's
equivalents, without importing jax or pyiga_tpu (duck typing on the
attributes those objects expose).  With them a test feeds both packages
identical state.
"""

import numpy as np
import scipy.sparse
import torch

from . import geometry
from .bspline import KnotVector
from .config import get_dtype, resolve_device
from .mlmatrix import MLStructure
from .ops.banded import flat_banded_data
from .ops.mg import DeviceMGSolver


def knot_vector(kv):
    """A port :class:`KnotVector` from any object with ``kv`` (knots) and
    ``p`` (degree)."""
    return KnotVector(np.array(kv.kv, dtype=float), int(kv.p))


def geometry_from(geo):
    """A port geometry from a B-spline or NURBS geometry object exposing
    ``kvs`` and ``coeffs`` (NURBS coefficients premultiplied, weight last,
    as both packages store them; every factory of the JAX package returns
    one), from a ``UserFunction`` (the same callables, support and
    dimension), or from a ``PhysicalGradientFunc`` or
    ``ComposedFunction`` of such objects (their parts carried over)."""
    name = type(geo).__name__
    if name == 'UserFunction':
        return geometry.UserFunction(geo.f, geo.support, jac=geo.jac)
    if name == 'PhysicalGradientFunc':
        return geometry.PhysicalGradientFunc(geometry_from(geo.func),
                                             geometry_from(geo.geo))
    if name == 'ComposedFunction':
        return geometry.ComposedFunction(geometry_from(geo.geo2),
                                         geometry_from(geo.geo1))
    kvs = tuple(knot_vector(kv) for kv in geo.kvs)
    coeffs = np.array(geo.coeffs, dtype=float)
    if type(geo).__name__ == 'NurbsFunc':
        return geometry.NurbsFunc(kvs, coeffs, weights=None,
                                  premultiplied=True)
    if type(geo).__name__ == 'BSplineFunc':
        return geometry.BSplineFunc(kvs, coeffs)
    raise TypeError('unsupported geometry type %s' % type(geo).__name__)


def geo_inputs(gi, device=None):
    """An assembler's geometry-input dict (``weights``, then
    ``geo_tables_bsp`` or ``geo_tables_nurbs`` with ``geo_coeffs``, or the
    host Jacobian ``jac``; numpy arrays or lists of them) as tensors of
    the compute dtype (:func:`~pyiga_tpu_torch.config.get_dtype`) on
    `device`, the form the port's field functions take."""
    device = resolve_device(device)
    dtype = get_dtype()

    def dev(a):
        return torch.as_tensor(np.array(a, dtype=np.float64), dtype=dtype,
                               device=device)
    out = {}
    for key in ('weights', 'geo_tables_bsp', 'geo_tables_nurbs'):
        if key in gi:
            out[key] = [dev(a) for a in gi[key]]
    for key in ('geo_coeffs', 'jac'):
        if key in gi:
            out[key] = dev(gi[key])
    return out


def flat_banded(D, bws, ns, device=None, dtype=None):
    """Banded data ``(b_1..b_d, n_1..n_d)`` (e.g. the JAX package's
    ``banded_from_compact_device`` result, as numpy) in the port's flat
    ``(C, F)`` layout on `device`, in `dtype` (default the compute
    dtype)."""
    D = flat_banded_data(np.array(D, dtype=np.float64), bws, ns)
    return D.to(device=resolve_device(device),
                dtype=get_dtype() if dtype is None else dtype).contiguous()


def vform_arrays(host_arrays, device=None):
    """A VForm assembler's host arrays (``weights``, ``input:*``,
    ``param:*``; numpy) as tensors of the compute dtype on `device`, the
    form the port's coefficient fields take (add ``geo_val_lvl`` /
    ``geo_jac_lvl`` from :func:`~pyiga_tpu_torch.ops.cuda_sumfac.
    geometry_fields`)."""
    device = resolve_device(device)
    dtype = get_dtype()

    def dev(a):
        return torch.as_tensor(np.array(a, dtype=np.float64), dtype=dtype,
                               device=device)
    return {k: [dev(w) for w in v] if k == 'weights' else dev(v)
            for k, v in host_arrays.items()}


def device_mg_solver(As, Ps, lv_inds, sweeps, smooth_steps, active_dofs=None,
                     smoother_impl='auto', device=None):
    """A port :class:`~pyiga_tpu_torch.ops.mg.DeviceMGSolver` from the
    inputs of the JAX package's ``DeviceMGSolver`` (the Galerkin matrices
    `As` and prolongators `Ps` as scipy sparse matrices, the smoothing
    sets `lv_inds` and `active_dofs` as integer arrays), on `device`."""
    return DeviceMGSolver(
        [scipy.sparse.csr_matrix(A, dtype=np.float64) for A in As],
        [scipy.sparse.csr_matrix(P, dtype=np.float64) for P in Ps],
        [np.array(ix, dtype=np.int64) for ix in lv_inds], tuple(sweeps),
        int(smooth_steps),
        active_dofs=None if active_dofs is None
        else np.array(active_dofs, dtype=np.int64),
        smoother_impl=smoother_impl, device=device)


def mlmatrix(mlm):
    """A port :class:`~pyiga_tpu_torch.mlmatrix.MLMatrix` from any compact
    matrix exposing ``structure.bs``, ``structure.bidx`` and ``data``."""
    S = MLStructure(mlm.structure.bs,
                    [np.array(bx) for bx in mlm.structure.bidx])
    return S.make_mlmatrix(data=np.array(mlm.data, dtype=np.float64))
