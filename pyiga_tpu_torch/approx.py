# -*- coding: utf-8 -*-
"""Approximate functions in tensor-product spline spaces: nodal
interpolation and L2 projection (a copy of :mod:`pyiga_tpu.approx` for
tensor-product spaces).  The host work is numpy/scipy; an L2 projection
with a geometry assembles its mass matrix through
:func:`~pyiga_tpu_torch.assemble.mass` on `device`; onto a hierarchical
space, its mass matrix and load vector through the hierarchical
:func:`~pyiga_tpu_torch.assemble.assemble`."""

import sys

import numpy as np
import scipy.sparse.linalg

from . import bspline, operators, tensor, utils
from .bspline import KnotVector


def _as_kv_tuple(kvs):
    return (kvs,) if isinstance(kvs, KnotVector) else tuple(kvs)


def _nodal_values(f, kvs, nodes, geo):
    """Values of `f` on the TP node grid; `f` may already be a value array
    (shape = per-axis dof counts, trailing component axes allowed)."""
    if isinstance(f, np.ndarray):
        want = tuple(kv.numdofs for kv in kvs)
        if np.shape(f)[:len(kvs)] != want:
            raise ValueError('value array has shape %s, expected leading %s'
                             % (np.shape(f), want))
        return f
    if geo is not None:
        return utils.grid_eval_transformed(f, nodes, geo)
    return utils.grid_eval(f, nodes)


def interpolate(kvs, f, geo=None, nodes=None):
    """Spline coefficients interpolating `f` at the given `nodes` (Greville
    abscissae by default); with `geo`, `f` takes physical coordinates."""
    kvs = _as_kv_tuple(kvs)
    if nodes is None:
        nodes = [kv.greville() for kv in kvs]
    vals = _nodal_values(f, kvs, nodes, geo)
    solve_1d = [operators.make_solver(bspline.collocation(kv, nd))
                for kv, nd in zip(kvs, nodes)]
    return tensor.apply_tprod(solve_1d, vals)


def project_L2(kvs, f, f_physical=False, geo=None, device=None):
    """L2-projection of `f` onto the tensor-product spline space `kvs`.

    Without geometry the Kronecker mass inverse applies directly; with
    `geo`, CG on the mapped mass matrix (assembled on `device`, default
    the card) is preconditioned by the parameter-domain Kronecker
    inverse.  `kvs` may be an
    :class:`~pyiga_tpu_torch.hierarchical.HSpace`
    (:func:`_project_L2_hspace`)."""
    from . import assemble
    from .hierarchical import HSpace
    if isinstance(kvs, HSpace):
        return _project_L2_hspace(kvs, f, f_physical, geo, device)
    kvs = _as_kv_tuple(kvs)
    if f_physical and geo is None:
        raise ValueError('physical-coordinate f requires a geometry')
    rhs = assemble.inner_products(kvs, f, f_physical=f_physical, geo=geo)
    kron_inv = [operators.make_solver(assemble.mass(kv), spd=True)
                for kv in kvs]
    if geo is None:
        return tensor.apply_tprod(kron_inv, rhs)

    M = assemble.mass(kvs, geo=geo, device=device)
    if rhs.size != M.shape[1]:
        raise NotImplementedError(
            'L2 projection with geometry handles scalar functions only')
    x, status = scipy.sparse.linalg.cg(
        M, rhs.ravel(), rtol=1e-12, atol=1e-12, maxiter=100,
        M=operators.KroneckerOperator(*kron_inv))
    if status != 0:
        print('WARNING: L2 projection CG did not converge (info=%s)' % status,
              file=sys.stderr)
    return x.reshape(rhs.shape)


def _project_L2_hspace(hs, f, f_physical, geo, device):
    """L2-projection onto a hierarchical space: its mass matrix and load
    vector assembled on `device` over the space (the identity geometry by
    default), solved by a sparse direct solve on the host
    (``pyiga_tpu/approx.py:80-87``)."""
    from . import assemble, geometry, vform
    if geo is None:
        geo = geometry.identity(hs.knotvectors(0))
    M = assemble.assemble(vform.mass_vf(hs.dim), hs, geo=geo, device=device)
    b = assemble.assemble(vform.L2functional_vf(hs.dim, physical=f_physical),
                          hs, geo=geo, f=f, device=device)
    return operators.make_solver(M, spd=True).dot(b)
