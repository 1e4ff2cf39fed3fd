# -*- coding: utf-8 -*-
"""Tensor-product B-spline and NURBS geometry maps (host, numpy).

The parts of :mod:`pyiga_tpu.geometry` that the assembly needs: the
function classes hold their knot vectors and control points, which
:func:`~pyiga_tpu_torch.ops.geom.geo_eval_tables` turns into device
inputs, and evaluate on tensor grids (``grid_eval``, grid axes in ZYX
order) for the host setup of input fields.  Conventions are the JAX
package's: coefficient arrays are indexed in ZYX order (axis 0 belongs to
the last coordinate), vector components trail; NURBS coefficients are
stored premultiplied by the weights, which ride along as the last
component (homogeneous coordinates).
"""

import numpy as np

from . import bspline
from .bspline import KnotVector
from .ops.basis import dense_basis_table


def _prep_tp_coeffs(kvs, coeffs, sdim):
    """Validate/reshape a coefficient array for a TP basis; returns the array
    and the inferred output dimension."""
    N = tuple(kv.numdofs for kv in kvs)
    coeffs = np.asanyarray(coeffs)
    if coeffs.ndim == 1:
        if coeffs.shape[0] != np.prod(N):
            raise ValueError('wrong length of coefficient vector')
        coeffs = coeffs.reshape(N)
    if N != coeffs.shape[:sdim]:
        raise ValueError('wrong shape of coefficients')
    tail = coeffs.shape[sdim:]
    if len(tail) == 0:
        dim = 1
    elif len(tail) == 1:
        dim = tail[0]
    else:
        dim = tail
    return coeffs, dim


def _tp_grid_eval(kvs, coeffs, gridaxes):
    """Values of the tensor-product spline with `coeffs` on the grid
    `gridaxes` (ZYX order); trailing coefficient axes are kept."""
    if len(gridaxes) != len(kvs):
        raise ValueError('grid has wrong dimension')
    Y = np.asarray(coeffs, dtype=float)
    for k, (kv, g) in enumerate(zip(kvs, gridaxes)):
        B = dense_basis_table(kv, np.ravel(g), 0)[0]        # (n_k, Q_k)
        Y = np.moveaxis(np.tensordot(B.T, Y, axes=(1, k)), 0, k)
    return Y


class _BaseGeoFunc:
    """Base of the function classes: a function is a geometry-function
    object (parametric input field) rather than a plain callable
    (physical input field)."""

    def __call__(self, *x):
        """Evaluate at a single point (arguments in XYZ order)."""
        coords = tuple(reversed(x))     # XYZ -> ZYX
        singletons = tuple(i for i, c in enumerate(coords) if np.isscalar(c))
        coords = tuple(np.atleast_1d(np.asarray(c, dtype=float))
                       for c in coords)
        y = self.grid_eval(coords).squeeze(axis=singletons)
        return y.item() if y.shape == () else y


class BSplineFunc(_BaseGeoFunc):
    """A function in a tensor-product B-spline basis: `kvs` is a tuple of
    `d` :class:`~pyiga_tpu_torch.bspline.KnotVector`; `coeffs` has its
    first `d` axes matching the per-axis dofs, trailing axes give the
    output shape."""

    def __init__(self, kvs, coeffs):
        if isinstance(kvs, KnotVector):
            kvs = (kvs,)
        self.kvs = tuple(kvs)
        self.sdim = len(self.kvs)
        self.coeffs, self.dim = _prep_tp_coeffs(self.kvs, coeffs, self.sdim)

    def output_shape(self):
        return self.coeffs.shape[self.sdim:]

    def grid_eval(self, gridaxes):
        """Evaluate on a tensor grid (axes in ZYX order)."""
        return _tp_grid_eval(self.kvs, self.coeffs, gridaxes)


class NurbsFunc(_BaseGeoFunc):
    """A function in a tensor-product NURBS basis.  With ``weights=None``
    the weights are the last vector component of `coeffs`; unless
    `premultiplied`, the control points are multiplied by the weights."""

    def __init__(self, kvs, coeffs, weights, premultiplied=False):
        self.kvs = (kvs,) if isinstance(kvs, KnotVector) else tuple(kvs)
        self.sdim = len(self.kvs)
        coeffs, dim = _prep_tp_coeffs(self.kvs, coeffs, self.sdim)
        if isinstance(dim, tuple):
            raise ValueError('tensor-valued NURBS functions not implemented')
        isscalar = self._isscalar = coeffs.ndim == self.sdim
        homog = np.array(coeffs, dtype=float)
        if weights is None:
            if dim <= 1:
                raise ValueError('weights must be specified in the coeffs '
                                 'array')
            self.dim = dim - 1
        else:
            weights = np.asanyarray(weights)
            if weights.shape != homog.shape[:self.sdim]:
                raise ValueError('wrong shape of weights array')
            if isscalar:
                homog = np.stack((homog, weights), axis=-1)
            else:
                homog = np.concatenate((homog, weights[..., None]), axis=-1)
            self.dim = dim
        if not premultiplied:
            homog[..., :-1] *= homog[..., -1:]
        self.coeffs = homog

    def output_shape(self):
        if self._isscalar:
            return ()
        shp = list(self.coeffs.shape[self.sdim:])
        shp[-1] -= 1
        return tuple(shp)

    def grid_eval(self, gridaxes):
        """Evaluate on a tensor grid (axes in ZYX order): the quotient of
        the homogeneous components by the weight."""
        vals = _tp_grid_eval(self.kvs, self.coeffs, gridaxes)
        f = vals[..., :-1] / vals[..., -1:]
        return np.squeeze(f, -1) if self._isscalar else f


def bspline_quarter_annulus(r1=1.0, r2=2.0):
    """B-spline (non-exact) quarter annulus in the first quadrant."""
    kvx = bspline.make_knots(1, 0.0, 1.0, 1)
    kvy = bspline.make_knots(2, 0.0, 1.0, 1)
    coeffs = np.array([
        [[r1, 0.0], [r2, 0.0]],
        [[r1, r1], [r2, r2]],
        [[0.0, r1], [0.0, r2]],
    ])
    return BSplineFunc((kvy, kvx), coeffs)


def quarter_annulus(r1=1.0, r2=2.0):
    """Exact NURBS quarter annulus in the first quadrant."""
    kvx = bspline.make_knots(1, 0.0, 1.0, 1)
    kvy = bspline.make_knots(2, 0.0, 1.0, 1)
    w = 1.0 / np.sqrt(2.0)
    coeffs = np.array([
        [[r1, 0.0, 1.0], [r2, 0.0, 1.0]],
        [[r1, r1, w], [r2, r2, w]],
        [[0.0, r1, 1.0], [0.0, r2, 1.0]],
    ])
    return NurbsFunc((kvy, kvx), coeffs, weights=None)


def twisted_box():
    """3D box with its right face twisted and bent upwards
    (gismo twistedFlatQuarterAnnulus.xml)."""
    kv1 = bspline.make_knots(1, 0.0, 1.0, 1)
    kv2 = bspline.make_knots(3, 0.0, 1.0, 1)
    coeffs = np.array([
        1, 0, 0,    2, 0, 0,
        1, 0.5, 0,  2, 1.5, 0,
        0.5, 1, 0.5, 1.5, 2, 0.5,
        0, 1, 2,    0, 2, 2,
        1, 0, 1,    2, 0, 1,
        1, 0.5, 1,  2, 1.5, 1,
        1, 1, 1.5,  1.5, 2, 1.5,
        1, 1, 2,    1, 2, 2,
    ]).reshape((2, 4, 2, 3))
    return BSplineFunc((kv1, kv2, kv1), coeffs)
