# -*- coding: utf-8 -*-
"""Tensor-product B-spline and NURBS geometry maps (host, numpy).

The parts of :mod:`pyiga_tpu.geometry` that the assembly and the
hierarchical spaces need: the
function classes hold their knot vectors and control points, which
:func:`~pyiga_tpu_torch.ops.geom.geo_eval_tables` turns into device
inputs, and evaluate on tensor grids (``grid_eval``, grid axes in ZYX
order) for the host setup of input fields.  Conventions are the JAX
package's: coefficient arrays are indexed in ZYX order (axis 0 belongs to
the last coordinate), vector components trail; NURBS coefficients are
stored premultiplied by the weights, which ride along as the last
component (homogeneous coordinates).  The factories :func:`unit_square`,
:func:`unit_cube` and :func:`line_segment` build B-spline maps through
:func:`tensor_product`.
"""

import functools

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


def _tp_grid_eval(kvs, coeffs, gridaxes, D=None):
    """Values of the tensor-product spline with `coeffs` on the grid
    `gridaxes` (ZYX order), or of its partial derivative of per-axis
    orders `D` (grid-axis order); trailing coefficient axes are kept."""
    if len(gridaxes) != len(kvs):
        raise ValueError('grid has wrong dimension')
    D = (0,) * len(kvs) if D is None else D
    Y = np.asarray(coeffs, dtype=float)
    for k, (kv, g) in enumerate(zip(kvs, gridaxes)):
        B = dense_basis_table(kv, np.ravel(g), D[k])[D[k]]   # (n_k, Q_k)
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

    eval = __call__

    def is_scalar(self):
        return len(self.output_shape()) == 0

    def is_vector(self):
        return len(self.output_shape()) == 1


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

    def grid_jacobian(self, gridaxes):
        """Jacobians on a tensor grid; shape ``grid x output x sdim``
        (the gradient per point for a scalar function), derivative axis
        in XYZ order."""
        d = self.sdim
        return np.stack([_tp_grid_eval(self.kvs, self.coeffs, gridaxes,
                                       tuple(int(j == i) for j in range(d)))
                         for i in reversed(range(d))], axis=-1)

    def grid_hessian(self, gridaxes):
        """Symmetric parts of the Hessians on a tensor grid, linearized in
        the JAX package's order (``xx, xy, yy`` in 2D)."""
        d = self.sdim
        comps = []
        for i in reversed(range(d)):
            for j in reversed(range(i + 1)):
                D = [0] * d
                D[i] += 1
                D[j] += 1
                comps.append(_tp_grid_eval(self.kvs, self.coeffs, gridaxes,
                                           tuple(D)))
        return np.stack(comps, axis=-1)

    def as_nurbs(self):
        return NurbsFunc(self.kvs, self.coeffs.copy(),
                         np.ones(self.coeffs.shape[:self.sdim]))

    def as_vector(self):
        if self.is_vector():
            return self
        if not self.is_scalar():
            raise ValueError('as_vector needs a scalar or vector function')
        return BSplineFunc(self.kvs, self.coeffs[..., np.newaxis])


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

    def coeffs_weights(self):
        """Non-premultiplied coefficients and weights as a pair of
        arrays."""
        W = self.coeffs[..., -1]
        return self.coeffs[..., :-1] / W[..., None], W.copy()

    def as_nurbs(self):
        return self

    def as_vector(self):
        if self.is_vector():
            return self
        if not self.is_scalar():
            raise ValueError('as_vector needs a scalar or vector function')
        return NurbsFunc(self.kvs, self.coeffs[..., :-1],
                         self.coeffs[..., -1], premultiplied=True)


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


def line_segment(x0, x1, support=(0.0, 1.0), intervals=1):
    """Linear spline curve between the points/vectors `x0` and `x1`."""
    x0 = np.atleast_1d(np.asarray(x0, dtype=float)).ravel()
    x1 = np.atleast_1d(np.asarray(x1, dtype=float)).ravel()
    if len(x0) != len(x1):
        raise ValueError('vectors must have the same dimension')
    S = np.linspace(0.0, 1.0, intervals + 1)[:, None]
    return BSplineFunc(bspline.make_knots(1, support[0], support[1],
                                          intervals),
                       (1 - S) * x0 + S * x1)


def _outer_shapes(Cs, sdims):
    SD1, SD2 = (np.atleast_1d(C.shape[:sd]).astype(np.int64)
                for C, sd in zip(Cs, sdims))
    VD1, VD2 = (np.atleast_1d(C.shape[sd:]).astype(np.int64)
                for C, sd in zip(Cs, sdims))
    shape1 = np.concatenate((SD1, np.ones_like(SD2), VD1))
    shape2 = np.concatenate((np.ones_like(SD1), SD2, VD2))
    return np.reshape(Cs[0], shape1), np.reshape(Cs[1], shape2)


def tensor_product(G1, G2, *Gs):
    r"""Tensor product ``G(x,y) = G2(x) x G1(y)`` (output vectors joined);
    `sdim` and `dim` are the sums of the inputs'."""
    if Gs:
        return tensor_product(G1, tensor_product(G2, *Gs))
    if G1.is_scalar():
        G1 = G1.as_vector()
    if G2.is_scalar():
        G2 = G2.as_vector()
    if not (G1.is_vector() and G2.is_vector()):
        raise ValueError('only implemented for scalar- or vector-valued '
                         'functions')

    nurbs = isinstance(G1, NurbsFunc) or isinstance(G2, NurbsFunc)
    if nurbs:
        G1, G2 = G1.as_nurbs(), G2.as_nurbs()
        CC1, W1 = G1.coeffs_weights()
        CC2, W2 = G2.coeffs_weights()
        Cs = (CC1, CC2)
        WW1, WW2 = _outer_shapes((W1, W2), (G1.sdim, G2.sdim))
        W = WW1 * WW2
    else:
        Cs = (G1.coeffs, G2.coeffs)

    SD1 = np.atleast_1d(Cs[0].shape[:G1.sdim])
    SD2 = np.atleast_1d(Cs[1].shape[:G2.sdim])
    VD1 = np.atleast_1d(Cs[0].shape[G1.sdim:])
    VD2 = np.atleast_1d(Cs[1].shape[G2.sdim:])
    shape1 = np.concatenate((SD1, np.ones_like(SD2), VD1))
    shape2 = np.concatenate((np.ones_like(SD1), SD2, VD2))
    tgt1 = np.concatenate((SD1, SD2, VD1))
    tgt2 = np.concatenate((SD1, SD2, VD2))
    C1 = np.broadcast_to(np.reshape(Cs[0], shape1), tgt1)
    C2 = np.broadcast_to(np.reshape(Cs[1], shape2), tgt2)
    # coefficients are in XY order but coordinate axes in YX order
    C = np.concatenate((C2, C1), axis=-1)

    if nurbs:
        return NurbsFunc(G1.kvs + G2.kvs, C, W)
    return BSplineFunc(G1.kvs + G2.kvs, C)


def unit_cube(dim=3, num_intervals=1):
    """The `dim`-dimensional unit cube."""
    return functools.reduce(
        tensor_product,
        dim * (line_segment(0.0, 1.0, intervals=num_intervals),))


def unit_square(num_intervals=1):
    """Unit square as a :class:`BSplineFunc`."""
    return unit_cube(dim=2, num_intervals=num_intervals)
