"""Iterated Gauss-Legendre quadrature over knot spans (host, numpy).

A copy of :mod:`pyiga_tpu.quadrature`'s tensor and boundary rules:
per-interval affine mapping of the ``numpy.polynomial.legendre.leggauss``
nodes, points ordered interval-major.
"""

import numpy as np


def gauss_rule(deg, a, b):
    """Nodes and weights of the `deg`-point Gauss-Legendre rule on each of the
    intervals ``(a[i], b[i])``.  Returns flat ``(nodes, weights)`` arrays."""
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    mid, hw = 0.5 * (a + b), 0.5 * (b - a)
    x, w = np.polynomial.legendre.leggauss(deg)
    nodes = np.outer(hw, x) + mid[:, None]
    weights = np.outer(hw, w)
    return nodes.ravel(), weights.ravel()


def make_iterated_quadrature(intervals, nqp):
    """Gauss rule with `nqp` points per span over consecutive breakpoints."""
    return gauss_rule(nqp, intervals[:-1], intervals[1:])


def make_tensor_quadrature(meshes, nqp):
    """Tensor-product iterated Gauss rule: per-axis ``(grid, weights)`` tuples."""
    gauss = tuple(make_iterated_quadrature(mesh, nqp) for mesh in meshes)
    return tuple(g[0] for g in gauss), tuple(g[1] for g in gauss)


def make_boundary_quadrature(meshes, nqp, bdspec):
    """Tensor Gauss rule with the `bdspec` axis collapsed to the boundary
    point with unit weight (for boundary integrals)."""
    bdax, bdside = bdspec
    gauss = [make_iterated_quadrature(mesh, nqp) for mesh in meshes]
    bdcoord = meshes[bdax][0 if bdside == 0 else -1]
    gauss[bdax] = (np.array([bdcoord]), np.ones(1))
    return tuple(g[0] for g in gauss), tuple(g[1] for g in gauss)
