# -*- coding: utf-8 -*-
"""Tour of the geometry layer over :mod:`pyiga_tpu_torch` (the port of
``examples/geometry_tour.py``): exact NURBS conics, B-spline
approximations, transforms and combinators, with quadrature checks
against closed-form areas and volumes.  Areas and volumes are integrals
by the Gauss rule of :func:`~pyiga_tpu_torch.assemble.integrate` (host
numpy, as in the JAX package); the parametric Hessian of the disk is
also evaluated on `device` (:func:`~pyiga_tpu_torch.ops.cuda_sumfac.
geometry_hessian`: K2 stages on the card) and held against the host's
:meth:`~pyiga_tpu_torch.geometry.NurbsFunc.grid_hessian`.

Run ``python examples/torch_geometry_tour.py`` on a machine with a CUDA
card, or ``python examples/torch_geometry_tour.py cpu`` on the CPU."""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from pyiga_tpu_torch import assemble, bspline, geometry  # noqa: E402
from pyiga_tpu_torch.config import resolve_device  # noqa: E402
from pyiga_tpu_torch.ops import cuda_sumfac, geom  # noqa: E402


def area(geo, n=40):
    kvs = geo.sdim * (bspline.make_knots(3, 0.0, 1.0, n),)
    return assemble.integrate(kvs, lambda *x: 1.0, geo=geo)


def hessian_levelorder(H, dim):
    """A host Hessian ``grid x dim x (sdim (sdim + 1) / 2)`` (linearized,
    components and derivative directions in XYZ order) as the device
    layout ``(dim, sdim, sdim) + grid`` (level order)."""
    sdim = H.ndim - 2
    out = np.empty((dim, sdim, sdim) + H.shape[:sdim])
    m = 0
    for i in reversed(range(sdim)):
        for j in reversed(range(i + 1)):
            for c in range(dim):
                out[dim - 1 - c, i, j] = out[dim - 1 - c, j, i] = \
                    H[..., c, m]
            m += 1
    return out


def device_hessian_error(geo, grid, device):
    """Max relative difference of the disk's parametric Hessian on
    `device` (K2 stages) against the host quotient rule."""
    tables, coeffs, nurbs = geom.geo_eval_tables(geo, grid, numderiv=2)
    Hd = cuda_sumfac.geometry_hessian(
        [torch.as_tensor(t, device=device) for t in tables],
        torch.as_tensor(coeffs, device=device), nurbs).cpu().numpy()
    Hh = hessian_levelorder(geo.grid_hessian(grid), geo.dim)
    return float(np.abs(Hd - Hh).max() / np.abs(Hh).max())


def main(device=None):
    """The tour; returns the unrounded areas and volumes."""
    device = resolve_device(device)
    # exact NURBS quarter annulus: area = pi*(r2^2 - r1^2)/4
    qa = geometry.quarter_annulus(r1=1.0, r2=2.0)
    a = area(qa)
    exact = np.pi * (4 - 1) / 4
    print('quarter annulus area: %.12f (exact %.12f, err %.1e)'
          % (a, exact, abs(a - exact)))
    assert abs(a - exact) < 1e-10           # NURBS circles are exact

    # the polynomial B-spline variant is a different (coarser) domain:
    # only NURBS represent circles exactly
    qb = geometry.bspline_quarter_annulus()
    a_qb = area(qb)
    print('b-spline variant area deviation from the circle: %.3f'
          % abs(a_qb - exact))

    # transforms compose
    big = qa.scale(2.0).rotate_2d(np.pi / 3).translate((1.0, -2.0))
    a_big = area(big)
    print('scaled/rotated/translated area: %.12f (expect %.12f)'
          % (a_big, 4 * exact))
    assert abs(a_big - 4 * exact) < 1e-9

    # full disk from a NURBS circle boundary; unit cube; twisted box volume
    disk = geometry.disk(r=1.5)
    a_disk = area(disk)
    print('disk area: %.12f (exact %.12f)' % (a_disk, np.pi * 1.5**2))
    tb = geometry.twisted_box()
    v_tb = area(tb, n=16)
    print('twisted box volume: %.6f' % v_tb)

    # combinators: extrude the exact 2D domain into a 3D solid
    cyl = geometry.tensor_product(geometry.line_segment(0.0, 2.0), qa)
    v = area(cyl, n=12)
    print('cylinderized quarter annulus volume: %.10f (exact %.10f)'
          % (v, 2 * exact))
    assert abs(v - 2 * exact) < 1e-8

    # point inversion: map physical points back to parameters
    G = geometry.quarter_annulus()
    x = G.eval(0.3, 0.7)
    uv = G.find_inverse(x)
    print('find_inverse roundtrip err: %.2e'
          % np.linalg.norm(np.asarray(G.eval(*uv)) - np.asarray(x)))

    # Jacobian determinants are positive on the parameter grid
    grid = 2 * (np.linspace(0, 1, 25),)
    det = np.linalg.det(qa.grid_jacobian(grid))
    print('det J range on grid: [%.4f, %.4f]' % (det.min(), det.max()))
    assert det.min() > 0

    # second derivatives of the disk map, on the device and on the host
    err = device_hessian_error(disk, 2 * (np.linspace(0.05, 0.95, 19),),
                               device)
    print('disk Hessian, %s vs host: rel err %.1e' % (device.type, err))
    assert err < 1e-12
    return dict(quarter_annulus=a, bspline_quarter_annulus=a_qb,
                transformed=a_big, disk=a_disk, twisted_box=v_tb,
                cylinder=v)


if __name__ == '__main__':
    main(device=sys.argv[1] if len(sys.argv) > 1 else None)
