# -*- coding: utf-8 -*-
"""Poisson on an L-shaped domain built from three unit-square patches over
:mod:`pyiga_tpu_torch` (the port of ``examples/multipatch_poisson.py``):
the interfaces are matched automatically, shared dofs get a union
numbering, the per-patch stiffness matrices and load vectors are
assembled on `device` (the card unless ``'cpu'`` is given) and scattered
into the global system, which a sparse direct solve on the host solves.

Run ``python examples/torch_multipatch_poisson.py`` on a machine with a
CUDA card, or ``python examples/torch_multipatch_poisson.py cpu`` on the
CPU."""

import os
import sys
import time

import numpy as np
import scipy.sparse.linalg

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from pyiga_tpu_torch import bspline, geometry, vform  # noqa: E402
from pyiga_tpu_torch.assemble import (  # noqa: E402
    Multipatch, RestrictedLinearSystem)


def main(p=2, n=8, device=None):
    """Solve on the L shape with `n` elements per axis and degree `p` per
    patch; returns ``(u, info)`` with the global solution, the
    :class:`Multipatch`, the global system ``A, b`` and the assembly and
    solve times in ms (``assemble_ms``, ``solve_ms``)."""
    kvs = 2 * (bspline.make_knots(p, 0.0, 1.0, n),)
    squ = geometry.unit_square()
    patches = [(kvs, squ),
               (kvs, squ.translate((1, 0))),
               (kvs, squ.translate((1, 1)))]
    MP = Multipatch(patches, automatch=True)
    print('patches: %d, global dofs: %d' % (MP.numpatches, MP.numdofs))

    t0 = time.perf_counter()
    A, b = MP.assemble_system(vform.stiffness_vf(2),
                              vform.L2functional_vf(2, physical=True),
                              f=lambda x, y: 1.0, device=device)
    t1 = time.perf_counter()

    # homogeneous Dirichlet on the entire outer boundary
    zero = lambda x, y: 0.0     # noqa: E731
    outer = [(0, 'left', zero), (0, 'bottom', zero), (0, 'top', zero),
             (1, 'bottom', zero), (1, 'right', zero),
             (2, 'left', zero), (2, 'top', zero), (2, 'right', zero)]
    bcidx, bcvals = MP.compute_dirichlet_bcs(outer)
    LS = RestrictedLinearSystem(A, b, (bcidx, bcvals))
    t2 = time.perf_counter()
    u = LS.complete(scipy.sparse.linalg.spsolve(LS.A.tocsc(), LS.b))
    t3 = time.perf_counter()

    print('assembly %.1f ms, host solve %.1f ms'
          % (1e3 * (t1 - t0), 1e3 * (t3 - t2)))
    print('interior residual (free dofs): %.2e'
          % (np.linalg.norm(LS.R_free @ (A @ u - b)) / np.linalg.norm(b)))
    print('max u = %.6f (positive source, zero boundary)' % u.max())
    assert u.max() > 0 and np.all(np.isfinite(u))

    # the solution is continuous across the interfaces by construction:
    # evaluate both patches on the shared edge and compare
    u0 = (MP.global_to_patch(0) @ u).reshape((n + p,) * 2)
    u1 = (MP.global_to_patch(1) @ u).reshape((n + p,) * 2)
    f0 = geometry.BSplineFunc(kvs, u0).grid_eval(
        (np.linspace(0, 1, 17), np.array([1.0])))
    f1 = geometry.BSplineFunc(kvs, u1).grid_eval(
        (np.linspace(0, 1, 17), np.array([0.0])))
    jump = np.abs(f0 - f1).max()
    print('interface jump: %.2e' % jump)
    assert jump < 1e-12
    return u, dict(MP=MP, A=A, b=b, jump=jump,
                   assemble_ms=1e3 * (t1 - t0), solve_ms=1e3 * (t3 - t2))


if __name__ == '__main__':
    main(device=sys.argv[1] if len(sys.argv) > 1 else None)
