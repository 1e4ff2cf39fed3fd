# -*- coding: utf-8 -*-
"""Adaptive Poisson with THB-splines and the local multigrid solver over
:mod:`pyiga_tpu_torch` (the port of ``examples/adaptive_poisson.py``):
refine toward a corner, assemble over the hierarchical space on `device`
(per-level VForm assemblies: K1 ``jac``, K5, K2 and K3 on the card),
solve with local multigrid (one launch of the V-cycle kernel K6 a solve
on the card), repeat.

Run ``python examples/torch_adaptive_poisson.py`` on a machine with a
CUDA card, or ``python examples/torch_adaptive_poisson.py cpu`` on the
CPU."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from pyiga_tpu_torch import bspline, geometry, solvers, vform  # noqa: E402
from pyiga_tpu_torch.hierarchical import (  # noqa: E402
    HDiscretization, HSpace)


def main(p=3, n0=8, num_refinements=3, truncate=True, device=None):
    """Refine `num_refinements` times; returns the space, the last
    solution (numpy) and the MG iteration count of every sweep."""
    geo = geometry.unit_square()
    hs = HSpace(2 * (bspline.make_knots(p, 0.0, 1.0, n0),),
                truncate=truncate, disparity=1,
                bdspecs=[(0, 0), (0, 1), (1, 0), (1, 1)])

    counts = []
    for sweep in range(num_refinements):
        # refine towards the reentrant-like corner at the origin
        hs.refine_region(sweep, lambda x, y: max(x, y) < 0.5 ** sweep * 0.5)

        hd = HDiscretization(hs, vform.stiffness_vf(dim=2),
                             {'geo': geo, 'f': lambda *x: 1.0},
                             device=device)
        A = hd.assemble_matrix()
        f = hd.assemble_rhs()

        u, iters = solvers.solve_hmultigrid(hs, A, f, strategy='cell_supp',
                                            smoother='symmetric_gs',
                                            tol=1e-8, device=device)
        print('sweep %d: levels=%d dofs=%d MG iterations=%s'
              % (sweep, hs.numlevels, hs.numdofs, iters))
        counts.append(iters)
    return hs, u, counts


if __name__ == '__main__':
    main(device=sys.argv[1] if len(sys.argv) > 1 else None)
