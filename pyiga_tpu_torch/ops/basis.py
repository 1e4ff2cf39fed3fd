# -*- coding: utf-8 -*-
"""Dense per-axis basis tables (host, numpy; a copy of
:mod:`pyiga_tpu.ops.basis`).

Tables ``B[d, i, q]`` (derivative order, basis function, Gauss point) are
tiny (n x Q per axis); every downstream consumer is a plain contraction.
"""

import numpy as np

from .. import bspline


def dense_basis_table(kv, grid, numderiv):
    """Dense basis table ``B[d, i, q]`` = d-th derivative of B-spline `i` of
    `kv` at ``grid[q]``; shape ``(numderiv+1, numdofs, len(grid))``."""
    grid = np.asarray(grid, dtype=float)
    Q = grid.size
    ad = bspline.active_deriv(kv, grid, numderiv)       # (nd+1, p+1, Q)
    first = bspline.findspans(kv, grid) - kv.p          # (Q,)
    B = np.zeros((numderiv + 1, kv.numdofs, Q))
    cols = np.arange(Q)
    for r in range(kv.p + 1):
        B[:, first + r, cols] = ad[:, r, :]
    return B


def dense_collocation_tables(kvs, grids, numderiv):
    """Per-axis dense basis tables for a TP space over per-axis `grids`."""
    return [dense_basis_table(kv, g, numderiv) for kv, g in zip(kvs, grids)]
