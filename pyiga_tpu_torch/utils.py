# -*- coding: utf-8 -*-
"""Evaluation of functions over tensor grids (host, numpy; a copy of the
grid-evaluation helpers of :mod:`pyiga_tpu.utils`).

Grid axes are given in ZYX order (the last axis is x); plain callables
receive XYZ-ordered coordinate arrays.  Input fields of a variational
form are evaluated here once, at assembler setup.
"""

import numpy as np


def _open_mesh(grid):
    """Open (broadcastable) coordinate arrays of a tensor grid, ij-indexed:
    axis k's array has shape (1,...,n_k,...,1)."""
    d = len(grid)
    return [np.reshape(g, (-1,) + (d - 1 - k) * (1,))
            for k, g in enumerate(grid)]


def _as_grid_array(values, grid_shape):
    """Normalize a function's return value over a tensor grid: broadcast up
    to the grid (constants / ignored arguments), stack tuple components into
    a trailing axis."""
    if isinstance(values, tuple):
        parts = [_as_grid_array(v, grid_shape) for v in values]
        return np.stack(parts, axis=-1)
    values = np.asanyarray(values)
    target = grid_shape + values.shape[len(grid_shape):]
    if values.shape != target:
        values = np.broadcast_to(values, target)
    return values


def grid_eval(f, grid):
    """Evaluate `f` over the tensor grid `grid` (axes in ZYX order; a plain
    callable receives XYZ-ordered coordinate arrays)."""
    if hasattr(f, 'grid_eval'):
        return f.grid_eval(grid)
    xyz = _open_mesh(grid)[::-1]        # grid axes are ZYX; args are XYZ
    return _as_grid_array(f(*xyz), tuple(len(g) for g in grid))


def grid_eval_transformed(f, grid, geo):
    """Evaluate `f` at the physical images of the tensor grid points under
    the geometry map `geo`."""
    pts = grid_eval(geo, grid)
    return _as_grid_array(f(*np.moveaxis(pts, -1, 0)),
                          tuple(len(g) for g in grid))
