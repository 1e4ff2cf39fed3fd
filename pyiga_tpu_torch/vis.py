# -*- coding: utf-8 -*-
"""Matplotlib visualization: scalar fields, geometry wireframes, curves,
field animations, and 2D hierarchical meshes (host copy of
:mod:`pyiga_tpu.vis`, on the port's host geometry, function and
hierarchical-space objects).

API-compatible with the reference's plotting module (same entry points:
``plot_field``, ``plot_geo``, ``plot_curve``, ``animate_field``,
``HSpaceVis``, ``plot_hierarchical_mesh``, ``plot_hierarchical_cells``,
``plot_active_cells``); the rendering is built on collection artists
(one ``LineCollection`` per wireframe direction, ``PatchCollection`` for
cell rectangles) rather than per-line plot calls.
"""

import numpy as np

import matplotlib.patches
import matplotlib.pyplot as plt
from matplotlib import animation
from matplotlib.collections import LineCollection, PatchCollection

from . import utils


def _as_pair(res):
    return (res, res) if np.isscalar(res) else tuple(res)


def _samples(support, counts):
    """Per-axis sample vectors over a function's parameter support."""
    return tuple(np.linspace(lo, hi, int(n))
                 for (lo, hi), n in zip(support, counts))


def plot_field(field, geo=None, res=80, physical=False, **kwargs):
    """Pseudocolor plot of a scalar field; with `geo`, over the mapped
    physical domain (``physical=True`` evaluates `field` at physical
    coordinates)."""
    kwargs.setdefault('shading', 'gouraud')
    ny, nx = _as_pair(res)
    if geo is None:
        grid = _samples(field.support, (ny, nx))
        vals = utils.grid_eval(field, grid)
        return plt.pcolormesh(grid[1], grid[0], vals, **kwargs)
    grid = _samples(geo.support, (ny, nx))
    phys = utils.grid_eval(geo, grid)
    if physical:
        vals = utils.grid_eval_transformed(field, grid, geo)
    else:
        vals = utils.grid_eval(field, grid)
    return plt.pcolormesh(phys[..., 0], phys[..., 1], vals, **kwargs)


def plot_curve(geo, res=50, linewidth=None, color='black'):
    """Draw a curve in the plane (sdim 1 -> dim 2)."""
    if not (geo.sdim == 1 and geo.dim == 2):
        raise ValueError('plot_curve needs a 2D curve (sdim=1, dim=2)')
    (ts,) = _samples(geo.support, (res,))
    xy = utils.grid_eval(geo, (ts,))
    plt.plot(xy[:, 0], xy[:, 1], color=color, linewidth=linewidth)


def _isolines(geo, fixed_values, n_along, transpose):
    """Polyline vertex arrays for isolines of a 2D geometry map: one line
    per entry of `fixed_values`, sampled with `n_along` points."""
    supp = geo.support
    along_axis = 0 if transpose else 1
    ts = np.linspace(supp[along_axis][0], supp[along_axis][1], n_along)
    grid = (fixed_values, ts) if not transpose else (ts, fixed_values)
    pts = utils.grid_eval(geo, grid)
    if transpose:
        pts = np.swapaxes(pts, 0, 1)
    return [pts[i] for i in range(pts.shape[0])]


def plot_geo(geo, grid=10, gridx=None, gridy=None, res=50,
             linewidth=None, color='black'):
    """Wireframe of a 2D geometry map as two families of isolines."""
    if geo.sdim == 1 and geo.dim == 2:
        return plot_curve(geo, res=res, linewidth=linewidth, color=color)
    if not (geo.dim == geo.sdim == 2):
        raise ValueError('plot_geo handles 2D -> 2D maps (or curves)')
    supp = geo.support
    lines = []
    # reference convention (vis.py:42-45): gridx fixes parameter AXIS 0,
    # gridy fixes axis 1
    for axis, count in ((0, gridx if gridx is not None else grid),
                        (1, gridy if gridy is not None else grid)):
        fixed = (np.linspace(supp[axis][0], supp[axis][1], count)
                 if np.isscalar(count) else np.asarray(count))
        lines += _isolines(geo, fixed, res, transpose=(axis == 1))
    ax = plt.gca()
    ax.add_collection(LineCollection(lines, colors=color,
                                     linewidths=linewidth, capstyle='round'))
    ax.autoscale_view()


def animate_field(fields, geo, vrange=None, res=(50, 50), cmap=None,
                  interval=50, progress=False):
    """FuncAnimation over a sequence of scalar fields on a fixed geometry."""
    frames = list(fields)
    ny, nx = _as_pair(res)
    grid = _samples(geo.support, (ny, nx))
    phys = geo.grid_eval(grid)
    if vrange is None:
        first = utils.grid_eval(frames[0], grid)
        vrange = (first.min(), first.max())

    fig, ax = plt.subplots()
    ax.set_aspect('equal')
    mesh = ax.pcolormesh(phys[..., 0], phys[..., 1], np.zeros((ny, nx)),
                         shading='gouraud', cmap=cmap,
                         vmin=vrange[0], vmax=vrange[1])
    fig.colorbar(mesh, ax=ax)
    bar = utils.progress_bar(progress)(total=len(frames))

    def draw(i):
        mesh.set_array(utils.grid_eval(frames[i], grid).ravel())
        bar.update()
        if i + 1 == len(frames):
            bar.close()

    return animation.FuncAnimation(fig, draw, frames=len(frames),
                                   interval=interval)


################################################################################
# Hierarchical meshes (2D)
################################################################################

def _rect_patch(extents):
    """Rectangle patch from per-axis extents (level order: last axis = x)."""
    (y0, y1), (x0, x1) = extents
    return matplotlib.patches.Rectangle((x0, y0), x1 - x0, y1 - y0)


def _bare_axes():
    ax = plt.gca()
    ax.set_aspect('equal')
    ax.set_xticks(())
    ax.set_yticks(())
    return ax


def _add_cell_patches(ax, hspace, lv, cells, facecolor):
    patches = [_rect_patch(hspace.cell_extents(lv, c)) for c in cells]
    if patches:
        ax.add_collection(PatchCollection(patches, facecolor=facecolor,
                                          edgecolor='black'))


class HSpaceVis:
    """2D hierarchical-space plotting helpers (API parity with the
    reference's class of the same name)."""

    def __init__(self, hspace):
        if hspace.dim != 2:
            raise ValueError('hierarchical visualization is 2D only')
        self.hspace = hspace

    @staticmethod
    def vis_rect(extents):
        return _rect_patch(extents)

    def cell_to_rect(self, lv, c):
        return _rect_patch(self.hspace.cell_extents(lv, c))

    def setup_axes(self):
        return _bare_axes()

    def plot_level(self, lv, color_act='steelblue', color_deact='lavender'):
        ax = _bare_axes()
        if color_act is not None:
            _add_cell_patches(ax, self.hspace, lv,
                              self.hspace.active_cells(lv), color_act)
        if color_deact is not None:
            _add_cell_patches(ax, self.hspace, lv,
                              self.hspace.deactivated_cells(lv), color_deact)

    def plot_level_cells(self, cells, lv, color_act='steelblue',
                         color_deact='white'):
        ax = _bare_axes()
        active = self.hspace.active_cells(lv)
        inside = [c for c in active if c in cells]
        outside = [c for c in active if c not in cells]
        if color_act is not None:
            _add_cell_patches(ax, self.hspace, lv, inside, color_act)
        if color_deact is not None:
            _add_cell_patches(ax, self.hspace, lv, outside, color_deact)

    def plot_active_cells(self, values, cmap=None, edgecolor=None):
        ax = _bare_axes()
        flat = self.hspace.active_cells(flat=True)
        values = np.asarray(values)
        if values.shape[0] != len(flat):
            raise ValueError('need one value per active cell '
                             '(%d given, %d cells)' % (len(values), len(flat)))
        coll = PatchCollection([self.cell_to_rect(lv, c) for lv, c in flat],
                               cmap=cmap, edgecolor=edgecolor)
        coll.set_array(values)
        ax.add_collection(coll)
        return ax, coll

    def vis_function(self, lv, jj):
        rect = _rect_patch(self.hspace.function_support(lv, jj))
        rect.set_fill(False)
        rect.set_edgecolor('red')
        rect.set_linewidth(3)
        return rect


def plot_hierarchical_mesh(hspace, levels='all', levelwise=False,
                           color_act='steelblue', color_deact='lavender'):
    """Draw the active (and optionally deactivated) cells of each level."""
    vis = HSpaceVis(hspace)
    which = (range(hspace.numlevels) if levels == 'all' else levels)
    which = tuple(which)
    for j, lv in enumerate(which):
        if levelwise:
            plt.subplot(1, len(which), j + 1)
        vis.plot_level(lv, color_act=color_act,
                       color_deact=(color_deact if levelwise else None))


def plot_hierarchical_cells(hspace, cells, color_act='steelblue',
                            color_deact='white'):
    """Highlight a per-level selection among the active cells."""
    vis = HSpaceVis(hspace)
    for lv in range(hspace.numlevels):
        vis.plot_level_cells(cells.get(lv, ()), lv, color_act=color_act,
                             color_deact=color_deact)


def plot_active_cells(hspace, values, cmap=None, edgecolor=None):
    """Color every active cell (level-major flat order) by `values`."""
    return HSpaceVis(hspace).plot_active_cells(values, cmap=cmap,
                                               edgecolor=edgecolor)
