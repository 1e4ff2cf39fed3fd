"""The port's profiling helpers (``pyiga_tpu_torch.profiling``: the
``Timings`` / ``timed`` protocol of ``tests/test_misc.py``, the device
sync over nested results, a ``torch.profiler`` trace written into a
directory, errors not swallowed) and its plotting module
(``pyiga_tpu_torch.vis``) against ``pyiga_tpu.vis`` on the same objects
under the Agg backend: every artist's data (line segments, mesh arrays
and coordinates, patch extents, colors) to 1e-12."""

import glob
import io
import json
import warnings

import matplotlib
matplotlib.use('Agg')
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import pyiga_tpu.approx as japprox  # noqa: E402
import pyiga_tpu.bspline as jbspline  # noqa: E402
import pyiga_tpu.geometry as jgeometry  # noqa: E402
import pyiga_tpu.hierarchical as jhier  # noqa: E402
import pyiga_tpu.vis as jvis  # noqa: E402

from pyiga_tpu_torch import (approx, bspline, geometry,  # noqa: E402
                             hierarchical, profiling, vis)

torch.set_num_threads(1)

TOL = 1e-12


# -- profiling --------------------------------------------------------------

def test_profiling_helpers(tmp_path, capsys):
    T = profiling.Timings()
    with T('phase', sync=None) as box:
        box['result'] = torch.arange(10.0, dtype=torch.float64) * 2
    with T('phase'):
        pass
    assert len(T.records['phase']) == 2
    buf = io.StringIO()
    T.report(buf)
    assert 'phase' in buf.getvalue() and '2 calls' in buf.getvalue()

    with profiling.timed('block', verbose=True) as box:
        box['result'] = torch.ones(5, dtype=torch.float64)
    out = capsys.readouterr().out
    assert 'block:' in out and out.strip().endswith('ms')
    assert box['seconds'] >= 0
    with profiling.timed('quiet', sync=torch.ones(2), verbose=False) as box:
        pass
    assert capsys.readouterr().out == '' and box['seconds'] >= 0

    with profiling.trace(tmp_path / 'prof') as prof:
        float(torch.sum(torch.ones(8, dtype=torch.float64)))
    files = glob.glob(str(tmp_path / 'prof' / '*.pt.trace.json'))
    assert len(files) == 1
    names = {e.get('name') for e in json.load(open(files[0]))['traceEvents']}
    assert 'aten::sum' in names
    assert any(e.key == 'aten::sum' for e in prof.key_averages())


def test_device_sync_walks_nested_results(monkeypatch):
    """Every CUDA device among the leaves of nested tuples, lists and
    dicts is synchronized, each once; CPU tensors and non-tensors are
    not."""
    class Dev:
        def __init__(self, index):
            self.type, self.index = 'cuda', index

        def __eq__(self, other):
            return self.index == other.index

        def __hash__(self):
            return self.index

    class FakeCuda(torch.Tensor):
        pass

    def cuda_tensor(index):
        t = torch.zeros(1).as_subclass(FakeCuda)
        t._dev = Dev(index)
        return t
    monkeypatch.setattr(FakeCuda, 'device', property(lambda t: t._dev),
                        raising=False)
    synced = []
    monkeypatch.setattr(torch.cuda, 'synchronize',
                        lambda dev=None: synced.append(dev.index))
    result = ({'a': [cuda_tensor(1), torch.zeros(2)], 'b': 3.0},
              [cuda_tensor(0), (cuda_tensor(1),)], 'text')
    assert profiling._device_sync(result) is result
    assert sorted(synced) == [0, 1]
    synced.clear()
    with profiling.timed('x', verbose=False) as box:
        box['result'] = [cuda_tensor(2)]
    assert synced == [2]


def test_trace_raises_on_a_profiler_error(tmp_path, monkeypatch):
    """Unlike the JAX package's, the trace does not carry on as a no-op
    when the profiler fails."""
    import torch.profiler

    class Broken:
        def __init__(self, *a, **k):
            pass

        def __enter__(self):
            raise RuntimeError('profiler unavailable')

        def __exit__(self, *exc):
            return False
    monkeypatch.setattr(torch.profiler, 'profile', Broken)
    with pytest.raises(RuntimeError, match='profiler unavailable'):
        with profiling.trace(tmp_path / 'prof'):
            pass


# -- vis against pyiga_tpu.vis ---------------------------------------------

def _close(a, b, tol=TOL):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    assert a.shape == b.shape
    assert np.abs(a - b).max(initial=0.0) <= tol * max(
        np.abs(b).max(initial=0.0), 1.0)


def _artists(ax):
    """Every artist's data on the axes, in order."""
    out = []
    for c in ax.collections:
        rec = dict(kind=type(c).__name__)
        if hasattr(c, 'get_coordinates'):
            rec['coords'] = np.asarray(c.get_coordinates())
        if hasattr(c, 'get_segments'):
            rec['segments'] = [np.asarray(s) for s in c.get_segments()]
        else:
            rec['paths'] = [np.asarray(p.vertices) for p in c.get_paths()]
        arr = c.get_array()
        rec['array'] = None if arr is None else np.asarray(arr)
        rec['face'] = np.asarray(c.get_facecolor())
        rec['edge'] = np.asarray(c.get_edgecolor())
        out.append(rec)
    for ln in ax.lines:
        out.append(dict(kind='Line2D', xy=np.asarray(ln.get_xydata()),
                        color=ln.get_color()))
    return out


def _same_artists(got, ref):
    assert [r['kind'] for r in got] == [r['kind'] for r in ref]
    assert got, 'nothing drawn'
    for g, r in zip(got, ref):
        for key in r:
            if key == 'kind':
                continue
            if r[key] is None or isinstance(r[key], str):
                assert g[key] == r[key] if isinstance(r[key], str) \
                    else g[key] is None
            elif isinstance(r[key], list):
                assert len(g[key]) == len(r[key])
                for x, y in zip(g[key], r[key]):
                    _close(x, y)
            else:
                _close(g[key], r[key])


def _draw(fn):
    plt.close('all')
    fig = plt.figure()
    ret = fn()
    out = [_artists(ax) for ax in fig.axes]
    plt.close('all')
    return out, ret


def _both(port_fn, jax_fn):
    got, g = _draw(port_fn)
    ref, r = _draw(jax_fn)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        _same_artists(a, b)
    return g, r


def _fields():
    kvs = 2 * (bspline.make_knots(2, 0.0, 1.0, 4),)
    jkvs = 2 * (jbspline.make_knots(2, 0.0, 1.0, 4),)
    geo, jgeo = geometry.quarter_annulus(), jgeometry.quarter_annulus()
    u = approx.interpolate(kvs, lambda x, y: x + y * y, geo=geo)
    ju = japprox.interpolate(jkvs, lambda x, y: x + y * y, geo=jgeo)
    _close(u, ju)
    return (geometry.BSplineFunc(kvs, u), geo,
            jgeometry.BSplineFunc(jkvs, ju), jgeo)


@pytest.mark.parametrize('case', ['geo', 'param', 'physical', 'res'])
def test_plot_field_matches_jax(case):
    f, geo, jf, jgeo = _fields()
    kw = dict(geo=(geo, jgeo), physical=False, res=80)
    if case == 'param':
        kw['geo'] = (None, None)
    elif case == 'physical':
        f = jf = (lambda x, y: np.sin(x) * y)
        kw['physical'] = True
    elif case == 'res':
        kw['res'] = (12, 17)
    g, r = _both(
        lambda: vis.plot_field(f, geo=kw['geo'][0], res=kw['res'],
                               physical=kw['physical']),
        lambda: jvis.plot_field(jf, geo=kw['geo'][1], res=kw['res'],
                                physical=kw['physical']))
    assert type(g).__name__ == type(r).__name__ == 'QuadMesh'


@pytest.mark.parametrize('case', ['annulus', 'gridxy', 'curve', 'nurbs'])
def test_plot_geo_and_curve_match_jax(case):
    if case == 'annulus':
        _both(lambda: vis.plot_geo(geometry.quarter_annulus(), grid=7,
                                   res=20, linewidth=2, color='red'),
              lambda: jvis.plot_geo(jgeometry.quarter_annulus(), grid=7,
                                    res=20, linewidth=2, color='red'))
    elif case == 'gridxy':
        _both(lambda: vis.plot_geo(geometry.bspline_quarter_annulus(),
                                   gridx=[0.0, 0.25, 1.0], gridy=5),
              lambda: jvis.plot_geo(jgeometry.bspline_quarter_annulus(),
                                    gridx=[0.0, 0.25, 1.0], gridy=5))
    elif case == 'curve':
        _both(lambda: vis.plot_curve(geometry.circular_arc(1.0), res=33),
              lambda: jvis.plot_curve(jgeometry.circular_arc(1.0), res=33))
    else:
        _both(lambda: vis.plot_geo(geometry.circular_arc(np.pi / 3, 2.0)),
              lambda: jvis.plot_geo(jgeometry.circular_arc(np.pi / 3, 2.0)))
    with pytest.raises(ValueError):
        vis.plot_curve(geometry.quarter_annulus())
    with pytest.raises(ValueError):
        vis.plot_geo(geometry.twisted_box())


def test_animate_field_matches_jax():
    f, geo, jf, jgeo = _fields()
    frames = [f, geometry.BSplineFunc(f.kvs, 2 * f.coeffs)]
    jframes = [jf, jgeometry.BSplineFunc(jf.kvs, 2 * jf.coeffs)]
    arrays = []
    for mod, fr, g in ((vis, frames, geo), (jvis, jframes, jgeo)):
        plt.close('all')
        anim = mod.animate_field(fr, g, res=(9, 11), progress=False)
        per_frame = []
        for i in range(len(fr)):
            anim._func(i)
            mesh = anim._fig.axes[0].collections[0]
            per_frame.append((np.asarray(mesh.get_array()).copy(),
                              np.asarray(mesh.get_coordinates()),
                              mesh.get_clim()))
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            anim._draw_was_started = True
            del anim
        arrays.append(per_frame)
        plt.close('all')
    for (a, c, lim), (b, d, jlim) in zip(*arrays):
        _close(a, b)
        _close(c, d)
        _close(lim, jlim)


def _hspaces():
    def build(bsp, hier):
        hs = hier.HSpace(2 * (bsp.make_knots(2, 0.0, 1.0, 4),))
        hs.refine_region(0, lambda x, y: x > 0.5 and y > 0.5)
        hs.refine_region(1, lambda x, y: x > 0.75 and y > 0.6)
        return hs
    return build(bspline, hierarchical), build(jbspline, jhier)


def test_hierarchical_plots_match_jax():
    hs, jhs = _hspaces()
    assert hs.numlevels == jhs.numlevels == 3
    _both(lambda: vis.plot_hierarchical_mesh(hs),
          lambda: jvis.plot_hierarchical_mesh(jhs))
    _both(lambda: vis.plot_hierarchical_mesh(hs, levels=(0, 2),
                                             levelwise=True),
          lambda: jvis.plot_hierarchical_mesh(jhs, levels=(0, 2),
                                              levelwise=True))
    cells = {0: set(sorted(hs.active_cells(0))[:3]),
             1: set(sorted(hs.active_cells(1))[-2:])}
    _both(lambda: vis.plot_hierarchical_cells(hs, cells),
          lambda: jvis.plot_hierarchical_cells(jhs, cells))
    values = np.random.RandomState(7).rand(hs.total_active_cells)
    g, r = _both(lambda: vis.plot_active_cells(hs, values, cmap='viridis'),
                 lambda: jvis.plot_active_cells(jhs, values, cmap='viridis'))
    _close(g[1].get_array(), r[1].get_array())
    with pytest.raises(ValueError):
        vis.plot_active_cells(hs, values[:-1])


def test_hspacevis_patches_match_jax():
    hs, jhs = _hspaces()
    V, J = vis.HSpaceVis(hs), jvis.HSpaceVis(jhs)

    def ext(rect):
        return (rect.get_x(), rect.get_y(), rect.get_width(),
                rect.get_height())
    for lv in range(hs.numlevels):
        for c in sorted(hs.active_cells(lv))[:4]:
            _close(ext(V.cell_to_rect(lv, c)), ext(J.cell_to_rect(lv, c)))
        for jj in sorted(hs.active_functions(lv))[:4]:
            a, b = V.vis_function(lv, jj), J.vis_function(lv, jj)
            _close(ext(a), ext(b))
            assert a.get_fill() == b.get_fill() is False
            _close(a.get_edgecolor(), b.get_edgecolor())
            assert a.get_linewidth() == b.get_linewidth()
    _close(ext(V.vis_rect(((0.1, 0.4), (0.2, 0.9)))),
           ext(J.vis_rect(((0.1, 0.4), (0.2, 0.9)))))
    _both(lambda: V.plot_level(1, color_deact='pink'),
          lambda: J.plot_level(1, color_deact='pink'))
    _both(lambda: V.plot_level_cells(set(sorted(hs.active_cells(2))[:2]), 2),
          lambda: J.plot_level_cells(set(sorted(jhs.active_cells(2))[:2]),
                                     2))
    ax = V.setup_axes()
    assert list(ax.get_xticks()) == [] and ax.get_aspect() == 1.0
    plt.close('all')
    hs3 = hierarchical.HSpace(3 * (bspline.make_knots(1, 0.0, 1.0, 2),))
    with pytest.raises(ValueError):
        vis.HSpaceVis(hs3)
