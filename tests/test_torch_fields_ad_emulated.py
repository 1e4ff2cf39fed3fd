"""K1-jvp and K1-hvp from their own sources (``csrc/fields_jvp.cu``,
``csrc/fields_jvp_f32.cu``,
``csrc/fields_hvp.cu`` and the templates of ``csrc/fields.cuh``) on the
CPU: compiled by the host compiler under the emulation of
``tests/cuda_emulation.py`` (a thread per CUDA thread, a barrier per
block) and called through the wrappers' CUDA branch (``fields_jvp``,
``fields_hvp``: the argument lists of the C entries), against the plain
versions (1e-13 in float64, 1e-5 in float32) on the geometry partials of
small real assemblers: the 2D NURBS quarter annulus, the 3D twisted box,
a surface (``G = 3``), a one-point last axis (the ROWS mapping) and a
last axis of three coefficients (the runtime-nL instance), every kind,
bitwise on a repeat."""

import contextlib
import ctypes
import os

import numpy as np
import pytest
import torch

from pyiga_tpu_torch import _cuda, bspline, geometry
from pyiga_tpu_torch.assemblers import StiffnessAssembler
from pyiga_tpu_torch.ops import cuda_sumfac

import cuda_emulation

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'pyiga_tpu_torch', 'csrc')


@pytest.fixture(scope='module')
def emulated(tmp_path_factory):
    """The three translation units built into one library, its entries
    declared with the package's signatures."""
    def read(name):
        with open(os.path.join(CSRC, name)) as f:
            return f.read()
    lib = ctypes.CDLL(str(cuda_emulation.build(
        tmp_path_factory.mktemp('fields_ad'), 'fields_ad',
        {n: read(n) for n in ('fields_jvp.cu', 'fields_jvp_f32.cu',
                              'fields_hvp.cu')},
        {n: read(n) for n in ('fields.cuh', 'common.cuh')})))
    for name in ('pyiga_fields_jvp_f64', 'pyiga_fields_jvp_f32',
                 'pyiga_fields_hvp_f64', 'pyiga_fields_hvp_f32'):
        fn = getattr(lib, name)
        fn.argtypes = list(_cuda._SIGNATURES[name])
        fn.restype = ctypes.c_int
    return lib


@pytest.fixture
def card(emulated, monkeypatch):
    """The wrappers' CUDA branch on CPU tensors, the library the emulated
    one."""
    monkeypatch.setattr(cuda_sumfac, '_kernel_device', lambda t, n: True)
    monkeypatch.setattr(_cuda, 'library', lambda: emulated)
    monkeypatch.setattr(_cuda, 'require', lambda *a: None)
    monkeypatch.setattr(_cuda, 'device_of',
                        lambda t: contextlib.nullcontext())
    monkeypatch.setattr(_cuda, 'stream_of', lambda t: 0)
    monkeypatch.setattr(_cuda, 'check', lambda err, name: None if err == 0
                        else pytest.fail('%s returned %d' % (name, err)))
    _cuda.reset_launches()
    return emulated


def _partials(geo, d, n=4, p=2):
    kvs = d * (bspline.make_knots(p, 0.0, 1.0, n),)
    asm = StiffnessAssembler(kvs, geo, device='cpu')
    (Y, T, w12, wL, nurbs), _ = cuda_sumfac._spline_stages(asm.geo_inputs())
    return Y, T, w12, wL, nurbs


@pytest.fixture(scope='module')
def geos():
    """K1's operands of three geometries, through the plain versions
    (module scope: before the CUDA branch is forced)."""
    return {'annulus_nurbs': _partials(geometry.quarter_annulus(), 2),
            'box_3d': _partials(geometry.twisted_box(), 3, n=2),
            'bspline_annulus': _partials(
                geometry.bspline_quarter_annulus(), 2)}


def _case(geos, geo, variant):
    """K1's operands of `geo` in the `variant`: as they come, a one-point
    last axis ('rows'), a third last-axis coefficient with a small table
    ('nl3'), or three components on the 2D grid ('surface', jac only)."""
    Y, T, w12, wL, nurbs = geos[geo]
    if variant == 'rows':
        T, wL = T[:, :1].contiguous(), wL[:1].contiguous()
    elif variant == 'nl3':
        Y = torch.cat([Y, 0.3 * Y[..., :1]], dim=3).contiguous()
        T = torch.cat([T, 0.01 + 0.0 * T[..., :1]], dim=2).contiguous()
    elif variant == 'surface':
        d = Y.shape[0]
        Y = torch.cat([Y[:, :d], 0.5 * Y[:, :1] + 0.1, Y[:, d:]],
                      dim=1).contiguous()
    return Y, T, w12, wL, nurbs


def _rel(got, ref):
    got, ref = got.double(), ref.double()
    scale = float(ref.abs().max())
    return float((got - ref).abs().max()) / (scale if scale > 0 else 1.0)


CASES = [(g, v, k) for g in ('annulus_nurbs', 'box_3d', 'bspline_annulus')
         for v in ('plain', 'rows', 'nl3')
         for k in ('stiffness', 'mass', 'jac')] + [
    ('annulus_nurbs', 'surface', 'jac'), ('bspline_annulus', 'surface',
                                          'jac')]


@pytest.mark.parametrize('geo,variant,kind', CASES)
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32],
                         ids=['f64', 'f32'])
def test_emulated_jvp_hvp_match_plain(geos, card, geo, variant, kind,
                                      dtype):
    Y, T, w12, wL, nurbs = (t.to(dtype) if isinstance(t, torch.Tensor)
                            else t for t in _case(geos, geo, variant))
    if kind == 'jac':
        w12 = wL = None
    rng = np.random.RandomState(7)
    dY = torch.as_tensor(rng.rand(*Y.shape) - 0.5, dtype=dtype)
    tol = 1e-13 if dtype == torch.float64 else 1e-5
    got = cuda_sumfac.fields_jvp(kind, Y, T, w12, wL, nurbs, dY)
    ref = cuda_sumfac.fields_jvp_plain(kind, Y, T, w12, wL, nurbs, dY)
    assert got.dtype == dtype and got.shape == ref.shape
    assert _rel(got, ref) < tol
    assert torch.equal(cuda_sumfac.fields_jvp(kind, Y, T, w12, wL, nurbs,
                                              dY), got)
    g = torch.as_tensor(rng.rand(*ref.shape) - 0.5, dtype=dtype)
    got = cuda_sumfac.fields_hvp(kind, Y, T, w12, wL, nurbs, g, dY)
    ref = cuda_sumfac.fields_hvp_plain(kind, Y, T, w12, wL, nurbs, g, dY)
    assert got.shape == Y.shape and _rel(got, ref) < tol
    assert torch.equal(cuda_sumfac.fields_hvp(kind, Y, T, w12, wL, nurbs,
                                              g, dY), got)
    sfx = '_f32' if dtype == torch.float32 else ''
    counter = cuda_sumfac._FIELD_KINDS[kind][1]
    assert _cuda.LAUNCHES[counter + '_jvp' + sfx] == 2
    assert _cuda.LAUNCHES[counter + '_hvp' + sfx] == 2
