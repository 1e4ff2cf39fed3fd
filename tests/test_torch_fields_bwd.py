"""K1's backward in the PyTorch port at the shapes its kernel must keep: a
boundary grid's one-point last axis (QL = 1), a last axis longer than a
block (QL = 300), one leading row (Q12 = 1), a runtime coefficient count
(nL = 5), 2D and 3D, B-spline and NURBS, a surface (G = 3) for the
``jac`` kind.  Torch autograd through the port's plain route (K2's and
K1's wrappers on CPU tensors, whose backward runs ``stage_bwd_plain`` and
``_fields_vjp_plain``) against ``jax.vjp`` of the JAX package's
native-f64 fields, with respect to the geometry coefficients; and the
wrappers' CUDA branch driven on CPU tensors through a stand-in for the
library entries, which checks the kind code and the shape arguments
handed to ``pyiga_fields_bwd_f64`` and ``pyiga_geo_jac_fields_f64`` and
computes with the plain formulas.  All float64."""

import contextlib
import ctypes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pyiga_tpu import assemblers as jassemblers
from pyiga_tpu.ops import geom as jgeom

from pyiga_tpu_torch import _cuda, assemblers, convert
from pyiga_tpu_torch.ops import cuda_sumfac

from test_torch_fields import _ragged_geo_inputs

torch.set_num_threads(1)

# (d, nurbs, leading Gauss counts, QL, leading coefficient counts, nL, G)
SHAPES = [(2, False, (9,), 1, (4,), 2, 2), (3, True, (4, 5), 1, (3, 4), 3, 3),
          (2, True, (3,), 300, (4,), 3, 2),
          (3, False, (1, 1), 40, (3, 2), 2, 3),
          (3, True, (3, 4), 17, (3, 3), 5, 3),
          (2, False, (11,), 23, (5,), 5, 2)]
SURFACES = [(2, True, (7,), 13, (4,), 3, 3), (2, False, (5,), 1, (3,), 2, 3),
            (2, True, (1,), 300, (3,), 2, 3)]
KINDS = ('stiffness', 'mass', 'jac')


def _ids(shape):
    d, nurbs, qs, QL, _ns, nL, G = shape
    return 'd%d_G%d_%s_Q12=%d_QL=%d_nL=%d' % (
        d, G, 'nurbs' if nurbs else 'bspline', int(np.prod(qs)), QL, nL)


def _inputs(d, nurbs, qs, QL, ns, nL, G, seed=3):
    """:func:`_ragged_geo_inputs`, with a third component for a surface
    (G = d + 1) placed before the NURBS weight."""
    gi = _ragged_geo_inputs(d, nurbs, qs, QL, ns, nL, seed=seed)
    if G > d:
        c = gi['geo_coeffs']
        extra = 0.2 + 0.5 * np.random.RandomState(seed + 1).rand(
            1, *c.shape[1:])
        gi['geo_coeffs'] = np.concatenate([c[:d], extra, c[d:]])
    return gi


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _port_fields(kind, tgi, key, nurbs):
    if kind == 'stiffness':
        return assemblers.stiffness_fields(tgi)
    if kind == 'mass':
        return assemblers.mass_fields(tgi)
    return list(cuda_sumfac.geometry_fields(tgi[key], tgi['geo_coeffs'],
                                            nurbs))


def _jax_fields(kind, jgi, key, nurbs, d):
    if kind == 'stiffness':
        return list(jassemblers.stiffness_fields(jgi))
    if kind == 'mass':
        return list(jassemblers.mass_fields(jgi))
    return list(jgeom.geo_jacobian_field(jgi[key], jgi['geo_coeffs'], nurbs,
                                         d))


def _grad_case(kind, shape):
    """The gradient of ``sum_i <w_i, F_i>`` with respect to the geometry
    coefficients on the port's plain route and by ``jax.vjp``."""
    d, nurbs = shape[0], shape[1]
    gi = _inputs(*shape)
    key = 'geo_tables_nurbs' if nurbs else 'geo_tables_bsp'
    tgi = convert.geo_inputs(gi, device='cpu')
    c = tgi['geo_coeffs'].clone().requires_grad_(True)
    tgi['geo_coeffs'] = c
    got = _port_fields(kind, tgi, key, nurbs)
    rng = np.random.RandomState(7)
    ws = [rng.rand(*F.shape) - 0.5 for F in got]
    obj = sum((torch.as_tensor(w) * F).sum() for w, F in zip(ws, got))
    grad, = torch.autograd.grad(obj, c)

    jgi = {k: [jnp.asarray(a) for a in v] if isinstance(v, list)
           else jnp.asarray(v) for k, v in gi.items()}

    def fn(coeffs):
        return _jax_fields(kind, dict(jgi, geo_coeffs=coeffs), key, nurbs, d)
    ref, vjp = jax.vjp(fn, jgi['geo_coeffs'])
    assert [tuple(F.shape) for F in got] == [tuple(R.shape) for R in ref]
    jgrad, = vjp([jnp.asarray(w) for w in ws])
    return grad, jgrad


@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('shape', SHAPES, ids=_ids)
def test_fields_grad_matches_jax_vjp(kind, shape):
    grad, jgrad = _grad_case(kind, shape)
    assert grad.shape == jgrad.shape
    assert _rel(grad, jgrad) < 1e-12


@pytest.mark.parametrize('shape', SURFACES, ids=_ids)
def test_surface_jac_grad_matches_jax_vjp(shape):
    grad, jgrad = _grad_case('jac', shape)
    assert grad.shape == jgrad.shape
    assert _rel(grad, jgrad) < 1e-12


def _arr(ptr, *shape):
    buf = (ctypes.c_double * int(np.prod(shape))).from_address(ptr)
    return torch.from_numpy(np.ctypeslib.as_array(buf).reshape(shape))


class _FakeLibrary:
    """K1's and K1-bwd's C entries on host memory: each records its kind
    code and shape arguments, reads its operands from the pointers it is
    handed and writes its output with the plain formulas."""

    def __init__(self):
        self.calls = []

    def pyiga_fields_bwd_f64(self, kind, Y, T, w12, wL, g, gY, d, G, nurbs,
                             Q12, QL, nL, stream):
        self.calls.append(('bwd', kind, d, G, nurbs, Q12, QL, nL))
        C = G + nurbs
        name = ('stiffness', 'mass', 'jac')[kind]
        shape = {'stiffness': (d * (d + 1) // 2, Q12, QL),
                 'mass': (Q12, QL), 'jac': (G + G * d, Q12, QL)}[name]
        w = ((None, None) if name == 'jac'
             else (_arr(w12, Q12), _arr(wL, QL)))
        _arr(gY, d, C, Q12, nL)[...] = cuda_sumfac._fields_vjp_plain(
            name, _arr(Y, d, C, Q12, nL), _arr(T, 2, QL, nL), *w,
            bool(nurbs), _arr(g, *shape))
        return 0

    def pyiga_geo_jac_fields_f64(self, Y, T, out, d, G, nurbs, Q12, QL, nL,
                                 stream):
        self.calls.append(('jac', 2, d, G, nurbs, Q12, QL, nL))
        C = G + nurbs
        _arr(out, G + G * d, Q12, QL)[...] = cuda_sumfac.geo_jac_fields_plain(
            _arr(Y, d, C, Q12, nL), _arr(T, 2, QL, nL), bool(nurbs))
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors: the device test forced,
    the library replaced by :class:`_FakeLibrary`."""
    lib = _FakeLibrary()
    monkeypatch.setattr(cuda_sumfac, '_kernel_device', lambda t, n: True)
    monkeypatch.setattr(_cuda, 'library', lambda: lib)
    monkeypatch.setattr(_cuda, 'require', lambda *a: None)
    monkeypatch.setattr(_cuda, 'device_of',
                        lambda t: contextlib.nullcontext())
    monkeypatch.setattr(_cuda, 'stream_of', lambda t: 0)
    _cuda.reset_launches()
    return lib


def _stage_operands(shape):
    """K1's operands ``(Y, T, w12, wL, nurbs)`` of a shape, through the
    plain stages."""
    gi = _inputs(*shape)
    (Y, T, w12, wL, nurbs), _grid = cuda_sumfac._spline_stages(
        convert.geo_inputs(gi, device='cpu'))
    return Y, T, w12, wL, nurbs


@pytest.mark.parametrize('kind,shape', [(k, s) for s in SHAPES for k in KINDS]
                         + [('jac', SURFACES[1])],
                         ids=lambda v: v if isinstance(v, str) else _ids(v))
def test_fields_bwd_cuda_branch_arguments(request, kind, shape):
    d, nurbs, _qs, QL, _ns, nL, G = shape
    Y, T, w12, wL, nurbs = _stage_operands(shape)
    fake_card = request.getfixturevalue('fake_card')
    Q12 = Y.shape[2]
    out = {'stiffness': (d * (d + 1) // 2, Q12, QL), 'mass': (Q12, QL),
           'jac': (G + G * d, Q12, QL)}[kind]
    g = torch.as_tensor(np.random.RandomState(5).rand(*out) - 0.5)
    a = (None, None) if kind == 'jac' else (w12, wL)
    got = cuda_sumfac.fields_bwd(kind, Y, T, *a, nurbs, g)
    code = {'stiffness': 0, 'mass': 1, 'jac': 2}[kind]
    assert fake_card.calls == [('bwd', code, d, G, int(nurbs), Q12, QL, nL)]
    counter = cuda_sumfac._FIELD_KINDS[kind][2]
    assert _cuda.LAUNCHES[counter] == 1
    ref = cuda_sumfac._fields_vjp_plain(kind, Y, T, *a, nurbs, g)
    assert got.shape == Y.shape and torch.equal(got, ref)


@pytest.mark.parametrize('shape', [SHAPES[1], SURFACES[1]], ids=_ids)
def test_geo_jac_fields_one_point_axis_through_autograd(request, shape):
    """At QL = 1 the ``jac`` kind's forward and, through autograd, its
    backward reach their C entries with the boundary grid's shape."""
    d, _nurbs, _qs, QL, _ns, nL, G = shape
    Y, T, _w12, _wL, nurbs = _stage_operands(shape)
    fake_card = request.getfixturevalue('fake_card')
    Q12 = Y.shape[2]
    assert QL == 1 and T.shape[1] == 1
    Yg = Y.clone().requires_grad_(True)
    out = cuda_sumfac.geo_jac_fields(Yg, T, nurbs)
    assert torch.equal(out.detach(),
                       cuda_sumfac.geo_jac_fields_plain(Y, T, nurbs))
    w = torch.as_tensor(np.random.RandomState(9).rand(*out.shape))
    grad, = torch.autograd.grad((w * out).sum(), Yg)
    args = (d, G, int(nurbs), Q12, QL, nL)
    assert fake_card.calls == [('jac', 2) + args, ('bwd', 2) + args]
    assert _cuda.LAUNCHES['geo_jac_fields'] == 1
    assert _cuda.LAUNCHES['geo_jac_fields_bwd'] == 1
    assert torch.equal(grad, cuda_sumfac.geo_jac_fields_bwd_plain(
        Y, T, nurbs, w))
