"""The f32 line beyond Poisson and mass, held against the JAX package under
``set_dtype(np.float32)`` on the same seeded inputs: VForm assembly
(``run_device`` / ``assemble``, a ``ds`` form, a surface form, a string
form), ``compact_slice`` and ``aca_3d_device``, the hierarchical
per-level assembly, the windowed route and the stiffness of a
host-evaluated geometry (K1').  Also: the float32 plain versions of K1's
``jac`` kind, K1', K5 and K8 / K8f compute in float32; their wrappers'
CUDA branch, driven through stand-in libraries, calls the ``_f32``
entries; the windowed plan for 4-byte elements against ``make_plan``
compiled from ``csrc/windowed.cu`` by the host compiler and the kernel's
float32 schedule emulated in numpy; the generated float32 K5 source
holds no double; the VForm operands follow a ``set_dtype`` switch."""

import contextlib
import ctypes
import re
import subprocess

import numpy as np
import pytest
import torch

import pyiga_tpu
import pyiga_tpu.bspline as jbspline
import pyiga_tpu.geometry as jgeometry
from pyiga_tpu import assemble as jassemble
from pyiga_tpu import compile as jcompile
from pyiga_tpu import vform as jvform
from pyiga_tpu._hdiscr import HDiscretization as JHDiscretization
from pyiga_tpu.assemblers import MassAssembler as JMassAssembler
from pyiga_tpu.assemblers import StiffnessAssembler as JStiffnessAssembler
from pyiga_tpu.hierarchical import HSpace as JHSpace

import pyiga_tpu_torch
from pyiga_tpu_torch import (_cuda, assemble, bspline, compile, geometry,
                             lowrank, vform)
from pyiga_tpu_torch._hdiscr import HDiscretization
from pyiga_tpu_torch.assemblers import MassAssembler, StiffnessAssembler
from pyiga_tpu_torch.hierarchical import HSpace
from pyiga_tpu_torch.ops import cuda_sumfac, cuda_vform, geom, sumfac

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64
TOL = 2e-6          # relative to the largest entry


@pytest.fixture(autouse=True)
def float64_after():
    """Every test leaves both packages at float64, whatever it raised."""
    yield
    pyiga_tpu.set_dtype(np.float64)
    pyiga_tpu_torch.set_dtype(np.float64)


def _f32():
    pyiga_tpu.set_dtype(np.float32)
    pyiga_tpu_torch.set_dtype(np.float32)


def _rel(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


# -- VForm assembly against the JAX package's float32 ---------------------------

FORMS = {
    'stiffness': ('inner(grad(u), grad(v)) * dx', {}),
    'mass': ('u * v * dx', {}),
    'convdiff': ('(inner(grad(u), grad(v)) + dot(b, grad(u)) * v + u * v)'
                 ' * dx', {'b': np.array([3.0, -2.0])}),
    'convdiff3d': ('(inner(grad(u), grad(v)) + dot(b, grad(u)) * v'
                   ' + x[0] * u * v) * dx', {'b': np.array([3.0, -2.0, 1.0])}),
}


def _vform_pair(name, p=3, n=6):
    form, args = FORMS[name]
    dim = 3 if name.endswith('3d') else 2
    n = 4 if dim == 3 else n
    kvs = dim * (bspline.make_knots(p, 0.0, 1.0, n),)
    jkvs = dim * (jbspline.make_knots(p, 0.0, 1.0, n),)
    geo, jgeo = (('twisted_box',) if dim == 3 else ('quarter_annulus',)) * 2
    asm = compile.compile_vform(vform.parse_vf(form, kvs, args=args))(
        kvs, geo=getattr(geometry, geo)(), device='cpu', **args)
    jasm = jcompile.compile_vform(jvform.parse_vf(form, jkvs, args=args))(
        jkvs, geo=getattr(jgeometry, jgeo)(), **args)
    return asm, jasm


@pytest.mark.parametrize('name', sorted(FORMS))
def test_vform_f32_matches_jax(name):
    """``run_device()`` float32 on the device, ``assemble()`` float64
    holding the float32 values, both within 2e-6 of the JAX package's
    float32 assembly; the float64 line of the same assembler untouched
    after the switch back."""
    asm, jasm = _vform_pair(name)
    _f32()
    data = asm.run_device()[(None, None)]
    jdata = jasm.assemble().data
    assert data.dtype == F32 and jdata.dtype == np.float64
    assert _rel(data.numpy(), jdata) <= TOL
    mlm = asm.assemble()
    assert mlm.data.dtype == np.float64
    assert np.array_equal(mlm.data, data.numpy().astype(np.float64))
    # every device operand of the fields and chains is float32
    ops = asm._device_operands()
    assert all(T.dtype == F32 for tabs in ops['term_tables'] for T in tabs)
    arrays = asm.device_arrays()
    assert all(t.dtype == F32 for k, t in arrays.items() if k != 'weights')
    assert all(w.dtype == F32 for w in arrays['weights'])
    pyiga_tpu.set_dtype(np.float64)
    pyiga_tpu_torch.set_dtype(np.float64)
    d64 = asm.run_device()[(None, None)]
    assert d64.dtype == F64
    assert _rel(d64.numpy(), jasm.assemble().data) <= 1e-13


def _boundary_pair():
    """``v * ds`` over the 'left' face of the extruded quarter annulus
    (3D p=2): the boundary Gauss grid, a one-point axis."""
    kvs = 3 * (bspline.make_knots(2, 0.0, 1.0, 3),)
    jkvs = 3 * (jbspline.make_knots(2, 0.0, 1.0, 3),)
    geo = geometry.tensor_product(geometry.line_segment(0.0, 1.0),
                                  geometry.quarter_annulus())
    jgeo = jgeometry.tensor_product(jgeometry.line_segment(0.0, 1.0),
                                    jgeometry.quarter_annulus())
    got = lambda: assemble.assemble('v * ds', kvs, geo=geo,  # noqa: E731
                                    boundary='left', device='cpu')
    ref = lambda: jassemble.assemble('v * ds', jkvs,  # noqa: E731
                                     geo=jgeo, boundary='left')
    return got, ref


def _surface_pair():
    """``v * ds`` on a surface (a 2D space in 3D space: the twisted box's
    'left' face)."""
    kvs = 2 * (bspline.make_knots(2, 0.0, 1.0, 5),)
    jkvs = 2 * (jbspline.make_knots(2, 0.0, 1.0, 5),)

    def run(vf_mod, comp, geo, k):
        vf = vf_mod.VForm(2, geo_dim=3, arity=1)
        vf.add(vf.basisfuns() * vf_mod.ds)
        return comp.compile_vform(vf)(k, geo=geo, **(
            {'device': 'cpu'} if comp is compile else {})).assemble_vector()
    return (lambda: run(vform, compile, geometry.twisted_box().boundary(
                'left'), kvs),
            lambda: run(jvform, jcompile, jgeometry.twisted_box().boundary(
                'left'), jkvs))


def _string_pair():
    """``assemble.assemble`` of a string form with a parameter, CSR."""
    kvs = 2 * (bspline.make_knots(3, 0.0, 1.0, 7),)
    jkvs = 2 * (jbspline.make_knots(3, 0.0, 1.0, 7),)
    form = '(inner(grad(u), grad(v)) + c * u * v) * dx'
    return (lambda: assemble.assemble(form, kvs,
                                      geo=geometry.quarter_annulus(), c=2.5,
                                      device='cpu'),
            lambda: jassemble.assemble(form, jkvs,
                                       geo=jgeometry.quarter_annulus(),
                                       c=2.5))


@pytest.mark.parametrize('case', ['boundary', 'surface', 'string'])
def test_forms_f32_match_jax(case):
    got, ref = {'boundary': _boundary_pair, 'surface': _surface_pair,
                'string': _string_pair}[case]()
    _f32()
    A, jA = got(), ref()
    if hasattr(A, 'toarray'):
        assert A.dtype == np.float64
        A, jA = A.toarray(), jA.toarray()
    A, jA = np.asarray(A), np.asarray(jA)
    assert A.dtype == np.float64
    assert _rel(A, jA) <= TOL
    pyiga_tpu_torch.set_dtype(np.float64)
    A64 = got()
    A64 = A64.toarray() if hasattr(A64, 'toarray') else np.asarray(A64)
    # float32 values, not float64 ones rounded at the end
    assert _rel(A, A64) > 0


def test_device_operands_follow_set_dtype():
    """``_device_operands`` keys its uploads by the compute dtype (as the
    JAX package's ``(mode, dtype)``): a switch uploads anew, a switch back
    reuses the first upload, and ``update`` refreshes every dtype's."""
    asm, _ = _vform_pair('convdiff')
    ops64 = asm._device_operands()
    d64 = asm.run_device()[(None, None)]
    pyiga_tpu_torch.set_dtype(np.float32)
    ops32 = asm._device_operands()
    assert ops32 is not ops64
    assert ops32['inputs']['params'].dtype == F32
    assert all(T.dtype == F32 for tabs in ops32['term_tables'] for T in tabs)
    assert ops32['geo_coeffs'].dtype == F32
    d32 = asm.run_device()[(None, None)]
    assert d32.dtype == F32
    pyiga_tpu_torch.set_dtype(np.float64)
    assert asm._device_operands() is ops64
    assert torch.equal(asm.run_device()[(None, None)], d64)
    asm.update(b=np.array([1.0, 1.0]))
    ref = asm.run_device()[(None, None)]
    pyiga_tpu_torch.set_dtype(np.float32)
    assert asm._device_operands()['inputs']['params'].dtype == F32
    assert torch.equal(asm._device_operands()['inputs']['params'],
                       torch.tensor([1.0, 1.0], dtype=F32))
    assert _rel(asm.run_device()[(None, None)].numpy(), ref.numpy()) <= TOL


# -- ACA ------------------------------------------------------------------

def test_compact_slice_dtype_switch():
    """The JAX package's ``test_compact_slice_dtype_switch``
    (``tests/test_lowrank.py``): the slice fields and tables are keyed by
    the dtype, so the float64 slice after a float32 one is float64
    accurate, the float32 one float32."""
    kvs = 2 * (bspline.make_knots(2, 0.0, 1.0, 5),)
    asm = compile.compile_vform(vform.stiffness_vf(2))(
        kvs, geo=geometry.quarter_annulus(), device='cpu')
    pyiga_tpu_torch.set_dtype(np.float32)
    row32 = asm.compact_slice({0: 1})
    pyiga_tpu_torch.set_dtype(np.float64)
    row64 = asm.compact_slice({0: 1})
    ref = compile.compile_vform(vform.stiffness_vf(2))(
        kvs, geo=geometry.quarter_annulus(),
        device='cpu').compact_slice({0: 1})
    assert row32.dtype == np.float32 and row64.dtype == np.float64
    assert abs(row64 - ref).max() <= 1e-12 * abs(ref).max()
    assert abs(row32 - ref).max() <= 1e-4 * abs(ref).max()
    assert abs(row32 - ref).max() > 0
    # the JAX package's float32 slice
    jkvs = 2 * (jbspline.make_knots(2, 0.0, 1.0, 5),)
    jasm = jcompile.compile_vform(jvform.stiffness_vf(2))(
        jkvs, geo=jgeometry.quarter_annulus())
    _f32()
    assert _rel(asm.compact_slice({0: 1}), jasm.compact_slice({0: 1})) \
        <= TOL


def test_aca_3d_device_f32():
    """``aca_3d_device`` under float32: float32 slices, float64 crosses
    (the JAX package's accumulators), the result within 1e-5 of the
    float64 compact tensor and 2e-6 of the JAX package's float32 one."""
    kvs = 3 * (bspline.make_knots(2, 0.0, 1.0, 6),)
    asm = compile.compile_vform(vform.stiffness_vf(3))(
        kvs, geo=geometry.twisted_box(), device='cpu')
    ref = asm.run_device()[(None, None)].numpy()
    jkvs = 3 * (jbspline.make_knots(2, 0.0, 1.0, 6),)
    jasm = jcompile.compile_vform(jvform.stiffness_vf(3))(
        jkvs, geo=jgeometry.twisted_box())
    _f32()
    fields, _tables = asm._slice_operands()
    assert all(F.dtype == F32 for F in fields)
    X = lowrank.aca_3d_device(asm, tol=1e-6, verbose=0)
    assert X.dtype == np.float64
    assert _rel(X, ref) <= 1e-5
    assert _rel(asm.run_device()[(None, None)].numpy(),
                jasm.assemble().data) <= TOL


# -- hierarchical per-level assembly -------------------------------------

def _hb(pkg_hs, pkg_bsp, pkg_geo, disc):
    hs = pkg_hs(2 * (pkg_bsp.make_knots(2, 0.0, 1.0, 6),), disparity=1,
                bdspecs=[(0, 0), (0, 1), (1, 0), (1, 1)])
    hs.refine_region(0, lambda *X: min(X) > 0.5)
    hs.refine_region(1, lambda *X: min(X) > 0.75)
    args = dict(device='cpu') if disc is HDiscretization else {}
    vfm = vform if disc is HDiscretization else jvform
    return disc(hs, vfm.stiffness_vf(dim=2),
                {'geo': pkg_geo.quarter_annulus(), 'f': lambda *x: 1.0},
                **args)


def test_hb_assembly_f32_matches_jax():
    """The HB per-level assembly (the ``bbox`` VForm assemblers) under
    float32: the matrix and right-hand side float64 holding float32
    values, within 2e-6 of the JAX package's float32 ones."""
    hd = _hb(HSpace, bspline, geometry, HDiscretization)
    jhd = _hb(JHSpace, jbspline, jgeometry, JHDiscretization)
    A64 = hd.assemble_matrix()
    _f32()
    A, f = hd.assemble_matrix(), hd.assemble_rhs()
    jA, jf = jhd.assemble_matrix(), jhd.assemble_rhs()
    assert A.dtype == np.float64 and f.dtype == np.float64
    assert _rel(A.toarray(), jA.toarray()) <= TOL
    assert _rel(f, jf) <= TOL
    assert 0 < _rel(A.toarray(), A64.toarray()) <= TOL


# -- the windowed route and K1' -------------------------------------------

ASSEMBLERS = {'stiffness': (StiffnessAssembler, JStiffnessAssembler),
              'mass': (MassAssembler, JMassAssembler)}


@pytest.mark.parametrize('kind', ['stiffness', 'mass'])
@pytest.mark.parametrize('name,p,n', [('twisted_box', 2, 5),
                                      ('quarter_annulus', 3, 9)])
def test_assemble_windowed_f32_matches_jax(kind, name, p, n):
    geo, jgeo = getattr(geometry, name)(), getattr(jgeometry, name)()
    cls, jcls = ASSEMBLERS[kind]
    asm = cls(geo.sdim * (bspline.make_knots(p, 0.0, 1.0, n),), geo,
              device='cpu')
    jasm = jcls(jgeo.sdim * (jbspline.make_knots(p, 0.0, 1.0, n),), jgeo)
    _f32()
    mlm = asm.assemble_windowed()
    jmlm = jasm.assemble_windowed()
    assert mlm.data.dtype == np.float64
    assert _rel(mlm.data, jmlm.data) <= TOL
    assert _rel(mlm.data, asm.assemble().data) <= TOL
    ops = asm._windowed_operands()
    assert all(P.dtype == F32 for tabs in ops['wtabs'] for P in tabs)
    Z = sumfac.run_windowed_assembly(
        asm.field_fn, asm.geo_inputs(), ops['wtabs'], ops['fss'],
        asm.tables.nqps, ops['plan'], ops['tperms'])
    assert Z.dtype == F32


def _stretched_square(pkg):
    """``(x, 2 y)`` as a host-evaluated geometry (area 2)."""
    def jac(x, y):
        x, y = np.broadcast_arrays(x, y)
        one, zero = np.ones_like(x), np.zeros_like(x)
        return np.stack([np.stack([one, zero], axis=-1),
                         np.stack([zero, 2 * one], axis=-1)], axis=-2)
    return pkg.UserFunction(lambda x, y: (x, 2 * y), [[0, 1], [0, 1]],
                            jac=jac)


def _polar(pkg):
    """The quarter annulus in polar parametrization, host-evaluated."""
    def f(x, y):
        r, t = 1 + x, np.pi / 2 * y
        return (r * np.cos(t), r * np.sin(t))

    def jac(x, y):
        x, y = np.broadcast_arrays(x, y)
        r, t = 1 + x, np.pi / 2 * y
        return np.stack([
            np.stack([np.cos(t), -np.pi / 2 * r * np.sin(t)], axis=-1),
            np.stack([np.sin(t), np.pi / 2 * r * np.cos(t)], axis=-1)],
            axis=-2)
    return pkg.UserFunction(f, [[0, 1], [0, 1]], jac=jac)


@pytest.mark.parametrize('geo_fn', [_stretched_square, _polar])
def test_user_geometry_stiffness_f32_matches_jax(geo_fn):
    """K1' (the stiffness fields of a host Jacobian) under float32: the
    float32 Jacobian uploaded once, the fields and chains float32, the
    matrix within 2e-6 of the JAX package's float32 one."""
    asm = StiffnessAssembler(2 * (bspline.make_knots(2, 0.0, 1.0, 6),),
                             geo_fn(geometry), device='cpu')
    jasm = JStiffnessAssembler(2 * (jbspline.make_knots(2, 0.0, 1.0, 6),),
                               geo_fn(jgeometry))
    ref64 = asm.run_device()
    _f32()
    assert asm.geo_inputs()['jac'].dtype == F32
    data = asm.run_device()
    assert data.dtype == F32
    assert _rel(data.numpy(), jasm.assemble().data) <= TOL
    assert 0 < _rel(data.numpy(), ref64.numpy()) <= TOL


# -- the float32 plain versions compute in float32 --------------------------

def _geo_partials(dtype):
    asm = StiffnessAssembler(2 * (bspline.make_knots(3, 0.0, 1.0, 7),),
                             geometry.quarter_annulus(), device='cpu')
    gi = asm.geo_inputs(dtype)
    tables = gi['geo_tables_nurbs']
    Y, _ = cuda_sumfac.geo_stage12(tables, gi['geo_coeffs'], 2)
    return Y, tables[1][:2].contiguous(), gi


def _differs_in_float32(f32, f64):
    assert f32.dtype == F32 and f64.dtype == F64
    assert _rel(f32.double().numpy(), f64.numpy()) <= TOL
    assert not torch.equal(f32, f64.float())


def test_plain_geo_jac_and_host_jac_compute_in_float32():
    """K1 ``jac`` (NURBS: the quotient rule in float32) and K1' from the
    float32 operands are not the float64 results rounded."""
    Y32, T32, gi32 = _geo_partials(F32)
    Y64, T64, gi64 = _geo_partials(F64)
    _differs_in_float32(cuda_sumfac.geo_jac_fields(Y32, T32, True),
                        cuda_sumfac.geo_jac_fields(Y64, T64, True))
    _, J32 = cuda_sumfac.geometry_fields(gi32['geo_tables_nurbs'],
                                         gi32['geo_coeffs'], True)
    _, J64 = cuda_sumfac.geometry_fields(gi64['geo_tables_nurbs'],
                                         gi64['geo_coeffs'], True)
    w32 = geom.gauss_weight_factors(gi32['weights'])
    w64 = geom.gauss_weight_factors(gi64['weights'])
    _differs_in_float32(
        cuda_sumfac.host_jac_fields(J32.reshape(2, 2, -1), *w32),
        cuda_sumfac.host_jac_fields(J64.reshape(2, 2, -1), *w64))


def test_plain_k5_computes_in_float32():
    """K5's plain version and the generated program run with torch ops on
    float32 operands stay float32 and are not the float64 fields
    rounded; the float32 program is a program of its own."""
    asm, _ = _vform_pair('convdiff')
    arrays64 = asm.device_arrays()
    pyiga_tpu_torch.set_dtype(np.float32)
    arrays32 = asm.device_arrays()
    f32 = torch.stack(cuda_vform.combo_fields_plain(asm, arrays32,
                                                    asm.combos))
    f64 = torch.stack(cuda_vform.combo_fields_plain(asm, arrays64,
                                                    asm.combos))
    _differs_in_float32(f32, f64)
    prog = asm._program(asm.combos, F32)
    assert prog is not asm._program(asm.combos, F64)
    assert prog.dtype == F32 and prog.counter == 'vform_fields_f32'
    run32 = cuda_vform.run_program_plain(prog, arrays32)
    assert run32.dtype == F32
    assert _rel(run32.numpy(), f32.reshape(len(asm.combos), -1).numpy()) \
        <= TOL
    # its adjoint is float32 too: a program (and a library) of its own
    adj = prog.adjoint()
    assert adj.program.dtype == F32 and adj.counter == 'vform_adjoint_f32'
    g = torch.as_tensor(np.random.RandomState(3).rand(*run32.shape),
                        dtype=F32).reshape((len(prog.outputs),) + tuple(
                            w.shape[0] for w in arrays32['weights']))
    grads, gp = cuda_vform.run_adjoint_plain(prog, arrays32, g)
    grads64, gp64 = cuda_vform.run_adjoint_plain(
        asm._program(asm.combos, F64), arrays64, g.double())
    assert all(v.dtype == F32 for v in grads.values())
    _differs_in_float32(gp, gp64)


def test_plain_windowed_fold_computes_in_float32():
    asm = StiffnessAssembler(3 * (bspline.make_knots(2, 0.0, 1.0, 5),),
                             geometry.twisted_box(), device='cpu')
    wt, fss = asm.tables.windowed_term_tables(asm.terms)
    nqp, Q = asm.tables.nqps[0], asm.tables.trial[0].shape[2]
    rng = np.random.RandomState(3)
    xs = [rng.rand(Q, 40) for _ in range(4)]
    idx = [0, 1, 0, 1]
    out = {}
    for dt in (F32, F64):
        out[dt] = cuda_sumfac.windowed_fold(
            [torch.as_tensor(X, dtype=dt) for X in xs],
            [torch.as_tensor(wt[k][-1], dtype=dt) for k in (0, 1)], idx,
            torch.as_tensor(fss[-1]), nqp)
    _differs_in_float32(out[F32], out[F64])


# -- the float32 wrappers' CUDA branch through stand-in libraries -------------

def _arr(ptr, dtype, *shape):
    ct = {np.float32: ctypes.c_float, np.float64: ctypes.c_double,
          np.int64: ctypes.c_int64}[dtype]
    buf = (ct * int(np.prod(shape))).from_address(ptr)
    return np.ctypeslib.as_array(buf).reshape(shape)


class _FakeLibrary:
    """The float32 C entries of K1 (all kinds, forward and backward), K1',
    K2, K3, their backward, K8 and K8f on host memory: each reads its
    operands from the pointers it is handed, writes the plain version's
    result and records the call."""

    def __init__(self):
        self.calls = []

    def _t(self, ptr, *shape):
        return torch.as_tensor(_arr(ptr, np.float32, *shape).copy())

    def pyiga_geo_jac_fields_f32(self, Y, T, out, d, G, nurbs, Q12, QL, nL,
                                 s):
        self.calls.append('geo_jac_fields_f32')
        C = G + nurbs
        res = cuda_sumfac.geo_jac_fields_plain(
            self._t(Y, d, C, Q12, nL), self._t(T, 2, QL, nL), bool(nurbs))
        _arr(out, np.float32, *res.shape)[...] = res.numpy()
        return 0

    def _fields(self, kind, Y, T, w12, wL, out, d, nurbs, Q12, QL, nL, s):
        self.calls.append(kind)
        C = d + nurbs
        args = (self._t(Y, d, C, Q12, nL), self._t(T, 2, QL, nL),
                self._t(w12, Q12), self._t(wL, QL), bool(nurbs))
        res = (cuda_sumfac.fields_plain if kind == 'fields_f32'
               else cuda_sumfac.fields_mass_plain)(*args)
        _arr(out, np.float32, *res.shape)[...] = res.numpy()
        return 0

    def pyiga_stiff_fields_f32(self, *a):
        return self._fields('fields_f32', *a)

    def pyiga_mass_fields_f32(self, *a):
        return self._fields('mass_fields_f32', *a)

    def pyiga_host_jac_fields_f32(self, jac, w12, wL, out, d, Q12, QL, s):
        self.calls.append('host_jac_fields_f32')
        res = cuda_sumfac.host_jac_fields_plain(
            self._t(jac, d, d, Q12 * QL), self._t(w12, Q12),
            self._t(wL, QL))
        _arr(out, np.float32, *res.shape)[...] = res.numpy()
        return 0

    def pyiga_fields_bwd_f32(self, kind, Y, T, w12, wL, gout, gY, d, G,
                             nurbs, Q12, QL, nL, s):
        name = ('stiffness', 'mass', 'jac')[kind]
        self.calls.append(cuda_sumfac._FIELD_KINDS[name][2] + '_f32')
        C = G + nurbs
        shape = {'stiffness': (d * (d + 1) // 2, Q12, QL),
                 'mass': (Q12, QL), 'jac': (G + G * d, Q12, QL)}[name]
        ws = ((None, None) if name == 'jac'
              else (self._t(w12, Q12), self._t(wL, QL)))
        res = cuda_sumfac._fields_vjp_plain(
            name, self._t(Y, d, C, Q12, nL), self._t(T, 2, QL, nL), *ws,
            bool(nurbs), self._t(gout, *shape))
        _arr(gY, np.float32, *res.shape)[...] = res.numpy()
        return 0

    def pyiga_stage_bwd_f32_tiles(self, out, n_max):
        buf = ctypes.cast(out, ctypes.POINTER(ctypes.c_int))
        for i, v in enumerate((192, 128, 1, 128, 128, 1, 64, 128, 2)):
            buf[i] = v
        return 3

    def pyiga_stage_bwd_f32(self, tp, n, g, out, K, R, M, tile, S, bounds,
                            scratch, s):
        """The kernel's two passes: each chunk's partial (into the scratch
        where the plan splits M), then the chunks summed in order."""
        self.calls.append('stage_bwd_f32')
        ts = ctypes.cast(tp, ctypes.POINTER(ctypes.c_uint64))
        b = ctypes.cast(bounds, ctypes.POINTER(ctypes.c_int))[:S + 1]
        assert b[0] == 0 and b[S] == M and (S == 1 or scratch)
        o = _arr(out, np.float32, n, K, R)
        parts = _arr(scratch, np.float32, S, n, K, R) if S > 1 else o[None]
        gr = _arr(g, np.float32, R, M)
        for c in range(S):
            for i in range(n):
                parts[c, i] = (_arr(ts[i], np.float32, M, K)[b[c]:b[c + 1]].T
                               @ gr[:, b[c]:b[c + 1]].T)
        if S > 1:
            o[...] = parts[0]
            for c in range(1, S):
                o += parts[c]
        return 0

    def pyiga_stage_f32(self, X, T, out, K, R, M, s):
        self.calls.append('stage_f32')
        _arr(out, np.float32, R, M)[...] = (_arr(X, np.float32, K, R).T
                                            @ _arr(T, np.float32, M, K).T)
        return 0

    def pyiga_fold_f32(self, xp, tp, n, out, K, R, M, s):
        self.calls.append('fold_f32')
        xs = ctypes.cast(xp, ctypes.POINTER(ctypes.c_uint64))
        ts = ctypes.cast(tp, ctypes.POINTER(ctypes.c_uint64))
        o = _arr(out, np.float32, R, M)
        o[...] = 0
        for t in range(n):
            o += _arr(xs[t], np.float32, K, R).T @ _arr(ts[t], np.float32,
                                                        M, K).T
        return 0

    def _windowed(self, name, xs, ps, fs, Y, Q, R, n, b, wsz, nqp):
        self.calls.append(name)
        fst = torch.as_tensor(_arr(fs, np.int64, n).copy())
        tabs = list(dict.fromkeys(ps))
        res = cuda_sumfac.windowed_fold_plain(
            [self._t(x, Q, R) for x in xs],
            [self._t(p, n, b, wsz) for p in tabs],
            [tabs.index(p) for p in ps], fst, nqp)
        _arr(Y, np.float32, R, b * n)[...] = res.numpy()
        return 0

    def pyiga_windowed_stage_f32(self, X, P, fs, Y, Q, R, n, b, wsz, nqp, s):
        return self._windowed('windowed_stage_f32', [X], [P], fs, Y, Q, R, n,
                              b, wsz, nqp)

    def pyiga_windowed_fold_f32(self, xp, tp, k, fs, Y, Q, R, n, b, wsz,
                                nqp, s):
        xs = ctypes.cast(xp, ctypes.POINTER(ctypes.c_uint64))
        ts = ctypes.cast(tp, ctypes.POINTER(ctypes.c_uint64))
        return self._windowed('windowed_fold_f32', [xs[t] for t in range(k)],
                              [ts[t] for t in range(k)], fs, Y, Q, R, n, b,
                              wsz, nqp)

    def vform_fields(self, prog, arrays):
        """A stand-in for a generated K5 library's entry: the program run
        with torch ops on the arrays the wrapper hands over."""
        def entry(*args):
            self.calls.append(prog.counter)
            ops = prog.operands(arrays, torch.device('cpu'))
            assert list(args[:len(ops)]) == [t.data_ptr() for t in ops]
            res = cuda_vform.run_program_plain(prog, arrays)
            dt = np.float32 if prog.dtype == F32 else np.float64
            _arr(args[len(ops)], dt, *res.shape)[...] = res.numpy()
            return 0
        return entry


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors: the device test forced,
    the library replaced by :class:`_FakeLibrary`, every operand check
    recorded with the dtype it asks for."""
    lib = _FakeLibrary()
    lib.required = []
    monkeypatch.setattr(cuda_sumfac, '_kernel_device', lambda t, n: True)
    monkeypatch.setattr(_cuda, 'library', lambda: lib)
    monkeypatch.setattr(_cuda, 'require',
                        lambda t, name, dt, nd: lib.required.append(
                            (name, dt, t.dtype)))
    monkeypatch.setattr(_cuda, 'device_of',
                        lambda t: contextlib.nullcontext())
    monkeypatch.setattr(_cuda, 'stream_of', lambda t: 0)
    monkeypatch.setattr(_cuda, 'sm_count', lambda t: 132)
    _cuda.reset_launches()
    return lib


F64_KERNELS = ('fields', 'mass_fields', 'geo_jac_fields', 'host_jac_fields',
               'stage', 'fold', 'windowed_stage', 'windowed_fold',
               'vform_fields', 'fields_bwd', 'mass_fields_bwd',
               'geo_jac_fields_bwd', 'stage_bwd', 'fold_bwd',
               'vform_adjoint')


def _only_f32(lib):
    """Every operand check asked float32 and got it (the window starts
    are int64), and no float64 kernel launched."""
    assert all(dt == got == (torch.int64 if n == 'fs' else F32)
               for n, dt, got in lib.required)
    assert all(_cuda.LAUNCHES[k] == 0 for k in F64_KERNELS)


def test_f32_jac_and_host_jac_wrappers_launch_f32_entries(fake_card):
    Y, T, gi = _geo_partials(F32)
    got = cuda_sumfac.geo_jac_fields(Y, T, True)
    assert got.dtype == F32
    assert torch.equal(got, cuda_sumfac.geo_jac_fields_plain(Y, T, True))
    _, J = cuda_sumfac.geometry_fields(gi['geo_tables_nurbs'],
                                       gi['geo_coeffs'], True)
    w = geom.gauss_weight_factors(gi['weights'])
    got = cuda_sumfac.host_jac_fields(J.reshape(2, 2, -1), *w)
    assert got.dtype == F32
    assert torch.equal(got, cuda_sumfac.host_jac_fields_plain(
        J.reshape(2, 2, -1), *w))
    assert _cuda.LAUNCHES['geo_jac_fields_f32'] == 2
    assert _cuda.LAUNCHES['host_jac_fields_f32'] == 1
    _only_f32(fake_card)
    # K1's backward on a float32 gradient: its float32 entry, counted
    # under geo_jac_fields_bwd_f32
    shape = cuda_sumfac.geo_jac_fields_plain(Y, T, True).shape
    g = torch.as_tensor(np.random.RandomState(4).rand(*shape) - 0.5,
                        dtype=F32)
    gY = cuda_sumfac.fields_bwd('jac', Y, T, None, None, True, g)
    assert gY.dtype == F32 and fake_card.calls[-1] == 'geo_jac_fields_bwd_f32'
    assert torch.equal(gY, cuda_sumfac.geo_jac_fields_bwd_plain(Y, T, True,
                                                                g))
    assert _cuda.LAUNCHES['geo_jac_fields_bwd_f32'] == 1
    _only_f32(fake_card)


def test_f32_user_geometry_path_launches_f32_entries(fake_card):
    """The stiffness of a host-evaluated geometry under float32: K1' f32,
    K2 f32, K3 f32 and nothing else."""
    asm = StiffnessAssembler(2 * (bspline.make_knots(2, 0.0, 1.0, 6),),
                             _polar(geometry), device='cpu')
    with pytest.MonkeyPatch.context() as m:
        m.setattr(cuda_sumfac, '_kernel_device', lambda t, n: False)
        ref = asm.run_device()
    pyiga_tpu_torch.set_dtype(np.float32)
    data = asm.run_device()
    assert data.dtype == F32 and _rel(data.numpy(), ref.numpy()) <= TOL
    assert set(fake_card.calls) == {'host_jac_fields_f32', 'stage_f32',
                                    'fold_f32'}
    assert _cuda.LAUNCHES['host_jac_fields_f32'] == 1
    _only_f32(fake_card)


@pytest.mark.parametrize('kind', ['stiffness', 'mass'])
def test_f32_windowed_route_launches_f32_entries(fake_card, kind):
    """``assemble_windowed()`` under float32 on the card's branch: K2 f32
    (geometry stages), K1 f32, K8 f32 stages and one K8f f32, no K3 and
    no float64 kernel; the result equals the plain route's."""
    cls = StiffnessAssembler if kind == 'stiffness' else MassAssembler
    asm = cls(3 * (bspline.make_knots(2, 0.0, 1.0, 5),),
              geometry.twisted_box(), device='cpu')
    pyiga_tpu_torch.set_dtype(np.float32)
    mlm = asm.assemble_windowed()
    assert _cuda.LAUNCHES['windowed_fold_f32'] == 1
    assert _cuda.LAUNCHES['windowed_stage_f32'] == 2 * (
        6 if kind == 'stiffness' else 1)
    assert _cuda.LAUNCHES['fold_f32'] == 0
    assert {'stage_f32', 'windowed_stage_f32',
            'windowed_fold_f32'} <= set(fake_card.calls)
    _only_f32(fake_card)
    calls = list(fake_card.calls)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(cuda_sumfac, '_kernel_device', lambda t, n: False)
        ref = asm.assemble_windowed()
    assert fake_card.calls == calls
    assert mlm.data.dtype == np.float64
    assert _rel(mlm.data, ref.data) <= TOL


def test_f32_vform_launches_f32_program(fake_card, monkeypatch):
    """K5 under float32 on its CUDA branch (``_ComboFields``, as
    ``combo_fields`` calls it on the card): the program's float32
    library, its operands float32, its launches counted under
    ``vform_fields_f32``; the float64 program is another library."""
    asm, _ = _vform_pair('convdiff')
    pyiga_tpu_torch.set_dtype(np.float32)
    arrays = asm.device_arrays()
    prog = asm._program(asm.combos, F32)
    built = []

    def build(name, src):
        built.append((name, src))
        return type('Lib', (), {'pyiga_vform_fields': staticmethod(
            fake_card.vform_fields(prog, arrays))})()
    monkeypatch.setattr(_cuda, 'build_generated', build)
    W = arrays['weights']
    tensors = list(W) + [arrays[k] for k in prog.sources] + [
        arrays['params']]
    out = cuda_vform._ComboFields.apply(prog, len(W), *tensors)
    assert out.dtype == F32
    assert built[0][0] == 'vform_fields_f32' and 'double' not in built[0][1]
    assert _cuda.LAUNCHES['vform_fields_f32'] == 1
    assert _cuda.LAUNCHES['vform_fields'] == 0
    ref = torch.stack(cuda_vform.combo_fields_plain(asm, arrays,
                                                    asm.combos))
    assert _rel(out.numpy(), ref.numpy()) <= TOL
    # a float64 operand does not fit the float32 program
    with pytest.raises(ValueError, match='float32'):
        prog.operands(dict(arrays, params=arrays['params'].double()),
                      torch.device('cpu'))


@pytest.mark.parametrize('kind', ['stiffness', 'mass'])
def test_f32_gradient_launches_f32_backwards(fake_card, kind):
    """The shape gradient of a 3D assembly under float32 on the card's
    branch: the forward on K2 f32 (geometry stages), K1 f32 and K3 f32,
    the backward on K1-bwd f32, K2-bwd f32 and one K3-bwd f32 launch;
    no float64 kernel; the gradient that of the plain path."""
    from pyiga_tpu_torch.diff import assembly_coeff_fn
    cls = StiffnessAssembler if kind == 'stiffness' else MassAssembler
    asm = cls(3 * (bspline.make_knots(2, 0.0, 1.0, 3),),
              geometry.twisted_box(), device='cpu')
    pyiga_tpu_torch.set_dtype(np.float32)
    fn, c0 = assembly_coeff_fn(asm)

    def grad():
        x = torch.tensor(c0, requires_grad=True)
        out = fn(x)
        w = torch.as_tensor(np.random.RandomState(5).rand(*out.shape),
                            dtype=F32)
        (w * out).sum().backward()
        return out.detach(), x.grad
    val, g = grad()
    bwd = {'stiffness': 'fields_bwd_f32', 'mass': 'mass_fields_bwd_f32'}
    assert val.dtype == F32 and g.dtype == F64
    assert _cuda.LAUNCHES[bwd[kind]] == 1
    # one backward launch a forward launch of the chains (the geometry
    # stages included)
    assert _cuda.LAUNCHES['stage_bwd_f32'] == _cuda.LAUNCHES['stage_f32'] > 0
    assert _cuda.LAUNCHES['fold_bwd_f32'] == _cuda.LAUNCHES['fold_f32'] > 0
    assert {bwd[kind], 'stage_bwd_f32', 'stage_f32',
            'fold_f32'} <= set(fake_card.calls)
    _only_f32(fake_card)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(cuda_sumfac, '_kernel_device', lambda t, n: False)
        val_ref, g_ref = grad()
    assert _rel(val.numpy(), val_ref.numpy()) <= TOL
    assert _rel(g.numpy(), g_ref.numpy()) <= TOL


def test_f32_adjoint_launches_f32_library(fake_card, monkeypatch):
    """K5's backward under float32 on its CUDA branch: the float32 adjoint
    program's library (``vform_adjoint_f32``, a source with no
    ``double``), its launch counted there, the gradients of every source
    and of the parameters those of the plain adjoint, in float32."""
    asm, _ = _vform_pair('convdiff')
    pyiga_tpu_torch.set_dtype(np.float32)
    arrays = asm.device_arrays()
    prog = asm._program(asm.combos, F32)
    adj = prog.adjoint()
    grid = tuple(w.shape[0] for w in arrays['weights'])
    made, built = {}, []
    outputs = cuda_vform.AdjointProgram.outputs

    def record_outputs(self, arrs):
        made['outs'] = outputs(self, arrs)
        return made['outs']
    monkeypatch.setattr(cuda_vform.AdjointProgram, 'outputs',
                        record_outputs)
    W = arrays['weights']
    leaves = [arrays[k].clone().requires_grad_(True) for k in prog.sources]
    params = arrays['params'].clone().requires_grad_(True)
    operands = dict(arrays, params=params.detach(), **{
        k: t.detach() for k, t in zip(prog.sources, leaves)})

    def shape(Q12, QL, out):
        out[0], out[1], out[2], out[3] = 0, 32, 16, -(-Q12 // 16)
        return 0

    def adjoint(*args):
        fake_card.calls.append('vform_adjoint_f32')
        k = prog.dim + adj.program.sources.index('gout')
        g = torch.as_tensor(_arr(args[k], np.float32, len(prog.outputs),
                                 *grid).copy())
        grads, gp = cuda_vform.run_adjoint_plain(prog, arrays, g)
        for key, t in made['outs'][0].items():
            t.copy_(grads[key])
        made['outs'][1].copy_(gp)
        return 0

    def build(name, src):
        built.append((name, src))
        if name == 'vform_adjoint_f32':
            return type('Lib', (), {
                'pyiga_vform_adjoint': staticmethod(adjoint),
                'pyiga_vform_shape': staticmethod(shape)})()
        return type('Lib', (), {'pyiga_vform_fields': staticmethod(
            fake_card.vform_fields(prog, operands))})()
    monkeypatch.setattr(_cuda, 'build_generated', build)
    out = cuda_vform._ComboFields.apply(prog, len(W), *W, *leaves, params)
    g = torch.as_tensor(np.random.RandomState(6).rand(*out.shape),
                        dtype=F32)
    out.backward(g)
    assert [b[0] for b in built] == ['vform_fields_f32', 'vform_adjoint_f32']
    assert 'double' not in built[1][1]
    assert _cuda.LAUNCHES['vform_adjoint_f32'] == 1
    assert _cuda.LAUNCHES['vform_adjoint'] == 0
    ref, gp = cuda_vform.run_adjoint_plain(prog, arrays, g)
    for key, t in zip(prog.sources, leaves):
        assert t.grad.dtype == F32 and torch.equal(t.grad, ref[key])
    assert params.grad.dtype == F32 and torch.equal(params.grad, gp)
    _only_f32(fake_card)


# -- the windowed plan and schedule for 4-byte elements ------------------------

@pytest.fixture(scope='module')
def make_plan(tmp_path_factory):
    """``make_plan`` of ``csrc/windowed.cu`` (its constants, ``Plan`` and
    the function, host code) compiled by the host compiler: ``plan(Q, R,
    n, b, wsz, nqp, groups, nsm, esize)`` -> the dict of
    ``cuda_sumfac.windowed_plan``."""
    src = (_cuda.SRC_DIR / 'windowed.cu').read_text()

    def cut(start, end):
        i = src.index(start)
        return src[i:src.index(end, i)]
    macros = cut('#ifndef PYIGA_WIN_CUT', 'namespace {')
    consts = cut('constexpr int kMaxTerms', '// the fields grouped')
    plan_t = cut('// The launch\'s tiling', '__device__')
    fn = cut('inline long long r128', 'int sm_count()')
    d = tmp_path_factory.mktemp('windowed_plan')
    (d / 'plan.cc').write_text(
        '#include <algorithm>\n#include <cstddef>\n' + macros
        + 'namespace win {\n' + consts + plan_t + fn + '}\n'
        'extern "C" int plan(long long Q, long long R, int n, int b, '
        'int wsz, int nqp, int groups, int nsm, int esize, long long* o) {\n'
        '    const win::Plan p = win::make_plan(Q, R, n, b, wsz, nqp, groups,'
        ' nsm, esize);\n'
        '    const long long v[12] = {p.rpt, p.run, p.nruns, p.cap, p.box,'
        ' p.ps, p.xs, p.stages, p.nys, p.rtiles, p.cpr, p.smem};\n'
        '    for (int k = 0; k < 12; ++k) o[k] = v[k];\n    return 0;\n}\n')
    subprocess.run(['g++', '-std=c++17', '-O1', '-shared', '-fPIC', '-o',
                    str(d / 'libplan.so'), str(d / 'plan.cc')], check=True)
    lib = ctypes.CDLL(str(d / 'libplan.so'))
    lib.plan.argtypes = [ctypes.c_longlong] * 2 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    keys = ('rpt', 'run', 'nruns', 'cap', 'box', 'ps', 'xs', 'stages', 'nys',
            'rtiles', 'cpr', 'smem')

    def plan(*args):
        out = (ctypes.c_longlong * 12)()
        lib.plan(*args, ctypes.cast(out, ctypes.c_void_p))
        return dict(zip(keys, list(out)))
    return plan


def _table_set(p, nel, ntab):
    """Windowed pair tables of a 1D space (degree p, nel elements)."""
    from pyiga_tpu_torch.mlmatrix import MLStructure
    kv = bspline.make_knots(p, 0.0, 1.0, nel)
    grid, _w = sumfac.quadrature_for((kv,))
    st = sumfac.SpaceTables((kv,), (kv,), grid,
                            MLStructure.from_kvs((kv,), (kv,)).bidx, 1)
    out = [st.windowed_pair_table(0, du, dv)
           for du, dv in ((0, 0), (0, 1), (1, 0), (1, 1))][:ntab]
    return [P for P, _fs in out], out[0][1], st.nqps[0]


# (p, elements, R, groups, nsm): the 3D n=48 stage and fold, the 2D n=128
# ones, ragged dof counts and R, p = 1 .. 4, one SM and a full card
PLAN_CASES = [(3, 48, 36864, 1, 132), (3, 48, 127449, 3, 132),
              (3, 128, 512, 1, 132), (3, 128, 917, 3, 132),
              (2, 13, 1001, 2, 132), (1, 40, 33, 1, 132),
              (4, 60, 2000, 1, 132), (4, 60, 100, 2, 132),
              (3, 61, 7210, 4, 132), (3, 20, 7211, 3, 1),
              (4, 10, 100, 2, 7), (3, 50, 77, 4, 132)]


@pytest.mark.parametrize('esize', [8, 4])
@pytest.mark.parametrize('p,nel,R,groups,nsm', PLAN_CASES)
def test_windowed_plan_matches_make_plan(make_plan, esize, p, nel, R,
                                         groups, nsm):
    """``windowed_plan(..., esize)`` is ``make_plan``'s plan for 8- and
    4-byte elements; the float32 plan keeps the shared memory within the
    block's and its strides in whole 16-byte vectors: the stage row rt +
    4 floats, the table's dof stride a multiple of 4 plus 4."""
    _tabs, fs, nqp = _table_set(p, nel, 1)
    n, b, wsz, Q = len(fs), 2 * p + 1, (p + 1) * nqp, nel * nqp
    pl = cuda_sumfac.windowed_plan(Q, R, n, b, wsz, nqp, groups, nsm,
                                   esize=esize)
    assert pl == make_plan(Q, R, n, b, wsz, nqp, groups, nsm, esize)
    V = 16 // esize
    assert 0 < pl['smem'] <= cuda_sumfac.WINDOWED_SMEM
    assert pl['xs'] == 8 * pl['rpt'] + V and pl['ps'] % (2 * V) == V
    assert pl['ps'] >= b * wsz and 2 <= pl['stages'] <= 4


def _emulate_windowed_f32(xs, tabs, idx, fs, nqp, nsm, aligned=True):
    """The float32 kernel's schedule in numpy, index for index: the plan
    for 4-byte elements, each X row copied into its stage from its
    16-byte aligned start (shifted by its first element's index mod 4),
    a group's fields summed into the newest stage in term order, the
    products read at the consumers' shift ``(par + w (R mod 4)) mod 4``;
    each output entry written once.  Unwritten slots hold NaN."""
    Q, R = xs[0].shape
    n, b, wsz = tabs[0].shape
    order = list(dict.fromkeys(idx))
    groups = [[t for t in range(len(xs)) if idx[t] == g] for g in order]
    pl = cuda_sumfac.windowed_plan(Q, R, n, b, wsz, nqp, len(order), nsm,
                                   esize=4)
    rt, S, xsr = 8 * pl['rpt'], pl['stages'], pl['xs']
    flat = [np.ascontiguousarray(X, dtype=np.float32).ravel() for X in xs]
    Y = np.full((R, b * n), np.nan, dtype=np.float32)
    written = np.zeros(Y.shape, dtype=int)
    vm = 3 if aligned else 0
    for c in range(pl['nruns'] * pl['cpr']):
        i0, k0 = c // pl['cpr'] * pl['run'], c % pl['cpr']
        nd = min(pl['run'], n - i0)
        qa = fs[i0] * nqp
        rows = fs[i0 + nd - 1] * nqp + wsz - qa
        ring = np.full((S, pl['cap'] * xsr), np.nan, dtype=np.float32)
        it = 0
        for t in range(k0, pl['rtiles'], pl['cpr']):
            r0 = t * rt
            nr = min(rt, R - r0)

            def copy(u, s):
                ring[s] = np.nan
                for q in range(rows):
                    e = (qa + q) * R + r0
                    sh = e & vm
                    # the 16-byte copies of the row stay inside the stage
                    assert (nr + sh + 3) // 4 * 4 <= xsr
                    ring[s, q * xsr + sh:q * xsr + sh + nr] = \
                        flat[u][e:e + nr]
            acc = np.zeros((nd, b, rt), dtype=np.float32)
            for g, terms in zip(order, groups):
                sa = it % S
                copy(terms[0], sa)
                it += 1
                for u in terms[1:]:
                    s2 = it % S
                    copy(u, s2)
                    it += 1
                    ring[s2] = ring[sa] + ring[s2]
                    sa = s2
                for il in range(nd):
                    i = i0 + il
                    qrel = fs[i] * nqp - qa
                    par = ((qa + qrel) * R + r0) & vm
                    rodd = R & vm
                    win = np.stack([ring[sa, (qrel + w) * xsr
                                         + ((par + w * rodd) & vm):][:rt]
                                    for w in range(wsz)])
                    acc[il] += tabs[g][i].astype(np.float32) @ win
            for il in range(nd):
                cols = np.arange(b) * n + i0 + il
                Y[r0:r0 + nr, cols] = acc[il, :, :nr].T
                written[r0:r0 + nr, cols] += 1
    assert (written == 1).all()
    return Y


# (p, elements, R, terms, tables, nsm, X aligned): R mod 4 = 0, 1, 2, 3
# (the consumers' shift walks all four slots), a group of several terms,
# one SM and several, X not aligned
EMULATED_F32 = [(3, 20, 248, 1, 1, 4, True), (3, 20, 249, 1, 1, 4, True),
                (3, 20, 250, 5, 3, 3, True), (2, 13, 103, 3, 2, 2, True),
                (1, 70, 40, 2, 1, 132, True), (4, 9, 77, 4, 2, 5, True),
                (3, 20, 251, 4, 2, 4, False)]


@pytest.mark.parametrize('p,nel,R,nterms,ntab,nsm,aligned', EMULATED_F32)
def test_windowed_f32_schedule_emulated(p, nel, R, nterms, ntab, nsm,
                                        aligned):
    """The float32 kernel's schedule (the plan for 4-byte elements, rows
    shifted by their first element's index mod 4, the consumers' shift)
    emulated on the host equals the float32 plain fold within 2e-6 and
    writes every entry of Y once."""
    tabs, fs, nqp = _table_set(p, nel, ntab)
    rng = np.random.RandomState(p * 1000 + R)
    xs = [rng.rand(nel * nqp, R).astype(np.float32) for _ in range(nterms)]
    idx = [(3 * t) % ntab for t in range(nterms)]
    got = _emulate_windowed_f32(xs, tabs, idx, fs, nqp, nsm, aligned)
    ref = cuda_sumfac.windowed_fold_plain(
        [torch.as_tensor(X) for X in xs],
        [torch.as_tensor(T, dtype=F32) for T in tabs], idx,
        torch.as_tensor(fs), nqp)
    assert ref.dtype == F32
    assert _rel(got, ref.numpy()) <= TOL


# -- the generated float32 K5 source -----------------------------------------

# enough of CUDA for the host compiler to parse a generated source
_CUDA_STUB = r'''
#include <algorithm>
#include <cmath>
using std::min;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(n)
#define __shared__ static
#define __restrict__
struct pyiga_dim3 { unsigned x, y, z; };
static pyiga_dim3 threadIdx, blockIdx, blockDim, gridDim;
static inline void __syncthreads() {}
template <class T> static inline T __ldg(const T* p) { return *p; }
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
static inline cudaError_t cudaGetLastError() { return cudaSuccess; }
'''


# what the adjoint's source adds: shuffles and the slot table
_ADJ_STUB = r'''
#define __constant__ static
template <class T> static inline T __shfl_xor_sync(unsigned, T v, int) {
    return v;
}
'''


@pytest.mark.parametrize('case', ['convdiff', 'convdiff3d', 'sqrt_exp',
                                  'boundary'])
def test_k5_f32_source_is_float(tmp_path, case):
    """The float32 program's source: no ``double`` anywhere, every
    constant ``f``-suffixed, the float functions; compiled by the host
    compiler with float-to-double promotion and double-to-float
    conversion as errors (any double arithmetic in the body fails)."""
    asm = _f32_case_asm(case)
    prog = asm._program(asm.combos, F32)
    src = prog.source
    prog64 = asm._program(asm.combos, F64)
    assert 'double' not in src and 'double' in prog64.source
    # constants: every literal with a decimal point carries its suffix
    body = src[src.index('vform_fields_kernel('):]
    lits = re.findall(r'\(-?[0-9][0-9.e+-]*f?\)', body)
    assert all(x.endswith('f)') for x in lits), lits
    for fn in ('sqrt', 'exp', 'fabs'):
        assert '%s(' % fn not in body
    if case == 'sqrt_exp':
        assert all('%sf(' % fn in body for fn in ('sqrt', 'exp', 'fabs'))
    res = _host_compile_float(tmp_path, src)
    assert res.returncode == 0, res.stderr[-3000:]


def _f32_case_asm(case):
    if case == 'sqrt_exp':
        kvs = 2 * (bspline.make_knots(2, 0.0, 1.0, 4),)
        return assemble.instantiate_assembler(
            '(sqrt(c[0]**2 + c[1]**2) * inner(grad(u), grad(v)) '
            '+ exp(c[1]) * abs(c[0]) * u * v / 3.0) * dx', kvs,
            {'geo': geometry.quarter_annulus(), 'c': np.array([0.5, 1.5])},
            None, device='cpu')
    if case == 'boundary':
        return assemble.instantiate_assembler(
            'inner(grad(u), grad(v)) * ds', 3 * (bspline.make_knots(
                2, 0.0, 1.0, 3),), {'geo': geometry.twisted_box()}, None,
            boundary='left', device='cpu')
    return _vform_pair(case)[0]


def _host_compile_float(tmp_path, src, stub=''):
    """`src` through the host compiler with float-to-double promotion and
    double-to-float conversion as errors; returns its result."""
    code = _CUDA_STUB + stub + re.sub(r'#include <cuda_runtime.h>', '', src)
    code = re.sub(r'(\w+)<<<[^>]*>>>\(', r'\1(', code)
    path = tmp_path / 'k5.cc'
    path.write_text(code)
    return subprocess.run(['g++', '-std=c++17', '-fsyntax-only',
                           '-Werror=double-promotion',
                           '-Werror=float-conversion', str(path)],
                          capture_output=True, text=True)


@pytest.mark.parametrize('case', ['convdiff', 'convdiff3d', 'sqrt_exp',
                                  'boundary'])
def test_k5_adjoint_f32_source_is_float(tmp_path, case):
    """The float32 program's adjoint source (the SSA of the form and its
    reverse sweep, the zero rows, the parameter sums and their second
    kernel): no ``double`` anywhere, every constant ``f``-suffixed, and
    through the host compiler with promotion and conversion as errors."""
    asm = _f32_case_asm(case)
    adj = asm._program(asm.combos, F32).adjoint()
    src = adj.source
    assert 'double' not in src
    assert 'double' in asm._program(asm.combos, F64).adjoint().source
    # every literal with a decimal point carries its suffix
    body = src[src.index('vform_adjoint_kernel('):]
    lits = re.findall(r'(?<![\w.])[0-9]+\.[0-9]*(?:e[+-]?[0-9]+)?f?', body)
    assert lits and all(x.endswith('f') for x in lits), lits
    res = _host_compile_float(tmp_path, src, _ADJ_STUB)
    assert res.returncode == 0, res.stderr[-3000:]
