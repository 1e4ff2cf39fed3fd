"""The PyTorch port's form language and coefficient fields held against
the JAX package: the parser (hashes, field keys), the probe-based combo
pruning and symmetric folding, K1's ``jac`` kind (plain version, through
the port's K2 stage chain) against ``pyiga_tpu.ops.geom``, and kernel
K5's plain version and generated program against
``VFormAssembler._eval_combo_fields`` (all float64 on the CPU)."""

import _ctypes
import functools
import sys

import numpy as np
import pytest
import torch

import pyiga_tpu.bspline as jbspline
import pyiga_tpu.geometry as jgeometry
from pyiga_tpu import compile as jcompile
from pyiga_tpu import vform as jvform
from pyiga_tpu.assemblers import StiffnessAssembler as JStiffnessAssembler
from pyiga_tpu.ops import geom as jgeom

from pyiga_tpu_torch import _cuda, bspline, compile, convert, geometry, vform
from pyiga_tpu_torch.ops import cuda_sumfac, cuda_vform

torch.set_num_threads(1)


def _f(x, y):
    return np.sin(x) * y + 1.0


# stiffness, mass, the bench's convection-diffusion + reaction form, a
# physical input function, a vector parameter under sqrt/exp
FORMS = {
    'stiffness': ('inner(grad(u), grad(v)) * dx', {}),
    'mass': ('u * v * dx', {}),
    'convdiff': ('(inner(grad(u), grad(v)) + dot(b, grad(u)) * v + u * v)'
                 ' * dx', {'b': np.array([3.0, -2.0])}),
    'rhs_f': ('f * v * dx', {'f': _f}),
    'sqrt_exp': ('(sqrt(c[0]**2 + c[1]**2) * inner(grad(u), grad(v)) '
                 '+ exp(c[1]) * u * v) * dx', {'c': np.array([0.5, 1.5])}),
}


def _kvs(pkg, p=2, n=5, dim=2):
    return dim * (pkg.make_knots(p, 0.0, 1.0, n),)


@functools.lru_cache(maxsize=None)
def _pair(name, geo='quarter_annulus'):
    """The same form compiled and instantiated in both packages."""
    form, args = FORMS[name]
    vf = vform.parse_vf(form, _kvs(bspline), args=args)
    jvf = jvform.parse_vf(form, _kvs(jbspline), args=args)
    asm = compile.compile_vform(vf)(_kvs(bspline),
                                    geo=getattr(geometry, geo)(), **args)
    jasm = jcompile.compile_vform(jvf)(_kvs(jbspline),
                                       geo=getattr(jgeometry, geo)(), **args)
    return vf, jvf, asm, jasm


@pytest.mark.parametrize('name', list(FORMS))
def test_parse_vf_matches_jax(name):
    vf, jvf, _, _ = _pair(name)
    assert vf.hash() == jvf.hash()
    assert vf.used_field_keys() == jvf.used_field_keys()
    assert [str(e) for e in vf.exprs] == [str(e) for e in jvf.exprs]
    assert vf.arity == jvf.arity and vf.max_deriv_order() == \
        jvf.max_deriv_order()


@pytest.mark.parametrize('name', list(FORMS))
def test_pruned_combos_and_fold_plan_match_jax(name):
    _, _, asm, jasm = _pair(name)
    assert asm.combos == jasm.combos
    assert asm._fold_plan == jasm._fold_plan
    assert asm._num_combos_total == jasm._num_combos_total
    if asm._fold_plan is not None:
        for a, b in zip(asm._fold_tperms, jasm._fold_tperms):
            assert np.array_equal(a, b)
    assert asm._host_arrays.keys() == jasm._host_arrays.keys()
    for k, v in asm._host_arrays.items():
        w = jasm._host_arrays[k]
        if k == 'weights':
            assert all(np.array_equal(a, b) for a, b in zip(v, w))
        else:
            assert np.abs(v - np.asarray(w)).max() <= \
                1e-14 * max(np.abs(w).max(), 1.0)


@pytest.mark.parametrize('name,p,n', [('quarter_annulus', 3, 10),
                                      ('twisted_box', 3, 5)])
def test_geo_jac_fields_plain_matches_jax(name, p, n):
    """K1 `jac` kind: the plain version, fed by the K2 stage chain, gives
    JAX's physical values and Jacobian (NURBS and B-spline branches)."""
    jgeo = getattr(jgeometry, name)()
    jasm = JStiffnessAssembler(jgeo.sdim * (jbspline.make_knots(
        p, 0.0, 1.0, n),), jgeo)
    gi = jasm._geo_inputs
    nurbs = 'geo_tables_nurbs' in gi
    key = 'geo_tables_nurbs' if nurbs else 'geo_tables_bsp'
    d = len(gi[key])
    tgi = convert.geo_inputs(gi)
    val, jac = cuda_sumfac.geometry_fields(tgi[key], tgi['geo_coeffs'],
                                           nurbs)
    jval, jjac = jgeom.geo_jacobian_field(gi[key], gi['geo_coeffs'], nurbs,
                                          d)
    for got, ref in ((val, jval), (jac, jjac)):
        ref = np.asarray(ref)
        assert got.shape == ref.shape and got.dtype == torch.float64
        assert np.abs(got.numpy() - ref).max() / np.abs(ref).max() < 1e-13


@pytest.mark.parametrize('name,geo', [(n, 'quarter_annulus') for n in FORMS]
                         + [('convdiff', 'bspline_quarter_annulus')])
def test_combo_fields_match_jax(name, geo):
    """K5's plain version, and the generated program run with torch ops,
    against JAX's ``_eval_combo_fields`` on JAX's own host arrays,
    relative to the largest field (a conformal map makes some fields pure
    rounding noise on both sides)."""
    _, _, asm, jasm = _pair(name, geo)
    ref = [np.asarray(F) for F in
           jasm._eval_combo_fields(jasm._device_inputs(), jasm.combos)]
    scale = max(np.abs(F).max() for F in ref)
    arrays = convert.vform_arrays(jasm._host_arrays)
    ops = asm._device_operands()
    arrays['geo_val_lvl'], arrays['geo_jac_lvl'] = \
        cuda_sumfac.geometry_fields(ops['geo_tables'], ops['geo_coeffs'],
                                    asm._geo_is_nurbs)
    plain = cuda_vform.combo_fields_plain(asm, arrays, asm.combos)
    prog = asm._program(asm.combos)
    Y, P = cuda_vform.leaf_rows(prog, arrays)
    run = cuda_vform.run_program_plain(prog, Y, P)
    assert run.shape == (len(asm.combos), Y.shape[1])
    for c, R in enumerate(ref):
        assert plain[c].shape == R.shape
        assert np.abs(plain[c].numpy() - R).max() / scale < 1e-13
        assert np.abs(run[c].numpy() - R.ravel()).max() / scale < 1e-13


def test_generated_program_shares_geometry():
    """The convection-diffusion program loads only what it uses (Gauss
    weight and Jacobian, not the geometry values), reads both parameter
    components, and computes det J once: one subtraction of the two
    Jacobian products for the inverse, one for the measure (the vform
    cofactor expansion), CSE'd across all combos."""
    _, _, asm, _ = _pair('convdiff')
    prog = asm._program(asm.combos)
    assert sorted(prog.leaves) == sorted(
        [('gw',)] + [('geo_jac', c, k) for c in range(2) for k in range(2)])
    assert sorted(prog.params) == [('param', 'b', (0,)),
                                   ('param', 'b', (1,))]
    assert len(prog.outputs) == len(asm.combos)
    assert sum(op == 'abs' for op, _ in prog.instrs) == 1
    assert sum(op == 'div' for op, _ in prog.instrs) == 4
    assert 'fabs(' in prog.source and 'pyiga_vform_fields' in prog.source
    assert len(set(prog.instrs)) == len(prog.instrs)


def _dummy_physical(x, y):
    return x * y


@pytest.mark.parametrize('form,args,kw', [
    ('inner(grad(u), grad(v)) * dx', {}, {'kvs2': 'same'}),
    ('u * v * ds', {}, {}),
    ('inner(grad(g), grad(v)) * dx', {'g': 'spline'}, {}),
    ('inner(hess(u), hess(v)) * dx', {}, {}),
    ('div(u) * div(v) * dx', {}, {'vec': True}),
    ('u * v * dx', {}, {'geo': 'callable'}),
])
def test_unsupported_forms_raise(form, args, kw):
    kvs = _kvs(bspline, p=3)
    args = dict(args)
    if args.get('g') == 'spline':
        args['g'] = geometry.BSplineFunc(kvs, np.ones((8, 8)))
    if kw.get('kvs2') == 'same':
        kw['kvs2'] = kvs
    bfuns = [('u', 2), ('v', 2)] if kw.pop('vec', False) else None
    geo = kw.pop('geo', None)
    geo = _dummy_physical if geo == 'callable' else geometry.quarter_annulus()
    vf = vform.parse_vf(form, kvs, args=args, bfuns=bfuns)
    with pytest.raises(NotImplementedError):
        compile.compile_vform(vf)(kvs, geo=geo, **args, **kw)


def test_fields_wrapper_refuses_other_devices():
    """K1 `jac` and K5 run their plain versions only for CPU tensors."""
    meta = torch.empty((2, 3, 4, 2), dtype=torch.float64, device='meta')
    with pytest.raises(ValueError):
        cuda_sumfac.geo_jac_fields(meta, meta[0, :2], True)
    _, _, asm, _ = _pair('mass')
    arrays = {'weights': [torch.empty(4, dtype=torch.float64,
                                      device='meta')] * 2}
    with pytest.raises(ValueError):
        cuda_vform.combo_fields(asm, arrays, asm.combos)


def test_build_generated_caches_and_raises(tmp_path, monkeypatch):
    """A generated source is compiled once: the library is reused in the
    process and, after the process cache is dropped, loaded from disk
    without calling nvcc again; a failing nvcc raises with its output.
    (A stand-in nvcc copies a shared object, so this runs on the CPU.)"""
    calls = tmp_path / 'calls'
    fake = tmp_path / 'nvcc'
    fake.write_text(
        '#!%s\nimport shutil, sys\nopen(%r, "a").write("x")\n'
        'if "BROKEN" in open(sys.argv[-1]).read():\n'
        '    print("error: broken source"); sys.exit(1)\n'
        'shutil.copy(%r, sys.argv[sys.argv.index("-o") + 1])\n'
        % (sys.executable, str(calls), _ctypes.__file__))
    fake.chmod(0o755)
    monkeypatch.setattr(_cuda, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(_cuda, '_nvcc', lambda: str(fake))
    monkeypatch.setattr(_cuda, '_gen_libs', {})
    monkeypatch.setattr(_cuda, 'GEN_BUILDS', {})
    lib = _cuda.build_generated('probe', '// a kernel\n')
    assert _cuda.build_generated('probe', '// a kernel\n') is lib
    _cuda._gen_libs.clear()
    _cuda.build_generated('probe', '// a kernel\n')
    assert calls.read_text() == 'x'
    assert len(list((tmp_path / 'build' / 'gen').glob('*.cu'))) == 1
    with pytest.raises(RuntimeError, match='broken source'):
        _cuda.build_generated('probe', '// BROKEN\n')
