"""The PyTorch port's form language and coefficient fields held against
the JAX package: the parser (hashes, field keys), the probe-based combo
pruning and symmetric folding, K1's ``jac`` kind (plain version, through
the port's K2 stage chain) against ``pyiga_tpu.ops.geom``, and kernel
K5's plain version and generated program against
``VFormAssembler._eval_combo_fields`` (all float64 on the CPU)."""

import _ctypes
import ctypes
import functools
import sys
import types

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


def _a(x, y):
    """A vector input field (physical)."""
    return (1.0 + x * y, np.cos(x) + 0.0 * y)


# stiffness, mass, the bench's convection-diffusion + reaction form, a
# physical input function, a vector parameter under sqrt/exp, a vector
# input field beside a vector parameter; in 3D convection-diffusion with
# a geometry value
FORMS = {
    'stiffness': ('inner(grad(u), grad(v)) * dx', {}),
    'mass': ('u * v * dx', {}),
    'convdiff': ('(inner(grad(u), grad(v)) + dot(b, grad(u)) * v + u * v)'
                 ' * dx', {'b': np.array([3.0, -2.0])}),
    'rhs_f': ('f * v * dx', {'f': _f}),
    'sqrt_exp': ('(sqrt(c[0]**2 + c[1]**2) * inner(grad(u), grad(v)) '
                 '+ exp(c[1]) * u * v) * dx', {'c': np.array([0.5, 1.5])}),
    'input_param': ('(c[1] * inner(grad(u), grad(v)) + dot(a, grad(u)) * v'
                    ' + c[0] * a[1] * u * v) * dx',
                    {'a': _a, 'c': np.array([0.5, 2.0])}),
    'convdiff3d': ('(inner(grad(u), grad(v)) + dot(b, grad(u)) * v'
                   ' + x[0] * u * v) * dx', {'b': np.array([3.0, -2.0, 1.0])}),
}
DIMS = {'convdiff3d': 3}


def _kvs(pkg, p=2, n=5, dim=2):
    return dim * (pkg.make_knots(p, 0.0, 1.0, n - 2 * (dim == 3)),)


@functools.lru_cache(maxsize=None)
def _pair(name, geo='quarter_annulus'):
    """The same form compiled and instantiated in both packages."""
    form, args = FORMS[name]
    dim = DIMS.get(name, 2)
    if dim == 3:
        geo = 'twisted_box'
    vf = vform.parse_vf(form, _kvs(bspline, dim=dim), args=args)
    jvf = jvform.parse_vf(form, _kvs(jbspline, dim=dim), args=args)
    asm = compile.compile_vform(vf)(_kvs(bspline, dim=dim),
                                    geo=getattr(geometry, geo)(),
                                    device='cpu', **args)
    jasm = jcompile.compile_vform(jvf)(_kvs(jbspline, dim=dim),
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
    tgi = convert.geo_inputs(gi, device='cpu')
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
    """K5's plain version, and the generated program run with torch ops
    from the leaves' source tensors, the per-axis Gauss weights and the
    flat parameter vector (the kernel's operands), against JAX's
    ``_eval_combo_fields`` on JAX's own host arrays, relative to the
    largest field (a conformal map makes some fields pure rounding noise
    on both sides)."""
    _, _, asm, jasm = _pair(name, geo)
    ref = [np.asarray(F) for F in
           jasm._eval_combo_fields(jasm._device_inputs(), jasm.combos)]
    scale = max(np.abs(F).max() for F in ref)
    arrays = convert.vform_arrays(jasm._host_arrays, device='cpu')
    ops = asm._device_operands()
    arrays['geo_val_lvl'], arrays['geo_jac_lvl'] = \
        cuda_sumfac.geometry_fields(ops['geo_tables'], ops['geo_coeffs'],
                                    asm._geo_is_nurbs)
    arrays['params'] = torch.as_tensor(
        cuda_vform.param_vector(jasm._host_arrays))
    plain = cuda_vform.combo_fields_plain(asm, arrays, asm.combos)
    prog = asm._program(asm.combos)
    run = cuda_vform.run_program_plain(prog, arrays)
    assert run.shape == (len(asm.combos), ref[0].size)
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


@pytest.mark.parametrize('name', ['convdiff', 'input_param', 'convdiff3d'])
def test_generated_source_reads_leaves_in_place(name):
    """The kernel takes one pointer per source tensor (no stacked leaf
    array), reads each leaf at its row of that tensor, forms the Gauss
    weight as ``(w0 w1) w2`` from the per-axis vectors and reads the
    parameters at their slots of the flat parameter vector."""
    _, _, asm, _ = _pair(name)
    prog = asm._program(asm.combos)
    src, d = prog.source, asm.dim
    assert 'y[' not in src and 'const double* __restrict__ y' not in src
    assert src.count('const double* __restrict__ s') == len(prog.sources)
    assert src.count('const double* __restrict__ w') == d
    rows = {'geo_val_lvl': lambda k: k[1],
            'geo_jac_lvl': lambda k: k[1] * d + k[2]}
    for j, key in enumerate(prog.leaves):
        if key == ('gw',):
            assert prog.leaf_src[j] is None
            assert 'const double l%d = sw12[r] * wl;' % j in src
            continue
        s, row = prog.leaf_src[j]
        akey = prog.sources[s]
        if akey.startswith('input:'):
            lead = np.shape(asm._host_arrays[akey])[:-d]
            assert row == (np.ravel_multi_index(key[2], lead) if lead
                           else 0)
        else:
            assert row == rows[akey](key)
        off = 'g' if row == 0 else '%dLL * N + g' % row
        assert 'const double l%d = __ldg(s%d + %s);' % (j, s, off) in src
    w12 = {2: '__ldg(w0 + r)',
           3: '__ldg(w0 + r / Q1) * __ldg(w1 + r % Q1)'}[d]
    assert 'sw12[threadIdx.x] = %s;' % w12 in src
    assert 'const double wl = __ldg(w%d + c);' % (d - 1) in src
    flat = {k: i for i, (k, _v) in enumerate(
        cuda_vform._param_components(asm._host_arrays))}
    for k, (key, slot) in enumerate(zip(prog.params, prog.param_slots)):
        assert slot == flat[key]
        assert 'const double p%d = __ldg(p + %d);' % (k, slot) in src
    assert ('const double* __restrict__ p,' in src) == bool(prog.params)
    P = asm.device_arrays()['params']
    assert np.array_equal(P.numpy(),
                          cuda_vform.param_vector(asm._host_arrays))


def test_param_update_keeps_source():
    """A new parameter value refreshes the cached flat parameter vector
    and keeps the program (and its source); a new shape rebuilds it."""
    vf = vform.parse_vf(FORMS['convdiff'][0], _kvs(bspline),
                        args={'b': np.array([3.0, -2.0])})
    asm = compile.compile_vform(vf)(_kvs(bspline),
                                    geo=geometry.quarter_annulus(),
                                    device='cpu', b=np.array([3.0, -2.0]))
    prog = asm._program(asm.combos)
    src = prog.source
    asm.device_arrays()
    asm.update(b=np.array([-1.0, 4.0]))
    assert asm._program(asm.combos) is prog and prog.source == src
    arrays = asm.device_arrays()
    assert arrays['params'].tolist() == [-1.0, 4.0]
    assert arrays['param:b'].tolist() == [-1.0, 4.0]
    run = cuda_vform.run_program_plain(prog, arrays)
    plain = cuda_vform.combo_fields_plain(asm, arrays, asm.combos)
    for c, F in enumerate(plain):
        assert torch.equal(run[c], F.reshape(-1))


def test_generated_program_without_leaves():
    """A program with no leaf and constant outputs: no load, no weight
    vector read, the constants stored at every point."""
    prog = cuda_vform.SSARecorder().finish([2.5, 0.0], 2)
    src = prog.source
    assert prog.sources == [] and prog.params == []
    assert '__ldg' not in src and 'sw12' not in src
    assert 'out[g] = (2.5);' in src and 'out[1LL * N + g] = (0.0);' in src
    W = [torch.rand(3, dtype=torch.float64), torch.rand(4,
                                                         dtype=torch.float64)]
    run = cuda_vform.run_program_plain(prog, {'weights': W})
    assert run.tolist() == [[2.5] * 12, [0.0] * 12]


def test_program_entry_built_once(monkeypatch):
    """The program's C entry is built, loaded and declared once: later
    launches reuse it without calling ``build_generated`` (no source
    hash per launch).  A stand-in library stands for the build."""
    calls = []

    def fake_build(name, source):
        calls.append(name)
        return types.SimpleNamespace(
            pyiga_vform_fields=types.SimpleNamespace())
    monkeypatch.setattr(_cuda, 'build_generated', fake_build)
    _, _, asm, _ = _pair('convdiff')
    prog = cuda_vform.generate(asm, asm.combos)
    fn = prog.entry()
    for _ in range(3):
        assert prog.entry() is fn
    assert calls == ['vform_fields']
    # w0, w1, the Jacobian, the parameters, out; Q12, QL, Q1; the stream
    assert len(fn.argtypes) == 5 + 3 + 1 and fn.restype is ctypes.c_int


def _dummy_physical(x, y):
    return x * y


def _to_dense(A):
    return A.toarray() if hasattr(A, 'toarray') else np.asarray(A)


@pytest.mark.parametrize('form,args,kw', [
    ('u * v * ds', {}, {'boundary': 'left'}),
    ('inner(hess(u), hess(v)) * dx', {}, {}),
    ('inner(hess(g), hess(v)) * dx', {'g': 'spline'}, {}),
    ('u * v * dx', {}, {'geo': 'callable'}),
])
def test_unsupported_forms_raise(form, args, kw):
    """The forms this test once saw refused: a boundary integral, a
    fourth-order form and the Hessian of a spline input assemble as the
    JAX package does (1e-13 relative); a bare callable as the geometry is
    refused by both packages alike (AttributeError: it has no
    ``grid_jacobian``)."""
    kvs, jkvs = _kvs(bspline, p=3), _kvs(jbspline, p=3)
    args, jargs, kw = dict(args), dict(args), dict(kw)
    if args.get('g') == 'spline':
        coeffs = np.random.RandomState(3).rand(8, 8)
        args['g'] = geometry.BSplineFunc(kvs, coeffs)
        jargs['g'] = jgeometry.BSplineFunc(jkvs, coeffs)
    if kw.pop('geo', None) == 'callable':
        vf = vform.parse_vf(form, kvs, args=args)
        jvf = jvform.parse_vf(form, jkvs, args=jargs)
        with pytest.raises(AttributeError):
            jcompile.compile_vform(jvf)(jkvs, geo=_dummy_physical)
        with pytest.raises(AttributeError):
            compile.compile_vform(vf)(kvs, geo=_dummy_physical,
                                      device='cpu')
        return
    from pyiga_tpu import assemble as jassemble

    from pyiga_tpu_torch import assemble
    A = assemble.assemble(form, kvs, geo=geometry.quarter_annulus(),
                          device='cpu', **args, **kw)
    jA = jassemble.assemble(form, jkvs, geo=jgeometry.quarter_annulus(),
                            **jargs, **kw)
    A, jA = _to_dense(A), _to_dense(jA)
    assert A.shape == jA.shape
    assert np.abs(A - jA).max() <= 1e-13 * np.abs(jA).max()


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
