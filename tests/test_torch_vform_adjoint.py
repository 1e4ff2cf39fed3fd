"""K5's adjoint (the backward of the generated coefficient-field kernel)
in the PyTorch port, on the CPU: the plain adjoint (``run_adjoint_plain``)
chained through the port's plain geometry fields against ``jax.vjp`` of
the JAX package's ``VFormAssembler._eval_combo_fields``, with respect to
the leaves the JAX assembler takes as inputs (the geometry coefficients
and every ``param:*`` array); the emitted sources of the forward and the
adjoint kernel (one mapping rule, compiled here with the host compiler;
the rows mapping below its threshold; every gradient row written; no
atomics); and the CUDA branch of ``AdjointProgram.launch`` and of
``_ComboFields``, driven on CPU tensors through a stand-in for the
generated libraries, which checks the argument list (pointers, grid, RB,
block count, rows) and that the wrapper issues no memset, fill or
scatter.  All float64."""

import contextlib
import ctypes
import re
import subprocess

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

import pyiga_tpu.bspline as jbspline
import pyiga_tpu.geometry as jgeometry
from pyiga_tpu import assemble as jassemble

from pyiga_tpu_torch import _cuda, assemble, bspline, geometry
from pyiga_tpu_torch.ops import cuda_vform

torch.set_num_threads(1)

CONVDIFF = ('(inner(grad(u), grad(v)) + dot(b, grad(u)) * v + u * v) * dx')
# (form, dimension, face, arguments but the geometry)
CASES = {
    'convdiff': (CONVDIFF, 2, None, {'b': np.array([3.0, -2.0])}),
    'gradgrad_ds_left': ('inner(grad(u), grad(v)) * ds', 3, 'left', {}),
}


def _geo(pkg, dim):
    if dim == 2:
        return pkg.quarter_annulus()
    return pkg.tensor_product(pkg.line_segment(0.0, 1.0),
                              pkg.quarter_annulus())


def _kvs(pkg, dim, n=3, p=2):
    return dim * (pkg.make_knots(p, 0.0, 1.0, n),)


def _both(name):
    """The case's assembler in the port (on the CPU) and in the JAX
    package."""
    form, dim, bd, args = CASES[name]
    asm = assemble.instantiate_assembler(
        form, _kvs(bspline, dim), dict(args, geo=_geo(geometry, dim)), None,
        boundary=bd, device='cpu')
    jasm = jassemble.instantiate_assembler(
        form, _kvs(jbspline, dim), dict(args, geo=_geo(jgeometry, dim)),
        None, boundary=bd)
    return asm, jasm


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize('name', sorted(CASES))
def test_plain_adjoint_matches_jax_vjp(name):
    """The plain adjoint against ``jax.vjp`` of ``_eval_combo_fields``
    (compile.py:717) for a seeded output gradient, with respect to the
    JAX assembler's inputs ``geo_coeffs`` and ``param:*`` (convection-
    diffusion: ``b``; the 'left' face, QL = 1: ``Jac_to_boundary``).  The
    adjoint gives the gradient of the fields the program reads and of the
    flat parameter vector; the first goes on to the coefficients through
    autograd of the port's plain geometry fields (K2 stages and K1's
    ``jac`` kind on CPU tensors), the second splits into the parameter
    arrays by ``param_vector``'s layout."""
    asm, jasm = _both(name)
    assert asm.combos == jasm.combos
    prog = asm._program(asm.combos)
    arrays = asm.device_arrays()
    grid = tuple(w.shape[0] for w in arrays['weights'])
    if CASES[name][2] is not None:
        assert grid[-1] == 1                # the rows mapping's shape
    g = np.random.RandomState(4).rand(len(prog.outputs), *grid) - 0.5
    grads, gp = cuda_vform.run_adjoint_plain(prog, arrays, torch.as_tensor(g))

    coeffs = asm._device_operands()['geo_coeffs']
    c = coeffs.clone().requires_grad_(True)
    fields = asm.device_arrays(geo_coeffs=c)
    keys = [k for k in prog.sources if k.startswith('geo_')]
    assert keys and set(prog.sources) == set(keys)
    gc, = torch.autograd.grad([fields[k] for k in keys], c,
                              [grads[k] for k in keys])

    inputs = jasm._device_inputs()
    assert np.array_equal(np.asarray(inputs['geo_coeffs']), coeffs.numpy())
    pkeys = [k for k in inputs if k.startswith('param:')]
    assert pkeys

    def f(cf, pars):
        return jasm._eval_combo_fields(dict(inputs, geo_coeffs=cf, **pars),
                                       jasm.combos)
    _out, vjp = jax.vjp(f, jnp.asarray(inputs['geo_coeffs']),
                        {k: jnp.asarray(inputs[k]) for k in pkeys})
    jgc, jgp = vjp([jnp.asarray(x) for x in g])
    assert _rel(gc.numpy(), jgc) < 1e-12
    at = 0
    for k in asm._host_arrays:
        if k.startswith('param:'):
            ref = np.asarray(jgp[k])
            got = gp[at:at + ref.size].numpy().reshape(ref.shape)
            at += ref.size
            assert np.abs(got - ref).max() <= 1e-12 * max(
                np.abs(ref).max(), np.abs(np.asarray(jgc)).max())
    assert at == gp.numel()


@pytest.fixture(scope='module')
def shape_rule(tmp_path_factory):
    """``vform_shape``, the generated kernels' one mapping rule, compiled
    by the host compiler into a library: ``(rows, threads, RB, blocks)``
    of a grid."""
    d = tmp_path_factory.mktemp('vform_shape')
    src = d / 'shape.cc'
    src.write_text(cuda_vform._SHAPE + ''.join(
        'extern "C" int %s(int Q12, int QL, int* s) {\n'
        '    const VformShape v = vform_shape(Q12, QL, %s);\n'
        '    s[0] = v.rows; s[1] = v.threads; s[2] = v.rb; s[3] = v.blocks;\n'
        '    return 0;\n}\n' % fn for fn in (
            ('pyiga_vform_shape', 'K5_ADJ_MIN_BLOCKS'),
            ('forward_shape', 'K5_FWD_MIN_BLOCKS'))))
    subprocess.run(['g++', '-O1', '-shared', '-fPIC', '-o',
                    str(d / 'libshape.so'), str(src)], check=True)
    lib = ctypes.CDLL(str(d / 'libshape.so'))
    for fn in (lib.pyiga_vform_shape, lib.forward_shape):
        fn.argtypes = [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int

    def rule(Q12, QL, fn=lib.pyiga_vform_shape):
        out = (ctypes.c_int * 4)()
        assert fn(Q12, QL, out) == 0
        return tuple(out)
    rule.fn = lib.pyiga_vform_shape
    rule.forward = lambda Q12, QL: rule(Q12, QL, lib.forward_shape)
    return rule


@pytest.mark.parametrize('grid,forward,adjoint', [
    ((36864, 1), (1, 128, 128, 288), None),     # a face of 3D n=48: QL = 1
    ((100, 7), (1, 128, 128, 1), None),
    ((1, 1), (1, 128, 128, 1), None),
    ((100, 8), (0, 32, 1, 100), None),          # the threshold: columns
    ((512, 512), (0, 256, 1, 512), (0, 256, 2, 256)),      # 2D n=128
    ((36864, 192), (0, 192, 16, 2304), None),   # 3D n=48
    ((2048, 64), (0, 64, 4, 512), (0, 64, 8, 256)),
])
def test_shape_rule_maps_rows_below_threshold(shape_rule, grid, forward,
                                              adjoint):
    """Below 8 points a row a thread owns a row (128 threads and rows a
    block); else a block owns RB rows (16, halved while the grid has fewer
    than two blocks an SM for the forward, one for the adjoint) and a
    thread columns of the last axis."""
    assert shape_rule.forward(*grid) == forward
    assert shape_rule(*grid) == (adjoint or forward)


@pytest.mark.parametrize('name', sorted(CASES) + ['hessian'])
def test_emitted_sources(name):
    """Both kernels carry the one rule and hand its mapping to the kernel
    (``by_rows``), whose loops run one body for both mappings: each line
    of the point code once; the adjoint writes every row of every forward
    source's gradient (0 in a row no target writes, a runtime loop over
    rows past those the program reads), sums the parameters without
    atomics and writes the whole parameter gradient in its second
    kernel."""
    if name == 'hessian':
        asm = assemble.instantiate_assembler(
            'inner(hess(u), hess(v)) * dx', _kvs(bspline, 2, p=3),
            {'geo': geometry.quarter_annulus()}, None, device='cpu')
    else:
        asm, _ = _both(name)
    prog = asm._program(asm.combos)
    adj = prog.adjoint()
    for p, src, kernel in ((prog, prog.source, 'vform_fields_kernel'),
                           (adj.program, adj.source, 'vform_adjoint_kernel')):
        assert cuda_vform._SHAPE in src
        assert re.search(r'atomic\w*\s*\(', src) is None      # no atomics
        assert src.count('%s<<<' % kernel) == 1
        assert re.search(r'%s<<<[^;]*, sh\.rb, sh\.rows[,)]' % kernel, src) \
            or re.search(r'%s<<<[^;]*, RB, sh\.rows[,)]' % kernel, src)
        assert 'int RB, int by_rows' in src
        for line in cuda_vform._point_code(p):
            assert src.count(line) == 1
    fwd = prog
    target = set(adj.src_targets)
    for k, key in enumerate(fwd.sources):
        for row in range(fwd._rows[k]):
            line = 'g%d[%s] = ' % (k, cuda_vform._row_offset(row))
            assert src.count(line) == 1
            assert ((line + '0.0;') in src) == ((key, row) not in target)
        assert src.count('for (int j = %d; j < R%d; ++j) g%d[j * N + g] = '
                         '0.0;' % (fwd._rows[k], k, k)) == 1
    if name == 'hessian':       # the mirrored rows (k > l) are zeroed
        k = fwd.sources.index('geo_hess_lvl')
        assert 'g%d[2LL * N + g] = 0.0;' % k in src
    assert ('vform_param_sum_kernel<<<' in src) == bool(fwd.params)
    if adj.param_targets:
        assert '__shfl_xor_sync' in src
        assert 'kSlot[%d] = {%s}' % (len(adj.param_targets), ', '.join(
            map(str, adj.param_targets))) in src


def _arr(ptr, shape):
    buf = (ctypes.c_double * int(np.prod(shape))).from_address(ptr)
    return np.ctypeslib.as_array(buf).reshape(shape)


class _Entry:
    """A stand-in C entry: a Python callable that takes ``argtypes``."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args):
        return self.fn(*args)


class _FakeLibrary:
    """The generated libraries of one program on host memory: each entry
    checks its argument list against the tensors it expects and writes
    the values of the plain versions through the pointers it is handed,
    by numpy (no torch op, so that the recorder sees only the wrapper's).
    ``pyiga_vform_shape`` is the rule compiled by the host compiler."""

    def __init__(self, shape_rule):
        self.pyiga_vform_shape = shape_rule.fn
        self.pyiga_vform_adjoint = _Entry(self.adjoint)
        self.pyiga_vform_fields = _Entry(self.fields)
        self.rule = shape_rule
        self.calls = []

    def expect(self, prog, arrays, g):
        """The operands of the next calls and the values to write."""
        self.prog, self.arrays = prog, arrays
        grid = tuple(w.shape[0] for w in arrays['weights'])
        self.grid, self.N = grid, int(np.prod(grid))
        with torch.no_grad():
            self.fields = cuda_vform.run_program_plain(prog, arrays).numpy()
            grads, gp = cuda_vform.run_adjoint_plain(prog, arrays, g)
        self.grads = {k: v.numpy() for k, v in grads.items()}
        self.gp = None if gp is None else gp.numpy()
        self.g = g

    def _grid_ints(self):
        Q12, QL = int(np.prod(self.grid[:-1])), self.grid[-1]
        return [Q12, QL, self.grid[1] if len(self.grid) == 3 else 1]

    def fields(self, *args):
        prog, arrays = self.prog, self.arrays
        ops = prog.operands(arrays, torch.device('cpu'))
        n = len(ops)
        assert list(args[:n]) == [t.data_ptr() for t in ops]
        assert list(args[n + 1:]) == self._grid_ints() + [0]
        _arr(args[n], self.fields.shape)[...] = self.fields
        self.calls.append('fields')
        return 0

    def adjoint(self, *args):
        adj, fwd = self.prog.adjoint(), self.prog
        ops = adj.program.operands(self.arrays, torch.device('cpu'), self.g)
        n, ns = len(ops), len(fwd.sources)
        assert list(args[:n]) == [t.data_ptr() for t in ops]
        rows, threads, rb, nb = self.rule(*self._grid_ints()[:2])
        ints = self._grid_ints() + [rb, nb] + [
            self.arrays[k].numel() // self.N for k in fwd.sources]
        has_p = bool(fwd.params)
        ptrs = args[n:n + ns + 2 * has_p]
        if has_p:
            ints.append(self.arrays['params'].numel())
        assert list(args[n + ns + 2 * has_p:]) == ints + [0]
        for key, ptr in zip(fwd.sources, ptrs):
            _arr(ptr, self.grads[key].shape)[...] = self.grads[key]
        if has_p:
            _arr(ptrs[ns], self.gp.shape)[...] = self.gp
            # the partials: one per target and block
            assert _arr(ptrs[ns + 1], (max(1, len(adj.param_targets) * nb),)
                        ).size == max(1, len(adj.param_targets) * nb)
        self.calls.append(('adjoint', rows, rb, nb))
        return 0


class _Recorder(TorchDispatchMode):
    """The aten ops a call issues."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.fixture
def fake_card(monkeypatch, shape_rule):
    """The CUDA branch on CPU tensors: the build replaced by
    :class:`_FakeLibrary`, no device or stream to switch."""
    lib = _FakeLibrary(shape_rule)
    monkeypatch.setattr(_cuda, 'build_generated', lambda name, src: lib)
    monkeypatch.setattr(_cuda, 'device_of',
                        lambda t: contextlib.nullcontext())
    monkeypatch.setattr(_cuda, 'stream_of', lambda t: 0)
    _cuda.reset_launches()
    return lib


# what a launch may issue: its allocations and views of them, nothing
# that writes
ALLOCATIONS = {'aten.empty.memory_format', 'aten.new_empty.default',
               'aten.slice.Tensor'}


@pytest.mark.parametrize('name', sorted(CASES))
def test_launch_through_stand_in(fake_card, name):
    """``AdjointProgram.launch`` and ``_ComboFields`` on their CUDA branch:
    the argument list holds the operands' pointers, the grid, RB and the
    block count of the compiled rule (the rows mapping on the 'left'
    face, QL = 1), each gradient's rows and the parameter count; the
    wrapper allocates and calls, with no zeros, memset, fill, copy or
    index scatter (the kernels write every element: ``gparams`` comes
    back whole as the kernel wrote it); autograd through ``_ComboFields``
    returns the adjoint's gradients."""
    asm, _ = _both(name)
    prog = asm._program(asm.combos)
    adj = prog.adjoint()
    arrays = asm.device_arrays()
    grid = tuple(w.shape[0] for w in arrays['weights'])
    g = torch.as_tensor(np.random.RandomState(5).rand(
        len(prog.outputs), *grid) - 0.5)
    fake_card.expect(prog, arrays, g)
    rec = _Recorder()
    with rec:
        grads, gp = adj.launch(arrays, g)
    assert 'aten.empty.memory_format' in rec.ops
    assert set(rec.ops) <= ALLOCATIONS, rec.ops
    rows, _threads, rb, nb = fake_card.rule(int(np.prod(grid[:-1])),
                                            grid[-1])
    assert rows == (grid[-1] < 8) and fake_card.calls == [
        ('adjoint', rows, rb, nb)]
    assert adj.shape(int(np.prod(grid[:-1])), grid[-1]) == (rows, _threads,
                                                           rb, nb)
    assert _cuda.LAUNCHES['vform_adjoint'] == 1
    for key in prog.sources:
        assert grads[key].shape == arrays[key].shape
        assert np.array_equal(grads[key].numpy(), fake_card.grads[key])
    assert np.array_equal(gp.numpy(), fake_card.gp)
    # one tensor object a source, none a view of another
    bases = [t.untyped_storage().data_ptr() for t in grads.values()]
    assert len(set(bases)) == len(bases)

    # the forward and its backward through autograd
    W = arrays['weights']
    leaves = [arrays[k].clone().requires_grad_(True) for k in prog.sources]
    params = arrays['params'].clone().requires_grad_(True)
    fake_card.expect(prog, dict(arrays, params=params.detach(),
                                **dict(zip(prog.sources, leaves))), g)
    rec = _Recorder()
    with rec:
        out = cuda_vform._ComboFields.apply(prog, len(W), *W, *leaves,
                                            params)
    assert set(rec.ops) <= ALLOCATIONS, rec.ops
    assert np.array_equal(out.detach().numpy().reshape(len(prog.outputs),
                                                       -1),
                          fake_card.fields)
    got = torch.autograd.grad(out, leaves + [params], g)
    for key, t in zip(prog.sources, got):
        assert np.array_equal(t.numpy(), fake_card.grads[key])
    assert np.array_equal(got[-1].numpy(), fake_card.gp)
    assert _cuda.LAUNCHES['vform_fields'] == 1
    assert _cuda.LAUNCHES['vform_adjoint'] == 2


def test_launch_checks_operands(fake_card):
    """The checks of the redesigned launch: the output's gradient, a
    source off the grid, the parameter slots; none reaches the library.
    What ``outputs`` allocates: a gradient tensor a source, and one
    allocation holding the parameter gradient and then the partials (one
    per target and block)."""
    asm, _ = _both('convdiff')
    prog = asm._program(asm.combos)
    adj = prog.adjoint()
    arrays = asm.device_arrays()
    grid = tuple(w.shape[0] for w in arrays['weights'])
    g = torch.zeros((len(prog.outputs),) + grid, dtype=torch.float64)
    with pytest.raises(ValueError, match='gradient'):
        adj.launch(arrays, g[:, :-1])
    with pytest.raises(ValueError, match='gradient'):
        adj.launch(arrays, g.float())
    key = prog.sources[0]
    with pytest.raises(ValueError, match=key):
        adj.launch(dict(arrays, **{key: arrays[key][..., :-1]}), g)
    with pytest.raises(ValueError, match='params'):
        adj.launch(dict(arrays, params=arrays['params'][:1]), g)
    assert fake_card.calls == []
    grads, gparams, part = adj.outputs(arrays)
    assert grads[key].shape == arrays[key].shape
    assert gparams.shape == arrays['params'].shape
    nb = adj.shape(int(np.prod(grid[:-1])), grid[-1])[3]
    assert part.shape == (len(adj.param_targets) * nb,)
    assert part.data_ptr() == gparams.data_ptr() + 8 * gparams.numel()
