"""The batch rule of the backward launches (K1-bwd, K2-/K3-bwd, the K5
adjoint): ``torch.func.vmap`` of ``torch.func.grad`` and ``torch.func.
jacrev`` through the wrappers' CUDA branch, driven on CPU tensors through a
stand-in for the library entries that computes from the pointers it is
handed (as ``tests/test_torch_stage_bwd.py`` does).  A member of a batch
is one launch of each kernel; the gradients equal the loop of ``grad``s
and the CPU run (the plain versions); a second derivative through a
backward kernel raises.  The K5 forward and adjoint run their plain
programs behind the same Functions."""

import contextlib
import ctypes

import numpy as np
import pytest
import torch

from pyiga_tpu_torch import _cuda, assemble, geometry
from pyiga_tpu_torch.assemblers import MassAssembler, StiffnessAssembler
from pyiga_tpu_torch.bspline import make_knots
from pyiga_tpu_torch.diff import assembly_coeff_fn
from pyiga_tpu_torch.ops import cuda_sumfac, cuda_vform

torch.set_num_threads(1)


def _arr(ptr, *shape):
    buf = (ctypes.c_double * int(np.prod(shape))).from_address(ptr)
    return torch.from_numpy(np.ctypeslib.as_array(buf).reshape(shape))


class _FakeLibrary:
    """The float64 entries of K1 (stiffness, mass), K2, K3 and their
    backward on host memory, each a plain version on the arrays behind
    the pointers; records each call's name."""

    def __init__(self):
        self.calls = []

    def _fields(self, name, plain, Y, T, w12, wL, out, d, nurbs, Q12, QL,
                nL):
        self.calls.append(name)
        C = d + nurbs
        shape = (d * (d + 1) // 2, Q12, QL) if name == 'fields' else \
            (Q12, QL)
        _arr(out, *shape)[...] = plain(
            _arr(Y, d, C, Q12, nL), _arr(T, 2, QL, nL), _arr(w12, Q12),
            _arr(wL, QL), bool(nurbs))
        return 0

    def pyiga_stiff_fields_f64(self, *a):
        return self._fields('fields', cuda_sumfac.fields_plain, *a[:-1])

    def pyiga_mass_fields_f64(self, *a):
        return self._fields('mass_fields', cuda_sumfac.fields_mass_plain,
                            *a[:-1])

    def pyiga_stage_f64(self, X, T, out, K, R, M, stream):
        self.calls.append('stage')
        _arr(out, R, M)[...] = _arr(X, K, R).T @ _arr(T, M, K).T
        return 0

    def pyiga_fold_f64(self, xp, tp, n, out, K, R, M, stream):
        self.calls.append('fold')
        xs = ctypes.cast(xp, ctypes.POINTER(ctypes.c_uint64))
        ts = ctypes.cast(tp, ctypes.POINTER(ctypes.c_uint64))
        o = _arr(out, R, M)
        o[...] = 0
        for t in range(n):
            o += _arr(xs[t], K, R).T @ _arr(ts[t], M, K).T
        return 0

    def pyiga_stage_bwd_f64(self, t_ptrs, n, g, out, K, R, M, stream):
        self.calls.append('stage_bwd')
        ptrs = ctypes.cast(t_ptrs, ctypes.POINTER(ctypes.c_uint64))
        o = _arr(out, n, K, R)
        for i in range(n):
            o[i] = _arr(ptrs[i], M, K).T @ _arr(g, R, M).T
        return 0

    def pyiga_fields_bwd_f64(self, kind, Y, T, w12, wL, g, gY, d, G, nurbs,
                             Q12, QL, nL, stream):
        name = ('stiffness', 'mass', 'jac')[kind]
        self.calls.append('fields_bwd_' + name)
        C = G + nurbs
        shape = {'stiffness': (d * (d + 1) // 2, Q12, QL),
                 'mass': (Q12, QL)}[name]
        _arr(gY, d, C, Q12, nL)[...] = cuda_sumfac._fields_vjp_plain(
            name, _arr(Y, d, C, Q12, nL), _arr(T, 2, QL, nL),
            _arr(w12, Q12), _arr(wL, QL), bool(nurbs), _arr(g, *shape))
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


def _objective(cls, geo):
    asm = cls(2 * (make_knots(2, 0.0, 1.0, 4),), geo, device='cpu')
    fn, c0 = assembly_coeff_fn(asm)
    w = torch.as_tensor(np.random.RandomState(42).rand(*fn(c0).shape))
    rng = np.random.RandomState(7)
    batch = torch.as_tensor(np.stack([c0 + 0.01 * rng.randn(*c0.shape)
                                      for _ in range(4)]))
    return (lambda c: (w * fn(c)).sum()), fn, batch


BACKWARDS = {MassAssembler: ('mass_fields_bwd', 'stage_bwd', 'fold_bwd'),
             StiffnessAssembler: ('fields_bwd', 'stage_bwd', 'fold_bwd')}


@pytest.mark.parametrize('cls', [MassAssembler, StiffnessAssembler],
                         ids=lambda c: c.__name__)
def test_vmap_of_grad_launches_each_backward_per_member(fake_card, cls):
    obj, _fn, batch = _objective(cls, geometry.bspline_quarter_annulus())
    _cuda.reset_launches()
    got = torch.func.vmap(torch.func.grad(obj))(batch)
    per_member = dict(_cuda.LAUNCHES)
    _cuda.reset_launches()
    loop = torch.stack([torch.func.grad(obj)(c) for c in batch])
    assert per_member == dict(_cuda.LAUNCHES)
    for k in BACKWARDS[cls]:
        assert per_member[k] > 0 and per_member[k] % len(batch) == 0, k
    assert torch.allclose(got, loop, rtol=1e-12, atol=1e-14)
    # the plain versions on the CPU (no stand-in)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_sumfac, '_kernel_device',
                   lambda t, n: t.is_cuda)
        ref = torch.func.vmap(torch.func.grad(obj))(batch)
    assert torch.allclose(got, ref, rtol=1e-12, atol=1e-14)


def test_jacrev_through_the_backward_kernels(fake_card):
    _obj, fn, batch = _objective(MassAssembler, geometry.quarter_annulus())
    c0 = batch[0]
    sub = torch.as_tensor(np.random.RandomState(3).rand(*fn(c0).shape))

    def g(c):                  # a few outputs: jacrev's batch of vjps
        return (sub * fn(c)).reshape(-1)[:5]
    _cuda.reset_launches()
    got = torch.func.jacrev(g)(c0)
    assert _cuda.LAUNCHES['mass_fields_bwd'] == 5
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_sumfac, '_kernel_device', lambda t, n: t.is_cuda)
        ref = torch.func.jacrev(g)(c0)
    assert got.shape == (5,) + tuple(c0.shape)
    assert torch.allclose(got, ref, rtol=1e-12, atol=1e-14)


def test_second_derivative_through_a_backward_kernel_raises(fake_card):
    obj, _fn, batch = _objective(MassAssembler,
                                 geometry.bspline_quarter_annulus())
    with pytest.raises(RuntimeError, match='no backward'):
        torch.func.grad(lambda c: torch.func.grad(obj)(c).sum())(batch[0])


def _k5_operands():
    """The convection-diffusion form's K5 program and operands at 2D n=4
    (its parameter ``b`` is the flat parameter vector)."""
    asm = assemble.instantiate_assembler(
        '(inner(grad(u), grad(v)) + dot(b, grad(u)) * v + u * v) * dx',
        2 * (make_knots(2, 0.0, 1.0, 4),),
        {'b': np.array([3.0, -2.0]), 'geo': geometry.quarter_annulus()},
        None, None, device='cpu')
    arrays = asm.device_arrays()
    prog = asm._program(asm.combos)
    W = list(arrays['weights'])
    tensors = W + [arrays[k] for k in prog.sources]
    return prog, len(W), tensors, arrays['params']


def test_vmap_of_grad_through_the_k5_adjoint(monkeypatch):
    """``_ComboFields`` and its adjoint's Function under ``vmap(grad)``
    over the parameter vector: one adjoint launch a member, the
    gradients those of the loop and of autograd through the plain
    program."""
    prog, n_w, tensors, params = _k5_operands()
    launches = []

    def forward(program, n_w, *t):
        arrays = cuda_vform._program_arrays(program, n_w, t)
        grid = tuple(w.shape[0] for w in arrays['weights'])
        return cuda_vform.run_program_plain(program, arrays).reshape(
            (len(program.outputs),) + grid)

    def launch(self, arrays, g):
        launches.append(1)
        return cuda_vform.run_adjoint_plain(self.forward, arrays, g)
    monkeypatch.setattr(cuda_vform._ComboFields, 'forward',
                        staticmethod(forward))
    monkeypatch.setattr(cuda_vform.AdjointProgram, 'launch', launch)
    grid = tuple(t.shape[0] for t in tensors[:n_w])
    w = torch.as_tensor(np.random.RandomState(5).rand(
        len(prog.outputs), *grid))

    def obj(p):
        return (w * cuda_vform._ComboFields.apply(prog, n_w, *tensors,
                                                  p)).sum()
    batch = params[None] * torch.as_tensor([[1.0], [0.5], [-2.0]])
    got = torch.func.vmap(torch.func.grad(obj))(batch)
    assert len(launches) == 3
    loop = torch.stack([torch.func.grad(obj)(p) for p in batch])
    assert torch.equal(got, loop)

    def plain(p):
        arrays = cuda_vform._program_arrays(prog, n_w, tensors + [p])
        return (w.reshape(len(prog.outputs), -1)
                * cuda_vform.run_program_plain(prog, arrays)).sum()
    ref = torch.stack([torch.func.grad(plain)(p) for p in batch])
    assert torch.allclose(got, ref, rtol=1e-12, atol=1e-14)
