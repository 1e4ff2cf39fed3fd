"""K5's generated tangent and second-order kernels from their own
sources on the CPU: each form's programs emitted as for the card
(:func:`~pyiga_tpu_torch.ops.cuda_vform.emit_cuda`,
:func:`~pyiga_tpu_torch.ops.cuda_vform.emit_cuda_adjoint`), compiled by
the host compiler under the emulation of ``tests/cuda_emulation.py`` (a
thread per CUDA thread, a barrier per block: the staged weights, the
parameter sums' shuffles and second kernel) and launched through
``Program.launch`` / ``AdjointProgram.launch`` (the entries' argument
lists), against their plain runs (1e-13 in float64, 1e-5 in float32):
forms with every op of the generator (its ``sign``, the derivative of
``abs``, included), parameters and a Hessian input."""

import contextlib
import ctypes

import numpy as np
import pytest
import torch

import pyiga_tpu_torch
from pyiga_tpu_torch import _cuda, assemble, bspline, geometry
from pyiga_tpu_torch.ops import cuda_vform

import cuda_emulation

torch.set_num_threads(1)

FORMS = {
    'convdiff': ('(inner(grad(u), grad(v)) + dot(b, grad(u)) * v + u * v)'
                 ' * dx', {'b': np.array([3.0, -2.0])}),
    'funcs': ('(sqrt(c) + exp(c) + log(c) + sin(c) + cos(c) + tan(0.3 * c)'
              ' + abs(c - 1.2)) * inner(grad(u), grad(v)) * dx',
              {'c': 'spline'}),
    'hessian': ('inner(hess(u), hess(v)) * dx', {}),
    'param': ('eps * (1 + dot(b, b)) * inner(grad(u), grad(v)) * dx',
              {'eps': 0.7, 'b': np.array([0.5, -1.5])}),
}


def _install(prog, lib):
    """Declare the emulated library's forward entry as the program's."""
    fn = lib.pyiga_vform_fields
    n_ptr = prog.dim + len(prog.sources) + int(bool(prog.params)) + 1
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    prog._entry = fn


def _install_adjoint(adj, lib):
    """Declare the emulated library's adjoint entries as `adj`'s."""
    fwd, prog = adj.forward, adj.program
    has_p = bool(fwd.params)
    fn = lib.pyiga_vform_adjoint
    fn.argtypes = ([ctypes.c_void_p] * (len(cuda_vform._pointer_args(prog))
                                        + len(fwd.sources) + 2 * has_p)
                   + [ctypes.c_int] * (5 + len(fwd.sources) + has_p)
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    shape = lib.pyiga_vform_shape
    shape.argtypes = [ctypes.c_int, ctypes.c_int,
                      ctypes.POINTER(ctypes.c_int)]
    shape.restype = ctypes.c_int
    adj._shape_fn, adj._entry = shape, fn


def _rel(got, ref):
    got, ref = got.double(), ref.double()
    scale = float(ref.abs().max())
    return float((got - ref).abs().max()) / (scale if scale > 0 else 1.0)


@pytest.mark.parametrize('name', sorted(FORMS))
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32],
                         ids=['f64', 'f32'])
def test_emulated_tangent_and_second_match_plain(tmp_path, monkeypatch,
                                                 name, dtype):
    form, args = FORMS[name]
    p = 3 if name == 'hessian' else 2
    kvs = 2 * (bspline.make_knots(p, 0.0, 1.0, 3),)
    rng = np.random.RandomState(1)
    args = {k: (geometry.BSplineFunc(kvs, 1.0 + rng.rand(
        *[kv.numdofs for kv in kvs])) if isinstance(v, str) else v)
        for k, v in args.items()}
    asm = assemble.instantiate_assembler(
        form, kvs, dict(args, geo=geometry.quarter_annulus()), None, None,
        device='cpu')
    saved = pyiga_tpu_torch.get_dtype()
    pyiga_tpu_torch.set_dtype(np.float32 if dtype == torch.float32
                              else np.float64)
    try:
        arrays = asm.device_arrays()
    finally:
        pyiga_tpu_torch.set_dtype(saved)
    prog = asm._program(asm.combos, dtype)
    mask = (True,) * (len(prog.sources) + int(bool(prog.params)))
    tans = {k: torch.as_tensor(rng.rand(*arrays[k].shape) - 0.5,
                               dtype=dtype) for k in prog.sources}
    if prog.params:
        tans['params'] = torch.as_tensor(rng.rand(*arrays['params'].shape)
                                         - 0.5, dtype=dtype)
    tprog, sprog = prog.tangent(mask), prog.second(mask)
    lib = ctypes.CDLL(str(cuda_emulation.build(
        tmp_path, 'k5_ad', {'tangent.cu': tprog.source,
                            'second.cu': sprog.source})))
    _install(tprog, lib)
    _install_adjoint(sprog, lib)
    monkeypatch.setattr(_cuda, 'device_of',
                        lambda t: contextlib.nullcontext())
    monkeypatch.setattr(_cuda, 'stream_of', lambda t: 0)
    monkeypatch.setattr(_cuda, 'check', lambda err, nm: None if err == 0
                        else pytest.fail('%s returned %d' % (nm, err)))
    tol = 1e-13 if dtype == torch.float64 else 1e-5
    targs = cuda_vform.tangent_operands(prog, mask, arrays, tans)
    got = tprog.launch(targs)
    ref = cuda_vform.run_tangent_plain(prog, mask, arrays, tans)
    assert got.dtype == dtype and _rel(got.reshape(ref.shape), ref) < tol
    grid = tuple(w.shape[0] for w in arrays['weights'])
    g = torch.as_tensor(rng.rand(len(prog.outputs), *grid) - 0.5,
                        dtype=dtype)
    grads, gp = sprog.launch(targs, g)
    rgrads, rgp = cuda_vform.run_second_plain(prog, mask, arrays, g, tans)
    for key in prog.sources:
        assert grads[key].shape == arrays[key].shape
        assert _rel(grads[key], rgrads[key]) < tol
    if prog.params:
        assert _rel(gp, rgp) < tol
        again, gp2 = sprog.launch(targs, g)
        assert torch.equal(gp2, gp)          # the sums' fixed order
    else:
        assert gp is None
