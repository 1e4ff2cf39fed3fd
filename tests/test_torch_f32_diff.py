"""The PyTorch port's differentiable assembly on the f32 line
(``pyiga_tpu_torch.set_dtype(np.float32)``) held against
``pyiga_tpu.diff`` under ``pyiga_tpu.set_dtype(np.float32)`` on the CPU:
the same seeded numpy inputs and geometries through both, values and
gradients of a weighted sum to 2e-5 relative (float32 rounding in two
orders of summation), for ``assembly_coeff_fn`` on the stiffness and mass
assemblers (B-spline and NURBS, 2D and a small 3D box) and on compiled
forms, ``assembly_input_fn`` on a parameter and an input field, and
``implicit_cg_solve`` through a float32 operator.  The outputs are
float32, the gradients come back in the leaf's dtype, and the float32
results are not the float64 ones rounded.  Beside them each float32
backward's plain version (what a CPU tensor runs) against autograd of
its plain float32 forward: K1's three kinds, K2 / K3 and the K5 adjoint
program."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pyiga_tpu
import pyiga_tpu.geometry as jgeometry
from pyiga_tpu import approx as japprox
from pyiga_tpu import assemble as jassemble
from pyiga_tpu import diff as jdiff
from pyiga_tpu.assemblers import MassAssembler as JMass
from pyiga_tpu.assemblers import StiffnessAssembler as JStiffness
from pyiga_tpu.bspline import make_knots as jmake_knots

import pyiga_tpu_torch
from pyiga_tpu_torch import approx, assemble, convert, diff, geometry
from pyiga_tpu_torch.assemblers import MassAssembler, StiffnessAssembler
from pyiga_tpu_torch.ops import cuda_sumfac, cuda_vform
from pyiga_tpu_torch.ops.fastdiag import interior_dofs

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64
TOL = 2e-5          # float32 against float32, two orders of summation
ASSEMBLERS = {'stiffness': (StiffnessAssembler, JStiffness),
              'mass': (MassAssembler, JMass)}


@pytest.fixture(autouse=True)
def float32_line():
    """Both packages on the f32 line for the test, float64 after it,
    whatever it raised."""
    pyiga_tpu.set_dtype(np.float32)
    pyiga_tpu_torch.set_dtype(np.float32)
    yield
    pyiga_tpu.set_dtype(np.float64)
    pyiga_tpu_torch.set_dtype(np.float64)


def _f64():
    pyiga_tpu.set_dtype(np.float64)
    pyiga_tpu_torch.set_dtype(np.float64)


def _rel(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _jkvs(p, n, d=2):
    return d * (jmake_knots(p, 0.0, 1.0, n),)


def _kvs(jkvs):
    return tuple(convert.knot_vector(kv) for kv in jkvs)


def _weights_for(shape):
    return np.random.RandomState(42).rand(*shape)


def _port_grad(fn, w, x0, dtype=F64):
    """``fn(x0)`` and the gradient of ``sum(w * fn(x))`` at `x0`, the leaf
    a tensor of `dtype` (float64: the caller's coefficients as they come;
    the assembly casts them to float32)."""
    x = torch.tensor(np.asarray(x0, dtype=float), dtype=dtype,
                     requires_grad=True)
    out = fn(x)
    (torch.as_tensor(w, dtype=out.dtype) * out).sum().backward()
    return out.detach(), x.grad


def _jax_value_grad(jfn, w, x0):
    x = jnp.asarray(x0, dtype=jnp.float64)
    val = jfn(x)
    g = jax.grad(lambda c: jnp.sum(jnp.asarray(w, dtype=val.dtype)
                                   * jfn(c)))(x)
    return np.asarray(val), np.asarray(g)


def _check(fn, jfn, x0, jax_dtype=np.float32):
    """Value and gradient against the JAX package's under float32 (its
    value of `jax_dtype`); the port's output float32, the gradient in the
    float64 leaf's dtype and, from a float32 leaf, float32 and equal to it
    rounded.  Returns ``(value, gradient)``."""
    with torch.no_grad():
        w = _weights_for(fn(x0).shape)
    val, g = _port_grad(fn, w, x0)
    jval, jg = _jax_value_grad(jfn, w, x0)
    assert val.dtype == F32 and jval.dtype == jax_dtype
    assert g.dtype == F64 and g.shape == np.shape(x0)
    assert np.all(np.isfinite(g.numpy())) and g.abs().max() > 1e-3
    assert _rel(val.numpy(), jval) <= TOL
    assert _rel(g.numpy(), jg) <= TOL
    _v32, g32 = _port_grad(fn, w, x0, dtype=F32)
    assert g32.dtype == F32 and torch.equal(g32, g.float())
    return val, g


def _differs_from_f64(fn, x0, val, g):
    """The float32 value and gradient are near the float64 ones and not
    those rounded: they were computed in float32."""
    w = _weights_for(val.shape)
    _f64()
    val64, g64 = _port_grad(fn, w, x0)
    pyiga_tpu.set_dtype(np.float32)
    pyiga_tpu_torch.set_dtype(np.float32)
    assert val64.dtype == F64
    assert _rel(val.numpy(), val64.numpy()) <= 1e-5
    assert _rel(g.numpy(), g64.numpy()) <= 1e-4
    assert not torch.equal(val, val64.float())
    assert not torch.equal(g, g64)


################################################################################
# assembly_coeff_fn: Gauss assemblers and compiled forms
################################################################################

@pytest.mark.parametrize('which', ['stiffness', 'mass'])
@pytest.mark.parametrize('geo_name', ['bspline', 'nurbs'])
def test_coeff_fn_f32_matches_jax(geo_name, which):
    jkvs = _jkvs(2, 4)
    jgeo = (jgeometry.bspline_quarter_annulus() if geo_name == 'bspline'
            else jgeometry.quarter_annulus())
    cls, jcls = ASSEMBLERS[which]
    asm = cls(_kvs(jkvs), convert.geometry_from(jgeo), device='cpu')
    fn, coeffs0 = diff.assembly_coeff_fn(asm)
    jfn, _ = jdiff.assembly_coeff_fn(jcls(jkvs, jgeo))
    val, g = _check(fn, jfn, coeffs0)
    assert torch.equal(val, asm.run_device())
    _differs_from_f64(fn, coeffs0, val, g)


@pytest.mark.parametrize('which', ['stiffness', 'mass'])
def test_coeff_fn_f32_3d_matches_jax(which):
    jkvs = _jkvs(2, 3, d=3)
    jgeo = jgeometry.twisted_box()
    cls, jcls = ASSEMBLERS[which]
    asm = cls(_kvs(jkvs), convert.geometry_from(jgeo), device='cpu')
    fn, coeffs0 = diff.assembly_coeff_fn(asm)
    jfn, _ = jdiff.assembly_coeff_fn(jcls(jkvs, jgeo))
    val, _g = _check(fn, jfn, coeffs0)
    assert torch.equal(val, asm.run_device())


def _vform_pair(form, jkvs, jgeo, **args):
    jargs = dict(args, geo=jgeo)
    pargs = {k: convert.geometry_from(v) if hasattr(v, 'coeffs') else v
             for k, v in jargs.items()}
    return (assemble.instantiate_assembler(form, _kvs(jkvs), pargs, None,
                                           None, device='cpu'),
            jassemble.instantiate_assembler(form, jkvs, jargs, None, None))


@pytest.mark.parametrize('form,p', [
    ('inner(grad(u), grad(v)) * dx', 2),
    ('inner(hess(u), hess(v)) * dx', 3)])
def test_vform_coeff_fn_f32_matches_jax(form, p):
    """A compiled form's shape gradient: K1 ``jac``, K5 (and, for the
    Hessian form, its K2 stages) and the chains in float32."""
    jkvs = _jkvs(p, 3 if p == 3 else 4)
    asm, jasm = _vform_pair(form, jkvs, jgeometry.bspline_quarter_annulus())
    fn, coeffs0 = diff.assembly_coeff_fn(asm)
    jfn, _ = jdiff.assembly_coeff_fn(jasm)
    val, g = _check(fn, jfn, coeffs0)
    assert torch.equal(val, asm.run_device()[(None, None)])
    _differs_from_f64(fn, coeffs0, val, g)


################################################################################
# assembly_input_fn: parameters and input fields
################################################################################

CONVDIFF = '(inner(grad(u), grad(v)) + dot(b, grad(u)) * v + u * v) * dx'


@pytest.mark.parametrize('name', ['eps', 'b'])
def test_parameter_grad_f32_matches_jax(name):
    """A scalar and a vector parameter (the flat parameter vector formed
    from the float32 value, its gradient summed over the points)."""
    jkvs = _jkvs(2, 4)
    if name == 'eps':
        form, args = '(eps * inner(grad(u), grad(v)) + u * v) * dx', \
            dict(eps=0.7)
    else:
        form, args = CONVDIFF, dict(b=np.array([3.0, -2.0]))
    asm, jasm = _vform_pair(form, jkvs, jgeometry.quarter_annulus(), **args)
    fn, x0 = diff.assembly_input_fn(asm, name)
    jfn, jx0 = jdiff.assembly_input_fn(jasm, name)
    assert np.array_equal(x0, jx0)
    val, g = _check(fn, jfn, x0)
    assert torch.equal(val, asm.run_device()[(None, None)])
    _differs_from_f64(fn, x0, val, g)


def _cfun(jkvs, f):
    return jgeometry.BSplineFunc(jkvs, np.asarray(
        japprox.interpolate(jkvs, f)))


@pytest.mark.parametrize('form,f', [
    ('c * inner(grad(u), grad(v)) * dx', lambda x, y: 1.0 + x * y),
    ('dot(grad(c), grad(u)) * v * dx', lambda x, y: x * x + 0.5 * y)])
def test_input_field_grad_f32_matches_jax(form, f):
    """The coefficient knob: the input's values and first derivatives from
    float32 collocation tables.  The JAX package's input path does not
    cast the coefficients (``tp_apply`` on its float64 collocation tables,
    ``pyiga_tpu/diff.py:240-247``), so its value comes out in float64
    there; the port casts them to the compute dtype as its geometry and
    parameter paths do, and stays in float32."""
    jkvs = _jkvs(2, 4)
    asm, jasm = _vform_pair(form, jkvs, jgeometry.quarter_annulus(),
                            c=_cfun(jkvs, f))
    fn, x0 = diff.assembly_input_fn(asm, 'c')
    jfn, jx0 = jdiff.assembly_input_fn(jasm, 'c')
    assert x0.shape == jx0.shape
    val, g = _check(fn, jfn, x0, jax_dtype=np.float64)
    ref = asm.run_device()[(None, None)]
    assert _rel(val.numpy(), ref.numpy()) <= TOL
    _differs_from_f64(fn, x0, val, g)


################################################################################
# implicit_cg_solve through a float32 operator
################################################################################

def test_implicit_cg_solve_f32_matches_jax():
    """The shape gradient of a compliance through one float32 CG and its
    adjoint solve, against the JAX package's ``implicit_cg_solve`` on its
    float32 operator, and the dense float32 solve."""
    jkvs = _jkvs(2, 4)
    jgeo = jgeometry.bspline_quarter_annulus()
    asm = StiffnessAssembler(_kvs(jkvs), convert.geometry_from(jgeo),
                             device='cpu')
    fn, coeffs0 = diff.assembly_coeff_fn(asm)
    jfn, _ = jdiff.assembly_coeff_fn(JStiffness(jkvs, jgeo))
    N = int(np.prod([kv.numdofs for kv in asm.kvs]))
    free = interior_dofs(asm.kvs)
    I, J = (ix.astype(np.int64) for ix in asm.structure.nonzero())
    f = np.random.RandomState(3).rand(len(free)).astype(np.float32)
    ft = torch.as_tensor(f)

    def operator(c):
        data = fn(c)
        A = torch.zeros((N, N), dtype=data.dtype).index_put(
            (torch.as_tensor(I), torch.as_tensor(J)), data.reshape(-1))
        return A[torch.as_tensor(free)][:, torch.as_tensor(free)]

    def value_grad(solve):
        c = torch.tensor(coeffs0, requires_grad=True)
        v = torch.dot(ft, solve(operator(c)))
        g, = torch.autograd.grad(v, c)
        return v.detach(), g

    v_c, g_c = value_grad(lambda A: diff.implicit_cg_solve(
        lambda x: A @ x, ft, tol=1e-6))
    v_d, g_d = value_grad(lambda A: torch.linalg.solve(A, ft))
    assert v_c.dtype == F32 and g_c.dtype == F64
    assert float(v_c) == pytest.approx(float(v_d), rel=TOL)
    assert _rel(g_c.numpy(), g_d.numpy()) <= 1e-4

    def jobj(c):
        data = jfn(c)
        A = jnp.zeros((N, N), dtype=data.dtype).at[I, J].set(
            data.reshape(-1))[np.ix_(free, free)]
        u = jdiff.implicit_cg_solve(lambda x: A @ x, jnp.asarray(f),
                                    tol=1e-6)
        return jnp.dot(jnp.asarray(f), u)

    jv, jg = jax.value_and_grad(jobj)(jnp.asarray(coeffs0))
    assert np.asarray(jv).dtype == np.float32
    assert float(v_c) == pytest.approx(float(jv), rel=TOL)
    assert _rel(g_c.numpy(), np.asarray(jg)) <= TOL


################################################################################
# the float32 backwards' plain versions against autograd
################################################################################

def _r(rng, *shape):
    return torch.tensor(rng.rand(*shape) + 0.5, dtype=F32)


@pytest.mark.parametrize('kind,d,G', [
    ('stiffness', 2, 2), ('stiffness', 3, 3), ('mass', 2, 2), ('mass', 3, 3),
    ('jac', 2, 2), ('jac', 3, 3), ('jac', 2, 3), ('jac', 1, 2)])
@pytest.mark.parametrize('nurbs', [False, True])
def test_fields_bwd_f32_plain_matches_autograd(kind, d, G, nurbs):
    """K1's float32 backward formulas (the CPU branch of its Function)
    against autograd of the plain float32 forward: float32 throughout,
    and not the float64 gradient rounded."""
    rng = np.random.RandomState(d * 10 + G + 100 * nurbs)
    C = G + int(nurbs)
    Q12, QL, nL = (1, 5, 4) if d == 1 else (7, 5, 3)
    Y, T = _r(rng, d, C, Q12, nL), _r(rng, 2, QL, nL)
    w12, wL = _r(rng, Q12), _r(rng, QL)

    def forward(Y, T, w12, wL):
        if kind == 'jac':
            return cuda_sumfac.geo_jac_fields_plain(Y, T, nurbs)
        if kind == 'mass':
            return cuda_sumfac.fields_mass_plain(Y, T, w12, wL, nurbs)
        return cuda_sumfac.fields_plain(Y, T, w12, wL, nurbs)

    Yg = Y.clone().requires_grad_(True)
    out = forward(Yg, T, w12, wL)
    g = _r(rng, *out.shape) - 1.0
    ref, = torch.autograd.grad(out, Yg, g)
    got = cuda_sumfac.fields_bwd(kind, Y, T, w12, wL, nurbs, g)
    assert got.dtype == ref.dtype == F32 and got.shape == Y.shape
    assert _rel(got.numpy(), ref.numpy()) <= TOL
    got64 = cuda_sumfac.fields_bwd(kind, Y.double(), T.double(),
                                   w12.double(), wL.double(), nurbs,
                                   g.double())
    # near the float64 gradient (random points: the Jacobian's condition
    # number amplifies float32 rounding) and not it rounded
    assert _rel(got.numpy(), got64.numpy()) <= 1e-2
    assert not torch.equal(got, got64.float())


def test_stage_and_fold_bwd_f32_plain_matches_autograd():
    """K2's and K3's float32 backwards (17 terms, tables shared) against
    autograd of the plain float32 forwards, the products in full
    float32."""
    rng = np.random.RandomState(7)
    X, T = _r(rng, 6, 9), _r(rng, 4, 6)
    g = _r(rng, 9, 4)
    Xg = X.clone().requires_grad_(True)
    got, = torch.autograd.grad(cuda_sumfac.stage(Xg, T), Xg, g)
    assert got.dtype == F32
    assert torch.equal(got, cuda_sumfac.stage_bwd(T, g))
    Xp = X.clone().requires_grad_(True)
    ref, = torch.autograd.grad(cuda_sumfac.stage_plain(Xp, T), Xp, g)
    assert _rel(got.numpy(), ref.numpy()) <= 1e-6
    xs = [_r(rng, 6, 9).requires_grad_(True) for _ in range(17)]
    tabs = [_r(rng, 4, 6) for _ in range(3)]
    idx = [t % 3 if t < 9 else 1 for t in range(17)]
    gs = torch.autograd.grad(cuda_sumfac.fold(xs, tabs, idx), xs, g)
    xp = [x.detach().clone().requires_grad_(True) for x in xs]
    rs = torch.autograd.grad(cuda_sumfac.fold_plain(xp, tabs, idx), xp, g)
    for a, b, i in zip(gs, rs, idx):
        assert a.dtype == F32 and _rel(a.numpy(), b.numpy()) <= 1e-6
        assert torch.equal(a, gs[idx.index(i)])   # shared per table


ADJOINT_FORMS = {
    'convdiff': (CONVDIFF, {'b': np.array([3.0, -2.0])}),
    'funcs': ('(sqrt(c) + exp(c) + log(c) + sin(c) + cos(c) + tan(0.3 * c)'
              ' + abs(c - 1.2)) * inner(grad(u), grad(v)) * dx',
              {'c': 'spline'}),
    'hessian': ('inner(hess(u), hess(v)) * dx', {}),
}


@pytest.mark.parametrize('name', sorted(ADJOINT_FORMS))
def test_adjoint_program_f32_matches_autograd(name):
    """The float32 K5 adjoint program run in torch ops (the plain version
    of the generated ``vform_adjoint_f32`` kernel) against autograd of
    the float32 ``run_program_plain`` on the same operands."""
    form, args = ADJOINT_FORMS[name]
    kvs = _kvs(_jkvs(3 if name == 'hessian' else 2, 4))
    if args.get('c') == 'spline':
        args = dict(c=geometry.BSplineFunc(kvs, np.asarray(
            approx.interpolate(kvs, lambda x, y: 1.0 + 0.3 * x * y))))
    asm = assemble.instantiate_assembler(
        form, kvs, dict(args, geo=geometry.quarter_annulus()), None, None,
        device='cpu')
    arrays = asm.device_arrays()
    prog = asm._program(asm.combos, F32)
    adj = prog.adjoint()
    assert adj.dtype == adj.program.dtype == F32
    assert adj.counter == 'vform_adjoint_f32'
    assert adj is not asm._program(asm.combos, F64).adjoint()
    leaves = {k: arrays[k].clone().requires_grad_(True)
              for k in prog.sources}
    params = arrays['params'].clone().requires_grad_(True)
    out = cuda_vform.run_program_plain(prog, dict(arrays, params=params,
                                                  **leaves))
    assert out.dtype == F32
    grid = tuple(w.shape[0] for w in arrays['weights'])
    g = torch.as_tensor(np.random.RandomState(1).rand(*out.shape) - 0.5,
                        dtype=F32)
    refs = torch.autograd.grad(out, list(leaves.values()) + [params], g,
                               allow_unused=True)
    grads, gp = cuda_vform.run_adjoint_plain(
        prog, arrays, g.reshape((len(prog.outputs),) + grid))
    for key, ref in zip(leaves, refs):
        ref = torch.zeros_like(grads[key]) if ref is None else ref
        assert grads[key].dtype == F32
        assert ref.abs().max() == 0 or \
            _rel(grads[key].numpy(), ref.numpy()) <= TOL
    if prog.params:
        assert gp.dtype == F32 and _rel(gp.numpy(), refs[-1].numpy()) <= TOL
    src = adj.source
    assert 'double' not in src and 'vform_adjoint_kernel' in src
