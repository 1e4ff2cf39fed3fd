"""Forward mode and second derivatives through the port's differentiable
assembly (``pyiga_tpu_torch.diff``), held against ``pyiga_tpu.diff`` on
the CPU: the same seeded numpy inputs through both, ``torch.func.jvp``
and ``torch.autograd.forward_ad`` against ``jax.jvp``, ``torch.func.
jacfwd`` against ``jax.jacfwd``, forward-over-reverse and
``create_graph`` Hessian-vector products against ``jax.jvp(jax.grad)``,
``torch.func.hessian`` against ``jax.hessian``, and
``implicit_cg_solve``'s tangent against ``custom_linear_solve``'s: 1e-12
relative in float64, 2e-5 under ``set_dtype(np.float32)``.

Beside them the plain versions of the new kernels against
``torch.func.jvp`` of the existing plain forward or backward (1e-13):
K1-jvp against K1's, K1-hvp against K1-bwd's, K5's tangent program
against the program's run and the form's evaluation, K5's second-order
program against the adjoint's run.  And the Functions' rules through the
wrappers' CUDA branch on CPU tensors (the device tests forced): K1,
K1-jvp, K1-hvp, K2, K3 and K2-bwd through a stand-in for the library
entries that computes from the pointers it is handed, K5's programs
through their plain runs; ``vmap`` of ``jvp`` (``jacfwd``) launches each
kernel once a member of the batch."""

import contextlib
import ctypes
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pyiga_tpu
import pyiga_tpu.geometry as jgeometry
from pyiga_tpu import assemble as jassemble
from pyiga_tpu import diff as jdiff
from pyiga_tpu.assemblers import MassAssembler as JMass
from pyiga_tpu.assemblers import StiffnessAssembler as JStiffness
from pyiga_tpu.bspline import make_knots as jmake_knots

import pyiga_tpu_torch
from pyiga_tpu_torch import _cuda, assemble, convert, diff
from pyiga_tpu_torch.assemblers import MassAssembler, StiffnessAssembler
from pyiga_tpu_torch.ops import cuda_sumfac, cuda_vform

torch.set_num_threads(1)

F64, F32 = torch.float64, torch.float32
CONVDIFF = '(inner(grad(u), grad(v)) + dot(b, grad(u)) * v + u * v) * dx'
NONLINEAR = '(1 + w*w) * inner(grad(w), grad(v)) * dx'
ASSEMBLERS = {'mass': (MassAssembler, JMass),
              'stiffness': (StiffnessAssembler, JStiffness)}


def _rel(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _jkvs(p, n, d=2):
    return d * (jmake_knots(p, 0.0, 1.0, n),)


def _kvs(jkvs):
    return tuple(convert.knot_vector(kv) for kv in jkvs)


def _jgeo(name):
    if name == 'nurbs_3d':      # the quarter annulus extruded
        return jgeometry.tensor_product(jgeometry.line_segment(0.0, 1.0),
                                        jgeometry.quarter_annulus())
    return {'bspline': jgeometry.bspline_quarter_annulus,
            'nurbs': jgeometry.quarter_annulus,
            'box': jgeometry.twisted_box}[name]()


def _gauss_pair(which, geo, p=2, n=3):
    d = 3 if geo in ('box', 'nurbs_3d') else 2
    jkvs = _jkvs(p, n, d)
    cls, jcls = ASSEMBLERS[which]
    jgeo = _jgeo(geo)
    asm = cls(_kvs(jkvs), convert.geometry_from(jgeo), device='cpu')
    fn, x0 = diff.assembly_coeff_fn(asm)
    jfn, _ = jdiff.assembly_coeff_fn(jcls(jkvs, jgeo), mode='exact')
    return fn, jfn, x0


def _vform_pair(form, jkvs, jgeo, **args):
    jargs = dict(args, geo=jgeo)
    pargs = {k: convert.geometry_from(v) if hasattr(v, 'coeffs') else v
             for k, v in jargs.items()}
    return (assemble.instantiate_assembler(form, _kvs(jkvs), pargs, None,
                                           None, device='cpu'),
            jassemble.instantiate_assembler(form, jkvs, jargs, None, None))


def _convdiff_pair():
    asm, jasm = _vform_pair(CONVDIFF, _jkvs(2, 3), _jgeo('nurbs'),
                            b=np.array([3.0, -2.0]))
    fn, x0 = diff.assembly_coeff_fn(asm)
    jfn, _ = jdiff.assembly_coeff_fn(jasm, mode='exact')
    return fn, jfn, x0


PARAM_FORM = 'eps * (1 + dot(b, b)) * inner(grad(u), grad(v)) * dx'


def _input_pair(name='w'):
    """``(1 + w²) grad(w).grad(v) dx`` (a vector form of one argument)
    in its spline input `w`; convection-diffusion in its parameter ``b``
    (the data linear in it); ``eps (1 + b.b) grad(u).grad(v) dx`` in its
    parameter ``b`` ('b2', nonlinear in it)."""
    jkvs = _jkvs(2, 3)
    if name == 'b':
        asm, jasm = _vform_pair(CONVDIFF, jkvs, _jgeo('nurbs'),
                                b=np.array([3.0, -2.0]))
    elif name == 'b2':
        asm, jasm = _vform_pair(PARAM_FORM, jkvs, _jgeo('nurbs'), eps=0.7,
                                b=np.array([0.5, -1.5]))
        name = 'b'
    else:
        coeffs = 0.3 * np.random.RandomState(5).rand(5, 5)
        asm, jasm = _vform_pair(NONLINEAR, jkvs, _jgeo('nurbs'),
                                w=jgeometry.BSplineFunc(jkvs, coeffs))
    fn, x0 = diff.assembly_input_fn(asm, name)
    jfn, _ = jdiff.assembly_input_fn(jasm, name)
    return fn, jfn, x0


PAIRS = {
    'mass_2d_bspline': lambda: _gauss_pair('mass', 'bspline'),
    'mass_2d_nurbs': lambda: _gauss_pair('mass', 'nurbs'),
    'stiffness_2d_bspline': lambda: _gauss_pair('stiffness', 'bspline'),
    'stiffness_2d_nurbs': lambda: _gauss_pair('stiffness', 'nurbs'),
    'mass_3d': lambda: _gauss_pair('mass', 'box', n=2),
    'stiffness_3d': lambda: _gauss_pair('stiffness', 'box', n=2),
    'stiffness_3d_nurbs': lambda: _gauss_pair('stiffness', 'nurbs_3d',
                                              n=2),
    'convdiff_coeffs': _convdiff_pair,
    'nonlinear_input_w': _input_pair,
    'convdiff_param_b': lambda: _input_pair('b'),
    'param_b_nonlinear': lambda: _input_pair('b2'),
}


def _direction(x0, seed=1):
    v = np.random.RandomState(seed).rand(*np.shape(x0)) - 0.5
    return v / np.abs(v).max()


def _weights(shape, seed=42):
    return np.random.RandomState(seed).rand(*shape)


def _t(x, dtype=F64):
    return torch.as_tensor(np.asarray(x, dtype=float), dtype=dtype)


def _j(x):
    return jnp.asarray(np.asarray(x, dtype=float))


################################################################################
# against the JAX package
################################################################################

@pytest.mark.parametrize('case', sorted(PAIRS))
def test_jvp_and_forward_ad_match_jax(case):
    """The tangent of the assembled data along a seeded direction:
    ``torch.func.jvp`` and a ``forward_ad`` dual tensor (which need not
    require grad) against ``jax.jvp``; the values against JAX's too."""
    fn, jfn, x0 = PAIRS[case]()
    v = _direction(x0)
    val, tan = torch.func.jvp(fn, (_t(x0),), (_t(v),))
    with torch.autograd.forward_ad.dual_level():
        dual = fn(torch.autograd.forward_ad.make_dual(_t(x0), _t(v)))
        dtan = torch.autograd.forward_ad.unpack_dual(dual).tangent
    jval, jtan = jax.jvp(jfn, (_j(x0),), (_j(v),))
    assert _rel(val, jval) < 1e-13
    assert np.abs(np.asarray(jtan)).max() > 1e-6
    assert _rel(tan, jtan) < 1e-12
    assert torch.equal(dtan, tan)


@pytest.mark.parametrize('case', ['mass_2d_bspline', 'stiffness_2d_nurbs',
                                  'convdiff_coeffs', 'nonlinear_input_w',
                                  'convdiff_param_b'])
def test_jacfwd_matches_jax(case):
    """``torch.func.jacfwd`` (``vmap`` of ``jvp``) of the assembled data
    against ``jax.jacfwd``."""
    fn, jfn, x0 = PAIRS[case]()
    jac = torch.func.jacfwd(fn)(_t(x0))
    jjac = jax.jacfwd(jfn)(_j(x0))
    assert jac.shape == np.shape(jjac)
    assert _rel(jac, jjac) < 1e-12


@pytest.mark.parametrize('case', sorted(set(PAIRS) - {'convdiff_param_b'}))
def test_hvp_matches_jax(case):
    """The Hessian of ``sum(w * fn(x))`` applied to a seeded direction, by
    forward over reverse (``torch.func.jvp`` of ``torch.func.grad``) and
    by reverse over reverse (``create_graph``), against
    ``jax.jvp(jax.grad)`` (convection-diffusion's data is linear in ``b``:
    its Hessian is zero, so a parameter enters nonlinearly instead)."""
    fn, jfn, x0 = PAIRS[case]()
    with torch.no_grad():
        w = _weights(fn(_t(x0)).shape)
    v = _direction(x0, seed=2)

    def obj(c):
        return (_t(w) * fn(c)).sum()
    fwd = torch.func.jvp(torch.func.grad(obj), (_t(x0),), (_t(v),))[1]
    x = _t(x0).requires_grad_(True)
    g, = torch.autograd.grad(obj(x), x, create_graph=True)
    rev, = torch.autograd.grad((g * _t(v)).sum(), x)
    jhv = jax.jvp(jax.grad(lambda c: jnp.sum(_j(w) * jfn(c))), (_j(x0),),
                  (_j(v),))[1]
    assert np.abs(np.asarray(jhv)).max() > 1e-8
    assert _rel(fwd, jhv) < 1e-12
    assert _rel(rev, jhv) < 1e-12


def test_hessian_matches_jax():
    """``torch.func.hessian`` (``jacfwd`` over ``jacrev``) of a 2D p=2
    mass objective against ``jax.hessian``."""
    fn, jfn, x0 = _gauss_pair('mass', 'nurbs', n=2)
    with torch.no_grad():
        w = _weights(fn(_t(x0)).shape)
    H = torch.func.hessian(lambda c: (_t(w) * fn(c)).sum())(_t(x0))
    jH = jax.hessian(lambda c: jnp.sum(_j(w) * jfn(c)))(_j(x0))
    assert H.shape == np.shape(jH)
    assert _rel(H, jH) < 1e-12


def _spd(n, seed):
    rng = np.random.RandomState(seed)
    Q = rng.rand(n, n)
    return Q @ Q.T + n * np.eye(n), rng.rand(n)


def test_implicit_cg_solve_tangent_matches_custom_linear_solve():
    """The tangent of ``A(s)^-1 b(s)`` along ``s`` through
    ``implicit_cg_solve`` (one solve of ``db - dA x``) against the JAX
    package's ``custom_linear_solve``, by ``torch.func.jvp``, by a
    ``forward_ad`` dual that does not require grad (the guard must see
    its tangent) and by ``jacfwd`` (the solve once a member of the
    batch)."""
    A0, b0 = _spd(12, 0)
    A1, b1 = _spd(12, 1)

    def solve(s):
        A = _t(A0) + s[0] * _t(A1)
        return diff.implicit_cg_solve(lambda x: A @ x, _t(b0) + s[1] * _t(b1),
                                      tol=1e-14)

    def jsolve(s):
        A = _j(A0) + s[0] * _j(A1)
        return jdiff.implicit_cg_solve(lambda x: A @ x,
                                       _j(b0) + s[1] * _j(b1), tol=1e-14)
    s0, ds = np.array([0.3, 0.7]), np.array([1.0, -0.5])
    x, tan = torch.func.jvp(solve, (_t(s0),), (_t(ds),))
    jx, jtan = jax.jvp(jsolve, (_j(s0),), (_j(ds),))
    assert _rel(x, jx) < 1e-12 and _rel(tan, jtan) < 1e-12
    with torch.autograd.forward_ad.dual_level():
        s = torch.autograd.forward_ad.make_dual(_t(s0), _t(ds))
        assert not s.requires_grad
        dtan = torch.autograd.forward_ad.unpack_dual(solve(s)).tangent
    assert dtan is not None and _rel(dtan, jtan) < 1e-12
    jac = torch.func.jacfwd(solve)(_t(s0))
    assert _rel(jac, jax.jacfwd(jsolve)(_j(s0))) < 1e-12


def test_implicit_cg_solve_second_derivative_matches_jax():
    """A second derivative through the solve: the Hessian of ``w^T
    A(s)^-1 b(s)`` (the adjoint solve is ``implicit_cg_solve`` again) by
    ``torch.func.hessian`` and by ``create_graph``, against
    ``jax.hessian`` through ``custom_linear_solve``."""
    A0, b0 = _spd(10, 2)
    A1, b1 = _spd(10, 3)
    w = np.random.RandomState(4).rand(10)

    def obj(s):
        A = _t(A0) + s[0] ** 2 * _t(A1)
        x = diff.implicit_cg_solve(lambda y: A @ y, _t(b0) + s[1] * _t(b1),
                                   tol=1e-14)
        return torch.dot(_t(w), x)

    def jobj(s):
        A = _j(A0) + s[0] ** 2 * _j(A1)
        x = jdiff.implicit_cg_solve(lambda y: A @ y, _j(b0) + s[1] * _j(b1),
                                    tol=1e-14)
        return jnp.dot(_j(w), x)
    s0 = np.array([0.8, 0.4])
    jH = jax.hessian(jobj)(_j(s0))
    assert _rel(torch.func.hessian(obj)(_t(s0)), jH) < 1e-12
    s = _t(s0).requires_grad_(True)
    g, = torch.autograd.grad(obj(s), s, create_graph=True)
    H = torch.stack([torch.autograd.grad(g[i], s, retain_graph=True)[0]
                     for i in range(2)])
    assert _rel(H, jH) < 1e-12


@pytest.fixture
def float32_line():
    pyiga_tpu.set_dtype(np.float32)
    pyiga_tpu_torch.set_dtype(np.float32)
    yield
    pyiga_tpu.set_dtype(np.float64)
    pyiga_tpu_torch.set_dtype(np.float64)


@pytest.mark.parametrize('case', ['stiffness_2d_nurbs', 'mass_3d',
                                  'convdiff_coeffs', 'nonlinear_input_w'])
def test_f32_jvp_and_hvp_match_jax(float32_line, case):
    """Under ``set_dtype(np.float32)`` (both packages): the tangent and
    the forward-over-reverse HVP against JAX's float32 ones (2e-5), the
    tangent in float32."""
    fn, jfn, x0 = PAIRS[case]()
    v = _direction(x0)
    _val, tan = torch.func.jvp(fn, (_t(x0),), (_t(v),))
    jtan = jax.jvp(jfn, (_j(x0),), (_j(v),))[1]
    assert tan.dtype == F32 and _rel(tan, jtan) < 2e-5
    with torch.no_grad():
        w = _weights(fn(_t(x0)).shape)
    hv = torch.func.jvp(torch.func.grad(
        lambda c: (_t(w, F32) * fn(c)).sum()), (_t(x0),), (_t(v),))[1]
    jhv = jax.jvp(jax.grad(lambda c: jnp.sum(
        jnp.asarray(w, dtype=jnp.float32) * jfn(c))), (_j(x0),),
        (_j(v),))[1]
    assert _rel(hv, jhv) < 2e-5


################################################################################
# the plain versions of the new kernels against torch.func.jvp
################################################################################

def _r(rng, *shape):
    return torch.tensor(rng.rand(*shape) + 0.5)


@pytest.mark.parametrize('kind,d,G', [
    ('stiffness', 2, 2), ('stiffness', 3, 3), ('mass', 2, 2), ('mass', 3, 3),
    ('jac', 2, 2), ('jac', 3, 3), ('jac', 2, 3), ('jac', 1, 1),
    ('jac', 1, 2)])
@pytest.mark.parametrize('nurbs', [False, True])
def test_fields_jvp_hvp_plain_match_torch_jvp(kind, d, G, nurbs):
    """K1-jvp's plain version (the transpose of K1-bwd's plain formulas)
    against ``torch.func.jvp`` of K1's plain forward, K1-hvp's against
    ``torch.func.jvp`` of those formulas (1e-13), at ragged shapes; and
    K1-hvp's against reverse over reverse of them (the Hessian is
    symmetric; 1e-12: the two orders round apart at 1e-13 on the 3D
    NURBS stiffness)."""
    rng = np.random.RandomState(d * 10 + G + 100 * nurbs)
    C = G + int(nurbs)
    Y, T = _r(rng, d, C, 7, 3), _r(rng, 2, 5, 3)
    w12, wL = (None, None) if kind == 'jac' else (_r(rng, 7), _r(rng, 5))
    dY = _r(rng, *Y.shape) - 1.0
    fwd = {'stiffness': lambda y: cuda_sumfac.fields_plain(
               y, T, w12, wL, nurbs),
           'mass': lambda y: cuda_sumfac.fields_mass_plain(
               y, T, w12, wL, nurbs),
           'jac': lambda y: cuda_sumfac.geo_jac_fields_plain(y, T, nurbs)}
    ref = torch.func.jvp(fwd[kind], (Y,), (dY,))[1]
    got = cuda_sumfac.fields_jvp_plain(kind, Y, T, w12, wL, nurbs, dY)
    assert got.shape == ref.shape and _rel(got, ref) < 1e-13
    g = _r(rng, *ref.shape) - 1.0
    ref = torch.func.jvp(lambda y: cuda_sumfac._fields_vjp_plain(
        kind, y, T, w12, wL, nurbs, g), (Y,), (dY,))[1]
    got = cuda_sumfac.fields_hvp_plain(kind, Y, T, w12, wL, nurbs, g, dY)
    assert got.shape == Y.shape
    if kind == 'jac' and not nurbs:         # linear: no second derivative
        assert not got.any() and not ref.any()
    else:
        assert _rel(got, ref) < 1e-13
        _out, vjp = torch.func.vjp(lambda y: cuda_sumfac._fields_vjp_plain(
            kind, y, T, w12, wL, nurbs, g), Y)
        assert _rel(got, vjp(dY)[0]) < 1e-12


K5_FORMS = {
    'convdiff': (CONVDIFF, {'b': np.array([3.0, -2.0])}),
    'funcs': ('(sqrt(c) + exp(c) + log(c) + sin(c) + cos(c) + tan(0.3 * c)'
              ' + abs(c - 1.2)) * inner(grad(u), grad(v)) * dx',
              {'c': 'spline'}),
    'gradc': ('dot(grad(c), grad(u)) * v * dx', {'c': 'spline'}),
    'hessian': ('inner(hess(u), hess(v)) * dx', {}),
    'nonlinear': ('(1 + c*c) * inner(grad(c), grad(v)) * dx',
                  {'c': 'spline'}),
    'param': ('eps * (1 + dot(b, b)) * inner(grad(u), grad(v)) * dx',
              {'eps': 0.7, 'b': np.array([0.5, -1.5])}),
}


def _k5_case(name, seed=0):
    """A form's fold-plan program at 2D n=4 on its CPU operands, and
    seeded tangents of every source and of the parameters."""
    from pyiga_tpu_torch import bspline, geometry
    form, args = K5_FORMS[name]
    p = 3 if name == 'hessian' else 2
    kvs = 2 * (bspline.make_knots(p, 0.0, 1.0, 4),)
    rng = np.random.RandomState(seed)
    args = {k: (geometry.BSplineFunc(kvs, 1.0 + rng.rand(
        *[kv.numdofs for kv in kvs])) if isinstance(v, str) else v)
        for k, v in args.items()}
    asm = assemble.instantiate_assembler(
        form, kvs, dict(args, geo=geometry.quarter_annulus()), None, None,
        device='cpu')
    plan = asm._fold_plan or [(t, False) for t in range(len(asm.combos))]
    combos = [asm.combos[t] for t, _m in plan]
    prog = asm._program(combos)
    arrays = asm.device_arrays()
    tans = {k: torch.as_tensor(rng.rand(*arrays[k].shape) - 0.5)
            for k in prog.sources}
    if 'geo_hess_lvl' in tans:      # the Hessian's tangent is symmetric
        h = tans['geo_hess_lvl']
        tans['geo_hess_lvl'] = 0.5 * (h + h.transpose(1, 2))
    if prog.params:
        tans['params'] = torch.as_tensor(rng.rand(*arrays['params'].shape)
                                         - 0.5)
    mask = (True,) * (len(prog.sources) + int(bool(prog.params)))
    return asm, combos, prog, arrays, tans, mask


def _with(arrays, prog, xs):
    """`arrays` with the program's sources (and parameters) from `xs`."""
    keys = list(prog.sources) + ['params'] * bool(prog.params)
    return dict(arrays, **dict(zip(keys, xs)))


@pytest.mark.parametrize('name', sorted(K5_FORMS))
def test_k5_tangent_and_second_plain_match_torch_jvp(name):
    """K5's tangent program (run with torch ops: its plain version)
    against ``torch.func.jvp`` of the program's run and of the form's own
    evaluation (``combo_fields_plain``), and the second-order program
    against ``torch.func.jvp`` of the adjoint's run, the output's
    gradient held (1e-13).  A mask without the geometry's tangent drops
    its leaves from the tangent program."""
    asm, combos, prog, arrays, tans, mask = _k5_case(name)
    keys = list(prog.sources) + ['params'] * bool(prog.params)
    xs = tuple(arrays[k] for k in keys)
    ds = tuple(tans[k] for k in keys)
    got = cuda_vform.run_tangent_plain(prog, mask, arrays, tans)
    ref = torch.func.jvp(lambda *a: cuda_vform.run_program_plain(
        prog, _with(arrays, prog, a)), xs, ds)[1]
    assert _rel(got, ref) < 1e-13
    # the form's evaluation reads the parameters from their own arrays:
    # held to the sources' tangents alone
    n = len(prog.sources)
    ref2 = torch.func.jvp(lambda *a: torch.stack(
        cuda_vform.combo_fields_plain(asm, _with(arrays, prog, a), combos)),
        xs[:n], ds[:n])[1]
    src_mask = (True,) * n + (False,) * bool(prog.params)
    got2 = cuda_vform.run_tangent_plain(prog, src_mask, arrays, tans)
    assert _rel(got2, ref2.reshape(got2.shape)) < 1e-13
    grid = tuple(w.shape[0] for w in arrays['weights'])
    g = torch.as_tensor(np.random.RandomState(9).rand(
        len(prog.outputs), *grid) - 0.5)

    def adjoint(*a):
        grads, gp = cuda_vform.run_adjoint_plain(prog, _with(arrays, prog, a),
                                                 g)
        return tuple(grads[k] for k in prog.sources) + (
            (gp,) if gp is not None else ())
    ref = torch.func.jvp(adjoint, xs, ds)[1]
    grads, gp = cuda_vform.run_second_plain(prog, mask, arrays, g, tans)
    got = [grads[k] for k in prog.sources] + ([gp] if gp is not None
                                              else [])
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        assert (not b.any() and not a.any()) or _rel(a, b) < 1e-13
    second = prog.second(mask)
    assert 'vform_adjoint_kernel' in second.source
    assert 'atomicAdd' not in second.source
    no_geo = tuple(not k.startswith('geo_') for k in keys)
    leaves = [k for k in prog.tangent(no_geo).leaves if k[0] == 'tan']
    assert all(not k[1][0].startswith('geo_') for k in leaves)


################################################################################
# the Functions' rules through the CUDA branch (device tests forced)
################################################################################

def _arr(ptr, *shape):
    buf = (ctypes.c_double * int(np.prod(shape))).from_address(ptr)
    return torch.from_numpy(np.ctypeslib.as_array(buf).reshape(shape))


def _field_shape(name, d, G, Q12, QL):
    return {'stiffness': (d * (d + 1) // 2, Q12, QL), 'mass': (Q12, QL),
            'jac': (G + G * d, Q12, QL)}[name]


class _FakeLibrary:
    """The float64 entries of K1 (stiffness, mass), K1-jvp, K1-hvp, K2,
    K3 and their backward on host memory, each a plain version on the
    arrays behind the pointers it is handed (the C entries' argument
    order); records each call's name."""

    def __init__(self):
        self.calls = []

    def _fields(self, name, plain, Y, T, w12, wL, out, d, nurbs, Q12, QL,
                nL):
        self.calls.append(name)
        C = d + nurbs
        _arr(out, *_field_shape(name, d, d, Q12, QL))[...] = plain(
            _arr(Y, d, C, Q12, nL), _arr(T, 2, QL, nL), _arr(w12, Q12),
            _arr(wL, QL), bool(nurbs))
        return 0

    def pyiga_stiff_fields_f64(self, *a):
        return self._fields('stiffness', cuda_sumfac.fields_plain, *a[:-1])

    def pyiga_mass_fields_f64(self, *a):
        return self._fields('mass', cuda_sumfac.fields_mass_plain, *a[:-1])

    def pyiga_geo_jac_fields_f64(self, Y, T, out, d, G, nurbs, Q12, QL, nL,
                                 stream):
        self.calls.append('jac')
        C = G + nurbs
        _arr(out, G + G * d, Q12, QL)[...] = cuda_sumfac.geo_jac_fields_plain(
            _arr(Y, d, C, Q12, nL), _arr(T, 2, QL, nL), bool(nurbs))
        return 0

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

    def _operands(self, kind, Y, T, w12, wL, d, G, nurbs, Q12, QL, nL):
        name = ('stiffness', 'mass', 'jac')[kind]
        C = G + nurbs
        w = ((None, None) if name == 'jac'
             else (_arr(w12, Q12), _arr(wL, QL)))
        return name, C, (_arr(Y, d, C, Q12, nL), _arr(T, 2, QL, nL), *w,
                         bool(nurbs))

    def pyiga_fields_bwd_f64(self, kind, Y, T, w12, wL, g, gY, d, G, nurbs,
                             Q12, QL, nL, stream):
        name, C, ops = self._operands(kind, Y, T, w12, wL, d, G, nurbs, Q12,
                                      QL, nL)
        self.calls.append('fields_bwd_' + name)
        _arr(gY, d, C, Q12, nL)[...] = cuda_sumfac._fields_vjp_plain(
            name, *ops, _arr(g, *_field_shape(name, d, G, Q12, QL)))
        return 0

    def pyiga_fields_jvp_f64(self, kind, Y, T, w12, wL, dY, out, d, G,
                             nurbs, Q12, QL, nL, stream):
        name, C, ops = self._operands(kind, Y, T, w12, wL, d, G, nurbs, Q12,
                                      QL, nL)
        self.calls.append('fields_jvp_' + name)
        _arr(out, *_field_shape(name, d, G, Q12, QL))[...] = \
            cuda_sumfac.fields_jvp_plain(name, *ops,
                                         _arr(dY, d, C, Q12, nL))
        return 0

    def pyiga_fields_hvp_f64(self, kind, Y, T, w12, wL, g, dY, gY, d, G,
                             nurbs, Q12, QL, nL, stream):
        name, C, ops = self._operands(kind, Y, T, w12, wL, d, G, nurbs, Q12,
                                      QL, nL)
        self.calls.append('fields_hvp_' + name)
        _arr(gY, d, C, Q12, nL)[...] = cuda_sumfac.fields_hvp_plain(
            name, *ops, _arr(g, *_field_shape(name, d, G, Q12, QL)),
            _arr(dY, d, C, Q12, nL))
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors: the device tests forced,
    the library replaced by :class:`_FakeLibrary`, K5's programs (forward,
    adjoint, tangent, second-order) run by their plain runs."""
    lib = _FakeLibrary()
    monkeypatch.setattr(cuda_sumfac, '_kernel_device', lambda t, n: True)
    monkeypatch.setattr(cuda_vform, '_on_card', lambda t, n=None: True)
    monkeypatch.setattr(_cuda, 'library', lambda: lib)
    monkeypatch.setattr(_cuda, 'require', lambda *a: None)
    monkeypatch.setattr(_cuda, 'device_of',
                        lambda t: contextlib.nullcontext())
    monkeypatch.setattr(_cuda, 'stream_of', lambda t: 0)

    def launch(prog, arrays):
        lib.calls.append(prog.counter)
        _cuda.LAUNCHES[prog.counter] += 1
        grid = tuple(w.shape[0] for w in arrays['weights'])
        return cuda_vform.run_program_plain(prog, arrays).reshape(
            (len(prog.outputs),) + grid)

    def adjoint(adj, arrays, g):
        lib.calls.append(adj.counter)
        _cuda.LAUNCHES[adj.counter] += 1
        return cuda_vform.run_adjoint_plain(adj.forward, arrays, g, adj)
    monkeypatch.setattr(cuda_vform.Program, 'launch', launch)
    monkeypatch.setattr(cuda_vform.AdjointProgram, 'launch', adjoint)
    _cuda.reset_launches()
    return lib


def _on_cpu(fn):
    """`fn()` through the plain versions (the CPU branch)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_sumfac, '_kernel_device', lambda t, n: t.is_cuda)
        mp.setattr(cuda_vform, '_on_card', lambda t, n=None: t.is_cuda)
        return fn()


CARD_CASES = {
    'mass': (lambda: _gauss_pair('mass', 'bspline'), 'mass_fields_jvp',
             'mass_fields_hvp'),
    'stiffness': (lambda: _gauss_pair('stiffness', 'nurbs'), 'fields_jvp',
                  'fields_hvp'),
    'convdiff': (_convdiff_pair, 'vform_tangent', 'vform_second'),
    'nonlinear_w': (_input_pair, 'vform_tangent', 'vform_second'),
}


@pytest.mark.parametrize('case', sorted(CARD_CASES))
def test_card_rules_jvp_forward_ad_and_jacfwd(fake_card, case):
    """``torch.func.jvp``, a ``forward_ad`` dual and ``torch.func.jacfwd``
    through the CUDA branch: the tangents equal the CPU run's (1e-12),
    the forward-mode kernel launches once a tangent, and ``jacfwd``
    launches it once a member of its batch (the ``vmap`` rule)."""
    make, tangent_kernel, _second = CARD_CASES[case]
    fn, _jfn, x0 = make()
    x, v = _t(x0), _t(_direction(x0))
    _cuda.reset_launches()
    tan = torch.func.jvp(fn, (x,), (v,))[1]
    assert _cuda.LAUNCHES[tangent_kernel] >= 1
    n1 = _cuda.LAUNCHES[tangent_kernel]
    with torch.autograd.forward_ad.dual_level():
        dtan = torch.autograd.forward_ad.unpack_dual(fn(
            torch.autograd.forward_ad.make_dual(x, v))).tangent
    assert _cuda.LAUNCHES[tangent_kernel] == 2 * n1
    ref = _on_cpu(lambda: torch.func.jvp(fn, (x,), (v,))[1])
    assert _rel(tan, ref) < 1e-12 and _rel(dtan, ref) < 1e-12
    sub = np.arange(x.numel())[::max(1, x.numel() // 6)][:6]

    def part(c):
        return fn(c).reshape(-1)[:20]

    def in_sub(y):                  # jacfwd along a few coefficients
        z = torch.zeros_like(x).reshape(-1)
        z = z.index_put((torch.as_tensor(sub),), y)
        return part(x + z.reshape(x.shape))
    _cuda.reset_launches()
    jac = torch.func.jacfwd(in_sub)(torch.zeros(len(sub), dtype=F64))
    assert _cuda.LAUNCHES[tangent_kernel] == len(sub) * n1
    ref = _on_cpu(lambda: torch.func.jacfwd(in_sub)(
        torch.zeros(len(sub), dtype=F64)))
    assert jac.shape == (20, len(sub)) and _rel(jac, ref) < 1e-12


@pytest.mark.parametrize('case', sorted(CARD_CASES))
def test_card_rules_hvp(fake_card, case):
    """The HVP of ``sum(w * fn)`` through the CUDA branch, forward over
    reverse and reverse over reverse, equals the CPU run's (1e-12); the
    second-order kernel (K1-hvp, or K5's second-order program) launched."""
    make, _tangent, second_kernel = CARD_CASES[case]
    fn, _jfn, x0 = make()
    x, v = _t(x0), _t(_direction(x0, seed=3))
    with torch.no_grad():
        w = _t(_weights(fn(x).shape))

    def obj(c):
        return (w * fn(c)).sum()

    def rev():
        xr = x.clone().requires_grad_(True)
        g, = torch.autograd.grad(obj(xr), xr, create_graph=True)
        return torch.autograd.grad((g * v).sum(), xr)[0]
    _cuda.reset_launches()
    fwd = torch.func.jvp(torch.func.grad(obj), (x,), (v,))[1]
    assert _cuda.LAUNCHES[second_kernel] >= 1
    _cuda.reset_launches()
    got = rev()
    assert _cuda.LAUNCHES[second_kernel] >= 1
    ref = _on_cpu(lambda: torch.func.jvp(torch.func.grad(obj), (x,),
                                         (v,))[1])
    assert _rel(fwd, ref) < 1e-12 and _rel(got, ref) < 1e-12


def test_card_hessian_of_a_small_mass_objective(fake_card):
    """``torch.func.hessian`` through the CUDA branch (every rule under
    ``vmap``: K1-jvp, K1-hvp, K2, K3 and K2-bwd once a member) equals the
    CPU run's and is symmetric."""
    fn, _jfn, x0 = _gauss_pair('mass', 'bspline', n=2)
    with torch.no_grad():
        w = _t(_weights(fn(_t(x0)).shape))

    def obj(c):
        return (w * fn(c)).sum()
    H = torch.func.hessian(obj)(_t(x0))
    assert _cuda.LAUNCHES['mass_fields_hvp'] == _t(x0).numel()
    ref = _on_cpu(lambda: torch.func.hessian(obj)(_t(x0)))
    assert _rel(H, ref) < 1e-12
    n = _t(x0).numel()
    H2 = H.reshape(n, n)
    assert _rel(H2, H2.T) < 1e-12


def test_tangents_and_gradients_of_constants_raise(fake_card):
    """Tables and weights are constants of the assembly: a tangent that
    reaches one, or a gradient asked of one, raises on the CUDA branch
    instead of being dropped."""
    rng = np.random.RandomState(2)
    X, T = _r(rng, 4, 6), _r(rng, 3, 4)
    with pytest.raises(RuntimeError, match='constants'):
        torch.func.jvp(lambda t: cuda_sumfac.stage(X, t), (T,), (T,))
    with pytest.raises(RuntimeError, match='constants'):
        cuda_sumfac.stage(X, T.clone().requires_grad_(True))
    with pytest.raises(RuntimeError, match='constants'):
        torch.func.jvp(lambda t: cuda_sumfac.fold([X, X], [t], [0, 0]),
                       (T,), (T,))


def test_no_derivative_kernels_refuse_tangents(monkeypatch):
    """The kernels without any derivative (K1', K7) refuse a forward-mode
    tangent on the CUDA branch as they refuse an operand that requires
    grad, and a chain with a tangent takes K2 + K3, never K7."""
    rng = np.random.RandomState(5)
    monkeypatch.setattr(cuda_sumfac, '_kernel_device', lambda t, n: True)
    jac, w12, wL = _r(rng, 2, 2, 6), _r(rng, 2), _r(rng, 3)
    with torch.autograd.forward_ad.dual_level():
        dual = torch.autograd.forward_ad.make_dual(jac, torch.ones_like(jac))
        with pytest.raises(RuntimeError, match='no forward-mode rule'):
            cuda_sumfac.host_jac_fields(dual, w12, wL)
        assert _cuda.differentiated(dual)
    assert not _cuda.differentiated(jac, None)
    with torch.no_grad():
        assert not _cuda.differentiated(jac.requires_grad_(True))


################################################################################
# the Newton example by jacfwd
################################################################################

def test_torch_nonlinear_poisson_jacobian_by_jacfwd():
    """The port's Newton example takes its Jacobian by
    ``torch.func.jacfwd``, as the JAX example takes ``jax.jacfwd``, and its
    docstring says so; at p=2, n=4 its residual norms fall quadratically
    to below 1e-12."""
    path = os.path.join(os.path.dirname(__file__), '..', 'examples',
                        'torch_nonlinear_poisson.py')
    src = open(path).read()
    assert 'torch.func.jacfwd' in src and 'autograd.functional' not in src
    spec = importlib.util.spec_from_file_location('nlp_jacfwd', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert 'jacfwd' in mod.__doc__
    norms, umax = mod.main(p=2, n=4, device='cpu')
    assert norms[-1] < 1e-12 and norms[2] < norms[1] ** 1.5
    assert 0.01 < umax < 1.0
