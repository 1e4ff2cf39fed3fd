"""The PyTorch port's differentiable assembly (``pyiga_tpu_torch.diff``)
held against ``pyiga_tpu.diff`` on the CPU: the same seeded numpy inputs
and geometries (carried across by ``convert.geometry_from``) through
both, values to 1e-14 relative and gradients to 1e-12 relative against
``jax.grad`` of the same objective, central differences at the JAX
tests' tolerances, ``torch.func.vmap`` against the loop,
``implicit_cg_solve`` against the dense solve, the same errors for the
same cases.  Beside them the backward of each kernel of the path in its
plain version (what a CPU tensor runs) against autograd of the plain
forward: K1's three kinds (NURBS or not, d = 2 and 3, a surface), K2,
K3 with tables shared by several terms, and the K5 adjoint program
(``run_adjoint_plain``) against autograd of ``run_program_plain`` on
forms that use every op of the generator; the guard of the kernels that
have no backward; second derivatives through the backward kernels'
Functions (their CUDA branch on CPU tensors, the launches replaced by
their plain versions); and the two example ports against the JAX
examples.  All float64."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pyiga_tpu.geometry as jgeometry
from pyiga_tpu import approx as japprox
from pyiga_tpu import assemble as jassemble
from pyiga_tpu import diff as jdiff
from pyiga_tpu.assemblers import MassAssembler as JMass
from pyiga_tpu.assemblers import StiffnessAssembler as JStiffness
from pyiga_tpu.bspline import make_knots as jmake_knots

from pyiga_tpu_torch import _cuda, assemble, convert, diff, geometry
from pyiga_tpu_torch.assemblers import MassAssembler, StiffnessAssembler
from pyiga_tpu_torch.ops import cuda_sumfac, cuda_vform
from pyiga_tpu_torch.ops.fastdiag import interior_dofs

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(__file__), '..', 'examples')


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _jkvs(p, n, d=2):
    return d * (jmake_knots(p, 0.0, 1.0, n),)


def _kvs(jkvs):
    return tuple(convert.knot_vector(kv) for kv in jkvs)


def _weights_for(shape):
    """Fixed random weights: sum(w * data) is a non-degenerate objective
    (the plain entry sum of a stiffness matrix is identically zero)."""
    return np.random.RandomState(42).rand(*shape)


def _port_grad(fn, w, x0):
    """Value of ``fn(x0)`` and the gradient of ``sum(w * fn(x))`` at
    `x0` through the port."""
    x = torch.tensor(np.asarray(x0, dtype=float), requires_grad=True)
    out = fn(x)
    (torch.as_tensor(w) * out).sum().backward()
    return out.detach().numpy(), x.grad.numpy()


def _jax_grad(fn, w, x0):
    g = jax.grad(lambda c: jnp.sum(jnp.asarray(w) * fn(c)))(
        jnp.asarray(x0, dtype=jnp.float64))
    return np.asarray(g)


def _fd(fn, w, x0, idx, h=1e-6):
    """Central finite difference of sum(w * fn) w.r.t. one entry."""
    cp = np.array(x0, dtype=float)
    cm = np.array(x0, dtype=float)
    cp[idx] += h
    cm[idx] -= h
    with torch.no_grad():
        return (float(np.sum(w * fn(cp).numpy()))
                - float(np.sum(w * fn(cm).numpy()))) / (2 * h)


def _pair(cls, jcls, jkvs, jgeo):
    return (cls(_kvs(jkvs), convert.geometry_from(jgeo), device='cpu'),
            jcls(jkvs, jgeo))


def _vform_pair(form, jkvs, jgeo, **args):
    """The same form through both packages; spline inputs carried across
    by convert.geometry_from."""
    jargs = dict(args, geo=jgeo)
    pargs = {k: convert.geometry_from(v) if hasattr(v, 'coeffs') else v
             for k, v in jargs.items()}
    return (assemble.instantiate_assembler(form, _kvs(jkvs), pargs, None,
                                           None, device='cpu'),
            jassemble.instantiate_assembler(form, jkvs, jargs, None, None))


def _check_value_and_grad(fn, jfn, x0, ref=None, fd_ids=(), fd_rel=2e-5):
    """fn(x0) against jfn(x0) (1e-14) and the production data `ref`
    (bitwise), the gradient against jax.grad (1e-12) and central
    differences at `fd_ids`."""
    with torch.no_grad():
        w = _weights_for(fn(x0).shape)
    val, g = _port_grad(fn, w, x0)
    jval = np.asarray(jfn(x0))
    assert _rel(val, jval) < 1e-14
    if ref is not None:
        assert np.array_equal(val, ref)
    jg = _jax_grad(jfn, w, x0)
    assert g.shape == np.shape(x0)
    assert np.all(np.isfinite(g)) and np.abs(g).max() > 1e-3
    assert _rel(g, jg) < 1e-12
    for idx in fd_ids:
        idx = np.unravel_index(idx, np.shape(x0))
        assert g[idx] == pytest.approx(_fd(fn, w, x0, idx), rel=fd_rel,
                                       abs=1e-8)
    return g


################################################################################
# assembly_coeff_fn: Gauss assemblers
################################################################################

@pytest.mark.parametrize('which', ['mass', 'stiffness'])
def test_value_matches_assemble_bspline(which):
    jkvs = _jkvs(2, 6)
    jgeo = jgeometry.bspline_quarter_annulus()
    cls, jcls = ((MassAssembler, JMass) if which == 'mass'
                 else (StiffnessAssembler, JStiffness))
    asm, jasm = _pair(cls, jcls, jkvs, jgeo)
    fn, coeffs0 = diff.assembly_coeff_fn(asm)
    jfn, _ = jdiff.assembly_coeff_fn(jasm)
    assert coeffs0.shape == np.asarray(jgeo.coeffs).shape
    data = fn(coeffs0).numpy()
    assert np.array_equal(data, asm.run_device().numpy())
    assert _rel(data, np.asarray(jfn(coeffs0))) < 1e-14
    ref = jasm.assemble().data
    assert np.allclose(data, ref, rtol=0, atol=1e-14 * np.abs(ref).max())


def test_value_matches_assemble_nurbs():
    jkvs = _jkvs(2, 6)
    asm, jasm = _pair(StiffnessAssembler, JStiffness, jkvs,
                      jgeometry.quarter_annulus())
    fn, coeffs0 = diff.assembly_coeff_fn(asm)
    jfn, _ = jdiff.assembly_coeff_fn(jasm)
    data = fn(coeffs0).numpy()
    assert np.array_equal(data, asm.run_device().numpy())
    assert _rel(data, np.asarray(jfn(coeffs0))) < 1e-14


@pytest.mark.parametrize('which', ['mass', 'stiffness'])
@pytest.mark.parametrize('geo_name', ['bspline', 'nurbs'])
def test_grad_matches_jax_and_finite_differences(geo_name, which):
    jkvs = _jkvs(2, 4)
    jgeo = (jgeometry.bspline_quarter_annulus() if geo_name == 'bspline'
            else jgeometry.quarter_annulus())
    cls, jcls = ((MassAssembler, JMass) if which == 'mass'
                 else (StiffnessAssembler, JStiffness))
    asm, jasm = _pair(cls, jcls, jkvs, jgeo)
    fn, coeffs0 = diff.assembly_coeff_fn(asm)
    jfn, _ = jdiff.assembly_coeff_fn(jasm)
    ids = np.random.RandomState(0).choice(coeffs0.size, size=4,
                                          replace=False)
    _check_value_and_grad(fn, jfn, coeffs0, asm.run_device().numpy(), ids)


def test_grad_3d_stiffness():
    jkvs = _jkvs(2, 3, d=3)
    asm, jasm = _pair(StiffnessAssembler, JStiffness, jkvs,
                      jgeometry.twisted_box())
    fn, coeffs0 = diff.assembly_coeff_fn(asm)
    jfn, _ = jdiff.assembly_coeff_fn(jasm)
    _check_value_and_grad(fn, jfn, coeffs0, asm.run_device().numpy(),
                          [coeffs0.size // 2])


def test_vmap_batched_assembly():
    """torch.func.vmap over a stack of coefficient arrays equals the loop
    (the kernels' Functions loop over the batch), for a mass and a NURBS
    stiffness assembler."""
    jkvs = _jkvs(2, 4)
    for cls, jgeo in ((MassAssembler, jgeometry.bspline_quarter_annulus()),
                      (StiffnessAssembler, jgeometry.quarter_annulus())):
        asm = cls(_kvs(jkvs), convert.geometry_from(jgeo), device='cpu')
        fn, coeffs0 = diff.assembly_coeff_fn(asm)
        rng = np.random.RandomState(1)
        batch = np.stack([coeffs0,
                          coeffs0 + 0.01 * rng.randn(*coeffs0.shape),
                          coeffs0 * 1.02])
        out = torch.func.vmap(fn)(torch.as_tensor(batch))
        for b in range(batch.shape[0]):
            assert torch.equal(out[b], fn(batch[b]))


def test_unstructured_geometry_raises():
    geo = geometry.UserFunction(
        lambda x, y: (x + 0.1 * y * y, y), [[0, 1], [0, 1]],
        jac=lambda x, y: ((np.ones_like(x), 0.2 * y),
                          (np.zeros_like(x), np.ones_like(y))))
    asm = MassAssembler(_kvs(_jkvs(2, 4)), geo, device='cpu')
    with pytest.raises(ValueError, match='structured geometry'):
        diff.assembly_coeff_fn(asm)
    with pytest.raises(TypeError, match='unsupported assembler type'):
        diff.assembly_coeff_fn(object())


################################################################################
# assembly_coeff_fn / assembly_input_fn: compiled forms
################################################################################

def test_vform_assembler_grad():
    jkvs = _jkvs(2, 4)
    asm, jasm = _vform_pair('inner(grad(u), grad(v)) * dx', jkvs,
                            jgeometry.quarter_annulus())
    fn, coeffs0 = diff.assembly_coeff_fn(asm)
    jfn, _ = jdiff.assembly_coeff_fn(jasm)
    _check_value_and_grad(fn, jfn, coeffs0,
                          asm.run_device()[(None, None)].numpy(),
                          [coeffs0.size // 2])


def test_vform_hessian_form_grad():
    """A form that reads the geometry's Hessian (mirrored entries read one
    row): the Hessian chains through K2 stages and K5's leaves."""
    jkvs = _jkvs(3, 3)
    asm, jasm = _vform_pair('inner(hess(u), hess(v)) * dx', jkvs,
                            jgeometry.bspline_quarter_annulus())
    fn, coeffs0 = diff.assembly_coeff_fn(asm)
    jfn, _ = jdiff.assembly_coeff_fn(jasm)
    _check_value_and_grad(fn, jfn, coeffs0,
                          asm.run_device()[(None, None)].numpy())


def _cfun(jkvs, f):
    return jgeometry.BSplineFunc(jkvs, np.asarray(
        japprox.interpolate(jkvs, f)))


@pytest.mark.parametrize('form,f,frac', [
    ('c * inner(grad(u), grad(v)) * dx', lambda x, y: 1.0 + x * y, 3),
    ('dot(grad(c), grad(u)) * v * dx', lambda x, y: x * x + 0.5 * y, 1.5),
])
def test_input_field_grad(form, f, frac):
    """The coefficient knob, with and without grad(c): the input's values
    and first derivatives recomputed from its coefficients."""
    jkvs = _jkvs(2, 4)
    asm, jasm = _vform_pair(form, jkvs, jgeometry.quarter_annulus(),
                            c=_cfun(jkvs, f))
    fn, x0 = diff.assembly_input_fn(asm, 'c')
    jfn, jx0 = jdiff.assembly_input_fn(jasm, 'c')
    assert x0.shape == jx0.shape
    ref = asm.run_device()[(None, None)].numpy()
    with torch.no_grad():
        assert np.allclose(fn(x0).numpy(), ref, rtol=0,
                           atol=1e-13 * np.abs(ref).max())
    _check_value_and_grad(fn, jfn, x0, fd_ids=[int(x0.size // frac)])


def test_parameter_grad():
    jkvs = _jkvs(2, 4)
    asm, jasm = _vform_pair('(eps * inner(grad(u), grad(v)) + u * v) * dx',
                            jkvs, jgeometry.quarter_annulus(), eps=0.7)
    fn, x0 = diff.assembly_input_fn(asm, 'eps')
    jfn, _ = jdiff.assembly_input_fn(jasm, 'eps')
    assert float(x0) == 0.7
    with torch.no_grad():
        data = fn(x0).numpy()
    assert np.array_equal(data, asm.run_device()[(None, None)].numpy())
    w = _weights_for(data.shape)
    val, g = _port_grad(fn, w, x0)
    assert _rel(val, np.asarray(jfn(x0))) < 1e-14
    jg = float(_jax_grad(jfn, w, 0.7))
    assert abs(float(g)) > 1e-3
    assert abs(float(g) - jg) < 1e-12 * abs(jg)
    h = 1e-6
    with torch.no_grad():
        fd = (float(np.sum(w * fn(0.7 + h).numpy()))
              - float(np.sum(w * fn(0.7 - h).numpy()))) / (2 * h)
    assert float(g) == pytest.approx(fd, rel=1e-6, abs=1e-10)


def test_vector_parameter_grad():
    """A vector parameter (the convection velocity): the flat parameter
    vector is formed from the replaced value, its gradient per slot."""
    jkvs = _jkvs(2, 4)
    b = np.array([3.0, -2.0])
    asm, jasm = _vform_pair('(inner(grad(u), grad(v)) + dot(b, grad(u)) * v'
                            ' + u * v) * dx', jkvs,
                            jgeometry.quarter_annulus(), b=b)
    fn, x0 = diff.assembly_input_fn(asm, 'b')
    jfn, _ = jdiff.assembly_input_fn(jasm, 'b')
    _check_value_and_grad(fn, jfn, x0)


def _vec(x, y):
    return (x + 0.0 * y, y + 0.0 * x)


@pytest.mark.parametrize('case,form,args,name,exc', [
    ('gauss', None, {}, 'c', TypeError),
    ('geo', 'u * v * dx', {}, 'geo', ValueError),
    ('unknown', 'u * v * dx', {}, 'nope', ValueError),
    ('physical', 'f * u * v * dx', {'f': lambda x, y: x + y}, 'f',
     NotImplementedError),
    ('vector', 'dot(a, grad(u)) * v * dx', {'a': _vec}, 'a',
     NotImplementedError),
    ('nurbs', 'c * u * v * dx', {'c': 'nurbs'}, 'c', NotImplementedError),
    ('second', 'inner(hess(c), hess(u)) * v * dx', {'c': 'spline'}, 'c',
     NotImplementedError),
])
def test_input_fn_errors(case, form, args, name, exc):
    """The same error for the same case in both packages."""
    jkvs = _jkvs(2, 4)
    jgeo = jgeometry.quarter_annulus()
    if case == 'gauss':
        asm, jasm = _pair(MassAssembler, JMass, jkvs, jgeo)
    else:
        if args.get('c') == 'nurbs':    # a scalar NURBS input
            jasm = jassemble.instantiate_assembler(form, jkvs, {
                'geo': jgeo, 'c': jgeometry.NurbsFunc(
                    jkvs, np.ones((6, 6)), np.ones((6, 6)))}, None, None)
            asm = assemble.instantiate_assembler(form, _kvs(jkvs), {
                'geo': convert.geometry_from(jgeo), 'c': geometry.NurbsFunc(
                    _kvs(jkvs), np.ones((6, 6)), np.ones((6, 6)))}, None,
                None, device='cpu')
        else:
            if args.get('c') == 'spline':
                args = {'c': _cfun(jkvs, lambda x, y: x * y)}
            asm, jasm = _vform_pair(form, jkvs, jgeo, **args)
    with pytest.raises(exc):
        jdiff.assembly_input_fn(jasm, name)
    with pytest.raises(exc):
        diff.assembly_input_fn(asm, name)


################################################################################
# implicit_cg_solve
################################################################################

def _dense_op(data, structure, N, free):
    I, J = (torch.as_tensor(ix.astype(np.int64))
            for ix in structure.nonzero())
    A = torch.zeros((N, N), dtype=data.dtype).index_put((I, J),
                                                        data.reshape(-1))
    return A[free][:, free]


def test_implicit_cg_solve_grad_matches_dense():
    """The shape gradient of a compliance through an iterative solve
    (one adjoint CG) equals that through a dense solve, and the JAX
    package's through its custom_linear_solve."""
    jkvs = _jkvs(2, 4)
    asm, jasm = _pair(StiffnessAssembler, JStiffness, jkvs,
                      jgeometry.bspline_quarter_annulus())
    fn, coeffs0 = diff.assembly_coeff_fn(asm)
    N = int(np.prod([kv.numdofs for kv in asm.kvs]))
    free = torch.as_tensor(interior_dofs(asm.kvs))
    f = torch.as_tensor(np.random.RandomState(3).rand(len(free)))

    def obj(c, solve):
        A = _dense_op(fn(c), asm.structure, N, free)
        return torch.dot(f, solve(A))

    def value_grad(solve):
        c = torch.tensor(coeffs0, requires_grad=True)
        v = obj(c, solve)
        g, = torch.autograd.grad(v, c)
        return float(v.detach()), g.numpy()

    v_d, g_d = value_grad(lambda A: torch.linalg.solve(A, f))
    v_c, g_c = value_grad(lambda A: diff.implicit_cg_solve(
        lambda x: A @ x, f, tol=1e-13))
    assert v_c == pytest.approx(v_d, rel=1e-10)
    assert np.allclose(g_c, g_d, rtol=1e-6, atol=1e-10)
    assert np.abs(g_d).max() > 1e-4

    jfn, _ = jdiff.assembly_coeff_fn(jasm)
    I, J = jasm.structure.nonzero()
    jfree = np.asarray(free)

    def jobj(c):
        data = jfn(c)
        A = jnp.zeros((N, N), dtype=data.dtype).at[I, J].set(
            data.reshape(-1))[np.ix_(jfree, jfree)]
        u = jdiff.implicit_cg_solve(lambda x: A @ x, jnp.asarray(f.numpy()),
                                    tol=1e-13)
        return jnp.dot(jnp.asarray(f.numpy()), u)

    jv, jg = jax.value_and_grad(jobj)(jnp.asarray(coeffs0))
    assert v_c == pytest.approx(float(jv), rel=1e-10)
    assert np.allclose(g_c, np.asarray(jg), rtol=1e-6, atol=1e-10)


def test_implicit_cg_solve_preconditioned():
    """With a preconditioner: the solve against the dense one and the JAX
    package's; the gradients to b and to the operator against the dense
    solve's."""
    rng = np.random.RandomState(0)
    Q = rng.rand(30, 30)
    A0 = Q @ Q.T + 30 * np.eye(30)
    b0 = rng.rand(30)
    A = torch.tensor(A0, requires_grad=True)
    b = torch.tensor(b0, requires_grad=True)
    diag = torch.tensor(np.diag(A0))
    x = diff.implicit_cg_solve(lambda v: A @ v, b, tol=1e-13,
                               precond=lambda r: r / diag)
    assert np.allclose(x.detach().numpy(), np.linalg.solve(A0, b0),
                       rtol=1e-9, atol=1e-11)
    jx = jdiff.implicit_cg_solve(lambda v: jnp.asarray(A0) @ v,
                                 jnp.asarray(b0), tol=1e-13,
                                 precond=lambda r: r / jnp.asarray(
                                     np.diag(A0)))
    assert np.allclose(x.detach().numpy(), np.asarray(jx), rtol=1e-9,
                       atol=1e-11)
    w = torch.as_tensor(rng.rand(30))
    gA, gb = torch.autograd.grad(torch.dot(w, x), (A, b))
    A2 = A.detach().clone().requires_grad_(True)
    b2 = b.detach().clone().requires_grad_(True)
    rA, rb = torch.autograd.grad(torch.dot(w, torch.linalg.solve(A2, b2)),
                                 (A2, b2))
    assert _rel(gb, rb) < 1e-9 and _rel(gA, rA) < 1e-9
    with torch.no_grad():       # no history: the plain solve
        assert torch.equal(diff.implicit_cg_solve(
            lambda v: A @ v, b, tol=1e-13, precond=lambda r: r / diag),
            x.detach())


################################################################################
# the kernels' backward in their plain versions
################################################################################

def _r(rng, *shape):
    return torch.tensor(rng.rand(*shape) + 0.5)


@pytest.mark.parametrize('kind,d,G', [
    ('stiffness', 2, 2), ('stiffness', 3, 3), ('mass', 2, 2), ('mass', 3, 3),
    ('jac', 2, 2), ('jac', 3, 3), ('jac', 2, 3), ('jac', 1, 1),
    ('jac', 1, 2)])
@pytest.mark.parametrize('nurbs', [False, True])
def test_fields_bwd_plain_matches_autograd(kind, d, G, nurbs):
    """K1's backward formulas (the CPU branch of its Function) against
    autograd of the plain forward, at ragged shapes."""
    rng = np.random.RandomState(d * 10 + G + 100 * nurbs)
    C = G + int(nurbs)
    Q12, QL, nL = (1, 5, 4) if d == 1 else (7, 5, 3)
    Y, T = _r(rng, d, C, Q12, nL), _r(rng, 2, QL, nL)
    w12, wL = _r(rng, Q12), _r(rng, QL)
    Yg = Y.clone().requires_grad_(True)
    if kind == 'jac':
        out = cuda_sumfac.geo_jac_fields_plain(Yg, T, nurbs)
    elif kind == 'mass':
        out = cuda_sumfac.fields_mass_plain(Yg, T, w12, wL, nurbs)
    else:
        out = cuda_sumfac.fields_plain(Yg, T, w12, wL, nurbs)
    g = _r(rng, *out.shape) - 1.0
    ref, = torch.autograd.grad(out, Yg, g)
    got = {'stiffness': lambda: cuda_sumfac.fields_bwd_plain(
        Y, T, w12, wL, nurbs, g),
           'mass': lambda: cuda_sumfac.fields_mass_bwd_plain(
        Y, T, w12, wL, nurbs, g),
           'jac': lambda: cuda_sumfac.geo_jac_fields_bwd_plain(
        Y, T, nurbs, g)}[kind]()
    assert got.shape == Y.shape
    assert _rel(got, ref) < 1e-13
    # the Function on CPU tensors runs the same formulas
    Yf = Y.clone().requires_grad_(True)
    if kind == 'jac':
        outf = cuda_sumfac.geo_jac_fields(Yf, T, nurbs)
    elif kind == 'mass':
        outf = cuda_sumfac.fields_mass(Yf, T, w12, wL, nurbs)
    else:
        outf = cuda_sumfac.fields(Yf, T, w12, wL, nurbs)
    assert torch.equal(outf, out.detach())
    gf, = torch.autograd.grad(outf, Yf, g)
    assert torch.equal(gf, got)


def test_stiffness_fields_mirrored_views_grad():
    """stiffness_fields hands one view to (a, b) and (b, a): a
    nonsymmetric weight's gradient adds both terms into one K1 row."""
    jkvs = _jkvs(2, 4)
    asm = StiffnessAssembler(_kvs(jkvs), convert.geometry_from(
        jgeometry.quarter_annulus()), device='cpu')
    gi = asm.geo_inputs()
    c = gi['geo_coeffs'].clone().requires_grad_(True)
    rng = np.random.RandomState(5)
    F = cuda_sumfac.stiffness_fields(dict(gi, geo_coeffs=c))
    ws = [torch.as_tensor(rng.rand(*F[0].shape)) for _ in F]
    g, = torch.autograd.grad(sum((w * x).sum() for w, x in zip(ws, F)), c)
    c2 = gi['geo_coeffs'].clone().requires_grad_(True)
    (Y, T, w12, wL, nurbs), grid = cuda_sumfac._spline_stages(
        dict(gi, geo_coeffs=c2))
    B = cuda_sumfac.fields_plain(Y, T, w12, wL, nurbs)
    full = [B[0], B[1], B[1], B[2]]
    g2, = torch.autograd.grad(sum((w * x.reshape(grid)).sum()
                                  for w, x in zip(ws, full)), c2)
    assert _rel(g, g2) < 1e-13


def test_stage_and_fold_bwd():
    """K2's backward is K2 with the roles swapped; K3's gives the terms
    that share a table one gradient (one launch per distinct table on the
    card), here against autograd of the plain versions, with 17 terms
    (past the kernel's split)."""
    rng = np.random.RandomState(7)
    X, T = _r(rng, 6, 9), _r(rng, 4, 6)
    g = _r(rng, 9, 4)
    Xg = X.clone().requires_grad_(True)
    got, = torch.autograd.grad(cuda_sumfac.stage(Xg, T), Xg, g)
    assert torch.equal(got, cuda_sumfac.stage_bwd(T, g))
    Xp = X.clone().requires_grad_(True)
    ref, = torch.autograd.grad(cuda_sumfac.stage_plain(Xp, T), Xp, g)
    assert _rel(got, ref) < 1e-15
    xs = [_r(rng, 6, 9).requires_grad_(True) for _ in range(17)]
    tabs = [_r(rng, 4, 6) for _ in range(3)]
    idx = [t % 3 if t < 9 else 1 for t in range(17)]
    gs = torch.autograd.grad(cuda_sumfac.fold(xs, tabs, idx), xs, g)
    xp = [x.detach().clone().requires_grad_(True) for x in xs]
    rs = torch.autograd.grad(cuda_sumfac.fold_plain(xp, tabs, idx), xp, g)
    for a, b, i in zip(gs, rs, idx):
        assert _rel(a, b) < 1e-15
        assert torch.equal(a, gs[idx.index(i)])   # shared per table
    with pytest.raises(RuntimeError, match='constants'):
        cuda_sumfac.stage(Xg, T.clone().requires_grad_(True))


# forms whose programs hold every op of the generator (add, sub, mul, div,
# neg from the geometry; sqrt, exp, log, sin, cos, tan, abs of an input),
# a vector parameter, and the geometry Hessian (mirrored entries read one
# row)
ADJOINT_FORMS = {
    'convdiff': ('(inner(grad(u), grad(v)) + dot(b, grad(u)) * v + u * v)'
                 ' * dx', {'b': np.array([3.0, -2.0])}),
    'funcs': ('(sqrt(c) + exp(c) + log(c) + sin(c) + cos(c) + tan(0.3 * c)'
              ' + abs(c - 1.2)) * inner(grad(u), grad(v)) * dx',
              {'c': 'spline'}),
    'gradc': ('dot(grad(c), grad(u)) * v * dx', {'c': 'spline'}),
    'hessian': ('inner(hess(u), hess(v)) * dx', {}),
    'nonlinear': ('(1 + c*c) * inner(grad(c), grad(v)) * dx',
                  {'c': 'spline'}),
}


@pytest.mark.parametrize('name', sorted(ADJOINT_FORMS))
def test_adjoint_program_matches_autograd(name):
    """K5's adjoint program run in torch ops (the plain version of the
    generated adjoint kernel) against autograd of run_program_plain on
    the same operands."""
    form, args = ADJOINT_FORMS[name]
    kvs = _kvs(_jkvs(3 if name == 'hessian' else 2, 4))
    if args.get('c') == 'spline':
        from pyiga_tpu_torch import approx
        args = dict(c=geometry.BSplineFunc(kvs, np.asarray(
            approx.interpolate(kvs, lambda x, y: 1.0 + 0.3 * x * y))))
    asm = assemble.instantiate_assembler(
        form, kvs, dict(args, geo=geometry.quarter_annulus()), None, None,
        device='cpu')
    arrays = asm.device_arrays()
    prog = asm._program(asm.combos)
    ops = {name for name, _a in prog.instrs}
    if name == 'funcs':
        assert ops >= set(cuda_vform._TORCH_OPS) - {'sign'}
    leaves = {k: arrays[k].clone().requires_grad_(True)
              for k in prog.sources}
    params = arrays['params'].clone().requires_grad_(True)
    out = cuda_vform.run_program_plain(prog, dict(arrays, params=params,
                                                  **leaves))
    grid = tuple(w.shape[0] for w in arrays['weights'])
    g = torch.as_tensor(np.random.RandomState(1).rand(*out.shape) - 0.5)
    refs = torch.autograd.grad(out, list(leaves.values()) + [params], g,
                               allow_unused=True)
    grads, gp = cuda_vform.run_adjoint_plain(
        prog, arrays, g.reshape((len(prog.outputs),) + grid))
    for key, ref in zip(leaves, refs):
        ref = torch.zeros_like(grads[key]) if ref is None else ref
        assert grads[key].shape == arrays[key].shape
        assert _rel(grads[key], ref) < 1e-12 or ref.abs().max() == 0
    if prog.params:
        assert _rel(gp, refs[-1]) < 1e-12
    else:
        assert gp is None
    if name == 'hessian':       # the mirrored entries' rows: k <= l only
        assert all(k == 'geo_jac_lvl' or row in (0, 1, 3, 4, 5, 7)
                   for k, row in prog.adjoint().src_targets)
    src = prog.adjoint().source
    assert 'vform_adjoint_kernel' in src and 'atomicAdd' not in src


def test_guard_of_kernels_without_backward(monkeypatch):
    """K1', K7a and K7b have no backward: on CUDA an operand that
    requires grad raises (here with the device test forced, so that the
    CUDA branch is reached on CPU tensors: the guard fires before any
    launch); under no_grad, or on the CPU, nothing raises."""
    rng = np.random.RandomState(2)
    x = _r(rng, 4, 6).requires_grad_(True)
    with pytest.raises(RuntimeError, match='no backward'):
        _cuda.no_grad_operands('k', x)
    with torch.no_grad():
        _cuda.no_grad_operands('k', x)
    _cuda.no_grad_operands('k', x.detach(), None)
    jac = _r(rng, 2, 2, 6).requires_grad_(True)
    w12, wL = _r(rng, 2), _r(rng, 3)
    cpu = cuda_sumfac.host_jac_fields(jac, w12, wL)      # plain: has a grad
    assert cpu.requires_grad
    monkeypatch.setattr(cuda_sumfac, '_kernel_device', lambda t, n: True)
    with pytest.raises(RuntimeError, match='host_jac_fields.*no backward'):
        cuda_sumfac.host_jac_fields(jac, w12, wL)
    with pytest.raises(RuntimeError, match='stage_T.*no backward'):
        cuda_sumfac.stage_T(x, _r(rng, 3, 4))
    with pytest.raises(RuntimeError, match='tail_fused.*no backward'):
        cuda_sumfac.tail_fused([_r(rng, 2, 3, 4).requires_grad_(True)],
                               [_r(rng, 2, 3)], [_r(rng, 2, 4)], [0], [0])


def _plain_card(monkeypatch):
    """The CUDA branch of the kernels' wrappers and Functions on CPU
    tensors: the device tests forced, every launch replaced by its plain
    version (K1 and its backward, K1-jvp, K1-hvp, K2, K3, K2-bwd, the K5
    program, adjoint, tangent and second-order programs), each plain call
    counted under the launch's kind in the returned dict."""
    calls = {}

    def counted(key, fn):
        def run(*a, **k):
            calls[key] = calls.get(key, 0) + 1
            return fn(*a, **k)
        return run
    cs = cuda_sumfac
    monkeypatch.setattr(cs, '_kernel_device', lambda t, n: True)
    monkeypatch.setattr(cuda_vform, '_on_card', lambda t, n=None: True)
    monkeypatch.setattr(_cuda, 'require', lambda *a: None)
    monkeypatch.setattr(cs, '_fields_kernel', counted('fields', lambda kind, Y, T, w12, wL, nurbs: {
        'stiffness': cs.fields_plain, 'mass': cs.fields_mass_plain}[kind](
            Y, T, w12, wL, nurbs) if kind != 'jac'
        else cs.geo_jac_fields_plain(Y, T, nurbs)))
    monkeypatch.setattr(cs, '_fields_bwd_kernel', counted(
        'fields_bwd', lambda kind, dims, Y, T, w12, wL, nurbs, g:
        cs._fields_vjp_plain(kind, Y, T, w12, wL, nurbs, g)))
    monkeypatch.setattr(cs, '_fields_ad_kernel', lambda mode, kind, dims, Y, T, w12, wL, nurbs, dY, g=None: counted(
        'fields_' + mode, cs.fields_jvp_plain if mode == 'jvp'
        else lambda *a: cs.fields_hvp_plain(*a[:6], g, a[6]))(
            kind, Y, T, w12, wL, nurbs, dY))
    monkeypatch.setattr(cs, '_stage_kernel', counted('stage',
                                                     cs.stage_plain))
    monkeypatch.setattr(cs, '_fold_kernel', counted('fold', cs.fold_plain))
    monkeypatch.setattr(cs, '_stage_bwd_kernel', counted(
        'stage_bwd', lambda tables, g, counter: torch.stack(
            [cs.stage_bwd_plain(T, g) for T in tables])))

    def launch(prog, arrays):
        grid = tuple(w.shape[0] for w in arrays['weights'])
        return cuda_vform.run_program_plain(prog, arrays).reshape(
            (len(prog.outputs),) + grid)

    def adjoint(adj, arrays, g):
        return cuda_vform.run_adjoint_plain(adj.forward, arrays, g, adj)
    monkeypatch.setattr(cuda_vform.Program, 'launch', lambda self, a: counted(
        self.counter, launch)(self, a))
    monkeypatch.setattr(cuda_vform.AdjointProgram, 'launch',
                        lambda self, a, g: counted(self.counter, adjoint)(
                            self, a, g))
    return calls


def _hvp_create_graph(f, x, v):
    """``d/dx <grad f(x), v>`` by reverse over reverse."""
    xr = x.clone().requires_grad_(True)
    g, = torch.autograd.grad(f(xr), xr, create_graph=True)
    assert g.requires_grad
    return torch.autograd.grad((g * v).sum(), xr)[0]


@pytest.mark.parametrize('case', ['plain', 'fields_bwd', 'stage_bwd',
                                  'vform_adjoint'])
def test_second_derivative_through_backward_kernels(monkeypatch, case):
    """A second derivative flows through the backward kernels' Functions
    (K1-bwd :class:`_FieldsBwd`, K2-/K3-bwd :class:`_StageBwd`, the K5
    adjoint :class:`_AdjointLaunch`): reverse over reverse
    (``create_graph``) and forward over reverse (``torch.func.jvp`` of
    ``torch.func.grad``) through their CUDA branch (the device tests
    forced, the launches replaced by their plain versions) equal autograd
    of the plain versions on the CPU (1e-12), and the rules launch what
    they should: K1-hvp and K1-jvp for K1-bwd, K3 and K2-bwd for K2-bwd,
    the second-order and tangent programs for the adjoint.  'plain' is
    the CPU branch: the backward's formulas recorded under
    ``create_graph``, a Hessian-vector product through K1 and K2 equal to
    autograd of the plain forwards."""
    rng = np.random.RandomState(3)
    Y, T = _r(rng, 2, 2, 7, 3), _r(rng, 2, 5, 3)
    w12, wL, S = _r(rng, 7), _r(rng, 5), _r(rng, 4, 3)
    V = _r(rng, *Y.shape) - 1.0
    if case in ('plain', 'fields_bwd', 'stage_bwd'):
        S2 = _r(rng, 6, 4)

        def chain(fields, stage):
            def f(Yg):
                out = fields(Yg, T, w12, wL, False).reshape(-1, 3)
                out = stage(stage(out, S), S2)
                return (out * out).sum()
            return f
        ref = _hvp_create_graph(chain(
            cuda_sumfac.fields_plain, lambda X, T_: X @ T_.T), Y, V)
        calls = {} if case == 'plain' else _plain_card(monkeypatch)
        f = chain(cuda_sumfac.fields, lambda X, T_: cuda_sumfac.stage(
            X.T.contiguous(), T_))
        assert _rel(_hvp_create_graph(f, Y, V), ref) < 1e-12
        if case == 'plain':
            return
        assert calls['fields_hvp'] > 0 and calls['fields_jvp'] > 0
        assert calls['stage_bwd'] > 0 and calls['fold'] > 0
        fwd = torch.func.jvp(torch.func.grad(f), (Y,), (V,))[1]
        assert _rel(fwd, ref) < 1e-12
        return
    asm = assemble.instantiate_assembler(
        ADJOINT_FORMS['convdiff'][0], _kvs(_jkvs(2, 4)),
        dict(ADJOINT_FORMS['convdiff'][1], geo=geometry.quarter_annulus()),
        None, None, device='cpu')
    arrays = asm.device_arrays()
    src = 'geo_jac_lvl'
    X = arrays[src]
    Wt = torch.as_tensor(rng.rand(len(asm.combos), *X.shape[2:]))
    dX = torch.as_tensor(rng.rand(*X.shape) - 0.5)

    def obj(combo_fields):
        def f(Xg):
            fields = combo_fields(asm, dict(arrays, **{src: Xg}), asm.combos)
            return sum((w * F * F).sum() for w, F in zip(Wt, fields))
        return f
    ref = _hvp_create_graph(obj(cuda_vform.combo_fields_plain), X, dX)
    calls = _plain_card(monkeypatch)
    f = obj(cuda_vform.combo_fields)
    assert _rel(_hvp_create_graph(f, X, dX), ref) < 1e-12
    assert calls['vform_second'] > 0 and calls['vform_tangent'] > 0
    assert calls['vform_adjoint'] > 0
    fwd = torch.func.jvp(torch.func.grad(f), (X,), (dX,))[1]
    assert _rel(fwd, ref) < 1e-12


################################################################################
# the example ports against the JAX examples
################################################################################

def _load(name):
    path = os.path.join(EXAMPLES, name + '.py')
    spec = importlib.util.spec_from_file_location('example_' + name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def test_torch_shape_derivative_matches_jax():
    jhist = _load('shape_derivative').main(p=2, n=6, steps=2)
    hist = _load('torch_shape_derivative').main(p=2, n=6, steps=2,
                                                device='cpu')
    assert len(hist) == len(jhist) == 3
    assert all(b < a for a, b in zip(hist, hist[1:]))
    assert _rel(hist, jhist) < 1e-10


def test_torch_nonlinear_poisson_matches_jax(monkeypatch):
    import pyiga_tpu.solvers as jsolvers
    import pyiga_tpu_torch.solvers as psolvers
    sols = {}

    def recording(mod, key):
        newton = mod.newton

        def wrapped(*a, **kw):
            sols[key] = newton(*a, **kw)
            return sols[key]
        monkeypatch.setattr(mod, 'newton', wrapped)

    recording(jsolvers, 'jax')
    recording(psolvers, 'port')
    jnorms, jumax = _load('nonlinear_poisson').main(p=2, n=6)
    norms, umax = _load('torch_nonlinear_poisson').main(p=2, n=6,
                                                        device='cpu')
    assert len(norms) == len(jnorms)
    assert np.allclose(norms, jnorms, rtol=1e-10, atol=1e-10)
    assert _rel(sols['port'], sols['jax']) < 1e-12
    assert umax == pytest.approx(jumax, rel=1e-12)
