"""Second derivatives in the PyTorch port held against the JAX package on
the CPU: the geometry Hessian (``ops.geom.geo_hessian_field`` and its
device counterpart through the K2 stage chain,
``cuda_sumfac.geometry_hessian``) for B-spline and NURBS maps on a
non-square grid, in level order; fourth-order forms and the Hessians of
spline and physical input fields (``ideriv:<name>:2`` in the symmetric
XYZ layout); the JAX package's own tests of these pieces; a
``UserFunction`` geometry inside a VForm; and K5's generated program on
the Hessian and ``ds`` forms, run with torch ops from the kernel's
operands, against its plain version.  Matrices and vectors to 1e-13
relative unless a finite difference takes part."""

import math

import numpy as np
import pytest
import torch

import pyiga_tpu.bspline as jbspline
import pyiga_tpu.geometry as jgeometry
from pyiga_tpu import approx as japprox
from pyiga_tpu import assemble as jassemble
from pyiga_tpu import compile as jcompile
from pyiga_tpu import vform as jvform
from pyiga_tpu.ops import geom as jgeom

from pyiga_tpu_torch import (approx, assemble, bspline, compile, geometry,
                             vform)
from pyiga_tpu_torch.ops import cuda_sumfac, cuda_vform, geom, sumfac

torch.set_num_threads(1)


def _dense(A):
    return A.toarray() if hasattr(A, 'toarray') else np.asarray(A)


def _rel(a, b):
    a, b = _dense(a), _dense(b)
    assert a.shape == b.shape
    return np.abs(a - b).max() / np.abs(b).max()


def _kvs(pkg, ns, p=3):
    return tuple(pkg.make_knots(p, 0.0, 1.0, n) for n in ns)


GEOS = ['quarter_annulus', 'bspline_quarter_annulus', 'twisted_box']


@pytest.mark.parametrize('name', GEOS)
def test_geo_hessian_field_matches_jax(name):
    """The plain Hessian and its K2-chain counterpart equal JAX's
    ``geo_hessian_field`` (quotient rule for NURBS) on a non-square grid,
    and are symmetric."""
    geo, jgeo = getattr(geometry, name)(), getattr(jgeometry, name)()
    ns = (4, 6, 5)[:geo.sdim]
    grid, _ = sumfac.quadrature_for(_kvs(bspline, ns))
    tabs, coeffs, nurbs = geom.geo_eval_tables(geo, grid, numderiv=2)
    jtabs, jcoeffs, jnurbs = jgeom.geo_eval_tables(jgeo, grid, numderiv=2)
    assert nurbs == jnurbs == (name == 'quarter_annulus')
    ref = np.asarray(jgeom.geo_hessian_field(jtabs, jcoeffs, jnurbs,
                                             geo.sdim))
    ttabs = [torch.as_tensor(t) for t in tabs]
    H = geom.geo_hessian_field(ttabs, torch.as_tensor(coeffs), nurbs,
                               geo.sdim)
    Hk = cuda_sumfac.geometry_hessian(ttabs, torch.as_tensor(coeffs), nurbs)
    d = geo.sdim
    assert H.shape == Hk.shape == (d, d, d) + tuple(len(g) for g in grid)
    for got in (H, Hk):
        assert _rel(got.numpy(), ref) < 1e-13
        assert torch.equal(got, got.transpose(1, 2))


# the B-spline case first: the JAX package's probe of the biharmonic form
# takes ~25 s on the CPU, and the NURBS case, whose probe is the same
# (random geometry fields), then finds it in JAX's probe cache
@pytest.mark.parametrize('form,geo', [
    ('inner(hess(u), hess(v)) * dx', 'bspline_quarter_annulus'),
    ('inner(hess(u), hess(v)) * dx', 'quarter_annulus'),
    ('(inner(hess(g), hess(v)) + tr(hess(g)) * v) * dx', 'quarter_annulus'),
])
def test_hessian_forms_match_jax(form, geo):
    """A fourth-order form (the Kirchhoff plate) and Hessians of a spline
    input on a non-square (5, 8) space: the matrix or vector, the pruned
    combos, the fold plan and the probe's Hessian flag are JAX's."""
    kvs, jkvs = _kvs(bspline, (5, 8)), _kvs(jbspline, (5, 8))
    coeffs = np.random.RandomState(7).rand(8, 11)
    args = {'g': geometry.BSplineFunc(kvs, coeffs)}
    jargs = {'g': jgeometry.BSplineFunc(jkvs, coeffs)}
    G, jG = getattr(geometry, geo)(), getattr(jgeometry, geo)()
    asm = assemble.instantiate_assembler(form, kvs, dict(args, geo=G), None,
                                         device='cpu')
    jasm = jassemble.instantiate_assembler(form, jkvs, dict(jargs, geo=jG),
                                           None)
    assert asm.combos == jasm.combos
    assert asm._fold_plan == jasm._fold_plan
    assert asm._needs_geo_hessian() == jasm._needs_geo_hessian()
    assert asm._host_arrays.keys() == jasm._host_arrays.keys()
    if 'hess(g)' in form:
        h, jh = asm._host_arrays['ideriv:g:2'], jasm._host_arrays['ideriv:g:2']
        assert h.shape == (3, 20, 32)
        assert _rel(h, jh) < 1e-13
    out = assemble.assemble_entries(asm)
    jout = jassemble.assemble_entries(jasm)
    assert _rel(out, jout) < 1e-13


def _laplacian_functional(pkg, asm_mod, app, kvs, **kw):
    fcoef = app.interpolate(kvs, lambda x, y: x**2 * y + y**3,
                            geo=pkg.quarter_annulus())
    mod = vform if pkg is geometry else jvform
    V = mod.VForm(2, arity=1)
    v = V.basisfuns()
    H = mod.hess(V.input('f'))
    V.add((H[0, 0] + H[1, 1]) * v * mod.dx)
    b = asm_mod.assemble(V, kvs, geo=pkg.quarter_annulus(),
                         f=pkg.BSplineFunc(kvs, fcoef), **kw)
    b_ex = asm_mod.inner_products(kvs, lambda x, y: 8 * y, f_physical=True,
                                  geo=pkg.quarter_annulus())
    return np.asarray(b).ravel(), np.asarray(b_ex).ravel()


def test_input_field_hessian_assembly():
    """``test_vform.py::test_input_field_hessian_assembly``: the Laplacian
    functional of an interpolated field converges at O(h^2) to the exact
    physical Laplacian; at n = 8 it equals JAX's."""
    errs = []
    for n in (8, 16):
        kvs = 2 * (bspline.make_knots(3, 0.0, 1.0, n),)
        b, b_ex = _laplacian_functional(geometry, assemble, approx, kvs,
                                        device='cpu')
        errs.append(abs(b - b_ex).max() / abs(b_ex).max())
        if n == 8:
            jkvs = 2 * (jbspline.make_knots(3, 0.0, 1.0, n),)
            jb, _ = _laplacian_functional(jgeometry, jassemble, japprox,
                                          jkvs)
            assert _rel(b, jb) < 1e-13
    assert errs[1] < errs[0] / 3.0
    assert errs[1] < 2e-4


def _poly(x, y):
    return x ** 2 + 3 * x * y + y ** 3


def _np_exp(x, y):
    return np.exp(0.3 * x) * y


def _math_sin(x, y):
    return np.vectorize(lambda a, b: math.sin(a) * b + a * a)(x, y)


def _phys_forms(pkg):
    mod = vform if pkg is geometry else jvform
    vf = mod.VForm(2)
    u, v = vf.basisfuns()
    ff = vf.input('f', physical=True)
    vf.add((mod.dot(mod.grad(ff), mod.grad(u)) * v
            + mod.tr(mod.hess(ff)) * u * v) * mod.dx)
    return vf


@pytest.mark.parametrize('f,traces', [(_poly, True), (_np_exp, False),
                                      (_math_sin, False)])
def test_physical_input_field_derivatives(f, traces):
    """``test_vform.py::test_physical_input_field_derivatives`` for three
    functions: a polynomial, which both packages differentiate exactly
    (torch.func / jax.jacfwd), and one through ``np.exp`` and one through
    ``math.sin``, which neither traces, so both take central differences.
    The port takes JAX's branch: exact agreement where both trace; where
    both difference, agreement to the rounding of the two packages' mapped
    Gauss points amplified by the second differences' 1/h^2 (1e-7), while
    the differences themselves stay ~1e-9 and more from the exact
    derivatives."""
    kvs, jkvs = _kvs(bspline, (6, 6)), _kvs(jbspline, (6, 6))
    geo, jgeo = geometry.quarter_annulus(), jgeometry.quarter_annulus()
    grid, _ = sumfac.quadrature_for(kvs)
    g, H = compile._physical_field_derivs(f, geo, grid, (), True)
    jg, jH = jcompile._physical_field_derivs(f, jgeo, grid, (), True)
    assert g.shape == (24, 24, 2) and H.shape == (24, 24, 3)
    # the exact derivatives by torch.func on the port's own points
    pts = torch.as_tensor(geo.grid_eval(grid).reshape(-1, 2))
    ok = True
    try:
        from torch.func import jacfwd, vmap
        ex = vmap(jacfwd(jacfwd(lambda p: torch.as_tensor(
            f(p[0], p[1]), dtype=torch.float64))))(pts).numpy()
    except Exception:
        ok = False
    assert ok == traces
    if traces:
        assert _rel(g, jg) < 1e-13 and _rel(H, jH) < 1e-13
        sym = np.stack([ex[:, 0, 0], ex[:, 0, 1], ex[:, 1, 1]], -1)
        assert _rel(H.reshape(-1, 3), sym) < 1e-13
    else:
        assert _rel(g, jg) < 1e-9 and _rel(H, jH) < 1e-7
    A = assemble.assemble(_phys_forms(geometry), kvs, geo=geo, f=f,
                          device='cpu')
    jA = jassemble.assemble(_phys_forms(jgeometry), jkvs, geo=jgeo, f=f)
    assert _rel(A, jA) < (1e-13 if traces else 1e-7)
    if f is _poly:
        # against the analytic gradient and Laplacian as plain inputs
        B = assemble.assemble(
            '(dot(gf, grad(u)) * v + lf * u * v) * dx', kvs, geo=geo,
            gf=lambda x, y: (2 * x + 3 * y, 3 * x + 3 * y ** 2),
            lf=lambda x, y: 2 + 6 * y, device='cpu')
        assert _rel(A, B) < 1e-12


def test_spacetime_second_order_space_derivs():
    """``test_vform.py::test_spacetime_second_order_space_derivs``: on a
    space-time cylinder the physical d^2/dx^2 equals the plain 2D form's;
    both forms and a wave-type term equal JAX's."""
    def cyl(pkg, bmod):
        seg = pkg.BSplineFunc((bmod.make_knots(2, 0.0, 1.0, 2),),
                              np.array([0.0, 0.2, 0.6, 1.0]))
        return seg.cylinderize(0.0, 1.0)

    def form(mod, spacetime, wave=False):
        vf = mod.VForm(2, spacetime=spacetime)
        u, v = vf.basisfuns()
        vf.add(mod.Dx(u, 0, 2) * (v.dt() if wave else v) * mod.dx)
        return vf

    kvs = (bspline.make_knots(2, 0.0, 1.0, 4),
           bspline.make_knots(3, 0.0, 1.0, 5))
    jkvs = (jbspline.make_knots(2, 0.0, 1.0, 4),
            jbspline.make_knots(3, 0.0, 1.0, 5))
    out = {}
    for st, wave in ((True, False), (False, False), (True, True)):
        A = assemble.assemble(form(vform, st, wave), kvs,
                              geo=cyl(geometry, bspline), device='cpu')
        jA = jassemble.assemble(form(jvform, st, wave), jkvs,
                                geo=cyl(jgeometry, jbspline))
        assert _rel(A, jA) < 1e-13
        out[st, wave] = A
    assert _rel(out[True, False], out[False, False]) < 1e-12
    assert np.abs(out[True, True].toarray()).max() > 0


def _stack_jac(rows):
    """[..., i, j] = dF_i / dx_j from nested lists of arrays."""
    rows = [np.broadcast_arrays(*r) for r in rows]
    return np.stack([np.stack(r, axis=-1) for r in rows], axis=-2)


def _user3d(pkg):
    def f(x, y, z):
        return (x + 0.1 * y * z, y + 0.2 * x * x, z + 0.05 * x * y)

    def jac(x, y, z):
        one, zero = np.ones_like(x * y * z), np.zeros_like(x * y * z)
        return _stack_jac([[one, 0.1 * z, 0.1 * y],
                           [0.4 * x, one, zero],
                           [0.05 * y, 0.05 * x, one]])
    return pkg.UserFunction(f, [[0, 1]] * 3, jac=jac)


def test_user_function_geometry_in_a_vform():
    """A 3D ``UserFunction`` geometry inside a convection-diffusion form
    with a physical input and the geometry's values: evaluated on the
    host, read by K5, equal to JAX's."""
    form = ('(inner(grad(u), grad(v)) + dot(b, grad(u)) * v'
            ' + x[0] * f * u * v) * dx')
    args = dict(b=np.array([1.0, -2.0, 0.5]), f=lambda x, y, z: 1 + x * z)
    kvs, jkvs = _kvs(bspline, (3, 4, 3), p=2), _kvs(jbspline, (3, 4, 3),
                                                      p=2)
    asm = compile.compile_vform(vform.parse_vf(form, kvs, args=args))(
        kvs, geo=_user3d(geometry), device='cpu', **args)
    jasm = jcompile.compile_vform(jvform.parse_vf(form, jkvs, args=args))(
        jkvs, geo=_user3d(jgeometry), **args)
    assert asm._geo_tables is None and asm.combos == jasm.combos
    assert asm._fold_plan == jasm._fold_plan
    assert _rel(asm.assemble().asmatrix(), jasm.assemble().asmatrix()) \
        < 1e-13


PROGRAM_CASES = {
    'biharmonic': ('inner(hess(u), hess(v)) * dx', {}, None),
    'hess_input': ('(H[0, 0] + H[1, 1]) * v * dx', {'H': 'hess'}, None),
    'ds_left': ('(inner(grad(u), grad(v)) + u * v) * ds', {}, 'left'),
    'normal_top': ('inner(v, n) * ds', {}, 'top'),
}


@pytest.mark.parametrize('case', list(PROGRAM_CASES))
def test_generated_program_on_hessian_and_ds_forms(case):
    """K5's generator on the Hessian leaves (``geo_hess_lvl``, read in
    place, mirrored entries from one row; ``ideriv:<name>:2``) and the
    ``ds`` measure with its ``Jac_to_boundary`` parameter: the program run
    with torch ops from the kernel's operands equals the plain fields."""
    form, extra, bd = PROGRAM_CASES[case]
    kvs = _kvs(bspline, (5, 8))
    geo = geometry.quarter_annulus()
    if extra.get('H') == 'hess':
        vf = vform.VForm(2, arity=1)
        v = vf.basisfuns()
        H = vform.hess(vf.input('f'))
        vf.add((H[0, 0] + H[1, 1]) * v * vform.dx)
        coeffs = np.random.RandomState(1).rand(8, 11)
        asm = compile.compile_vform(vf)(
            kvs, geo=geo, f=geometry.BSplineFunc(kvs, coeffs), device='cpu')
        assert 'ideriv:f:2' in asm._host_arrays
    else:
        kw = {'bfuns': [('v', 2)]} if 'n)' in form else {}
        asm = assemble.instantiate_assembler(form, kvs, {'geo': geo},
                                             kw.get('bfuns'), boundary=bd,
                                             device='cpu')
    arrays = asm.device_arrays()
    prog = cuda_vform.generate(asm, asm.combos)
    got = cuda_vform.run_program_plain(prog, arrays)
    ref = cuda_vform.combo_fields_plain(asm, arrays, asm.combos)
    ref = torch.stack([F.reshape(-1) for F in ref])
    assert got.shape == ref.shape
    assert (got - ref).abs().max() <= 1e-13 * ref.abs().max()
    if case == 'biharmonic':
        assert 'geo_hess_lvl' in prog.sources
        rows = {r for (s, r) in filter(None, prog.leaf_src)
                if prog.sources[s] == 'geo_hess_lvl'}
        # the level-ordered (c, k, l) rows with k <= l only
        assert rows <= {(c * 2 + k) * 2 + l for c in range(2)
                        for k in range(2) for l in range(k, 2)}
    if bd is not None:
        assert prog.params and 'param:Jac_to_boundary' in asm._host_arrays
