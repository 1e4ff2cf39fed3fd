"""Vector-valued and two-space forms, first derivatives of spline input
fields and the updatable ``Assembler`` of the PyTorch port, held against
the JAX package in float64 on the CPU: ``divdiv`` in the blocked and
packed layouts, the vector Laplacian, the two-space ``div(u) * q`` block,
the Navier-Stokes convection forms before and after an update, the
generated K5 program of these forms (run with torch ops) against its
plain version, and the host copies they need (``MLStructure.dense`` /
``join``, the geometry transforms)."""

import functools

import numpy as np
import pytest
import scipy.sparse
import torch

import pyiga_tpu.assemble as jassemble
import pyiga_tpu.assemblers as jassemblers
import pyiga_tpu.bspline as jbspline
import pyiga_tpu.geometry as jgeometry
import pyiga_tpu.mlmatrix as jmlmatrix
from pyiga_tpu import compile as jcompile
from pyiga_tpu import vform as jvform

from pyiga_tpu_torch import (assemble, assemblers, bspline, compile, convert,
                             geometry, mlmatrix, vform)
from pyiga_tpu_torch.approx import interpolate
from pyiga_tpu_torch.ops import cuda_sumfac, cuda_vform

torch.set_num_threads(1)

TOL = 1e-13


def _dense(A):
    return A.toarray() if scipy.sparse.issparse(A) else np.asarray(A)


def _rel(got, ref):
    """Max abs error over max |ref| (both dense or sparse)."""
    got, ref = _dense(got), _dense(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


def _kvs(pkg, p=2, ns=(5, 6)):
    return tuple(pkg.make_knots(p, 0.0, 1.0, n) for n in ns)


def _geo(pkg, name):
    return getattr(pkg, name)()


def _channel(pkg):
    return pkg.unit_square().scale([2, 1])


def _vel_coeffs(kvs, seed=3):
    """Velocity coefficients whose x- and y-derivatives differ."""
    rng = np.random.RandomState(seed)
    m = tuple(kv.numdofs for kv in kvs)
    X, Y = np.meshgrid(np.linspace(0, 1, m[1]), np.linspace(0, 1, m[0]))
    return np.stack((X ** 2 + 0.1 * rng.rand(*m),
                     3 * Y - X + 0.1 * rng.rand(*m)), axis=-1)


# -- host copies -------------------------------------------------------------

def test_mlstructure_dense_and_join_match_jax():
    kvs, jkvs = _kvs(bspline), _kvs(jbspline)
    S = mlmatrix.MLStructure.from_kvs(kvs, kvs).join(
        mlmatrix.MLStructure.dense((2, 3)))
    jS = jmlmatrix.MLStructure.from_kvs(jkvs, jkvs).join(
        jmlmatrix.MLStructure.dense((2, 3)))
    assert S.bs == jS.bs and S.shape == jS.shape
    assert all(np.array_equal(a, b) for a, b in zip(S.bidx, jS.bidx))
    for a, b in zip(S.nonzero(), jS.nonzero()):
        assert np.array_equal(a, b)


@pytest.mark.parametrize('name', ['unit_square', 'quarter_annulus',
                                  'bspline_quarter_annulus', 'twisted_box'])
def test_geometry_transforms_match_jax(name):
    geo, jgeo = _geo(geometry, name), _geo(jgeometry, name)
    d = geo.dim
    A = np.arange(1.0, d * d + 1).reshape(d, d) + np.eye(d)
    grid = tuple(np.linspace(0, 1, 4 + k) for k in range(geo.sdim))
    cases = [(geo.copy(), jgeo.copy()),
             (geo.translate(np.arange(1.0, d + 1)),
              jgeo.translate(np.arange(1.0, d + 1))),
             (geo.scale([2, 1, 3][:d]), jgeo.scale([2, 1, 3][:d])),
             (geo.scale(0.5), jgeo.scale(0.5)),
             (geo.apply_matrix(A), jgeo.apply_matrix(A))]
    if d == 2:
        cases.append((geo.rotate_2d(0.3), jgeo.rotate_2d(0.3)))
    for got, ref in cases:
        assert type(got).__name__ == type(ref).__name__
        assert np.array_equal(got.coeffs, ref.coeffs)
        assert np.abs(got.grid_eval(grid) - ref.grid_eval(grid)).max() \
            <= 1e-15 * np.abs(ref.grid_eval(grid)).max()
    cp = geo.copy()
    cp.coeffs[...] = 0.0
    assert np.abs(geo.coeffs).max() > 0     # a copy, not a view


# -- vector-valued forms -----------------------------------------------------

@pytest.mark.parametrize('dim,layout', [(2, 'blocked'), (2, 'packed'),
                                        (3, 'blocked'), (3, 'packed')])
def test_divdiv_matches_jax(dim, layout):
    """``divdiv`` (port of ``tests/test_vform.py:69``): the JAX package's
    matrix to 1e-13, and a divergence-free field in its kernel."""
    name = 'bspline_quarter_annulus' if dim == 2 else 'twisted_box'
    ns = (5, 6) if dim == 2 else (3, 4, 3)
    kvs, jkvs = _kvs(bspline, 2, ns), _kvs(jbspline, 2, ns)
    fmt = 'bsr' if layout == 'packed' else 'csr'
    A = assemble.divdiv(kvs, _geo(geometry, name), layout=layout,
                        format=fmt, device='cpu')
    ref = jassemble.divdiv(jkvs, _geo(jgeometry, name), layout=layout,
                           format=fmt)
    assert A.format == fmt and _rel(A, ref) <= TOL
    if dim == 2:
        u = interpolate(kvs, lambda x, y: (x, -y),
                        geo=_geo(geometry, name))
        if layout == 'blocked':
            u = np.moveaxis(u, -1, 0)
        assert abs(A.dot(u.ravel())).max() < 1e-12


def test_divdiv_blocks_match_jax():
    """The compact blocks of ``divdiv_vf`` (port of
    ``tests/test_pair_vform.py:97``): the same block keys and data."""
    kvs, jkvs = _kvs(bspline), _kvs(jbspline)
    B = compile.compile_vform(vform.divdiv_vf(2))(
        kvs, geo=geometry.quarter_annulus(), device='cpu').assemble()
    jB = jcompile.compile_vform(jvform.divdiv_vf(2))(
        jkvs, geo=jgeometry.quarter_annulus()).assemble(mode='exact')
    assert sorted(B) == sorted(jB) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for k in jB:
        assert _rel(B[k].data, jB[k].data) <= TOL
    # symmetric operator: block (i, j) is block (j, i) transposed
    assert _rel(B[(0, 1)].asmatrix().T, B[(1, 0)].asmatrix()) <= TOL


@pytest.mark.parametrize('layout', ['blocked', 'packed'])
def test_vector_laplacian_matches_scalar_stiffness(layout):
    """``inner(grad(u), grad(v))`` on two components: the diagonal blocks
    are the scalar stiffness, the off-diagonal ones are pruned."""
    kvs, jkvs = _kvs(bspline, 3, (6, 7)), _kvs(jbspline, 3, (6, 7))
    geo, jgeo = geometry.quarter_annulus(), jgeometry.quarter_annulus()
    form = 'inner(grad(u), grad(v)) * dx'
    bfuns = [('u', 2), ('v', 2)]
    fmt = 'mlb' if layout == 'packed' else 'csr'
    A = assemble.assemble(form, kvs, bfuns=bfuns, geo=geo, layout=layout,
                          format=fmt, device='cpu')
    ref = jassemble.assemble(form, jkvs, bfuns=bfuns, geo=jgeo,
                             layout=layout, format=fmt)
    if layout == 'packed':
        assert _rel(A.data, ref.data) <= TOL
        A = A.asmatrix()
    else:
        assert _rel(A, ref) <= TOL
    S = assemble.stiffness(kvs, geo, device='cpu')
    n = S.shape[0]
    P = np.arange(2 * n).reshape(n, 2).T.ravel() if layout == 'packed' \
        else np.arange(2 * n)
    A = _dense(A)[np.ix_(P, P)]
    for c in range(2):
        blk = A[c * n:(c + 1) * n, c * n:(c + 1) * n]
        assert _rel(blk, S) <= TOL
    assert np.abs(A[:n, n:]).max() == 0.0
    asm = compile.compile_vform(vform.parse_vf(form, kvs, bfuns=bfuns))(
        kvs, geo=geo, device='cpu')
    assert sorted(asm.assemble()) == [(0, 0), (1, 1)]


@pytest.mark.parametrize('layout', ['blocked', 'packed'])
def test_nonsymmetric_vector_form_matches_jax(layout):
    """Port of ``tests/test_vform.py:222``: a nonsymmetric vector form
    with a kernel, its ``multi_blocks``."""
    kvs, jkvs = _kvs(bspline, 2, (5, 5)), _kvs(jbspline, 2, (5, 5))
    geo, jgeo = geometry.quarter_annulus(), jgeometry.quarter_annulus()
    problem = 'inner(as_matrix([[2,1],[0,0]]).dot(u), v) * dx'
    bfuns = [('u', 2), ('v', 2)]
    fmt = 'bsr' if layout == 'packed' else 'csr'
    A = assemble.assemble(problem, kvs, geo=geo, bfuns=bfuns, layout=layout,
                          format=fmt, device='cpu')
    ref = jassemble.assemble(problem, jkvs, geo=jgeo, bfuns=bfuns,
                             layout=layout, format=fmt)
    assert _rel(A, ref) <= TOL
    u = interpolate(kvs, lambda x, y: (x * y, -2 * x * y), geo=geo)
    if layout == 'blocked':
        u = np.moveaxis(u, -1, 0)
    assert np.allclose(A @ u.ravel(), 0)
    if layout == 'packed':
        idx = [(0, 0), (0, 1), (2, 1), (7, 3)]
        asm = assemble.instantiate_assembler(problem, kvs, {'geo': geo},
                                             bfuns, device='cpu')
        jasm = jassemble.instantiate_assembler(problem, jkvs, {'geo': jgeo},
                                               bfuns)
        blocks = asm.multi_blocks(idx)
        assert _rel(blocks, jasm.multi_blocks(idx)) <= TOL
        AA = A.toarray()
        for b, (i, j) in zip(blocks, idx):
            assert np.allclose(b, AA[2 * i:2 * i + 2, 2 * j:2 * j + 2])
        assert asm.num_components() == jasm.num_components() == (2, 2)


def test_vector_assembly_pruned_block():
    """Port of ``tests/test_assemble.py:225``: a form touching one block
    gets explicit zero blocks in the blocked layout."""
    kvs, jkvs = _kvs(bspline, 2, (5, 5)), _kvs(jbspline, 2, (5, 5))
    A = assemble.assemble('u[0] * v[0] * dx', kvs, bfuns=[('u', 2), ('v', 2)],
                          geo=geometry.unit_square(), device='cpu')
    ref = jassemble.assemble('u[0] * v[0] * dx', jkvs,
                             bfuns=[('u', 2), ('v', 2)],
                             geo=jgeometry.unit_square())
    n = kvs[0].numdofs * kvs[1].numdofs
    assert A.shape == (2 * n, 2 * n) and _rel(A, ref) <= TOL
    assert abs(A[:n, :n]).max() > 0 and abs(A[n:, n:]).max() == 0


@pytest.mark.parametrize('layout', ['blocked', 'packed'])
def test_vector_functional_matches_jax(layout):
    """Port of the ``f * div(v)`` functional of ``tests/test_vform.py:
    104``: the component axis trails (packed) or leads (blocked)."""
    kvs, jkvs = _kvs(bspline), _kvs(jbspline)

    def f(x, y):
        return x * y ** 2
    b = assemble.assemble('f * div(v) * dx', kvs, bfuns=[('v', 2)],
                          geo=geometry.quarter_annulus(), f=f, layout=layout,
                          device='cpu')
    ref = jassemble.assemble('f * div(v) * dx', jkvs, bfuns=[('v', 2)],
                             geo=jgeometry.quarter_annulus(), f=f,
                             layout=layout)
    assert b.shape == ref.shape and _rel(b, ref) <= TOL
    assert b.shape[0 if layout == 'blocked' else -1] == 2


def test_assemble_vector_pruned_component():
    """Port of ``tests/test_pair_vform.py:280``: a pruned component of a
    vector functional assembles to zeros."""
    kvs = _kvs(bspline, 2, (5, 5))

    def build(mod):
        V = mod.VForm(2, arity=1)
        v = V.basisfuns(components=(2,))
        V.add(V.input('f') * v[0] * mod.dx)
        return V
    b = compile.compile_vform(build(vform))(
        kvs, geo=geometry.quarter_annulus(), f=lambda x, y: 1.0 + 0 * x,
        device='cpu').assemble_vector()
    ref = jcompile.compile_vform(build(jvform))(
        _kvs(jbspline, 2, (5, 5)), geo=jgeometry.quarter_annulus(),
        f=lambda x, y: 1.0 + 0 * x).assemble_vector()
    assert b.shape == ref.shape and b.shape[-1] == 2
    assert _rel(b, ref) <= TOL
    assert abs(b[..., 0]).max() > 0 and abs(b[..., 1]).max() == 0


def test_updatable_assembler_matches_jax():
    """Port of ``tests/test_vform.py:245``, and the checks of
    ``Assembler``'s updatable names."""
    kvs, jkvs = _kvs(bspline, 2, (6, 6)), _kvs(jbspline, 2, (6, 6))
    asm = assemble.Assembler('c * u * v * dx', kvs, geo=geometry.unit_square(),
                             c=lambda x, y: 1.0 + 0 * x, updatable=['c'],
                             device='cpu')
    M1 = asm.assemble()
    assert _rel(M1, assemble.mass(kvs, geometry.unit_square(),
                                  device='cpu')) <= TOL
    M2 = asm.assemble(c=lambda x, y: 2.0 + x * y)
    jasm = jassemble.Assembler('c * u * v * dx', jkvs,
                               geo=jgeometry.unit_square(),
                               c=lambda x, y: 1.0 + 0 * x, updatable=['c'])
    jasm.assemble()
    assert _rel(M2, jasm.assemble(c=lambda x, y: 2.0 + x * y)) <= TOL
    with pytest.raises(RuntimeError):
        asm.assemble(f=geometry.unit_square())
    with pytest.raises(ValueError):
        assemble.Assembler('c * u * v * dx', kvs, geo=geometry.unit_square(),
                           c=lambda x, y: x, updatable=['f'], device='cpu')


# -- two spaces ---------------------------------------------------------------

def _ns_spaces(pkg, ns=(5, 8)):
    return (tuple(pkg.make_knots(2, 0.0, 1.0, n) for n in ns),
            tuple(pkg.make_knots(1, 0.0, 1.0, n) for n in ns))


@pytest.mark.parametrize('call', ['assemble', 'positional', 'keyword'])
def test_two_space_divergence_block_matches_jax(call):
    """``div(u) * q * dx`` on (velocity p=2, pressure p=1): rows are the
    test (pressure) space, columns the trial (velocity) space."""
    (ku, kp), (jku, jkp) = _ns_spaces(bspline), _ns_spaces(jbspline)
    bfuns = [('u', 2, 0), ('q', 1, 1)]
    form = 'div(u) * q * dx'
    ref = jassemble.assemble(form, (jku, jkp), bfuns=bfuns,
                             geo=_channel(jgeometry))
    if call == 'assemble':
        A = assemble.assemble(form, (ku, kp), bfuns=bfuns,
                              geo=_channel(geometry), device='cpu')
    else:
        cls = compile.compile_vform(vform.parse_vf(form, (ku, kp),
                                                   bfuns=bfuns))
        asm = (cls(ku, kp, _channel(geometry), device='cpu')
               if call == 'positional' else
               cls(ku, kvs2=kp, geo=_channel(geometry), device='cpu'))
        assert asm.kvs1 == kp and asm._fold_plan is None
        assert len(asm.grid[0]) == 3 * 5       # nqp = 3 over both spaces
        A = assemble.assemble_entries(asm)
    n_u = 2 * np.prod([kv.numdofs for kv in ku])
    n_p = np.prod([kv.numdofs for kv in kp])
    assert A.shape == (n_p, n_u) and _rel(A, ref) <= TOL


# -- input fields with first derivatives -------------------------------------

CONV_FORMS = {
    'nlconv': ('grad(vel).dot(vel).dot(v) * dx', [('v', 2)]),
    'linconv': ('grad(u).dot(vel).dot(v) * dx', [('u', 2), ('v', 2)]),
}


@functools.lru_cache(maxsize=None)
def _conv_pair(name):
    form, bfuns = CONV_FORMS[name]
    (ku, _), (jku, _) = _ns_spaces(bspline), _ns_spaces(jbspline)
    C = _vel_coeffs(ku)
    asm = assemble.Assembler(form, ku, bfuns=bfuns, geo=_channel(geometry),
                             vel=geometry.BSplineFunc(ku, C),
                             updatable=['vel'], device='cpu')
    jasm = jassemble.Assembler(form, jku, bfuns=bfuns,
                               geo=_channel(jgeometry),
                               vel=jgeometry.BSplineFunc(jku, C),
                               updatable=['vel'])
    return asm, jasm


@pytest.mark.parametrize('name', list(CONV_FORMS))
def test_convection_forms_match_jax_before_and_after_update(name):
    """The Navier-Stokes convection forms with a seeded spline ``vel`` on
    the non-square (5, 8) grid, before and after ``update(vel=...)``;
    the derivative field ``ideriv:vel:1`` (XYZ axis) equals JAX's."""
    asm, jasm = _conv_pair(name)
    ku, jku = asm.asm.kvs0, jasm.asm.kvs0
    for layout in ('blocked', 'packed'):
        assert _rel(asm.assemble(layout=layout),
                    jasm.assemble(layout=layout)) <= TOL
    assert asm.asm.combos == jasm.asm.combos
    C2 = _vel_coeffs(ku, seed=5)[::-1]
    got = asm.assemble(vel=geometry.BSplineFunc(ku, C2))
    ref = jasm.assemble(vel=jgeometry.BSplineFunc(jku, C2))
    assert _rel(got, ref) <= TOL
    keys = [k for k in jasm.asm._host_arrays if k.startswith('ideriv')]
    assert keys == (['ideriv:vel:1'] if name == 'nlconv' else [])
    for k in keys:
        D = asm.asm._host_arrays[k]
        assert D.shape == (2, 2) + tuple(len(g) for g in asm.asm.grid)
        assert _rel(D, jasm.asm._host_arrays[k]) <= TOL
        # x- and y-derivatives differ on this field
        assert np.abs(D[:, 0] - D[:, 1]).max() > 0.1


@pytest.mark.parametrize('name', list(CONV_FORMS))
def test_run_device_inputs_equal_update(name):
    """``run_device(inputs=...)`` with the new velocity fields as tensors
    gives the blocks of ``update(vel=...)`` and leaves the cached
    operands as they were."""
    asm = _conv_pair(name)[0].asm
    ku = asm.kvs0
    C2 = _vel_coeffs(ku, seed=7)
    before = {k: v.clone() for k, v in asm.run_device().items()}
    inp = next(i for i in asm.vf.inputs if i.name == 'vel')
    new = asm._eval_input(inp, geometry.BSplineFunc(ku, C2))
    got = asm.run_device(inputs={k: torch.as_tensor(v)
                                 for k, v in new.items()})
    again = asm.run_device()
    for k in before:
        assert torch.equal(again[k], before[k])
    asm.update(vel=geometry.BSplineFunc(ku, C2))
    ref = asm.run_device()
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k])
    with pytest.raises(ValueError):
        asm.run_device(inputs={'input:vel': torch.zeros(3)})


# -- K5's generated program for these forms -----------------------------------

def _vec_asm(name):
    """(port assembler, JAX assembler) of the vector / two-space forms."""
    if name in CONV_FORMS:
        asm, jasm = _conv_pair(name)
        C = _vel_coeffs(asm.asm.kvs0)       # other tests update them
        asm.update(vel=geometry.BSplineFunc(asm.asm.kvs0, C))
        jasm.update(vel=jgeometry.BSplineFunc(jasm.asm.kvs0, C))
        return asm.asm, jasm.asm
    (ku, kp), (jku, jkp) = _ns_spaces(bspline), _ns_spaces(jbspline)
    if name == 'divdiv':
        return (compile.compile_vform(vform.divdiv_vf(2))(
                    ku, geo=_channel(geometry), device='cpu'),
                jcompile.compile_vform(jvform.divdiv_vf(2))(
                    jku, geo=_channel(jgeometry)))
    form, bfuns = {'veclap': ('inner(grad(u), grad(v)) * dx',
                              [('u', 2), ('v', 2)]),
                   'div_q': ('div(u) * q * dx',
                             [('u', 2, 0), ('q', 1, 1)])}[name]
    spaces = ((ku, kp), (jku, jkp)) if name == 'div_q' else (ku, jku)
    asm = assemble.instantiate_assembler(form, spaces[0],
                                         {'geo': _channel(geometry)}, bfuns,
                                         device='cpu')
    jasm = jassemble.instantiate_assembler(form, spaces[1],
                                           {'geo': _channel(jgeometry)},
                                           bfuns)
    return asm, jasm


@pytest.mark.parametrize('name', ['divdiv', 'veclap', 'div_q', 'nlconv',
                                  'linconv'])
def test_generated_program_matches_plain(name):
    """K5 for the NS forms: the generated program run with torch ops from
    the leaves' source tensors (the kernel's operands: ``input:vel`` and
    ``ideriv:vel:1`` read in place) against ``combo_fields_plain`` and
    JAX's ``_eval_combo_fields``, with the same pruned combos."""
    asm, jasm = _vec_asm(name)
    assert asm.combos == jasm.combos
    assert asm._fold_plan is None and jasm._fold_plan is None
    ref = [np.asarray(F) for F in
           jasm._eval_combo_fields(jasm._device_inputs(), jasm.combos)]
    scale = max(np.abs(F).max() for F in ref)
    arrays = asm.device_arrays()
    plain = cuda_vform.combo_fields_plain(asm, arrays, asm.combos)
    prog = asm._program(asm.combos)
    if name == 'nlconv':
        assert sorted(prog.sources) == ['geo_jac_lvl', 'ideriv:vel:1',
                                        'input:vel']
        assert any(k[0] == 'ideriv' for k in prog.leaves)
        assert 'ideriv' in ''.join(prog.sources) and \
            '__ldg(s' in prog.source
    run = cuda_vform.run_program_plain(prog, arrays)
    for c, R in enumerate(ref):
        assert np.abs(plain[c].numpy() - R).max() / scale < TOL
        assert np.abs(run[c].numpy() - R.ravel()).max() / scale < TOL


def test_vform_arrays_carry_input_derivatives():
    """JAX's host arrays, converted, drive the port's plain fields of the
    nonlinear convection form to JAX's values."""
    asm, jasm = _vec_asm('nlconv')
    arrays = convert.vform_arrays(jasm._host_arrays, device='cpu')
    ops = asm._device_operands()
    arrays['geo_val_lvl'], arrays['geo_jac_lvl'] = \
        cuda_sumfac.geometry_fields(ops['geo_tables'], ops['geo_coeffs'],
                                    asm._geo_is_nurbs)
    got = cuda_vform.combo_fields_plain(asm, arrays, asm.combos)
    ref = jasm._eval_combo_fields(jasm._device_inputs(), jasm.combos)
    for a, b in zip(got, ref):
        assert _rel(a.numpy(), np.asarray(b)) <= TOL


# -- predefined names ---------------------------------------------------------

@pytest.mark.parametrize('dim', [2, 3])
def test_divdiv_assembler_names_match_jax(dim):
    ns = (5, 6) if dim == 2 else (3, 4, 3)
    kvs, jkvs = _kvs(bspline, 2, ns), _kvs(jbspline, 2, ns)
    name = 'quarter_annulus' if dim == 2 else 'twisted_box'
    cls = getattr(assemblers, 'DivDivAssembler%dD' % dim)
    jcls = getattr(jassemblers, 'DivDivAssembler%dD' % dim)
    asm = cls(kvs, _geo(geometry, name), device='cpu')
    jasm = jcls(jkvs, _geo(jgeometry, name))
    assert cls is getattr(assemblers, 'DivDivAssembler%dD' % dim)
    assert asm.num_components() == jasm.num_components() == (dim, dim)
    for layout in ('blocked', 'packed'):
        assert _rel(assemble.assemble_entries_vec(asm, layout=layout),
                    jassemble.assemble_entries_vec(jasm, layout=layout)) \
            <= TOL
    with pytest.raises(ValueError):
        assemble.assemble_entries(asm, format='mlb')
