"""Generic VForm assembly of the PyTorch port held against the JAX
package (``assemble.assemble(..., mode='exact')``) and the golden
fixtures, and the compact-matrix matvec against the expanded matrix (all
float64 on the CPU, through the kernels' plain versions)."""

import os

import numpy as np
import pytest
import torch

import pyiga_tpu.bspline as jbspline
import pyiga_tpu.geometry as jgeometry
from pyiga_tpu import assemble as jassemble

from pyiga_tpu_torch import assemble, bspline, convert, geometry
from pyiga_tpu_torch.ops import cuda_sumfac, cuda_vform, sumfac
from pyiga_tpu_torch.ops.mlmatvec import make_ml_matvec, ml_matvec

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'fixtures')

CONVDIFF = '(inner(grad(u), grad(v)) + dot(b, grad(u)) * v + u * v) * dx'


def _physical_f(*x):
    return np.cos(x[0]) + x[-1] ** 2


# (form, geometry, degree, spans, inputs)
CASES = [
    (CONVDIFF, 'quarter_annulus', 3, 12, {'b': np.array([3.0, -2.0])}),
    ('v * dx', 'quarter_annulus', 3, 12, {}),
    ('inner(grad(u), grad(v)) * dx', 'twisted_box', 2, 4, {}),
    ('f * v * dx', 'twisted_box', 2, 4, {'f': _physical_f}),
]


@pytest.mark.parametrize('form,geo,p,n,args', CASES)
def test_assemble_matches_jax(form, geo, p, n, args):
    dim = getattr(geometry, geo)().sdim
    kvs = dim * (bspline.make_knots(p, 0.0, 1.0, n),)
    jkvs = dim * (jbspline.make_knots(p, 0.0, 1.0, n),)
    got = assemble.assemble(form, kvs, geo=getattr(geometry, geo)(),
                            device='cpu', **args)
    ref = jassemble.assemble(form, jkvs, geo=getattr(jgeometry, geo)(),
                             mode='exact', **args)
    if hasattr(ref, 'tocsr'):
        assert got.shape == ref.shape
        assert abs(got - ref).max() <= 1e-13 * abs(ref).max()
    else:
        ref = np.asarray(ref)
        assert got.shape == ref.shape and got.dtype == np.float64
        assert np.abs(got - ref).max() <= 1e-13 * np.abs(ref).max()


@pytest.mark.parametrize('form,fixture', [
    ('inner(grad(u), grad(v)) * dx', 'poisson_neu_d2_p3_n15_stiff.mtx.gz'),
    ('u * v * dx', 'poisson_neu_d2_p3_n15_mass.mtx.gz'),
])
def test_vform_golden_fixtures(form, fixture):
    """The VForm path (K1 `jac` B-spline branch, K5, folded chains) on
    the geometry of the JAX package's 2D golden tests."""
    kv = bspline.make_knots(3, 0.0, 1.0, 15)
    A = assemble.assemble(form, (kv, kv),
                          geo=geometry.bspline_quarter_annulus(), device='cpu')
    data = np.loadtxt(os.path.join(FIXTURES, fixture), skiprows=1, ndmin=2)
    ij = data[:, :2].astype(np.intp) - 1
    ref = np.zeros(A.shape)
    ref[ij[:, 0], ij[:, 1]] = data[:, 2]
    assert np.abs(A.toarray() - ref).max() < 1e-14


def test_ml_matvec_matches_expanded_matrix():
    kvs = 2 * (bspline.make_knots(3, 0.0, 1.0, 9),)
    M = assemble.assemble(CONVDIFF, kvs, geo=geometry.quarter_annulus(),
                          b=np.array([3.0, -2.0]), format='mlb',
                          device='cpu')
    x = np.random.RandomState(1).rand(M.shape[1])
    ref = M.asmatrix() @ x
    op = make_ml_matvec(M, device='cpu')
    y = op(torch.as_tensor(x))
    assert y.shape == (M.shape[0],) and op.ns == (12, 12)
    assert np.abs(y.numpy() - ref).max() <= 1e-14 * np.abs(ref).max()
    S = M.structure
    Y = ml_matvec(torch.as_tensor(M.data), S.bidx,
                  [b[0] for b in S.bs], [b[1] for b in S.bs],
                  torch.as_tensor(x))
    assert Y.shape == (12, 12) and torch.equal(Y.reshape(-1), y)


def test_mlmatrix_from_jax():
    """A JAX compact matrix carried over by ``convert.mlmatrix`` expands
    to the same scipy matrix, and the port's own assembly of the same
    form gives the same compact data."""
    kvs = 2 * (jbspline.make_knots(2, 0.0, 1.0, 6),)
    jM = jassemble.assemble(CONVDIFF, kvs, geo=jgeometry.quarter_annulus(),
                            b=np.array([3.0, -2.0]), format='mlb',
                            mode='exact')
    M = convert.mlmatrix(jM)
    assert abs(M.asmatrix() - jM.asmatrix()).max() == 0.0
    own = assemble.assemble(CONVDIFF, 2 * (bspline.make_knots(2, 0.0, 1.0,
                                                              6),),
                            geo=geometry.quarter_annulus(),
                            b=np.array([3.0, -2.0]), format='mlb',
                            device='cpu')
    assert own.datashape == M.datashape
    assert np.abs(own.data - M.data).max() <= 1e-13 * np.abs(M.data).max()


def test_folded_assembly_matches_reference_chain():
    """The device-path folded assembly (K2 chains, K3 fold, transpose
    gather) equals the plain tensordot reference ``ops.sumfac.
    assemble_terms_folded`` on the same fields and plan."""
    kvs = 2 * (bspline.make_knots(2, 0.0, 1.0, 5),)
    asm = assemble.instantiate_assembler(
        CONVDIFF, kvs, {'geo': geometry.bspline_quarter_annulus(),
                        'b': np.array([1.0, 2.0])}, None, device='cpu')
    assert asm._fold_plan is not None and any(m for _t, m in asm._fold_plan)
    ops = asm._device_operands()
    fields = cuda_vform.combo_fields(asm, asm.device_arrays(), asm.combos)
    got = cuda_sumfac.assemble_terms_folded(
        ops['term_tables'], fields, asm._fold_plan, ops['tperms'],
        ops['last_idx'])
    ref = sumfac.assemble_terms_folded(
        ops['term_tables'], fields, asm._fold_plan, ops['tperms'])
    assert torch.allclose(got, ref, rtol=0, atol=1e-15 * ref.abs().max())


def _heat_st_space(bs, geo_mod):
    kv_t = bs.make_knots(2, 0.0, 2.0, 6)
    kv = bs.make_knots(3, 0.0, 1.0, 8)
    geo = geo_mod.unit_cube(dim=1).cylinderize(0.0, 2.0, support=(0.0, 2.0))
    return (kv_t, kv), geo


def test_assembler_positional_args():
    """The reference's predefined assembler names take ``(kvs, geo)``
    positionally, as its generated assemblers do."""
    from pyiga_tpu import assemblers as jassemblers
    from pyiga_tpu_torch import assemblers
    kvs, geo = _heat_st_space(bspline, geometry)
    asm_pos = assemblers.HeatAssembler_ST2D(kvs, geo, device='cpu')
    asm_kw = assemblers.HeatAssembler_ST2D(kvs, geo=geo, device='cpu')
    A1 = assemble.assemble_entries(asm_pos)
    A2 = assemble.assemble_entries(asm_kw)
    assert abs(A1 - A2).max() < 1e-15
    jkvs, jgeo = _heat_st_space(jbspline, jgeometry)
    ref = jassemble.assemble_entries(jassemblers.HeatAssembler_ST2D(
        jkvs, jgeo), mode='exact')
    assert A1.shape == ref.shape and abs(A1 - ref).max() < 1e-14
    assert assemblers.HeatAssembler_ST2D is assemblers.HeatAssembler_ST2D
    # the vector-valued name, positional too, gives JAX's blocks
    kvs2 = 2 * (bspline.make_knots(2, 0.0, 1.0, 4),)
    jkvs2 = 2 * (jbspline.make_knots(2, 0.0, 1.0, 4),)
    D = assemble.assemble_entries(assemblers.DivDivAssembler2D(
        kvs2, geometry.quarter_annulus(), device='cpu'))
    Dref = jassemble.assemble_entries(jassemblers.DivDivAssembler2D(
        jkvs2, jgeometry.quarter_annulus()), mode='exact')
    assert D.shape == Dref.shape and abs(D - Dref).max() < 1e-14


def test_assembler_positional_non_geo_input():
    """Positional binding skips the implicit ``geo`` input: ``(kvs, geo,
    coef)`` binds `coef` to the declared input."""
    import pyiga_tpu.vform as jvform
    from pyiga_tpu.compile import compile_vform as jcompile_vform
    from pyiga_tpu_torch import vform
    from pyiga_tpu_torch.compile import compile_vform

    def form(mod):
        V = mod.VForm(2)
        u, v = V.basisfuns()
        coef = V.input('coef')
        V.add(coef * mod.inner(mod.grad(u), mod.grad(v)) * mod.dx)
        return V

    def cf(x, y):
        return 1.0 + x * y
    cls = compile_vform(form(vform))
    kvs = 2 * (bspline.make_knots(2, 0.0, 1.0, 6),)
    geo = geometry.quarter_annulus()
    A_pos = assemble.assemble_entries(cls(kvs, geo, cf, device='cpu'))
    A_kw = assemble.assemble_entries(cls(kvs, geo=geo, coef=cf,
                                         device='cpu'))
    assert abs(A_pos - A_kw).max() < 1e-15
    jcls = jcompile_vform(form(jvform))
    ref = jassemble.assemble_entries(
        jcls(2 * (jbspline.make_knots(2, 0.0, 1.0, 6),),
             jgeometry.quarter_annulus(), cf), mode='exact')
    assert abs(A_pos - ref).max() < 1e-14
    with pytest.raises(TypeError):
        cls(kvs, geo, cf, cf, device='cpu')
