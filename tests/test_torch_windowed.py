"""The windowed assembly route of the PyTorch port (host tables, the plain
route, kernels K8 and K8f by their plain versions, ``assemble_windowed``)
and the regular banded layout (``BandedOperator`` and its helpers), held
against the JAX package, the golden stiffness fixtures and the
expanded matrix."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pyiga_tpu.bspline as jbspline
import pyiga_tpu.geometry as jgeometry
from pyiga_tpu import assemblers as jassemblers
from pyiga_tpu.ops import banded as jbanded
from pyiga_tpu.ops import sumfac as jsumfac
from pyiga_tpu.utils import read_sparse_matrix

from pyiga_tpu_torch import assemblers, bspline, geometry
from pyiga_tpu_torch.mlmatrix import MLStructure
from pyiga_tpu_torch.ops import banded, cuda_sumfac, sumfac
from pyiga_tpu_torch.ops.fastdiag import interior_dofs
from pyiga_tpu_torch.ops.matfree import RestrictedOperator

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), 'fixtures')

# (geometry, degrees, elements per axis): an anisotropic 3D space with a
# degree a axis, and a 2D space whose first axis has one window (p=3 on
# 4 spans: nwin = 1)
SPACES = {'aniso3d': ('twisted_box', (2, 3, 2), (4, 5, 3)),
          'nwin1': ('quarter_annulus', (3, 3), (4, 6))}


def _kvs(mod, degs, nels):
    return tuple(mod.make_knots(p, 0.0, 1.0, n) for p, n in zip(degs, nels))


def _pair(name, kind='StiffnessAssembler'):
    """The JAX and the port's assembler on one space (the port's on the
    CPU)."""
    geo, degs, nels = SPACES[name]
    jasm = getattr(jassemblers, kind)(_kvs(jbspline, degs, nels),
                                      getattr(jgeometry, geo)())
    asm = getattr(assemblers, kind)(_kvs(bspline, degs, nels),
                                    getattr(geometry, geo)(), device='cpu')
    return jasm, asm


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize('name', sorted(SPACES))
def test_windowed_host_tables_equal_jax(name):
    jasm, asm = _pair(name)
    assert asm.tables.nqps == jasm.tables.nqps
    assert asm.tables.kvs0 == asm.tables.kvs1 == asm.kvs
    for k in range(asm.dim):
        for du in (0, 1):
            for dv in (0, 1):
                P, fs = asm.tables.windowed_pair_table(k, du, dv)
                jP, jfs = jasm.tables.windowed_pair_table(k, du, dv)
                assert np.array_equal(P, jP) and np.array_equal(fs, jfs)
    tabs, fss = asm.tables.windowed_term_tables(asm.terms)
    jtabs, jfss = jasm.tables.windowed_term_tables(jasm.terms)
    assert all(np.array_equal(a, b) for ta, tb in zip(tabs, jtabs)
               for a, b in zip(ta, tb))
    assert all(np.array_equal(a, b) for a, b in zip(fss, jfss))
    # the pair-table cache interns shared tables, as the reference's
    assert tabs[0][1] is asm.tables.windowed_pair_table(1, 0, 0)[0]


@pytest.mark.parametrize('name', sorted(SPACES))
def test_banded_index_maps_equal_jax(name):
    jasm, asm = _pair(name)
    bws = banded.band_info(asm.structure)
    assert bws == jbanded.band_info(jasm.structure)
    for a, b in zip(sumfac.compact_from_banded_maps(asm.structure, bws),
                    jsumfac.compact_from_banded_maps(jasm.structure, bws)):
        assert np.array_equal(a, b)
    for (mu, i), (jmu, ji) in zip(
            banded.compact_to_banded_indices(asm.structure, bws),
            jbanded.compact_to_banded_indices(jasm.structure, bws)):
        assert np.array_equal(mu, jmu) and np.array_equal(i, ji)
    for a, b in zip(banded.banded_gather_maps(asm.structure, bws),
                    jbanded.banded_gather_maps(jasm.structure, bws)):
        assert np.array_equal(a, b)
    data = np.random.RandomState(0).rand(*[len(b)
                                           for b in asm.structure.bidx])
    D = banded.banded_from_compact(data, asm.structure, bws)
    assert np.array_equal(D, jbanded.banded_from_compact(data, jasm.structure,
                                                         bws))


def _stage_case(name, k, seed):
    """Axis `k` of a space: its stiffness (du=1, dv=0) windowed table,
    window starts and nqp, and a seeded field (Q_k, 3, 5)."""
    _jasm, asm = _pair(name)
    P, fs = asm.tables.windowed_pair_table(k, 1, 0)
    nqp = asm.tables.nqps[k]
    X = np.random.RandomState(seed).rand(asm.tables.trial[k].shape[2], 3, 5)
    return P, fs, nqp, X


@pytest.mark.parametrize('name,k', [('aniso3d', 0), ('aniso3d', 1),
                                    ('nwin1', 0), ('nwin1', 1)])
def test_windowed_stage_plain_vs_jax(name, k):
    P, fs, nqp, X = _stage_case(name, k, seed=k + 1)
    got = sumfac.windowed_stage_plain(torch.as_tensor(X), torch.as_tensor(P),
                                      fs, nqp)
    ref = jsumfac._windowed_stage(jnp.asarray(X), jnp.asarray(P),
                                  jnp.asarray(fs), nqp)
    assert got.shape == ref.shape == (3, 5, P.shape[0] * P.shape[1])
    assert _rel(got.numpy(), ref) <= 1e-14


def _fields(asm, seed):
    """Seeded coefficient fields on the Gauss grid, one a term."""
    grid = tuple(len(g) for g in asm.grid)
    rng = np.random.RandomState(seed)
    return [rng.rand(*grid) for _ in asm.terms]


@pytest.mark.parametrize('name', sorted(SPACES))
def test_contract_chain_windowed_vs_jax(name):
    jasm, asm = _pair(name)
    tabs, fss = asm.tables.windowed_term_tables(asm.terms)
    F = _fields(asm, 2)[0]
    got = sumfac.contract_chain_windowed(
        [torch.as_tensor(T) for T in tabs[1]], fss, asm.tables.nqps,
        torch.as_tensor(F))
    ref = jsumfac.contract_chain_windowed(
        [jnp.asarray(T) for T in tabs[1]], [jnp.asarray(f) for f in fss],
        jasm.tables.nqps, jnp.asarray(F))
    assert _rel(got.numpy(), ref) <= 1e-14


@pytest.mark.parametrize('name', sorted(SPACES))
@pytest.mark.parametrize('folded', [False, True])
def test_assemble_terms_windowed_vs_jax(name, folded):
    """The plain route and the device route (on CPU tensors: the halved
    direct terms in the one accumulator, one mirror) against the
    reference's assemble_terms_windowed, with and without a fold plan."""
    jasm, asm = _pair(name)
    tabs, fss = asm.tables.windowed_term_tables(asm.terms)
    F = _fields(asm, 3)
    plan = tperms = None
    if folded:
        plan = asm._fold()
        bws = banded.band_info(asm.structure)
        ns = tuple(b[0] for b in asm.structure.bs)
        tperms = [sumfac.banded_transpose_perm(n, bw)
                  for n, bw in zip(ns, bws)]
    ref = np.asarray(jsumfac.assemble_terms_windowed(
        [[jnp.asarray(T) for T in ta] for ta in tabs],
        [jnp.asarray(f) for f in fss], jasm.tables.nqps,
        [jnp.asarray(f) for f in F], plan,
        None if tperms is None else [jnp.asarray(p) for p in tperms]))
    ttabs = [[torch.as_tensor(T) for T in ta] for ta in tabs]
    tF = [torch.as_tensor(f) for f in F]
    got = sumfac.assemble_terms_windowed(ttabs, fss, asm.tables.nqps, tF,
                                         plan, tperms)
    assert _rel(got.numpy(), ref) <= 1e-14
    dev = cuda_sumfac.assemble_terms_windowed(
        ttabs, [torch.as_tensor(f) for f in fss], asm.tables.nqps, tF, plan,
        None if tperms is None else [torch.as_tensor(p) for p in tperms])
    assert dev.shape == got.shape
    assert _rel(dev.numpy(), ref) <= 1e-14


WINDOWED_CASES = [(2, 2, 6, 'MassAssembler'), (2, 2, 6, 'StiffnessAssembler'),
                  (2, 3, 6, 'MassAssembler'), (2, 3, 6, 'StiffnessAssembler'),
                  (3, 2, 5, 'MassAssembler'), (3, 2, 5, 'StiffnessAssembler')]


@pytest.mark.parametrize('d,p,n,kind', WINDOWED_CASES)
def test_assemble_windowed_vs_jax_exact(d, p, n, kind):
    """A non-slow port of tests/test_ops.py's test_windowed_assembly: the
    port's windowed route against the JAX package's exact assembly (and,
    for one 2D and one 3D case, against its own windowed route)."""
    geo = 'twisted_box' if d == 3 else 'quarter_annulus'
    jasm = getattr(jassemblers, kind)(
        d * (jbspline.make_knots(p, 0.0, 1.0, n),), getattr(jgeometry, geo)())
    asm = getattr(assemblers, kind)(d * (bspline.make_knots(p, 0.0, 1.0, n),),
                                    getattr(geometry, geo)(), device='cpu')
    A = asm.assemble_windowed().asmatrix()
    A_ref = jasm.assemble(mode='exact').asmatrix()
    assert abs(A - A_ref).max() / abs(A_ref).max() <= 1e-14
    if (d, p) in ((2, 3), (3, 2)) and kind == 'StiffnessAssembler':
        A_win = jasm.assemble_windowed().asmatrix()
        assert abs(A - A_win).max() / abs(A_win).max() <= 1e-14


@pytest.mark.parametrize('fixture,name,p,n', [
    ('poisson_neu_d3_p2_n10_stiff.mtx.gz', 'twisted_box', 2, 10),
    ('poisson_neu_d2_p3_n15_stiff.mtx.gz', 'bspline_quarter_annulus', 3, 15),
])
def test_windowed_golden_stiffness(fixture, name, p, n):
    geo = getattr(geometry, name)()
    asm = assemblers.StiffnessAssembler(
        geo.sdim * (bspline.make_knots(p, 0.0, 1.0, n),), geo, device='cpu')
    A = asm.assemble_windowed().asmatrix()
    A_ref = read_sparse_matrix(os.path.join(FIXTURES, fixture))
    assert A.shape == A_ref.shape
    assert abs(A - A_ref).max() < 1e-14


def test_windowed_wrappers_cpu_equal_plain():
    """K8 and K8f on CPU tensors run their plain versions; a fold of more
    than 16 terms (several launches on the card) likewise."""
    _jasm, asm = _pair('aniso3d')
    rng = np.random.RandomState(4)
    P = [torch.as_tensor(asm.tables.windowed_pair_table(2, du, dv)[0])
         for du, dv in ((0, 0), (0, 1), (1, 1))]
    fs = torch.as_tensor(asm.tables.windowed_pair_table(2, 0, 0)[1])
    nqp = asm.tables.nqps[2]
    Q = asm.tables.trial[2].shape[2]
    X = torch.as_tensor(rng.rand(Q, 37))
    assert torch.equal(cuda_sumfac.windowed_stage(X, P[1], fs, nqp),
                       sumfac.windowed_stage_plain(X, P[1], fs, nqp))
    xs = [torch.as_tensor(rng.rand(Q, 37)) for _ in range(18)]
    idx = [t % 3 for t in range(18)]
    got = cuda_sumfac.windowed_fold(xs, P, idx, fs, nqp)
    assert torch.equal(got, cuda_sumfac.windowed_fold_plain(xs, P, idx, fs,
                                                            nqp))
    ref = sum(sumfac.windowed_stage_plain(x, P[i], fs, nqp)
              for x, i in zip(xs, idx))
    assert _rel(got.numpy(), ref.numpy()) <= 1e-14
    with pytest.raises(ValueError):
        cuda_sumfac.windowed_stage(X[:-1], P[1], fs, nqp)     # Q % nqp
    with pytest.raises(ValueError):
        cuda_sumfac.windowed_fold(xs, P, idx[:-1], fs, nqp)
    with pytest.raises(ValueError):
        cuda_sumfac.windowed_fold(xs, P, [3] + idx[1:], fs, nqp)
    with pytest.raises(ValueError):
        cuda_sumfac.windowed_stage(X, P[1], fs[:-1], nqp)


def _tables(kv0, kv1):
    grid, _ = sumfac.quadrature_for((kv0,))
    return sumfac.SpaceTables((kv0,), (kv1,), grid,
                              MLStructure.from_kvs((kv0,), (kv1,)).bidx, 1)


def test_windowed_value_errors():
    # equal dof counts, unequal degrees (7 dofs each)
    st = _tables(bspline.make_knots(2, 0.0, 1.0, 5),
                 bspline.make_knots(3, 0.0, 1.0, 4))
    with pytest.raises(ValueError, match='equal trial/test degrees'):
        st.windowed_pair_table(0, 0, 0)
    # no more spans than the degree: nwin < 1
    kv = bspline.make_knots(3, 0.0, 1.0, 3)
    with pytest.raises(ValueError, match='more spans than degree'):
        _tables(kv, kv).windowed_pair_table(0, 0, 0)
    # a repeated interior knot: not regularly banded
    kvm = bspline.make_knots(2, 0.0, 1.0, 4, mult=2)
    asm = assemblers.MassAssembler((kvm, kvm), geometry.unit_square(),
                                   device='cpu')
    with pytest.raises(ValueError, match='regularly banded'):
        asm.assemble_windowed()


def _stiffness(p=2, n=6, d=3):
    geo = geometry.twisted_box() if d == 3 else geometry.quarter_annulus()
    return assemblers.StiffnessAssembler(
        d * (bspline.make_knots(p, 0.0, 1.0, n),), geo, device='cpu')


def test_banded_matvec():
    """Port of tests/test_ops.py's test_banded_matvec: the regular-layout
    operator from the compact matrix against the expanded matrix, and
    bitwise against the flat operator on the same data."""
    asm = _stiffness()
    K = asm.assemble()
    assert banded.band_info(K.structure) == [2, 2, 2]
    x = np.random.RandomState(5).rand(K.shape[1])
    y_ref = K.asmatrix() @ x
    op = banded.BandedOperator.from_mlmatrix(K, device='cpu')
    assert op.shape == K.shape and op.D.shape == (5, 5, 5, 8, 8, 8)
    y = op(torch.as_tensor(x)).numpy()
    assert np.abs(y - y_ref).max() / np.abs(y_ref).max() <= 1e-12
    flat = banded.FlatBandedOperator(
        banded.flat_banded_data(op.D, op.bws, op.ns), op.bws, op.ns)
    assert torch.equal(op.matvec(torch.as_tensor(x)),
                       flat.matvec(torch.as_tensor(x)))
    # the tensor route of from_mlmatrix gathers on the data's device
    op_t = banded.BandedOperator.from_mlmatrix(
        K, data=torch.as_tensor(K.data), device='cpu')
    assert torch.equal(op_t.D.contiguous(), op.D)
    # banded_matvec (and its static alias) against the JAX package's
    Dj = jnp.asarray(op.D.numpy())
    for fn in (banded.banded_matvec, banded.banded_matvec_static):
        got = fn(op.D, torch.as_tensor(x), op.bws, op.ns).numpy()
        ref = np.asarray(jbanded.banded_matvec(Dj, jnp.asarray(x), op.bws,
                                               op.ns))
        assert np.abs(got - ref).max() / np.abs(ref).max() <= 1e-14


def test_banded_rejects_irregular():
    kvm = bspline.make_knots(2, 0.0, 1.0, 4, mult=2)
    S = MLStructure.from_kvs((kvm,), (kvm,))
    assert banded.band_info(S) is None
    assert banded.BandedOperator.from_mlmatrix(S.make_mlmatrix(
        data=np.ones([len(b) for b in S.bidx]))) is None


def test_banded_from_compact_device():
    asm = _stiffness()
    K = asm.assemble()
    bws = banded.band_info(K.structure)
    bsz = tuple(2 * b + 1 for b in bws)
    ns = tuple(b[0] for b in K.structure.bs)
    D_host = banded.banded_from_compact(K.data, K.structure, bws)
    maps = banded.banded_gather_maps(K.structure, bws)
    D_dev = banded.banded_from_compact_device(torch.as_tensor(K.data), maps,
                                              bsz, ns)
    assert np.array_equal(D_dev.numpy(), D_host)
    D_jax = jbanded.banded_from_compact_device(
        jnp.asarray(K.data), [jnp.asarray(m) for m in maps], bsz, ns)
    assert np.array_equal(np.asarray(D_jax), D_host)
    # the flat embed is the reshape; set_data_banded_device swaps it in
    lay = banded.flat_banded_layout(bws, ns)
    E = banded.flat_banded_embed_device(D_dev, bws, ns)
    assert E.shape == (lay['C'], lay['F'])
    assert np.array_equal(E.numpy(), D_host.reshape(lay['C'], lay['F']))
    op = banded.FlatBandedOperator(
        torch.zeros(lay['C'], lay['F'], dtype=torch.float64), bws, ns)
    op.set_data_banded_device(D_dev)
    x = torch.as_tensor(np.random.RandomState(6).rand(lay['F']))
    assert torch.equal(op(x), banded.BandedOperator(D_dev, bws, ns)(x))


def test_restricted_operator_banded():
    """The banded half of tests/test_ops.py's test_restricted_operator."""
    asm = _stiffness(p=3, n=5)
    K = asm.assemble()
    bws = banded.band_info(K.structure)
    bsz = tuple(2 * b + 1 for b in bws)
    ns = tuple(b[0] for b in K.structure.bs)
    D = banded.banded_from_compact_device(
        torch.as_tensor(K.data), banded.banded_gather_maps(K.structure, bws),
        bsz, ns)
    free = interior_dofs(asm.kvs)
    rop = RestrictedOperator(banded.BandedOperator(D, bws, ns), free)
    x = np.random.RandomState(7).rand(len(free))
    y = rop(torch.as_tensor(x)).numpy()
    Aff = K.asmatrix().tocsr()[free][:, free]
    assert np.abs(y - Aff @ x).max() < 1e-12


@pytest.mark.parametrize('d,n', [(3, 5), (2, 9)])
def test_windowed_output_into_banded_operators(d, n):
    """The windowed route's banded-flat tensor laid out both ways: the
    regular layout (banded_reorder) and the flat one
    (flat_banded_from_padded_chain without the transpose) give the same
    K4 matvec bitwise, and equal assemble_banded()'s operator."""
    asm = _stiffness(p=3, n=n, d=d)
    ops = asm._windowed_operands()
    Z = sumfac.run_windowed_assembly(
        asm.field_fn, asm.geo_inputs(), ops['wtabs'], ops['fss'],
        asm.tables.nqps, ops['plan'], ops['tperms'])
    bws = banded.band_info(asm.structure)
    ns = tuple(b[0] for b in asm.structure.bs)
    flat = banded.FlatBandedOperator(
        banded.flat_banded_from_padded_chain(Z, bws, ns, add_transpose=False),
        bws, ns)
    reg = banded.BandedOperator(
        sumfac.banded_reorder(Z, tuple(2 * b + 1 for b in bws), ns), bws, ns)
    x = torch.as_tensor(np.random.RandomState(8).rand(flat.shape[0]))
    assert torch.equal(reg(x), flat(x))
    ref = asm.assemble_banded()
    assert _rel(flat.D.numpy(), ref.D.numpy()) <= 1e-13
