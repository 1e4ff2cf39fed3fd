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


def _table_set(p, nel, ntab):
    """`ntab` windowed pair tables of a 1D space (degree p, nel
    elements), its window starts and nqp."""
    kv = bspline.make_knots(p, 0.0, 1.0, nel)
    st = _tables(kv, kv)
    pairs = ((0, 0), (0, 1), (1, 0), (1, 1))[:ntab]
    tabs = [st.windowed_pair_table(0, du, dv)[0] for du, dv in pairs]
    return tabs, st.windowed_pair_table(0, 0, 0)[1], st.nqps[0]


# (p, elements, R, groups, nsm) of the plan: the 3D n=48 and 2D n=128
# shapes, p = 1 to 4, several runs, small and large R, few SMs
PLAN_CASES = [(3, 48, 36864, 1, 132), (3, 48, 68544, 1, 132),
              (3, 48, 127449, 3, 132), (3, 128, 512, 1, 132),
              (3, 128, 917, 3, 132), (1, 40, 33, 1, 132), (2, 13, 1001, 2, 8),
              (4, 60, 100, 2, 132), (4, 10, 100, 4, 132), (2, 200, 7, 3, 132),
              (3, 20, 7211, 3, 132), (4, 300, 5000, 4, 16)]


@pytest.mark.parametrize('p,nel,R,groups,nsm', PLAN_CASES)
def test_windowed_plan_tiles_and_fits(p, nel, R, groups, nsm):
    """The kernels' tiling (cuda_sumfac.windowed_plan, the mirror of
    make_plan in csrc/windowed.cu): shared memory within 232,448 bytes
    and laid out as documented, at least two stages, runs of whole warps
    that cover the dofs, stages that hold every run's X rows, and a CTA
    walk that visits every (run, r tile) exactly once."""
    _tabs, fs, nqp = _table_set(p, nel, 1)
    n, b, wsz, Q = len(fs), 2 * p + 1, (p + 1) * nqp, nel * nqp
    pl = cuda_sumfac.windowed_plan(Q, R, n, b, wsz, nqp, groups, nsm)
    rt = 8 * pl['rpt']

    def r128(x):
        return (x + 127) // 128 * 128
    assert 0 < pl['smem'] <= cuda_sumfac.WINDOWED_SMEM
    assert pl['smem'] == (128 + r128(groups * pl['run'] * pl['ps'] * 8)
                          + pl['stages'] * r128(pl['cap'] * pl['xs'] * 8)
                          + pl['nys'] * r128(rt * b * n * 8))
    assert 2 <= pl['stages'] <= 4 and pl['xs'] == rt + 2
    assert pl['box'] <= 256 and pl['cap'] % pl['box'] == 0
    assert pl['box'] % 8 == 0
    assert pl['ps'] % 4 == 2 and pl['ps'] >= b * wsz
    assert pl['run'] % 4 == 0 and pl['run'] <= 64
    assert pl['nruns'] * pl['run'] >= n > (pl['nruns'] - 1) * pl['run']
    assert pl['nys'] in (0, 1, 2) and (pl['nys'] == 0 or pl['nruns'] == 1)
    assert pl['rtiles'] * rt >= R > (pl['rtiles'] - 1) * rt
    for k in range(pl['nruns']):
        i0 = k * pl['run']
        i1 = min(n, i0 + pl['run']) - 1
        assert fs[i1] * nqp + wsz - fs[i0] * nqp <= pl['cap']
    seen = np.zeros((pl['nruns'], pl['rtiles']), dtype=int)
    for c in range(pl['nruns'] * pl['cpr']):
        seen[c // pl['cpr'], c % pl['cpr']::pl['cpr']] += 1
    assert (seen == 1).all()
    assert pl['nruns'] * pl['cpr'] <= max(nsm, pl['nruns'])


def test_windowed_plan_headline_shapes():
    """The plans that csrc/windowed.cu's note describes: at 3D p=3 n=48
    the stages in 16-r tiles with two output spans in shared memory
    beside three stages (221,952 bytes), the fold's 3 tables beside two
    stages of 24 r, stores direct (222,336); at 2D n=128 three runs,
    stores direct, 16-r tiles for the stage and 24-r tiles for the
    fold."""
    plan = cuda_sumfac.windowed_plan
    s1 = plan(192, 36864, 51, 7, 16, 4, 1)
    assert (s1['rpt'], s1['stages'], s1['nys'], s1['ps'], s1['smem'],
            s1['cpr']) == (2, 3, 2, 114, 221952, 132)
    f = plan(192, 127449, 51, 7, 16, 4, 3)
    assert (f['rpt'], f['stages'], f['nys'], f['smem']) == (3, 2, 0, 222336)
    s2d = plan(512, 512, 131, 7, 16, 4, 1)
    assert (s2d['rpt'], s2d['nruns'], s2d['nys']) == (2, 3, 0)
    assert plan(512, 917, 131, 7, 16, 4, 3)['rpt'] == 3


def _emulate_windowed_kernel(xs, tabs, idx, fs, nqp, nsm, aligned=True):
    """The kernels' schedule in numpy, index for index: the plan's CTA
    walk; per tile every term's X rows copied into the ring's stages as
    the producer copies them (a row from its 16-byte aligned start, so
    shifted one slot where its first element is odd, unless X is not
    aligned); a group's fields summed into the newest stage in term
    order; the products read through the consumers' slot parity; each
    output entry written once (checked).  Unwritten stage slots hold NaN, so a read outside
    the copied data shows in the result."""
    Q, R = xs[0].shape
    n, b, wsz = tabs[0].shape
    order = []
    for i in idx:
        if i not in order:
            order.append(i)
    groups = [[t for t in range(len(xs)) if idx[t] == g] for g in order]
    pl = cuda_sumfac.windowed_plan(Q, R, n, b, wsz, nqp, len(order), nsm)
    rt, S, xsr = 8 * pl['rpt'], pl['stages'], pl['xs']
    flat = [np.ascontiguousarray(X).ravel() for X in xs]
    Y = np.full((R, b * n), np.nan)
    written = np.zeros(Y.shape, dtype=int)
    for c in range(pl['nruns'] * pl['cpr']):
        i0, k0 = c // pl['cpr'] * pl['run'], c % pl['cpr']
        nd = min(pl['run'], n - i0)
        qa = fs[i0] * nqp
        rows = fs[i0 + nd - 1] * nqp + wsz - qa
        ring = np.full((S, pl['cap'] * xsr), np.nan)
        it = 0
        for t in range(k0, pl['rtiles'], pl['cpr']):
            r0 = t * rt
            nr = min(rt, R - r0)

            def copy(u, s):
                ring[s] = np.nan
                for q in range(rows):
                    e = (qa + q) * R + r0
                    sh = e % 2 if aligned else 0
                    assert (nr + sh + 1) // 2 * 2 <= xsr
                    ring[s, q * xsr + sh:q * xsr + sh + nr] = \
                        flat[u][e:e + nr]
            acc = np.zeros((nd, b, rt))
            for g, terms in zip(order, groups):
                sa = it % S
                copy(terms[0], sa)
                it += 1
                for u in terms[1:]:
                    s2 = it % S
                    copy(u, s2)
                    it += 1
                    ring[s2] = ring[sa] + ring[s2]
                    sa = s2
                for il in range(nd):
                    i = i0 + il
                    qrel = fs[i] * nqp - qa
                    par = ((qa + qrel) * R + r0) % 2 if aligned else 0
                    rodd = R % 2 if aligned else 0
                    win = np.stack([ring[sa, (qrel + w) * xsr
                                         + (par ^ (w & rodd)):][:rt]
                                    for w in range(wsz)])
                    acc[il] += tabs[g][i] @ win
            for il in range(nd):
                cols = np.arange(b) * n + i0 + il
                Y[r0:r0 + nr, cols] = acc[il, :, :nr].T
                written[r0:r0 + nr, cols] += 1
    assert (written == 1).all()
    return Y


# (p, elements, R, terms, tables, nsm, X aligned)
EMULATED = [(3, 20, 250, 1, 1, 4, True), (3, 20, 251, 1, 1, 4, True),
            (3, 20, 251, 5, 3, 3, True), (2, 13, 101, 3, 2, 2, True),
            (1, 70, 40, 2, 1, 132, True), (4, 9, 77, 4, 2, 5, True),
            (3, 20, 250, 4, 2, 4, False), (2, 70, 33, 6, 3, 132, True)]


@pytest.mark.parametrize('p,nel,R,nterms,ntab,nsm,aligned', EMULATED)
def test_windowed_kernel_schedule_emulated(p, nel, R, nterms, ntab, nsm,
                                           aligned):
    """The kernels' schedule (tile walk, ring, the odd-R slot shift, the
    group sums into the newest stage) emulated on the host equals
    windowed_fold_plain and the JAX package's _windowed_stage, summed,
    within 1e-14 relative, and writes every entry of Y once."""
    tabs, fs, nqp = _table_set(p, nel, ntab)
    rng = np.random.RandomState(p * 1000 + R)
    xs = [rng.rand(nel * nqp, R) for _ in range(nterms)]
    idx = [(3 * t) % ntab for t in range(nterms)]
    got = _emulate_windowed_kernel(xs, tabs, idx, fs, nqp, nsm, aligned)
    ref = cuda_sumfac.windowed_fold_plain(
        [torch.as_tensor(X) for X in xs], [torch.as_tensor(T) for T in tabs],
        idx, torch.as_tensor(fs), nqp).numpy()
    assert _rel(got, ref) <= 1e-14
    jref = sum(np.asarray(jsumfac._windowed_stage(
        jnp.asarray(X), jnp.asarray(tabs[i]), jnp.asarray(fs), nqp))
        for X, i in zip(xs, idx))
    assert _rel(got, jref) <= 1e-14
