"""The stage (kernel K2) and the fold (kernel K3) of the PyTorch port, by
their plain versions on the CPU, held against the JAX package:
``cuda_sumfac.stage`` against ``pallas_sumfac._stage_call`` and
``cuda_sumfac.fold`` with shared tables against ``_stage_call_fold``, both
in interpret mode (1e-12 relative: the JAX side is two-float); the
association K3 uses on the card (the terms that share a table summed
before it, groups in order of first appearance, terms in their given
order) against ``sumfac._sum_chains_merged(mode='exact')`` in 2D and 3D
(1e-14); the wrappers' argument checks; and a non-spline geometry
inside a VForm against the JAX package."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyiga_tpu.ops import pallas_sumfac as jps
from pyiga_tpu.ops import sumfac as jsumfac
from pyiga_tpu.ops import twofloat as jtf

from pyiga_tpu_torch import _cuda, bspline, compile, geometry, vform
from pyiga_tpu_torch.ops import cuda_sumfac

torch.set_num_threads(1)

F64 = torch.float64


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _pair_to_f64(hi, lo, M):
    """A Pallas stage's two-float ``(R, Mp)`` output, unpadded."""
    return (np.asarray(hi, np.float64) + np.asarray(lo, np.float64))[:, :M]


@pytest.mark.parametrize('K,R,M', [(24, 128, 7), (512, 128, 130)])
def test_stage_matches_pallas_stage_call(K, R, M):
    """K = 512 splits into two K-blocks on the TPU, M = 130 pads to two
    lane blocks; tables prepared as the JAX package's own tests do."""
    rng = np.random.RandomState(K + M)
    X = rng.rand(K, R) * 2 - 1
    T = rng.rand(M, K) * 2 - 1
    xh, xl = jtf.df_from_f64(jnp.asarray(X))
    tc, ts, _ = jps.prepare_table(T)
    ref = _pair_to_f64(*jps._stage_call(xh, xl, tc, ts, interpret=True), M)
    got = cuda_sumfac.stage(torch.as_tensor(X), torch.as_tensor(T))
    assert got.shape == (R, M) and got.dtype == F64
    assert _rel(got, ref) < 1e-12


@pytest.mark.parametrize('term_idx', [(0, 1, 0), (1, 1, 0, 2)])
def test_fold_matches_pallas_fold(term_idx):
    """Terms that share a table (`term_idx` (0, 1, 0) as in the JAX
    package's fold test) at a shape ``_pick_blocks_fold`` accepts."""
    rng = np.random.RandomState(len(term_idx))
    K, R, M = 64, 128, 24
    ntab = max(term_idx) + 1
    tabs = [rng.rand(M, K) for _ in range(ntab)]
    xs = [rng.rand(K, R) for _ in term_idx]
    assert jps._pick_blocks_fold(K, R, jps._pad_lanes(M), 512, len(xs),
                                 ntab) is not None
    prepped = [jps.prepare_table(T) for T in tabs]
    pairs = [jtf.df_from_f64(jnp.asarray(X)) for X in xs]
    ref = _pair_to_f64(*jps._stage_call_fold(
        pairs, [p[0] for p in prepped], [p[1] for p in prepped],
        tuple(term_idx), interpret=True), M)
    got = cuda_sumfac.fold([torch.as_tensor(X) for X in xs],
                           [torch.as_tensor(T) for T in tabs], list(term_idx))
    assert got.shape == (R, M)
    assert _rel(got, ref) < 1e-12


def _grouped_fold(xs, tables, term_idx):
    """The association of K3 on the card: per table, in order of first
    appearance, the fields of its terms summed in term order, then one
    stage per table."""
    order = list(dict.fromkeys(term_idx))
    sums = [functools.reduce(torch.add, [X for X, i in zip(xs, term_idx)
                                         if i == g]) for g in order]
    return cuda_sumfac.fold(sums, [tables[g] for g in order],
                            list(range(len(order))))


@pytest.mark.parametrize('dim', [2, 3])
def test_grouped_fold_matches_jax_merged_chains(dim):
    """Five terms over three last tables (groups (0, 2), (1, 4), (3)):
    the per-term stages, then K3's grouped association, against the JAX
    package's exact merged chains (1e-14); the per-term association of
    ``fold_plain`` agrees as well."""
    rng = np.random.RandomState(10 + dim)
    Q, M = 7, 5
    last = [rng.rand(M, Q) for _ in range(3)]
    term_tables = [[rng.rand(M, Q) for _ in range(dim - 1)] + [last[i]]
                   for i in (0, 1, 0, 2, 1)]
    fields = [rng.rand(*(dim * (Q,))) for _ in term_tables]
    li = jsumfac.last_table_groups(term_tables)
    assert li == (0, 1, 0, 2, 1)
    ref = np.asarray(jsumfac._sum_chains_merged(
        [[jnp.asarray(T) for T in tabs] for tabs in term_tables],
        [jnp.asarray(F) for F in fields], range(len(fields)), mode='exact',
        last_idx=li))

    flats = []
    for tabs, F in zip(term_tables, fields):
        X = torch.as_tensor(F)
        for T in tabs[:-1]:
            X = cuda_sumfac._run_stage(X, torch.as_tensor(T))
        flats.append(X.reshape(Q, -1))
    tables = [torch.as_tensor(T) for T in last]
    got = _grouped_fold(flats, tables, li).reshape(dim * (M,))
    assert _rel(got, ref) < 1e-14
    per_term = cuda_sumfac.fold(flats, tables, list(li)).reshape(dim * (M,))
    assert _rel(per_term, ref) < 1e-14


def test_wrappers_check_their_arguments():
    """Mismatched K, shapes, table indices or devices raise ValueError on
    either device; valid CPU calls launch nothing."""
    X = torch.zeros((4, 5), dtype=F64)
    T = torch.zeros((3, 4), dtype=F64)
    meta = X.to('meta')
    for fn in (cuda_sumfac.stage, cuda_sumfac.stage_T):
        with pytest.raises(ValueError, match='disagree in K'):
            fn(X, T[:, :3])
        with pytest.raises(ValueError, match='disagree in K'):
            fn(X[0], T)
        with pytest.raises(ValueError, match='on cpu but T on meta'):
            fn(X, T.to('meta'))
        with pytest.raises(ValueError, match='unsupported device'):
            fn(meta, T.to('meta'))
    bad = [([X, X], [T], [0]),                  # two fields, one index
           ([], [T], []),                       # no field
           ([X, X[:, :4]], [T], [0, 0]),        # fields of two shapes
           ([X], [T, T[:2]], [0]),              # tables of two M
           ([X], [T[:, :3]], [0]),              # a table of another K
           ([X, X], [T], [0, 1]),               # an index past the tables
           ([X, meta], [T], [0, 0]),            # fields on two devices
           ([X], [T.to('meta')], [0])]          # a table on another device
    for xs, tabs, idx in bad:
        with pytest.raises(ValueError):
            cuda_sumfac.fold(xs, tabs, idx)
    with pytest.raises(ValueError, match='unsupported device'):
        cuda_sumfac.fold([meta], [T.to('meta')], [0])
    before = dict(_cuda.LAUNCHES)
    assert cuda_sumfac.stage(X, T).shape == (5, 3)
    assert cuda_sumfac.fold([X, X], [T], [0, 0]).shape == (5, 3)
    assert _cuda.LAUNCHES == before


def test_fold_splits_above_the_kernel_capacity():
    """17 terms over 4 tables (the card runs 16 + 1 launches) equal the
    per-term sum."""
    rng = np.random.RandomState(5)
    tabs = [torch.as_tensor(rng.rand(6, 9)) for _ in range(4)]
    xs = [torch.as_tensor(rng.rand(9, 11)) for _ in range(17)]
    idx = [t % 4 for t in range(17)]
    ref = sum(X.T @ tabs[i].T for X, i in zip(xs, idx))
    assert _rel(cuda_sumfac.fold(xs, tabs, idx), ref) < 1e-14
    assert _rel(_grouped_fold(xs, tabs, idx), ref) < 1e-14


def test_user_function_geometry_in_a_vform_raises():
    """A non-spline geometry inside a generic VForm: its values and
    Jacobian are evaluated on the host and read by K5, and the matrix
    equals the JAX package's (1e-13 relative); a form that needs its
    Hessian is refused by both packages alike."""
    from pyiga_tpu import bspline as jbspline
    from pyiga_tpu import compile as jcompile
    from pyiga_tpu import geometry as jgeometry
    from pyiga_tpu import vform as jvform

    def jac(x, y):      # grid x dim x sdim, [..., i, j] = dF_i / dx_j
        x, y = np.broadcast_arrays(x, y)
        c, s = np.cos(y), np.sin(y)
        return np.stack([np.stack([c, -(1 + x) * s], axis=-1),
                         np.stack([s, (1 + x) * c], axis=-1)], axis=-2)

    def polar(pkg):
        return pkg.UserFunction(
            lambda x, y: ((1 + x) * np.cos(y), (1 + x) * np.sin(y)),
            [[0, 1], [0, 1]], jac=jac)
    kvs = 2 * (bspline.make_knots(2, 0.0, 1.0, 4),)
    jkvs = 2 * (jbspline.make_knots(2, 0.0, 1.0, 4),)
    form = '(u * v + x[0] * inner(grad(u), grad(v))) * dx'
    asm = compile.compile_vform(vform.parse_vf(form, kvs))(
        kvs, geo=polar(geometry), device='cpu')
    jasm = jcompile.compile_vform(jvform.parse_vf(form, jkvs))(
        jkvs, geo=polar(jgeometry))
    assert asm._geo_tables is None and asm.combos == jasm.combos
    A = asm.assemble().asmatrix().toarray()
    assert _rel(A, jasm.assemble().asmatrix().toarray()) < 1e-13
    vf = vform.parse_vf('inner(hess(u), hess(v)) * dx', kvs)
    with pytest.raises(NotImplementedError, match='second geometry'):
        compile.compile_vform(vf)(kvs, geo=polar(geometry), device='cpu')
