"""The port's host helpers (``pyiga_tpu_torch.utils``) and multilevel
matrices (``pyiga_tpu_torch.mlmatrix``) held against ``pyiga_tpu.utils``
and ``pyiga_tpu.mlmatrix`` on the same inputs made from a seed: the cases
of ``tests/test_utils.py`` and ``tests/test_mlmatrix.py`` for the names
the port carries, each result bitwise equal to the JAX package's."""

import os

import numpy as np
import pytest
import scipy.sparse

import pyiga_tpu.bspline as jbspline
import pyiga_tpu.mlmatrix as jm
import pyiga_tpu.utils as ju

from pyiga_tpu_torch import bspline, geometry, mlmatrix as tm, utils as tu
from pyiga_tpu_torch.assemble import bsp_mass_1d

FIXTURES = os.path.join(os.path.dirname(__file__), 'fixtures')


def _random_banded(rng, n, bw):
    return scipy.sparse.spdiags(rng.rand(2 * bw + 1, n),
                                np.arange(-bw, bw + 1), n, n)


def _eq(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize('name', sorted(
    f for f in os.listdir(FIXTURES) if f.endswith('.mtx.gz')))
def test_read_sparse_matrix_fixtures(name):
    A = tu.read_sparse_matrix(os.path.join(FIXTURES, name))
    B = ju.read_sparse_matrix(os.path.join(FIXTURES, name))
    assert A.shape == B.shape and (A != B).nnz == 0


def test_read_sparse_matrix(tmp_path):
    p = tmp_path / 'm.mtx'
    p.write_text('3 3 2\n1 1 2.5\n3 2 -1.0\n')
    A = tu.read_sparse_matrix(str(p))
    assert A[0, 0] == 2.5 and A[2, 1] == -1.0


def test_csr_row_helpers():
    rng = np.random.RandomState(0)
    A = scipy.sparse.random(10, 8, density=0.4, format='csr',
                            random_state=rng)
    x = rng.rand(8)
    sl = tu.CSRRowSlice(A, (2, 6))
    assert np.allclose(sl.dot(x), A.toarray()[2:6] @ x)
    assert np.array_equal(sl @ x, ju.CSRRowSlice(A, (2, 6)) @ x)
    rows = [1, 4, 7]
    sub = tu.CSRRowSubset(A, rows)
    assert np.array_equal(sub.dot(x), ju.CSRRowSubset(A, rows).dot(x))
    assert sub.shape == (3, 8) and sl.bounds == (2, 6)
    with pytest.raises(ValueError):
        tu.CSRRowSlice(A, (6, 2))
    with pytest.raises(TypeError):
        tu.CSRRowSubset(A.toarray(), rows)


def test_bijective_index():
    vals = [(0, 1), (2, 3), (4, 5)]
    bi = tu.BijectiveIndex(vals)
    assert len(bi) == 3
    assert bi[1] == (2, 3)
    assert bi.index((4, 5)) == 2


@pytest.mark.parametrize('mode', ['eval', 'jac'])
def test_lazy_arrays(mode):
    geo = geometry.quarter_annulus()
    grid = (np.linspace(0, 1, 12), np.linspace(0, 1, 8))
    full = (geo.grid_eval(grid) if mode == 'eval'
            else geo.grid_jacobian(grid))
    la = tu.LazyArray(geo, grid, mode=mode)
    I = (slice(2, 7), slice(1, 5))
    assert np.array_equal(la[I], full[I])
    lc = tu.LazyCachingArray(geo, full.shape[2:], grid, 4, mode=mode)
    J = (slice(4, 12), slice(0, 8))
    assert np.array_equal(lc[J], full[J])
    assert len(lc.tiles) == 4
    assert np.array_equal(lc.get_tile((1, 0)), full[4:8, 0:4])
    import pyiga_tpu.geometry as jg
    jl = ju.LazyArray(jg.quarter_annulus(), grid, mode=mode)
    assert np.abs(la[I] - jl[I]).max() <= 1e-14 * np.abs(jl[I]).max()
    with pytest.raises(IndexError):
        la[(slice(0, 1),)]


def test_mlstructure_constructors():
    rng = np.random.RandomState(1)
    bs, bw = (5, 5), (2, 2)
    S = tm.MLStructure.multi_banded(bs, bw)
    A = _random_banded(rng, bs[0], bw[0]).tocsr()
    A2 = scipy.sparse.kron(A, A)
    assert np.array_equal(S.nonzero(), A2.nonzero())
    assert _eq(S.bidx, jm.MLStructure.multi_banded(bs, bw).bidx)
    assert np.array_equal(tm.MLStructure.from_matrix(A).nonzero(),
                          A.nonzero())
    assert np.array_equal(tm.MLStructure.from_kronecker((A, A)).nonzero(),
                          A2.nonzero())
    B = scipy.sparse.random(8, 20, density=0.1, random_state=rng)
    C = scipy.sparse.random(17, 9, density=0.1, random_state=rng)
    S = tm.MLStructure.from_kronecker((B, C))
    assert np.array_equal(S.nonzero(), scipy.sparse.kron(B, C).nonzero())
    jS = jm.MLStructure.from_kronecker((B, C))
    assert _eq(S.bidx, jS.bidx) and S.bs == jS.bs
    assert _eq(S.transpose().bidx, jS.transpose().bidx)
    assert _eq(S.reorder((1, 0)).bidx, jS.reorder((1, 0)).bidx)
    assert _eq(S.sequential_bidx(), jS.sequential_bidx())
    assert S.slice(1).bs == jS.slice(1).bs == (tuple(C.shape),)


def test_sparsity_from_kvs():
    kv = bspline.make_knots(3, 0.0, 1.0, 8)
    S = tm.MLStructure.from_kvs((kv,), (kv,))
    M = bsp_mass_1d(kv)
    I, J = S.nonzero()
    M2 = scipy.sparse.coo_matrix((np.ones(len(I)), (I, J)), shape=M.shape)
    assert (M2.toarray() != 0).sum() == M.nnz
    assert np.array_equal(tm.compute_sparsity_ij(kv, kv),
                          tm.compute_banded_sparsity_ij(kv.numdofs, kv.p))
    assert np.array_equal(tm.compute_banded_sparsity(9, 2),
                          jm.compute_banded_sparsity(9, 2))


def test_nonzeros_for_rows_and_columns():
    A = np.array([[0, 2, 0], [3, 0, 1], [0, 7, 0]])
    B = np.array([[2, 9, 0, 0], [0, 2, 9, 0], [0, 0, 2, 9]])
    X = np.kron(A, B)
    mats = (scipy.sparse.csr_matrix(A), scipy.sparse.csr_matrix(B))
    S, jS = tm.MLStructure.from_kronecker(mats), \
        jm.MLStructure.from_kronecker(mats)
    I, J = S.nonzeros_for_rows([4, 5, 6, 7])
    IX, JX = X[4:8, :].nonzero()
    assert np.array_equal(I, IX + 4) and np.array_equal(J, JX)
    assert _eq(S.nonzeros_for_rows([4, 7], renumber_rows=True),
               jS.nonzeros_for_rows([4, 7], renumber_rows=True))
    assert _eq(S.nonzeros_for_columns([1, 2, 7]),
               jS.nonzeros_for_columns([1, 2, 7]))
    assert all(len(a) == 0 for a in S.nonzeros_for_rows([]))


@pytest.mark.parametrize('bs,bw', [((9, 12), (2, 3)), ((8, 7, 6),
                                                        (3, 2, 2))])
def test_mlbanded(bs, bw):
    rng = np.random.RandomState(2)
    S = tm.MLStructure.multi_banded(bs, bw)
    mats = [_random_banded(rng, n, p).toarray() for n, p in zip(bs, bw)]
    vecs = [X.ravel()[np.flatnonzero(X.ravel())] for X in mats]
    data = vecs[0]
    for v in vecs[1:]:
        data = np.multiply.outer(data, v)
    M = tm.MLMatrix(structure=S, data=data)
    assert M.nnz == data.size
    X = mats[0]
    for Y in mats[1:]:
        X = np.kron(X, Y)
    assert np.allclose(X, M.asmatrix().toarray())
    x = rng.rand(M.shape[1])
    assert np.allclose(X.dot(x), M.dot(x))
    perm = tuple(reversed(range(len(bs))))
    jM = jm.MLMatrix(structure=jm.MLStructure.multi_banded(bs, bw), data=data)
    assert (M.reorder(perm).asmatrix() != jM.reorder(perm).asmatrix()).nnz \
        == 0
    M.data = 2 * data
    assert np.allclose(2 * X.dot(x), M.dot(x))
    with pytest.raises(ValueError):
        M.data = data.ravel()


def test_reorder_and_reindex():
    rng = np.random.RandomState(3)
    X = rng.rand(6 * 5, 4 * 3)
    Y = tm.reorder(X, 6, 4)
    assert np.array_equal(Y, jm.reorder(X, 6, 4))
    for i in (0, 5, 13, 23):
        for j in (0, 3, 7, 14):
            gi, gj = tm.reindex_from_reordered(i, j, 6, 4, 5, 3)
            assert Y[i, j] == X[gi, gj]
    bs = np.array([[5, 4], [3, 7]])
    for (i, j) in [(0, 0), (7, 11), (14, 27)]:
        M = tm.reindex_to_multilevel(i, j, bs)
        assert M == jm.reindex_to_multilevel(i, j, bs)
        assert tm.reindex_from_multilevel(M, bs) == (i, j)
    assert tm.from_seq(17, (3, 4, 5)) == jm.from_seq(17, (3, 4, 5))
    assert tm.to_seq((0, 3, 2), (3, 4, 5)) == 17


def test_transpose_idx_alias():
    bidx = tm.compute_banded_sparsity_ij(7, 2)
    tidx = tm.get_transpose_idx_for_bidx(bidx)
    assert np.array_equal(tidx, jm.get_transpose_idx_for_bidx(bidx))
    for s, (i, j) in enumerate(bidx):
        assert tuple(bidx[tidx[s]]) == (j, i)


def test_reordered_generators():
    """The compact generators over a 2- and a 3-level structure give the
    JAX package's entries for the same multi-entry callback."""
    kvs = (bspline.make_knots(2, 0.0, 1.0, 4), bspline.make_knots(1, 0.0,
                                                                  1.0, 5))
    jkvs = (jbspline.make_knots(2, 0.0, 1.0, 4),
            jbspline.make_knots(1, 0.0, 1.0, 5))
    S, jS = tm.MLStructure.from_kvs(kvs, kvs), \
        jm.MLStructure.from_kvs(jkvs, jkvs)

    def multiasm(ij):
        return np.array([1.0 + i + 0.01 * j for i, j in ij])
    G, jG = tm.ReorderedMatrixGenerator(multiasm, S), \
        jm.ReorderedMatrixGenerator(multiasm, jS)
    assert G.shape == jG.shape
    idx = [(0, 0), (3, 5), (G.shape[0] - 1, G.shape[1] - 1)]
    assert np.array_equal(G.compute_entries(idx), jG.compute_entries(idx))
    S3 = S.join(tm.MLStructure.multi_banded((4,), (1,)))
    jS3 = jS.join(jm.MLStructure.multi_banded((4,), (1,)))
    T, jT = tm.ReorderedTensorGenerator(multiasm, S3), \
        jm.ReorderedTensorGenerator(multiasm, jS3)
    idx = [(0, 0, 0), (3, 5, 2), tuple(n - 1 for n in T.shape)]
    assert T.shape == jT.shape
    assert np.array_equal(T.compute_entries(idx), jT.compute_entries(idx))

