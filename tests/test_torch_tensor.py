"""The port's tensor-approximation pillar (``pyiga_tpu_torch.tensor``):
every case of ``tests/test_tensor.py`` on the port's module, then each
function and format held against ``pyiga_tpu.tensor`` on the same inputs
drawn from a numpy seed, to 1e-13 relative (both run the same numpy
arithmetic, so most agree bitwise)."""

import numpy as np
import pytest
import scipy.sparse
import torch

import pyiga_tpu.tensor as jt

from pyiga_tpu_torch import assemble, bspline
from pyiga_tpu_torch.tensor import (
    CanonicalOperator, CanonicalTensor, TensorProd, TensorSum, TuckerTensor,
    als, als1, als1_ls, apply_tprod, array_outer, asarray, find_truncation_rank,
    fro_norm, grou, gta, gta_ls, hosvd, matricize, modek_tprod, outer, pad,
)
import pyiga_tpu_torch.tensor as tt

torch.set_num_threads(1)

TOL = 1e-13
_RNG = np.random.RandomState(1234)


def rand(*shape):
    return _RNG.rand(*shape)


def _random_lowrank(shape, R):
    return CanonicalTensor.from_terms(
        [tuple(rand(n) for n in shape) for _ in range(R)])


# -- the cases of tests/test_tensor.py on the port -------------------------

def test_modek_and_apply_tprod():
    X = rand(4, 5, 6)
    A, B, C = rand(7, 4), rand(8, 5), rand(9, 6)
    Y = apply_tprod((A, B, C), X)
    assert Y.shape == (7, 8, 9)
    full = np.kron(np.kron(A, B), C).dot(X.ravel())
    assert np.allclose(Y.ravel(), full)
    Y2 = apply_tprod((A, None), rand(4, 5, 3))
    assert Y2.shape == (7, 5, 3)
    S = scipy.sparse.csr_matrix(A)
    assert np.allclose(modek_tprod(S, 0, X), modek_tprod(A, 0, X))


def test_matricize():
    X = rand(3, 4, 5)
    M1 = matricize(X, 1)
    assert M1.shape == (4, 15)
    assert np.allclose(M1[2, :], np.moveaxis(X, 1, 0)[2].ravel())


def test_hosvd_roundtrip():
    X = rand(5, 6, 7)
    T = hosvd(X)
    assert np.allclose(T.asarray(), X)


def test_truncation():
    T = _random_lowrank((10, 11, 12), 3)
    X = T.asarray()
    H = hosvd(X)
    shp = find_truncation_rank(H.X, tol=1e-10)
    assert all(r <= 4 for r in shp)
    assert np.allclose(H.truncate(shp).asarray(), X, atol=1e-8)


def test_tucker_compress():
    T = _random_lowrank((8, 9, 10), 2)
    TT = TuckerTensor.from_tensor(T).compress(tol=1e-12)
    assert all(r <= 3 for r in TT.R)
    assert np.allclose(TT.asarray(), T.asarray(), atol=1e-8)


def test_canonical_algebra():
    A = _random_lowrank((5, 6), 2)
    B = _random_lowrank((5, 6), 3)
    assert (A + B).R == 5
    assert np.allclose((A + B).asarray(), A.asarray() + B.asarray())
    assert np.allclose((A - B).asarray(), A.asarray() - B.asarray())
    assert abs(A.norm() - np.linalg.norm(A.asarray())) < 1e-10
    ops = (rand(4, 5), rand(7, 6))
    assert np.allclose(apply_tprod(ops, A).asarray(),
                       apply_tprod(ops, A.asarray()))
    assert np.allclose(asarray(A[1:3, :]), A.asarray()[1:3, :])
    assert np.allclose(A[2, 3], A.asarray()[2, 3])


def test_tucker_algebra():
    A = TuckerTensor.from_tensor(_random_lowrank((5, 6), 2))
    B = TuckerTensor.from_tensor(_random_lowrank((5, 6), 1))
    assert np.allclose((A + B).asarray(), A.asarray() + B.asarray())
    assert np.allclose((-A).asarray(), -A.asarray())
    assert abs(A.norm() - np.linalg.norm(A.asarray())) < 1e-10
    assert np.allclose(asarray(A[0, :]), A.asarray()[0, :])


def test_tensor_sum_prod():
    X, Y = rand(4, 5), rand(4, 5)
    S = TensorSum(X, Y)
    assert np.allclose(S.asarray(), X + Y)
    P = TensorProd(rand(3), rand(4))
    assert P.shape == (3, 4)
    assert np.allclose(P.asarray(), np.outer(P.Xs[0], P.Xs[1]))
    assert np.allclose(asarray(P[1, 2]), P.asarray()[1, 2])


def test_outer_pad():
    x, y, z = rand(3), rand(4), rand(5)
    assert np.allclose(outer(x, y, z), np.einsum('i,j,k->ijk', x, y, z))
    X = rand(3, 4)
    assert array_outer(X, rand(2)).shape == (3, 4, 2)
    Xp = pad(X, [(1, 2), None])
    assert Xp.shape == (6, 4)
    assert np.allclose(Xp[1:4], X)


def test_als1():
    T = outer(rand(6), rand(7), rand(8))
    xs = als1(T)
    assert np.allclose(outer(*xs), T, atol=1e-8)


def test_als():
    T = _random_lowrank((6, 7, 8), 2).asarray()
    X = als(T, 2, tol=1e-12)
    assert fro_norm(X.asarray() - T) < 1e-6 * fro_norm(T)


def test_grou():
    T = _random_lowrank((6, 7), 3).asarray()
    X, errors = grou(T, 10, tol=1e-10, return_errors=True)
    assert errors[-1] < 1e-9 * fro_norm(T) or X.R <= 10


def test_gta():
    T = _random_lowrank((6, 7, 8), 2).asarray()
    X = gta(T, 6, tol=1e-10)
    assert fro_norm(X.asarray() - T) < 1e-6 * fro_norm(T)


def _kron_operator_1():
    # simple SPD Kronecker-rank-2 operator: K (x) M + M (x) K
    kv = bspline.make_knots(2, 0.0, 1.0, 8)
    K = assemble.stiffness(kv) + assemble.mass(kv)
    M = assemble.mass(kv)
    return [(K.tocsr(), M.tocsr()), (M.tocsr(), K.tocsr())]


def _laplace_3d(p=3, n=10):
    kv = bspline.make_knots(p, 0.0, 1.0, n)
    K = assemble.stiffness(kv)[1:-1, 1:-1].tocsr()
    M = assemble.mass(kv)[1:-1, 1:-1].tocsr()
    return [(K, M, M), (M, K, M), (M, M, K)], K.shape[0]


def test_ls():
    A, n = _laplace_3d()
    F = CanonicalTensor.ones((n, n, n))

    X = CanonicalTensor(als1_ls(A, F))
    Y = CanonicalTensor(als1_ls(A, F, spd=True))
    assert X.shape == F.shape and Y.shape == F.shape
    assert fro_norm(X - Y) < 0.1 * fro_norm(X)

    T1 = gta_ls(A, F, 5)
    T2 = gta_ls(A, F, 5, spd=True)
    assert T1.shape == F.shape and T2.shape == F.shape
    assert fro_norm(T1 - T2) < 0.01 * fro_norm(T1)
    A_op = CanonicalOperator(A)
    assert fro_norm(A_op.apply(T2) - F) < 0.01 * fro_norm(F)


def test_canonical_operator():
    terms = _kron_operator_1()
    Op = CanonicalOperator(terms)
    assert Op.R == 2
    full = Op.asmatrix().toarray()
    ref = sum(np.kron(t[0].toarray(), t[1].toarray()) for t in terms)
    assert np.allclose(full, ref)
    X = rand(*Op.shape[1])
    assert np.allclose(Op.apply(X).ravel(), ref.dot(X.ravel()))
    assert np.allclose((Op + Op).asmatrix().toarray(), 2 * ref)
    assert np.allclose((-Op).asmatrix().toarray(), -ref)
    assert np.allclose(Op.T.asmatrix().toarray(), ref.T)
    assert np.allclose((Op * Op).asmatrix().toarray(), ref @ ref)
    E = CanonicalOperator.eye((3, 4))
    assert np.allclose(E.asmatrix().toarray(), np.eye(12))


def test_pad_structured():
    rng = np.random.default_rng(3)
    X = TuckerTensor(tuple(rng.random((n, 2)) for n in (3, 4, 5)),
                     rng.random((2, 2, 2)))
    Y = pad(X, [(2, 2), None, (0, 1)])
    assert Y.shape == (7, 4, 6)
    YA = asarray(Y)
    assert np.allclose(YA[2:-2, :, :-1], asarray(X))
    assert np.linalg.norm(YA[:2].ravel()) < 1e-10
    assert np.linalg.norm(YA[-2:].ravel()) < 1e-10
    assert np.linalg.norm(YA[:, :, -1:].ravel()) < 1e-10
    C = CanonicalTensor(tuple(rng.random((n, 2)) for n in (3, 4)))
    Z = pad(C, [None, (1, 0)])
    ZA = asarray(Z)
    assert np.allclose(ZA[:, 1:], asarray(C))
    assert np.linalg.norm(ZA[:, 0]) < 1e-10


def test_als_structured_input():
    rng = np.random.default_rng(5)
    A = CanonicalTensor(tuple(rng.random((n, 2)) for n in (3, 4, 5)))
    B = als(A, R=2, maxiter=200)
    assert np.allclose(asarray(A), asarray(B), atol=1e-6)
    X = np.zeros((2, 2, 2))
    X[0, 0, 0] = X[1, 1, 1] = 1.0
    T = TuckerTensor(tuple(rng.random((n, 2)) for n in (3, 4, 5)), X)
    B2 = als(T, R=2, maxiter=500)
    assert np.allclose(asarray(T), asarray(B2), atol=1e-6)


def _tridiag_system(n=12):
    K = (np.diag(np.full(n, 2.0)) + np.diag(np.full(n - 1, -1.0), 1)
         + np.diag(np.full(n - 1, -1.0), -1))
    M = np.eye(n)
    A = [(K, M, M), (M, K, M), (M, M, K)]
    F = np.random.default_rng(0).random((n, n, n))
    return A, F


def test_gta_ls_gauss_seidel_branch():
    A, F = _tridiag_system()
    X = gta_ls(A, F, R=9, gs=2, spd=True)     # core 9^3 = 729 > 500
    res = fro_norm(sum(apply_tprod(list(Aj), asarray(X)) for Aj in A) - F)
    X1 = gta_ls(A, F, R=1, spd=True)
    res1 = fro_norm(sum(apply_tprod(list(Aj), asarray(X1)) for Aj in A) - F)
    assert np.isfinite(res) and res < res1


# -- the port against pyiga_tpu.tensor on the same inputs ------------------

def _close(a, b, tol=TOL):
    """`a` and `b` (arrays, structured tensors, scalars or sequences of
    them) agree to `tol` relative to the largest entry of `b`."""
    if isinstance(b, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y, tol)
        return
    a, b = np.asarray(tt.asarray(a)), np.asarray(jt.asarray(b))
    assert a.shape == b.shape
    scale = max(np.abs(b).max(initial=0.0), 1e-300)
    assert np.abs(a - b).max(initial=0.0) <= tol * scale, \
        np.abs(a - b).max() / scale


def _seeded(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.rand(*s) for s in shapes]


def _lowrank_terms(seed, shape, R):
    rng = np.random.RandomState(seed)
    return [tuple(rng.rand(n) for n in shape) for _ in range(R)]


def _both_lowrank(seed, shape, R):
    terms = _lowrank_terms(seed, shape, R)
    return (CanonicalTensor.from_terms(terms),
            jt.CanonicalTensor.from_terms(terms))


def test_hosvd_and_truncation_match_jax():
    (X,) = _seeded(11, (5, 6, 7))
    T, J = hosvd(X), jt.hosvd(X)
    _close(T.Us, list(J.Us))
    _close(T.X, J.X)
    C, _ = _both_lowrank(12, (10, 11, 12), 3)
    H = jt.hosvd(C.asarray())
    for tol in (1e-14, 1e-10, 1e-2):
        assert find_truncation_rank(H.X, tol) == \
            jt.find_truncation_rank(H.X, tol)
    assert find_truncation_rank(np.zeros((0, 3)), 1.0) == (0, 3)


@pytest.mark.parametrize('name', ['als1', 'als', 'grou', 'gta'])
def test_approximations_match_jax(name):
    C, _ = _both_lowrank(13, (6, 7, 8), 2)
    T = C.asarray()
    if name == 'als1':
        _close(als1(T), jt.als1(T))
        _close(als1(np.zeros((3, 4))), jt.als1(np.zeros((3, 4))))
    elif name == 'als':
        X, J = als(T, 2, tol=1e-12), jt.als(T, 2, tol=1e-12)
        _close(list(X.Xs), list(J.Xs))
        start = [np.random.RandomState(14).rand(n, 3) for n in T.shape]
        X = als(C, 3, maxiter=50, startval=CanonicalTensor(start))
        J = jt.als(T, 3, maxiter=50, startval=start)
        _close(list(X.Xs), list(J.Xs))
    elif name == 'grou':
        X, e = grou(T, 5, tol=1e-10, return_errors=True)
        J, f = jt.grou(T, 5, tol=1e-10, return_errors=True)
        _close(list(X.Xs), list(J.Xs))
        _close(np.array(e), np.array(f))
    else:
        X, e = gta(T, 6, tol=1e-10, return_errors=True)
        J, f = jt.gta(T, 6, tol=1e-10, return_errors=True)
        _close(list(X.Us), list(J.Us))
        _close(X.X, J.X)
        _close(np.array(e), np.array(f))


@pytest.mark.parametrize('spd', [False, True])
def test_als1_ls_match_jax(spd):
    A, n = _laplace_3d(p=2, n=6)
    F = np.random.RandomState(15).rand(n, n, n)
    _close(als1_ls(A, F, spd=spd), jt.als1_ls(A, F, spd=spd))
    Fc = CanonicalTensor.ones((n, n, n))
    _close(als1_ls(A, Fc, spd=spd),
           jt.als1_ls(A, jt.CanonicalTensor.ones((n, n, n)), spd=spd))
    if not spd:
        _close(tt.als1_ls_structured(A, F), jt.als1_ls_structured(A, F))


@pytest.mark.parametrize('branch', ['dense', 'gauss_seidel'])
def test_gta_ls_matches_jax(branch):
    if branch == 'dense':
        A, n = _laplace_3d(p=2, n=6)
        F = np.random.RandomState(16).rand(n, n, n)
        for spd in (False, True):
            X, J = gta_ls(A, F, 4, spd=spd), jt.gta_ls(A, F, 4, spd=spd)
            _close(list(X.Us), list(J.Us))
            _close(X.X, J.X)
    else:
        A, F = _tridiag_system()
        X = gta_ls(A, F, R=9, gs=2, spd=True)
        J = jt.gta_ls(A, F, R=9, gs=2, spd=True)
        assert X.X.size > 500
        _close(list(X.Us), list(J.Us))
        _close(X.X, J.X)


def test_canonical_tucker_algebra_matches_jax():
    A, JA = _both_lowrank(17, (5, 6, 4), 2)
    B, JB = _both_lowrank(18, (5, 6, 4), 3)
    ops = _seeded(19, (4, 5), (7, 6))
    (D,) = _seeded(20, (5, 6, 4))
    TA, JTA = TuckerTensor.from_tensor(A), jt.TuckerTensor.from_tensor(JA)
    TB, JTB = TuckerTensor.from_tensor(B), jt.TuckerTensor.from_tensor(JB)
    pairs = [
        (A + B, JA + JB), (A - B, JA - JB), (-A, -JA), (A + D, JA + D),
        (apply_tprod(ops, A), jt.apply_tprod(ops, JA)),
        (A[1:3, :, -1], JA[1:3, :, -1]), (A[2, 3], JA[2, 3]),
        (A[[0, 2], 1::2], JA[[0, 2], 1::2]),
        (A[-1:], JA[-1:]),
        (A.squeeze(), JA.squeeze()),
        (TuckerTensor.from_tensor(D), jt.TuckerTensor.from_tensor(D)),
        (CanonicalTensor.from_tensor(TB), jt.CanonicalTensor.from_tensor(JTB)),
        (TA + TB, JTA + JTB), (TA - B, JTA - JB), (A + TB, JA + JTB),
        (TA + D, JTA + D), (-TA, -JTA),
        (TA.orthogonalize(), JTA.orthogonalize()),
        (TA.compress(tol=1e-12), JTA.compress(tol=1e-12)),
        (TA.truncate(1), JTA.truncate(1)),
        (TA.truncate((2, 1, 2)), JTA.truncate((2, 1, 2))),
        (TA[0, :, 1:3], JTA[0, :, 1:3]), (TA[:, -2], JTA[:, -2]),
        (apply_tprod(ops, TA), jt.apply_tprod(ops, JTA)),
        (pad(TA, [(1, 0), None, (2, 3)]), jt.pad(JTA, [(1, 0), None, (2, 3)])),
        (pad(A, [None, (1, 1), (0, 2)]), jt.pad(JA, [None, (1, 1), (0, 2)])),
        (pad(D, [(1, 2), None, None]), jt.pad(D, [(1, 2), None, None])),
        (CanonicalTensor.zeros((3, 4)), jt.CanonicalTensor.zeros((3, 4))),
        (TuckerTensor.ones((3, 4)), jt.TuckerTensor.ones((3, 4))),
        (TuckerTensor.zeros((3, 2)), jt.TuckerTensor.zeros((3, 2))),
    ]
    for got, ref in pairs:
        assert type(got).__name__ == type(ref).__name__
        _close(got, ref)
    for got, ref in ((A.norm(), JA.norm()), (TA.norm(), JTA.norm()),
                     (fro_norm(D), jt.fro_norm(D))):
        assert abs(got - ref) <= TOL * abs(ref)
    U, X1, X2 = tt.join_tucker_bases(TA, TB)
    JU, JX1, JX2 = jt.join_tucker_bases(JTA, JTB)
    _close(U, JU)
    _close([X1, X2], [JX1, JX2])
    with pytest.raises(ValueError):
        A[0, 0, 0, 0]
    with pytest.raises(IndexError):
        A[5]


def test_sum_prod_on_formats_match_jax():
    A, JA = _both_lowrank(21, (4, 5), 2)
    X, Y = _seeded(22, (4, 5), (4, 5))
    x, y = _seeded(23, (3,), (4,))
    S, JS = TensorSum(X, A), jt.TensorSum(X, JA)
    P, JP = TensorProd(x, y), jt.TensorProd(x, y)
    P2, JP2 = TensorProd(A, x), jt.TensorProd(JA, x)
    pairs = [(S, JS), (S - Y, JS - Y), (S - A, JS - JA), (-S, -JS),
             (S[1:3], JS[1:3]), (S[:, -1], JS[:, -1]),
             (P - outer(x, y), JP - outer(x, y)), (P + P, JP + JP),
             (P[1:, 2], JP[1:, 2]), (-P, -JP), (P2, JP2), (P2[:, 1:3], JP2[:, 1:3]),
             (apply_tprod(_seeded(24, (2, 4)), S),
              jt.apply_tprod(_seeded(24, (2, 4)), JS))]
    for got, ref in pairs:
        assert type(got).__name__ == type(ref).__name__
        _close(got, ref)
    assert S[2, 3] == JS[2, 3]
    assert P[1, 2] == JP[1, 2]
    assert abs(S.norm() - JS.norm()) <= TOL * JS.norm()
    assert abs((S - S).norm()) <= TOL * JS.norm()


def test_canonical_operator_matches_jax():
    terms = _kron_operator_1()
    Op, JOp = CanonicalOperator(terms), jt.CanonicalOperator(terms)
    n = Op.shape[1]
    (X,) = _seeded(25, n)
    C, JC = _both_lowrank(26, n, 2)
    for got, ref in ((Op.apply(X), JOp.apply(X)), (Op @ X, JOp @ X),
                     (Op.apply(C), JOp.apply(JC))):
        _close(got, ref)
    for got, ref in ((Op.asmatrix(), JOp.asmatrix()),
                     (Op.T.asmatrix(), JOp.T.asmatrix()),
                     ((Op + Op).asmatrix(), (JOp + JOp).asmatrix()),
                     ((Op - Op.T).asmatrix(), (JOp - JOp.T).asmatrix()),
                     ((Op * Op).asmatrix(), (JOp * JOp).asmatrix()),
                     ((Op @ Op).asmatrix(), (JOp @ JOp).asmatrix()),
                     (Op.kron(Op).asmatrix(), JOp.kron(JOp).asmatrix()),
                     (Op.slice([(1, 5), (2, 7)]).asmatrix(),
                      JOp.slice([(1, 5), (2, 7)]).asmatrix()),
                     (CanonicalOperator.eye((3, 4), format='csr').asmatrix(),
                      jt.CanonicalOperator.eye((3, 4), format='csr')
                      .asmatrix()),
                     (Op.asmatrix('csc'), JOp.asmatrix('csc'))):
        assert got.format == ref.format
        _close(got.toarray(), ref.toarray())
    assert Op.shape == JOp.shape and Op.R == JOp.R
    assert len(Op.terms) == len(JOp.terms)
    assert repr(Op) == repr(JOp)
    assert Op.kron(Op).shape == JOp.kron(JOp).shape
