"""The backward of the stage (K2) and of the fold (K3) in the PyTorch port:
``stage_bwd_plain`` and ``fold_bwd_plain`` (what a CPU tensor runs)
against autograd of the plain forwards on ragged shapes and against
``jax.vjp`` of the JAX package's merged chain sum; the per-term views of
one stacked gradient through autograd's accumulation (a field in two
terms of different tables, a field on a second path, two backward passes
into leaves that share a table) against separate tensors; tables that no
term needs; more than 16 terms and more than 16 distinct tables; and the
wrappers' CUDA branch driven on CPU tensors through a stand-in for the
library entry, which computes from the pointers it is handed: one launch
a fold up to 16 distinct tables, the gradient of table i at ``out + i K
R``.  All float64."""

import contextlib
import ctypes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pyiga_tpu.ops import sumfac as jsumfac

from pyiga_tpu_torch import _cuda
from pyiga_tpu_torch.ops import cuda_sumfac

torch.set_num_threads(1)


def _r(rng, *shape):
    return torch.as_tensor(rng.rand(*shape) - 0.5, dtype=torch.float64)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize('K,R,M', [(33, 101, 7), (5, 17, 16), (64, 9, 35)])
def test_stage_bwd_plain_matches_autograd(K, R, M):
    rng = np.random.RandomState(K + R + M)
    X, T, g = _r(rng, K, R), _r(rng, M, K), _r(rng, R, M)
    Xg = X.clone().requires_grad_(True)
    ref, = torch.autograd.grad(cuda_sumfac.stage_plain(Xg, T), Xg, g)
    got = cuda_sumfac.stage_bwd_plain(T, g)
    assert got.shape == (K, R)
    assert _rel(got, ref) < 1e-15
    assert torch.equal(cuda_sumfac.stage_bwd(T, g), got)


@pytest.mark.parametrize('term_idx,need', [
    ((0, 1, 0, 2), None),
    ((2, 2, 0), (True, True, False)),           # table 0: no term needs it
    ((1, 0, 1, 3), (False, True, True, False)),  # tables 2 and 3 unused
])
def test_fold_bwd_plain_matches_autograd(term_idx, need):
    rng = np.random.RandomState(len(term_idx))
    K, R, M = 13, 29, 11
    tabs = [_r(rng, M, K) for _ in range(4)]
    xs = [_r(rng, K, R) for _ in term_idx]
    g = _r(rng, R, M)
    want = need or (True,) * len(term_idx)
    xg = [x.clone().requires_grad_(w) for x, w in zip(xs, want)]
    leaves = [x for x in xg if x.requires_grad]
    refs = iter(torch.autograd.grad(cuda_sumfac.fold_plain(xg, tabs,
                                                           term_idx),
                                    leaves, g))
    got = cuda_sumfac.fold_bwd_plain(tabs, term_idx, g, need)
    used = list(dict.fromkeys(i for i, w in zip(term_idx, want) if w))
    base = next(a for a in got if a is not None)._base
    assert base.shape == (len(used), K, R)
    for a, i, w in zip(got, term_idx, want):
        if not w:
            assert a is None
            continue
        assert a._base is base                  # views of one tensor
        assert torch.equal(a, base[used.index(i)])
        assert _rel(a, next(refs)) < 1e-15
    assert all(a is None for a in cuda_sumfac.fold_bwd_plain(
        tabs, term_idx, g, [False] * len(term_idx)))


@pytest.mark.parametrize('n_terms,n_tables', [(17, 3), (18, 18)])
def test_fold_bwd_past_sixteen(n_terms, n_tables):
    """More than 16 terms, and more than 16 distinct tables (two launches
    on the card), through the Function against autograd of fold_plain."""
    rng = np.random.RandomState(n_terms + n_tables)
    K, R, M = 6, 10, 5
    tabs = [_r(rng, M, K) for _ in range(n_tables)]
    idx = [(3 * t) % n_tables for t in range(n_terms)]
    xs = [_r(rng, K, R).requires_grad_(True) for _ in idx]
    g = _r(rng, R, M)
    got = torch.autograd.grad(cuda_sumfac.fold(xs, tabs, idx), xs, g)
    xp = [x.detach().clone().requires_grad_(True) for x in xs]
    ref = torch.autograd.grad(cuda_sumfac.fold_plain(xp, tabs, idx), xp, g)
    for a, b in zip(got, ref):
        assert _rel(a, b) < 1e-15


def test_fold_bwd_views_through_accumulation():
    """Field `a` feeds two terms of different tables, field `b` a term and
    a second differentiable path, leaves `c` and `d` share a table; two
    backward passes accumulate into the leaves' ``.grad``.  The stacked
    views give what separate tensors give (autograd of fold_plain)."""
    rng = np.random.RandomState(21)
    K, R, M = 9, 14, 8
    tabs = [_r(rng, M, K) for _ in range(3)]
    w = _r(rng, R, M)
    idx = [0, 1, 0, 2, 2]
    leaves0 = [_r(rng, K, R) for _ in range(4)]

    def grads(fold):
        a, b, c, d = [x.clone().requires_grad_(True) for x in leaves0]
        for _ in range(2):
            out = fold([a * 1.0, b, a, c, d], tabs, idx)
            ((w * out).sum() + (b * b * b).sum()).backward()
        return [x.grad for x in (a, b, c, d)]
    got = grads(cuda_sumfac.fold)
    ref = grads(cuda_sumfac.fold_plain)
    for x, y in zip(got, ref):
        assert _rel(x, y) <= 1e-15
    assert not any(x.data_ptr() == y.data_ptr()
                   for i, x in enumerate(got) for y in got[i + 1:])


def test_fold_bwd_plain_matches_jax_vjp():
    """K3's backward against ``jax.vjp`` of the JAX package's merged
    final stage (``_sum_chains_merged`` over one-stage chains; a JAX field
    is the port's ``(K, R)`` field transposed)."""
    rng = np.random.RandomState(4)
    K, R, M = 12, 23, 9
    tabs = [rng.rand(M, K) - 0.5 for _ in range(3)]
    idx = (1, 0, 1, 2)
    xs = [rng.rand(K, R) - 0.5 for _ in idx]
    g = rng.rand(R, M) - 0.5
    term_tables = [[jnp.asarray(tabs[i])] for i in idx]

    def fn(*fields):
        return jsumfac._sum_chains_merged(term_tables, fields,
                                          range(len(idx)), last_idx=idx)
    _, vjp = jax.vjp(fn, *[jnp.asarray(x.T) for x in xs])
    ref = vjp(jnp.asarray(g))
    got = cuda_sumfac.fold_bwd_plain([torch.as_tensor(t) for t in tabs], idx,
                                     torch.as_tensor(g))
    for a, b in zip(got, ref):
        assert _rel(a.T, b) < 1e-14


@pytest.mark.parametrize('tables,g,match', [
    ([(4, 3), (4, 5)], (6, 4), 'table 1 is'),
    ([(4, 3)], (6, 5), 'disagree in M'),
    ([(4, 3, 1)], (6, 4), 'table 0 is'),
])
def test_bwd_argument_checks(tables, g, match):
    rng = np.random.RandomState(0)
    tabs = [_r(rng, *s) for s in tables]
    with pytest.raises(ValueError, match=match):
        cuda_sumfac.fold_bwd(tabs, list(range(len(tabs))), _r(rng, *g))
    if len(tabs) == 1:
        with pytest.raises(ValueError, match=match):
            cuda_sumfac.stage_bwd(tabs[0], _r(rng, *g))


class _FakeLibrary:
    """``pyiga_stage_bwd_f64`` on host memory: reads the tables and `g`
    from the pointers it is handed and writes table i's gradient at
    ``out + i K R``, as the kernel does; records each call."""

    def __init__(self):
        self.calls = []

    def pyiga_stage_bwd_f64(self, t_ptrs, n, g, out, K, R, M, stream):
        def arr(ptr, *shape):
            buf = (ctypes.c_double * int(np.prod(shape))).from_address(ptr)
            return np.ctypeslib.as_array(buf).reshape(shape)
        ptrs = ctypes.cast(t_ptrs, ctypes.POINTER(ctypes.c_uint64))
        self.calls.append(n)
        gr = arr(g, R, M)
        o = arr(out, n, K, R)
        for i in range(n):
            o[i] = arr(ptrs[i], M, K).T @ gr.T
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors: the device test forced,
    the library replaced by :class:`_FakeLibrary`."""
    lib = _FakeLibrary()
    monkeypatch.setattr(cuda_sumfac, '_kernel_device', lambda t, n: True)
    monkeypatch.setattr(_cuda, 'library', lambda: lib)
    monkeypatch.setattr(_cuda, 'require', lambda *a: None)
    monkeypatch.setattr(_cuda, 'device_of',
                        lambda t: contextlib.nullcontext())
    monkeypatch.setattr(_cuda, 'stream_of', lambda t: 0)
    _cuda.reset_launches()
    return lib


@pytest.mark.parametrize('n_tables', [1, 3, 16, 17, 33])
def test_fold_bwd_launches_once_per_sixteen_tables(fake_card, n_tables):
    rng = np.random.RandomState(n_tables)
    K, R, M = 7, 11, 5
    tabs = [_r(rng, M, K) for _ in range(n_tables)]
    idx = list(range(n_tables)) + [0]
    g = _r(rng, R, M)
    got = cuda_sumfac.fold_bwd(tabs, idx, g)
    launches = -(-n_tables // 16)
    assert fake_card.calls == [min(16, n_tables - 16 * c)
                               for c in range(launches)]
    assert _cuda.LAUNCHES['fold_bwd'] == launches
    ref = cuda_sumfac.fold_bwd_plain(tabs, idx, g)
    for a, b in zip(got, ref):
        assert torch.allclose(a, b, rtol=1e-14, atol=1e-15)
    assert got[0] is got[-1]                  # terms of one table share
    assert got[0]._base is got[1]._base
    one = cuda_sumfac.stage_bwd(tabs[0], g)
    assert one.shape == (K, R) and torch.allclose(one, ref[0], rtol=1e-14,
                                                  atol=1e-15)
    assert _cuda.LAUNCHES['stage_bwd'] == 1
