"""The float32 backward of the stage (K2-bwd f32) and of the fold (K3-bwd
f32) in the PyTorch port: the launch plan of ``stage_bwd_f32_kernel``
(``cuda_sumfac.stage_bwd_f32_plan``: the tile that pads K least, the
split of M into chunks on 16-deep slice bounds where the unsplit grid
cannot fill the card) at the paths' shapes and at ragged ones, and the
wrappers' CUDA branch driven on CPU tensors through a stand-in for the
library entry with the kernel's signature, which refuses a plan the
kernel refuses, sums each chunk's partial and then the chunks in chunk
order: its result against ``stage_bwd_plain`` / ``fold_bwd_plain`` and
against ``jax.vjp`` of the JAX package's merged chain sum in float32."""

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

F32 = torch.float32
N_SM = 132                  # the H100 SXM's SMs
SLICE = 16
# (k rows, r columns, blocks an SM) of Tile192, Tile128 and Tile64, as
# the built library's pyiga_stage_bwd_f32_tiles reports them
TILES = ((192, 128, 1), (128, 128, 1), (64, 128, 2))

# (K, R, M, tables): the 3D n=48 gradient's two stage shapes and its fold,
# 2D n=128's stage and its fold over 2 and 3 tables, the ragged fold, M <
# 16, 16 tables, a split whose last chunk is short, K = 1
PATH_SHAPES = {
    'n48 stage R=36864': (192, 36864, 345, 1),
    'n48 stage R=66240': (192, 66240, 345, 1),
    'n48 fold': (192, 119025, 345, 3),
    '2D n128 stage': (512, 512, 905, 1),
    '2D n128 fold 2': (512, 905, 905, 2),
    '2D n128 fold 3': (512, 905, 905, 3),
    'ragged fold': (33, 1001, 7, 2),
    'M < 16': (64, 300, 5, 1),
    '16 tables': (192, 4097, 345, 16),
    'short last chunk': (64, 130, 1001, 1),
    'K = 1': (1, 999, 40, 1),
}
N48 = ('n48 stage R=36864', 'n48 stage R=66240', 'n48 fold')
SHAPES = list(PATH_SHAPES.values()) + [
    (K, 1000, 345, 1) for K in (1, 2, 3, 31, 63, 64, 65, 96, 100, 127, 128,
                                129, 191, 192, 193, 256, 300, 383, 384, 511,
                                512, 513, 576, 600)]


def _padded(K, bk):
    return -(-K // bk) * bk


@pytest.mark.parametrize('K,R,M,G', SHAPES)
def test_plan_tile_pads_k_least(K, R, M, G):
    plan = cuda_sumfac.stage_bwd_f32_plan(K, R, M, G, N_SM, TILES)
    tiles = TILES
    least = min(_padded(K, bk) for bk, _br, _b in tiles)
    assert plan['bk'] == tiles[plan['tile']][0]
    assert _padded(K, plan['bk']) == least
    # the larger tile on a tie
    assert plan['bk'] == max(bk for bk, _br, _b in tiles
                             if _padded(K, bk) == least)


@pytest.mark.parametrize('K,R,M,G', SHAPES)
def test_plan_chunks_cover_m_once_on_slices(K, R, M, G):
    plan = cuda_sumfac.stage_bwd_f32_plan(K, R, M, G, N_SM, TILES)
    b, S = plan['bounds'], plan['chunks']
    assert 1 <= S <= 64 and len(b) == S + 1
    assert b[0] == 0 and b[-1] == M
    assert all(x < y for x, y in zip(b, b[1:]))
    assert all(x % SLICE == 0 for x in b[:-1])
    covered = np.zeros(M, dtype=int)
    for c in range(S):
        covered[b[c]:b[c + 1]] += 1
    assert (covered == 1).all()
    # every chunk but the last a whole number of slices; the last may be
    # short
    assert all((y - x) % SLICE == 0 for x, y in zip(b[:-2], b[1:-1]))


@pytest.mark.parametrize('K,R,M,G', SHAPES)
def test_plan_splits_only_under_a_wave(K, R, M, G):
    plan = cuda_sumfac.stage_bwd_f32_plan(K, R, M, G, N_SM, TILES)
    _bk, br, per_sm = TILES[plan['tile']]
    unsplit = -(-K // plan['bk']) * -(-R // br) * G
    wave = N_SM * per_sm
    assert plan['blocks'] == unsplit * plan['chunks']
    assert plan['waves'] == pytest.approx(plan['blocks'] / wave)
    if plan['chunks'] > 1:
        assert unsplit < wave
        assert plan['blocks'] <= wave          # the split fits one wave
        assert all(y - x >= 4 * SLICE for x, y in
                   zip(plan['bounds'][:-2], plan['bounds'][1:-1]))


@pytest.mark.parametrize('name', N48)
def test_plan_does_not_split_at_n48(name):
    plan = cuda_sumfac.stage_bwd_f32_plan(*PATH_SHAPES[name], N_SM, TILES)
    assert plan['chunks'] == 1 and plan['bk'] == 192


def test_plan_splits_the_2d_stage():
    """2D n=128's stage has 16 output tiles of 128 x 128: the split
    fills the card."""
    plan = cuda_sumfac.stage_bwd_f32_plan(*PATH_SHAPES['2D n128 stage'],
                                          N_SM, TILES)
    assert plan['bk'] == 128 and plan['chunks'] > 1
    assert plan['waves'] > 0.5


def _arr(ptr, dtype, *shape):
    n = int(np.prod(shape))
    buf = (np.ctypeslib.as_ctypes_type(dtype) * n).from_address(ptr)
    return np.ctypeslib.as_array(buf).reshape(shape)


class _FakeLibrary:
    """``pyiga_stage_bwd_f32`` on host memory with the kernel's signature:
    refuses (1, cudaErrorInvalidValue) what the entry refuses; computes
    each chunk's partial of each table in float32, writes it to the
    scratch ``(S, n, K, R)`` where S > 1 and then sums the chunks in chunk
    order into ``out`` (table i at ``out + i K R``), as the two passes
    do; records each call's tables, tile, chunks and scratch.  Reports
    `tiles` through ``pyiga_stage_bwd_f32_tiles``."""

    def __init__(self, tiles=TILES):
        self.calls = []
        self.tiles = tiles

    def pyiga_stage_bwd_f32_tiles(self, out, n_max):
        if n_max < len(self.tiles):
            return -1
        buf = ctypes.cast(out, ctypes.POINTER(ctypes.c_int))
        for i, v in enumerate(x for t in self.tiles for x in t):
            buf[i] = v
        return len(self.tiles)

    def pyiga_stage_bwd_f32(self, t_ptrs, n, g, out, K, R, M, tile, S,
                            bounds, scratch, stream):
        b = ctypes.cast(bounds, ctypes.POINTER(ctypes.c_int))[:S + 1]
        self.calls.append(dict(n=n, tile=tile, chunks=S, bounds=b,
                               scratch=bool(scratch)))
        if (not 1 <= n <= 16 or min(K, R, M) < 1 or not 1 <= S <= 64
                or not 0 <= tile < len(self.tiles)
                or (S > 1 and not scratch)
                or b[0] != 0 or b[-1] != M
                or any(x >= y for x, y in zip(b, b[1:]))
                or any(x % SLICE for x in b[:-1])):
            return 1
        ptrs = ctypes.cast(t_ptrs, ctypes.POINTER(ctypes.c_uint64))
        gr = _arr(g, np.float32, R, M)
        tabs = [_arr(ptrs[i], np.float32, M, K) for i in range(n)]
        o = _arr(out, np.float32, n, K, R)
        parts = (_arr(scratch, np.float32, S, n, K, R) if S > 1
                 else o[None])
        for c in range(S):
            m0, m1 = b[c], b[c + 1]
            for i in range(n):
                parts[c, i] = tabs[i][m0:m1].T @ gr[:, m0:m1].T
        if S > 1:
            acc = parts[0].copy()
            for c in range(1, S):
                acc += parts[c]
            o[...] = acc
        return 0


def _install(monkeypatch, lib):
    """The wrappers' CUDA branch on CPU tensors: the device test forced,
    the library replaced by `lib`, a card of 132 SMs."""
    monkeypatch.setattr(cuda_sumfac, '_kernel_device', lambda t, n: True)
    monkeypatch.setattr(_cuda, 'library', lambda: lib)
    monkeypatch.setattr(_cuda, 'require', lambda *a: None)
    monkeypatch.setattr(_cuda, 'device_of',
                        lambda t: contextlib.nullcontext())
    monkeypatch.setattr(_cuda, 'stream_of', lambda t: 0)
    monkeypatch.setattr(_cuda, 'sm_count', lambda t: N_SM)
    _cuda.reset_launches()
    return lib


@pytest.fixture
def fake_card(monkeypatch):
    """:func:`_install` of a :class:`_FakeLibrary` with the shipped
    tiles."""
    return _install(monkeypatch, _FakeLibrary())


def _r(rng, *shape):
    return torch.as_tensor(rng.rand(*shape) - 0.5, dtype=F32)


def _rel(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _jax_vjp(tabs, idx, xs_shape, g):
    """``jax.vjp`` of the JAX package's merged final stage over
    one-stage chains in float32 (a JAX field is the port's ``(K, R)``
    field transposed); per term its field's gradient ``(K, R)``."""
    K, R = xs_shape
    term_tables = [[jnp.asarray(tabs[i])] for i in idx]

    def fn(*fields):
        return jsumfac._sum_chains_merged(term_tables, fields,
                                          range(len(idx)), last_idx=idx)
    zeros = [jnp.zeros((R, K), dtype=jnp.float32) for _ in idx]
    _, vjp = jax.vjp(fn, *zeros)
    return [np.asarray(a).T for a in vjp(jnp.asarray(g))]


# (K, R, M): one chunk; a split with a short last chunk; M < 16 and K =
# 1; a Tile128 split with an odd R
STAGE_CASES = [(48, 37, 50), (64, 130, 1001), (1, 45, 5), (130, 7, 300)]


@pytest.mark.parametrize('K,R,M', STAGE_CASES)
def test_stage_bwd_f32_through_fake_card(fake_card, K, R, M):
    rng = np.random.RandomState(K + R + M)
    T, g = _r(rng, M, K), _r(rng, R, M)
    got = cuda_sumfac.stage_bwd(T, g)
    assert got.dtype == F32 and got.shape == (K, R)
    plan = cuda_sumfac.stage_bwd_f32_plan(K, R, M, 1, N_SM, TILES)
    call, = fake_card.calls
    assert call == dict(n=1, tile=plan['tile'], chunks=plan['chunks'],
                        bounds=plan['bounds'], scratch=plan['chunks'] > 1)
    assert _cuda.LAUNCHES['stage_bwd_f32'] == 1
    assert _cuda.LAUNCHES['stage_bwd'] == 0
    assert _rel(got, cuda_sumfac.stage_bwd_plain(T, g)) <= 1e-6
    ref, = _jax_vjp([T.numpy()], (0,), (K, R), g.numpy())
    assert _rel(got, ref) <= 1e-6
    # bitwise on a repeat
    assert torch.equal(cuda_sumfac.stage_bwd(T, g), got)


def test_the_split_cases_split():
    """The stage cases above include a split (the stand-in's second pass
    is exercised) and one that does not."""
    S = [cuda_sumfac.stage_bwd_f32_plan(K, R, M, 1, N_SM, TILES)['chunks']
         for K, R, M in STAGE_CASES]
    assert S[0] == 1 and S[1] > 1 and S[3] > 1


@pytest.mark.parametrize('K,R,M,idx', [
    (33, 101, 7, (1, 0, 1)),                     # the ragged fold, M < 16
    (64, 33, 1001, (0, 1, 2, 0)),                # split over 3 tables
    (20, 17, 40, tuple(range(16)) + (3,)),       # 16 tables, one launch
    (12, 9, 70, tuple(range(19))),               # 19 tables, two launches
])
def test_fold_bwd_f32_through_fake_card(fake_card, K, R, M, idx):
    rng = np.random.RandomState(len(idx) + M)
    ntab = max(idx) + 1
    tabs = [_r(rng, M, K) for _ in range(ntab)]
    g = _r(rng, R, M)
    got = cuda_sumfac.fold_bwd(tabs, idx, g)
    launches = -(-ntab // 16)
    assert [c['n'] for c in fake_card.calls] == [
        min(16, ntab - 16 * c) for c in range(launches)]
    for c in fake_card.calls:
        plan = cuda_sumfac.stage_bwd_f32_plan(K, R, M, c['n'], N_SM, TILES)
        assert (c['tile'], c['chunks'], c['bounds']) == (
            plan['tile'], plan['chunks'], plan['bounds'])
    assert _cuda.LAUNCHES['fold_bwd_f32'] == launches
    assert _cuda.LAUNCHES['fold_bwd'] == 0
    ref = cuda_sumfac.fold_bwd_plain(tabs, idx, g)
    jref = _jax_vjp([t.numpy() for t in tabs], idx, (K, R), g.numpy())
    for a, b, j in zip(got, ref, jref):
        assert a.dtype == F32 and a.shape == (K, R)
        assert _rel(a, b) <= 1e-6
        assert _rel(a, j) <= 1e-6
    assert got[idx.index(0)] is got[len(idx) - 1 - idx[::-1].index(0)]


def test_stage_bwd_f32_g_at_an_offset(fake_card):
    """g a view 4 bytes into its buffer: the pointer handed over is the
    view's."""
    rng = np.random.RandomState(3)
    K, R, M = 40, 21, 33
    T = _r(rng, M, K)
    buf = _r(rng, R * M + 1)
    g = buf[1:].view(R, M)
    got = cuda_sumfac.stage_bwd(T, g)
    assert _rel(got, cuda_sumfac.stage_bwd_plain(T, g)) <= 1e-6


def test_stage_bwd_f32_refused_plan_raises(fake_card, monkeypatch):
    """A plan the entry refuses raises; nothing replaces the launch."""
    def bad(K, R, M, n, n_sm, tiles):         # an inner bound off a slice
        return 0, 2, (ctypes.c_int * 3)(0, 7, M)
    monkeypatch.setattr(cuda_sumfac, '_stage_bwd_f32_args', bad)
    monkeypatch.setattr(_cuda, 'check', lambda err, name: (
        None if err == 0 else (_ for _ in ()).throw(
            RuntimeError('%s: refused (%d)' % (name, err)))))
    rng = np.random.RandomState(4)
    with pytest.raises(RuntimeError, match='stage_bwd_f32: refused'):
        cuda_sumfac.stage_bwd(_r(rng, 30, 8), _r(rng, 5, 30))
    assert _cuda.LAUNCHES['stage_bwd_f32'] == 0


def test_stage_bwd_f32_double_backward_raises(fake_card, monkeypatch):
    """K2-bwd f32 on a gradient that requires grad records its Function:
    the value is the stand-in kernel's, and its backward (one K3 fold of
    the cotangent, here in its plain version) equals autograd of the
    plain backward.  A table that requires grad raises: tables are
    constants."""
    rng = np.random.RandomState(6)
    T = _r(rng, 9, 4)
    g = _r(rng, 5, 9).requires_grad_(True)
    u = _r(rng, 4, 5)
    monkeypatch.setattr(cuda_sumfac, '_fold_kernel', cuda_sumfac.fold_plain)
    got = cuda_sumfac.stage_bwd(T, g)
    assert got.requires_grad and len(fake_card.calls) == 1
    gg, = torch.autograd.grad((u * got).sum(), g)
    g2 = g.detach().clone().requires_grad_(True)
    ref = cuda_sumfac.stage_bwd_plain(T, g2)
    rg, = torch.autograd.grad((u * ref).sum(), g2)
    assert _rel(got.detach(), ref.detach()) < 1e-6
    assert _rel(gg, rg) < 1e-6
    with pytest.raises(RuntimeError, match='constants'):
        cuda_sumfac.stage_bwd(T.clone().requires_grad_(True), g)


def test_stage_bwd_f32_tiles_read_from_the_library():
    """The tiles come from the library's own report, read once a
    library; a report of no tile raises."""
    lib = _FakeLibrary()
    assert cuda_sumfac.stage_bwd_f32_tiles(lib) == TILES
    lib.tiles = ((8, 8, 1),)
    assert cuda_sumfac.stage_bwd_f32_tiles(lib) == TILES     # cached
    assert cuda_sumfac.stage_bwd_f32_tiles(_FakeLibrary(((8, 8, 1),))) \
        == ((8, 8, 1),)
    with pytest.raises(RuntimeError, match='pyiga_stage_bwd_f32_tiles'):
        cuda_sumfac.stage_bwd_f32_tiles(_FakeLibrary(tuple(
            (8, 8, 1) for _ in range(17))))


@pytest.mark.parametrize('tiles,K,R,M', [
    (((96, 64, 1), (32, 64, 4)), 64, 130, 1001),  # the 32-row tile, split
    (((96, 64, 1), (32, 64, 4)), 96, 3000, 345),  # the 96-row tile, whole
    (((256, 32, 2),), 5, 40, 300),                # one tile
])
def test_stage_bwd_f32_plans_over_the_library_tiles(monkeypatch, tiles, K,
                                                   R, M):
    """A library built with other tiles gets a plan over its own tiles,
    not over the shipped geometry."""
    lib = _install(monkeypatch, _FakeLibrary(tiles))
    rng = np.random.RandomState(K + M)
    T, g = _r(rng, M, K), _r(rng, R, M)
    got = cuda_sumfac.stage_bwd(T, g)
    plan = cuda_sumfac.stage_bwd_f32_plan(K, R, M, 1, N_SM, tiles)
    call, = lib.calls
    assert (call['tile'], call['chunks'], call['bounds']) == (
        plan['tile'], plan['chunks'], plan['bounds'])
    assert plan['bk'] == tiles[plan['tile']][0]
    assert _rel(got, cuda_sumfac.stage_bwd_plain(T, g)) <= 1e-6
