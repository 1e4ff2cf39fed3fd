"""The order-exact wavefront Gauss-Seidel smoother of the PyTorch port
(``ops/relax.py``, the wavefront packs of ``ops/cuda_mg.py``) and the
local-MG routes built on it, held against the JAX package on the CPU:
identical schedules and packs, sweeps to 1e-13 against the JAX
``DeviceIndexedGS`` and the host ``gauss_seidel``, identical iteration
counts against the host path."""

import functools
import inspect
from fractions import Fraction

import numpy as np
import pytest
import scipy.linalg
import scipy.sparse
import scipy.sparse.linalg
import torch

import pyiga_tpu.ops.relax as jrelax
import pyiga_tpu.solvers as jsolvers

from pyiga_tpu_torch import _cuda, assemble, bspline, hierarchical, solvers
from pyiga_tpu_torch.ops import cuda_mg, mg, relax

from test_torch_hierarchical import example_hspace
from test_torch_localmg import REFERENCE_COUNTS, discretize, num_iterations

torch.set_num_threads(1)


def _spd(n, rng, density=0.08):
    A = scipy.sparse.random(n, n, density=density, random_state=rng)
    return (A + A.T + 10 * scipy.sparse.eye(n)).tocsr()


def _nonsym(n, rng, density=0.1):
    A = scipy.sparse.random(n, n, density=density, random_state=rng)
    return (A + 10 * scipy.sparse.eye(n)).tocsr()


MATRICES = {'symmetric': _spd, 'nonsymmetric': _nonsym}


def _fma(a, b, c):
    """a * b + c rounded once (float(Fraction) rounds correctly)."""
    return float(Fraction(a) * Fraction(b) + Fraction(c))


def _quotient(num, d, r):
    """The chain warp's quotient: num / d from the reciprocal r = 1 / d,
    q = num r corrected by one residual step (fused as on the card)."""
    out = np.empty_like(num)
    for i, (n_, d_, r_) in enumerate(zip(num.tolist(), d.tolist(),
                                         r.tolist())):
        q = n_ * r_
        out[i] = _fma(_fma(-q, d_, n_), r_, q)
    return out


def _stale_sums(vals, cols, k, L, T, xs):
    """A level's stale partials in the kernel's order, from its stale
    values and columns (lane-major, ``cuda_mg.stale_positions``): lane j
    of a row's L sums its quads t L + j with an accumulator per entry of
    the quad, the four summed pairwise, then the L lanes' sums by a
    butterfly."""
    if not T:
        return np.zeros(k)
    pv, pc = cuda_mg.stale_positions(k, L, T)
    prod = (vals[pv] * xs[cols[pc]]).reshape(k, T, L, 4)
    acc = prod[:, 0]
    for t in range(1, T):
        acc = acc + prod[:, t]
    s = (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])
    o = L // 2
    while o:
        s = s[:, :o] + s[:, o:2 * o]
        o //= 2
    return s[:, 0]


def _level_sums(c, level, xs):
    """The sums of one level's rows in the kernel's order: the stale
    partial (:func:`_stale_sums`), then the fresh entries one by one.
    Returns the rows' indices in the pack and their sums."""
    row0, s0, f0, k, Ws, L, T, F = (int(t) for t in c['lvl'][level])
    Rp = -(-k // 4) * 4
    s = _stale_sums(c['sval'][s0:], c['scol'][s0:], k, L, T, xs)
    for i in range(F):
        e = f0 + i * Rp + np.arange(k)
        s = s + c['fval'][e] * xs[c['fcol'][e]]
    return np.arange(row0, row0 + k), s


def _emulate_blocks(sweeps, group, iterations, x, b):
    """:func:`_emulate_kernel` on the device layout of the group
    (``cuda_mg._group_blocks``: the table rows decoded as the kernel
    decodes them, the stale and chain blocks at their offsets, b placed
    by ``boff``)."""
    blk = cuda_mg._group_blocks(sweeps.compact[group])
    sb = blk['sblk']
    cd = blk['cblk'].copy().view(np.float64)
    cd[blk['boff']] = b[blk['gid']]
    cb = cd.view(np.uint8)
    xs = x[sweeps.l2g].copy()
    hist = []                  # the values each level of the pass wrote
    for _ in range(iterations):
        for so, co, kw, lw in blk['table'].tolist():
            k, Ws = kw & 0xffffffff, kw >> 32
            L, T, F = lw & 0xff, (lw >> 8) & 0xff, (lw >> 16) & 0xffff
            if lw >> 32 == 0:           # a pass starts
                hist = []
            Rp = -(-k // 4) * 4
            ks = k * Ws
            s = _stale_sums(sb[so:so + 8 * ks].view(np.float64),
                            sb[so + 8 * ks:so + 12 * ks].view(np.int32),
                            k, L, T, xs)
            bb, r, d = (cb[co + 8 * i * Rp:co + 8 * (i + 1) * Rp].view(
                np.float64)[:k] for i in range(3))
            dst = cb[co + 24 * Rp:co + 28 * Rp].view(np.int32)[:k]
            o = co + 28 * Rp
            fval = cb[o:o + 8 * F * Rp].view(np.float64)
            fsrc = cb[o + 8 * F * Rp:o + 12 * F * Rp].view(np.int32)
            for i in range(F):
                e = i * Rp + np.arange(k)
                # a value from the chain warp's registers (row q of the
                # level a back) or from the local x
                # (a pad, times zero, may read a level the pass has not
                # run)
                xv = np.array([(hist[-1 - (~j >> 5)][~j & 31]
                                if len(hist) > ~j >> 5 else 0.0) if j < 0
                               else xs[j] for j in fsrc[e].tolist()])
                s = s + fval[e] * xv
            xs[dst] = _quotient(bb - s, d, r)
            hist.append(xs[dst].copy())
    x[sweeps.l2g[:sweeps.m]] = xs[:sweeps.m]
    return x


def _emulate_kernel(sweeps, group, iterations, x, b):
    """The arithmetic of ``csrc/mg.cu`` ``wavefront_smooth`` on the
    kernel's own operands (``sweeps.compact``, the local numbering), in
    numpy: a level's rows read the local x (the producers' stale entries
    and the chain's fresh ones see the same values), then write it."""
    xs = x[sweeps.l2g].copy()
    for _ in range(iterations):
        for c in sweeps.compact[group]:
            for level in range(c['nlev']):
                r, s = _level_sums(c, level, xs)
                xs[c['dst'][r]] = _quotient(b[c['gid'][r]] - s,
                                            c['diag'][r], c['rcp'][r])
    x[sweeps.l2g[:sweeps.m]] = xs[:sweeps.m]
    return x


@pytest.mark.parametrize('kind', sorted(MATRICES))
@pytest.mark.parametrize('reverse', [False, True])
def test_level_schedule_and_pack_match_jax(kind, reverse):
    rng = np.random.RandomState(1)
    A = MATRICES[kind](60, rng)
    subset = rng.permutation(60)[:40]
    order, level = relax.level_schedule(A, subset, reverse=reverse)
    jorder, jlevel = jrelax.level_schedule(A, subset, reverse=reverse)
    assert np.array_equal(order, jorder) and np.array_equal(level, jlevel)
    for got, ref in zip(relax._pack_sweep(A, order, level),
                        jrelax._pack_sweep(A, jorder, jlevel)):
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
    # every row comes after each earlier row whose value it reads
    rank = {i: r for r, i in enumerate(order)}
    for r, i in enumerate(order):
        for j in A.indices[A.indptr[i]:A.indptr[i + 1]]:
            if j in rank and rank[j] < r:
                assert level[rank[j]] < level[r]


def _zero_diag(A, rows):
    A = A.tolil()
    for i in rows:
        A[i, i] = 0.0
    return A.tocsr()


CASES = {
    'subset': lambda rng, n: rng.permutation(n)[:37],
    'all': lambda rng, n: np.arange(n),
    'empty': lambda rng, n: np.array([], dtype=np.int64),
}


@pytest.mark.parametrize('kind', sorted(MATRICES))
@pytest.mark.parametrize('sweep', ['forward', 'backward', 'symmetric'])
@pytest.mark.parametrize('case', sorted(CASES))
def test_device_indexed_gs_matches_jax_and_host(kind, sweep, case):
    rng = np.random.RandomState(0)
    A = MATRICES[kind](80, rng)
    subset = CASES[case](rng, 80)
    A = _zero_diag(A, subset[:2])          # rows the sweep must skip
    b = rng.rand(80)
    x0 = rng.rand(80)
    xh = x0.copy()
    if len(subset):
        solvers.gauss_seidel(A, xh, b, iterations=3, indices=subset,
                             sweep=sweep)
    xj = x0.copy()
    jrelax.DeviceIndexedGS(A, subset, sweep=sweep, iterations=3).apply(xj, b)
    before = dict(_cuda.LAUNCHES)
    gs = relax.DeviceIndexedGS(A, subset, sweep=sweep, iterations=3,
                               device='cpu')
    xd = x0.copy()
    assert gs.apply(xd, b) is xd
    assert _cuda.LAUNCHES == before        # the CPU runs the plain version
    assert np.abs(xd - xj).max() < 1e-13 and np.abs(xd - xh).max() < 1e-13
    if not len(subset):
        assert np.array_equal(xd, x0)
    # the kernel's operands (local numbering, live rows, padded widths)
    # compute the same sweeps
    xk = _emulate_kernel(gs.sweeps, 0, 3, x0.copy(), b)
    assert np.abs(xk - xd).max() < 1e-13
    assert [c['war'] for c in gs.sweeps.compact[0]] == \
        [False] * len(gs.sweeps.compact[0]) or kind == 'nonsymmetric'


def test_war_pass_and_zero_diagonal():
    # the reference's small cases: a write after read in one level, and a
    # zero diagonal that the sweep skips
    A = scipy.sparse.csr_matrix(np.array([[2., 0, 0], [1, 2, 1], [0, 0, 2]]))
    b = np.array([1., 1, 1])
    xh = np.array([1., 1, 1])
    solvers.gauss_seidel(A, xh, b, indices=np.array([0, 1, 2]))
    gs = relax.DeviceIndexedGS(A, np.array([0, 1, 2]), device='cpu')
    assert gs.sweeps.compact[0][0]['war']
    xd = gs.apply(np.array([1., 1, 1]), b)
    assert np.allclose(xh, xd, rtol=1e-15)
    assert np.allclose(_emulate_kernel(gs.sweeps, 0, 1, np.ones(3), b), xd)
    A = scipy.sparse.csr_matrix(np.array([[2., 1, 0], [0, 0., 1],
                                          [0, 1, 2.]]))
    xh = np.array([1., 1, 1])
    solvers.gauss_seidel(A, xh, b, indices=np.array([0, 1, 2]))
    gs = relax.DeviceIndexedGS(A, np.array([0, 1, 2]), device='cpu')
    xd = gs.apply(np.array([1., 1, 1]), b)
    assert xd[1] == 1.0 and np.allclose(xh, xd, rtol=1e-15)
    # the dropped row is in no level of the kernel's pack
    c = gs.sweeps.compact[0][0]
    live = np.concatenate([c['dst'][r0:r0 + k]
                           for r0, k in c['lvl'][:, [0, 3]]])
    assert sorted(gs.sweeps.l2g[live]) == [0, 2]


@pytest.mark.parametrize('budget', ['x global', 'split'])
def test_wavefront_layout_under_a_small_shared_memory(monkeypatch, budget):
    # with less shared memory the local x moves to a global scratch
    # vector, then levels are split into runs of rows: the kernel's
    # operands still compute the same sweeps
    rng = np.random.RandomState(6)
    A = _spd(120, rng, density=0.15)
    subset = rng.permutation(120)[:90]
    full = relax.DeviceIndexedGS(A, subset, sweep='symmetric', device='cpu')
    sw = full.sweeps
    small = sw.smem_bytes - 8 * sw.nloc
    if budget == 'split':
        small = small // 2
    monkeypatch.setattr(cuda_mg, 'WF_SMEM_BYTES', small)
    gs = relax.DeviceIndexedGS(A, subset, sweep='symmetric', iterations=2,
                               device='cpu')
    assert not gs.sweeps.xs_shared and gs.sweeps.smem_bytes <= small
    nlev = [c['nlev'] for c in gs.sweeps.compact[0]]
    assert (nlev > [c['nlev'] for c in sw.compact[0]]) == (budget == 'split')
    b, x0 = rng.rand(120), rng.rand(120)
    xd = gs.apply(x0.copy(), b)
    xk = _emulate_kernel(gs.sweeps, 0, 2, x0.copy(), b)
    assert np.abs(xk - xd).max() < 1e-13
    sw = gs.sweeps
    for c in sw.compact[0]:
        row0, s0, f0, k, Ws, L, T, F = c['lvl'].T
        Rp = (k + 3) // 4 * 4
        assert (row0 % 4 == 0).all() and (s0 % 4 == 0).all()
        assert (f0 % 4 == 0).all() and (Ws == 4 * L * T).all()
        assert (k * Ws <= sw.slot_entries).all()
        assert ((28 + 12 * F) * Rp <= sw.slot_chain).all()
        assert Rp.max() <= sw.slot_rows


@functools.lru_cache(maxsize=None)
def _bench_hierarchy(n0=24, L=3):
    """The local-MG bench's (n0, L) hierarchy (2D p=3, disparity 1,
    Dirichlet on all sides, refined toward (1, 1)): its Galerkin matrices
    and smoothing sets."""
    hs = hierarchical.HSpace(2 * (bspline.make_knots(3, 0.0, 1.0, n0),),
                             disparity=1,
                             bdspecs=[(0, 0), (0, 1), (1, 0), (1, 1)])
    for lv in range(L - 1):
        thr = 1.0 - 2.0 ** (-lv - 1)
        hs.refine_region(lv, lambda *X: min(X) > thr)
    A, _f = discretize(hs)
    As = solvers.galerkin_hierarchy(A, hs.virtual_hierarchy_prolongators())
    return As, hs.indices_to_smooth('cell_supp')


def _split_case(case, monkeypatch):
    """(A, indices, sweep) of a split-pack case and its DeviceIndexedGS:
    the (24, 3) sets by level and direction, a write-after-read matrix
    with zero diagonals, and the (24, 3) level-2 set laid out for less
    shared memory (the local x in global memory, then levels split)."""
    if case == 'war zero diagonal':
        rng = np.random.RandomState(5)
        A = _zero_diag(_nonsym(80, rng), [3, 11])
        S, sweep = rng.permutation(80)[:60], 'symmetric'
    else:
        As, lv_inds = _bench_hierarchy()
        lv = 2 if case in ('x global', 'split') else int(case[1])
        A, S = As[lv], np.asarray(lv_inds[lv])
        sweep = 'symmetric' if case in ('x global', 'split') \
            else case.split()[1]
    if case in ('x global', 'split'):
        full = relax.DeviceIndexedGS(A, S, sweep=sweep, device='cpu').sweeps
        small = full.smem_bytes - 8 * full.nloc
        if case == 'split':
            small = small * 3 // 4
        monkeypatch.setattr(cuda_mg, 'WF_SMEM_BYTES', small)
        gs = relax.DeviceIndexedGS(A, S, sweep=sweep, iterations=2,
                                   device='cpu')
        assert not gs.sweeps.xs_shared
        split = [c['nlev'] for c in gs.sweeps.compact[0]] > \
            [c['nlev'] for c in full.compact[0]]
        assert split == (case == 'split')
        return A, S, gs
    return A, S, relax.DeviceIndexedGS(A, S, sweep=sweep, iterations=2,
                                       device='cpu')


SPLIT_CASES = ['L%d %s' % (lv, sweep) for lv in (1, 2)
               for sweep in ('forward', 'backward', 'symmetric')] \
    + ['war zero diagonal', 'x global', 'split']


@pytest.mark.parametrize('case', SPLIT_CASES)
def test_split_pack_partitions_every_live_entry(case, monkeypatch):
    # each live entry of a row lands in exactly one of its level's fresh
    # and stale sets, and the fresh ones are exactly those whose column
    # the pass writes in the WF_FRESH levels before the row's
    A, S, gs = _split_case(case, monkeypatch)
    A = scipy.sparse.csr_matrix(A)
    sw = gs.sweeps
    g2l = {int(g): i for i, g in enumerate(sw.l2g)}
    D = cuda_mg.WF_FRESH
    for c in sw.compact[0]:
        written = {}
        for l, (row0, _s0, _f0, k, *_r) in enumerate(c['lvl']):
            for j in c['dst'][row0:row0 + k].tolist():
                assert j not in written         # a row once a pass
                written[j] = l
        nrows = 0
        for l, (row0, s0, f0, k, Ws, L, T, F) in enumerate(c['lvl']):
            Rp = (k + 3) // 4 * 4
            assert Ws == 4 * L * T and L in (1, 2, 4, 8, 16, 32)
            pv, pc = cuda_mg.stale_positions(k, L, T)
            # each stale slot of the level holds one entry (16-byte units
            # of a warp's lanes contiguous)
            assert np.array_equal(np.sort(pv.ravel()), np.arange(k * Ws))
            assert np.array_equal(np.sort(pc.ravel()), np.arange(k * Ws))
            for p in range(k):
                g = int(c['gid'][row0 + p])
                assert sw.l2g[c['dst'][row0 + p]] == g
                lo, hi = A.indptr[g], A.indptr[g + 1]
                live = sorted((g2l[int(j)], float(v)) for j, v in zip(
                    A.indices[lo:hi], A.data[lo:hi]) if j != g and v != 0)
                fe = f0 + np.arange(F) * Rp + p
                stale = [(int(j), float(v)) for j, v in
                         zip(c['scol'][s0 + pc[p]], c['sval'][s0 + pv[p]])
                         if v != 0]
                fresh = [(int(j), float(v)) for j, v in
                         zip(c['fcol'][fe], c['fval'][fe]) if v != 0]
                assert sorted(stale + fresh) == live
                for j, _v in stale:
                    assert not l - D <= written.get(j, -D - 1) < l
                for j, _v in fresh:
                    assert l - D <= written[j] < l
                # where the chain finds each fresh value: the lane of its
                # row in the level that wrote it, or the local x
                for j, code, val in zip(c['fcol'][fe], c['fsrc'][fe],
                                        c['fval'][fe]):
                    if val == 0:            # a pad: lane 0's last value
                        assert code == -1
                    elif code < 0:
                        a, q = (~code >> 5) + 1, ~code & 31
                        r0, kk = c['lvl'][l - a][[0, 3]]
                        assert q < kk and c['dst'][r0 + q] == j
                    else:
                        assert code == j
                assert c['diag'][row0 + p] == A[g, g] != 0
                assert c['rcp'][row0 + p] == 1.0 / A[g, g]
            nrows += k
        # every live row of the pass, once
        assert nrows == sum(1 for g in S if A[g, g] != 0)


@pytest.mark.parametrize('case', SPLIT_CASES)
def test_split_pack_emulation_matches_plain(case, monkeypatch):
    # the kernel's order of summation (stale partial by the lane split,
    # fresh entries, the reciprocal quotient) on its own operands
    # reproduces the plain version
    A, S, gs = _split_case(case, monkeypatch)
    rng = np.random.RandomState(7)
    n = A.shape[0]
    x0, b = rng.rand(n), rng.rand(n)
    ref = cuda_mg.wavefront_gs_plain(gs.sweeps, 0, 2,
                                     torch.as_tensor(x0.copy()),
                                     torch.as_tensor(b)).numpy()
    got = _emulate_kernel(gs.sweeps, 0, 2, x0.copy(), b)
    assert np.abs(got - ref).max() <= 1e-13 * np.abs(ref).max()
    assert not np.array_equal(ref, x0)
    # the same sums from the device layout the kernel reads
    assert np.array_equal(_emulate_blocks(gs.sweeps, 0, 2, x0.copy(), b),
                          got)


def test_wavefront_gs_argument_checks():
    rng = np.random.RandomState(3)
    A = _spd(30, rng)
    gs = relax.DeviceIndexedGS(A, np.arange(30), device='cpu')
    x, b = torch.zeros(30, dtype=torch.float64), torch.ones(30,
                                                              dtype=torch.float64)
    with pytest.raises(ValueError):
        cuda_mg.wavefront_gs(gs.sweeps, 0, 1, x[:29], b)
    with pytest.raises(ValueError):
        cuda_mg.wavefront_gs(gs.sweeps, 0, 1, x.float(), b)
    with pytest.raises(ValueError):
        cuda_mg.wavefront_gs(gs.sweeps, 1, 1, x, b)
    with pytest.raises(ValueError):
        cuda_mg.wavefront_gs(gs.sweeps, 0, -1, x, b)
    with pytest.raises(ValueError):
        relax.DeviceIndexedGS(A, np.arange(30), sweep='sideways',
                              device='cpu')
    y = cuda_mg.wavefront_gs(gs.sweeps, 0, 2, x.clone(), b)
    assert torch.equal(y, cuda_mg.wavefront_gs_plain(gs.sweeps, 0, 2,
                                                     x.clone(), b))


def _example(disparity=1, truncate=False):
    hs = example_hspace(hierarchical, bspline, p=3, n0=6,
                        disparity=disparity, truncate=truncate)
    A, f = discretize(hs)
    return hs, A, f


@pytest.mark.parametrize('impl', ['wavefront', 'tri'])
@pytest.mark.parametrize('smoother', ['gs', 'symmetric_gs'])
def test_device_mg_solver_routes_match_host_counts(impl, smoother):
    hs, A, f = _example()
    Ps = hs.virtual_hierarchy_prolongators()
    _uh, it_h = solvers.solve_hmultigrid(hs, A, f, tol=1e-8,
                                         smoother=smoother,
                                         relax_backend='host')
    s = mg.DeviceMGSolver(solvers.galerkin_hierarchy(A, Ps), Ps,
                          hs.indices_to_smooth('cell_supp'),
                          solvers._MG_SWEEPS[smoother], 2,
                          active_dofs=hs.non_dirichlet_dofs(),
                          smoother_impl=impl, device='cpu')
    assert s.smoother_impl == impl and s.ops.wave == (impl == 'wavefront')
    u, it = s.solve(f, tol=1e-8)
    assert it == it_h
    # one wavefront cycle is one step of the host V-cycle
    if impl == 'wavefront':
        x0 = np.random.RandomState(4).rand(A.shape[0])
        got = cuda_mg.vcycle(s.ops, torch.as_tensor(x0),
                             torch.as_tensor(f))[0].numpy()
        step = solvers.local_mg_step(hs, A, f, Ps,
                                     hs.indices_to_smooth('cell_supp'),
                                     smoother, 2, relax_backend='host')
        assert np.allclose(got, step(x0.copy()), rtol=1e-12, atol=1e-13)
        assert s.setup_ms.keys() == {'smoothers', 'coarse_inverse',
                                     'operands'}


def test_auto_picks_wavefront_above_tri_block_cutoff():
    hs, A, f = _example()
    Ps = hs.virtual_hierarchy_prolongators()
    As = solvers.galerkin_hierarchy(A, Ps)
    lv_inds = hs.indices_to_smooth('cell_supp')
    biggest = max(len(s) for s in lv_inds[1:])

    def solver(**kw):
        return mg.DeviceMGSolver(As, Ps, lv_inds, ('forward', 'backward'),
                                 2, active_dofs=hs.non_dirichlet_dofs(),
                                 dense_cutoff=A.shape[0] - 1, device='cpu',
                                 **kw)
    assert solver(tri_block_cutoff=biggest).smoother_impl == 'fused'
    s = solver(tri_block_cutoff=biggest - 1)
    assert s.smoother_impl == 'wavefront' and s.ops.wave
    assert s.solve(f)[1] == solvers.solve_hmultigrid(
        hs, A, f, relax_backend='host')[1]
    with pytest.raises(NotImplementedError, match='TPU'):
        solver(smoother_impl='df')
    with pytest.raises(ValueError):
        solver(smoother_impl='ozaki')


@pytest.mark.parametrize('smoother', ['gs', 'symmetric_gs', 'forward_gs'])
def test_local_mg_step_device_counts(smoother):
    hs, A, f = _example()
    Ps = hs.virtual_hierarchy_prolongators()
    lv_inds = hs.indices_to_smooth('cell_supp')
    active = hs.non_dirichlet_dofs()
    counts = {}
    for backend in ('host', 'device'):
        step = solvers.local_mg_step(hs, A, f, Ps, lv_inds, smoother, 2,
                                     relax_backend=backend, device='cpu')
        x, counts[backend] = solvers.iterative_solve(step, A, f,
                                                     active_dofs=active)
    step = jsolvers.local_mg_step(hs, A, f, Ps, lv_inds, smoother, 2,
                                  relax_backend='device')
    _x, jit = jsolvers.iterative_solve(step, A, f, active_dofs=active)
    assert counts['host'] == counts['device'] == jit


def test_local_mg_step_default_is_auto():
    params = inspect.signature(solvers.local_mg_step).parameters
    assert params['relax_backend'].default == 'auto'
    assert params['device'].default is None
    assert inspect.signature(jsolvers.local_mg_step).parameters[
        'relax_backend'].default == 'auto'
    # 'auto' on the CPU runs the host sweeps, as the reference's does on
    # a CPU backend: the same iterates as 'host', distinct from the device
    # smoother's only by rounding
    hs, A, f = _example()
    Ps = hs.virtual_hierarchy_prolongators()
    lv_inds = hs.indices_to_smooth('cell_supp')
    x0 = np.random.RandomState(2).rand(A.shape[0])
    auto = solvers.local_mg_step(hs, A, f, Ps, lv_inds, device='cpu')
    dev = solvers.local_mg_step(hs, A, f, Ps, lv_inds,
                                relax_backend='device', device='cpu')
    host = solvers.local_mg_step(hs, A, f, Ps, lv_inds, relax_backend='host')
    xa, xd, xh = auto(x0.copy()), dev(x0.copy()), host(x0.copy())
    assert np.array_equal(xa, xh)
    assert np.allclose(xa, xd, rtol=1e-12, atol=1e-13)


def test_local_mg_step_auto_on_cpu_builds_no_device_smoother(monkeypatch):
    hs, A, f = _example()
    Ps = hs.virtual_hierarchy_prolongators()
    lv_inds = hs.indices_to_smooth('cell_supp')
    built = []
    real = solvers.DeviceIndexedGS

    def spy(*args, **kw):
        built.append(kw.get('device'))
        return real(*args, **kw)
    monkeypatch.setattr(solvers, 'DeviceIndexedGS', spy)
    active = hs.non_dirichlet_dofs()
    step = solvers.local_mg_step(hs, A, f, Ps, lv_inds, 'gs', 2,
                                 relax_backend='host')
    _x, it_host = solvers.iterative_solve(step, A, f, active_dofs=active)
    for device in ('cpu', torch.device('cpu')):
        step = solvers.local_mg_step(hs, A, f, Ps, lv_inds, 'gs', 2,
                                     device=device)
        _x, it = solvers.iterative_solve(step, A, f, active_dofs=active)
        assert it == it_host
    assert built == []
    solvers.local_mg_step(hs, A, f, Ps, lv_inds, 'gs', 2,
                          relax_backend='device', device='cpu')
    assert built and set(built) == {'cpu'}


@pytest.mark.parametrize('strategy, counts', zip(
    ('new', 'trunc', 'func_supp', 'cell_supp'), REFERENCE_COUNTS[np.inf]))
def test_reference_table_through_device_smoother(strategy, counts):
    # the reference's (HB, THB) table with the wavefront smoother
    got = []
    for truncate in (False, True):
        hs, A, f = _example(disparity=np.inf, truncate=truncate)
        dir_dofs = hs.dirichlet_dofs()
        LS = assemble.RestrictedLinearSystem(
            A, f, (dir_dofs, np.zeros_like(dir_dofs)))
        u0 = LS.complete(scipy.sparse.linalg.spsolve(LS.A.tocsc(), LS.b))
        step = solvers.local_mg_step(
            hs, A, f, hs.virtual_hierarchy_prolongators(),
            hs.indices_to_smooth(strategy), 'symmetric_gs', 1,
            relax_backend='device', device='cpu')
        got.append(num_iterations(step, u0))
    assert tuple(got) == counts


def test_device_mg_cache_keys_on_route():
    hs, A, f = _example()
    solvers._DEVICE_MG_CACHE.clear()
    s = solvers._device_mg_solver(hs, A, 'cell_supp', 'gs', 2, 'cpu')
    assert solvers._device_mg_solver(hs, A, 'cell_supp', 'gs', 2,
                                     'cpu') is s
    (key,) = solvers._DEVICE_MG_CACHE
    assert key[-1] == s.smoother_impl == 'fused'
    # a copy of the matrix hits by content
    assert solvers._device_mg_solver(hs, A.copy(), 'cell_supp', 'gs', 2,
                                     'cpu') is s
    solvers._DEVICE_MG_CACHE.clear()
