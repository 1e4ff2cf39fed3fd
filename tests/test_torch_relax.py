"""The order-exact wavefront Gauss-Seidel smoother of the PyTorch port
(``ops/relax.py``, the wavefront packs of ``ops/cuda_mg.py``) and the
local-MG routes built on it, held against the JAX package on the CPU:
identical schedules and packs, sweeps to 1e-13 against the JAX
``DeviceIndexedGS`` and the host ``gauss_seidel``, identical iteration
counts against the host path."""

import inspect

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


def _emulate_kernel(sweeps, group, iterations, x, b):
    """The arithmetic of ``csrc/mg.cu`` ``wavefront_smooth`` on the
    kernel's own operands (``sweeps.compact``, the local numbering), in
    numpy: a level's rows read the local x, then write it."""
    xs = x[sweeps.l2g].copy()
    for _ in range(iterations):
        for c in sweeps.compact[group]:
            for row0, ent, width, nrows in c['lvl']:
                r = np.arange(row0, row0 + nrows)
                e = ent + (r - row0)[:, None] * width + np.arange(width)
                z = (c['val'][e] * xs[c['col'][e]]).sum(axis=1)
                xs[c['dst'][r]] = (b[c['gid'][r]] - z) / c['diag'][r]
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
    live = np.concatenate([c['dst'][r0:r0 + k] for r0, _, _, k in c['lvl']])
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
    for c in gs.sweeps.compact[0]:
        rows, ents, width = c['lvl'][:, 3], c['lvl'][:, 1], c['lvl'][:, 2]
        assert (c['lvl'][:, 0] % 4 == 0).all() and (ents % 4 == 0).all()
        assert (width % 4 == 0).all()
        assert (rows * width <= gs.sweeps.slot_entries).all()
        assert rows.max() <= gs.sweeps.slot_rows


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
    # 'auto' runs the device smoother on the given device: the same
    # iterates as 'device', distinct from the host sweeps only by rounding
    hs, A, f = _example()
    Ps = hs.virtual_hierarchy_prolongators()
    lv_inds = hs.indices_to_smooth('cell_supp')
    x0 = np.random.RandomState(2).rand(A.shape[0])
    auto = solvers.local_mg_step(hs, A, f, Ps, lv_inds, device='cpu')
    dev = solvers.local_mg_step(hs, A, f, Ps, lv_inds,
                                relax_backend='device', device='cpu')
    host = solvers.local_mg_step(hs, A, f, Ps, lv_inds, relax_backend='host')
    xa, xd, xh = auto(x0.copy()), dev(x0.copy()), host(x0.copy())
    assert np.array_equal(xa, xd)
    assert np.allclose(xa, xh, rtol=1e-12, atol=1e-13)


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
