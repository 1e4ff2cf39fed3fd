"""The local-multigrid solve of the PyTorch port held against the JAX
package on the CPU: the host Gauss-Seidel sweeps, the host V-cycle
(``local_mg_step`` + ``iterative_solve``), and the device solver
``DeviceMGSolver`` through K6's wrapper (its plain version on CPU
tensors).  Iteration counts are a contract and must be identical;
solutions agree to 1e-10."""

import math

import numpy as np
import pytest
import scipy.linalg
import scipy.sparse
import scipy.sparse.linalg
import torch

import pyiga_tpu.bspline as jbspline
import pyiga_tpu.geometry as jgeometry
import pyiga_tpu.hierarchical as jhier
import pyiga_tpu.native as jnative
import pyiga_tpu.solvers as jsolvers
import pyiga_tpu.vform as jvform
from pyiga_tpu.ops.mg import DeviceMGSolver as JDeviceMGSolver

from pyiga_tpu_torch import (_cuda, assemble, bspline, convert, geometry,
                             hierarchical, native, solvers, vform)
from pyiga_tpu_torch.ops import cuda_mg, mg

from test_torch_hierarchical import example_hspace

torch.set_num_threads(1)


def discretize(hs, f=lambda *x: 1.0):
    hd = hierarchical.HDiscretization(
        hs, vform.stiffness_vf(dim=2), {'geo': geometry.unit_square(), 'f': f},
        device='cpu')
    return hd.assemble_matrix().tocsr(), hd.assemble_rhs()


def test_native_sweeps_match_jax():
    rng = np.random.RandomState(0)
    A = (scipy.sparse.random(40, 40, 0.2, format='csr', random_state=rng)
         + scipy.sparse.diags(rng.rand(40) + 2.0)).tocsr()
    A[5, 5] = 0.0                         # a zero diagonal row is skipped
    b = rng.rand(40)
    rows = rng.permutation(40)[:25]
    for reverse in (False, True):
        x0 = rng.rand(40)
        x, jx = x0.copy(), x0.copy()
        native.gauss_seidel_sweep(A, x, b, reverse=reverse)
        jnative.gauss_seidel_sweep(A, jx, b, reverse=reverse)
        assert np.array_equal(x, jx)
        x, jx = x0.copy(), x0.copy()
        native.gauss_seidel_sweep_indexed(A, x, b, rows, reverse=reverse)
        jnative.gauss_seidel_sweep_indexed(A, jx, b, rows, reverse=reverse)
        assert np.array_equal(x, jx)
        # the numpy loops visit the rows in the same order
        y = x0.copy()
        native._sweep_rows_numpy(*native._csr_arrays(A), y, b,
                                 rows[::-1] if reverse else rows)
        assert np.allclose(x, y, rtol=1e-14, atol=1e-14)
    for sweep in ('forward', 'backward', 'symmetric'):
        for M in (A, A.toarray()):
            x0 = rng.rand(40)
            x, jx = x0.copy(), x0.copy()
            solvers.gauss_seidel(M, x, b, iterations=2, indices=rows,
                                 sweep=sweep)
            jsolvers.gauss_seidel(M, jx, b, iterations=2, indices=rows,
                                  sweep=sweep)
            assert np.allclose(x, jx, rtol=1e-14, atol=1e-14)


def test_make_solver():
    rng = np.random.RandomState(1)
    B = rng.rand(6, 6) + 6 * np.eye(6)
    r = rng.rand(6)
    for M in (B, scipy.sparse.csr_matrix(B)):
        assert np.allclose(solvers.make_solver(M) @ r, np.linalg.solve(B, r),
                           rtol=1e-12)


def num_iterations(step, sol, tol=1e-8):
    x = np.zeros_like(sol)
    for it in range(1, 20000):
        x = step(x)
        if scipy.linalg.norm(x - sol) < tol:
            return it
    return np.inf


# the reference's integers (tests/test_localmg.py::test_localmg): per
# strategy 'new', 'trunc', 'func_supp', 'cell_supp' the (HB, THB) counts
# of symmetric GS with one step
REFERENCE_COUNTS = {
    np.inf: [(107, 118), (49, 19), (49, 15), (41, 15)],
    1: [(105, 104), (59, 23), (59, 23), (61, 22)],
}


@pytest.mark.parametrize('disparity', [np.inf, 1])
def test_local_mg_step_exact_counts(disparity):
    hs = example_hspace(hierarchical, bspline, p=3, n0=6, disparity=disparity)
    dir_dofs = hs.dirichlet_dofs()
    iters = {s: [] for s in ('new', 'trunc', 'func_supp', 'cell_supp')}
    for truncate in (False, True):
        hs.truncate = truncate
        A, f = discretize(hs)
        LS = assemble.RestrictedLinearSystem(
            A, f, (dir_dofs, np.zeros_like(dir_dofs)))
        u0 = LS.complete(scipy.sparse.linalg.spsolve(LS.A.tocsc(), LS.b))
        Ps = hs.virtual_hierarchy_prolongators()
        for strategy, counts in iters.items():
            step = solvers.local_mg_step(hs, A, f, Ps,
                                         hs.indices_to_smooth(strategy),
                                         'symmetric_gs', 1,
                                         relax_backend='host')
            counts.append(num_iterations(step, u0))
    assert [tuple(c) for c in iters.values()] == REFERENCE_COUNTS[disparity]


@pytest.mark.parametrize('truncate', [False, True])
def test_solve_hmultigrid_matches_jax(truncate):
    kw = dict(p=3, n0=6, disparity=1, truncate=truncate)
    hs = example_hspace(hierarchical, bspline, **kw)
    jhs = example_hspace(jhier, jbspline, **kw)
    A, f = discretize(hs)
    ju, jit = jsolvers.solve_hmultigrid(jhs, A, f, tol=1e-8,
                                        relax_backend='host')
    u_h, it_h = solvers.solve_hmultigrid(hs, A, f, tol=1e-8,
                                         relax_backend='host')
    u_d, it_d = solvers.solve_hmultigrid(hs, A, f, tol=1e-8,
                                         relax_backend='device',
                                         device='cpu')
    assert it_h == jit and it_d == jit
    assert np.allclose(u_h, ju, rtol=1e-10, atol=1e-12)
    assert np.allclose(u_d, ju, rtol=1e-10, atol=1e-12)
    # 'auto' on the CPU is the host path; a repeat reuses the cached solver
    assert solvers.solve_hmultigrid(hs, A, f, device='cpu')[1] == jit
    u_d2, it_d2 = solvers.solve_hmultigrid(hs, A, f, relax_backend='device',
                                           device='cpu')
    assert it_d2 == it_d and np.array_equal(u_d2, u_d)


def bench_hspace(hmod, bmod, n0, num_levels=3):
    """The bench's local-MG hierarchy (``bench.py`` ``run_localmg``) for
    either package."""
    hs = hmod.HSpace(2 * (bmod.make_knots(3, 0.0, 1.0, n0),), disparity=1,
                     bdspecs=[(0, 0), (0, 1), (1, 0), (1, 1)])
    for lv in range(num_levels - 1):
        hs.refine_region(lv, lambda *X: min(X) > 1.0 - 2.0 ** (-lv - 1))
    return hs


def test_auto_device_solver_above_dense_cutoff_matches_jax():
    # 'auto' above dense_cutoff runs K6 (its plain cycle on the CPU) with
    # the count of the host path and of the JAX package: 29 at (24, 3)
    hs, jhs = bench_hspace(hierarchical, bspline, 24), \
        bench_hspace(jhier, jbspline, 24)
    A, f = discretize(hs)
    _ju, jit = jsolvers.solve_hmultigrid(jhs, A, f, tol=1e-8,
                                         relax_backend='host')
    _uh, it_h = solvers.solve_hmultigrid(hs, A, f, tol=1e-8,
                                         relax_backend='host')
    _ud, it_d = solvers.solve_hmultigrid(hs, A, f, tol=1e-8,
                                         relax_backend='device', device='cpu')
    Ps = hs.virtual_hierarchy_prolongators()
    s = mg.DeviceMGSolver(solvers.galerkin_hierarchy(A, Ps), Ps,
                          hs.indices_to_smooth('cell_supp'),
                          solvers._MG_SWEEPS['gs'], 2,
                          active_dofs=hs.non_dirichlet_dofs(),
                          smoother_impl='auto', dense_cutoff=1000,
                          device='cpu')
    assert A.shape[0] > 1000 and s.smoother_impl == 'fused'
    _us, it_s = s.solve(f, tol=1e-8)
    assert jit == it_h == it_d == it_s == 29


def test_plain_cycle_matches_jax_fused_interpret():
    # the setup of tests/test_localmg.py::test_device_mg_fused_kernel_
    # interpret: p=2, n0=4, two levels; JAX runs its Pallas V-cycle in
    # interpret mode
    jhs = jhier.HSpace(2 * (jbspline.make_knots(2, 0.0, 1.0, 4),),
                       disparity=1, bdspecs=[(0, 0), (0, 1), (1, 0), (1, 1)])
    jhs.refine_region(0, lambda *X: min(X) > 0.5)
    jhs.refine_region(1, lambda *X: min(X) > 0.75)
    jhd = jhier.HDiscretization(jhs, jvform.stiffness_vf(dim=2),
                                {'geo': jgeometry.unit_square(),
                                 'f': lambda *x: 1.0})
    A = jhd.assemble_matrix().tocsr()
    f = jhd.assemble_rhs()
    Ps = jhs.virtual_hierarchy_prolongators()
    lv_inds = jhs.indices_to_smooth('cell_supp')
    As = solvers.galerkin_hierarchy(A, Ps)
    args = (As, Ps, lv_inds, ('forward', 'backward'), 2)
    ju, jit = JDeviceMGSolver(*args, active_dofs=jhs.non_dirichlet_dofs(),
                              smoother_impl='fused').solve(f, tol=1e-8)
    for impl in ('fused', 'dense'):
        s = convert.device_mg_solver(*args,
                                     active_dofs=jhs.non_dirichlet_dofs(),
                                     smoother_impl=impl, device='cpu')
        u, it = s.solve(f, tol=1e-8)
        assert it == jit, impl
        assert np.allclose(u, ju, rtol=1e-10, atol=1e-12), impl


def test_vcycle_wrapper_on_cpu_is_the_plain_version():
    hs = example_hspace(hierarchical, bspline, p=3, n0=6, disparity=1)
    A, f = discretize(hs)
    Ps = hs.virtual_hierarchy_prolongators()
    lv_inds = hs.indices_to_smooth('cell_supp')
    s = mg.DeviceMGSolver(solvers.galerkin_hierarchy(A, Ps), Ps, lv_inds,
                          solvers._MG_SWEEPS['symmetric_gs'], 2,
                          active_dofs=hs.non_dirichlet_dofs(), device='cpu')
    assert s.smoother_impl == 'fused' and s.ops.desc is None
    assert (s.ops.npre, s.ops.npost) == (2, 2)
    rng = np.random.RandomState(4)
    x0 = rng.rand(A.shape[0])
    x = torch.as_tensor(x0, dtype=torch.float64)
    ft = torch.as_tensor(f, dtype=torch.float64)
    before = dict(_cuda.LAUNCHES)
    got, ref = cuda_mg.vcycle(s.ops, x, ft), cuda_mg.vcycle_plain(s.ops, x, ft)
    assert _cuda.LAUNCHES == before
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert torch.equal(x, torch.as_tensor(x0))      # the input is kept
    # one cycle is one step of the host V-cycle, and res2 its residual
    step = solvers.local_mg_step(hs, A, f, Ps, lv_inds, 'symmetric_gs', 2,
                                 relax_backend='host')
    xh = step(x0.copy())
    assert np.allclose(got[0].numpy(), xh, rtol=1e-12, atol=1e-13)
    r = (f - A @ xh)[hs.non_dirichlet_dofs()]
    assert np.isclose(float(got[1]), r @ r, rtol=1e-10)


def test_device_solver_options():
    hs = example_hspace(hierarchical, bspline, p=2, n0=4, disparity=1,
                        num_levels=2)
    A, f = discretize(hs)
    Ps = hs.virtual_hierarchy_prolongators()
    As = solvers.galerkin_hierarchy(A, Ps)
    lv_inds = hs.indices_to_smooth('cell_supp')
    # above dense_cutoff 'auto' takes K6 while the smoothing sets fit
    # tri_block_cutoff, with the host path's count ...
    s = mg.DeviceMGSolver(As, Ps, lv_inds, ('forward', 'backward'), 2,
                          active_dofs=hs.non_dirichlet_dofs(),
                          dense_cutoff=A.shape[0] - 1, device='cpu')
    assert s.smoother_impl == 'fused'
    assert s.solve(f)[1] == solvers.solve_hmultigrid(
        hs, A, f, relax_backend='host')[1]
    # ... and past it takes the wavefront smoother, with the same count
    s = mg.DeviceMGSolver(As, Ps, lv_inds, ('forward', 'backward'), 2,
                          active_dofs=hs.non_dirichlet_dofs(),
                          dense_cutoff=A.shape[0] - 1, tri_block_cutoff=1,
                          device='cpu')
    assert s.smoother_impl == 'wavefront'
    assert s.solve(f)[1] == solvers.solve_hmultigrid(
        hs, A, f, relax_backend='host')[1]
    # 'tri' is K6's dense route; the two-float 'df' is the TPU's alone
    for impl in ('tri', 'wavefront'):
        assert mg.DeviceMGSolver(As, Ps, lv_inds, ('forward', 'backward'),
                                 2, smoother_impl=impl,
                                 device='cpu').smoother_impl == impl
    with pytest.raises(NotImplementedError):
        mg.DeviceMGSolver(As, Ps, lv_inds, ('forward', 'backward'), 2,
                          smoother_impl='df', device='cpu')
    step = solvers.local_mg_step(hs, A, f, Ps, lv_inds, 'gs', 2,
                                 relax_backend='device', device='cpu')
    assert solvers.iterative_solve(
        step, A, f, active_dofs=hs.non_dirichlet_dofs())[1] == \
        solvers.solve_hmultigrid(hs, A, f, relax_backend='host')[1]
    # the explicit 'fused' has no size gate; a single level is the coarse
    # solve alone
    u, it = mg.DeviceMGSolver(As, Ps, lv_inds, ('forward', 'backward'), 2,
                              active_dofs=hs.non_dirichlet_dofs(),
                              smoother_impl='fused',
                              dense_cutoff=10, device='cpu').solve(f)
    assert it == solvers.solve_hmultigrid(hs, A, f, relax_backend='host')[1]
    one = mg.DeviceMGSolver(As[:1], [], lv_inds[:1], ('forward', 'backward'),
                            2, active_dofs=lv_inds[0], device='cpu')
    x1, it1 = one.solve(np.random.RandomState(5).rand(As[0].shape[0]))
    assert it1 == 1 and np.isfinite(x1).all()


def _gs_solver(hs, A):
    Ps = hs.virtual_hierarchy_prolongators()
    return mg.DeviceMGSolver(solvers.galerkin_hierarchy(A, Ps), Ps,
                             hs.indices_to_smooth('cell_supp'),
                             solvers._MG_SWEEPS['gs'], 2,
                             active_dofs=hs.non_dirichlet_dofs(),
                             smoother_impl='fused', device='cpu')


@pytest.mark.parametrize('n0', [6, 24])
def test_row_extents_cover_every_nonzero(n0):
    # K6 reads each row of a triangular inverse over [lo, hi) only: the
    # extents must hold every nonzero, for the forward (pre) and backward
    # (post) sweeps, on the n0=6 and the bench's (24, 3) hierarchies
    hs = bench_hspace(hierarchical, bspline, n0)
    s = _gs_solver(hs, discretize(hs)[0])
    for lev in s.ops.levels[1:]:
        S = lev['S'].numpy()
        for key, tri in (('pre', np.tril), ('post', np.triu)):
            T, = lev[key]
            vals = T.vals.numpy()
            assert np.array_equal(T.mat.numpy(), tri(T.mat.numpy()))
            rows = T.rows.numpy()
            assert sorted(rows[:, 0]) == list(range(T.m))
            assert np.array_equal(rows[:, 3], S[rows[:, 0]])
            lengths = rows[:, 2] - rows[:, 1]
            assert (np.diff(lengths) <= 0).all()       # longest first
            assert (rows[:, 1] % 4 == 0).all() and (rows[:, 2] % 4 == 0).all()
            assert (rows[:, 1] <= rows[:, 2]).all() and \
                (rows[:, 2] <= T.ld).all()
            col = np.arange(T.ld)
            for i, lo, hi, _ in rows:
                assert not vals[i][(col < lo) | (col >= hi)].any()
            # the triangle's half of the dense bytes
            assert T.entries <= T.m * (T.m + 1) // 2 < T.m * T.m
    assert (s.ops.Cinv.rows.numpy()[:, 1:3] == [0, s.ops.Cinv.ld]).all()


def test_row_extents_dead_row():
    # a zero diagonal makes a dead row of the sweep: its row of T is zero
    # and its extent empty; the other rows keep theirs
    rng = np.random.RandomState(2)
    A = rng.rand(9, 9) + 9 * np.eye(9)
    A[4, 4] = 0.0
    for rev in (False, True):
        T = mg._tri_inverse(A, reverse=rev)
        dr = cuda_mg.DenseRows(T, np.arange(9), torch.device('cpu'))
        ext, entries = cuda_mg.row_extents(dr.vals.numpy())
        assert not T[4].any() and tuple(ext[4]) == (0, 0)
        live = [i for i in range(9) if i != 4]
        assert (ext[live, 1] > ext[live, 0]).all()
        assert entries == sum(np.ptp(np.flatnonzero(T[i])) + 1 for i in live)
        assert dr.rows.numpy()[-1, 0] == 4          # taken last


def test_plain_solve_loop_matches_jax_counts():
    # the plain version of the one-launch solve (the host loop over the
    # plain cycle) gives the JAX package's count: 47 at n0=6, 3 levels
    hs, jhs = bench_hspace(hierarchical, bspline, 6), \
        bench_hspace(jhier, jbspline, 6)
    A, f = discretize(hs)
    _ju, jit = jsolvers.solve_hmultigrid(jhs, A, f, tol=1e-8,
                                         relax_backend='host')
    s = _gs_solver(hs, A)
    ft = torch.as_tensor(f, dtype=torch.float64)
    res0 = np.float64(torch.linalg.vector_norm(ft * s.ops.mask).item())
    x, it, res, hist = cuda_mg.vcycle_solve(s.ops, ft, res0, 1e-8, 5000)
    assert it == jit == 47 and res / res0 < 1e-8 <= \
        math.sqrt(hist[-2].item()) / res0
    assert hist.shape == (47,) and np.isclose(hist[-1].item(), res ** 2)
    xh, ith = solvers.solve_hmultigrid(hs, A, f, tol=1e-8,
                                       relax_backend='host')
    assert ith == 47 and np.allclose(x.numpy(), xh, rtol=1e-10, atol=1e-13)


def test_solve_loop_maxiter_and_zero_tol():
    hs = bench_hspace(hierarchical, bspline, 6)
    A, f = discretize(hs)
    s = _gs_solver(hs, A)
    # maxiter runs out before tol: inf, as iterative_solve
    x5, it5 = s.solve(f, tol=1e-8, maxiter=5)
    assert it5 == np.inf and np.isfinite(x5).all()
    # tol = 0 is never reached: exactly maxiter cycles
    ft = torch.as_tensor(f, dtype=torch.float64)
    res0 = np.float64(torch.linalg.vector_norm(ft * s.ops.mask).item())
    x, it, res, hist = cuda_mg.vcycle_solve(s.ops, ft, res0, 0.0, 7)
    assert it == 7 and hist.shape == (7,)
    x7, it7 = s.solve(f, tol=0.0, maxiter=7)
    assert it7 == np.inf and np.array_equal(x7, x.numpy())
    # the first five cycles are those of the maxiter=5 run
    assert np.array_equal(cuda_mg.vcycle_solve(s.ops, ft, res0, 0.0, 5)[0]
                          .numpy(), x5)
    # maxiter = 0 runs no cycle: x stays zero and res is res0
    x0, it0, r0, h0 = cuda_mg.vcycle_solve(s.ops, ft, res0, 1e-8, 0)
    assert it0 == 0 and r0 == res0 and not x0.any() and h0.numel() == 0


def test_device_solver_cache_sees_in_place_changes():
    # the same matrix object again reuses the solver (its arrays compared
    # with the entry's copies), an equal copy too (by digest), and a
    # matrix changed in place gets a new one
    hs = bench_hspace(hierarchical, bspline, 6)
    A, f = discretize(hs)
    A = scipy.sparse.csr_matrix(A)
    cpu = torch.device('cpu')

    def lookup(M):
        return solvers._device_mg_solver(hs, M, 'cell_supp', 'gs', 2, cpu)
    s1 = lookup(A)
    assert lookup(A) is s1 and lookup(A.copy()) is s1
    x1, it1 = solvers.solve_hmultigrid(hs, A, f, relax_backend='device',
                                       device='cpu')
    A.data *= 2.0
    assert lookup(A) is not s1
    x2, it2 = solvers.solve_hmultigrid(hs, A, f, relax_backend='device',
                                       device='cpu')
    # Gauss-Seidel is scale invariant: the same count, half the solution
    assert it2 == it1 == 47 and np.allclose(2 * x2, x1, rtol=1e-12,
                                            atol=1e-15)
