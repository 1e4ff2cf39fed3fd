"""The local-multigrid solve of the PyTorch port held against the JAX
package on the CPU: the host Gauss-Seidel sweeps, the host V-cycle
(``local_mg_step`` + ``iterative_solve``), and the device solver
``DeviceMGSolver`` through K6's wrapper (its plain version on CPU
tensors).  Iteration counts are a contract and must be identical;
solutions agree to 1e-10."""

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
        hs, vform.stiffness_vf(dim=2), {'geo': geometry.unit_square(), 'f': f})
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
                                         'symmetric_gs', 1)
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
                                         relax_backend='device')
    assert it_h == jit and it_d == jit
    assert np.allclose(u_h, ju, rtol=1e-10, atol=1e-12)
    assert np.allclose(u_d, ju, rtol=1e-10, atol=1e-12)
    # 'auto' on the CPU is the host path; a repeat reuses the cached solver
    assert solvers.solve_hmultigrid(hs, A, f)[1] == jit
    u_d2, it_d2 = solvers.solve_hmultigrid(hs, A, f, relax_backend='device')
    assert it_d2 == it_d and np.array_equal(u_d2, u_d)


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
                                     smoother_impl=impl)
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
                          active_dofs=hs.non_dirichlet_dofs())
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
    step = solvers.local_mg_step(hs, A, f, Ps, lv_inds, 'symmetric_gs', 2)
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
    # above dense_cutoff 'auto' names the smoothers still to port
    with pytest.raises(NotImplementedError, match='tri'):
        mg.DeviceMGSolver(As, Ps, lv_inds, ('forward', 'backward'), 2,
                          dense_cutoff=A.shape[0] - 1)
    for impl in ('tri', 'wavefront', 'df'):
        with pytest.raises(NotImplementedError):
            mg.DeviceMGSolver(As, Ps, lv_inds, ('forward', 'backward'), 2,
                              smoother_impl=impl)
    with pytest.raises(NotImplementedError):
        solvers.local_mg_step(hs, A, f, Ps, lv_inds, 'gs', 2,
                              relax_backend='device')
    # the explicit 'fused' has no size gate; a single level is the coarse
    # solve alone
    u, it = mg.DeviceMGSolver(As, Ps, lv_inds, ('forward', 'backward'), 2,
                              active_dofs=hs.non_dirichlet_dofs(),
                              smoother_impl='fused',
                              dense_cutoff=10).solve(f)
    assert it == solvers.solve_hmultigrid(hs, A, f, relax_backend='host')[1]
    one = mg.DeviceMGSolver(As[:1], [], lv_inds[:1], ('forward', 'backward'),
                            2, active_dofs=lv_inds[0])
    x1, it1 = one.solve(np.random.RandomState(5).rand(As[0].shape[0]))
    assert it1 == 1 and np.isfinite(x1).all()
