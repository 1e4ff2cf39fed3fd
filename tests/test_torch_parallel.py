"""The multi-device layer of the PyTorch port (``pyiga_tpu_torch.parallel``
and ``__graft_entry__.dryrun_multichip``) against the JAX package: every
case of ``tests/test_parallel.py`` and ``tests/test_diff.py::
test_grad_composes_with_sharding``, with JAX's tolerances.

The ranks are processes on the CPU over gloo: one pool of 4 and one of 8
ranks a module (:class:`pyiga_tpu_torch.parallel._launch.RankPool`), each
check a test of its own.  What the ranks run is in
``tests/torch_parallel_ranks.py``; the JAX side runs here, on the
conftest's 8 virtual CPU devices.  Also: the halo exchange on uneven and
empty slabs, ``make_mesh`` refusing to under-provision, the flagship's
slab relayout, and the JAX package's host cutoffs routing nothing here."""

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import jax
import jax.numpy as jnp

from pyiga_tpu import geometry as jgeometry
from pyiga_tpu.assemblers import (MassAssembler as JMass,
                                  StiffnessAssembler as JStiff)
from pyiga_tpu.bspline import make_knots as jmake_knots

import torch_parallel_ranks as ranks
from pyiga_tpu_torch import config
from pyiga_tpu_torch.parallel._launch import RankPool

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def pools():
    """Rank pools by world size, started on first use, ended with the
    module."""
    started = {}

    def get(n):
        if n not in started:
            started[n] = RankPool(n, device='cpu', threads=1, timeout=300)
        return started[n]
    yield get
    for pool in started.values():
        pool.close()


def _rel(a, b):
    a = a.toarray() if hasattr(a, 'toarray') else np.asarray(a)
    b = b.toarray() if hasattr(b, 'toarray') else np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _same_on_every_rank(results):
    first = results[0]
    for r in results[1:]:
        for a, b in zip(r, first):
            if isinstance(a, np.ndarray):
                assert np.array_equal(a, b)
    return first


################################################################################
# tests/test_parallel.py
################################################################################

@pytest.mark.parametrize('ndev', [4, 8])
def test_sharded_assembly_and_cg(pools, ndev):
    data, X = _same_on_every_rank(pools(ndev).run(ranks.dryrun, ndev, 2, 4,
                                                  2, 4))
    assert np.all(np.isfinite(data)) and np.all(np.isfinite(X))
    kvs = 2 * (jmake_knots(2, 0.0, 1.0, 4),)
    ref = JStiff(kvs, jgeometry.quarter_annulus()).assemble().data
    assert np.abs(data - ref).max() < 1e-12


@pytest.mark.slow
def test_sharded_3d_flagship_weak_scaling(pools):
    data, X = _same_on_every_rank(pools(8).run(ranks.dryrun, 8, 3, 4, 3, 4))
    assert np.all(np.isfinite(data)) and np.all(np.isfinite(X))
    kvs = 3 * (jmake_knots(3, 0.0, 1.0, 4),)
    ref = JStiff(kvs, jgeometry.twisted_box()).assemble().data
    assert np.abs(data - ref).max() / np.abs(ref).max() < 1e-12


def test_make_mesh_hard_fails_when_underprovisioned(pools):
    msgs = pools(4).run(ranks.make_mesh_raises, 1000)
    assert all(m is not None and 'requested 1000 ranks but only 4' in m
               and 'nproc-per-node=1000' in m for m in msgs)
    # no process group here: a mesh of more than one rank is refused
    from pyiga_tpu_torch.parallel import make_mesh
    with pytest.raises(RuntimeError, match='no process group'):
        make_mesh(n_devices=2, device='cpu')


def test_sharded_step_cg_correctness(pools):
    # the mass matrix: SPD and well conditioned, so fixed-iteration
    # unpreconditioned CG converges (the Neumann stiffness is singular);
    # 7 dof rows on 4 'space' ranks
    data, X, B, sizes = _same_on_every_rank(pools(8).run(
        ranks.stiffness_step, 'mass', 5, (4, 2), 60, 2))
    assert sizes == (4, 2, 1)           # axis_size: JAX's mesh.shape[name]
    kvs = 2 * (jmake_knots(2, 0.0, 1.0, 5),)
    A = JMass(kvs, jgeometry.quarter_annulus()).assemble().asmatrix()
    for k in range(B.shape[0]):
        r = np.linalg.norm(A @ X[k] - B[k]) / np.linalg.norm(B[k])
        assert r < 1e-6


def test_sharded_multi_rhs_axis(pools):
    """Batched right-hand sides over a 'rhs' mesh axis each converge to
    the solution of an unbatched solve."""
    data, X, B, sizes = _same_on_every_rank(pools(8).run(
        ranks.stiffness_step, 'mass', 5, (2, 4), 60, 4))
    assert sizes == (2, 4, 1)
    kvs = 2 * (jmake_knots(2, 0.0, 1.0, 5),)
    A = JMass(kvs, jgeometry.quarter_annulus()).assemble().asmatrix()
    for k in range(4):
        x_ref = spla.spsolve(A.tocsc(), B[k])
        assert np.abs(X[k] - x_ref).max() < 1e-6


def _jax_matfree(b, tol, maxiter, mass_shift=None):
    from pyiga_tpu.ops.fastdiag import fastdiag_precond
    from pyiga_tpu.parallel import make_mesh, sharded_matfree_cg
    kvs = 3 * (jmake_knots(2, 0.0, 1.0, 5),)
    asm = JMass(kvs, jgeometry.twisted_box())
    mesh = make_mesh(8, axis_names=('space',))
    pc = (None if mass_shift is None
          else fastdiag_precond(kvs, mass_shift=mass_shift))
    solve, ops_ = sharded_matfree_cg(asm, mesh, precond=pc, tol=tol,
                                     maxiter=maxiter)
    with mesh:
        x, it = jax.jit(solve)(jax.tree_util.tree_map(
            lambda a: a if a is None else jnp.asarray(a), ops_),
            jnp.asarray(b))
    return np.asarray(x), int(it), asm.assemble().asmatrix()


def test_sharded_matfree_cg(pools):
    # JAX's case: 7 dof rows on 8 ranks (one slab is empty), no
    # preconditioner
    x, it, b = _same_on_every_rank(pools(8).run(ranks.matfree_cg, 8, 1e-10,
                                                300, False))
    _jx, _jit, M = _jax_matfree(b, 1e-10, 300)
    r = np.linalg.norm(M @ x - b) / np.linalg.norm(b)
    assert r < 1e-8
    assert it < 300


def test_sharded_matfree_cg_count_equals_jax(pools):
    """The iteration count of the same solve preconditioned by the
    parameter-domain fastdiag equals JAX's on its 8 devices.  Without a
    preconditioner the count (~250) is decided by rounding: JAX's own
    changes with its device count (256, 258, 256, 257 on 1, 2, 4, 8)."""
    x, it, b = _same_on_every_rank(pools(8).run(ranks.matfree_cg, 8, 1e-10,
                                                300, False, 1e4))
    jx, jit, M = _jax_matfree(b, 1e-10, 300, mass_shift=1e4)
    assert it == jit
    assert np.linalg.norm(M @ x - b) / np.linalg.norm(b) < 1e-8
    assert np.abs(x - jx).max() / np.abs(jx).max() < 1e-8


def test_sharded_matfree_cg_free_dofs(pools):
    """The restricted solve (interior dofs) against the restricted mass
    matrix."""
    x, it, b = _same_on_every_rank(pools(4).run(ranks.matfree_cg, 4, 1e-10,
                                                300, True))
    from pyiga_tpu.ops.fastdiag import interior_dofs
    kvs = 3 * (jmake_knots(2, 0.0, 1.0, 5),)
    M = JMass(kvs, jgeometry.twisted_box()).assemble().asmatrix().tocsr()
    free = interior_dofs(kvs)
    Mf = M[free][:, free]
    assert np.linalg.norm(Mf @ x - b) / np.linalg.norm(b) < 1e-8
    assert it < 300


def _jax_three_patches(nspans):
    from pyiga_tpu.assemble import Multipatch
    kvs = 2 * (jmake_knots(2, 0.0, 1.0, nspans),)
    squ = jgeometry.unit_square()
    geos = (squ, squ.translate((1, 0)),
            squ.scale((-1, 1)).translate((2, 1)))
    MP = Multipatch([(kvs, g) for g in geos])
    MP.join_boundaries(0, 'right', 1, 'left')
    MP.join_boundaries(1, 'top', 2, 'bottom', flip=(True,))
    MP.finalize()
    return kvs, geos, MP


def test_sharded_multipatch_assembly(pools):
    # 3 patches on 8 ranks: five ranks hold none
    data, A = _same_on_every_rank(pools(8).run(ranks.multipatch_stiffness,
                                               8))
    from pyiga_tpu import vform
    kvs, geos, MP = _jax_three_patches(6)
    assert data.shape[0] == 3
    for p, g in enumerate(geos):
        ref = JStiff(kvs, g).assemble(mode='exact').data
        err = np.abs(data[p] - ref).max() / np.abs(ref).max()
        assert err < 1e-12, (p, err)
    A_ref, _ = MP.assemble_system(vform.stiffness_vf(2),
                                  vform.L2functional_vf(2, physical=True),
                                  f=lambda x, y: 1.0)
    assert _rel(A, A_ref) < 1e-12


def test_sharded_multipatch_generic_vform(pools):
    """'mass', a string form with a parameter and a vector form, each
    against the JAX package's host loop (reference
    assemble.py:1337-1368)."""
    import scipy.sparse
    from pyiga_tpu import vform
    from pyiga_tpu.assemble import assemble as jassemble
    A_mass, A_cdr, A_div = _same_on_every_rank(
        pools(8).run(ranks.multipatch_system, 8))
    _kvs, _geos, MP = _jax_three_patches(5)
    rhs = vform.L2functional_vf(2, physical=True)
    A_ref, _ = MP.assemble_system(vform.mass_vf(2), rhs, f=lambda x, y: 1.0)
    assert _rel(A_mass, A_ref) < 1e-12
    form = '(inner(grad(u), grad(v)) + dot(b, grad(u)) * v + u * v) * dx'
    A_ref, _ = MP.assemble_system(form, rhs, args={'b': np.array([2.0,
                                                                  -1.0])},
                                  f=lambda x, y: 1.0)
    assert _rel(A_cdr, A_ref) < 1e-12
    n = MP.numdofs
    A_ref = scipy.sparse.csr_matrix((2 * n, 2 * n))
    for p in range(MP.numpatches):
        X = MP.patch_to_global(p)
        A_p = jassemble(vform.divdiv_vf(2), MP.patches[p][0],
                        geo=MP.patches[p][1])
        Xb = scipy.sparse.kron(scipy.sparse.eye(2), X, format='csr')
        A_ref = A_ref + Xb @ A_p @ Xb.T
    assert _rel(A_div, A_ref) < 1e-12


def test_sharded_multipatch_refuses_unequal_patches(pools):
    msgs = pools(4).run(ranks.multipatch_errors, 4)[0]
    assert len(msgs) == 2
    assert 'geometry structure' in msgs[0]
    assert 'share knot vectors' in msgs[1]


def test_sharded_flagship_pipeline(pools):
    """The flagship f64 pipeline (the two-float pipeline's case in the JAX
    package) on 8 ranks: its banded data against the JAX package's exact
    f64 assembly, its cg_ir counts and solution against the port's
    unsharded assemble_banded + cg_ir on one process."""
    D, u, info, b = _same_on_every_rank(pools(8).run(ranks.flagship, 8, 12))
    from pyiga_tpu.ops.banded import band_info, banded_from_compact
    kvs = 2 * (jmake_knots(3, 0.0, 1.0, 12),)
    jasm = JStiff(kvs, jgeometry.quarter_annulus())
    bws = band_info(jasm.structure)
    ref = banded_from_compact(jasm.assemble().data, jasm.structure, bws)
    assert _rel(D, ref.reshape(D.shape)) < 5e-13

    from pyiga_tpu_torch import bspline, geometry, solvers
    from pyiga_tpu_torch.assemblers import StiffnessAssembler
    from pyiga_tpu_torch.ops.fastdiag import (fastdiag_precond_weighted,
                                              interior_dofs)
    from pyiga_tpu_torch.ops.matfree import RestrictedOperator
    pkvs = 2 * (bspline.make_knots(3, 0.0, 1.0, 12),)
    asm = StiffnessAssembler(pkvs, geometry.quarter_annulus(), device='cpu')
    op = asm.assemble_banded()
    free = interior_dofs(pkvs)
    x, ref_info = solvers.cg_ir(
        RestrictedOperator(op, free),
        RestrictedOperator(op.to(torch.float32), free), torch.as_tensor(b),
        tol=1e-8, precond_lo=fastdiag_precond_weighted(
            asm, dirichlet=True, dtype=torch.float32))
    assert info['inner_iters'] == ref_info['inner_iters']
    assert info['residual'] < 1e-8
    assert np.linalg.norm(u - x.numpy()) / np.linalg.norm(x.numpy()) < 1e-6


################################################################################
# tests/test_diff.py::test_grad_composes_with_sharding
################################################################################

def test_grad_composes_with_sharding(pools):
    """vmap(grad) of a mass objective with the batch split over 4 ranks
    equals the loop of grads and JAX's unsharded vmap(grad)."""
    from pyiga_tpu import geometry as jg
    from pyiga_tpu.assemblers import MassAssembler as JM
    from pyiga_tpu.diff import assembly_coeff_fn
    jasm = JM(2 * (jmake_knots(2, 0.0, 1.0, 4),), jg.bspline_quarter_annulus())
    fn, coeffs0 = assembly_coeff_fn(jasm)
    w = np.random.RandomState(42).rand(*np.asarray(fn(coeffs0)).shape)
    rng = np.random.RandomState(7)
    batch = np.stack([coeffs0 + 0.01 * rng.randn(*coeffs0.shape)
                      for _ in range(4)])
    g, loop = _same_on_every_rank(pools(4).run(ranks.grad_batch, 4, batch))
    assert np.allclose(g, loop, rtol=1e-12, atol=1e-14)
    g_ref = np.asarray(jax.vmap(jax.grad(
        lambda c: jnp.sum(jnp.asarray(w) * fn(c))))(jnp.asarray(batch)))
    assert np.allclose(g, g_ref, rtol=1e-12, atol=1e-14)


################################################################################
# the halo exchange, the dry run entry
################################################################################

@pytest.mark.parametrize('n,w', [(2, 1), (7, 3), (9, 2)])
def test_halo_exchange_uneven_and_empty_slabs(pools, n, w):
    """Every rank receives exactly the rows around its slab, from
    whichever ranks own them: 2 rows on 4 ranks (two empty slabs), a halo
    of 3 over slabs of 1 or 2 rows, slabs of 2 and 3."""
    for need, rows in pools(4).run(ranks.halo, n, w):
        a, c = need
        assert rows.shape == (c - a, 3)
        assert np.array_equal(rows[:, 0], np.arange(a, c))


def test_dryrun_multichip_cpu():
    from pyiga_tpu_torch.__graft_entry__ import dryrun_multichip
    dryrun_multichip(4, device='cpu')


def test_dryrun_multichip_refuses_nccl_without_cards():
    from pyiga_tpu_torch.__graft_entry__ import dryrun_multichip
    with pytest.raises(ValueError, match="backend='gloo'"):
        dryrun_multichip(2, device='cpu', backend='nccl')
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match='2 ranks over NCCL need 2 '
                           'cards'):
            dryrun_multichip(2)


################################################################################
# the slab relayout of the flagship
################################################################################

@pytest.mark.parametrize('bws,ns', [((1, 2), (7, 6)), ((2, 1, 1), (6, 4, 5))])
@pytest.mark.parametrize('add_transpose', [True, False])
@pytest.mark.parametrize('lo,hi', [(0, 3), (2, 5), (4, 6), (3, 3)])
def test_flat_banded_from_padded_chain_on_a_slab(bws, ns, add_transpose,
                                                 lo, hi):
    """A slab's rows of the flat layout, from the chain of the rows it
    reaches, are the whole layout's rows (bitwise)."""
    from pyiga_tpu_torch.ops.banded import flat_banded_from_padded_chain
    bsz = [2 * b + 1 for b in bws]
    Z = torch.as_tensor(np.random.RandomState(3).rand(
        *[m * n for m, n in zip(bsz, ns)]))
    whole = flat_banded_from_padded_chain(Z, bws, ns, add_transpose)
    n0, s0 = ns[0], int(np.prod(ns[1:]))
    a, c = max(0, lo - bws[0]), min(n0, hi + bws[0])
    Zs = torch.cat([Z[mu * n0 + a:mu * n0 + c] for mu in range(bsz[0])])
    got = flat_banded_from_padded_chain(Zs, bws, ns, add_transpose, a=a,
                                        lo=lo, hi=hi)
    assert torch.equal(got, whole[:, lo * s0:hi * s0])


def test_jax_host_cutoff_variables_route_nothing(monkeypatch):
    """The JAX package's host cutoffs are not ported (the card wins at
    every size they would route): their environment variables move no
    call that names the card onto the CPU."""
    from pyiga_tpu_torch import assemble, bspline, geometry
    assert not hasattr(config, 'host_assembly_cutoff')
    assert not hasattr(config, 'host_solve_cutoff')
    monkeypatch.setenv('PYIGA_HOST_ASM_CUTOFF', str(10 ** 9))
    monkeypatch.setenv('PYIGA_HOST_SOLVE_CUTOFF', str(10 ** 9))
    kvs = 2 * (bspline.make_knots(2, 0.0, 1.0, 6),)
    if torch.cuda.is_available():
        pytest.skip('needs a torch without CUDA')
    with pytest.raises((AssertionError, RuntimeError)):
        assemble.assemble('inner(grad(u), grad(v)) * dx', kvs,
                          geo=geometry.quarter_annulus(), device='cuda')
