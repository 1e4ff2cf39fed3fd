"""The port's block and subspace operators, host smoothers, two-grid and
fast-diagonalization solvers, its device Krylov entry points
(``cg_jit``, ``cg_jit_traceable``, ``cg_ir_traceable``, ``gmres_jit``),
the S-tilde basis, the ``Spline`` wrapper and the assembly-level names
(``assemblers.stiffness_fields`` / ``mass_fields``,
``ops.sumfac.assemble_terms`` / ``run_matrix_assembly`` /
``run_banded_assembly`` / ``SpaceTables.vector_term_tables``,
``ops.geom.deriv_1``), held against ``pyiga_tpu`` on the same inputs
made from a seed, on the CPU: host copies bitwise or to 1e-14, every
iteration count equal, Krylov solutions to 1e-10 relative.

``tests/test_solvers.py``'s ``test_gmres_cache_key_not_id`` and
``test_solver_cache_evicts_plain_callables`` are not ported: the JAX
package caches a traced program per operator, the port traces nothing
and keeps no cache.  ``test_cg_jit_keeps_no_reference`` checks that
instead."""

import gc
import weakref
from functools import reduce

import numpy as np
import pytest
import scipy.linalg
import scipy.sparse
import torch

import jax.numpy as jnp
import pyiga_tpu.assemble as jassemble
import pyiga_tpu.assemblers as jassemblers
import pyiga_tpu.bspline as jbspline
import pyiga_tpu.geometry as jgeometry
import pyiga_tpu.operators as joperators
import pyiga_tpu.solvers as jsolvers
import pyiga_tpu.spline as jspline
import pyiga_tpu.stilde as jstilde
from pyiga_tpu.ops import banded as jbanded
from pyiga_tpu.ops import fastdiag as jfastdiag
from pyiga_tpu.ops import geom as jgeom
from pyiga_tpu.ops import matfree as jmatfree
from pyiga_tpu.ops import sumfac as jsumfac

from pyiga_tpu_torch import (assemble, assemblers, bspline, geometry,
                             operators, solvers, spline, stilde)
from pyiga_tpu_torch.mlmatrix import transpose_idx_for_bidx
from pyiga_tpu_torch.ops import banded, fastdiag, geom, matfree, sumfac

torch.set_num_threads(1)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


# -- operators ----------------------------------------------------------

def test_block_operators():
    rng = np.random.RandomState(0)
    blocks = [rng.rand(3, 4), rng.rand(3, 2), rng.rand(5, 4)]
    x = rng.rand(6)
    B = operators.BlockOperator([[blocks[0], blocks[1]], [blocks[2], None]])
    jB = joperators.BlockOperator([[blocks[0], blocks[1]],
                                   [blocks[2], None]])
    assert B.shape == jB.shape == (8, 6)
    assert np.array_equal(B @ x, jB @ x)
    z = rng.rand(8)
    assert np.array_equal(B.T @ z, jB.T @ z)
    D = operators.BlockDiagonalOperator(*blocks)
    jD = joperators.BlockDiagonalOperator(*blocks)
    y = rng.rand(D.shape[1])
    assert np.array_equal(D @ y, jD @ y)
    assert np.array_equal(D.matmat(np.eye(D.shape[1])),
                          scipy.linalg.block_diag(*blocks))
    N = operators.BlockOperator([[None, operators.NullOperator((3, 2))],
                                 [blocks[2], None]])
    assert np.array_equal(N @ x, jB @ x * np.r_[np.zeros(3), np.ones(5)])
    with pytest.raises(ValueError):
        operators.BlockOperator([[blocks[0]], [blocks[1]]])


def test_subspace_operator_and_pardiso_stub():
    rng = np.random.RandomState(1)
    Ps = [rng.rand(7, 3), scipy.sparse.random(7, 2, density=0.5,
                                              random_state=rng).tocsr()]
    Bs = [rng.rand(3, 3), rng.rand(2, 2)]
    S, jS = operators.SubspaceOperator(Ps, Bs), \
        joperators.SubspaceOperator(Ps, Bs)
    x = rng.rand(7)
    ref = sum(P @ (B @ (P.T @ x)) for P, B in zip(Ps, Bs))
    assert np.allclose(S @ x, ref)
    assert np.array_equal(S @ x, jS @ x)
    assert np.array_equal(S.T @ x, jS.T @ x)
    assert operators.HAVE_MKL is joperators.HAVE_MKL is False
    with pytest.raises(ImportError):
        operators.PardisoSolverWrapper(np.eye(2))


# -- host solvers -------------------------------------------------------

def test_fastdiag_solver():
    specs = [(4, 3), (3, 4), (2, 5)]
    KM = [(assemble.stiffness(bspline.make_knots(p, 0.0, 1.0, n))[1:-1, 1:-1]
           .toarray(), assemble.mass(bspline.make_knots(p, 0.0, 1.0, n))
           [1:-1, 1:-1].toarray()) for p, n in specs]
    solver = solvers.fastdiag_solver(KM)
    A = sum(reduce(np.kron, [KM[k][int(k != i)] for k in range(3)])
            for i in range(3))
    f = np.random.RandomState(2).rand(A.shape[0])
    assert np.allclose(f, solver.dot(A.dot(f)))
    assert _rel(solver.dot(f), jsolvers.fastdiag_solver(KM).dot(f)) < 1e-14


@pytest.mark.parametrize('sweep', ['forward', 'backward', 'symmetric'])
def test_smoothers(sweep):
    rng = np.random.RandomState(3)
    A = scipy.sparse.csr_matrix(np.abs(rng.rand(10, 10)) + 4 * np.eye(10))
    b, x0 = rng.rand(10), rng.rand(10)
    S = solvers.SequentialSmoother((
        solvers.GaussSeidelSmoother(iterations=2, sweep=sweep),
        solvers.OperatorSmoother(0.1 * np.eye(10))))
    jS = jsolvers.SequentialSmoother((
        jsolvers.GaussSeidelSmoother(iterations=2, sweep=sweep),
        jsolvers.OperatorSmoother(0.1 * np.eye(10))))
    x, jx = x0.copy(), x0.copy()
    S(A, x, b)
    jS(A, jx, b)
    assert np.array_equal(x, jx)


def test_twogrid(capsys):
    kv_c = bspline.make_knots(3, 0.0, 1.0, 50)
    kv = kv_c.refine()
    P = bspline.prolongation(kv_c, kv)
    A = assemble.mass(kv) + assemble.stiffness(kv)
    f = bspline.load_vector(kv, lambda x: 1.0)
    S = solvers.SequentialSmoother((solvers.GaussSeidelSmoother(),
                                    solvers.OperatorSmoother(
                                        1e-6 * np.eye(len(f)))))
    x = solvers.twogrid(A, f, P, S)
    assert np.linalg.norm(f - A.dot(x)) < 1e-6
    ours = capsys.readouterr().out
    jS = jsolvers.SequentialSmoother((jsolvers.GaussSeidelSmoother(),
                                      jsolvers.OperatorSmoother(
                                          1e-6 * np.eye(len(f)))))
    jx = jsolvers.twogrid(A, f, P, jS)
    assert ours == capsys.readouterr().out and ours.endswith(' iterations\n')
    assert np.array_equal(x, jx)


def test_stilde_and_spline():
    for p, n in ((3, 10), (4, 7), (5, 12)):
        kv, jkv = bspline.make_knots(p, 0.0, 1.0, n), \
            jbspline.make_knots(p, 0.0, 1.0, n)
        for got, ref in zip(stilde.Stilde_basis(kv),
                            jstilde.Stilde_basis(jkv)):
            assert np.array_equal(got, ref)
        for side in (0, 1):
            for got, ref in zip(stilde.Stilde_basis_side(kv, side),
                                jstilde.Stilde_basis_side(jkv, side)):
                assert np.array_equal(got, ref)
    kv = bspline.make_knots(3, 0.0, 1.0, 6)
    c = np.random.RandomState(4).rand(kv.numdofs)
    s, js = spline.Spline(kv, c), jspline.Spline(
        jbspline.make_knots(3, 0.0, 1.0, 6), c)
    x = np.linspace(0, 1, 23)
    assert np.array_equal(s.eval(x), js.eval(x))
    assert np.array_equal(s.deriv(x, 2), js.deriv(x, 2))
    assert np.array_equal(s.derivative().coeffs, js.derivative().coeffs)
    assert np.allclose(s.derivative().eval(x), s.deriv(x))
    with pytest.raises(ValueError):
        spline.Spline(kv, c[:-1])


# -- device Krylov entry points on the CPU ------------------------------

def _poisson(n=8):
    """The port's 3D p=3 flat banded operator on the CPU restricted to the
    interior dofs, its weighted fastdiag preconditioner, and the JAX
    package's same operator (the port's data as numpy) and
    preconditioner."""
    kvs = 3 * (bspline.make_knots(3, 0.0, 1.0, n),)
    asm = assemblers.StiffnessAssembler(kvs, geometry.twisted_box(),
                                        device='cpu')
    op = asm.assemble_banded()
    free = fastdiag.interior_dofs(kvs)
    D = op.D.numpy().reshape(tuple(2 * b + 1 for b in op.bws) + op.ns)
    jasm = jassemblers.StiffnessAssembler(
        3 * (jbspline.make_knots(3, 0.0, 1.0, n),), jgeometry.twisted_box())
    return dict(
        op=op, free=free, D=D, asm=asm,
        A=matfree.RestrictedOperator(op, free),
        P=fastdiag.fastdiag_precond_weighted(asm, dirichlet=True),
        jA=jmatfree.RestrictedOperator(jbanded.BandedOperator(
            D, op.bws, op.ns), free, int(np.prod(op.ns))),
        jP=jfastdiag.fastdiag_precond_weighted(jasm, dirichlet=True))


@pytest.fixture(scope='module')
def poisson():
    return _poisson()


def _starts(n, seed=0):
    return [None, np.random.RandomState(seed).standard_normal(n)]


@pytest.mark.parametrize('start', [0, 1])
def test_cg_jit_matches_jax(poisson, start):
    nf = len(poisson['free'])
    b = np.random.RandomState(0).rand(nf)
    x0 = _starts(nf)[start]
    x, it = solvers.cg_jit(poisson['A'], torch.as_tensor(b),
                           x0=None if x0 is None else torch.as_tensor(x0),
                           tol=1e-8, precond=poisson['P'])
    jx, jit = jsolvers.cg_jit(poisson['jA'], jnp.asarray(b),
                              x0=None if x0 is None else jnp.asarray(x0),
                              tol=1e-8, precond=poisson['jP'])
    assert isinstance(it, int) and it == int(jit)
    assert isinstance(x, torch.Tensor) and x.device.type == 'cpu'
    assert _rel(x.numpy(), jx) < 1e-10


def test_cg_jit_stops_relative_to_initial_residual(poisson):
    """From a start near the solution the stop is tol * ||b - A x0||, so
    the solve still takes iterations (tol * ||b|| would stop at once)."""
    nf = len(poisson['free'])
    b = torch.as_tensor(np.random.RandomState(0).rand(nf))
    x, _ = solvers.cg_jit(poisson['A'], b, tol=1e-12, precond=poisson['P'])
    x0 = x + 1e-6 * torch.as_tensor(_starts(nf)[1])
    r0 = float(torch.linalg.vector_norm(b - poisson['A'](x0)))
    assert r0 < 1e-4 * float(torch.linalg.vector_norm(b))
    x1, it = solvers.cg_jit(poisson['A'], b, x0=x0, tol=1e-4,
                            precond=poisson['P'])
    assert it > 0
    assert float(torch.linalg.vector_norm(b - poisson['A'](x1))) \
        <= 1e-4 * r0
    jx, jit = jsolvers.cg_jit(poisson['jA'], jnp.asarray(b.numpy()),
                              x0=jnp.asarray(x0.numpy()), tol=1e-4,
                              precond=poisson['jP'])
    assert it == int(jit)


def test_operand_protocol_and_traceable(poisson):
    """BandedOperator and FastDiagPrecond carry operands; the traceable
    program runs on substituted operands (here the mass matrix's data
    doubled: the solution halves)."""
    P = poisson['P']
    sop = banded.BandedOperator(torch.as_tensor(poisson['D']),
                                poisson['op'].bws, poisson['op'].ns)
    v = torch.as_tensor(np.random.RandomState(5).rand(sop.shape[0]))
    assert torch.equal(sop(v), poisson['op'](v))
    mass = assemblers.MassAssembler(poisson['asm'].kvs,
                                    geometry.twisted_box(),
                                    device='cpu').assemble_banded()
    op = banded.BandedOperator(
        mass.D.reshape(tuple(2 * b + 1 for b in mass.bws) + mass.ns),
        mass.bws, mass.ns)
    assert set(op.operands) == {'D'}
    assert set(P.operands) == {'Us', 'UTs', 'inv_diag', 'free'}
    assert torch.equal(op.apply_with_operands(op.operands, v), op(v))
    y = op.apply_with_operands({'D': 2 * op.D}, v)
    assert torch.allclose(y, 2 * op(v), rtol=1e-14, atol=0)
    full = torch.as_tensor(np.random.RandomState(6).rand(op.shape[0]))
    run, mv_ops, pc_ops = solvers.cg_jit_traceable(op, tol=1e-10,
                                                   maxiter=40)
    assert mv_ops is op.operands and pc_ops is None
    x1, it1 = run(full, None, mv_ops, None)
    x2, it2 = run(full, None, {'D': 2 * op.D}, None)
    assert it1 == it2
    assert _rel(2 * x2.numpy(), x1.numpy()) < 1e-10
    nf = len(poisson['free'])
    r = torch.as_tensor(np.random.RandomState(7).rand(nf))
    assert torch.equal(P.apply_with_operands(P.operands, r), P(r))


def test_cg_ir_traceable_matches_cg_ir(poisson):
    op, free = poisson['op'], poisson['free']
    hi = matfree.RestrictedOperator(op, free)
    lo = matfree.RestrictedOperator(op.to(torch.float32), free)
    P32 = fastdiag.fastdiag_precond_weighted(poisson['asm'], dirichlet=True,
                                             dtype=torch.float32)
    b = torch.as_tensor(np.random.RandomState(0).rand(len(free)))
    x, info = solvers.cg_ir(hi, lo, b, tol=1e-10, precond_lo=P32,
                            inner_tol=3e-3)
    run, hi_ops, lo_ops, pc_ops = solvers.cg_ir_traceable(
        hi, lo, tol=1e-10, precond_lo=P32, inner_tol=3e-3)
    assert hi_ops is None and lo_ops is None and pc_ops is P32.operands
    x2, packed = run(b, hi_ops, lo_ops, pc_ops)
    assert solvers.cg_ir_info(packed) == info
    assert torch.equal(x, x2)
    jx, jinfo = jsolvers.cg_ir(
        poisson['jA'], jmatfree.RestrictedOperator(
            jbanded.BandedOperator(poisson['D'].astype(np.float32), op.bws,
                                   op.ns), free, int(np.prod(op.ns))),
        jnp.asarray(b.numpy()), tol=1e-10, inner_tol=3e-3,
        precond_lo=jfastdiag.fastdiag_precond_weighted(
            jassemblers.StiffnessAssembler(
                3 * (jbspline.make_knots(3, 0.0, 1.0, 8),),
                jgeometry.twisted_box()), dirichlet=True, dtype=np.float32))
    assert info['inner_iters'] == jinfo['inner_iters']
    assert _rel(x.numpy(), jx) < 1e-10


@pytest.mark.parametrize('start', [0, 1])
def test_gmres_jit_matches_jax(start):
    """The convection-diffusion restricted operator (dense, as the
    example's) from zero and from a nonzero start; the port's ``gmres``
    gives the same count."""
    n, p = 8, 2
    kvs = 2 * (bspline.make_knots(p, 0.0, 1.0, n),)
    A = assemble.assemble('(inner(grad(u), grad(v)) + dot(b, grad(u)) * v)'
                          ' * dx', kvs, geo=geometry.quarter_annulus(),
                          b=np.array([3.0, -2.0]), device='cpu')
    free = fastdiag.interior_dofs(kvs)
    K = A.tocsr()[free][:, free].toarray()
    rng = np.random.RandomState(8)
    b = rng.rand(len(free))
    x0 = _starts(len(free), seed=9)[start]
    Kt, Kj = torch.as_tensor(K), jnp.asarray(K)
    P = fastdiag.fastdiag_precond(kvs, dirichlet=True, device='cpu')
    jP = jfastdiag.fastdiag_precond(
        2 * (jbspline.make_knots(p, 0.0, 1.0, n),), dirichlet=True)
    tx0 = None if x0 is None else torch.as_tensor(x0)
    x, it = solvers.gmres_jit(lambda v: Kt @ v, torch.as_tensor(b), x0=tx0,
                              tol=1e-10, restart=10, precond=P)
    jx, jit = jsolvers.gmres_jit(lambda v: Kj @ v, jnp.asarray(b),
                                 x0=None if x0 is None else jnp.asarray(x0),
                                 tol=1e-10, restart=10, precond=jP)
    assert it == int(jit) and it > 10
    assert _rel(x.numpy(), jx) < 1e-10
    x2, it2 = solvers.gmres(lambda v: Kt @ v, torch.as_tensor(b), x0=tx0,
                            tol=1e-10, restart=10, precond=P)
    assert it2 == it and torch.equal(x2, x)


def test_cg_jit_keeps_no_reference():
    """No reference to the operator or preconditioner outlives the
    call."""
    class Op:
        def __init__(self, M):
            self.M = M

        def __call__(self, v):
            return self.M @ v
    rng = np.random.RandomState(10)
    M = rng.rand(12, 12)
    M = torch.as_tensor(M @ M.T + 12 * np.eye(12))
    op, pc = Op(M), Op(torch.eye(12, dtype=torch.float64))
    refs = [weakref.ref(op), weakref.ref(pc)]
    x, it = solvers.cg_jit(op, torch.as_tensor(rng.rand(12)), precond=pc)
    x, it = solvers.gmres_jit(op, torch.as_tensor(rng.rand(12)), precond=pc)
    del op, pc
    gc.collect()
    assert all(r() is None for r in refs)


# -- assembly-level names -----------------------------------------------

@pytest.mark.parametrize('kind', ['stiffness', 'mass'])
@pytest.mark.parametrize('geo_name', ['twisted_box', 'quarter_annulus'])
def test_assembly_entries(kind, geo_name):
    d = 3 if geo_name == 'twisted_box' else 2
    kvs = d * (bspline.make_knots(3, 0.0, 1.0, 5),)
    cls = (assemblers.StiffnessAssembler if kind == 'stiffness'
           else assemblers.MassAssembler)
    jcls = (jassemblers.StiffnessAssembler if kind == 'stiffness'
            else jassemblers.MassAssembler)
    asm = cls(kvs, getattr(geometry, geo_name)(), device='cpu')
    jasm = jcls(d * (jbspline.make_knots(3, 0.0, 1.0, 5),),
                getattr(jgeometry, geo_name)())
    field_fn = getattr(assemblers, kind + '_fields')
    jfield_fn = getattr(jassemblers, kind + '_fields')
    F, jF = field_fn(asm.geo_inputs()), jfield_fn(jasm._geo_inputs)
    assert _rel(torch.stack(F).numpy(), np.stack(jF)) < 1e-14
    plan = asm._fold()
    tperms = ([transpose_idx_for_bidx(bx) for bx in asm.structure.bidx]
              if plan else None)
    tabs = asm.tables.term_tables(asm.terms)
    data = sumfac.run_matrix_assembly(field_fn, asm._geo_inputs, tabs, plan,
                                      tperms, device='cpu')
    assert torch.equal(data, asm.run_device())
    jdata = jsumfac.run_matrix_assembly(jfield_fn, jasm._geo_inputs,
                                        jasm.tables.term_tables(jasm.terms),
                                        plan, tperms)
    assert _rel(data.numpy(), jdata) < 1e-14
    bws = banded.band_info(asm.structure)
    ns = tuple(b[0] for b in asm.structure.bs)
    bsz = tuple(2 * b + 1 for b in bws)
    btabs = asm.tables.banded_term_tables(asm.terms, bws)
    Db = sumfac.run_banded_assembly(field_fn, asm.geo_inputs(), btabs, bsz,
                                    ns)
    jDb = jsumfac.run_banded_assembly(
        jfield_fn, jasm._geo_inputs,
        jasm.tables.banded_term_tables(jasm.terms, bws), bsz, ns)
    assert _rel(Db.numpy(), jDb) < 1e-14
    flat = banded.flat_banded_embed_device(Db, bws, ns)
    ref = asm.assemble_banded().D
    if kind == 'mass':
        assert torch.equal(flat, ref)       # the same chain, unfolded
    else:
        assert _rel(flat.numpy(), ref.numpy()) < 1e-14
    F = field_fn(asm.geo_inputs())
    summed = sumfac.assemble_terms(
        [[torch.as_tensor(T) for T in t] for t in tabs], F)
    plain = sum(sumfac.contract_chain([torch.as_tensor(T) for T in t], f)
                for t, f in zip(tabs, F))
    assert _rel(summed.numpy(), plain.numpy()) < 1e-14


def test_vector_term_tables_and_deriv_1():
    kvs = 2 * (bspline.make_knots(2, 0.0, 1.0, 4),)
    jkvs = 2 * (jbspline.make_knots(2, 0.0, 1.0, 4),)
    asm = assemblers.MassAssembler(kvs, geometry.quarter_annulus(),
                                   device='cpu')
    jasm = jassemblers.MassAssembler(jkvs, jgeometry.quarter_annulus())
    terms = [(0, 0), (1, 0), (0, 1)]
    for tabs, jtabs in zip(asm.tables.vector_term_tables(terms),
                           jasm.tables.vector_term_tables(terms)):
        assert all(np.array_equal(a, b) for a, b in zip(tabs, jtabs))
    gi = asm._geo_inputs
    tables = gi['geo_tables_nurbs']
    val = [torch.as_tensor(t[0]) for t in tables]
    der = [torch.as_tensor(t[1]) for t in tables]
    C = torch.as_tensor(gi['geo_coeffs'])
    for k in range(2):
        got = geom.deriv_1(val, der, C, k, 2)
        ref = jgeom.deriv_1([jnp.asarray(t[0]) for t in tables],
                            [jnp.asarray(t[1]) for t in tables],
                            jnp.asarray(gi['geo_coeffs']), k, 2)
        assert _rel(got.numpy(), ref) < 1e-14


def test_assemble_mass_1d_matches_jax():
    """The 1D builders behind the subspace-correction example."""
    kv, jkv = bspline.make_knots(4, 0.0, 1.0, 9), \
        jbspline.make_knots(4, 0.0, 1.0, 9)
    for f in ('mass', 'stiffness'):
        assert (getattr(assemble, f)(kv) != getattr(jassemble, f)(jkv)).nnz \
            == 0
