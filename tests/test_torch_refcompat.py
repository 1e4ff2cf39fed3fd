"""The public signatures of the PyTorch port take the JAX package's
keywords: each entry point is called with the reference's keywords and
defaults and held to the reference's result (float64 on the CPU, the
kernels through their plain versions).  A value the port cannot honour
raises ``NotImplementedError`` naming the ROADMAP item that ports it."""

import numpy as np
import pytest
import scipy.sparse
import torch

import jax.numpy as jnp

import pyiga_tpu.bspline as jbspline
import pyiga_tpu.geometry as jgeometry
import pyiga_tpu.hierarchical as jhier
from pyiga_tpu import assemble as jassemble
from pyiga_tpu import mlmatrix as jmlmatrix
from pyiga_tpu import solvers as jsolvers
from pyiga_tpu.assemblers import StiffnessAssembler as JStiffnessAssembler
from pyiga_tpu.ops import banded as jbanded
from pyiga_tpu.ops import fastdiag as jfastdiag
from pyiga_tpu.ops import matfree as jmatfree
from pyiga_tpu.ops import mlmatvec as jmlmatvec
from pyiga_tpu.ops import sumfac as jsumfac

from pyiga_tpu_torch import (assemble, bspline, geometry, hierarchical,
                             mlmatrix, solvers)
from pyiga_tpu_torch.assemblers import StiffnessAssembler
from pyiga_tpu_torch.ops import fastdiag, matfree, mg, mlmatvec, sumfac

from test_torch_localmg import bench_hspace, discretize

torch.set_num_threads(1)

CONVDIFF = '(inner(grad(u), grad(v)) + dot(b, grad(u)) * v + u * v) * dx'


def _kvs(pkg, p=2, n=5, dim=2):
    return dim * (pkg.make_knots(p, 0.0, 1.0, n),)


def _structures():
    """The same 2D stiffness structure in both packages, and a matrix with
    that sparsity."""
    jS = jmlmatrix.MLStructure.from_kvs(_kvs(jbspline), _kvs(jbspline))
    S = mlmatrix.MLStructure.from_kvs(_kvs(bspline), _kvs(bspline))
    A = jassemble.stiffness(_kvs(jbspline), jgeometry.quarter_annulus())
    return S, jS, scipy.sparse.csr_matrix(A)


@pytest.mark.parametrize('lower_tri', [False, True])
def test_nonzero_lower_tri(lower_tri):
    S, jS, _A = _structures()
    for got, ref in ((S.nonzero(lower_tri=lower_tri),
                      jS.nonzero(lower_tri=lower_tri)),
                     (mlmatrix.ml_nonzero(S.bidx, S.bs, lower_tri=lower_tri),
                      jmlmatrix.ml_nonzero(jS.bidx, np.asarray(jS.bs),
                                           lower_tri=lower_tri))):
        assert all(np.array_equal(g, r) for g, r in zip(got, ref))
    if lower_tri:
        I, J = S.nonzero(lower_tri=True)
        assert (I >= J).all() and len(I) < S.make_mlmatrix(
            data=np.zeros([len(b) for b in S.bidx])).nonzero()[0].size


@pytest.mark.parametrize('dense', [False, True])
def test_mlmatrix_from_matrix(dense):
    S, jS, A = _structures()
    M = A.toarray() if dense else A
    for X, jX in ((mlmatrix.MLMatrix(S, matrix=M),
                   jmlmatrix.MLMatrix(jS, matrix=M)),
                  (S.make_mlmatrix(matrix=M), jS.make_mlmatrix(matrix=M))):
        assert np.array_equal(X.data, jX.data)
        assert abs(X.asmatrix() - A).max() == 0.0
        assert (X.nonzero(lower_tri=True)[0]
                == jX.nonzero(lower_tri=True)[0]).all()
    # the reference's defaults: no data
    empty = S.make_mlmatrix()
    assert empty.data is None and jS.make_mlmatrix().data is None
    with pytest.raises(ValueError):
        empty.asmatrix()
    with pytest.raises(ValueError):
        mlmatrix.MLMatrix(S, data=jS.make_mlmatrix(matrix=A).data, matrix=A)


@pytest.mark.parametrize('layout', ['blocked', 'packed'])
def test_assemble_entries_layout(layout):
    kw = dict(b=np.array([3.0, -2.0]))
    asm = assemble.instantiate_assembler(
        CONVDIFF, _kvs(bspline), dict(kw, geo=geometry.quarter_annulus()),
        None, None, device='cpu')
    got = assemble.assemble_entries(asm, symmetric=False, format='csr',
                                    layout=layout, mode=None)
    ref = jassemble.assemble(CONVDIFF, _kvs(jbspline),
                             geo=jgeometry.quarter_annulus(), layout=layout,
                             mode='exact', **kw)
    assert abs(got - ref).max() <= 1e-13 * abs(ref).max()
    same = assemble.assemble(CONVDIFF, _kvs(bspline),
                             geo=geometry.quarter_annulus(), layout=layout,
                             device='cpu', **kw)
    assert abs(same - got).max() == 0.0


@pytest.mark.parametrize('bdspec', [None, (0, 0), (1, 1)])
def test_quadrature_for_bdspec(bdspec):
    kvs, jkvs = _kvs(bspline, p=3, n=4), _kvs(jbspline, p=3, n=4)
    got = sumfac.quadrature_for(kvs, bdspec=bdspec)
    ref = jsumfac.quadrature_for(jkvs, bdspec=bdspec)
    for g, r in zip(got, ref):
        assert all(np.array_equal(a, b) for a, b in zip(g, r))


def test_entry_points_take_reference_keywords():
    """``assemble_banded(mode=)``, ``cg_ir(fetch_info=)``,
    ``RestrictedOperator(ns=)``, ``ml_matvec(sorted_rows=)`` and
    ``DeviceMGSolver(tri_block_cutoff=)`` with the reference's keywords
    give the reference's results."""
    geo, jgeo = geometry.twisted_box(), jgeometry.twisted_box()
    asm = StiffnessAssembler(_kvs(bspline, 3, 6, 3), geo, device='cpu')
    jasm = JStiffnessAssembler(_kvs(jbspline, 3, 6, 3), jgeo)
    op = asm.assemble_banded(mode=None)
    assert torch.equal(asm.assemble_banded(mode='ozaki').D, op.D)
    mlm = jasm.assemble(mode='exact')
    bws = jbanded.band_info(mlm.structure)
    ns = tuple(b[0] for b in mlm.structure.bs)
    Db = jbanded.banded_from_compact(mlm.data, mlm.structure, bws)
    jop = jbanded.BandedOperator(Db, bws, ns)
    x = np.random.RandomState(0).rand(op.shape[0])
    y, jy = op(torch.as_tensor(x)).numpy(), np.asarray(jop(jnp.asarray(x)))
    assert np.abs(y - jy).max() <= 1e-14 * np.abs(jy).max()

    # RestrictedOperator: ns given explicitly, or taken from the operator
    free = fastdiag.interior_dofs(asm.kvs)
    nf = int(np.prod(ns))
    R = matfree.RestrictedOperator(op, free, nf, ns=ns)
    jR = jmatfree.RestrictedOperator(jop, free, nf, ns=ns)
    xf = torch.as_tensor(x[:len(free)])
    assert torch.equal(R(xf), matfree.RestrictedOperator(op, free)(xf))
    assert np.abs(R(xf).numpy() - np.asarray(jR(jnp.asarray(xf.numpy())))
                  ).max() <= 1e-14 * np.abs(jy).max()

    # cg_ir: the packed info of fetch_info=False decodes to the dict
    b = torch.as_tensor(np.random.RandomState(1).rand(len(free)))
    R32 = matfree.RestrictedOperator(op.to(torch.float32), free, ns=ns)
    kw = dict(tol=1e-8, inner_tol=3e-3)
    pc = fastdiag.fastdiag_precond_weighted(asm, dirichlet=True,
                                            dtype=torch.float32)
    xa, info = solvers.cg_ir(R, R32, b, precond_lo=pc, fetch_info=True, **kw)
    xb, packed = solvers.cg_ir(R, R32, b, precond_lo=pc, fetch_info=False,
                               **kw)
    assert torch.equal(xa, xb) and packed.shape == (2 + 10,)
    assert solvers.cg_ir_info(packed) == info
    jR32 = jmatfree.RestrictedOperator(
        jbanded.BandedOperator(Db.astype(np.float32), bws, ns), free, nf)
    _jx, jpacked = jsolvers.cg_ir(
        jR, jR32, jnp.asarray(b.numpy()), fetch_info=False,
        precond_lo=jfastdiag.fastdiag_precond_weighted(
            jasm, dirichlet=True, dtype=np.float32), **kw)
    jinfo = jsolvers.cg_ir_info(jpacked)
    assert info['outer'] == jinfo['outer']
    assert info['inner_iters'] == jinfo['inner_iters']

    # ml_matvec: the row-order hint changes nothing
    S = mlm.structure
    args = (S.bidx, [bk[0] for bk in S.bs], [bk[1] for bk in S.bs])
    for hint in (None, [True] * 3):
        Y = mlmatvec.ml_matvec(torch.tensor(np.array(mlm.data)), *args,
                               torch.as_tensor(x), sorted_rows=hint)
        jY = jmlmatvec.ml_matvec(jnp.asarray(mlm.data), *args,
                                 jnp.asarray(x), sorted_rows=hint)
        assert np.abs(Y.numpy() - np.asarray(jY)).max() \
            <= 1e-14 * np.abs(jy).max()


def test_device_mg_solver_tri_block_cutoff():
    hs, jhs = bench_hspace(hierarchical, bspline, 8), \
        bench_hspace(jhier, jbspline, 8)
    A, f = discretize(hs)
    Ps = hs.virtual_hierarchy_prolongators()
    args = (solvers.galerkin_hierarchy(A, Ps), Ps,
            hs.indices_to_smooth('cell_supp'), ('forward', 'backward'), 2)
    _u, it = mg.DeviceMGSolver(*args, active_dofs=hs.non_dirichlet_dofs(),
                               smoother_impl='auto', dense_cutoff=6000,
                               tri_block_cutoff=8192, device='cpu').solve(f)
    assert it == jsolvers.solve_hmultigrid(jhs, A, f,
                                           relax_backend='host')[1]
    # past the cutoff 'auto' takes the wavefront smoother, as the JAX
    # package does, with the same count
    s = mg.DeviceMGSolver(*args, active_dofs=hs.non_dirichlet_dofs(),
                          dense_cutoff=10, tri_block_cutoff=10, device='cpu')
    assert s.smoother_impl == 'wavefront' and s.solve(f)[1] == it


def test_fastdiag_weighted():
    """``tests/test_ops.py::test_fastdiag_weighted`` on the port, with the
    reference's call (default dtype): on the twisted box the geometry-
    averaged preconditioner takes strictly fewer CG iterations than the
    parametric one, to a residual below 1e-9, and each count equals the
    JAX package's ``cg_jit`` on the same operators."""
    from pyiga_tpu.ops.matfree import MatrixFreeOperator as JMatrixFree
    kvs, jkvs = _kvs(bspline, 3, 8, 3), _kvs(jbspline, 3, 8, 3)
    asm = StiffnessAssembler(kvs, geometry.twisted_box(), device='cpu')
    jasm = JStiffnessAssembler(jkvs, jgeometry.twisted_box())
    free = fastdiag.interior_dofs(kvs)
    op = matfree.MatrixFreeOperator(asm, free_dofs=free,
                                    dtype=torch.float64)
    b = np.random.RandomState(0).rand(len(free))
    P0 = fastdiag.fastdiag_precond(kvs, dirichlet=True, device='cpu')
    Pw = fastdiag.fastdiag_precond_weighted(asm, dirichlet=True)
    _x0, it0 = solvers.cg(op, torch.as_tensor(b), tol=1e-10, maxiter=500,
                          precond=P0)
    xw, itw = solvers.cg(op, torch.as_tensor(b), tol=1e-10, maxiter=500,
                         precond=Pw)
    assert int(itw) < int(it0)
    K = jasm.assemble().asmatrix().tocsr()[free][:, free]
    r = np.linalg.norm(K @ xw.numpy() - b) / np.linalg.norm(b)
    assert r < 1e-9

    jop = JMatrixFree(jasm, free_dofs=free, dtype=np.float64)
    _jx0, jit0 = jsolvers.cg_jit(
        jop, jnp.asarray(b), tol=1e-10, maxiter=500,
        precond=jfastdiag.fastdiag_precond(jkvs, dirichlet=True))
    _jxw, jitw = jsolvers.cg_jit(
        jop, jnp.asarray(b), tol=1e-10, maxiter=500,
        precond=jfastdiag.fastdiag_precond_weighted(jasm, dirichlet=True))
    assert (int(it0), int(itw)) == (int(jit0), int(jitw))


def test_fastdiag_weighted_default_dtype():
    """The weighted preconditioner defaults to the compute dtype, float64
    (``pyiga_tpu/ops/fastdiag.py``: ``dtype=None`` -> the config's dtype),
    as the parametric one does; float32 stays available by keyword."""
    asm = StiffnessAssembler(_kvs(bspline, 2, 4, 2),
                             geometry.quarter_annulus(), device='cpu')
    Pw = fastdiag.fastdiag_precond_weighted(asm, dirichlet=True)
    assert Pw.inv_diag.dtype == torch.float64
    assert all(U.dtype == torch.float64 for U in Pw.Us + Pw.UTs)
    r = torch.ones(len(fastdiag.interior_dofs(asm.kvs)), dtype=torch.float64)
    assert Pw(r).dtype == torch.float64
    P32 = fastdiag.fastdiag_precond_weighted(asm, dirichlet=True,
                                             dtype=torch.float32)
    assert P32.inv_diag.dtype == torch.float32


def _folded_operands(rng):
    """Random two-axis chains, numpy: 4 terms, terms 0 and 2 sharing their
    last table, terms 1 and 3 mirrored (random axis permutations)."""
    Q, m = (5, 6), (4, 7)
    T0 = rng.rand(m[1], Q[1])
    tabs = [[rng.rand(m[0], Q[0]), T0], [rng.rand(m[0], Q[0]),
                                         rng.rand(m[1], Q[1])],
            [rng.rand(m[0], Q[0]), T0], [rng.rand(m[0], Q[0]),
                                         rng.rand(m[1], Q[1])]]
    fields = [rng.rand(*Q) for _ in tabs]
    perms = [rng.permutation(k) for k in m]
    return tabs, fields, [(0, False), (1, True), (2, False), (3, True)], perms


def _shared(tabs, conv):
    """`tabs` converted by `conv`, one object a distinct array (the
    last-table groups go by identity)."""
    memo = {}
    return [[memo.setdefault(id(T), conv(T)) for T in t] for t in tabs]


@pytest.mark.parametrize('call', ['keyword', 'positional', 'last_idx',
                                  'both_positional'])
def test_assemble_terms_folded_takes_reference_arguments(call):
    """``assemble_terms_folded(..., mode='exact', last_idx=None)`` in the
    reference's order: `mode` by keyword or fifth by position, `last_idx`
    by keyword or sixth, each equal to the port's call without them and
    to the JAX package's native-f64 result at 1e-13 relative."""
    tabs, fields, plan, perms = _folded_operands(np.random.RandomState(11))
    ttabs = _shared(tabs, torch.as_tensor)
    tf = [torch.as_tensor(F) for F in fields]
    tp = [torch.as_tensor(p) for p in perms]
    ref = sumfac.assemble_terms_folded(ttabs, tf, plan, tp)
    li = sumfac.last_table_groups(ttabs)
    assert li == (0, 1, 0, 2)
    args = (ttabs, tf, plan, tp)
    got = {'keyword': lambda: sumfac.assemble_terms_folded(*args,
                                                           mode='exact'),
           'positional': lambda: sumfac.assemble_terms_folded(*args,
                                                              'exact'),
           'last_idx': lambda: sumfac.assemble_terms_folded(*args,
                                                            last_idx=li),
           'both_positional': lambda: sumfac.assemble_terms_folded(
               *args, 'exact', li)}[call]()
    assert torch.equal(got, ref)
    jtabs = _shared(tabs, jnp.asarray)
    jref = np.asarray(jsumfac.assemble_terms_folded(
        jtabs, [jnp.asarray(F) for F in fields], plan,
        [jnp.asarray(p) for p in perms], mode='exact',
        last_idx=jsumfac.last_table_groups(jtabs)))
    assert np.abs(got.numpy() - jref).max() <= 1e-13 * np.abs(jref).max()


@pytest.mark.parametrize('call', ['positional', 'keyword'])
def test_flat_banded_operator_takes_interpret(call):
    """``FlatBandedOperator(D, bws, ns, interpret=None)``: ``True`` by
    position or by keyword gives the port's operator, equal to the one
    built without it and to the JAX package's native-f64
    ``BandedOperator`` on the same banded data at 1e-13 relative."""
    from pyiga_tpu_torch.ops import banded
    rng = np.random.RandomState(12)
    bws, ns = (1, 2), (6, 9)
    Db = _zero_padding(rng.rand(*([2 * b + 1 for b in bws] + list(ns))),
                       bws, ns)
    D = banded.flat_banded_embed_device(torch.as_tensor(Db), bws, ns)
    op = (banded.FlatBandedOperator(D, bws, ns, True) if call == 'positional'
          else banded.FlatBandedOperator(D, bws, ns, interpret=True))
    x = rng.rand(int(np.prod(ns)))
    y = op(torch.as_tensor(x))
    assert torch.equal(y, banded.FlatBandedOperator(D, bws, ns)(
        torch.as_tensor(x)))
    jy = np.asarray(jbanded.BandedOperator(Db, bws, ns)(jnp.asarray(x)))
    assert np.abs(y.numpy() - jy).max() <= 1e-13 * np.abs(jy).max()


def _zero_padding(Db, bws, ns):
    """Banded data ``(b_1.., n_1..)`` with the entries whose column
    ``j_k = i_k + mu_k - b_k`` leaves the grid set to zero."""
    d = len(ns)
    for k, (b, n) in enumerate(zip(bws, ns)):
        mu = np.arange(2 * b + 1)[:, None]
        j = np.arange(n)[None, :] + mu - b
        shape = [1] * (2 * d)
        shape[k], shape[d + k] = 2 * b + 1, n
        Db = Db * ((j >= 0) & (j < n)).reshape(shape)
    return Db
