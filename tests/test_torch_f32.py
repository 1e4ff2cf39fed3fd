"""The f32 line of the PyTorch port held against the JAX package under
``set_dtype(np.float32)``: the dtype and config API, the float32 compact
and banded assemblies (K1 / K2 / K3's float32 instances run their plain
versions here), the float32 CG against ``cg_jit`` on the same operator,
local MG and the differentiable assembly under float32 against the JAX
package's, TF32 pinned off, the
memoized operands per dtype, and the float32 wrappers' CUDA branch
driven through a stand-in library."""

import contextlib
import ctypes
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pyiga_tpu
import pyiga_tpu.bspline as jbspline
import pyiga_tpu.geometry as jgeometry
import pyiga_tpu.hierarchical as jhier
import pyiga_tpu.vform as jvform
from pyiga_tpu import diff as jdiff
from pyiga_tpu import solvers as jsolvers
from pyiga_tpu.assemblers import MassAssembler as JMassAssembler
from pyiga_tpu.assemblers import StiffnessAssembler as JStiffnessAssembler
from pyiga_tpu.ops import banded as jbanded
from pyiga_tpu.ops import fastdiag as jfastdiag
from pyiga_tpu.ops import matfree as jmatfree

import pyiga_tpu_torch
from pyiga_tpu_torch import (_cuda, bspline, config, geometry, hierarchical,
                             solvers, vform)
from pyiga_tpu_torch.diff import assembly_coeff_fn
from pyiga_tpu_torch.assemblers import MassAssembler, StiffnessAssembler
from pyiga_tpu_torch.ops import cuda_sumfac, fastdiag, matfree, sumfac

from test_torch_hierarchical import example_hspace

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64
ASSEMBLERS = {'stiffness': (StiffnessAssembler, JStiffnessAssembler),
              'mass': (MassAssembler, JMassAssembler)}


@pytest.fixture(autouse=True)
def float64_after():
    """Every test leaves both packages at float64, whatever it raised."""
    yield
    pyiga_tpu.set_dtype(np.float64)
    pyiga_tpu_torch.set_dtype(np.float64)


def _f32():
    pyiga_tpu.set_dtype(np.float32)
    pyiga_tpu_torch.set_dtype(np.float32)


def _pair(kind, name, p, n):
    geo, jgeo = getattr(geometry, name)(), getattr(jgeometry, name)()
    cls, jcls = ASSEMBLERS[kind]
    asm = cls(geo.sdim * (bspline.make_knots(p, 0.0, 1.0, n),), geo,
              device='cpu')
    jasm = jcls(jgeo.sdim * (jbspline.make_knots(p, 0.0, 1.0, n),), jgeo)
    return asm, jasm


def _compact_from_flat(asm, D):
    """The compact data tensor from a flat banded ``(C, F)`` layout."""
    bws = [int(b) for b in jbanded.band_info(asm.structure)]
    ns = [b[0] for b in asm.structure.bs]
    d = len(ns)
    R = D.reshape([2 * b + 1 for b in bws] + ns)
    # (b_1, ..., b_d, n_1, ..., n_d) -> banded-flat (b_1 n_1, ..., b_d n_d)
    Z = R.permute([x for k in range(d) for x in (k, d + k)]).reshape(
        [(2 * b + 1) * n for b, n in zip(bws, ns)])
    maps = sumfac.compact_from_banded_maps(asm.structure, bws)
    return Z[np.ix_(*maps)]


# -- the dtype and config API ------------------------------------------------

TORCH_OF = {np.float32: F32, np.float64: F64}


@pytest.mark.parametrize('form', [np.float32, np.float64, 'float32',
                                  'float64', np.dtype('float32'),
                                  np.dtype('float64'), jnp.float32,
                                  jnp.float64])
def test_dtype_api_matches_jax(form):
    pyiga_tpu.set_dtype(form)
    pyiga_tpu_torch.set_dtype(form)
    assert pyiga_tpu_torch.get_dtype() == TORCH_OF[pyiga_tpu.get_dtype()]
    assert pyiga_tpu_torch.get_dtype() is config.get_dtype()
    assert pyiga_tpu_torch.default_assembly_mode() == \
        pyiga_tpu.config.default_assembly_mode() == 'exact'


@pytest.mark.parametrize('form', [F32, F64])
def test_set_dtype_takes_torch_dtypes(form):
    pyiga_tpu_torch.set_dtype(form)
    assert pyiga_tpu_torch.get_dtype() is form
    assert pyiga_tpu_torch.default_assembly_mode() == 'exact'


@pytest.mark.parametrize('form', [np.int32, 'float16', torch.int64,
                                  torch.bfloat16])
def test_set_dtype_refuses_other_dtypes(form):
    with pytest.raises(ValueError, match='float32 or float64'):
        pyiga_tpu_torch.set_dtype(form)
    assert pyiga_tpu_torch.get_dtype() is F64


def test_max_threads_match_jax():
    import pyiga_tpu.config as jconfig
    assert pyiga_tpu_torch.get_max_threads() == \
        pyiga_tpu.get_max_threads() == (os.cpu_count() or 1)
    saved = pyiga_tpu.get_max_threads()
    try:
        for n in (3, '5'):
            pyiga_tpu.set_max_threads(n)
            pyiga_tpu_torch.set_max_threads(n)
            assert pyiga_tpu_torch.get_max_threads() == \
                jconfig.get_max_threads() == int(n)
    finally:
        pyiga_tpu.set_max_threads(saved)
        pyiga_tpu_torch.set_max_threads(saved)


# -- the float32 assemblies against the JAX package's -------------------------

CASES = [('twisted_box', 2, 5), ('twisted_box', 3, 6),
         ('quarter_annulus', 3, 12)]


@pytest.mark.parametrize('kind', ['stiffness', 'mass'])
@pytest.mark.parametrize('name,p,n', CASES)
def test_f32_assembly_matches_jax(kind, name, p, n):
    asm, jasm = _pair(kind, name, p, n)
    _f32()
    data = asm.run_device()
    jdata = jasm.assemble().data            # float64 holding float32 values
    assert data.dtype == F32 and jdata.dtype == np.float64
    scale = np.abs(jdata).max()
    assert np.abs(data.numpy() - jdata).max() <= 2e-6 * scale
    mlm = asm.assemble()
    assert mlm.data.dtype == np.float64
    assert np.array_equal(mlm.data, data.numpy().astype(np.float64))
    op = asm.assemble_banded()
    assert op.D.dtype == F32 and op.dtype == F32
    banded = _compact_from_flat(asm, op.D)
    assert banded.dtype == F32
    assert np.abs(banded.numpy() - jdata).max() <= 2e-6 * scale
    # the float64 line of the same assembler is untouched
    pyiga_tpu_torch.set_dtype(np.float64)
    pyiga_tpu.set_dtype(np.float64)
    d64 = asm.run_device()
    assert d64.dtype == F64
    assert np.abs(d64.numpy() - jasm.assemble().data).max() <= 1e-13 * scale


def test_f32_fields_compute_in_float32():
    """K1's float32 plain version is not the float64 one rounded: it
    computes from the float32 geometry partials."""
    asm, _ = _pair('stiffness', 'twisted_box', 3, 6)
    args64, _ = cuda_sumfac._spline_stages(asm.geo_inputs(F64))
    args32, _ = cuda_sumfac._spline_stages(asm.geo_inputs(F32))
    for fn in (cuda_sumfac.fields, cuda_sumfac.fields_mass):
        f64, f32 = fn(*args64), fn(*args32)
        assert f32.dtype == F32
        assert (f32.double() - f64).abs().max() <= 2e-6 * f64.abs().max()
        assert not torch.equal(f32, f64.float())


@pytest.mark.parametrize('K,R,M,terms,tables', [(2, 24, 19, 1, 1),
                                                (33, 300, 70, 3, 2),
                                                (192, 130, 357, 6, 3)])
def test_plain_stage_fold_f32_vs_f64(K, R, M, terms, tables):
    rng = np.random.RandomState(K)
    xs = [rng.rand(K, R) for _ in range(terms)]
    tabs = [rng.rand(M, K) for _ in range(tables)]
    idx = [t % tables for t in range(terms)]
    for dt in (F32, F64):
        x = [torch.as_tensor(a, dtype=dt) for a in xs]
        t = [torch.as_tensor(a, dtype=dt) for a in tabs]
        st = cuda_sumfac.stage(x[0], t[0])
        fo = cuda_sumfac.fold(x, t, idx)
        assert st.dtype == fo.dtype == dt
        if dt == F32:
            st32, fo32 = st, fo
    for a, b in ((st32, st), (fo32, fo)):
        assert (a.double() - b).abs().max() <= 1e-6 * b.abs().max()


# -- the float32 solve against JAX's cg_jit ----------------------------------

@pytest.mark.parametrize('name,p,n', CASES)
def test_f32_cg_count_matches_jax(name, p, n):
    asm, jasm = _pair('stiffness', name, p, n)
    _f32()
    op = asm.assemble_banded()
    free = fastdiag.interior_dofs(asm.kvs)
    b = np.random.RandomState(0).rand(len(free)).astype(np.float32)
    P = fastdiag.fastdiag_precond_weighted(asm, dirichlet=True)
    x, it = solvers.cg(matfree.RestrictedOperator(op, free),
                       torch.as_tensor(b), tol=1e-8, maxiter=600, precond=P)
    assert x.dtype == F32 and P(torch.as_tensor(b)).dtype == F32
    D = op.D.numpy().reshape(tuple(2 * bw + 1 for bw in op.bws) + op.ns)
    jP = jfastdiag.fastdiag_precond_weighted(jasm, dirichlet=True,
                                             dtype=np.float32)
    jx, jit = jsolvers.cg_jit(
        jmatfree.RestrictedOperator(jbanded.BandedOperator(D, op.bws, op.ns),
                                    free, int(np.prod(op.ns))),
        jnp.asarray(b), tol=1e-8, maxiter=600, precond=jP)
    assert it == int(jit) < 600
    jx = np.asarray(jx)
    assert np.abs(x.numpy() - jx).max() <= 1e-4 * np.abs(jx).max()


# -- local MG and the differentiable assembly under float32 ----------------

def _hb_problem(geo_name):
    """The HB example of ``tests/test_torch_hierarchical.py`` (p=3, n0=6,
    3 levels) discretized by both packages under the current dtype:
    ``(hs, jhs, A, f, jA, jf)``, the port's matrix assembled on the CPU."""
    hs = example_hspace(hierarchical, bspline)
    jhs = example_hspace(jhier, jbspline)
    hd = hierarchical.HDiscretization(
        hs, vform.stiffness_vf(dim=2),
        {'geo': getattr(geometry, geo_name)(), 'f': lambda *x: 1.0},
        device='cpu')
    jhd = jhier.HDiscretization(
        jhs, jvform.stiffness_vf(dim=2),
        {'geo': getattr(jgeometry, geo_name)(), 'f': lambda *x: 1.0})
    return (hs, jhs, hd.assemble_matrix().tocsr(), hd.assemble_rhs(),
            jhd.assemble_matrix().tocsr(), jhd.assemble_rhs())


def _f32_against_f64(assemble_f32_and_f64):
    """The float32 assembly (float64 entries) within 1e-6 of the float64
    one and not equal to it: it was computed in float32."""
    _f32()
    A32 = assemble_f32_and_f64()
    pyiga_tpu.set_dtype(np.float64)
    pyiga_tpu_torch.set_dtype(np.float64)
    A64 = assemble_f32_and_f64()
    _f32()
    assert A32.dtype == A64.dtype == np.float64
    err = abs(A32 - A64).max() / abs(A64).max()
    assert 0 < err < 1e-6


def _localmg_run():
    """``solve_hmultigrid`` under float32 on the quarter-annulus HB
    example: the JAX package's count (35) on the same float32-assembled
    matrix and on its own, by both of the port's routes, the solutions
    within 1e-10."""
    _f32()
    hs, jhs, A, f, jA, jf = _hb_problem('quarter_annulus')
    _f32_against_f64(lambda: _hb_problem('quarter_annulus')[2])
    assert abs(A - jA).max() <= 1e-6 * abs(jA).max()
    ju, jit = jsolvers.solve_hmultigrid(jhs, A, f, tol=1e-8,
                                        relax_backend='host')
    _jo, jit_own = jsolvers.solve_hmultigrid(jhs, jA, jf, tol=1e-8,
                                             relax_backend='host')
    u_h, it_h = solvers.solve_hmultigrid(hs, A, f, tol=1e-8,
                                         relax_backend='host')
    u_d, it_d = solvers.solve_hmultigrid(hs, A, f, tol=1e-8,
                                         relax_backend='device',
                                         device='cpu')
    assert it_h == it_d == jit == jit_own == 35
    assert u_h.dtype == u_d.dtype == np.float64
    for u in (u_h, u_d):
        assert np.abs(u - ju).max() <= 1e-10 * np.abs(ju).max()


def _localmg_step_run():
    """``local_mg_step`` under float32 on the unit-square HB example,
    iterated by ``iterative_solve``: the JAX package's count (27) on the
    same float32-assembled matrix, the solution within 1e-10."""
    _f32()
    hs, jhs, A, f, jA, jf = _hb_problem('unit_square')
    assert abs(A - jA).max() <= 1e-6 * abs(jA).max()
    ju, jit = jsolvers.solve_hmultigrid(jhs, A, f, tol=1e-8,
                                        relax_backend='host')
    Ps = hs.virtual_hierarchy_prolongators()
    step = solvers.local_mg_step(hs, A, f, Ps, hs.indices_to_smooth(
        'cell_supp'), 'gs', 2, relax_backend='host')
    u, it = solvers.iterative_solve(step, A, f,
                                    active_dofs=hs.non_dirichlet_dofs(),
                                    tol=1e-8)
    assert it == jit == 27
    assert np.abs(u - ju).max() <= 1e-10 * np.abs(ju).max()


def _diff_run():
    """``assembly_coeff_fn`` under float32: the float32 data and the
    gradient of a weighted sum against ``pyiga_tpu.diff`` under float32
    (2e-5 relative), the gradient in the leaf's dtype."""
    asm, jasm = _pair('stiffness', 'quarter_annulus', 2, 4)
    _f32()
    fn, c0 = assembly_coeff_fn(asm)
    jfn, _ = jdiff.assembly_coeff_fn(jasm)
    x = torch.tensor(np.asarray(c0, dtype=float), requires_grad=True)
    out = fn(x)
    w = np.random.RandomState(42).rand(*out.shape)
    (torch.as_tensor(w, dtype=F32) * out).sum().backward()
    jval = np.asarray(jfn(jnp.asarray(c0)))
    jg = np.asarray(jax.grad(lambda c: jnp.sum(
        jnp.asarray(w, dtype=jnp.float32) * jfn(c)))(
            jnp.asarray(c0, dtype=jnp.float64)))
    assert out.dtype == F32 and jval.dtype == np.float32
    assert x.grad.dtype == F64
    val = out.detach().double().numpy()
    assert np.abs(val - jval).max() <= 2e-5 * np.abs(jval).max()
    g = x.grad.numpy()
    assert np.abs(g - jg).max() <= 2e-5 * np.abs(jg).max()


def _stretched_square():
    """``(x, 2 y)`` as a host-evaluated geometry (area 2)."""
    def jac(x, y):
        x, y = np.broadcast_arrays(x, y)
        one, zero = np.ones_like(x), np.zeros_like(x)
        return np.stack([np.stack([one, zero], axis=-1),
                         np.stack([zero, 2 * one], axis=-1)], axis=-2)
    return geometry.UserFunction(lambda x, y: (x, 2 * y), [[0, 1], [0, 1]],
                                 jac=jac)


@pytest.mark.parametrize('run', [_diff_run, _localmg_run, _localmg_step_run])
def test_f32_localmg_and_diff_match_jax(run):
    """Local MG runs under float32 (the float64 solve of the float32
    assembly, as the JAX package's), and so does the differentiable
    assembly; each against the JAX package under float32."""
    run()


def test_k7_refuses_float32_and_f32_chains_skip_it(monkeypatch):
    rng = np.random.RandomState(2)
    X = torch.as_tensor(rng.rand(5, 7), dtype=F32)
    T = torch.as_tensor(rng.rand(3, 5), dtype=F32)
    with pytest.raises(NotImplementedError, match='float64 only'):
        cuda_sumfac.stage_T(X, T)
    with pytest.raises(NotImplementedError, match='float64 only'):
        cuda_sumfac.tail_fused([X.reshape(5, 7, 1)], [T], [T], [0], [0])
    asm, _ = _pair('stiffness', 'twisted_box', 3, 6)
    _f32()
    ref = asm.assemble_banded().D
    monkeypatch.setattr(cuda_sumfac, 'TAIL_FUSED', True)
    got = asm.assemble_banded().D
    assert got.dtype == F32 and torch.equal(got, ref)


# -- TF32 pinned off; operands memoized per dtype ---------------------------

def test_no_tf32_restores_the_settings():
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cudnn.allow_tf32)
    try:
        torch.set_float32_matmul_precision('medium')
        torch.backends.cudnn.allow_tf32 = True
        with config.no_tf32():
            assert torch.get_float32_matmul_precision() == 'highest'
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.get_float32_matmul_precision() == 'medium'
        assert torch.backends.cudnn.allow_tf32
        with pytest.raises(RuntimeError):
            with config.no_tf32():
                raise RuntimeError('inside')
        assert torch.get_float32_matmul_precision() == 'medium'
        with config.no_tf32(F64):          # float64 operands: untouched
            assert torch.get_float32_matmul_precision() == 'medium'
        # the f32 plain versions run under it and leave the caller's
        # setting as they found it
        X = torch.ones(3, 4)
        assert cuda_sumfac.stage_plain(X, torch.ones(2, 3)).dtype == F32
        assert torch.get_float32_matmul_precision() == 'medium'
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]


def test_memoized_operands_follow_the_dtype():
    asm, _ = _pair('stiffness', 'twisted_box', 2, 5)
    d64 = asm.run_device()
    tabs64 = asm._compact_operands()['term_tables']
    _f32()
    d32 = asm.run_device()
    tabs32 = asm._compact_operands()['term_tables']
    assert d64.dtype == F64 and d32.dtype == F32
    assert all(T.dtype == F64 for tabs in tabs64 for T in tabs)
    assert all(T.dtype == F32 for tabs in tabs32 for T in tabs)
    assert all(v.dtype == F32 for v in asm.geo_inputs()['weights'])
    pyiga_tpu_torch.set_dtype(np.float64)
    assert asm._compact_operands()['term_tables'] is tabs64
    assert torch.equal(asm.run_device(), d64)


def test_host_jacobian_cached_per_dtype():
    asm = MassAssembler(2 * (bspline.make_knots(2, 0.0, 1.0, 4),),
                        _stretched_square(), device='cpu')
    j64 = asm.geo_inputs()['jac']
    assert asm.geo_inputs()['jac'] is j64 and j64.dtype == F64
    _f32()
    j32 = asm.geo_inputs()['jac']
    assert j32.dtype == F32 and asm.geo_inputs()['jac'] is j32
    # the mass fields of a host Jacobian need no kernel: float32 runs
    assert asm.run_device().dtype == F32
    assert abs(float(asm.run_device().sum()) - 2.0) < 1e-5


# -- the float32 wrappers' CUDA branch through a stand-in library ------------

def _arr(ptr, dtype, *shape):
    ct = ctypes.c_float if dtype == np.float32 else ctypes.c_double
    buf = (ct * int(np.prod(shape))).from_address(ptr)
    return np.ctypeslib.as_array(buf).reshape(shape)


class _FakeLibrary:
    """The float32 C entries of K1, K2 and K3 (and K2's float64 one) on
    host memory: each reads its operands from the pointers it is handed
    and writes the plain version's result; records each call."""

    def __init__(self):
        self.calls = []
        self.fold_terms = []

    def _fields(self, kind, Y, T, w12, wL, out, d, nurbs, Q12, QL, nL, s):
        self.calls.append(kind)
        C = d + nurbs
        args = [torch.as_tensor(_arr(p, np.float32, *sh)) for p, sh in
                ((Y, (d, C, Q12, nL)), (T, (2, QL, nL)), (w12, (Q12,)),
                 (wL, (QL,)))]
        plain = (cuda_sumfac.fields_plain if kind == 'stiffness'
                 else cuda_sumfac.fields_mass_plain)
        res = plain(*args, bool(nurbs)).numpy()
        _arr(out, np.float32, *res.shape)[...] = res
        return 0

    def pyiga_stiff_fields_f32(self, *a):
        return self._fields('stiffness', *a)

    def pyiga_mass_fields_f32(self, *a):
        return self._fields('mass', *a)

    def _stage(self, dtype, name, X, T, out, K, R, M, s):
        self.calls.append(name)
        _arr(out, dtype, R, M)[...] = (_arr(X, dtype, K, R).T
                                       @ _arr(T, dtype, M, K).T)
        return 0

    def pyiga_stage_f32(self, *a):
        return self._stage(np.float32, 'stage_f32', *a)

    def pyiga_stage_f64(self, *a):
        return self._stage(np.float64, 'stage_f64', *a)

    def pyiga_fold_f32(self, xp, tp, n, out, K, R, M, s):
        """The kernel's order: the terms grouped by table pointer (groups
        in order of first appearance), a group's fields summed in term
        order before its one product, the groups' products added in
        order; at most 16 terms a call."""
        self.calls.append('fold_f32')
        self.fold_terms.append(n)
        assert 1 <= n <= 16
        xs = ctypes.cast(xp, ctypes.POINTER(ctypes.c_uint64))
        ts = ctypes.cast(tp, ctypes.POINTER(ctypes.c_uint64))
        groups = {}
        for t in range(n):
            groups.setdefault(ts[t], []).append(t)
        o = _arr(out, np.float32, R, M)
        o[...] = 0
        for tab, terms in groups.items():
            S = _arr(xs[terms[0]], np.float32, K, R).copy()
            for t in terms[1:]:
                S += _arr(xs[t], np.float32, K, R)
            o += S.T @ _arr(tab, np.float32, M, K).T
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors: the device test forced,
    the library replaced by :class:`_FakeLibrary`, and every operand
    check recorded with the dtype it asks for."""
    lib = _FakeLibrary()
    lib.required = []
    monkeypatch.setattr(cuda_sumfac, '_kernel_device', lambda t, n: True)
    monkeypatch.setattr(_cuda, 'library', lambda: lib)
    monkeypatch.setattr(_cuda, 'require',
                        lambda t, name, dt, nd: lib.required.append(
                            (name, dt, t.dtype)))
    monkeypatch.setattr(_cuda, 'device_of',
                        lambda t: contextlib.nullcontext())
    monkeypatch.setattr(_cuda, 'stream_of', lambda t: 0)
    _cuda.reset_launches()
    return lib


def test_f32_wrappers_launch_the_float32_entries(fake_card):
    asm, _ = _pair('stiffness', 'twisted_box', 3, 6)
    _f32()
    op = asm.assemble_banded()
    assert op.D.dtype == F32
    assert fake_card.calls.count('stiffness') == 1
    assert set(fake_card.calls) == {'stiffness', 'stage_f32', 'fold_f32'}
    assert _cuda.LAUNCHES['fields_f32'] == 1
    assert _cuda.LAUNCHES['stage_f32'] == fake_card.calls.count('stage_f32')
    assert _cuda.LAUNCHES['fold_f32'] == 1
    assert all(_cuda.LAUNCHES[k] == 0 for k in ('fields', 'stage', 'fold'))
    assert all(dt == F32 and got == F32
               for _n, dt, got in fake_card.required)
    mass, _ = _pair('mass', 'twisted_box', 3, 6)
    mass.assemble_banded()
    assert _cuda.LAUNCHES['mass_fields_f32'] == 1
    pyiga_tpu_torch.set_dtype(np.float64)
    fake_card.required.clear()
    X = torch.as_tensor(np.random.RandomState(1).rand(4, 6))
    T = torch.as_tensor(np.random.RandomState(2).rand(3, 4))
    got = cuda_sumfac.stage(X, T)
    assert fake_card.calls[-1] == 'stage_f64' and got.dtype == F64
    assert _cuda.LAUNCHES['stage'] == 1
    assert all(dt == F64 for _n, dt, _g in fake_card.required)
    assert torch.allclose(got, cuda_sumfac.stage_plain(X, T), rtol=1e-14)


# -- the float32 fold at ragged shapes against the JAX package -----------------

# (K, R, M): odd R and R % 4 = 1, 2, 3; K not a multiple of the kernel's
# k slice (8); M = 385, 1, 357
F32_RAGGED = [(13, 1001, 385), (37, 4098, 1), (203, 515, 357)]
# per term its table: one term; a table repeated out of order; 17 terms
# over 3 tables, which the wrapper splits into launches of 16 and 1
F32_PATTERNS = {'stage': (0,), 'repeat': (0, 1, 0, 2, 1, 2),
                'split': tuple(t % 3 for t in range(17))}
# float32 sums of at most K + 17 non-negative products and terms, each
# rounding 2^-24 relative: ~1e-6 relative to the largest entry expected,
# 1e-5 allowed
F32_RAGGED_TOL = 1e-5


def _ragged_operands(K, R, M, idx):
    rng = np.random.RandomState(K * R + M + len(idx))
    xs = [rng.rand(K, R).astype(np.float32) for _ in idx]
    tabs = [rng.rand(M, K).astype(np.float32) for _ in range(max(idx) + 1)]
    return xs, tabs


def _jax_f32_fold(xs, tabs, idx):
    """The JAX package's float32 fold: ``assemble_terms_folded(mode=
    'exact')`` over one-table chains (each term's field transposed to
    ``(R, K)``), the terms of a table summed before ``_contract_last``."""
    from pyiga_tpu.ops import sumfac as jsumfac
    jt = [jnp.asarray(T) for T in tabs]
    out = jsumfac.assemble_terms_folded(
        [[jt[i]] for i in idx], [jnp.asarray(X.T) for X in xs],
        [(t, False) for t in range(len(idx))], None, mode='exact',
        last_idx=tuple(idx))
    assert out.dtype == jnp.float32
    return np.asarray(out)


def _per_table_first(xs, tabs, idx):
    """The kernel's order of summation in float32 torch: each table's
    fields summed in term order, one product a table, tables in order of
    first appearance."""
    out = None
    for i in dict.fromkeys(idx):
        S = None
        for X, j in zip(xs, idx):
            if j == i:
                S = torch.as_tensor(X) if S is None else S + torch.as_tensor(X)
        Y = cuda_sumfac.stage_plain(S, torch.as_tensor(tabs[i]))
        out = Y if out is None else out + Y
    return out


def _close(got, ref):
    ref = np.asarray(ref, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= F32_RAGGED_TOL * np.abs(ref).max()


@pytest.mark.parametrize('pattern', sorted(F32_PATTERNS))
@pytest.mark.parametrize('K,R,M', F32_RAGGED)
def test_f32_fold_plain_at_ragged_shapes_matches_jax(K, R, M, pattern):
    """The plain float32 stage and fold (term by term) against the JAX
    package's float32 ``_contract_last`` / ``assemble_terms_folded``, and
    against the same sum taken per table first, the kernel's order."""
    from pyiga_tpu.ops import sumfac as jsumfac
    idx = F32_PATTERNS[pattern]
    xs, tabs = _ragged_operands(K, R, M, idx)
    tx, tt = [torch.as_tensor(X) for X in xs], [torch.as_tensor(T)
                                                for T in tabs]
    ref = _jax_f32_fold(xs, tabs, idx)
    got = cuda_sumfac.fold(tx, tt, list(idx))
    assert got.dtype == F32
    _close(got, ref)
    _close(got, _per_table_first(xs, tabs, idx))
    if pattern == 'stage':
        st = cuda_sumfac.stage(tx[0], tt[0])
        _close(st, np.asarray(jsumfac._contract_last(
            jnp.asarray(xs[0].T), jnp.asarray(tabs[0]))))
        assert torch.equal(st, got)


@pytest.mark.parametrize('pattern', sorted(F32_PATTERNS))
@pytest.mark.parametrize('K,R,M', F32_RAGGED)
def test_f32_fold_wrapper_at_ragged_shapes(fake_card, K, R, M, pattern):
    """The float32 fold's CUDA branch through a stand-in library that sums
    in the kernel's order: 17 terms go out as launches of 16 and 1, a
    table repeated out of order is one group, and the result equals the
    JAX package's float32 fold."""
    idx = F32_PATTERNS[pattern]
    xs, tabs = _ragged_operands(K, R, M, idx)
    tx, tt = [torch.as_tensor(X) for X in xs], [torch.as_tensor(T)
                                                for T in tabs]
    got = cuda_sumfac.fold(tx, tt, list(idx))
    assert got.dtype == F32 and got.shape == (R, M)
    assert fake_card.fold_terms == ([16, 1] if len(idx) > 16
                                    else [len(idx)])
    assert _cuda.LAUNCHES['fold_f32'] == len(fake_card.fold_terms)
    assert _cuda.LAUNCHES['fold'] == 0
    assert all(dt == F32 and g == F32 for _n, dt, g in fake_card.required)
    _close(got, _jax_f32_fold(xs, tabs, idx))
    if len(idx) <= 16:
        _close(got, _per_table_first(xs, tabs, idx))
    st = cuda_sumfac.stage(tx[0], tt[0])
    assert fake_card.calls[-1] == 'stage_f32'
    _close(st, _jax_f32_fold(xs[:1], tabs, idx[:1]))
