"""Low-rank (ACA) assembly of the PyTorch port held against the JAX
package on the CPU: the host drivers on the same seeded arrays, the
tensor generators, ``compact_slice`` (1e-13 relative) and
``multi_entries``, ``mass_fast`` / ``stiffness_fast`` against the golden
fixtures (1e-9), and ``aca_3d_device`` against the JAX drivers (the same
pivot count, 1e-9 relative to the largest entry)."""

import os.path
import subprocess
import sys

import numpy as np
import pytest
import torch

import pyiga_tpu.bspline as jbspline
import pyiga_tpu.compile as jcompile
import pyiga_tpu.geometry as jgeometry
import pyiga_tpu.lowrank as jlowrank
import pyiga_tpu.tensor as jtensor
import pyiga_tpu.utils as jutils
import pyiga_tpu.vform as jvform

from pyiga_tpu_torch import (_cuda, assemble, bspline, compile as tcompile,
                             geometry, lowrank, native, tensor, utils, vform)

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), 'fixtures')
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lowrank(rng, m, n, r):
    return rng.rand(m, r) @ rng.rand(r, n)


def _tensor(rng, shape, r):
    return sum(np.einsum('i,j,k->ijk', *(rng.rand(n) for n in shape))
               for _ in range(r))


def test_host_helpers_match_jax():
    rng = np.random.RandomState(0)
    arrays = [np.arange(3), np.array([5, 1]), np.arange(4) * 2]
    assert np.array_equal(utils.cartesian_product(arrays),
                          jutils.cartesian_product(arrays))
    xs = [rng.rand(3), rng.rand(4), rng.rand(2)]
    assert np.array_equal(tensor.outer(*xs), jtensor.outer(*xs))
    for I in [(1, slice(None), [0, 2]), slice(1, 3), (-1, 2)]:
        got, ref = (tensor._normalize_indices(I, (3, 4, 5)),
                    jtensor._normalize_indices(I, (3, 4, 5)))
        assert [list(a) for a in got[0]] == [list(a) for a in ref[0]]
        assert got[1:] == ref[1:]
    A = rng.rand(7, 6)
    u, v = rng.rand(7), rng.rand(6)
    B = A.copy()
    assert native.rank_1_update(B, 0.7, u, v) is B
    assert np.allclose(B, A + 0.7 * np.outer(u, v), rtol=1e-15)
    C = np.asfortranarray(A)            # the numpy fallback
    native.rank_1_update(C, 0.7, u, v)
    assert np.allclose(C, B, rtol=1e-15)


def test_tensor_sum_and_prod_match_jax():
    rng = np.random.RandomState(1)
    terms = [(rng.rand(4), rng.rand(5, 3)) for _ in range(3)]
    X = tensor.TensorSum(*(tensor.TensorProd(c, M) for c, M in terms))
    J = jtensor.TensorSum(*(jtensor.TensorProd(c, M) for c, M in terms))
    assert X.shape == J.shape == (4, 5, 3)
    assert np.allclose(X.asarray(), J.asarray(), rtol=1e-15)
    assert np.allclose((X - X).asarray(), 0.0)
    assert np.isclose(X[1, 2, 0], J[1, 2, 0])
    assert np.allclose(X[:, 1:3, 2].asarray(), J[:, 1:3, 2].asarray())
    assert np.isclose(X.norm(), J.norm())
    with pytest.raises(ValueError):
        tensor.TensorSum(tensor.TensorProd(rng.rand(2), rng.rand(3)),
                         tensor.TensorProd(rng.rand(3), rng.rand(2)))


@pytest.mark.parametrize('driver', ['aca', 'aca_lr'])
def test_aca_2d_matches_jax(driver):
    rng = np.random.RandomState(2)
    A = _lowrank(rng, 60, 50, 5)
    np.random.seed(3)
    got = getattr(lowrank, driver)(A, tol=1e-12, verbose=0)
    np.random.seed(3)
    ref = getattr(jlowrank, driver)(A, tol=1e-12, verbose=0)
    if driver == 'aca_lr':
        assert len(got) == len(ref)
        got = sum(np.outer(c, r) for c, r in got)
        ref = sum(np.outer(c, r) for c, r in ref)
    assert np.abs(got - ref).max() < 1e-13
    assert np.allclose(A, got, atol=1e-10)
    # a generator and a start value
    gen = lowrank.MatrixGenerator.from_array(A)
    assert np.array_equal(gen.row(3), A[3]) and np.array_equal(
        gen.column(7), A[:, 7])
    assert gen.entry((2, 3)) == A[2, 3]
    X = lowrank.aca(gen, tol=1e-12, verbose=0, startval=0.5 * A)
    assert np.allclose(A, X, atol=1e-10)


@pytest.mark.parametrize('slices', ['materialize', 'aca'])
@pytest.mark.parametrize('lr', [False, True])
def test_aca_3d_matches_jax(slices, lr):
    rng = np.random.RandomState(4)
    T = _tensor(rng, (20, 21, 22), 3)
    out = {}
    for mod in (lowrank, jlowrank):
        np.random.seed(5)
        X = mod.aca_3d(T, tol=1e-12, verbose=0, lr=lr, slices=slices)
        if lr:
            assert type(X).__name__ == 'TensorSum'
            out[mod] = (len(X.Xs), X.asarray())
        else:
            out[mod] = (None, X)
    (kg, Xg), (kr, Xr) = out[lowrank], out[jlowrank]
    assert kg == kr
    assert np.abs(Xg - Xr).max() < 1e-13 and np.allclose(T, Xg, atol=1e-9)
    # a zero tensor takes no cross
    Z = lowrank.aca_3d(np.zeros((3, 4, 5)), verbose=0, lr=lr, slices=slices)
    assert np.array_equal(tensor.asarray(Z), np.zeros((3, 4, 5)))


def test_tensor_generator_indices_match_jax():
    rng = np.random.RandomState(7)
    X = rng.random((3, 4, 5))
    gens = [mod.TensorGenerator.from_array(X) for mod in (lowrank, jlowrank)]
    for I in [(1, slice(None), 2), (slice(None), [0, 2], slice(1, 4)),
              (2, [3], [0, 4]), (0, 1, 2)]:
        got, ref = (np.asarray(g[I]) for g in gens)
        assert got.shape == ref.shape and np.array_equal(got, ref)
    assert np.array_equal(gens[0].asarray(), X)
    M = gens[0].matrix_at((0, 1, 2), axes=(1, 2))
    assert np.array_equal(M[:, 4], X[0, :, 4])
    assert np.array_equal(M[3, :], X[0, 3, :])
    # entry-function generators take the multi-entry path
    E = lowrank.TensorGenerator(X.shape, entryfunc=lambda I: X[tuple(I)])
    assert np.array_equal(E[:, 1, [0, 3]], X[:, 1][:, [0, 3]])
    assert np.array_equal(E.asarray(), X)


def _assemblers(dim, n, p=2, form='stiffness'):
    """The port's and the JAX package's compiled assemblers of a scalar
    form on the twisted box (3D) or the quarter annulus (2D)."""
    vfs = {'stiffness': 'stiffness_vf', 'mass': 'mass_vf'}
    kvs = dim * (bspline.make_knots(p, 0.0, 1.0, n),)
    jkvs = dim * (jbspline.make_knots(p, 0.0, 1.0, n),)
    geo = geometry.twisted_box() if dim == 3 else geometry.quarter_annulus()
    jgeo = jgeometry.twisted_box() if dim == 3 else \
        jgeometry.quarter_annulus()
    asm = tcompile.compile_vform(getattr(vform, vfs[form])(dim))(
        kvs, geo=geo, device='cpu')
    jasm = jcompile.compile_vform(getattr(jvform, vfs[form])(dim))(
        jkvs, geo=jgeo)
    return asm, jasm


@pytest.mark.parametrize('dim', [2, 3])
@pytest.mark.parametrize('form', ['stiffness', 'mass'])
def test_compact_slice_matches_jax(dim, form):
    asm, jasm = _assemblers(dim, 6 if dim == 3 else 9, form=form)
    shape = tuple(len(bx) for bx in asm.structure.bidx)
    rng = np.random.RandomState(dim)
    full = asm.compact_slice({})
    ref = asm.run_device()[(None, None)].numpy()
    scale = np.abs(ref).max()
    assert full.shape == shape and np.abs(full - ref).max() <= 1e-13 * scale
    patterns = [()] + [(k,) for k in range(dim)] + \
        [tuple(a for a in range(dim) if a != k) for k in range(dim)]
    for axes in set(patterns):
        fixed = {ax: int(rng.randint(shape[ax])) for ax in axes}
        got, jref = asm.compact_slice(fixed), jasm.compact_slice(fixed)
        assert got.shape == jref.shape
        assert np.abs(got - jref).max() <= 1e-13 * scale, axes
    # an update drops the cached fields
    fields = asm._slice_operands()[0]
    asm.update(geo=geometry.twisted_box() if dim == 3
               else geometry.quarter_annulus())
    assert asm._slice_operands()[0] is not fields


def test_multi_entries_matches_jax():
    asm, jasm = _assemblers(2, 7)
    A = asm.assemble().asmatrix('csr')
    rng = np.random.RandomState(8)
    idx = np.stack([rng.randint(A.shape[0], size=40),
                    rng.randint(A.shape[1], size=40)], axis=1)
    got, ref = asm.multi_entries(idx), jasm.multi_entries(idx)
    assert np.abs(got - ref).max() <= 1e-13 * np.abs(A).max()
    assert np.array_equal(got, np.asarray(A[idx[:, 0], idx[:, 1]]).ravel())
    with pytest.raises(ValueError):
        asm.multi_blocks(idx)       # a scalar form has no component blocks
    # a vector form's blocks at the same indices, against JAX's
    kvs = 2 * (bspline.make_knots(2, 0.0, 1.0, 7),)
    jkvs = 2 * (jbspline.make_knots(2, 0.0, 1.0, 7),)
    vasm = tcompile.compile_vform(vform.divdiv_vf(2))(
        kvs, geo=geometry.quarter_annulus(), device='cpu')
    jvasm = jcompile.compile_vform(jvform.divdiv_vf(2))(
        jkvs, geo=jgeometry.quarter_annulus())
    idx = idx % (kvs[0].numdofs * kvs[1].numdofs)
    got, ref = vasm.multi_blocks(idx), jvasm.multi_blocks(idx)
    assert got.shape == ref.shape == (len(idx), 2, 2)
    assert np.abs(got - ref).max() <= 1e-13 * np.abs(ref).max()


def _fixture(name):
    from pyiga_tpu.utils import read_sparse_matrix
    return read_sparse_matrix(os.path.join(FIXTURES, name))


@pytest.mark.parametrize('dim, p, n', [(2, 3, 15), (3, 2, 10)])
def test_fast_mass_stiffness_fixtures(dim, p, n):
    kvs = dim * (bspline.make_knots(p, 0.0, 1.0, n),)
    geo = geometry.bspline_quarter_annulus() if dim == 2 else \
        geometry.twisted_box()
    for kind, fn in (('mass', assemble.mass_fast),
                     ('stiff', assemble.stiffness_fast)):
        M = fn(kvs, geo, verbose=0, device='cpu')
        ref = _fixture('poisson_neu_d%d_p%d_n%d_%s.mtx.gz'
                       % (dim, p, n, kind))
        assert M.shape == ref.shape and abs(M - ref).max() < 1e-9


def test_fast_no_geo_fallback():
    kv = bspline.make_knots(2, 0.0, 1.0, 6)
    assert abs(assemble.mass_fast((kv, kv)) - assemble.mass((kv, kv))
               ).max() == 0
    assert abs(assemble.stiffness_fast((kv, kv))
               - assemble.stiffness((kv, kv))).max() == 0


def _jax_pivots(jasm, **kw):
    counts = []
    inflate = jlowrank._aca_inflate

    def counting(cols, mats, count, shape):
        counts.append(int(count))
        return inflate(cols, mats, count, shape)
    jlowrank._aca_inflate = counting
    try:
        X = jlowrank.aca_3d_device(jasm, **kw)
    finally:
        jlowrank._aca_inflate = inflate
    return X, counts[0]


def _port_pivots(asm, **kw):
    counts = []
    inflate = lowrank._aca_inflate

    def counting(cols, mats, count, shape):
        counts.append(int(count))
        return inflate(cols, mats, count, shape)
    lowrank._aca_inflate = counting
    try:
        X = lowrank.aca_3d_device(asm, **kw)
    finally:
        lowrank._aca_inflate = inflate
    return X, counts[0]


def test_aca_3d_device_matches_jax():
    asm, jasm = _assemblers(3, 8)
    ref = asm.run_device()[(None, None)].numpy()
    scale = np.abs(ref).max()
    before = dict(_cuda.LAUNCHES)
    X, pivots = _port_pivots(asm, tol=1e-10, verbose=0)
    assert _cuda.LAUNCHES == before
    Xj, jpivots = _jax_pivots(jasm, tol=1e-10, verbose=0)
    Xh = jlowrank.aca_3d(jlowrank.compact_generator(jasm), tol=1e-10,
                         verbose=0, slices='materialize')
    assert pivots == jpivots == 33
    assert np.abs(X - ref).max() / scale < 1e-9
    assert np.abs(X - Xj).max() / scale < 1e-9
    assert np.abs(X - Xh).max() / scale < 1e-9
    # the host driver over the port's generator agrees as well
    Xp = lowrank.aca_3d(lowrank.compact_generator(asm), tol=1e-10,
                        verbose=0, slices='materialize')
    assert np.abs(X - Xp).max() / scale < 1e-12
    assert np.array_equal(lowrank.aca_3d_device(asm, tol=1e-10, verbose=0),
                          X)
    # an odd cap: the last accepted cross must stay intact
    X3, k3 = _port_pivots(asm, tol=1e-14, maxiter=3, verbose=0)
    X3h = jlowrank.aca_3d(jlowrank.compact_generator(jasm), tol=1e-14,
                          maxiter=3, verbose=0, slices='materialize')
    assert k3 == 3
    assert np.abs(X3 - X3h).max() < 1e-9 * np.abs(X3h).max()
    # the fast-assembly route of a CPU assembler is the host driver
    A = lowrank.fast_assemble(asm, asm.kvs0, verbose=0)
    assert abs(A - asm.assemble().asmatrix('csr')).max() < 1e-9 * scale


def test_first_max_breaks_ties_by_the_lowest_index():
    a = torch.tensor([0.5, 2.0, 1.0, 2.0 + 1e-14, 2.0 - 1e-14, 1.9],
                     dtype=torch.float64)
    assert int(lowrank._first_max(a, 0.0)) == 3
    assert int(lowrank._first_max(a, 1e-12)) == 1
    assert int(lowrank._first_max(a.reshape(2, 3), 1e-12)) == 1


def test_aca_3d_device_pivots_do_not_follow_rounding():
    # a symmetric form's compact tensor has exact ties between mirrored
    # entries; rounding picks among them unless ties are broken by index:
    # fields perturbed at the rounding level give the same pivots
    asm, _ = _assemblers(3, 8, p=3)
    X, pivots = _port_pivots(asm, tol=1e-10, verbose=0)
    fields, tables = asm._slice_operands()
    rng = np.random.RandomState(9)
    noisy = [F * (1 + 4e-16 * torch.as_tensor(rng.randn(*F.shape)))
             for F in fields]
    asm._slice_cache = (noisy, tables)
    Xn, pivots_n = _port_pivots(asm, tol=1e-10, verbose=0)
    assert pivots_n == pivots == 31
    scale = np.abs(X).max()
    assert np.abs(Xn - X).max() < 1e-9 * scale


def test_port_imports_no_jax():
    code = ('import sys; import pyiga_tpu_torch.lowrank, '
            'pyiga_tpu_torch.ops.relax, pyiga_tpu_torch.assemble, '
            'pyiga_tpu_torch.solvers; '
            'bad = [m for m in sys.modules if m == "jax" or '
            'm.startswith("jax.") or m == "pyiga_tpu" or '
            'm.startswith("pyiga_tpu.")]; '
            'print(bad); sys.exit(1 if bad else 0)')
    r = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
