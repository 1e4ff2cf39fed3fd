"""The PyTorch port's solver path — Dirichlet restriction, the weighted
fast-diagonalization preconditioner and mixed-precision CG with iterative
refinement — held against the JAX package, and the whole slice (assembly
+ solve) with identical iteration counts.  Also checks that the port
never loads jax."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pyiga_tpu.bspline as jbspline
import pyiga_tpu.geometry as jgeometry
from pyiga_tpu import solvers as jsolvers
from pyiga_tpu.assemblers import StiffnessAssembler as JStiffnessAssembler
from pyiga_tpu.ops import banded as jbanded
from pyiga_tpu.ops import fastdiag as jfastdiag
from pyiga_tpu.ops import matfree as jmatfree

from pyiga_tpu_torch import bspline, geometry, solvers
from pyiga_tpu_torch.assemblers import StiffnessAssembler
from pyiga_tpu_torch.ops import fastdiag, matfree

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pair(name, p, n):
    """The same stiffness assembler in both packages."""
    geo, jgeo = getattr(geometry, name)(), getattr(jgeometry, name)()
    asm = StiffnessAssembler(geo.sdim * (bspline.make_knots(p, 0.0, 1.0, n),),
                             geo, device='cpu')
    jasm = JStiffnessAssembler(
        jgeo.sdim * (jbspline.make_knots(p, 0.0, 1.0, n),), jgeo)
    return asm, jasm


@pytest.mark.parametrize('ns,box', [((6, 7), True), ((5, 6, 7), True),
                                    ((6, 6), False)])
def test_interior_dofs_and_box(ns, box):
    kvs = [bspline.make_knots(1, 0.0, 1.0, m - 1) for m in ns]
    jkvs = [jbspline.make_knots(1, 0.0, 1.0, m - 1) for m in ns]
    free = fastdiag.interior_dofs(kvs)
    assert np.array_equal(free, jfastdiag.interior_dofs(jkvs))
    if not box:
        free = free[1:]
    assert matfree.box_restriction(free, ns) == \
        jmatfree.box_restriction(free, ns)


@pytest.mark.parametrize('name,p,n', [('twisted_box', 3, 6),
                                      ('quarter_annulus', 3, 10)])
def test_fastdiag_weighted_apply(name, p, n):
    asm, jasm = _pair(name, p, n)
    P = fastdiag.fastdiag_precond_weighted(asm, dirichlet=True,
                                           dtype=torch.float64)
    jP = jfastdiag.fastdiag_precond_weighted(jasm, dirichlet=True,
                                             dtype=np.float64)
    r = np.random.RandomState(3).rand(len(fastdiag.interior_dofs(asm.kvs)))
    z = P(torch.as_tensor(r)).numpy()
    jz = np.asarray(jP(jnp.asarray(r)))
    assert np.abs(z - jz).max() / np.abs(jz).max() < 1e-12


def test_fastdiag_general_free_set():
    """A non-box free set applies the unrestricted diagonalization between
    an extension and a restriction, as in the JAX package."""
    asm, jasm = _pair('quarter_annulus', 2, 6)
    free = np.arange(0, 64, 3)
    P = fastdiag.fastdiag_precond_weighted(asm, free_dofs=free,
                                           dtype=torch.float64,
                                           mass_shift=1.0)
    jP = jfastdiag.fastdiag_precond_weighted(jasm, free_dofs=free,
                                             dtype=np.float64, mass_shift=1.0)
    r = np.random.RandomState(4).rand(len(free))
    z, jz = P(torch.as_tensor(r)).numpy(), np.asarray(jP(jnp.asarray(r)))
    assert np.abs(z - jz).max() / np.abs(jz).max() < 1e-12


@pytest.mark.parametrize('name,p,n', [('twisted_box', 3, 6),
                                      ('quarter_annulus', 3, 12)])
def test_cg_ir_slice_matches_jax(name, p, n):
    """The whole slice: port assembly -> restriction -> weighted fastdiag
    -> cg_ir, against JAX cg_ir on the same operators (f64 banded hi, f32
    banded lo, f32 weighted fastdiag): identical outer and inner counts."""
    asm, jasm = _pair(name, p, n)
    op_hi = asm.assemble_banded()
    free = fastdiag.interior_dofs(asm.kvs)
    b = np.random.RandomState(0).rand(len(free))
    x, info = solvers.cg_ir(
        matfree.RestrictedOperator(op_hi, free),
        matfree.RestrictedOperator(op_hi.to(torch.float32), free),
        torch.as_tensor(b), tol=1e-8, inner_tol=3e-3,
        precond_lo=fastdiag.fastdiag_precond_weighted(
            asm, dirichlet=True, dtype=torch.float32))

    mlm = jasm.assemble(mode='exact')
    bws = jbanded.band_info(mlm.structure)
    ns = tuple(bk[0] for bk in mlm.structure.bs)
    Db = jbanded.banded_from_compact(mlm.data, mlm.structure, bws)
    nf = int(np.prod(ns))
    jx, jinfo = jsolvers.cg_ir(
        jmatfree.RestrictedOperator(jbanded.BandedOperator(Db, bws, ns),
                                    free, nf),
        jmatfree.RestrictedOperator(
            jbanded.BandedOperator(Db.astype(np.float32), bws, ns), free, nf),
        jnp.asarray(b), tol=1e-8, inner_tol=3e-3,
        precond_lo=jfastdiag.fastdiag_precond_weighted(
            jasm, dirichlet=True, dtype=np.float32))

    assert info['outer'] == jinfo['outer']
    assert info['inner_iters'] == jinfo['inner_iters']
    assert info['residual'] <= 1e-8
    jx = np.asarray(jx)
    assert np.abs(x.numpy() - jx).max() / np.abs(jx).max() < 1e-9
    A = mlm.asmatrix()[free][:, free]
    assert np.linalg.norm(A @ x.numpy() - b) <= 1e-8 * np.linalg.norm(b)


def test_cg_matches_jax():
    asm, jasm = _pair('twisted_box', 2, 4)
    op = asm.assemble_banded()
    free = fastdiag.interior_dofs(asm.kvs)
    A = matfree.RestrictedOperator(op, free)
    b = np.random.RandomState(5).rand(len(free))
    x, it = solvers.cg(A, torch.as_tensor(b), tol=1e-10)
    K = jnp.asarray(
        jasm.assemble(mode='exact').asmatrix()[free][:, free].toarray())
    jx, jit = jsolvers.cg_jit(lambda v: K @ v, jnp.asarray(b), tol=1e-10)
    assert it == int(jit)
    assert np.abs(x.numpy() - np.asarray(jx)).max() < 1e-9


def test_port_never_imports_jax():
    code = ('import sys, pkgutil, importlib, pyiga_tpu_torch\n'
            'for m in pkgutil.walk_packages(pyiga_tpu_torch.__path__, '
            '"pyiga_tpu_torch."):\n'
            '    importlib.import_module(m.name)\n'
            'bad = [m for m in sys.modules if m == "jax" or '
            'm.startswith(("jax.", "pyiga_tpu.")) or m == "pyiga_tpu"]\n'
            'print(len(sys.modules)); assert not bad, bad\n')
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, '-c', code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    pattern = re.compile(r'^\s*(import|from)\s+(jax|pyiga_tpu)(\s|\.|$)',
                         re.M)
    pkg = os.path.join(REPO, 'pyiga_tpu_torch')
    for root, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith('.py'):
                with open(os.path.join(root, f)) as fh:
                    assert not pattern.search(fh.read()), f
