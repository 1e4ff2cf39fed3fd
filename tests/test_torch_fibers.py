"""The host float64 fiber evaluator of the port
(``pyiga_tpu_torch.ops.sumfac.banded_fibers_exact``: the rank-1
restricted chain of the JAX package's bench spot check) against the
fibers of the port's CPU ``assemble_banded()`` and of the JAX package's
exact assembly taken to the banded layout, including fibers on the band's
padding; and ``scripts/jax_poisson_counts.py`` at small sizes against the
counts of the port's solve."""

import os
import sys

import numpy as np
import pytest
import torch

import pyiga_tpu.bspline as jbspline
import pyiga_tpu.geometry as jgeometry
from pyiga_tpu.assemblers import MassAssembler as JMassAssembler
from pyiga_tpu.assemblers import StiffnessAssembler as JStiffnessAssembler
from pyiga_tpu.ops import banded as jbanded

import pyiga_tpu_torch
from pyiga_tpu_torch import bspline, geometry, solvers
from pyiga_tpu_torch.assemblers import MassAssembler, StiffnessAssembler
from pyiga_tpu_torch.ops import fastdiag, matfree, sumfac
from pyiga_tpu_torch.ops.banded import band_info

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'scripts'))
import jax_poisson_counts  # noqa: E402

torch.set_num_threads(1)

ASSEMBLERS = {'stiffness': (StiffnessAssembler, JStiffnessAssembler),
              'mass': (MassAssembler, JMassAssembler)}


def _rows(asm, count, seed):
    """`count` random trailing banded rows and three on the padding."""
    bws = band_info(asm.structure)
    ns = [b[0] for b in asm.structure.bs]
    rng = np.random.RandomState(seed)
    rows = [[int(rng.randint((2 * b + 1) * n)) for b, n in
             zip(bws[1:], ns[1:])] for _ in range(count)]
    # mu_1 = 0 at the first dofs, and mu_2 = 2 b at the last: the offset
    # leaves the matrix
    return rows + [[0, 0], [1, ns[2] + 2],
                   [bws[1] * ns[1] + 3, (2 * bws[2] + 1) * ns[2] - 1]]


@pytest.mark.parametrize('kind', ['stiffness', 'mass'])
@pytest.mark.parametrize('n', [6, 8])
def test_fibers_match_port_and_jax(kind, n):
    cls, jcls = ASSEMBLERS[kind]
    geo, jgeo = geometry.twisted_box(), jgeometry.twisted_box()
    asm = cls(3 * (bspline.make_knots(3, 0.0, 1.0, n),), geo, device='cpu')
    jasm = jcls(3 * (jbspline.make_knots(3, 0.0, 1.0, n),), jgeo)
    rows = _rows(asm, 16, n)
    host = sumfac.banded_fibers_exact(asm, rows)
    scale = np.abs(host).max()
    assert host.shape == (19, 7 * (n + 3)) and scale > 0
    op = asm.assemble_banded()
    port = sumfac.banded_fibers(op.D, op.bws, op.ns, rows).numpy()
    assert np.abs(port - host).max() <= 1e-14 * scale
    mlm = jasm.assemble(mode='exact')
    Db = jbanded.banded_from_compact(mlm.data, mlm.structure,
                                     jbanded.band_info(mlm.structure))
    # the JAX regular layout (b_1, b_2, b_3, n_1, n_2, n_3) as the flat one
    jax = sumfac.banded_fibers(torch.as_tensor(Db).reshape(op.D.shape),
                               op.bws, op.ns, rows).numpy()
    assert np.abs(jax - host).max() <= 1e-14 * scale
    # the padding rows: zero on every side
    assert not host[-3:].any() and not port[-3:].any() and not jax[-3:].any()


def test_fibers_of_a_nurbs_geometry():
    """A NURBS map (the quarter annulus extruded) through the quotient
    rule of the host chain."""
    geo = geometry.tensor_product(geometry.line_segment(0.0, 1.0),
                                  geometry.quarter_annulus())
    asm = StiffnessAssembler(3 * (bspline.make_knots(3, 0.0, 1.0, 5),), geo,
                             device='cpu')
    rows = _rows(asm, 16, 3)
    host = sumfac.banded_fibers_exact(asm, rows)
    op = asm.assemble_banded()
    port = sumfac.banded_fibers(op.D, op.bws, op.ns, rows).numpy()
    assert np.abs(port - host).max() <= 1e-14 * np.abs(host).max()


@pytest.mark.parametrize('name,p,n', [('twisted_box', 3, 6),
                                      ('quarter_annulus', 3, 12)])
def test_jax_poisson_counts_script(name, p, n):
    """The script's float64 counts are the JAX side of
    ``test_cg_ir_slice_matches_jax``: the port's ``cg_ir`` on the same
    problem gives them; its float32 count is the port's ``cg`` on its
    float32 operator."""
    geo = getattr(geometry, name)()
    asm = StiffnessAssembler(geo.sdim * (bspline.make_knots(p, 0.0, 1.0, n),),
                             geo, device='cpu')
    op = asm.assemble_banded()
    free = fastdiag.interior_dofs(asm.kvs)
    b = np.random.RandomState(0).rand(len(free))
    _, info = solvers.cg_ir(
        matfree.RestrictedOperator(op, free),
        matfree.RestrictedOperator(op.to(torch.float32), free),
        torch.as_tensor(b), tol=1e-8, inner_tol=3e-3,
        precond_lo=fastdiag.fastdiag_precond_weighted(
            asm, dirichlet=True, dtype=torch.float32))
    assert jax_poisson_counts.f64_counts(n, name, p) == \
        (info['outer'], info['inner_iters'])

    D32, bws, ns = jax_poisson_counts.port_f32_operator(n, name, p)
    assert D32.dtype == np.float32
    assert pyiga_tpu_torch.get_dtype() == torch.float64
    pyiga_tpu_torch.set_dtype(np.float32)
    try:
        P = fastdiag.fastdiag_precond_weighted(asm, dirichlet=True)
        from pyiga_tpu_torch.ops.banded import FlatBandedOperator
        _, it = solvers.cg(
            matfree.RestrictedOperator(
                FlatBandedOperator(torch.as_tensor(D32), bws, ns), free),
            torch.as_tensor(b.astype(np.float32)), tol=1e-8, maxiter=600,
            precond=P)
    finally:
        pyiga_tpu_torch.set_dtype(np.float64)
    assert jax_poisson_counts.f32_count(n, name, p, D32) == it
