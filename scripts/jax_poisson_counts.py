# -*- coding: utf-8 -*-
"""The JAX package's Krylov counts on the CPU for the Poisson lines that
``chip_smoke.py`` phases 22 and 22b hold the port to
(``POISSON_COUNTS_JAX``).

    JAX_PLATFORMS=cpu python scripts/jax_poisson_counts.py f64 [n]
    JAX_PLATFORMS=cpu python scripts/jax_poisson_counts.py f32 [n]

``f64`` (default n=96): the 3D p=3 twisted box assembled by
``pyiga_tpu`` in exact float64 (``assemble(mode='exact')`` taken to the
regular banded layout), then ``cg_ir`` with the float64 banded operator,
its float32 copy and the float32 weighted fast-diagonalization
preconditioner, ``tol=1e-8``, ``inner_tol=3e-3``, the right-hand side
``RandomState(0).rand(n_free)``: the JAX CPU path of
``tests/test_torch_solve.py::test_cg_ir_slice_matches_jax``.

``f32`` (default n=48): the port's float32 operator
(``pyiga_tpu_torch.set_dtype(np.float32)``, ``assemble_banded()`` on the
CPU, its plain versions), copied to numpy, through the JAX package's
``cg_jit`` with its float32 weighted fast-diagonalization preconditioner,
``tol=1e-8``, ``maxiter=600``, the same right-hand side in float32
(``bench.py:482-499``).

Prints one JSON line with the counts and the seconds it took.  At n=96
the float64 run holds ~3 GB arrays (the compact and banded operators)
beside XLA's buffers."""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..'))


def _jax_assembler(name, p, n):
    import pyiga_tpu.bspline as jbspline
    import pyiga_tpu.geometry as jgeometry
    from pyiga_tpu.assemblers import StiffnessAssembler
    geo = getattr(jgeometry, name)()
    return StiffnessAssembler(
        geo.sdim * (jbspline.make_knots(p, 0.0, 1.0, n),), geo)


def f64_counts(n=96, name='twisted_box', p=3):
    """``cg_ir``'s ``(outer, inner_iters)`` in the JAX package on the CPU
    for the float64 Poisson line at `n`."""
    import jax.numpy as jnp
    from pyiga_tpu import solvers
    from pyiga_tpu.ops import banded, fastdiag, matfree
    jasm = _jax_assembler(name, p, n)
    mlm = jasm.assemble(mode='exact')
    bws = banded.band_info(mlm.structure)
    ns = tuple(bk[0] for bk in mlm.structure.bs)
    Db = banded.banded_from_compact(mlm.data, mlm.structure, bws)
    del mlm
    nf = int(np.prod(ns))
    free = fastdiag.interior_dofs(jasm.kvs0)
    b = np.random.RandomState(0).rand(len(free))
    _, info = solvers.cg_ir(
        matfree.RestrictedOperator(banded.BandedOperator(Db, bws, ns), free,
                                   nf),
        matfree.RestrictedOperator(
            banded.BandedOperator(Db.astype(np.float32), bws, ns), free, nf),
        jnp.asarray(b), tol=1e-8, inner_tol=3e-3,
        precond_lo=fastdiag.fastdiag_precond_weighted(
            jasm, dirichlet=True, dtype=np.float32))
    return int(info['outer']), [int(i) for i in info['inner_iters']]


def port_f32_operator(n, name='twisted_box', p=3):
    """The port's float32 flat banded data at `n` on the CPU, as numpy,
    with its bandwidths and dofs per axis."""
    import pyiga_tpu_torch
    from pyiga_tpu_torch import bspline, geometry
    from pyiga_tpu_torch.assemblers import StiffnessAssembler
    geo = getattr(geometry, name)()
    saved = pyiga_tpu_torch.get_dtype()
    pyiga_tpu_torch.set_dtype(np.float32)
    try:
        op = StiffnessAssembler(
            geo.sdim * (bspline.make_knots(p, 0.0, 1.0, n),), geo,
            device='cpu').assemble_banded()
    finally:
        pyiga_tpu_torch.set_dtype(saved)
    return op.D.numpy(), op.bws, op.ns


def f32_count(n=48, name='twisted_box', p=3, D32=None):
    """``cg_jit``'s count in the JAX package on the CPU for the float32
    line at `n`, on the port's float32 operator `D32` (the flat ``(C, F)``
    layout; default: :func:`port_f32_operator`)."""
    import jax.numpy as jnp
    import pyiga_tpu
    from pyiga_tpu import solvers
    from pyiga_tpu.ops import banded, fastdiag, matfree
    jasm = _jax_assembler(name, p, n)
    bws = banded.band_info(jasm.structure)
    ns = tuple(bk[0] for bk in jasm.structure.bs)
    if D32 is None:
        D32, _, _ = port_f32_operator(n, name, p)
    D = np.asarray(D32, np.float32).reshape(
        tuple(2 * bw + 1 for bw in bws) + ns)
    free = fastdiag.interior_dofs(jasm.kvs0)
    b = np.random.RandomState(0).rand(len(free)).astype(np.float32)
    saved = pyiga_tpu.get_dtype()
    pyiga_tpu.set_dtype(np.float32)
    try:
        P = fastdiag.fastdiag_precond_weighted(jasm, dirichlet=True,
                                               dtype=np.float32)
        _, it = solvers.cg_jit(
            matfree.RestrictedOperator(banded.BandedOperator(D, bws, ns),
                                       free, int(np.prod(ns))),
            jnp.asarray(b), tol=1e-8, maxiter=600, precond=P)
    finally:
        pyiga_tpu.set_dtype(saved)
    return int(it)


def main(argv):
    kind = argv[1] if len(argv) > 1 else 'f64'
    t0 = time.perf_counter()
    if kind == 'f64':
        n = int(argv[2]) if len(argv) > 2 else 96
        outer, inner = f64_counts(n)
        rec = dict(line='3d_p3_poisson float64', n=n, outer=outer,
                   inner_iters=inner, iters=sum(inner))
    elif kind == 'f32':
        n = int(argv[2]) if len(argv) > 2 else 48
        rec = dict(line='3d_p3_poisson float32', n=n, cg_iters=f32_count(n))
    else:
        raise SystemExit('usage: jax_poisson_counts.py f64|f32 [n]')
    rec['seconds'] = time.perf_counter() - t0
    print(json.dumps(rec))


if __name__ == '__main__':
    main(sys.argv)
