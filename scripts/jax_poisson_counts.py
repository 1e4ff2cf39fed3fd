# -*- coding: utf-8 -*-
"""The JAX package's Krylov and local-MG counts on the CPU for the lines
that ``chip_smoke.py`` phases 22, 22b, 22c and 8c-f32 hold the port to
(``POISSON_COUNTS_JAX``, ``CONVDIFF_COUNTS_JAX``, ``LOCALMG_ITERS_F32``).

    JAX_PLATFORMS=cpu python scripts/jax_poisson_counts.py f64 [n]
    JAX_PLATFORMS=cpu python scripts/jax_poisson_counts.py f32 [n]
    JAX_PLATFORMS=cpu python scripts/jax_poisson_counts.py f32win [n]
    JAX_PLATFORMS=cpu python scripts/jax_poisson_counts.py convdiff [n] \
        [--data FILE.npy]
    JAX_PLATFORMS=cpu python scripts/jax_poisson_counts.py localmg_f32 [n0]

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

``f32win`` (default n=48): the same count on the port's float32
*windowed* operator (``run_windowed_assembly`` under float32 on the CPU,
its regular banded layout by ``banded_reorder``), phase 22c (c).

``convdiff`` (default n=128): the convection-diffusion form of phase 7
(``(inner(grad(u), grad(v)) + dot(b, grad(u)) * v + u * v) * dx``,
``b = (3, -2)``, the NURBS quarter annulus, p=3) assembled by the port in
float32 on the CPU (``run_device()``; or the compact data in FILE.npy,
e.g. the card's from ``chiprun_out/f32_convdiff_n128.npy``), its float32
values in float64, through the JAX package's ``gmres_jit`` (restart 30,
``tol=1e-10``) on its compact matvec restricted to the interior dofs,
with its fast-diagonalization preconditioner and the port's float64
``v * dx`` right-hand side: phase 7's solve, phase 22c (a).

``localmg_f32`` (default n0=96): the bench's local-MG hierarchy
(``bench.py`` ``run_localmg``: 2D p=3, disparity 1, Dirichlet on all
four sides, 3 levels refined toward the (1, 1) corner) discretized by
``pyiga_tpu.hierarchical.HDiscretization`` (``stiffness_vf`` on the unit
square, ``f = 1``) under ``pyiga_tpu.set_dtype(np.float32)``, then
``solve_hmultigrid`` (its defaults: 'cell_supp', 'gs', 2 steps,
``tol=1e-8``, the host route) in float64 on that matrix: phase 8c-f32's
count.  The same solve on the port's float32 matrix (its CPU plain
versions) is printed beside it.

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


def port_f32_windowed_operator(n, name='twisted_box', p=3):
    """The port's float32 windowed operator at `n` on the CPU: the
    regular banded layout of ``run_windowed_assembly`` (numpy), with its
    bandwidths and dofs per axis."""
    import pyiga_tpu_torch
    from pyiga_tpu_torch import bspline, geometry
    from pyiga_tpu_torch.assemblers import StiffnessAssembler
    from pyiga_tpu_torch.ops import sumfac
    from pyiga_tpu_torch.ops.banded import band_info
    geo = getattr(geometry, name)()
    saved = pyiga_tpu_torch.get_dtype()
    pyiga_tpu_torch.set_dtype(np.float32)
    try:
        asm = StiffnessAssembler(
            geo.sdim * (bspline.make_knots(p, 0.0, 1.0, n),), geo,
            device='cpu')
        ops = asm._windowed_operands()
        Z = sumfac.run_windowed_assembly(
            asm.field_fn, asm.geo_inputs(), ops['wtabs'], ops['fss'],
            asm.tables.nqps, ops['plan'], ops['tperms'])
        bws = band_info(asm.structure)
        ns = tuple(b[0] for b in asm.structure.bs)
        D = sumfac.banded_reorder(Z, tuple(2 * b + 1 for b in bws), ns)
        assert D.dtype == pyiga_tpu_torch.get_dtype()
    finally:
        pyiga_tpu_torch.set_dtype(saved)
    return D.numpy(), bws, ns


CONVDIFF = '(inner(grad(u), grad(v)) + dot(b, grad(u)) * v + u * v) * dx'


def convdiff_count(n=128, data=None, p=3):
    """``gmres_jit``'s count in the JAX package on the CPU for phase 7's
    solve on the port's float32 convection-diffusion matrix at `n` (its
    compact data `data`, default: assembled here on the CPU)."""
    import jax.numpy as jnp
    import pyiga_tpu.bspline as jbspline
    from pyiga_tpu import solvers
    from pyiga_tpu.mlmatrix import MLStructure
    from pyiga_tpu.ops import fastdiag, matfree, mlmatvec
    import pyiga_tpu_torch
    from pyiga_tpu_torch import bspline, geometry
    from pyiga_tpu_torch.assemble import instantiate_assembler
    kvs = 2 * (bspline.make_knots(p, 0.0, 1.0, n),)
    geo = geometry.quarter_annulus()
    f = instantiate_assembler('v * dx', kvs, {'geo': geo}, None,
                              device='cpu').assemble_vector()
    if data is None:
        saved = pyiga_tpu_torch.get_dtype()
        pyiga_tpu_torch.set_dtype(np.float32)
        try:
            asm = instantiate_assembler(CONVDIFF, kvs, {
                'geo': geo, 'b': np.array([3.0, -2.0])}, None, device='cpu')
            D = asm.run_device()[(None, None)]
            assert D.dtype == pyiga_tpu_torch.get_dtype()
            data = D.numpy()
        finally:
            pyiga_tpu_torch.set_dtype(saved)
    jkvs = 2 * (jbspline.make_knots(p, 0.0, 1.0, n),)
    S = MLStructure.from_kvs(jkvs, jkvs)
    A = mlmatvec.make_ml_matvec(S.make_mlmatrix(
        data=np.asarray(data, np.float32).astype(np.float64)))
    free = fastdiag.interior_dofs(jkvs)
    nf = int(np.prod([kv.numdofs for kv in jkvs]))
    P = fastdiag.fastdiag_precond(jkvs, dirichlet=True)
    _, it = solvers.gmres_jit(matfree.RestrictedOperator(A, free, nf),
                              jnp.asarray(f.ravel()[free]), tol=1e-10,
                              restart=30, precond=P)
    return int(it)


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


def localmg_f32_counts(n0=96, num_levels=3):
    """``solve_hmultigrid``'s count in the JAX package on the CPU on its
    own float32-assembled matrix and on the port's."""
    import pyiga_tpu
    import pyiga_tpu.bspline as jbspline
    import pyiga_tpu.geometry as jgeometry
    import pyiga_tpu.hierarchical as jhier
    import pyiga_tpu.vform as jvform
    from pyiga_tpu import solvers
    import pyiga_tpu_torch
    from pyiga_tpu_torch import bspline, geometry, hierarchical, vform

    def space(hmod, bmod):
        hs = hmod.HSpace(2 * (bmod.make_knots(3, 0.0, 1.0, n0),),
                         disparity=1, bdspecs=[(0, 0), (0, 1), (1, 0), (1, 1)])
        for lv in range(num_levels - 1):
            thr = 1.0 - 2.0 ** (-lv - 1)
            hs.refine_region(lv, lambda *X: min(X) > thr)
        return hs

    saved = pyiga_tpu.get_dtype(), pyiga_tpu_torch.get_dtype()
    pyiga_tpu.set_dtype(np.float32)
    pyiga_tpu_torch.set_dtype(np.float32)
    try:
        jhs = space(jhier, jbspline)
        jhd = jhier.HDiscretization(jhs, jvform.stiffness_vf(dim=2),
                                    {'geo': jgeometry.unit_square(),
                                     'f': lambda *x: 1.0})
        jA, jf = jhd.assemble_matrix().tocsr(), jhd.assemble_rhs()
        hd = hierarchical.HDiscretization(
            space(hierarchical, bspline), vform.stiffness_vf(dim=2),
            {'geo': geometry.unit_square(), 'f': lambda *x: 1.0},
            device='cpu')
        A, f = hd.assemble_matrix().tocsr(), hd.assemble_rhs()
        _, it = solvers.solve_hmultigrid(jhs, jA, jf, tol=1e-8,
                                         relax_backend='host')
        _, it_port = solvers.solve_hmultigrid(jhs, A, f, tol=1e-8,
                                              relax_backend='host')
    finally:
        pyiga_tpu.set_dtype(saved[0])
        pyiga_tpu_torch.set_dtype(saved[1])
    return dict(ndofs=int(jA.shape[0]), matrix_dtype=str(jA.dtype),
                iters=int(it), iters_on_port_matrix=int(it_port),
                port_vs_jax_matrix=float(abs(A - jA).max() / abs(jA).max()))


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
    elif kind == 'f32win':
        n = int(argv[2]) if len(argv) > 2 else 48
        D, _, _ = port_f32_windowed_operator(n)
        rec = dict(line='3d_p3_poisson float32 windowed', n=n,
                   cg_iters=f32_count(n, D32=D))
    elif kind == 'convdiff':
        n = int(argv[2]) if len(argv) > 2 and argv[2] != '--data' else 128
        data = (np.load(argv[argv.index('--data') + 1])
                if '--data' in argv else None)
        rec = dict(line='2d_p3_convdiff float32 matrix', n=n,
                   data='card' if data is not None else 'port CPU',
                   gmres_iters=convdiff_count(n, data))
    elif kind == 'localmg_f32':
        n0 = int(argv[2]) if len(argv) > 2 else 96
        rec = dict(line='2d_p3_hb_localmg float32 assembly', n0=n0,
                   levels=3, **localmg_f32_counts(n0))
    else:
        raise SystemExit('usage: jax_poisson_counts.py '
                         'f64|f32|f32win|convdiff|localmg_f32 [n] '
                         '[--data FILE.npy]')
    rec['seconds'] = time.perf_counter() - t0
    print(json.dumps(rec))


if __name__ == '__main__':
    main(sys.argv)
