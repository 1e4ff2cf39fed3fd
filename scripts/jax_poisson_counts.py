# -*- coding: utf-8 -*-
"""The JAX package's Krylov and local-MG counts on the CPU for the lines
that ``chip_smoke.py`` phases 22, 22b, 22c, 8c-f32 and 23 hold the port to
(``POISSON_COUNTS_JAX``, ``CONVDIFF_COUNTS_JAX``, ``LOCALMG_ITERS_F32``,
``CG_JIT_COUNTS_JAX``, ``GMRES_JIT_COUNTS_JAX``, ``EXAMPLE_COUNTS_JAX``),
and the Newton residual norms that phase 26 (d) holds the port's
nonlinear Poisson example to (``NLP_NORMS_JAX``).

    JAX_PLATFORMS=cpu python scripts/jax_poisson_counts.py f64 [n]
    JAX_PLATFORMS=cpu python scripts/jax_poisson_counts.py f32 [n]
    JAX_PLATFORMS=cpu python scripts/jax_poisson_counts.py f32win [n]
    JAX_PLATFORMS=cpu python scripts/jax_poisson_counts.py convdiff [n] \
        [--data FILE.npy]
    JAX_PLATFORMS=cpu python scripts/jax_poisson_counts.py localmg_f32 [n0]
    JAX_PLATFORMS=cpu python scripts/jax_poisson_counts.py cgjit [n] \
        [--seed S]
    JAX_PLATFORMS=cpu python scripts/jax_poisson_counts.py convdiff64 [n] \
        [--seed S]
    JAX_PLATFORMS=cpu python scripts/jax_poisson_counts.py examples [small]
    JAX_PLATFORMS=cpu python scripts/jax_poisson_counts.py nonlinear

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

``cgjit`` (default n=48): the port's float64 operator
(``assemble_banded()`` on the CPU, its plain versions), copied to numpy,
through the JAX package's ``cg_jit`` with its float64 weighted
fast-diagonalization preconditioner, ``tol=1e-8``, the right-hand side
``RandomState(0).rand(n_free)``, from zero and from the start
:func:`seeded_x0` (``--seed``, default 0): phase 23 (a).

``convdiff64`` (default n=128): phase 7's solve on the port's float64
convection-diffusion matrix (assembled on the CPU) through the JAX
package's ``gmres_jit``, from zero and from :func:`seeded_x0`: phase 23
(c).

``examples``: the JAX examples ``poisson_3d``, ``convection_diffusion``,
``adaptive_poisson``, ``geometry_tour`` and ``subspace_correction_mg``
run at their default sizes (``small``: the reduced sizes of
``tests/test_examples.py``), with the counts and numbers each prints
parsed from its output (:func:`parse_example`): phase 23 (e) and
``tests/test_torch_examples.py``.

Prints one JSON line with the counts and the seconds it took.  At n=96
the float64 run holds ~3 GB arrays (the compact and banded operators)
beside XLA's buffers."""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..')
sys.path.insert(0, REPO)


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


def seeded_x0(n, seed=0):
    """The nonzero start of phase 23's Krylov solves: standard normal
    values from ``RandomState(seed)``."""
    return np.random.RandomState(seed).standard_normal(n)


def port_f64_operator(n, name='twisted_box', p=3):
    """The port's float64 flat banded data at `n` on the CPU, as numpy,
    with its bandwidths and dofs per axis."""
    from pyiga_tpu_torch import bspline, geometry
    from pyiga_tpu_torch.assemblers import StiffnessAssembler
    geo = getattr(geometry, name)()
    op = StiffnessAssembler(
        geo.sdim * (bspline.make_knots(p, 0.0, 1.0, n),), geo,
        device='cpu').assemble_banded()
    return op.D.numpy(), op.bws, op.ns


def cg_jit_counts(n=48, seed=0, name='twisted_box', p=3):
    """``cg_jit``'s counts in the JAX package on the CPU on the port's
    float64 operator at `n`, with the float64 weighted fast-diagonalization
    preconditioner: ``(from zero, from seeded_x0)``."""
    import jax.numpy as jnp
    from pyiga_tpu import solvers
    from pyiga_tpu.ops import banded, fastdiag, matfree
    jasm = _jax_assembler(name, p, n)
    bws = banded.band_info(jasm.structure)
    ns = tuple(bk[0] for bk in jasm.structure.bs)
    D64, _, _ = port_f64_operator(n, name, p)
    D = D64.reshape(tuple(2 * bw + 1 for bw in bws) + ns)
    free = fastdiag.interior_dofs(jasm.kvs0)
    A = matfree.RestrictedOperator(banded.BandedOperator(D, bws, ns), free,
                                   int(np.prod(ns)))
    P = fastdiag.fastdiag_precond_weighted(jasm, dirichlet=True)
    b = jnp.asarray(np.random.RandomState(0).rand(len(free)))
    _, it0 = solvers.cg_jit(A, b, tol=1e-8, precond=P)
    _, it1 = solvers.cg_jit(A, b, x0=jnp.asarray(seeded_x0(len(free), seed)),
                            tol=1e-8, precond=P)
    return int(it0), int(it1)


def convdiff64_counts(n=128, seed=0, p=3):
    """``gmres_jit``'s counts in the JAX package on the CPU for phase 7's
    solve on the port's float64 convection-diffusion matrix: ``(from
    zero, from seeded_x0)``."""
    import jax.numpy as jnp
    import pyiga_tpu.bspline as jbspline
    from pyiga_tpu import solvers
    from pyiga_tpu.mlmatrix import MLStructure
    from pyiga_tpu.ops import fastdiag, matfree, mlmatvec
    from pyiga_tpu_torch import bspline, geometry
    from pyiga_tpu_torch.assemble import instantiate_assembler
    kvs = 2 * (bspline.make_knots(p, 0.0, 1.0, n),)
    geo = geometry.quarter_annulus()
    f = instantiate_assembler('v * dx', kvs, {'geo': geo}, None,
                              device='cpu').assemble_vector()
    data = instantiate_assembler(CONVDIFF, kvs, {
        'geo': geo, 'b': np.array([3.0, -2.0])}, None,
        device='cpu').run_device()[(None, None)].numpy()
    jkvs = 2 * (jbspline.make_knots(p, 0.0, 1.0, n),)
    S = MLStructure.from_kvs(jkvs, jkvs)
    A = matfree.RestrictedOperator(
        mlmatvec.make_ml_matvec(S.make_mlmatrix(data=data)),
        fastdiag.interior_dofs(jkvs), int(np.prod([kv.numdofs
                                                   for kv in jkvs])))
    free = fastdiag.interior_dofs(jkvs)
    P = fastdiag.fastdiag_precond(jkvs, dirichlet=True)
    b = jnp.asarray(f.ravel()[free])
    _, it0 = solvers.gmres_jit(A, b, tol=1e-10, restart=30, precond=P)
    _, it1 = solvers.gmres_jit(A, b, x0=jnp.asarray(seeded_x0(len(free),
                                                              seed)),
                               tol=1e-10, restart=30, precond=P)
    return int(it0), int(it1)


# the reduced sizes of tests/test_examples.py
EXAMPLES_SMALL = {
    'poisson_3d': dict(n=6, p=2),
    'convection_diffusion': dict(n=8, p=2),
    'adaptive_poisson': dict(p=2, n0=4, num_refinements=2),
    'geometry_tour': dict(),
    'subspace_correction_mg': dict(p1=5, n1=16, p2=3, n2=6),
}


def parse_example(name, text):
    """The counts and numbers an example prints, from its output `text`
    (the same words in the JAX example and its port)."""
    import re
    lines = text.splitlines()
    if name == 'poisson_3d':
        m = re.search(r'cg_ir: (\d+) outer / (\[[^\]]*\]) inner', text)
        return dict(outer=int(m.group(1)), inner_iters=json.loads(
            m.group(2)))
    if name == 'convection_diffusion':
        m = re.search(r'GMRES iters: (\S+) \(preconditioned\) vs (\S+) '
                      r'\(plain\)', text)
        return dict(gmres_precond=int(m.group(1)),
                    gmres_plain=int(m.group(2)))
    if name == 'adaptive_poisson':
        return dict(sweeps=[[int(v) for v in re.findall(
            r'=(\d+)', ln)] for ln in lines if ln.startswith('sweep')])
    if name == 'subspace_correction_mg':
        return dict(twogrid=[int(ln.split()[0]) for ln in lines
                             if ln.endswith(' iterations')])
    if name == 'geometry_tour':
        return dict(printed=[ln.split(':')[0] for ln in lines])
    raise ValueError(name)


def tour_values(geometry, area):
    """The areas and volumes ``geometry_tour`` prints, unrounded, from a
    package's `geometry` module and the example's ``area`` function."""
    qa = geometry.quarter_annulus(r1=1.0, r2=2.0)
    return dict(
        quarter_annulus=area(qa),
        bspline_quarter_annulus=area(geometry.bspline_quarter_annulus()),
        transformed=area(qa.scale(2.0).rotate_2d(np.pi / 3)
                         .translate((1.0, -2.0))),
        disk=area(geometry.disk(r=1.5)),
        twisted_box=area(geometry.twisted_box(), n=16),
        cylinder=area(geometry.tensor_product(
            geometry.line_segment(0.0, 2.0), qa), n=12))


def jax_example_counts(small=False):
    """Run the five JAX examples (default or reduced sizes) and parse what
    each prints."""
    import contextlib
    import importlib.util
    import io
    out = {}
    for name, kwargs in EXAMPLES_SMALL.items():
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            '..', 'examples', name + '.py')
        spec = importlib.util.spec_from_file_location('jex_' + name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main(**(kwargs if small else {}))
        out[name] = parse_example(name, buf.getvalue())
        if name == 'geometry_tour':
            out[name]['values'] = tour_values(mod.geometry, mod.area)
    return out


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


def nonlinear_norms():
    """The Newton residual norms of ``examples/nonlinear_poisson.py`` at
    its default size (p=2, n=8; its Jacobian by ``jax.jacfwd`` of the
    assembly) and ``max |u|``."""
    import importlib.util
    path = os.path.join(REPO, 'examples', 'nonlinear_poisson.py')
    spec = importlib.util.spec_from_file_location('nonlinear_poisson', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    norms, umax = mod.main()
    return dict(norms=[float(r) for r in norms], umax=float(umax))


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
    elif kind in ('cgjit', 'convdiff64'):
        seed = int(argv[argv.index('--seed') + 1]) if '--seed' in argv else 0
        n = (int(argv[2]) if len(argv) > 2 and argv[2] != '--seed'
             else (48 if kind == 'cgjit' else 128))
        if kind == 'cgjit':
            it0, it1 = cg_jit_counts(n, seed)
            rec = dict(line='3d_p3_poisson float64 cg_jit', n=n, seed=seed)
        else:
            it0, it1 = convdiff64_counts(n, seed)
            rec = dict(line='2d_p3_convdiff float64 gmres_jit', n=n,
                       seed=seed)
        rec.update(iters_from_zero=it0, iters_from_x0=it1)
    elif kind == 'nonlinear':
        rec = dict(line='examples/nonlinear_poisson.py p=2 n=8',
                   **nonlinear_norms())
    elif kind == 'examples':
        small = len(argv) > 2 and argv[2] == 'small'
        rec = dict(line='examples', sizes='small' if small else 'default',
                   **jax_example_counts(small))
    else:
        raise SystemExit('usage: jax_poisson_counts.py '
                         'f64|f32|f32win|convdiff|localmg_f32|cgjit|'
                         'convdiff64|examples|nonlinear [n] '
                         '[--data FILE.npy] '
                         '[--seed S]')
    rec['seconds'] = time.perf_counter() - t0
    print(json.dumps(rec))


if __name__ == '__main__':
    main(sys.argv)
