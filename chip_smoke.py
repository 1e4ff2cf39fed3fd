"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pyiga_tpu_torch/csrc``, holds each
kernel against its plain PyTorch version on the card at the shapes of the
3D p=3 n=48 main path, checks the whole path on small inputs against the
CPU run and a golden stiffness fixture, then drives the main path
(``StiffnessAssembler.assemble_banded`` -> ``RestrictedOperator`` ->
``fastdiag_precond_weighted`` -> ``cg_ir``) on the twisted box at 3D p=3
n=48 and on the NURBS quarter annulus at 2D p=3 n=128, counting every
kernel launch of the 3D run.

The generic VForm path has its own phases: K1's ``jac`` kind and the
generated coefficient-field kernel K5 (built from the form's generated
source) against their plain versions (4c), the 2D n=16 convection-
diffusion solve on the card against the CPU run (4d), and the
convection-diffusion path of ``examples/convection_diffusion.py`` at the
bench's 2D p=3 n=128 size (``assemble.assemble`` / ``VFormAssembler.
run_device`` -> ``MLMatvecOperator`` -> ``fastdiag_precond`` -> ``gmres``),
cold and warm, counting its launches (7).

The hierarchical local-multigrid path (the bench's ``run_localmg``:
``HSpace`` refined toward the (1, 1) corner -> ``HDiscretization`` on
``unit_square`` with the on-demand ``bbox`` assemblers -> ``solvers.
solve_hmultigrid`` -> ``DeviceMGSolver``, one K6 launch per V-cycle) has
these phases: K6 against its plain version for one V-cycle from a seeded
iterate on the (24, 3) and (48, 3) hierarchies (4e); the path at n0=6 on
the card against the CPU (4f); the bench shape (24, 3), cold and warm,
held to 29 iterations and to the port's host path in the same process
(8); and (48, 3) with ``smoother_impl='fused'`` (above the JAX package's
dense cutoff), held to 27 (8b).  Any failed check raises (nonzero exit).

Output: phase lines, then a JSON line ``{"kernels": [...]}``, the card's
``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``.  The full record also goes to
``chiprun_out/chip_smoke.json``.  Without a CUDA device it exits nonzero
and prints no result.  Imports neither jax nor pyiga_tpu.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# kernel -> (route, source, TPU kernel it replaces), for the JSON record
KERNELS = {
    'fields': ('cuda', 'pyiga_tpu_torch/csrc/sumfac.cu',
               'pyiga_tpu/ops/pallas_sumfac.py:1087'),
    # the same pallas_call with kind='jac'
    'geo_jac_fields': ('cuda', 'pyiga_tpu_torch/csrc/sumfac.cu',
                       'pyiga_tpu/ops/pallas_sumfac.py:1087'),
    'stage': ('cuda', 'pyiga_tpu_torch/csrc/sumfac.cu',
              'pyiga_tpu/ops/pallas_sumfac.py:353'),
    'fold': ('cuda', 'pyiga_tpu_torch/csrc/sumfac.cu',
             'pyiga_tpu/ops/pallas_sumfac.py:781'),
    'flat_banded_f64': ('cuda', 'pyiga_tpu_torch/csrc/banded.cu',
                        'pyiga_tpu/ops/banded.py:541'),
    'flat_banded_f32': ('cuda', 'pyiga_tpu_torch/csrc/banded.cu',
                        'pyiga_tpu/ops/banded.py:515'),
    # CUDA C generated per form by this module, built at run time
    'vform_fields': ('cuda', 'pyiga_tpu_torch/ops/cuda_vform.py',
                     'pyiga_tpu/compile.py:974'),
    'vcycle': ('cuda', 'pyiga_tpu_torch/csrc/mg.cu',
               'pyiga_tpu/ops/mg_pallas.py:493'),
}
# the kernels each main path runs
POISSON_KERNELS = ('fields', 'stage', 'fold', 'flat_banded_f64',
                   'flat_banded_f32')
VFORM_KERNELS = ('geo_jac_fields', 'vform_fields', 'stage', 'fold')
LOCALMG_KERNELS = ('vcycle', 'geo_jac_fields', 'vform_fields', 'stage',
                   'fold')
# (n0, levels) -> the iteration count of the JAX package's host path
LOCALMG_ITERS = {(24, 3): 29, (48, 3): 27}

CONVDIFF = '(inner(grad(u), grad(v)) + dot(b, grad(u)) * v + u * v) * dx'
CONV_B = np.array([3.0, -2.0])


def log(*args):
    print(*args, flush=True)


def sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def time_ms(fn, device, reps=10, warmup=2):
    """Mean milliseconds of `fn()` over `reps` calls after `warmup`, by
    CUDA events (host clock around a synchronize on the CPU)."""
    for _ in range(warmup):
        fn()
    if device.type != 'cuda':
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sync(device)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, got, ref, rtol):
    """Max abs error and its ratio to max |ref|; raises above `rtol`."""
    err = float((got.double() - ref.double()).abs().max())
    scale = float(ref.double().abs().max())
    rel = err / scale if scale > 0 else err
    ok = bool(torch.isfinite(got).all()) and rel <= rtol
    log('  %-16s max_abs_err %.3e  rel %.3e  (tol %.0e)  %s'
        % (name, err, rel, rtol, 'ok' if ok else 'FAIL'))
    if not ok:
        raise RuntimeError('%s disagrees with its plain version' % name)
    return err, rel


def nvidia_smi():
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired) as e:
        return 'nvidia-smi unavailable (%s)' % e


def main_path_setup(dim, n, device):
    """The main path's assembler with its host tables built (numpy
    setup that bench.py also keeps out of the timed assembly)."""
    from pyiga_tpu_torch import bspline, geometry
    from pyiga_tpu_torch.assemblers import StiffnessAssembler
    from pyiga_tpu_torch.ops.banded import band_info
    kvs = dim * (bspline.make_knots(3, 0.0, 1.0, n),)
    geo = geometry.twisted_box() if dim == 3 else geometry.quarter_annulus()
    asm = StiffnessAssembler(kvs, geo, device=device)
    asm.tables.banded_term_tables(asm.terms, band_info(asm.structure))
    return asm


def check_kernels(device, n=48, seed=0):
    """Phase 4: each kernel against its plain version on `device`, at the
    shapes of the 3D p=3 main path (n=48 by default)."""
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    from pyiga_tpu_torch.ops import banded as bd

    rng = np.random.RandomState(seed)
    f64 = torch.float64

    def rand(*shape):
        return torch.as_tensor(rng.rand(*shape), dtype=f64, device=device)

    asm = main_path_setup(3, n, device)
    out = {}

    # K1 on the real geometry partials of the twisted box
    gi = asm.geo_inputs()
    tables = gi['geo_tables_bsp']
    Y, _ = cs.geo_stage12(tables, gi['geo_coeffs'], 3)
    w12 = (gi['weights'][0][:, None] * gi['weights'][1]).reshape(-1)
    T = tables[2][:2].contiguous()
    wL = gi['weights'][2]
    args = (Y, T, w12, wL, False)
    got, ref = cs.fields(*args), cs.fields_plain(*args)
    sync(device)
    err, rel = compare('fields', got, ref, 1e-12)
    out['fields'] = dict(max_abs_err=err, rel=rel,
                         shape=list(got.shape),
                         ms=time_ms(lambda: cs.fields(*args), device),
                         plain_ms=time_ms(lambda: cs.fields_plain(*args),
                                          device, reps=3))
    del Y, got, ref, args

    # K2 at both chain-stage shapes, real banded tables
    bws = bd.band_info(asm.structure)
    btabs = asm.tables.banded_term_tables(asm.terms, bws)
    stage_tabs = [torch.as_tensor(btabs[0][k], dtype=f64, device=device)
                  for k in (0, 1)]
    K, M = stage_tabs[0].shape[1], stage_tabs[0].shape[0]
    stage_ms, stage_plain_ms, stage_err, stage_rel = [], [], 0.0, 0.0
    for R, Tt in ((K * K, stage_tabs[0]), (K * M, stage_tabs[1])):
        X = rand(K, R)
        got, ref = cs.stage(X, Tt), cs.stage_plain(X, Tt)
        sync(device)
        e, r = compare('stage R=%d' % R, got, ref, 1e-12)
        stage_err, stage_rel = max(stage_err, e), max(stage_rel, r)
        stage_ms.append(time_ms(lambda: cs.stage(X, Tt), device))
        stage_plain_ms.append(time_ms(lambda: cs.stage_plain(X, Tt), device))
        del X, got, ref
    out['stage'] = dict(max_abs_err=stage_err, rel=stage_rel,
                        shapes=[[K, K * K, M], [K, K * M, M]],
                        ms=sum(stage_ms), plain_ms=sum(stage_plain_ms),
                        ms_each=stage_ms, plain_ms_each=stage_plain_ms)

    # K3: the fold plan's terms over their deduplicated last tables,
    # R = M * M
    from pyiga_tpu_torch.ops.sumfac import last_table_groups
    plan = asm._fold()
    idx = list(last_table_groups([btabs[t] for t, _m in plan]))
    fold_tabs = [None] * (max(idx) + 1)
    for (t, _m), i in zip(plan, idx):
        fold_tabs[i] = torch.as_tensor(btabs[t][2], dtype=f64, device=device)
    xs = [rand(K, M * M) for _ in plan]
    got, ref = cs.fold(xs, fold_tabs, idx), cs.fold_plain(xs, fold_tabs, idx)
    sync(device)
    err, rel = compare('fold', got, ref, 1e-12)
    out['fold'] = dict(max_abs_err=err, rel=rel,
                       shape=[len(xs), K, M * M, M], tables=len(fold_tabs),
                       ms=time_ms(lambda: cs.fold(xs, fold_tabs, idx),
                                  device),
                       plain_ms=time_ms(lambda: cs.fold_plain(
                           xs, fold_tabs, idx), device))
    del xs, got, ref

    # K4 in f64 and f32 on the n=48 flat layout
    ns = tuple(b[0] for b in asm.structure.bs)
    lay = bd.flat_banded_layout(bws, ns)
    C, F, lead = lay['C'], lay['F'], lay['lead']
    offs = torch.as_tensor(lay['offs'], device=device)
    D = rand(C, F)
    xp = torch.zeros(F + 2 * lead, dtype=f64, device=device)
    xp[lead:lead + F] = rand(F)
    for dtype, name, tol in ((f64, 'flat_banded_f64', 1e-13),
                             (torch.float32, 'flat_banded_f32', 1e-5)):
        Dd, xd = D.to(dtype), xp.to(dtype)
        got = bd.flat_banded_matvec(Dd, xd, offs, lead)
        ref = bd.flat_banded_matvec_plain(Dd, xd, offs, lead)
        sync(device)
        err, rel = compare(name, got, ref, tol)
        out[name] = dict(
            max_abs_err=err, rel=rel, shape=[C, F],
            ms=time_ms(lambda: bd.flat_banded_matvec(Dd, xd, offs, lead),
                       device, reps=50),
            plain_ms=time_ms(lambda: bd.flat_banded_matvec_plain(
                Dd, xd, offs, lead), device))
        del Dd, xd, got, ref
    for name, r in out.items():
        log('  %-16s kernel %.4f ms   plain %.4f ms' % (name, r['ms'],
                                                      r['plain_ms']))
    return out


def solve_case(asm, op_hi, device):
    """Dirichlet solve of the main path on an assembled operator."""
    from pyiga_tpu_torch import solvers
    from pyiga_tpu_torch.ops.fastdiag import (fastdiag_precond_weighted,
                                              interior_dofs)
    from pyiga_tpu_torch.ops.matfree import RestrictedOperator

    free = interior_dofs(asm.kvs)
    t0 = time.perf_counter()
    A_hi = RestrictedOperator(op_hi, free)
    A_lo = RestrictedOperator(op_hi.to(torch.float32), free)
    P = fastdiag_precond_weighted(asm, dirichlet=True, dtype=torch.float32)
    b = torch.as_tensor(np.random.RandomState(0).rand(len(free)),
                        dtype=torch.float64, device=device)
    sync(device)
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, info = solvers.cg_ir(A_hi, A_lo, b, tol=1e-8, precond_lo=P,
                            inner_tol=3e-3)
    sync(device)
    t_solve = time.perf_counter() - t0
    res = float(torch.linalg.vector_norm(b - A_hi(x))
                / torch.linalg.vector_norm(b))
    return x, info, res, t_setup, t_solve


def run_main_path(dim, n, device):
    """Phases 5/6: assemble + solve, timed after synchronizes."""
    t0 = time.perf_counter()
    asm = main_path_setup(dim, n, device)
    t_host = time.perf_counter() - t0
    sync(device)
    t0 = time.perf_counter()
    op_hi = asm.assemble_banded()
    sync(device)
    t_asm = time.perf_counter() - t0
    x, info, res, t_setup, t_solve = solve_case(asm, op_hi, device)
    ndofs = op_hi.shape[0]
    n_free = int(np.prod([kv.numdofs - 2 for kv in asm.kvs]))
    if x.shape != (n_free,) or not bool(torch.isfinite(x).all()):
        raise RuntimeError('solution has shape %s or is not finite'
                           % (tuple(x.shape),))
    rec = dict(dim=dim, n=n, p=3, ndofs=ndofs, n_free=int(x.shape[0]),
               t_host_setup_ms=1e3 * t_host, t_assembly_ms=1e3 * t_asm,
               t_precond_setup_ms=1e3 * t_setup, t_solve_ms=1e3 * t_solve,
               dof_per_s=ndofs / (t_asm + t_solve), outer=info['outer'],
               inner_iters=info['inner_iters'],
               iters=sum(info['inner_iters']), residual=res,
               residual_cg_ir=info['residual'])
    log('  %dD p=3 n=%d: %d dofs (%d free); host setup %.1f ms'
        % (dim, n, ndofs, rec['n_free'], rec['t_host_setup_ms']))
    log('  assembly %.2f ms  solve %.2f ms  (precond setup %.1f ms)  '
        '%.0f dof/s' % (rec['t_assembly_ms'], rec['t_solve_ms'],
                        rec['t_precond_setup_ms'], rec['dof_per_s']))
    log('  outer %d  inner_iters %s  sum %d  rel residual %.3e'
        % (rec['outer'], rec['inner_iters'], rec['iters'], res))
    if not res <= 1e-8:
        raise RuntimeError('relative residual %.3e above 1e-8' % res)
    return rec


def check_small(device):
    """The whole path on small inputs: the card against the CPU run of the
    plain versions (3D p=3 n=8), and the card's 3D p=2 n=10 stiffness
    against the golden fixture."""
    import scipy.sparse
    from pyiga_tpu_torch import bspline, geometry
    from pyiga_tpu_torch.assemblers import StiffnessAssembler
    from pyiga_tpu_torch.ops.banded import flat_banded_to_csr

    cpu = torch.device('cpu')
    outs = {}
    for dev in (device, cpu):
        asm = main_path_setup(3, 8, dev)
        op = asm.assemble_banded()
        x, info, res, _, _ = solve_case(asm, op, dev)
        outs[dev.type] = (op.D.cpu(), x.cpu(), info, res)
    (Dg, xg, ig, rg), (Dc, xc, ic, rc) = outs[device.type], outs['cpu']
    err_D = float((Dg - Dc).abs().max() / Dc.abs().max())
    err_x = float((xg - xc).abs().max() / xc.abs().max())
    log('  3D n=8 card vs CPU: D rel %.3e  x rel %.3e  iters %s vs %s  '
        'res %.2e / %.2e' % (err_D, err_x, ig['inner_iters'],
                             ic['inner_iters'], rg, rc))
    if not (err_D <= 1e-12 and err_x <= 1e-9 and rg <= 1e-8):
        raise RuntimeError('card run disagrees with the CPU run at n=8')

    kv = bspline.make_knots(2, 0.0, 1.0, 10)
    op = StiffnessAssembler(3 * (kv,), geometry.twisted_box(),
                            device=device).assemble_banded()
    A = flat_banded_to_csr(op.D, op.bws, op.ns)
    data = np.loadtxt(os.path.join(REPO, 'tests', 'fixtures',
                                   'poisson_neu_d3_p2_n10_stiff.mtx.gz'),
                      skiprows=1, ndmin=2)
    ij = data[:, :2].astype(np.intp) - 1
    A_ref = scipy.sparse.coo_matrix((data[:, 2], (ij[:, 0], ij[:, 1])),
                                    shape=A.shape).tocsr()
    err_fix = float(abs(A - A_ref).max())
    log('  3D p=2 n=10 stiffness vs golden fixture: max abs err %.3e'
        % err_fix)
    if not err_fix <= 1e-14:
        raise RuntimeError('card assembly misses the golden fixture')
    return dict(n8_D_rel=err_D, n8_x_rel=err_x, n8_iters_card=ig,
                n8_iters_cpu=ic, fixture_max_abs_err=err_fix)


def convdiff_setup(n, device):
    """The convection-diffusion assemblers of the VForm path (matrix and
    right-hand side) on the exact-NURBS quarter annulus, 2D p=3."""
    from pyiga_tpu_torch import bspline, geometry
    from pyiga_tpu_torch.assemble import instantiate_assembler
    kvs = 2 * (bspline.make_knots(3, 0.0, 1.0, n),)
    geo = geometry.quarter_annulus()
    asm = instantiate_assembler(CONVDIFF, kvs, {'geo': geo, 'b': CONV_B},
                                None, device=device)
    asm_f = instantiate_assembler('v * dx', kvs, {'geo': geo}, None,
                                  device=device)
    return kvs, geo, asm, asm_f


def check_vform_kernels(device):
    """Phase 4c: K1's jac kind against its plain version on the 2D
    annulus at n=128 and the 3D twisted box at n=48, and the generated K5
    against its plain version on the convection-diffusion form at n=128
    (both 1e-12 relative to the largest output)."""
    from pyiga_tpu_torch import _cuda
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    from pyiga_tpu_torch.ops import cuda_vform as cv

    t0 = time.perf_counter()
    _, _, asm, _ = convdiff_setup(128, device)
    t_setup = time.perf_counter() - t0
    ops = asm._device_operands()
    asm3 = main_path_setup(3, 48, device)
    gi3 = asm3.geo_inputs()
    cases = {}
    for name, tables, coeffs, nurbs in (
            ('2d_n128_nurbs', ops['geo_tables'], ops['geo_coeffs'],
             asm._geo_is_nurbs),
            ('3d_n48_bspline', gi3['geo_tables_bsp'], gi3['geo_coeffs'],
             False)):
        d = len(tables)
        Y, _ = cs.geo_stage12(tables, coeffs, d)
        T = tables[d - 1][:2].contiguous()
        got = cs.geo_jac_fields(Y, T, nurbs)
        ref = cs.geo_jac_fields_plain(Y, T, nurbs)
        sync(device)
        err, rel = compare('geo_jac ' + name[:9], got, ref, 1e-12)
        cases[name] = dict(
            max_abs_err=err, rel=rel, shape=list(got.shape),
            ms=time_ms(lambda: cs.geo_jac_fields(Y, T, nurbs), device),
            plain_ms=time_ms(lambda: cs.geo_jac_fields_plain(Y, T, nurbs),
                             device, reps=3))
        del Y, got, ref
    out = {'geo_jac_fields': dict(cases['2d_n128_nurbs'], cases=cases)}

    # K5 on the plan's combos of the n=128 path
    plan = asm._fold_plan or [(t, False) for t in range(len(asm.combos))]
    combos = [asm.combos[t] for t, _m in plan]
    arrays = asm.device_arrays()
    got = torch.stack(cv.combo_fields(asm, arrays, combos))
    ref = torch.stack(cv.combo_fields_plain(asm, arrays, combos))
    sync(device)
    err, rel = compare('vform_fields', got, ref, 1e-12)
    prog = asm._program(combos)
    Y, P = cv.leaf_rows(prog, arrays)
    lib = [k for k in _cuda.GEN_BUILDS if 'vform_fields' in k][-1]
    build = dict(_cuda.GEN_BUILDS[lib], path=lib)
    for line in build['log'].splitlines():
        if 'registers' in line or 'spill' in line:
            log('  ' + line.strip())
    _cuda._gen_libs.clear()              # the next load finds the disk copy
    t0 = time.perf_counter()
    _cuda.build_generated('vform_fields', prog.source)
    build['cached_load_s'] = time.perf_counter() - t0
    out['vform_fields'] = dict(
        max_abs_err=err, rel=rel, shape=list(got.shape),
        leaves=len(prog.leaves), params=len(prog.params),
        instrs=len(prog.instrs),
        ms=time_ms(lambda: cv.vform_fields(prog, Y, P), device),
        wrapper_ms=time_ms(lambda: cv.combo_fields(asm, arrays, combos),
                           device),
        plain_ms=time_ms(lambda: cv.combo_fields_plain(asm, arrays, combos),
                         device, reps=3),
        build=build, host_setup_first_ms=1e3 * t_setup)
    log('  K5 program: %d leaves, %d params, %d SSA instrs, %d fields; '
        'nvcc %.2f s, cached load %.3f s; first host setup %.1f ms'
        % (len(prog.leaves), len(prog.params), len(prog.instrs),
           len(combos), build['seconds'], build['cached_load_s'],
           1e3 * t_setup))
    for name, r in out.items():
        log('  %-16s kernel %.4f ms   plain %.4f ms' % (name, r['ms'],
                                                      r['plain_ms']))
    return out


def solve_convdiff(asm, data, f, device):
    """Dirichlet restriction of the assembled convection-diffusion matrix
    and its GMRES(30) solve to 1e-10, fastdiag right preconditioner."""
    from pyiga_tpu_torch import solvers
    from pyiga_tpu_torch.ops import fastdiag, matfree
    from pyiga_tpu_torch.ops.mlmatvec import MLMatvecOperator

    free = fastdiag.interior_dofs(asm.kvs0)
    t0 = time.perf_counter()
    A = matfree.RestrictedOperator(MLMatvecOperator(data, asm.structure),
                                   free)
    P = fastdiag.fastdiag_precond(asm.kvs0, dirichlet=True, device=device)
    b = torch.as_tensor(np.asarray(f).ravel()[free], dtype=torch.float64,
                        device=device)
    sync(device)
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, iters = solvers.gmres(A, b, tol=1e-10, restart=30, precond=P)
    sync(device)
    t_solve = time.perf_counter() - t0
    res = float(torch.linalg.vector_norm(b - A(x))
                / torch.linalg.vector_norm(b))
    if x.shape != (len(free),) or not bool(torch.isfinite(x).all()):
        raise RuntimeError('GMRES solution has shape %s or is not finite'
                           % (tuple(x.shape),))
    return x, iters, res, t_setup, t_solve


def check_vform_small(device):
    """Phase 4d: the VForm path (assembly and GMRES) at 2D n=16 on the
    card against the CPU run of the plain versions."""
    cpu = torch.device('cpu')
    outs = {}
    for dev in (device, cpu):
        _, _, asm, asm_f = convdiff_setup(16, dev)
        data = asm.run_device()[(None, None)]
        x, iters, res, _, _ = solve_convdiff(asm, data,
                                             asm_f.assemble_vector(), dev)
        outs[dev.type] = (data.cpu(), x.cpu(), iters, res)
    (Dg, xg, ig, rg), (Dc, xc, ic, rc) = outs[device.type], outs['cpu']
    err_D = float((Dg - Dc).abs().max() / Dc.abs().max())
    err_x = float((xg - xc).abs().max() / xc.abs().max())
    log('  2D n=16 card vs CPU: A data rel %.3e  x rel %.3e  GMRES iters '
        '%s vs %s  res %.2e / %.2e' % (err_D, err_x, ig, ic, rg, rc))
    if ig != ic:
        log('  iteration counts differ by %d: the card sums the compact '
            'matvec by atomic scatter-adds, in another order than the CPU,'
            ' which moves the Givens residual estimate across tol'
            % abs(ig - ic))
    if not (err_D <= 1e-12 and err_x <= 1e-9 and abs(ig - ic) <= 1
            and rg <= 1e-9):
        raise RuntimeError('card VForm path disagrees with the CPU run')
    return dict(n16_data_rel=err_D, n16_x_rel=err_x, n16_iters_card=ig,
                n16_iters_cpu=ic, n16_res_card=rg, n16_res_cpu=rc)


def run_convdiff(device, n=128):
    """Phase 7: the convection-diffusion VForm path at 2D p=3 n=128,
    timed after synchronizes: assembler setup, ``run_device()`` (best of
    3 after a warm call, as bench.py times it), ``assemble_vector()``,
    the whole ``assemble.assemble`` call with its CSR expansion, and the
    GMRES solve."""
    from pyiga_tpu_torch import assemble

    def best_of_3(fn):
        fn()
        sync(device)
        best = np.inf
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            sync(device)
            best = min(best, time.perf_counter() - t0)
        return 1e3 * best

    t0 = time.perf_counter()
    kvs, geo, asm, asm_f = convdiff_setup(n, device)
    t_host = 1e3 * (time.perf_counter() - t0)
    t_A = best_of_3(asm.run_device)
    t_f = best_of_3(asm_f.assemble_vector)
    t0 = time.perf_counter()
    A = assemble.assemble(CONVDIFF, kvs, geo=geo, b=CONV_B, device=device)
    t_whole = 1e3 * (time.perf_counter() - t0)
    data = asm.run_device()[(None, None)]
    f = asm_f.assemble_vector()
    x, iters, res, t_setup, t_solve = solve_convdiff(asm, data, f, device)
    ndofs = A.shape[0]
    rec = dict(n=n, p=3, ndofs=ndofs, n_free=int(x.shape[0]),
               nnz=int(A.nnz), combos=len(asm.combos),
               fold_plan=asm._fold_plan, t_host_setup_ms=t_host,
               t_run_device_ms=t_A, t_assemble_vector_ms=t_f,
               t_assemble_csr_ms=t_whole, t_precond_setup_ms=1e3 * t_setup,
               t_solve_ms=1e3 * t_solve, iters=iters, residual=res)
    log('  2D p=3 n=%d: %d dofs (%d free), %d combos; host setup %.1f ms'
        % (n, ndofs, rec['n_free'], rec['combos'], t_host))
    log('  run_device %.2f ms  assemble_vector %.2f ms  assemble()+CSR '
        '%.1f ms' % (t_A, t_f, t_whole))
    log('  GMRES %d iterations in %.2f ms (precond setup %.1f ms)  true '
        'rel residual %.3e' % (iters, rec['t_solve_ms'],
                               rec['t_precond_setup_ms'], res))
    if not res <= 1e-9:
        raise RuntimeError('relative residual %.3e above 1e-9' % res)
    return rec


def localmg_space(n0, num_levels=3):
    """The bench's hierarchy (``bench.py`` ``run_localmg``): 2D p=3,
    disparity 1, Dirichlet on all four sides, refined toward the (1, 1)
    corner."""
    from pyiga_tpu_torch import bspline
    from pyiga_tpu_torch.hierarchical import HSpace
    hs = HSpace(2 * (bspline.make_knots(3, 0.0, 1.0, n0),), disparity=1,
                bdspecs=[(0, 0), (0, 1), (1, 0), (1, 1)])
    for lv in range(num_levels - 1):
        thr = 1.0 - 2.0 ** (-lv - 1)
        hs.refine_region(lv, lambda *X: min(X) > thr)
    return hs


def localmg_discretization(hs, device):
    from pyiga_tpu_torch import geometry, vform
    from pyiga_tpu_torch.hierarchical import HDiscretization
    return HDiscretization(hs, vform.stiffness_vf(dim=2),
                           {'geo': geometry.unit_square(),
                            'f': lambda *x: 1.0}, device=device)


def localmg_solver(hs, A, device, impl):
    """The device solver of ``solve_hmultigrid``'s defaults ('cell_supp',
    'gs', 2 steps) with `impl` forced."""
    from pyiga_tpu_torch import solvers
    from pyiga_tpu_torch.ops.mg import DeviceMGSolver
    Ps = hs.virtual_hierarchy_prolongators()
    return DeviceMGSolver(solvers.galerkin_hierarchy(A, Ps), Ps,
                          hs.indices_to_smooth('cell_supp'),
                          ('forward', 'backward'), 2,
                          active_dofs=hs.non_dirichlet_dofs(),
                          smoother_impl=impl, device=device)


def check_vcycle_kernel(device):
    """Phase 4e: K6 against its plain version, one V-cycle from a seeded
    iterate and right-hand side, on the operands of the (24, 3) and
    (48, 3) hierarchies (1e-13 relative to the largest entry)."""
    from pyiga_tpu_torch.ops import cuda_mg
    cpu = torch.device('cpu')
    cases = {}
    for n0, L in LOCALMG_ITERS:
        hs = localmg_space(n0, L)
        A = localmg_discretization(hs, cpu).assemble_matrix()
        t0 = time.perf_counter()
        s = localmg_solver(hs, A, device, 'fused')
        sync(device)
        t_setup = time.perf_counter() - t0
        rng = np.random.RandomState(n0)
        x = torch.as_tensor(rng.rand(A.shape[0]), dtype=torch.float64,
                            device=device)
        f = torch.as_tensor(rng.rand(A.shape[0]), dtype=torch.float64,
                            device=device)
        got, ref = cuda_mg.vcycle(s.ops, x, f), cuda_mg.vcycle_plain(s.ops,
                                                                    x, f)
        sync(device)
        err, rel = compare('vcycle (%d,%d)' % (n0, L), got[0], ref[0], 1e-13)
        err2, rel2 = compare('res2 (%d,%d)' % (n0, L), got[1].reshape(1),
                             ref[1].reshape(1), 1e-13)
        m = [int(lev['S'].shape[0]) for lev in s.ops.levels[1:]]
        cases['%d_%d' % (n0, L)] = dict(
            max_abs_err=err, rel=rel, res2_rel=rel2, n=s.ops.n, m=m,
            m0=int(s.ops.ind0.shape[0]),
            blocks=cuda_mg._grid_blocks(device),
            solver_setup_ms=1e3 * t_setup,
            ms=time_ms(lambda: cuda_mg.vcycle(s.ops, x, f), device, reps=20),
            plain_ms=time_ms(lambda: cuda_mg.vcycle_plain(s.ops, x, f),
                             device, reps=5))
        log('  (%d,%d): n %s  m %s  m0 %d  blocks %d  solver setup %.0f ms'
            % (n0, L, s.ops.n, m, cases['%d_%d' % (n0, L)]['m0'],
               cases['%d_%d' % (n0, L)]['blocks'], 1e3 * t_setup))
        del s, x, f, got, ref
    out = {'vcycle': dict(cases['24_3'], cases=cases)}
    for name, r in cases.items():
        log('  vcycle %-9s kernel %.4f ms   plain %.4f ms' % (name, r['ms'],
                                                             r['plain_ms']))
    return out


def check_localmg_small(device):
    """Phase 4f: the local-MG path at n0=6, L=3 ('gs'): assembly and the
    device solve on the card against the CPU run of the plain versions
    and the host path; equal iteration counts, x to 1e-12."""
    from pyiga_tpu_torch import solvers
    cpu = torch.device('cpu')
    hs = localmg_space(6)
    outs = {}
    for dev in (device, cpu):
        hd = localmg_discretization(hs, dev)
        A, f = hd.assemble_matrix(), hd.assemble_rhs()
        x, it = solvers.solve_hmultigrid(hs, A, f, tol=1e-8,
                                         relax_backend='device', device=dev)
        outs[dev.type] = (A, f, x, it)
    (Ag, fg, xg, ig), (Ac, fc, xc, ic) = outs[device.type], outs['cpu']
    xh, ih = solvers.solve_hmultigrid(hs, Ac, fc, tol=1e-8,
                                      relax_backend='host')
    err_A = float(abs(Ag - Ac).max() / abs(Ac).max())
    err_f = float(np.abs(fg - fc).max() / np.abs(fc).max())
    err_x = float(np.abs(xg - xc).max() / np.abs(xc).max())
    err_xh = float(np.abs(xg - xh).max() / np.abs(xh).max())
    log('  n0=6 L=3 (%d dofs) card vs CPU: A rel %.3e  f rel %.3e  x rel '
        '%.3e (host path %.3e)  iterations %s / %s / host %s'
        % (hs.numdofs, err_A, err_f, err_x, err_xh, ig, ic, ih))
    if not (ig == ic == ih and err_A <= 1e-13 and err_f <= 1e-13
            and err_x <= 1e-12 and err_xh <= 1e-12):
        raise RuntimeError('card local-MG path disagrees with the CPU run')
    return dict(n6_dofs=hs.numdofs, n6_A_rel=err_A, n6_f_rel=err_f,
                n6_x_rel=err_x, n6_x_host_rel=err_xh, n6_iters_card=ig,
                n6_iters_cpu=ic, n6_iters_host=ih)


def run_localmg(device, n0, L=3, impl=None):
    """Phases 8/8b: the local-MG path the way ``bench.py`` ``run_localmg``
    times it: assembly (``assemble_matrix`` + ``assemble_rhs``) is the min
    of 3 after 2 warm-up builds; the solve the min of 2 at tol 1e-8 after
    a warm-up at tol 1e-2, through ``solve_hmultigrid`` (`impl` None) or a
    ``DeviceMGSolver`` with ``smoother_impl=impl``.  Holds the count to
    the port's host path in this process and to the JAX package's."""
    from pyiga_tpu_torch import _cuda, solvers
    t0 = time.perf_counter()
    hs = localmg_space(n0, L)
    t_space = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(device)
    _cuda.reset_launches()

    def build():
        hd = localmg_discretization(hs, device)
        t0 = time.perf_counter()
        A = hd.assemble_matrix()
        t1 = time.perf_counter()
        f = hd.assemble_rhs()
        return A, f, t1 - t0, time.perf_counter() - t1

    t0 = time.perf_counter()
    build()
    t_first = time.perf_counter() - t0
    build()
    best = None
    for _ in range(3):
        A, f, t_A, t_f = build()
        if best is None or t_A + t_f < sum(best):
            best = (t_A, t_f)
    t0 = time.perf_counter()
    if impl is None:
        def solve(tol):
            return solvers.solve_hmultigrid(hs, A, f, tol=tol, device=device)
    else:
        solver = localmg_solver(hs, A, device, impl)

        def solve(tol):
            return solver.solve(f, tol=tol)
    solve(1e-2)     # on the solve_hmultigrid path this builds the solver
    sync(device)
    t_warm = time.perf_counter() - t0
    t_slv = np.inf
    for _ in range(2):
        t0 = time.perf_counter()
        x, iters = solve(1e-8)
        t_slv = min(t_slv, time.perf_counter() - t0)
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device)

    t0 = time.perf_counter()
    xh, it_host = solvers.solve_hmultigrid(hs, A, f, tol=1e-8,
                                           relax_backend='host')
    t_host = time.perf_counter() - t0
    free = hs.non_dirichlet_dofs()
    res = float(np.linalg.norm((f - A @ x)[free]) / np.linalg.norm(f[free]))
    x_rel = float(np.abs(x - xh).max() / np.abs(xh).max())
    rec = dict(n0=n0, levels=L, p=3, impl=impl or 'auto', ndofs=hs.numdofs,
               nnz=int(A.nnz), numactive=list(hs.numactive),
               t_space_ms=1e3 * t_space, t_first_build_ms=1e3 * t_first,
               t_assemble_matrix_ms=1e3 * best[0],
               t_assemble_rhs_ms=1e3 * best[1],
               t_assembly_ms=1e3 * sum(best),
               t_solver_setup_and_warm_solve_ms=1e3 * t_warm,
               t_solve_ms=1e3 * t_slv, iters=iters, iters_host=it_host,
               t_host_solve_ms=1e3 * t_host, residual=res, x_rel_host=x_rel,
               dof_per_s=hs.numdofs / (sum(best) + t_slv),
               peak_device_bytes=int(peak), launches=launches)
    log('  (%d,%d) %s: %d dofs, nnz %d; first build %.0f ms'
        % (n0, L, rec['impl'], hs.numdofs, A.nnz, 1e3 * t_first))
    log('  assembly %.2f ms (matrix %.2f + rhs %.2f)  solver setup + warm '
        'solve %.1f ms  solve %.2f ms  %.0f dof/s'
        % (rec['t_assembly_ms'], rec['t_assemble_matrix_ms'],
           rec['t_assemble_rhs_ms'], rec['t_solver_setup_and_warm_solve_ms'],
           rec['t_solve_ms'], rec['dof_per_s']))
    log('  iterations %s (host path %s in %.1f ms, JAX %d)  rel residual '
        '%.3e  x vs host %.3e  peak %.1f MB'
        % (iters, it_host, 1e3 * t_host, LOCALMG_ITERS[(n0, L)], res, x_rel,
           peak / 2 ** 20))
    log('  launches: %s' % launches)
    if x.shape != (hs.numdofs,) or not np.isfinite(x).all():
        raise RuntimeError('local-MG solution has shape %s or is not finite'
                           % (x.shape,))
    if not (iters == it_host == LOCALMG_ITERS[(n0, L)]):
        raise RuntimeError('local-MG iterations %s, host path %s, expected %d'
                           % (iters, it_host, LOCALMG_ITERS[(n0, L)]))
    if not (res <= 1e-8 and x_rel <= 1e-10):
        raise RuntimeError('local-MG residual %.3e or x vs host %.3e too '
                           'large' % (res, x_rel))
    missing = [k for k in LOCALMG_KERNELS if launches[k] <= 0]
    if missing:
        raise RuntimeError('local-MG path never launched %s' % missing)
    return rec


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from pyiga_tpu_torch import _cuda

    device = torch.device('cuda', 0)
    card = nvidia_smi()
    log('phase 1: %s | torch %s | CUDA %s | %s x%d'
        % (card, torch.__version__, torch.version.cuda,
           torch.cuda.get_device_name(0), torch.cuda.device_count()))

    t0 = time.perf_counter()
    _cuda.library()
    t_build = time.perf_counter() - t0
    log('phase 2: kernels built+loaded in %.1f s (nvcc %.1f s) -> %s'
        % (t_build, _cuda.BUILD_INFO['seconds'], _cuda.BUILD_INFO['path']))
    for line in _cuda.BUILD_INFO['log'].splitlines():
        if 'registers' in line or 'spill' in line or 'Compiling' in line:
            log('  ' + line.strip())

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log('phase 3: matmul.allow_tf32=%s cudnn.allow_tf32=%s'
        % (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32))

    log('phase 4: kernels vs plain versions at the 3D n=48 shapes')
    kern = check_kernels(device)
    torch.cuda.empty_cache()

    log('phase 4b: whole path on small inputs')
    small = check_small(device)
    torch.cuda.empty_cache()

    log('phase 4c: K1 jac kind and generated K5 vs plain versions')
    kern.update(check_vform_kernels(device))
    torch.cuda.empty_cache()

    log('phase 4d: VForm path on small inputs, card vs CPU')
    small.update(check_vform_small(device))
    torch.cuda.empty_cache()

    log('phase 5: main path, 3D p=3 twisted box n=48, float64')
    _cuda.reset_launches()
    main3 = run_main_path(3, 48, device)
    launches = dict(_cuda.LAUNCHES)
    log('  launches: %s' % launches)
    missing = [k for k in POISSON_KERNELS if launches[k] <= 0]
    if missing:
        raise RuntimeError('main path never launched %s' % missing)
    main3['warm'] = run_main_path(3, 48, device)
    torch.cuda.empty_cache()

    log('phase 6: main path, 2D p=3 NURBS quarter annulus n=128, float64')
    _cuda.reset_launches()
    main2 = run_main_path(2, 128, device)
    main2['launches'] = dict(_cuda.LAUNCHES)
    log('  launches: %s' % main2['launches'])
    if any(main2['launches'][k] <= 0 for k in POISSON_KERNELS):
        raise RuntimeError('2D main path missed a kernel')
    main2['warm'] = run_main_path(2, 128, device)
    torch.cuda.empty_cache()

    log('phase 7: VForm path, 2D p=3 convection-diffusion n=128, float64')
    _cuda.reset_launches()
    conv = run_convdiff(device)
    conv['launches'] = dict(_cuda.LAUNCHES)
    log('  launches: %s' % conv['launches'])
    missing = [k for k in VFORM_KERNELS if conv['launches'][k] <= 0]
    if missing:
        raise RuntimeError('VForm path never launched %s' % missing)
    launches.update((k, conv['launches'][k])
                    for k in ('geo_jac_fields', 'vform_fields'))
    log('  warm:')
    conv['warm'] = run_convdiff(device)
    torch.cuda.empty_cache()

    log('phase 4e: K6 (V-cycle) vs its plain version, (24,3) and (48,3)')
    kern.update(check_vcycle_kernel(device))
    torch.cuda.empty_cache()

    log('phase 4f: local-MG path on small inputs, card vs CPU')
    small.update(check_localmg_small(device))
    torch.cuda.empty_cache()

    log('phase 8: local-MG path, 2D p=3 HB (24,3), float64')
    lmg = run_localmg(device, 24)
    launches['vcycle'] = lmg['launches']['vcycle']
    log('  warm:')
    lmg['warm'] = run_localmg(device, 24)
    torch.cuda.empty_cache()
    log('phase 8b: local-MG path, 2D p=3 HB (48,3), smoother_impl=fused')
    lmg48 = run_localmg(device, 48, impl='fused')

    kernels = [dict(name=k, route=KERNELS[k][0], source=KERNELS[k][1],
                    replaces=KERNELS[k][2], launches=launches[k],
                    max_abs_err=kern[k]['max_abs_err'], ms=kern[k]['ms'],
                    plain_ms=kern[k]['plain_ms']) for k in KERNELS]
    record = dict(card=card, torch=torch.__version__,
                  cuda=torch.version.cuda, build_s=t_build, kernels=kern,
                  small=small, main3d=main3, main2d=main2,
                  convdiff2d=conv, localmg_24_3=lmg, localmg_48_3=lmg48)
    os.makedirs(os.path.join(REPO, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(REPO, 'chiprun_out', 'chip_smoke.json'), 'w') as f:
        json.dump(record, f, indent=1, default=str)

    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
