"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pyiga_tpu_torch/csrc``, holds each
kernel against its plain PyTorch version on the card at the shapes of the
3D p=3 n=48 main path (the stage K2 and the fold K3, both on the f64
tensor cores, and the geometry fields K1, also at ragged shapes and
launched twice for bitwise-equal output; K1's ``jac`` and ``mass`` kinds
likewise in phases 4c and 4g), checks the whole path on small inputs
against the
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
solve_hmultigrid`` -> ``DeviceMGSolver``, one K6 launch per solve: every
V-cycle and the convergence test run inside it) has these phases: K6
against its plain version on the (24, 3) and (48, 3) hierarchies, one
V-cycle from a seeded iterate and the whole solve against the host loop
over the plain cycle, with each step of a cycle timed from a traced
launch (4e); the path at n0=6 on the card against the CPU (4f); the bench
shape (24, 3), cold and warm, held to 29 iterations and to the port's
host path in the same process, one K6 launch per solve (8); and (48, 3)
through ``solve_hmultigrid(hs, A, f)`` with its defaults (above the JAX
package's dense cutoff, where ``'auto'`` takes K6 up to
``tri_block_cutoff``), held to 27 (8b).

The mass and time-stepping paths: K1's ``mass`` kind and K1' (the
stiffness fields of a host-evaluated Jacobian) against their plain
versions (4g); ``assemble.mass`` / ``assemble.stiffness`` on the card
against the golden fixtures and the small heat problem card vs CPU (4h);
the 3D p=3 n=48 mass path (``MassAssembler.assemble_banded`` and the
compact ``assemble``, ``M 1`` against ``assemble('v * dx')``) (9); the
heat equation ``M u' = f - K u`` on the NURBS quarter annulus at 2D p=3
n=128, assembled on the card and integrated by the host ``esdirk34`` and
``ros3p`` (10); and on the polar quarter annulus given as a
``UserFunction`` at n=60, integrated by ``DeviceRosenbrockScheme`` against
the host scheme's step sequence with no host fallback (10b).

The fused stage-2 + fold tail (K7, the JAX package's ``PYIGA_TAIL_FUSED``
switch) and the 3D Dirichlet Poisson path of ``examples/poisson_3d.py``
with non-zero data: K7's transposed stage and tail kernel (both on the
f64 tensor cores; phase 2 finds the DMMA instructions of K2, K3 and K7 in
the built library's SASS) against their plain versions at the n=48 flat-banded
shapes and at ragged shapes around the DMMA tiles, each launched twice
to show bitwise-equal results (4i); the headline
``assemble_banded()`` with the switch on, then off, in one process, the
fused operator solved to the headline's 25 iterations (11); the
Dirichlet path at 3D p=3 n=48 on the twisted box with the harmonic data
``g = x + 2y + 3z`` (``StiffnessAssembler.assemble`` through K7 ->
``compute_dirichlet_bcs`` -> the lifted right-hand side by a
``MatrixFreeOperator`` -> ``cg_ir`` to 1e-10 -> the L2 error by
``integrate``), cold and warm (12); and the same path at n=8, card against
CPU (12b).  Any failed check raises (nonzero exit).

Every kernel's entry in the JSON line has its time, its plain version's,
the time of one PyTorch call computing the same function where one
exists (``library_ms``; used nowhere in the port) and ``bound_ms``: the
larger of its bytes over 3.35 TB/s and its operations over the
datasheet's peak (67 TFLOP/s for f64 on the tensor cores where the
function is a matrix product, 34 TFLOP/s for f64 FMA otherwise, 67 for
f32), both counted from this run's inputs.

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
    'fields': ('cuda', 'pyiga_tpu_torch/csrc/fields.cu',
               'pyiga_tpu/ops/pallas_sumfac.py:1087'),
    # the same pallas_call with kind='jac'
    'geo_jac_fields': ('cuda', 'pyiga_tpu_torch/csrc/fields.cu',
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
    # the K1 call site with kind='mass' (through mass_fields_pallas)
    'mass_fields': ('cuda', 'pyiga_tpu_torch/csrc/fields.cu',
                    'pyiga_tpu/ops/pallas_sumfac.py:1087'),
    # K1': stiffness_fields_pallas's host-Jacobian branch
    'host_jac_fields': ('cuda', 'pyiga_tpu_torch/csrc/fields.cu',
                        'pyiga_tpu/ops/pallas_sumfac.py:1163'),
    # K7: the transposed stage and the fused stage-2 + fold tail
    'stage_T': ('cuda', 'pyiga_tpu_torch/csrc/sumfac.cu',
                'pyiga_tpu/ops/pallas_sumfac.py:436'),
    'tail_fused': ('cuda', 'pyiga_tpu_torch/csrc/sumfac.cu',
                   'pyiga_tpu/ops/pallas_sumfac.py:563'),
}
# the kernels each main path runs
POISSON_KERNELS = ('fields', 'stage', 'fold', 'flat_banded_f64',
                   'flat_banded_f32')
VFORM_KERNELS = ('geo_jac_fields', 'vform_fields', 'stage', 'fold')
LOCALMG_KERNELS = ('vcycle', 'geo_jac_fields', 'vform_fields', 'stage',
                   'fold')
MASS_KERNELS = ('mass_fields', 'stage', 'fold', 'flat_banded_f64')
HEAT_KERNELS = ('mass_fields', 'fields', 'stage', 'fold')
USERGEO_KERNELS = ('host_jac_fields', 'stage', 'fold')
# the headline with the fused tail (phase 11) and the Dirichlet path (12)
TAILFUSED_KERNELS = ('fields', 'stage', 'stage_T', 'tail_fused',
                     'flat_banded_f64', 'flat_banded_f32')
DIRICHLET_KERNELS = ('fields', 'stage', 'stage_T', 'tail_fused')
# phase 10's end times: esdirk34 factors 4 sparse LUs of the 16,641 free
# dofs per step attempt (~2.5 s each on the host), and its start from
# tau0 = 1e-3 rejects 5 attempts, so t = 0.1 would take minutes; t = 3e-4
# keeps it near a minute (5 rejected attempts, 2 accepted)
HEAT_T_END = {'esdirk34': 3e-4, 'ros3p': 0.1}
# (n0, levels) -> the iteration count of the JAX package's host path
LOCALMG_ITERS = {(24, 3): 29, (48, 3): 27}

CONVDIFF = '(inner(grad(u), grad(v)) + dot(b, grad(u)) * v + u * v) * dx'
CONV_B = np.array([3.0, -2.0])

# datasheet peaks of the H100 SXM (at its 700 W limit), per millisecond
HBM_BYTES_PER_MS = 3.35e12 / 1e3
F64_TENSOR_PER_MS = 67e12 / 1e3     # f64 on the tensor cores (DMMA)
F64_FMA_PER_MS = 34e12 / 1e3        # f64 outside the tensor cores
F32_PER_MS = 67e12 / 1e3            # f32 outside the tensor cores


def bound(nbytes, flops, peak_per_ms):
    """The least time the card could take for a function that moves
    `nbytes` (each input read once, each output written once) and does
    `flops` operations at `peak_per_ms`."""
    t_bytes = nbytes / HBM_BYTES_PER_MS
    t_ops = flops / peak_per_ms
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by='bytes' if t_bytes >= t_ops else 'operations',
                bound_bytes=int(nbytes), bound_flops=int(flops))


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def harmonic(x, y, z):
    """The Dirichlet data of phase 12: harmonic, so the discrete solution
    is the interpolant of g o geo on the twisted box."""
    return x + 2 * y + 3 * z


class SquaredError:
    """``(u_h - g)^2`` on a tensor grid (``g`` alone for ``uh=None``), `g`
    taken at the mapped points: the integrand of the L2 error."""

    def __init__(self, uh, geo, g):
        self.uh, self.geo, self.g = uh, geo, g

    def grid_eval(self, grid):
        X = self.geo.grid_eval(grid)
        ref = self.g(*np.moveaxis(X, -1, 0))
        return (ref if self.uh is None else self.uh.grid_eval(grid) - ref) ** 2


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


def sass_dmma(lib_path, kernels=('stage_kernel', 'fold_kernel',
                                 'stage_T_kernel', 'tail_kernel')):
    """DMMA (f64 tensor-core) instructions per kernel in the SASS of the
    built library, by ``cuobjdump --dump-sass`` from the toolkit that
    built it; raises if one of `kernels` has none."""
    from pyiga_tpu_torch import _cuda
    tool = os.path.join(os.path.dirname(_cuda._nvcc()), 'cuobjdump')
    sass = subprocess.run([tool, '--dump-sass', lib_path], check=True,
                          capture_output=True, text=True,
                          timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if 'Function :' in line:
            fn = line.split('Function :')[1].strip()
            counts[fn] = 0
        elif fn is not None and 'DMMA' in line:
            counts[fn] += 1
    found = {k: sum(c for f, c in counts.items() if k in f) for k in kernels}
    log('  SASS DMMA instructions: %s' % found)
    missing = [k for k, c in found.items() if c == 0]
    if missing:
        raise RuntimeError('no DMMA instruction in the SASS of %s' % missing)
    return found


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


# ragged shapes around the DMMA tiles (16-row m tiles, 8-column n tiles,
# 4- and 16-deep k slices, the 64 x 128 block tile of K2 and K7a, K3's
# 192 x 64, K7b's 32-row slab, 192-deep Y2 chunk and 384-column chunk):
# K < 4 (the twisted box's geometry stages), K not a multiple of 16, odd
# and even M and R, R below one tile, the 2D n=128 shapes (K = 512).
# K2 and K7a (K, R, M)
STAGE_RAGGED = ((2, 24, 192), (4, 1152, 192), (7, 45, 13), (33, 300, 70),
                (200, 1001, 5), (512, 512, 917), (192, 130, 357))
STAGE_T_RAGGED = ((7, 45, 13), (33, 300, 70), (200, 1001, 5),
                  (192, 130, 357))
# K3 (K, R, M, terms, tables), term t on table t % tables: one term, one
# group of all terms, groups of one, 16 terms and 17 (the wrapper's split)
FOLD_RAGGED = ((3, 100, 11, 2, 1), (7, 45, 13, 1, 1), (33, 300, 70, 3, 2),
               (512, 917, 917, 3, 2), (20, 129, 64, 16, 5),
               (20, 129, 64, 17, 4), (192, 200, 357, 6, 1),
               (9, 64, 130, 5, 5))
# K7b (M1, K2, K3, M2, M3, terms, stage-2 tables, final tables)
TAIL_RAGGED = ((5, 7, 9, 13, 11, 3, 2, 1), (3, 33, 200, 17, 600, 3, 2, 1),
               (4, 18, 30, 35, 45, 1, 1, 1), (3, 13, 21, 40, 70, 16, 3, 2),
               (2, 192, 384, 33, 385, 2, 1, 2))


# K1 (d, nurbs, Q12, QL, nL): D = 2 and 3, NURBS and not, nL = 1..5 (5
# takes the runtime-length loop), odd QL, QL above one block of threads,
# Q12 not a multiple of the 16-row tile, and grids above and below two
# blocks an SM (where the row tile shrinks)
FIELDS_RAGGED = ((2, False, 37, 13, 1), (2, True, 515, 7, 2),
                 (3, False, 1003, 45, 3), (3, True, 4099, 33, 4),
                 (2, False, 261, 301, 5), (3, True, 77, 19, 5),
                 (3, False, 10001, 9, 2), (2, True, 8191, 257, 3))


def check_fields_ragged(kind, device, seed=8):
    """K1's `kind` ('stiffness', 'mass' or 'jac') against its plain
    version at :data:`FIELDS_RAGGED` on seeded inputs shaped like a
    geometry's (positive value tables, centred derivative tables, each
    component's partials dominant along its own axis, NURBS weights near
    1), so that every Jacobian is well conditioned: 1e-13 relative to the
    largest output, each launched twice for bitwise-equal output."""
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    fn, plain = {'stiffness': (cs.fields, cs.fields_plain),
                 'mass': (cs.fields_mass, cs.fields_mass_plain),
                 'jac': (cs.geo_jac_fields, cs.geo_jac_fields_plain)}[kind]
    rng = np.random.RandomState(seed)
    out = {}
    for d, nurbs, Q12, QL, nL in FIELDS_RAGGED:
        C = d + int(nurbs)
        Y = 0.3 * rng.rand(d, C, Q12, nL)
        for t in range(d - 1):
            Y[t, t] += 2.0
        Y[d - 1, :d] += 1.0
        Y[d - 1, d - 1] += 3.0 * np.arange(nL)
        if nurbs:
            Y[:, C - 1] *= 0.2
            Y[d - 1, C - 1] += 1.0
        T = np.stack([rng.rand(QL, nL) + 0.5,
                      np.arange(nL) - (nL - 1) / 2.0
                      + 0.3 * rng.rand(QL, nL)])

        def dev(a):
            return torch.as_tensor(a, dtype=torch.float64, device=device)
        args = (dev(Y), dev(T))
        if kind != 'jac':
            args += (dev(rng.rand(Q12) + 0.5), dev(rng.rand(QL) + 0.5))
        args += (nurbs,)
        got, ref = fn(*args), plain(*args)
        sync(device)
        key = '%dD%s Q12=%d QL=%d nL=%d' % (d, ' NURBS' if nurbs else '',
                                            Q12, QL, nL)
        out[key] = compare('%s %s' % (kind, key), got, ref, 1e-13)
        check_repeat('%s %s' % (kind, key), lambda: fn(*args), got)
    return out


def check_repeat(name, fn, got):
    """A second launch on the same inputs gives bitwise-equal output (no
    atomics, a fixed summation order)."""
    again = fn()
    sync(again.device)
    if not torch.equal(again, got):
        raise RuntimeError('%s: two launches on the same inputs differ'
                           % name)
    return True


def check_kernels(device, n=48, seed=0):
    """Phase 4: each kernel against its plain version on `device`, at the
    shapes of the 3D p=3 main path (n=48 by default).  K2 and K3 (on the
    f64 tensor cores) also at the ragged shapes above, both to 1e-13
    relative to the largest entry and each launched twice (bitwise-equal);
    K3's plain version sums term by term, the kernel per distinct table.
    Yardsticks: one ``torch.matmul`` for K2, one over the terms' operands
    concatenated along K for K3."""
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
    err, rel = compare('fields', got, ref, 1e-13)
    check_repeat('fields', lambda: cs.fields(*args), got)
    # per point: the last-axis contraction (C x d dots of nL) + det/inverse
    d, C, _, nL = Y.shape
    out['fields'] = dict(max_abs_err=err, rel=rel,
                         shape=list(got.shape),
                         ms=time_ms(lambda: cs.fields(*args), device),
                         plain_ms=time_ms(lambda: cs.fields_plain(*args),
                                          device, reps=3),
                         library_ms=None,
                         **bound(nbytes(Y, T, w12, wL, got),
                                 got[0].numel() * (2 * C * d * nL + 100),
                                 F64_FMA_PER_MS))
    out['fields']['repeat_equal'] = True
    out['fields']['ragged'] = check_fields_ragged('stiffness', device)
    del Y, got, ref, args

    # K2 at both chain-stage shapes, real banded tables
    bws = bd.band_info(asm.structure)
    btabs = asm.tables.banded_term_tables(asm.terms, bws)
    stage_tabs = [torch.as_tensor(btabs[0][k], dtype=f64, device=device)
                  for k in (0, 1)]
    K, M = stage_tabs[0].shape[1], stage_tabs[0].shape[0]
    stage_ms, stage_plain_ms, stage_err, stage_rel = [], [], 0.0, 0.0
    stage_lib_ms, stage_bytes, stage_flops = [], 0, 0
    for R, Tt in ((K * K, stage_tabs[0]), (K * M, stage_tabs[1])):
        X = rand(K, R)
        got, ref = cs.stage(X, Tt), cs.stage_plain(X, Tt)
        sync(device)
        e, r = compare('stage R=%d' % R, got, ref, 1e-13)
        check_repeat('stage R=%d' % R, lambda: cs.stage(X, Tt), got)
        stage_err, stage_rel = max(stage_err, e), max(stage_rel, r)
        stage_ms.append(time_ms(lambda: cs.stage(X, Tt), device))
        stage_plain_ms.append(time_ms(lambda: cs.stage_plain(X, Tt), device))
        # yardstick: one torch.matmul of the same operands
        stage_lib_ms.append(time_ms(lambda: torch.matmul(X.t(), Tt.t()),
                                    device))
        stage_bytes += nbytes(X, Tt, got)
        stage_flops += 2 * K * R * M
        del X, got, ref
    out['stage'] = dict(max_abs_err=stage_err, rel=stage_rel,
                        shapes=[[K, K * K, M], [K, K * M, M]],
                        repeat_equal=True,
                        ms=sum(stage_ms), plain_ms=sum(stage_plain_ms),
                        library_ms=sum(stage_lib_ms),
                        ms_each=stage_ms, plain_ms_each=stage_plain_ms,
                        library_ms_each=stage_lib_ms,
                        **bound(stage_bytes, stage_flops,
                                F64_TENSOR_PER_MS))
    out['stage']['ragged'] = {}
    for Kr, Rr, Mr in STAGE_RAGGED:
        X, Tt = rand(Kr, Rr), rand(Mr, Kr)
        got, ref = cs.stage(X, Tt), cs.stage_plain(X, Tt)
        sync(device)
        key = '%dx%dx%d' % (Kr, Rr, Mr)
        out['stage']['ragged'][key] = compare('stage ' + key, got, ref,
                                              1e-13)
        check_repeat('stage ' + key, lambda: cs.stage(X, Tt), got)

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
    err, rel = compare('fold', got, ref, 1e-13)
    check_repeat('fold', lambda: cs.fold(xs, fold_tabs, idx), got)
    # yardstick: one torch.matmul over the terms' operands concatenated
    # along K (the concatenation is made outside the timed call)
    xcat = torch.cat(xs, dim=0).t()
    tcat = torch.cat([fold_tabs[i] for i in idx], dim=1).t()
    lib_ms = time_ms(lambda: torch.matmul(xcat, tcat), device)
    del xcat, tcat
    # the bound counts one product per distinct table: the terms that
    # share one are summed before it (what the kernel does, and the least
    # work for the function)
    out['fold'] = dict(max_abs_err=err, rel=rel,
                       shape=[len(xs), K, M * M, M], tables=len(fold_tabs),
                       repeat_equal=True,
                       ms=time_ms(lambda: cs.fold(xs, fold_tabs, idx),
                                  device),
                       plain_ms=time_ms(lambda: cs.fold_plain(
                           xs, fold_tabs, idx), device),
                       library_ms=lib_ms,
                       **bound(nbytes(*xs, *fold_tabs, got),
                               2 * K * M * M * M * len(set(idx)),
                               F64_TENSOR_PER_MS))
    del xs, got, ref
    out['fold']['ragged'] = {}
    for Kr, Rr, Mr, nt, ntab in FOLD_RAGGED:
        xs = [rand(Kr, Rr) for _ in range(nt)]
        tabs = [rand(Mr, Kr) for _ in range(ntab)]
        ti = [t % ntab for t in range(nt)]
        got, ref = cs.fold(xs, tabs, ti), cs.fold_plain(xs, tabs, ti)
        sync(device)
        key = '%dx%dx%d,%d terms,%d tables' % (Kr, Rr, Mr, nt, ntab)
        out['fold']['ragged'][key] = compare('fold ' + key, got, ref, 1e-13)
        check_repeat('fold ' + key, lambda: cs.fold(xs, tabs, ti), got)
        del xs, tabs, got, ref

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
        # D, the offsets and x read once, y written once; no single
        # PyTorch call takes the flat banded layout (library_ms null)
        out[name] = dict(
            max_abs_err=err, rel=rel, shape=[C, F],
            ms=time_ms(lambda: bd.flat_banded_matvec(Dd, xd, offs, lead),
                       device, reps=50),
            plain_ms=time_ms(lambda: bd.flat_banded_matvec_plain(
                Dd, xd, offs, lead), device),
            library_ms=None,
            **bound(nbytes(Dd, offs, xd[lead:lead + F], got), 2 * C * F,
                    F64_FMA_PER_MS if dtype == f64 else F32_PER_MS))
        del Dd, xd, got, ref
    for name, r in out.items():
        log('  %-16s kernel %.4f ms   plain %.4f ms   library %s   bound '
            '%.4f ms (%s)' % (name, r['ms'], r['plain_ms'],
                              'none' if r['library_ms'] is None
                              else '%.4f ms' % r['library_ms'],
                              r['bound_ms'], r['bound_by']))
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


# an empty kernel: its event time through ctypes is the floor under any
# kernel timed through its wrapper
EMPTY_SRC = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int launch_empty(void* stream) {
    empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}
"""


def empty_launch_ms(device):
    """Event time of one empty launch, by ctypes, 200 back to back."""
    import ctypes
    from pyiga_tpu_torch import _cuda
    lib = _cuda.build_generated('empty_kernel', EMPTY_SRC)
    lib.launch_empty.argtypes = [ctypes.c_void_p]
    stream = torch.cuda.current_stream(device).cuda_stream
    return time_ms(lambda: lib.launch_empty(stream), device, reps=200)


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
        err, rel = compare('geo_jac ' + name[:9], got, ref, 1e-13)
        check_repeat('geo_jac ' + name[:9],
                     lambda: cs.geo_jac_fields(Y, T, nurbs), got)
        # per point: C x (d + 1) dots of nL, the NURBS quotient
        C, nL = Y.shape[1], Y.shape[3]
        cases[name] = dict(
            max_abs_err=err, rel=rel, shape=list(got.shape),
            ms=time_ms(lambda: cs.geo_jac_fields(Y, T, nurbs), device),
            plain_ms=time_ms(lambda: cs.geo_jac_fields_plain(Y, T, nurbs),
                             device, reps=3),
            library_ms=None,
            **bound(nbytes(Y, T, got),
                    got[0].numel() * (2 * C * (d + 1) * nL + 30),
                    F64_FMA_PER_MS))
        del Y, got, ref
    out = {'geo_jac_fields': dict(cases['2d_n128_nurbs'], cases=cases,
                                  repeat_equal=True,
                                  ragged=check_fields_ragged('jac', device),
                                  empty_launch_ms=empty_launch_ms(device))}
    log('  empty launch (the floor of a wrapper-timed kernel): %.4f ms'
        % out['geo_jac_fields']['empty_launch_ms'])

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
        library_ms=None,
        # the leaves and parameters read once, the fields written once;
        # one operation per SSA instruction and Gauss point
        **bound(nbytes(Y, P, got), len(prog.instrs) * Y.shape[1],
                F64_FMA_PER_MS),
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


def vcycle_bound(ops, x, f):
    """K6's bound for one cycle: every operand of the hierarchy, x and f
    read once, x written once, each triangular inverse T over its occupied
    entries only (from each row's first to its last nonzero); the
    operations counted are T's occupied entries once per listed sweep and
    the coarse inverse once (a lower bound: the ELL products are left
    out)."""
    tensors, seen = [ops.ind0, ops.mask, x, f, x], set()
    nbytes_dense = 8 * ops.Cinv.m ** 2
    flops = 2 * ops.Cinv.m ** 2
    for lev in ops.levels:
        for key, val in lev.items():
            for t in (val if isinstance(val, (list, tuple)) else [val]):
                if id(t) in seen:
                    continue
                seen.add(id(t))
                if key in ('pre', 'post'):
                    nbytes_dense += 8 * t.entries
                else:
                    tensors.append(t)
        for T in lev.get('pre', []) + lev.get('post', []):
            flops += 2 * ops.steps * T.entries
    return bound(nbytes(*tensors) + nbytes_dense, flops, F64_FMA_PER_MS)


def localmg_problem(n0, L, device):
    """Hierarchy, matrix and right-hand side of the local-MG path."""
    hs = localmg_space(n0, L)
    hd = localmg_discretization(hs, device)
    return hs, hd.assemble_matrix(), hd.assemble_rhs()


def check_vcycle_kernel(device):
    """Phase 4e: K6 against its plain version on the operands of the
    (24, 3) and (48, 3) hierarchies: one V-cycle from a seeded iterate and
    right-hand side (1e-13 relative to the largest entry, a second launch
    bitwise equal), and the whole solve from zero for the path's
    right-hand side against the host loop over the plain cycle (the same
    cycle count, x and the per-cycle res2 to 1e-12 relative).  Times: one
    cycle by its own launch, the solve's launch divided by its cycles, and
    from a traced solve the time of each step of its second cycle (block
    0's ``%globaltimer`` after each grid barrier)."""
    from pyiga_tpu_torch.ops import cuda_mg
    cpu = torch.device('cpu')
    cases = {}
    for n0, L in LOCALMG_ITERS:
        hs, A, fh = localmg_problem(n0, L, cpu)
        t0 = time.perf_counter()
        s = localmg_solver(hs, A, device, 'fused')
        sync(device)
        t_setup = time.perf_counter() - t0
        ops = s.ops
        name = '(%d,%d)' % (n0, L)
        rng = np.random.RandomState(n0)
        x = torch.as_tensor(rng.rand(A.shape[0]), dtype=torch.float64,
                            device=device)
        f = torch.as_tensor(rng.rand(A.shape[0]), dtype=torch.float64,
                            device=device)
        got, ref = cuda_mg.vcycle(ops, x, f), cuda_mg.vcycle_plain(ops, x, f)
        sync(device)
        err, rel = compare('vcycle ' + name, got[0], ref[0], 1e-13)
        _, rel2 = compare('res2 ' + name, got[1].reshape(1),
                          ref[1].reshape(1), 1e-13)
        check_repeat('vcycle ' + name, lambda: cuda_mg.vcycle(ops, x, f)[0],
                     got[0])
        fp = torch.as_tensor(fh, dtype=torch.float64, device=device)
        res0 = np.float64(torch.linalg.vector_norm(fp * ops.mask).item())
        xs, its, _, hists = cuda_mg.vcycle_solve_plain(ops, fp, res0, 1e-8,
                                                       100)
        xg, itg, _, histg = cuda_mg.vcycle_solve(ops, fp, res0, 1e-8, 100)
        if itg != its:
            raise RuntimeError('K6 solve %s took %d cycles, the plain loop %d'
                               % (name, itg, its))
        _, rel_x = compare('solve x ' + name, xg, xs, 1e-12)
        _, rel_h = compare('solve res2 ' + name, histg, hists, 1e-12)
        xz = torch.zeros_like(fp)
        solve_ms = time_ms(lambda: cuda_mg.launch_solve(
            ops, xz.zero_(), fp, res0, 1e-8, 100), device, reps=10)
        # a traced solve: the steps of its second cycle
        first, names = cuda_mg.phase_names(ops, first=True), \
            cuda_mg.phase_names(ops)
        trace = torch.zeros(len(first) + len(names) + 1, dtype=torch.int64,
                            device=device)
        traced_ms = time_ms(lambda: cuda_mg.launch_solve(
            ops, xz.zero_(), fp, res0, 1e-8, 100, trace=trace), device,
            reps=10)
        ts = trace.cpu().numpy()[len(first):]
        steps_us = [(nm, 1e-3 * float(t1 - t0_))
                    for nm, t0_, t1 in zip(names, ts[:-1], ts[1:])]
        blocks, smem = cuda_mg._launch_shape(ops, device)
        m = [int(lev['S'].shape[0]) for lev in ops.levels[1:]]
        key = '%d_%d' % (n0, L)
        cases[key] = dict(
            max_abs_err=err, rel=rel, res2_rel=rel2, solve_x_rel=rel_x,
            solve_res2_rel=rel_h, repeat_equal=True, cycles=itg,
            blocks=blocks, smem_bytes=smem, n=ops.n, m=m,
            m0=int(ops.ind0.shape[0]), solver_setup_ms=1e3 * t_setup,
            cycle_ms=time_ms(lambda: cuda_mg.vcycle(ops, x, f), device,
                             reps=20),
            solve_ms=solve_ms, ms=solve_ms / itg, traced_solve_ms=traced_ms,
            cycle2_steps_us=steps_us,
            plain_ms=time_ms(lambda: cuda_mg.vcycle_plain(ops, x, f), device,
                             reps=5),
            library_ms=None, **vcycle_bound(ops, x, f))
        r = cases[key]
        log('  %s: n %s  m %s  m0 %d  %d blocks, %d B shared  solver setup '
            '%.0f ms' % (name, ops.n, m, r['m0'], blocks, smem,
                         1e3 * t_setup))
        log('  vcycle %s one cycle %.4f ms   solve %.4f ms / %d cycles = '
            '%.4f ms a cycle (traced %.4f ms)   plain %.4f ms a cycle   '
            'bound %.4f ms' % (name, r['cycle_ms'], solve_ms, itg, r['ms'],
                               traced_ms, r['plain_ms'], r['bound_ms']))
        log('  cycle 2 steps (us): %s'
            % ', '.join('%s %.2f' % st for st in steps_us))
        del s, ops, x, f, fp, got, ref
    return {'vcycle': dict(cases['24_3'], cases=cases)}


def check_localmg_small(device):
    """Phase 4f: the local-MG path at n0=6, L=3 ('gs'): assembly and the
    device solve on the card against the CPU run of the plain versions
    and the host path; equal iteration counts, x to 1e-12.  Then K6's
    solve with 0 and 1 smoothing steps against its plain loop."""
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
    # K6's solve with 0 and 1 smoothing steps (with none, the kernel adds a
    # barrier between the residual sum and the next cycle's first write to
    # r) against the plain loop on the same operands, at most 20 cycles
    from pyiga_tpu_torch.ops import cuda_mg
    steps_rel = {}
    for steps in (0, 1):
        ops = solvers._device_mg_solver(hs, Ag, 'cell_supp', 'gs', steps,
                                        device).ops
        ft = torch.as_tensor(fg, dtype=torch.float64, device=device)
        res0 = np.float64(torch.linalg.vector_norm(ft * ops.mask).item())
        xk, itk, _, hk = cuda_mg.vcycle_solve(ops, ft, res0, 1e-8, 20)
        xp, itp, _, hp = cuda_mg.vcycle_solve_plain(ops, ft, res0, 1e-8, 20)
        if itk != itp:
            raise RuntimeError('K6 with %d smoothing steps took %d cycles, '
                               'the plain loop %d' % (steps, itk, itp))
        _, rel = compare('solve x steps=%d' % steps, xk, xp, 1e-12)
        compare('solve res2 steps=%d' % steps, hk, hp, 1e-12)
        steps_rel[steps] = dict(cycles=itk, x_rel=rel)
    return dict(n6_dofs=hs.numdofs, n6_A_rel=err_A, n6_f_rel=err_f,
                n6_x_rel=err_x, n6_x_host_rel=err_xh, n6_iters_card=ig,
                n6_iters_cpu=ic, n6_iters_host=ih, n6_smooth_steps=steps_rel)


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
    if impl is None:        # solve_hmultigrid's defaults: the card, 'auto'
        def solve(tol):
            return solvers.solve_hmultigrid(hs, A, f, tol=tol)
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
    # the warm-up solve and the two timed ones: one K6 launch each
    if launches['vcycle'] != 3:
        raise RuntimeError('K6 launched %d times for 3 solves'
                           % launches['vcycle'])
    return rec


def polar_annulus():
    """The quarter annulus in polar parametrization as a ``UserFunction``
    (map and analytic Jacobian, ``[..., i, j] = dF_i/dx_j``): a geometry
    the assemblers evaluate on the host."""
    from pyiga_tpu_torch import geometry
    h = 0.5 * np.pi

    def f(x, y):
        return ((1 + x) * np.cos(h * y), (1 + x) * np.sin(h * y))

    def jac(x, y):
        x, y = np.broadcast_arrays(x, y)
        c, s = np.cos(h * y), np.sin(h * y)
        return np.stack([np.stack([c, -h * (1 + x) * s], axis=-1),
                         np.stack([s, h * (1 + x) * c], axis=-1)], axis=-2)
    return geometry.UserFunction(f, [[0, 1], [0, 1]], jac=jac)


def check_mass_kernels(device, n3=48, n2=128):
    """Phase 4g: K1's mass kind against its plain version at the 3D n=48
    twisted-box shapes and the 2D n=128 NURBS quarter-annulus shapes, and
    K1' at the 2D n=128 shape of the polar annulus (its host Jacobian) and
    at the 3D n=48 shape (the twisted box's Jacobian, made on the card by
    K1's jac kind), all 1e-13 relative to the largest output."""
    from pyiga_tpu_torch.assemblers import MassAssembler, StiffnessAssembler
    from pyiga_tpu_torch import bspline, geometry
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    from pyiga_tpu_torch.ops import geom

    out = {'mass_fields': {}, 'host_jac_fields': {}}
    kv128 = bspline.make_knots(3, 0.0, 1.0, n2)
    kv48 = bspline.make_knots(3, 0.0, 1.0, n3)
    for name, asm in (
            ('3d_n48_bspline', MassAssembler(3 * (kv48,),
                                             geometry.twisted_box(),
                                             device=device)),
            ('2d_n128_nurbs', MassAssembler(2 * (kv128,),
                                            geometry.quarter_annulus(),
                                            device=device))):
        gi = asm.geo_inputs()
        args, grid = cs._spline_stages(gi)
        got, ref = cs.fields_mass(*args), cs.fields_mass_plain(*args)
        sync(device)
        err, rel = compare('mass ' + name[:10], got, ref, 1e-13)
        check_repeat('mass ' + name[:10], lambda: cs.fields_mass(*args), got)
        Y = args[0]
        d, C, _, nL = Y.shape
        out['mass_fields'][name] = dict(
            max_abs_err=err, rel=rel, shape=list(got.shape),
            out_bytes=got.numel() * 8,
            ms=time_ms(lambda: cs.fields_mass(*args), device),
            plain_ms=time_ms(lambda: cs.fields_mass_plain(*args), device,
                             reps=3),
            library_ms=None,
            **bound(nbytes(*args[:4], got),
                    got.numel() * (2 * C * d * nL + 20), F64_FMA_PER_MS))
        if name.startswith('3d'):
            # the twisted box's Jacobian at the 3D shape, for K1' below
            tables = gi['geo_tables_bsp']
            _, jac3 = cs.geometry_fields(tables, gi['geo_coeffs'], False)
            jac3 = jac3.reshape(3, 3, -1).contiguous()
            gw3 = geom.gauss_weight_field(gi['weights']).reshape(-1)
        del asm, gi, args, got, ref

    t0 = time.perf_counter()
    asm = StiffnessAssembler(2 * (kv128,), polar_annulus(), device=device)
    t_host_jac = time.perf_counter() - t0
    gi = asm.geo_inputs()
    jac2, gw2, _ = cs._host_jacobian(gi)
    for name, jac, gw in (('2d_n128_user', jac2, gw2),
                          ('3d_n48_twisted', jac3, gw3)):
        got = cs.host_jac_fields(jac, gw)
        ref = cs.host_jac_fields_plain(jac, gw)
        sync(device)
        err, rel = compare("K1' " + name[:11], got, ref, 1e-13)
        out['host_jac_fields'][name] = dict(
            max_abs_err=err, rel=rel, shape=list(got.shape),
            in_bytes=(jac.numel() + gw.numel()) * 8,
            ms=time_ms(lambda: cs.host_jac_fields(jac, gw), device),
            plain_ms=time_ms(lambda: cs.host_jac_fields_plain(jac, gw),
                             device, reps=3),
            library_ms=None,
            # det, adjugate, the unique products: ~60 operations a point
            **bound(nbytes(jac, gw, got), 60 * gw.numel(), F64_FMA_PER_MS))
        del got, ref
    out['host_jac_fields']['2d_n128_user']['host_jacobian_setup_ms'] = \
        1e3 * t_host_jac
    # headline cases: the shapes of the paths that launch each kernel
    # (phase 9's 3D mass path, phase 10b's user geometry at full width)
    res = {k: dict(v['3d_n48_bspline' if k == 'mass_fields'
                     else '2d_n128_user'], cases=v) for k, v in out.items()}
    res['mass_fields'].update(repeat_equal=True,
                              ragged=check_fields_ragged('mass', device))
    for k, r in res.items():
        for name, c in r['cases'].items():
            log('  %-16s %-15s kernel %.4f ms   plain %.4f ms'
                % (k, name, c['ms'], c['plain_ms']))
    return res


def read_fixture(name, shape=None):
    import scipy.sparse
    data = np.loadtxt(os.path.join(REPO, 'tests', 'fixtures', name),
                      skiprows=1, ndmin=2)
    ij = data[:, :2].astype(np.intp) - 1
    if shape is None:
        shape = (int(ij[:, 0].max()) + 1, int(ij[:, 1].max()) + 1)
    return scipy.sparse.coo_matrix((data[:, 2], (ij[:, 0], ij[:, 1])),
                                   shape=shape).tocsr()


def heat_system(M, K, kvs):
    """The restricted heat equation ``M_ff u' = f_f - K_ff u`` (u = 0 on
    the boundary, f = 1, so ``f = M 1``), scaled by ``n**2`` (n the spans
    per axis) so that M's entries are O(1): the DIRK stage Newton stops
    at an absolute residual of 1e-4.  Returns ``(M_ff, K_ff, f_f)``."""
    from pyiga_tpu_torch.ops.fastdiag import interior_dofs
    free = interior_dofs(kvs)
    s = float(kvs[0].numspans ** 2)
    Mf = (s * M)[free][:, free].tocsr()
    Kf = (s * K)[free][:, free].tocsr()
    f = s * (M @ np.ones(M.shape[0]))[free]
    return Mf, Kf, f


class CountingScheme:
    """A scheme proxy counting step attempts (accepted and rejected)."""

    def __init__(self, scheme):
        self.scheme, self.attempts = scheme, 0

    def step(self, *args, **kwargs):
        self.attempts += 1
        return self.scheme.step(*args, **kwargs)

    def truncated(self):
        return self.scheme.truncated()


def integrate_host(name, Mf, Kf, f, tol=1e-5, tau0=1e-3, t_end=0.1):
    """Adaptive integration of the heat system by the host scheme of
    `name`; returns ``(times, states, attempts, seconds)``."""
    from pyiga_tpu_torch import solvers
    coeffs = getattr(solvers, 'coeffs_' + name)()
    if name.startswith('ros') or name == 'rodasp':
        scheme, order = solvers._RosenbrockScheme(*coeffs[:4]), coeffs[4]
    else:
        scheme, order = solvers._DIRKScheme(coeffs[0]), coeffs[1]
    scheme = CountingScheme(scheme)
    x0 = np.zeros(Mf.shape[0])
    t0 = time.perf_counter()
    ts, xs = solvers._integrate_adaptive(
        scheme, order, Mf, lambda x: f - Kf @ x, lambda x: -Kf, x0, tau0,
        t_end, tol)
    return ts, xs, scheme.attempts, time.perf_counter() - t0


def check_mass_small(device):
    """Phase 4h: ``assemble.mass`` / ``assemble.stiffness`` on the card
    against the four golden fixtures (1e-14 abs), and the small heat
    problem (2D p=3 n=8 NURBS quarter annulus) assembled on the card and
    on the CPU, integrated by esdirk34 and ros3p: identical step times."""
    from pyiga_tpu_torch import assemble, bspline, geometry
    out = {}
    for kind, fix, geo, p, n, d in (
            ('mass', 'poisson_neu_d2_p3_n15_mass', 'bspline_quarter_annulus',
             3, 15, 2),
            ('stiffness', 'poisson_neu_d2_p3_n15_stiff',
             'bspline_quarter_annulus', 3, 15, 2),
            ('mass', 'poisson_neu_d3_p2_n10_mass', 'twisted_box', 2, 10, 3),
            ('stiffness', 'poisson_neu_d3_p2_n10_stiff', 'twisted_box', 2,
             10, 3)):
        kvs = d * (bspline.make_knots(p, 0.0, 1.0, n),)
        A = getattr(assemble, kind)(kvs, getattr(geometry, geo)(),
                                    device=device)
        err = float(abs(A - read_fixture(fix + '.mtx.gz', A.shape)).max())
        log('  %-30s card vs golden fixture: max abs err %.3e' % (fix, err))
        if not err <= 1e-14:
            raise RuntimeError('card assembly misses fixture %s' % fix)
        out[fix] = err

    kvs = 2 * (bspline.make_knots(3, 0.0, 1.0, 8),)
    systems = {}
    for dev in (device, torch.device('cpu')):
        geo = geometry.quarter_annulus()
        systems[dev.type] = heat_system(
            assemble.mass(kvs, geo, device=dev),
            assemble.stiffness(kvs, geo, device=dev), kvs)
    (Mg, Kg, fg), (Mc, Kc, fc) = systems[device.type], systems['cpu']
    err_M = float(abs(Mg - Mc).max() / abs(Mc).max())
    err_K = float(abs(Kg - Kc).max() / abs(Kc).max())
    out['heat_n8'] = dict(M_rel=err_M, K_rel=err_K)
    for name in ('esdirk34', 'ros3p'):
        tg, xg, ag, _ = integrate_host(name, Mg, Kg, fg)
        tc, xc, ac, _ = integrate_host(name, Mc, Kc, fc)
        dt = (float(np.abs(np.subtract(tg, tc)).max())
              if len(tg) == len(tc) else np.inf)
        dx = float(np.abs(xg[-1] - xc[-1]).max() / np.abs(xc[-1]).max())
        log('  heat n=8 %-8s card vs CPU: M rel %.3e  K rel %.3e  steps '
            '%d/%d (attempts %d/%d)  times max diff %.3e  x rel %.3e'
            % (name, err_M, err_K, len(tg) - 1, len(tc) - 1, ag, ac, dt, dx))
        if not (err_M <= 1e-13 and err_K <= 1e-13 and ag == ac
                and dt <= 1e-12 and dx <= 1e-10):
            raise RuntimeError('card heat problem disagrees with the CPU')
        out['heat_n8'][name] = dict(steps=len(tg) - 1, attempts=ag,
                                    times_max_diff=dt, x_rel=dx)
    return out


def run_mass_path(device, n=48):
    """Phase 9: the 3D mass path, p=3 twisted box: ``MassAssembler.
    assemble_banded()`` (K2 geometry stages, K1 mass, K2, K3; flat
    layout) cold and warm, then the compact ``assemble()`` on the same
    space; the layouts agree on a seeded matvec (1e-13 rel), and ``M 1``
    through K4 equals ``assemble('v * dx')`` (1e-12 rel)."""
    from pyiga_tpu_torch import _cuda, assemble, bspline, geometry
    from pyiga_tpu_torch.assemblers import MassAssembler
    from pyiga_tpu_torch.ops.banded import band_info
    from pyiga_tpu_torch.ops.mlmatvec import MLMatvecOperator

    kvs = 3 * (bspline.make_knots(3, 0.0, 1.0, n),)
    geo = geometry.twisted_box()
    t0 = time.perf_counter()
    asm = MassAssembler(kvs, geo, device=device)
    asm.tables.banded_term_tables(asm.terms, band_info(asm.structure))
    t_host = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(device)
    _cuda.reset_launches()
    times = []
    for _ in range(2):                      # cold, warm
        sync(device)
        t0 = time.perf_counter()
        op = asm.assemble_banded()
        sync(device)
        times.append(time.perf_counter() - t0)
    peak_banded = torch.cuda.max_memory_allocated(device)
    t0 = time.perf_counter()
    data = asm.run_device()
    sync(device)
    t_compact = time.perf_counter() - t0
    t0 = time.perf_counter()
    mlm = asm.assemble()
    t_compact_host = time.perf_counter() - t0
    ones = torch.ones(op.shape[0], dtype=torch.float64, device=device)
    m1 = op(ones)
    sync(device)
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device)
    missing = [k for k in MASS_KERNELS if launches[k] <= 0]
    if missing:
        raise RuntimeError('mass path never launched %s' % missing)

    x = torch.as_tensor(np.random.RandomState(9).rand(op.shape[0]),
                        dtype=torch.float64, device=device)
    y_b = op(x)
    y_c = MLMatvecOperator(data, asm.structure)(x)
    rel_layout = float((y_b - y_c).abs().max() / y_c.abs().max())
    v = torch.as_tensor(assemble.assemble('v * dx', kvs, geo=geo,
                                          device=device).ravel(),
                        dtype=torch.float64, device=device)
    rel_pu = float((m1 - v).abs().max() / v.abs().max())
    vol = float(m1.sum())
    rec = dict(n=n, p=3, ndofs=op.shape[0], D_bytes=op.D.numel() * 8,
               compact_bytes=data.numel() * 8, t_host_setup_ms=1e3 * t_host,
               t_banded_cold_ms=1e3 * times[0],
               t_banded_warm_ms=1e3 * times[1],
               t_compact_run_device_ms=1e3 * t_compact,
               t_compact_assemble_ms=1e3 * t_compact_host,
               layout_rel=rel_layout, m1_vs_vdx_rel=rel_pu, volume=vol,
               peak_banded_bytes=int(peak_banded), peak_bytes=int(peak),
               launches=launches, mlmatrix_nnz_blocks=list(mlm.data.shape))
    log('  3D p=3 n=%d: %d dofs, D %.0f MB, compact %.0f MB; host setup '
        '%.0f ms' % (n, rec['ndofs'], rec['D_bytes'] / 1e6,
                     rec['compact_bytes'] / 1e6, rec['t_host_setup_ms']))
    log('  assemble_banded cold %.2f ms  warm %.2f ms  run_device (compact) '
        '%.2f ms  assemble() with host copy %.1f ms'
        % (rec['t_banded_cold_ms'], rec['t_banded_warm_ms'],
           rec['t_compact_run_device_ms'], rec['t_compact_assemble_ms']))
    log('  banded vs compact matvec rel %.3e  M 1 vs v*dx rel %.3e  volume '
        '%.12f  peak %.0f MB (banded alone %.0f MB)'
        % (rel_layout, rel_pu, vol, peak / 2 ** 20, peak_banded / 2 ** 20))
    log('  launches: %s' % launches)
    if not (rel_layout <= 1e-13 and rel_pu <= 1e-12
            and bool(torch.isfinite(m1).all())):
        raise RuntimeError('mass layouts or partition of unity disagree')
    return rec


def run_heat_host(device, n=128):
    """Phase 10: the heat equation on the 2D p=3 NURBS quarter annulus,
    M and K assembled on the card through the compact path and held to
    the CPU assembly (1e-13), then integrated by the host esdirk34 (to
    t = 3e-4, see ``HEAT_T_END``) and ros3p (to t = 0.1), both adaptive
    with tol 1e-5 and tau0 1e-3."""
    from pyiga_tpu_torch import _cuda, assemble, bspline, geometry
    kvs = 2 * (bspline.make_knots(3, 0.0, 1.0, n),)
    geo = geometry.quarter_annulus()
    _cuda.reset_launches()
    sync(device)
    t0 = time.perf_counter()
    M = assemble.mass(kvs, geo, device=device)
    K = assemble.stiffness(kvs, geo, device=device)
    sync(device)
    t_first = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    missing = [k for k in HEAT_KERNELS if launches[k] <= 0]
    if missing:
        raise RuntimeError('heat path never launched %s' % missing)
    t0 = time.perf_counter()
    M = assemble.mass(kvs, geo, device=device)
    K = assemble.stiffness(kvs, geo, device=device)
    t_warm = time.perf_counter() - t0
    from pyiga_tpu_torch.assemblers import MassAssembler, StiffnessAssembler
    t_dev = {}
    for name, cls in (('mass', MassAssembler),
                      ('stiffness', StiffnessAssembler)):
        asm = cls(kvs, geo, device=device)
        t_dev[name] = time_ms(asm.run_device, device, reps=5)
    Mc = assemble.mass(kvs, geo)
    Kc = assemble.stiffness(kvs, geo)
    err_M = float(abs(M - Mc).max() / abs(Mc).max())
    err_K = float(abs(K - Kc).max() / abs(Kc).max())
    Mf, Kf, f = heat_system(M, K, kvs)
    rec = dict(n=n, p=3, ndofs=M.shape[0], n_free=Mf.shape[0],
               t_assembly_first_ms=1e3 * t_first,
               t_assembly_csr_ms=1e3 * t_warm,
               t_run_device_ms=t_dev, M_rel_cpu=err_M, K_rel_cpu=err_K,
               launches=launches)
    log('  2D p=3 n=%d: %d dofs (%d free); M+K to CSR first %.0f ms, warm '
        '%.0f ms; run_device mass %.2f ms stiffness %.2f ms; vs CPU M %.3e '
        'K %.3e' % (n, rec['ndofs'], rec['n_free'], 1e3 * t_first,
                    1e3 * t_warm, t_dev['mass'], t_dev['stiffness'], err_M,
                    err_K))
    log('  launches: %s' % launches)
    if not (err_M <= 1e-13 and err_K <= 1e-13):
        raise RuntimeError('card heat matrices disagree with the CPU')
    import scipy.sparse.linalg
    t0 = time.perf_counter()
    scipy.sparse.linalg.splu((Mf + 1e-3 * Kf).tocsc(), permc_spec='COLAMD')
    rec['t_one_lu_s'] = time.perf_counter() - t0
    for name, t_end in HEAT_T_END.items():
        ts, xs, att, secs = integrate_host(name, Mf, Kf, f, t_end=t_end)
        acc = len(ts) - 1
        rec[name] = dict(t_end=t_end, accepted=acc, rejected=att - acc,
                         seconds=secs, t_final=ts[-1],
                         x_max=float(np.abs(xs[-1]).max()))
        log('  %-8s to t_end %g: %d accepted, %d rejected, t %.6f, max u '
            '%.6f, host %.2f s (one LU %.3f s)'
            % (name, t_end, acc, att - acc, ts[-1], rec[name]['x_max'], secs,
               rec['t_one_lu_s']))
        if not (np.all(np.isfinite(xs[-1])) and ts[-1] >= t_end
                and 0 < rec[name]['x_max'] < 1):
            raise RuntimeError('heat integration by %s failed' % name)
    return rec


def run_heat_device(device, n=60, n_full=128):
    """Phase 10b: the heat equation on the polar quarter annulus given as
    a ``UserFunction`` (K through K1', M through the plain host-Jacobian
    mass), integrated by ``DeviceRosenbrockScheme`` (ros3p, tol 1e-5;
    and rodasp, tol 1e-7, whose sequence has a rejected step) against
    the host ``_RosenbrockScheme`` on the same matrices; then K and M at
    n=128 on the card held to the CPU (1e-13)."""
    from pyiga_tpu_torch import _cuda, assemble, bspline, solvers
    from pyiga_tpu_torch.ops.rosw import DeviceRosenbrockScheme
    kvs = 2 * (bspline.make_knots(3, 0.0, 1.0, n),)
    geo = polar_annulus()
    _cuda.reset_launches()
    sync(device)
    t0 = time.perf_counter()
    M = assemble.mass(kvs, geo, device=device)
    K = assemble.stiffness(kvs, geo, device=device)
    sync(device)
    t_asm = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    missing = [k for k in USERGEO_KERNELS if launches[k] <= 0]
    if missing:
        raise RuntimeError('user-geometry path never launched %s' % missing)
    Mf, Kf, f = heat_system(M, K, kvs)
    rec = dict(n=n, p=3, ndofs=M.shape[0], n_free=Mf.shape[0],
               t_assembly_ms=1e3 * t_asm, launches=launches)
    log('  2D p=3 n=%d polar UserFunction: %d dofs (%d free); M+K %.0f ms'
        % (n, rec['ndofs'], rec['n_free'], 1e3 * t_asm))
    log('  launches: %s' % launches)
    ops = {'K': torch.as_tensor(Kf.toarray(), device=device),
           'f': torch.as_tensor(f, device=device)}
    rec['host_fallbacks'] = 0
    for name, tol in (('ros3p', 1e-5), ('rodasp', 1e-7)):
        ts_h, xs_h, att_h, secs_h = integrate_host(name, Mf, Kf, f, tol=tol)
        A, G, b, bh, order = getattr(solvers, 'coeffs_' + name)()
        scheme = DeviceRosenbrockScheme(
            (A, G, b, bh), lambda x, o: o['f'] - o['K'] @ x,
            lambda x, o: -o['K'], Mf.toarray(), ops,
            host_scheme=solvers._RosenbrockScheme(A, G, b, bh),
            device=device)
        sync(device)
        t0 = time.perf_counter()
        ts, xs = scheme.integrate_adaptive(
            (Mf, lambda x: f - Kf @ x, lambda x: -Kf), np.zeros(len(f)),
            1e-3, 0.1, tol, order)
        secs = time.perf_counter() - t0
        rec['host_fallbacks'] += scheme.host_fallbacks
        same = len(ts) == len(ts_h) and scheme.n_attempts == att_h
        dt = (float(np.abs(np.subtract(ts, ts_h)).max()) if same
              else np.inf)
        dx = float(np.abs(xs[-1] - xs_h[-1]).max()
                   / np.abs(xs_h[-1]).max())
        acc = len(ts) - 1
        rec[name] = dict(tol=tol, accepted=acc, rejected=scheme.n_attempts
                         - acc, host_accepted=len(ts_h) - 1,
                         host_rejected=att_h - len(ts_h) + 1,
                         times_max_diff=dt, x_rel=dx, device_s=secs,
                         host_s=secs_h,
                         ms_per_attempt_device=1e3 * secs / scheme.n_attempts,
                         ms_per_attempt_host=1e3 * secs_h / att_h,
                         host_reads=scheme.n_host_reads)
        log('  %-6s tol %.0e: device %d accepted / %d rejected, host %d / %d'
            '; times max diff %.3e  x rel %.3e; %.2f ms per step attempt on '
            'the card, %.2f ms on the host'
            % (name, tol, acc, rec[name]['rejected'],
               rec[name]['host_accepted'], rec[name]['host_rejected'], dt, dx,
               rec[name]['ms_per_attempt_device'],
               rec[name]['ms_per_attempt_host']))
        # ros3p to 1e-12; rodasp's 25 attempts compound the stage
        # solves' 1e-11 residual into tau, so its times are held to 1e-10
        if not (same and dt <= (1e-12 if name == 'ros3p' else 1e-10)
                and dx <= 1e-9):
            raise RuntimeError('device Rosenbrock (%s) left the host step '
                               'sequence' % name)
    log('  host fallbacks: %d' % rec['host_fallbacks'])
    if rec['host_fallbacks'] != 0:
        raise RuntimeError('device Rosenbrock fell back to the host')

    kvs = 2 * (bspline.make_knots(3, 0.0, 1.0, n_full),)
    errs = {}
    for kind in ('mass', 'stiffness'):
        A = getattr(assemble, kind)(kvs, geo, device=device)
        Ac = getattr(assemble, kind)(kvs, geo)
        errs[kind] = float(abs(A - Ac).max() / abs(Ac).max())
    rec['n128_rel_cpu'] = errs
    log('  n=%d card vs CPU: M %.3e  K %.3e' % (n_full, errs['mass'],
                                                errs['stiffness']))
    if not max(errs.values()) <= 1e-13:
        raise RuntimeError('card user-geometry matrices disagree with CPU')
    return rec


def check_tail_kernels(device, n=48, seed=4):
    """Phase 4i: K7's transposed stage and tail kernel against their plain
    versions at the n=48 flat-banded shapes of ``assemble_banded`` (real
    banded tables, the direct terms' first tables halved, stage-2 and
    final tables shared by identity as the route shares them; seeded
    fields and stage-1 outputs) and at the ragged shapes above, 1e-13
    relative to the largest entry, each launched twice (bitwise-equal).
    Yardsticks: one ``torch.matmul`` for ``stage_T``, one
    ``torch.einsum`` over the stacked per-term operands for
    ``tail_fused``.  The tail's bound counts the final stage once per
    distinct final table: the terms that share one are summed before it
    (what the kernel does, and the least work for the function)."""
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    from pyiga_tpu_torch.ops.banded import band_info

    rng = np.random.RandomState(seed)
    f64 = torch.float64

    def rand(*shape):
        return torch.as_tensor(rng.rand(*shape), dtype=f64, device=device)

    asm = main_path_setup(3, n, device)
    plan = asm._fold()
    btabs = asm.tables.banded_term_tables(asm.terms, band_info(asm.structure))
    uploaded = {}

    def dev(a):
        if id(a) not in uploaded:
            uploaded[id(a)] = (a, torch.as_tensor(a, dtype=f64,
                                                  device=device))
        return uploaded[id(a)][1]
    tabs = [[dev(btabs[t][0] if m else 0.5 * btabs[t][0])]
            + [dev(T) for T in btabs[t][1:]] for t, m in plan]
    M, K = tabs[0][0].shape
    out = {}

    X = rand(K, K * K)
    T = tabs[0][0]
    got, ref = cs.stage_T(X, T), cs.stage_T_plain(X, T)
    sync(device)
    err, rel = compare('stage_T', got, ref, 1e-13)
    check_repeat('stage_T', lambda: cs.stage_T(X, T), got)
    out['stage_T'] = dict(
        max_abs_err=err, rel=rel, shape=[K, K * K, M], repeat_equal=True,
        ms=time_ms(lambda: cs.stage_T(X, T), device),
        plain_ms=time_ms(lambda: cs.stage_T_plain(X, T), device),
        library_ms=time_ms(lambda: torch.matmul(T, X), device),
        **bound(nbytes(X, T, got), 2 * K * K * K * M, F64_TENSOR_PER_MS))
    del X, got, ref
    out['stage_T']['ragged'] = {}
    for Kr, Rr, Mr in STAGE_T_RAGGED:
        X, T = rand(Kr, Rr), rand(Mr, Kr)
        got, ref = cs.stage_T(X, T), cs.stage_T_plain(X, T)
        sync(device)
        key = '%dx%dx%d' % (Kr, Rr, Mr)
        out['stage_T']['ragged'][key] = compare('stage_T ' + key, got, ref,
                                                1e-13)
        check_repeat('stage_T ' + key, lambda: cs.stage_T(X, T), got)

    x1T = [rand(M, K, K) for _ in plan]
    tc2, idx2 = cs._dedup([t[1] for t in tabs])
    tc3, idx3 = cs._dedup([t[2] for t in tabs])
    args = (x1T, tc2, tc3, idx2, idx3)
    got, ref = cs.tail_fused(*args), cs.tail_fused_plain(*args)
    sync(device)
    err, rel = compare('tail_fused', got, ref, 1e-13)
    check_repeat('tail_fused', lambda: cs.tail_fused(*args), got)
    M2, M3 = tc2[0].shape[0], tc3[0].shape[0]
    flops = (len(x1T) * 2 * M * K * K * M2
             + len(set(idx3)) * 2 * M * M2 * K * M3)
    rec = dict(max_abs_err=err, rel=rel, shape=[len(x1T), M, K, K, M2, M3],
               tables=[len(tc2), len(tc3)], repeat_equal=True,
               ms=time_ms(lambda: cs.tail_fused(*args), device, reps=5),
               plain_ms=time_ms(lambda: cs.tail_fused_plain(*args), device,
                                reps=5),
               **bound(nbytes(*x1T, *tc2, *tc3, got), flops,
                       F64_TENSOR_PER_MS))
    X6 = torch.stack(x1T)
    T2 = torch.stack([tc2[i] for i in idx2])
    T3 = torch.stack([tc3[i] for i in idx3])
    del got, ref
    rec['library_ms'] = time_ms(
        lambda: torch.einsum('tajk,tbj,tck->abc', X6, T2, T3), device,
        reps=3, warmup=1)
    out['tail_fused'] = rec
    del X6, T2, T3, x1T, args
    rec['ragged'] = {}
    for M1, K2, K3, M2, M3, nt, n2, n3 in TAIL_RAGGED:
        xs = [rand(M1, K2, K3) for _ in range(nt)]
        t2 = [rand(M2, K2) for _ in range(n2)]
        t3 = [rand(M3, K3) for _ in range(n3)]
        a = (xs, t2, t3, [t % n2 for t in range(nt)],
             [(t * 7 // 3) % n3 for t in range(nt)])
        got, ref = cs.tail_fused(*a), cs.tail_fused_plain(*a)
        sync(device)
        key = '%dx%dx%dx%dx%d,%d terms' % (M1, K2, K3, M2, M3, nt)
        rec['ragged'][key] = compare('tail ' + key, got, ref, 1e-13)
        check_repeat('tail ' + key, lambda: cs.tail_fused(*a), got)
    for name, r in out.items():
        log('  %-16s kernel %.4f ms   plain %.4f ms   library %.4f ms   '
            'bound %.4f ms (%s)' % (name, r['ms'], r['plain_ms'],
                                    r['library_ms'], r['bound_ms'],
                                    r['bound_by']))
    return out


def run_tail_fused_path(device, n=48):
    """Phase 11: the headline ``assemble_banded()`` with the fused tail
    (``cuda_sumfac.TAIL_FUSED``) on, then off, in one process: each route
    cold, then five warm calls of each in turns (fused, two-call,
    two-call, fused, ...; host clock after a synchronize, min and median
    reported): D agrees to 1e-13 relative, the fused run launches
    ``stage_T`` six times, ``tail_fused`` once and ``fold`` never, and
    ``cg_ir`` on the fused operator takes the headline's 25 inner
    iterations [7, 9, 9].  The switch is restored afterwards."""
    from pyiga_tpu_torch import _cuda
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    asm = main_path_setup(3, n, device)
    saved = cs.TAIL_FUSED
    ops, times, launches = {}, {'fused': [], 'two_call': []}, {}

    def run(on, count):
        cs.TAIL_FUSED = on
        key = 'fused' if on else 'two_call'
        if count:
            _cuda.reset_launches()
        sync(device)
        t0 = time.perf_counter()
        ops[key] = asm.assemble_banded()
        sync(device)
        times[key].append(1e3 * (time.perf_counter() - t0))
        if count:
            launches[key] = dict(_cuda.LAUNCHES)

    try:
        for on in (True, False):            # cold
            run(on, True)
        for rep in range(5):                # warm, in turns
            for on in ((True, False) if rep % 2 == 0 else (False, True)):
                run(on, False)
    finally:
        cs.TAIL_FUSED = saved
    Df, D2 = ops['fused'].D, ops['two_call'].D
    rel = float((Df - D2).abs().max() / D2.abs().max())
    lf = launches['fused']
    warm = {k: (min(v[1:]), float(np.median(v[1:]))) for k, v in times.items()}
    log('  assemble_banded fused cold %.2f ms warm min %.2f median %.2f ms; '
        'two-call cold %.2f ms warm min %.2f median %.2f ms; D rel %.3e'
        % (times['fused'][0], *warm['fused'], times['two_call'][0],
           *warm['two_call'], rel))
    log('  launches (fused): %s' % lf)
    if not rel <= 1e-13:
        raise RuntimeError('fused D differs from the two-call D: %.3e' % rel)
    if not (lf['stage_T'] == 6 and lf['tail_fused'] == 1
            and lf['fold'] == 0):
        raise RuntimeError('fused assembly launched stage_T %d, tail_fused '
                           '%d, fold %d (expected 6, 1, 0)'
                           % (lf['stage_T'], lf['tail_fused'], lf['fold']))
    _cuda.reset_launches()
    x, info, res, t_setup, t_solve = solve_case(asm, ops['fused'], device)
    solve_launches = dict(_cuda.LAUNCHES)
    log('  cg_ir on the fused operator: inner_iters %s  sum %d  rel residual '
        '%.3e  solve %.2f ms' % (info['inner_iters'], sum(info['inner_iters']),
                                 res, 1e3 * t_solve))
    if info['inner_iters'] != [7, 9, 9] or not res <= 1e-8:
        raise RuntimeError('fused operator solves in %s, residual %.3e'
                           % (info['inner_iters'], res))
    path = {k: lf[k] + solve_launches[k] for k in lf}
    missing = [k for k in TAILFUSED_KERNELS if path[k] <= 0]
    if missing:
        raise RuntimeError('fused headline never launched %s' % missing)
    return dict(n=n, D_rel=rel, t_fused_ms=times['fused'],
                t_two_call_ms=times['two_call'],
                t_warm_min_median_ms=warm, launches_fused=lf,
                launches_two_call=launches['two_call'],
                launches_path=path, inner_iters=info['inner_iters'],
                residual=res, t_solve_ms=1e3 * t_solve)


def dirichlet_path(n, device):
    """The 3D Dirichlet Poisson path (``examples/poisson_3d.py`` with the
    harmonic data `g`) at p=3 on the twisted box: ``StiffnessAssembler.
    assemble()`` (a host MLMatrix), ``compute_dirichlet_bcs``, the lifted
    right-hand side ``b = -(A_mf ext(g_b))_free`` by a full
    ``MatrixFreeOperator``, float64/float32 restricted operators, the
    weighted fastdiag in float32, ``cg_ir`` to 1e-10, then the completed
    solution's L2 error by ``integrate``.  Returns the record and the
    solution on the free dofs (host)."""
    from pyiga_tpu_torch import assemble, bspline, geometry, solvers
    from pyiga_tpu_torch.assemblers import StiffnessAssembler
    from pyiga_tpu_torch.ops.fastdiag import fastdiag_precond_weighted
    from pyiga_tpu_torch.ops.matfree import MatrixFreeOperator
    from pyiga_tpu_torch.ops.mlmatvec import make_ml_matvec

    t = {}
    kvs = 3 * (bspline.make_knots(3, 0.0, 1.0, n),)
    geo = geometry.twisted_box()
    t0 = time.perf_counter()
    asm = StiffnessAssembler(kvs, geo, device=device)
    t['host_setup'] = time.perf_counter() - t0
    sync(device)
    t0 = time.perf_counter()
    A = asm.assemble()
    t['assembly'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bd, vals = assemble.compute_dirichlet_bcs(kvs, geo, ('all', harmonic))
    t['dirichlet_bcs'] = time.perf_counter() - t0
    n_full = A.shape[0]
    free = np.setdiff1d(np.arange(n_full), bd)
    t0 = time.perf_counter()
    A_mf = MatrixFreeOperator(asm)
    ext = torch.zeros(n_full, dtype=torch.float64, device=device)
    ext[torch.as_tensor(bd, device=device)] = torch.as_tensor(vals,
                                                               device=device)
    free_t = torch.as_tensor(free, device=device)
    b = -A_mf(ext)[free_t]
    op_hi = MatrixFreeOperator(asm, free_dofs=free, dtype=torch.float64)
    op_lo = MatrixFreeOperator(asm, free_dofs=free, dtype=torch.float32)
    P = fastdiag_precond_weighted(asm, dirichlet=True, dtype=torch.float32)
    sync(device)
    t['solver_setup'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, info = solvers.cg_ir(op_hi, op_lo, b, tol=1e-10, precond_lo=P)
    sync(device)
    t['solve'] = time.perf_counter() - t0
    res = float(torch.linalg.vector_norm(b - op_hi(x))
                / torch.linalg.vector_norm(b))
    # the matrix-free operator against the assembled one (K7's output)
    xr = torch.as_tensor(np.random.RandomState(12).rand(n_full),
                         dtype=torch.float64, device=device)
    y_mf, y_asm = A_mf(xr), make_ml_matvec(A, device=device)(xr)
    mf_rel = float((y_mf - y_asm).abs().max() / y_asm.abs().max())
    u = np.zeros(n_full)
    u[free], u[bd] = x.cpu().numpy(), vals
    uh = geometry.BSplineFunc(kvs, u.reshape([kv.numdofs for kv in kvs]))
    t0 = time.perf_counter()
    err2 = assemble.integrate(kvs, SquaredError(uh, geo, harmonic), geo=geo)
    t['integrate'] = time.perf_counter() - t0
    norm2 = assemble.integrate(kvs, SquaredError(None, geo, harmonic),
                               geo=geo)
    rec = dict(n=n, p=3, ndofs=n_full, n_free=len(free),
               n_dirichlet=len(bd), outer=info['outer'],
               inner_iters=info['inner_iters'],
               iters=sum(info['inner_iters']), residual=res,
               residual_cg_ir=info['residual'],
               rel_l2_error=float(np.sqrt(err2 / norm2)),
               mf_vs_assembled_rel=mf_rel,
               **{'t_%s_ms' % k: 1e3 * v for k, v in t.items()})
    return rec, x.cpu()


def run_dirichlet_path(device, n=48):
    """Phase 12: the Dirichlet path at n=48 with the fused tail on, cold
    and warm; residual <= 1e-10 and relative L2 error <= 1e-7 (the
    discrete solution is the interpolant of the harmonic data, so the
    error is the solver's), the assembled (K7) and the matrix-free
    operators agree to 1e-12."""
    from pyiga_tpu_torch import _cuda
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    saved = cs.TAIL_FUSED
    cs.TAIL_FUSED = True
    try:
        torch.cuda.reset_peak_memory_stats(device)
        _cuda.reset_launches()
        cold, _ = dirichlet_path(n, device)
        cold['launches'] = dict(_cuda.LAUNCHES)
        cold['peak_device_bytes'] = int(torch.cuda.max_memory_allocated(
            device))
        warm, _ = dirichlet_path(n, device)
    finally:
        cs.TAIL_FUSED = saved
    for name, r in (('cold', cold), ('warm', warm)):
        log('  %s: %d dofs (%d free); assemble() %.1f ms  bcs %.1f ms  '
            'solver setup %.1f ms  solve %.1f ms  integrate %.1f ms'
            % (name, r['ndofs'], r['n_free'], r['t_assembly_ms'],
               r['t_dirichlet_bcs_ms'], r['t_solver_setup_ms'],
               r['t_solve_ms'], r['t_integrate_ms']))
        log('    outer %d  inner_iters %s  rel residual %.3e  rel L2 error '
            '%.3e  matrix-free vs assembled %.3e'
            % (r['outer'], r['inner_iters'], r['residual'],
               r['rel_l2_error'], r['mf_vs_assembled_rel']))
    log('  peak %.0f MB  launches: %s' % (cold['peak_device_bytes'] / 2 ** 20,
                                         cold['launches']))
    for r in (cold, warm):
        if not (r['residual'] <= 1e-10 and r['rel_l2_error'] <= 1e-7
                and r['mf_vs_assembled_rel'] <= 1e-12):
            raise RuntimeError('Dirichlet path: residual %.3e, L2 error '
                               '%.3e, operators %.3e'
                               % (r['residual'], r['rel_l2_error'],
                                  r['mf_vs_assembled_rel']))
    missing = [k for k in DIRICHLET_KERNELS if cold['launches'][k] <= 0]
    if missing:
        raise RuntimeError('Dirichlet path never launched %s' % missing)
    cold['warm'] = warm
    return cold


def check_dirichlet_small(device, n=8):
    """Phase 12b: the Dirichlet path at n=8 with the fused tail on, card
    against CPU: identical ``cg_ir`` counts, solutions to 1e-10."""
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    saved = cs.TAIL_FUSED
    cs.TAIL_FUSED = True
    try:
        rg, xg = dirichlet_path(n, device)
        rc, xc = dirichlet_path(n, torch.device('cpu'))
    finally:
        cs.TAIL_FUSED = saved
    err_x = float((xg - xc).abs().max() / xc.abs().max())
    log('  n=%d card vs CPU: inner_iters %s vs %s  x rel %.3e  L2 error '
        '%.3e / %.3e' % (n, rg['inner_iters'], rc['inner_iters'], err_x,
                         rg['rel_l2_error'], rc['rel_l2_error']))
    if rg['inner_iters'] != rc['inner_iters'] or not err_x <= 1e-10:
        raise RuntimeError('card Dirichlet path disagrees with the CPU run')
    return dict(dirichlet_n8_card=rg, dirichlet_n8_cpu=rc,
                dirichlet_n8_x_rel=err_x)


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from pyiga_tpu_torch import _cuda

    t_start = time.perf_counter()
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
    dmma = sass_dmma(_cuda.BUILD_INFO['path'])

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log('phase 3: matmul.allow_tf32=%s cudnn.allow_tf32=%s'
        % (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32))

    log('phase 4: kernels vs plain versions at the 3D n=48 shapes, K2 and '
        'K3 also at ragged shapes')
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
    log('phase 8b: local-MG path, 2D p=3 HB (48,3), solve_hmultigrid '
        'defaults')
    lmg48 = run_localmg(device, 48)
    torch.cuda.empty_cache()

    log("phase 4g: K1 mass kind and K1' vs plain versions")
    kern.update(check_mass_kernels(device))
    torch.cuda.empty_cache()

    log('phase 4h: mass/stiffness fixtures and the small heat problem, '
        'card vs CPU')
    small.update(check_mass_small(device))
    torch.cuda.empty_cache()

    log('phase 9: mass path, 3D p=3 twisted box n=48, float64')
    mass3 = run_mass_path(device)
    launches['mass_fields'] = mass3['launches']['mass_fields']
    torch.cuda.empty_cache()

    log('phase 10: heat equation, host integrators, 2D p=3 NURBS quarter '
        'annulus n=128')
    heat = run_heat_host(device)
    torch.cuda.empty_cache()

    log('phase 10b: heat equation, device Rosenbrock, 2D p=3 polar '
        'UserFunction n=60')
    heat_dev = run_heat_device(device)
    launches['host_jac_fields'] = heat_dev['launches']['host_jac_fields']
    torch.cuda.empty_cache()

    log('phase 4i: K7 (stage_T, tail_fused) vs plain versions at the 3D '
        'n=48 flat-banded shapes')
    kern.update(check_tail_kernels(device))
    torch.cuda.empty_cache()

    log('phase 11: headline assemble_banded with the fused tail on, then '
        'off, 3D p=3 n=48')
    tail = run_tail_fused_path(device)
    launches.update((k, tail['launches_path'][k])
                    for k in ('stage_T', 'tail_fused'))
    torch.cuda.empty_cache()

    log('phase 12: 3D Dirichlet Poisson path (harmonic data), p=3 twisted '
        'box n=48, fused tail')
    dirichlet = run_dirichlet_path(device)
    torch.cuda.empty_cache()

    log('phase 12b: Dirichlet path on small inputs (n=8), card vs CPU')
    small.update(check_dirichlet_small(device))

    kernels = [dict(name=k, route=KERNELS[k][0], source=KERNELS[k][1],
                    replaces=KERNELS[k][2], launches=launches[k],
                    max_abs_err=kern[k]['max_abs_err'], ms=kern[k]['ms'],
                    plain_ms=kern[k]['plain_ms'],
                    bound_ms=kern[k]['bound_ms'],
                    bound_by=kern[k]['bound_by'],
                    library_ms=kern[k]['library_ms']) for k in KERNELS]
    record = dict(card=card, torch=torch.__version__,
                  cuda=torch.version.cuda, build_s=t_build,
                  sass_dmma=dmma, kernels=kern,
                  small=small, main3d=main3, main2d=main2,
                  convdiff2d=conv, localmg_24_3=lmg, localmg_48_3=lmg48,
                  mass3d=mass3, heat2d=heat, heat2d_device=heat_dev,
                  tail_fused3d=tail, dirichlet3d=dirichlet,
                  seconds=time.perf_counter() - t_start)
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
