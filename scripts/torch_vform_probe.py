"""Time the calls of the port's VForm and user-geometry paths that reach
kernels K5 (the generated coefficient-field kernel) and K1' (the
stiffness fields of a host Jacobian) on one GPU, through entry points
that every version of the port has, so that a checkout of another commit
with this script copied into it measures its own calls the same way.

    python3 scripts/torch_vform_probe.py [TAG]

1. Convection-diffusion, 2D p=3 n=128 on the NURBS quarter annulus (the
   VForm path of ``chip_smoke.py`` phase 7): ``cuda_vform.combo_fields``
   on the plan's combos (K5 as the path calls it) and
   ``VFormAssembler.run_device()``, each by CUDA events over back-to-back
   calls and ``run_device`` also by the host clock (best of 5 after a
   synchronize); K5's launches per ``run_device``.
2. The local-MG assembly of ``chip_smoke.py`` phases 8 / 8b at (24, 3)
   and (48, 3): ``assemble_matrix`` + ``assemble_rhs``, min of 10 after 2
   warm builds, and K5's launches per build.
3. The polar quarter annulus given as a ``UserFunction``, 2D p=3 n=128:
   ``assemblers.stiffness_fields`` on its geometry inputs (the host
   Jacobian's upload excluded; K1' and its operands as the path calls
   them), by CUDA events.

Writes ``chiprun_out/vform_probe_TAG.json`` (TAG default ``run``) and
prints the card's ``nvidia-smi`` name and power limit.  Exits nonzero
without a CUDA device.  Imports neither jax nor pyiga_tpu.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, 'chiprun_out')

CONVDIFF = '(inner(grad(u), grad(v)) + dot(b, grad(u)) * v + u * v) * dx'


def events_ms(fn, reps):
    """Mean milliseconds of `fn()` over `reps` back-to-back calls, after
    two warm calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps=5):
    """Best host-clock milliseconds of `fn()` ended by a synchronize."""
    fn()
    torch.cuda.synchronize()
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return 1e3 * best


def convdiff(device):
    from pyiga_tpu_torch import _cuda, bspline, geometry
    from pyiga_tpu_torch.assemble import instantiate_assembler
    from pyiga_tpu_torch.ops import cuda_vform
    kvs = 2 * (bspline.make_knots(3, 0.0, 1.0, 128),)
    asm = instantiate_assembler(CONVDIFF, kvs, {
        'geo': geometry.quarter_annulus(), 'b': np.array([3.0, -2.0])},
        None, device=device)
    plan = asm._fold_plan or [(t, False) for t in range(len(asm.combos))]
    combos = [asm.combos[t] for t, _m in plan]
    arrays = asm.device_arrays()
    rec = dict(
        combo_fields_ms=events_ms(
            lambda: cuda_vform.combo_fields(asm, arrays, combos), 50),
        run_device_events_ms=events_ms(asm.run_device, 20),
        run_device_host_ms=host_ms(asm.run_device))
    k5 = _cuda.LAUNCHES['vform_fields']
    asm.run_device()
    rec['k5_per_run_device'] = _cuda.LAUNCHES['vform_fields'] - k5
    print('  convdiff n=128: combo_fields %.4f ms  run_device %.4f ms '
          '(events) %.4f ms (host)  K5 per run_device %d'
          % (rec['combo_fields_ms'], rec['run_device_events_ms'],
             rec['run_device_host_ms'], rec['k5_per_run_device']),
          flush=True)
    return rec


def localmg(device, n0, L=3, reps=10):
    from pyiga_tpu_torch import _cuda, bspline, geometry, vform
    from pyiga_tpu_torch.hierarchical import HDiscretization, HSpace
    hs = HSpace(2 * (bspline.make_knots(3, 0.0, 1.0, n0),), disparity=1,
                bdspecs=[(0, 0), (0, 1), (1, 0), (1, 1)])
    for lv in range(L - 1):
        thr = 1.0 - 2.0 ** (-lv - 1)
        hs.refine_region(lv, lambda *X: min(X) > thr)

    def build():
        hd = HDiscretization(hs, vform.stiffness_vf(dim=2),
                             {'geo': geometry.unit_square(),
                              'f': lambda *x: 1.0}, device=device)
        t0 = time.perf_counter()
        hd.assemble_matrix()
        hd.assemble_rhs()
        return time.perf_counter() - t0

    build()
    build()
    k5 = _cuda.LAUNCHES['vform_fields']
    best = min(build() for _ in range(reps))
    rec = dict(assembly_ms=1e3 * best,
               k5_per_build=(_cuda.LAUNCHES['vform_fields'] - k5) / reps)
    print('  local MG (%d,%d): assembly %.2f ms  K5 per build %g'
          % (n0, L, rec['assembly_ms'], rec['k5_per_build']), flush=True)
    return rec


def user_stiffness_fields(device):
    from pyiga_tpu_torch import assemblers, bspline, geometry
    h = 0.5 * np.pi

    def f(x, y):
        return ((1 + x) * np.cos(h * y), (1 + x) * np.sin(h * y))

    def jac(x, y):
        x, y = np.broadcast_arrays(x, y)
        c, s = np.cos(h * y), np.sin(h * y)
        return np.stack([np.stack([c, -h * (1 + x) * s], axis=-1),
                         np.stack([s, h * (1 + x) * c], axis=-1)], axis=-2)
    geo = geometry.UserFunction(f, [[0, 1], [0, 1]], jac=jac)
    asm = assemblers.StiffnessAssembler(
        2 * (bspline.make_knots(3, 0.0, 1.0, 128),), geo, device=device)
    gi = asm.geo_inputs()
    rec = dict(stiffness_fields_ms=events_ms(
        lambda: assemblers.stiffness_fields(gi), 50))
    print("  polar UserFunction n=128: stiffness_fields (K1') %.4f ms"
          % rec['stiffness_fields_ms'], flush=True)
    return rec


def main():
    if not torch.cuda.is_available():
        print('torch_vform_probe: no CUDA device', file=sys.stderr)
        return 2
    tag = sys.argv[1] if len(sys.argv) > 1 else 'run'
    device = torch.device('cuda', 0)
    os.makedirs(OUT, exist_ok=True)
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    rec = dict(card=card, convdiff=convdiff(device),
               localmg_24_3=localmg(device, 24),
               localmg_48_3=localmg(device, 48),
               user=user_stiffness_fields(device))
    with open(os.path.join(OUT, 'vform_probe_%s.json' % tag), 'w') as f:
        json.dump(rec, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
