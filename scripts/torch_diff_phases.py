# -*- coding: utf-8 -*-
"""Phase 20 of ``chip_smoke.py`` alone: the backward kernels of the
differentiable assembly (K1's three kinds, K2's and K3's, the generated
K5 adjoint) against their plain versions (20a), then the differentiable
paths at full width: gradients of assembled operators at 3D p=3 n=48 and
2D n=128 (20b), an implicit-CG compliance (20c), input and parameter
derivatives (20d) and the two example ports card vs CPU (20e), their
launches counted; then the float32 backward kernels (20f) and the
differentiable paths under ``set_dtype(float32)`` (20g), and the
float32 local-MG line at (96, 3) (8c-f32).

    python scripts/torch_diff_phases.py [--only 20a,20,20f,20g,8c-f32]
        [--tag NAME]

Needs a CUDA card.  Writes ``chiprun_out/diff_phases_<tag>.json`` and
prints ``OK <tag>`` at the end; any failed check raises."""

import argparse
import json
import os
import sys
import time

import torch

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..')
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

def localmg_f32(device):
    """Phase 8c-f32 as ``chip_smoke.main`` runs it."""
    with chip_smoke.ComputeDtype(torch.float32):
        return chip_smoke.run_localmg(
            device, 96, iters_jax=chip_smoke.LOCALMG_ITERS_F32[(96, 3)],
            kernels=chip_smoke.WAVE_LOCALMG_F32_KERNELS)


PHASES = {
    '20a': chip_smoke.check_diff_kernels,
    '20': chip_smoke.run_diff_phase,
    '20f': chip_smoke.check_diff_f32_kernels,
    '20g': chip_smoke.run_diff_f32,
    '8c-f32': localmg_f32,
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--only', default=','.join(PHASES))
    ap.add_argument('--tag', default='0')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('torch_diff_phases: no CUDA device available', file=sys.stderr)
        return 2
    from pyiga_tpu_torch import _cuda
    device = torch.device('cuda', 0)
    chip_smoke.log(chip_smoke.nvidia_smi())
    t0 = time.perf_counter()
    _cuda.library()
    t_build = time.perf_counter() - t0
    chip_smoke.log('kernels built+loaded in %.1f s' % t_build)
    lines = _cuda.BUILD_INFO['log'].splitlines()
    for i, line in enumerate(lines):     # ptxas -v of the backward kernels
        if 'Compiling entry' in line and 'bwd' in line:
            for ln in lines[i:i + 4]:
                chip_smoke.log('  ' + ln.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = dict(card=chip_smoke.nvidia_smi(), build_s=t_build,
               nvcc_s=_cuda.BUILD_INFO['seconds'])
    for ph in args.only.split(','):
        chip_smoke.log('phase %s' % ph)
        t0 = time.perf_counter()
        rec[ph] = PHASES[ph](device)
        rec[ph + '_s'] = time.perf_counter() - t0
        chip_smoke.log('phase %s took %.1f s' % (ph, rec[ph + '_s']))
        torch.cuda.empty_cache()
    out = os.path.join(REPO, 'chiprun_out')
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, 'diff_phases_%s.json' % args.tag),
              'w') as f:
        json.dump(rec, f, indent=1, default=str)
    chip_smoke.log('kernels built+loaded in %.1f s (nvcc %.1f s); %s'
                   % (t_build, rec['nvcc_s'], rec['card']))
    print('OK', args.tag)
    return 0


if __name__ == '__main__':
    sys.exit(main())
