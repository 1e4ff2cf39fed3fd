# -*- coding: utf-8 -*-
"""Phase 26 of ``chip_smoke.py`` alone: forward mode and second
derivatives through the differentiable assembly.  (a) K1-jvp, K1-hvp
and the generated K5 tangent and second-order programs against their
plain versions, float64 (``26a``) and float32 (``26a-f32``); (b)-(d)
``torch.func.jvp``, ``forward_ad`` and HVPs (forward over reverse,
``create_graph``) through ``assembly_coeff_fn`` at 3D p=3 n=48 and 2D
n=128 and ``assembly_input_fn`` at 2D n=128 against the plain versions
on the card, ``torch.func.hessian`` of a small mass objective, and the
Newton example by ``torch.func.jacfwd`` (``26``), launches counted.

    python scripts/torch_diff_fwd_phase.py [--only 26a,26a-f32,26]
        [--tag NAME]

Needs a CUDA card.  Writes ``chiprun_out/diff_fwd_phase_<tag>.json``
and prints ``OK <tag>`` at the end; any failed check raises."""

import argparse
import json
import os
import sys
import time

import torch

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..')
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

PHASES = {
    '26a': chip_smoke.check_fwd_kernels,
    '26a-f32': lambda device: chip_smoke.check_fwd_kernels(
        device, dtype=torch.float32),
    '26': chip_smoke.run_fwd_phase,
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--only', default=','.join(PHASES))
    ap.add_argument('--tag', default='0')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('torch_diff_fwd_phase: no CUDA device available',
              file=sys.stderr)
        return 2
    from pyiga_tpu_torch import _cuda
    device = torch.device('cuda', 0)
    chip_smoke.log(chip_smoke.nvidia_smi())
    t0 = time.perf_counter()
    _cuda.library()
    t_build = time.perf_counter() - t0
    chip_smoke.log('kernels built+loaded in %.1f s (nvcc %.1f s)'
                   % (t_build, _cuda.BUILD_INFO['seconds']))
    lines = _cuda.BUILD_INFO['log'].splitlines()
    for i, line in enumerate(lines):     # ptxas -v of K1-jvp and K1-hvp
        if 'Compiling entry' in line and ('jvp' in line or 'hvp' in line):
            for ln in lines[i:i + 4]:
                if 'registers' in ln or 'spill' in ln or 'Compiling' in ln:
                    chip_smoke.log('  ' + ln.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = dict(card=chip_smoke.nvidia_smi(), build_s=t_build,
               nvcc_s=_cuda.BUILD_INFO['seconds'],
               nvcc_sources_s=_cuda.BUILD_INFO.get('sources'))
    chip_smoke.log('nvcc seconds a source: %s' % rec['nvcc_sources_s'])
    for ph in args.only.split(','):
        chip_smoke.log('phase %s' % ph)
        t0 = time.perf_counter()
        rec[ph] = PHASES[ph](device)
        rec[ph + '_s'] = time.perf_counter() - t0
        chip_smoke.log('phase %s took %.1f s' % (ph, rec[ph + '_s']))
        torch.cuda.empty_cache()
    out = os.path.join(REPO, 'chiprun_out')
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, 'diff_fwd_phase_%s.json' % args.tag),
              'w') as f:
        json.dump(rec, f, indent=1, default=str)
    chip_smoke.log('kernels built+loaded in %.1f s (nvcc %.1f s); %s'
                   % (t_build, rec['nvcc_s'], rec['card']))
    print('OK', args.tag)
    return 0


if __name__ == '__main__':
    sys.exit(main())
