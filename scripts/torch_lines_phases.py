# -*- coding: utf-8 -*-
"""Phases 4n, 22, 22b, 4o and 22c of ``chip_smoke.py`` alone: the float32
K1 (stiffness and ``mass``), K2 and K3 against their plain versions (4n),
the 3D p=3 n=96 float64 Poisson line with its peak bytes, fibers and the
windowed route (22), the f32 line at n=48 (22b), the float32 K1 ``jac``,
K1', K5, K8 and K8f against their plain versions with the SASS check of
every float32 instance (4o), and the f32 line beyond Poisson (22c).

    python scripts/torch_lines_phases.py [--only 4n,22,22b,4o,22c]
        [--tag NAME]

Needs a CUDA card.  Prints ptxas's registers and spills of the float32
kernels and the card's ``nvidia-smi`` name and power limit; writes
``chiprun_out/lines_phases_<tag>.json`` and prints ``OK <tag>`` at the
end; any failed check raises."""

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
    '4n': chip_smoke.check_f32_kernels,
    '22': chip_smoke.run_n96,
    '22b': chip_smoke.run_f32_line,
    '4o': chip_smoke.check_f32_assembly_kernels,
    '22c': chip_smoke.run_f32_assembly,
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--only', default=','.join(PHASES))
    ap.add_argument('--tag', default='0')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('torch_lines_phases: no CUDA device available', file=sys.stderr)
        return 2
    from pyiga_tpu_torch import _cuda
    device = torch.device('cuda', 0)
    card = chip_smoke.nvidia_smi()
    chip_smoke.log(card)
    t0 = time.perf_counter()
    _cuda.library()
    chip_smoke.log('kernels built+loaded in %.1f s' % (time.perf_counter()
                                                       - t0))
    lines = _cuda.BUILD_INFO['log'].splitlines()
    for i, line in enumerate(lines):     # ptxas -v of the float32 kernels
        if 'Compiling entry' in line and ('f32' in line or 'EfE' in line
                                          or 'IfLi' in line):
            for ln in lines[i:i + 4]:
                chip_smoke.log('  ' + ln.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec = {'card': card}
    for ph in args.only.split(','):
        chip_smoke.log('phase %s' % ph)
        t0 = time.perf_counter()
        rec[ph] = PHASES[ph](device)
        rec[ph + '_s'] = time.perf_counter() - t0
        chip_smoke.log('phase %s took %.1f s' % (ph, rec[ph + '_s']))
        torch.cuda.empty_cache()
    out = os.path.join(REPO, 'chiprun_out')
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, 'lines_phases_%s.json' % args.tag),
              'w') as f:
        json.dump(rec, f, indent=1, default=str)
    print('OK', args.tag)
    return 0


if __name__ == '__main__':
    sys.exit(main())
