# -*- coding: utf-8 -*-
"""Phases 4m and 21 of ``chip_smoke.py`` alone: the windowed route's
kernels K8 (``windowed_stage``) and K8f (``windowed_fold``) against their
plain versions at the route's shapes, with their yardsticks (4m), then
the route end to end at 3D p=3 n=48 and 2D p=3 n=128, held to the dense
route and its solve (21).

    python scripts/torch_windowed_phases.py [--only 4m,21] [--tag NAME]

Needs a CUDA card.  Prints ptxas's registers and spills of the windowed
kernels and the card's ``nvidia-smi`` name and power limit; writes
``chiprun_out/windowed_phases_<tag>.json`` and prints ``OK <tag>`` at the
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
    '4m': chip_smoke.check_windowed_kernels,
    '21': chip_smoke.run_windowed_phase,
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--only', default=','.join(PHASES))
    ap.add_argument('--tag', default='0')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('torch_windowed_phases: no CUDA device available',
              file=sys.stderr)
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
    for i, line in enumerate(lines):     # ptxas -v of the windowed kernels
        if 'Compiling entry' in line and 'windowed' in line:
            for ln in lines[i:i + 4]:
                chip_smoke.log('  ' + ln.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
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
    with open(os.path.join(out, 'windowed_phases_%s.json' % args.tag),
              'w') as f:
        json.dump(rec, f, indent=1, default=str)
    print('OK', args.tag)
    return 0


if __name__ == '__main__':
    sys.exit(main())
