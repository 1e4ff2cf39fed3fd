# -*- coding: utf-8 -*-
"""Phases 4l and 17-19 of ``chip_smoke.py`` alone: K1's ``jac`` kind, K5,
K2 and K3 at the shapes of surface integrals and second derivatives
against their plain versions, then the surface-integral, second-
derivative and multipatch / hierarchical paths at full width, each held
to a CPU setup, with their launches counted.

    python scripts/torch_item8_phases.py [--only 4l,17,18,19] [--tag NAME]

Needs a CUDA card.  Writes ``chiprun_out/item8_phases_<tag>.json`` and
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

PHASES = {
    '4l': lambda dev: chip_smoke.check_item8_kernels(dev),
    '17': lambda dev: chip_smoke.run_item8_phase(
        'phase 17', chip_smoke.run_surface, dev),
    '18': lambda dev: chip_smoke.run_item8_phase(
        'phase 18', chip_smoke.run_second_derivatives, dev),
    '19': lambda dev: chip_smoke.run_item8_phase(
        'phase 19', chip_smoke.run_multipatch, dev),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--only', default=','.join(PHASES))
    ap.add_argument('--tag', default='0')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('torch_item8_phases: no CUDA device available',
              file=sys.stderr)
        return 2
    from pyiga_tpu_torch import _cuda
    device = torch.device('cuda', 0)
    chip_smoke.log(chip_smoke.nvidia_smi())
    t0 = time.perf_counter()
    _cuda.library()
    chip_smoke.log('kernels built+loaded in %.1f s' % (time.perf_counter()
                                                       - t0))
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = {}
    for ph in args.only.split(','):
        chip_smoke.log('phase %s' % ph)
        t0 = time.perf_counter()
        rec[ph] = PHASES[ph](device)
        rec[ph + '_s'] = time.perf_counter() - t0
        chip_smoke.log('phase %s took %.1f s' % (ph, rec[ph + '_s']))
        torch.cuda.empty_cache()
    out = os.path.join(REPO, 'chiprun_out')
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, 'item8_phases_%s.json' % args.tag),
              'w') as f:
        json.dump(rec, f, indent=1, default=str)
    print('OK', args.tag)
    return 0


if __name__ == '__main__':
    sys.exit(main())
