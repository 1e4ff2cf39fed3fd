# -*- coding: utf-8 -*-
"""Phases 4k and 16 of ``chip_smoke.py`` alone: the port's Navier-Stokes
kernels against their plain versions at the path's shapes, then the
channel at (16, 32) to t = 1 on the device scheme against the host
scheme and the JAX package's step sequence, with ms per attempt and per
F / J evaluation.  F and J are host-bound, so their times vary between
processes; run the script several times to see the spread.

    python scripts/torch_ns_phases.py [--ns-only] [--tag NAME]

Needs a CUDA card.  Writes ``chiprun_out/ns_phases_<tag>.json`` and
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--ns-only', action='store_true',
                    help='phase 16 only (skip phase 4k)')
    ap.add_argument('--tag', default='0')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('torch_ns_phases: no CUDA device available', file=sys.stderr)
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
    if not args.ns_only:
        chip_smoke.log('phase 4k')
        rec['ns_kernels'] = chip_smoke.check_ns_kernels(device)
        torch.cuda.empty_cache()
    chip_smoke.log('phase 16')
    rec['navier_stokes'] = chip_smoke.run_navier_stokes(device)
    out = os.path.join(REPO, 'chiprun_out')
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, 'ns_phases_%s.json' % args.tag), 'w') as f:
        json.dump(rec, f, indent=1, default=str)
    print('OK', args.tag)
    return 0


if __name__ == '__main__':
    sys.exit(main())
