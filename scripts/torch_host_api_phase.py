# -*- coding: utf-8 -*-
"""Phase 23 of ``chip_smoke.py`` alone: ``cg_jit`` / ``cg_ir_traceable``
at 3D p=3 n=48, ``gmres_jit`` at 2D n=128, the reference-signature
assembly entries at 3D n=48, the five example twins at their default
sizes and the host NURBS Hessian against the card's, each held to the
JAX package's CPU counts or to the port's own route.

    python scripts/torch_host_api_phase.py [--seed S] [--tag NAME]

Needs a CUDA card.  Writes ``chiprun_out/host_api_phase_<tag>.json`` and
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
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--tag', default='0')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('torch_host_api_phase: no CUDA device available',
              file=sys.stderr)
        return 2
    from pyiga_tpu_torch import _cuda
    device = torch.device('cuda', 0)
    card = chip_smoke.nvidia_smi()
    chip_smoke.log(card)
    t0 = time.perf_counter()
    _cuda.library()
    t_build = time.perf_counter() - t0
    chip_smoke.log('kernels built+loaded in %.1f s' % t_build)
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = dict(card=card, build_s=t_build,
               phase23=chip_smoke.run_host_api_phase(device, args.seed))
    out = os.path.join(REPO, 'chiprun_out')
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, 'host_api_phase_%s.json' % args.tag),
              'w') as f:
        json.dump(rec, f, indent=1, default=str)
    print('OK %s' % args.tag)
    return 0


if __name__ == '__main__':
    sys.exit(main())
