# -*- coding: utf-8 -*-
"""Phase 24 of ``chip_smoke.py`` alone: the entry twin
(``pyiga_tpu_torch.__graft_entry__``) on the card against the CPU at
JAX's size and at 3D p=3 n=48 (data against ``run_device()``, x against
a host CG, ms, K1 / K2 / K3 launches), ``profiling.timed`` and
``profiling.trace`` around its step (the trace must name
``geo_fields_kernel``, ``stage_kernel`` and ``fold_kernel``), and
``str2asm --source``.

    python scripts/torch_entry_phase.py [--tag NAME]

Needs a CUDA card.  Writes ``chiprun_out/entry_phase_<tag>.json`` and the
trace under ``chiprun_out/entry_trace/``, and prints ``OK <tag>`` at the
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--tag', default='0')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('torch_entry_phase: no CUDA device available', file=sys.stderr)
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
               phase24=chip_smoke.run_entry_phase(device))
    out = os.path.join(REPO, 'chiprun_out')
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, 'entry_phase_%s.json' % args.tag), 'w') as f:
        json.dump(rec, f, indent=1, default=str)
    print('OK %s' % args.tag)
    return 0


if __name__ == '__main__':
    sys.exit(main())
