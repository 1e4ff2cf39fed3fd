# -*- coding: utf-8 -*-
"""Phase 25 of ``chip_smoke.py`` alone: the multi-device layer
(``pyiga_tpu_torch.parallel``) on the card: the sharded flagship and step
at 3D p=3 n=48 over NCCL at world size 1 against phase 5's solve and
``_single_chip_step``, the same on two rank processes sharing the card
over gloo (each rank's launches, CUDA-event ms, halo bytes, collective
share), ``dryrun_multichip(4, backend='gloo')``, the three patches and
``vmap(grad)`` over the ranks, NCCL across cards where there are two.

    python scripts/torch_parallel_phase.py [--tag NAME] [--cutoffs]
                                           [--skip-phase]

``--cutoffs`` also times the crossover that the JAX package's host
cutoffs route by (``chip_smoke.cutoff_crossover``: the HB (24, 3) and
(48, 3) assembly on the card and on the CPU, the local-MG solve by K6 and
by the host sweeps; the port has no such cutoff); ``--skip-phase`` runs
only that.  Needs a CUDA card.  Writes
``chiprun_out/parallel_phase_<tag>.json`` and prints ``OK <tag>`` at the
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
    ap.add_argument('--cutoffs', action='store_true')
    ap.add_argument('--skip-phase', action='store_true')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('torch_parallel_phase: no CUDA device available',
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
    rec = dict(card=card, build_s=t_build)
    if not args.skip_phase:
        rec['phase25'] = chip_smoke.run_parallel_phase(device)
    if args.cutoffs or args.skip_phase:
        rec['cutoffs'] = chip_smoke.cutoff_crossover(device)
    out = os.path.join(REPO, 'chiprun_out')
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, 'parallel_phase_%s.json' % args.tag),
              'w') as f:
        json.dump(rec, f, indent=1, default=str)
    print('OK %s' % args.tag)
    return 0


if __name__ == '__main__':
    sys.exit(main())
