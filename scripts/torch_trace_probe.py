# -*- coding: utf-8 -*-
"""How complete a ``profiling.trace`` of the entry step is: for several
trace sessions in one process, the CUDA launches the trace records
(``cudaLaunchKernel``) against the kernel records CUPTI delivers for
them, and which launches lost theirs.

    python scripts/torch_trace_probe.py [--n 48] [--sessions 4]
        [--before 22b,23] [--tag X]

Each session traces one ``_single_chip_step`` of the entry twin at 3D
p=3 n (default 48); then as many sessions again, each starting with
eight one-element kernels and a synchronize inside the trace (a
warm-up, to see whether the lost records are a session's first ones
whatever they are).  ``--before`` first runs those phases of
``chip_smoke.py`` in the same process (22b holds two ``torch.profiler``
sessions of its own).  Needs a CUDA card.  Writes
``chiprun_out/trace_probe_<tag>.json`` and the traces under
``chiprun_out/trace_probe_<tag>/``."""

import argparse
import glob
import json
import os
import shutil
import sys

import torch

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..')
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--n', type=int, default=48)
    ap.add_argument('--sessions', type=int, default=4)
    ap.add_argument('--before', default='',
                    help="chip_smoke.py phases to run first: 22b, 23")
    ap.add_argument('--tag', default='0')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('torch_trace_probe: no CUDA device available', file=sys.stderr)
        return 2
    from pyiga_tpu_torch import bspline, geometry, profiling
    from pyiga_tpu_torch.__graft_entry__ import _single_chip_step
    from pyiga_tpu_torch.assemblers import StiffnessAssembler
    import chip_smoke
    device = torch.device('cuda', 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    phases = {'22b': chip_smoke.run_f32_line,
              '23': chip_smoke.run_host_api_phase}
    for name in filter(None, args.before.split(',')):
        chip_smoke.log('phase %s first' % name)
        phases[name](device)
        torch.cuda.empty_cache()
    kvs = 3 * (bspline.make_knots(3, 0.0, 1.0, args.n),)
    step, sargs = _single_chip_step(
        StiffnessAssembler(kvs, geometry.twisted_box(), device=device))
    step(*sargs)
    torch.cuda.synchronize()
    out = os.path.join(REPO, 'chiprun_out', 'trace_probe_%s' % args.tag)
    shutil.rmtree(out, ignore_errors=True)
    rec = dict(card=chip_smoke.nvidia_smi(), n=args.n, before=args.before,
               sessions=[])
    warm = torch.zeros(1, dtype=torch.float64, device=device)
    for s in range(2 * args.sessions):
        logdir = os.path.join(out, 'session%d' % s)
        with profiling.trace(logdir):
            if s >= args.sessions:
                for _ in range(8):
                    warm.add_(1.0)
                torch.cuda.synchronize()
            step(*sargs)
            torch.cuda.synchronize()
        (path,) = glob.glob(os.path.join(logdir, '*.pt.trace.json'))
        r = chip_smoke.read_trace(path)[2]
        r['warmup'] = s >= args.sessions
        rec['sessions'].append(r)
        chip_smoke.log('session %d (warm-up %s): %d launches, %d kernel '
                       'records, lost %s'
                       % (s, r['warmup'], r['launches'], r['kernel_records'],
                          [(x['index'], x['op']) for x in r['lost']]))
    with open(os.path.join(REPO, 'chiprun_out',
                           'trace_probe_%s.json' % args.tag), 'w') as f:
        json.dump(rec, f, indent=1)
    print('OK %s' % args.tag)
    return 0


if __name__ == '__main__':
    sys.exit(main())
