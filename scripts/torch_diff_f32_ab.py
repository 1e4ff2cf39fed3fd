"""Time phase 20g's float32 gradients (``chip_smoke.diff_f32_problems``:
the 3D p=3 n=48 stiffness and mass shape gradients, the 2D p=3 n=128
convection-diffusion and input-form gradients) of two or more checkouts
on one GPU in one call, in alternating order.

    python3 scripts/torch_diff_f32_ab.py --trees DIR,DIR[,...]
        [--order 0,1,1,0] [--reps 10] [--only NAME,NAME]

Each tree is a checkout's root (``.`` for this one; an earlier commit
unpacked by ``git archive`` into a directory under ``build/``).  The
script first builds every tree's kernel library, one process a tree, all
at once; then runs one process for each entry of ``--order`` (an index
into ``--trees``), which imports that tree's ``chip_smoke`` and
``pyiga_tpu_torch`` and, under ``set_dtype(float32)``, builds the
problems, warms each once, and times each over ``--reps`` runs: the
forward and the backward by CUDA events as phase 20g does, the
backward's host time (the host clock around ``torch.autograd.grad``, which
returns once its launches are queued), and the backward's launches of
``stage_bwd_f32`` and ``fold_bwd_f32`` a run.  Where the backward's host
time is close to its event time, the host sets its pace and a faster
kernel does not show in it.  The pseudo-problem ``wrappers`` times the
backward wrappers alone at their 2D n=128 shapes (the stage (512, 512,
905), the fold (512, 905, 905) over 3 tables) and at the ragged fold (33,
1,001, 7) over 2 tables: 200 calls back to back, the host clock until
the last call returns (host ms a call) and CUDA events until the card is
done (ms a call: the larger of the host's and the card's pace).  Prints
the card's ``nvidia-smi`` name and power limit and a line a problem and
process; writes
``chiprun_out/diff_f32_ab.json``.  Exits nonzero without a CUDA device.
Imports neither jax nor pyiga_tpu.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBLEMS = ('stiffness_3d', 'mass_3d', 'convdiff_shape_2d', 'convdiff_b_2d',
            'input_c_2d', 'param_eps_2d', 'wrappers')
# (K, R, M, term indices) of the wrappers timed; one term: stage_bwd
WRAPPERS = {'2D stage': (512, 512, 905, (0,)),
            '2D fold': (512, 905, 905, (0, 1, 2, 0, 1, 2)),
            'ragged fold': (33, 1001, 7, (1, 0, 1))}


def wrapper_times(device, calls=200, rounds=3):
    """Host and event ms a call of ``stage_bwd`` / ``fold_bwd`` at
    :data:`WRAPPERS`, `rounds` rounds of `calls` calls."""
    import numpy as np
    import torch
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    rng = np.random.RandomState(7)
    out = {}
    for name, (K, R, M, idx) in WRAPPERS.items():
        tabs = [torch.as_tensor(rng.rand(M, K), dtype=torch.float32,
                                device=device) for _ in range(max(idx) + 1)]
        g = torch.as_tensor(rng.rand(R, M), dtype=torch.float32,
                            device=device)
        if len(idx) == 1:
            def fn():
                return cs.stage_bwd(tabs[0], g)
        else:
            def fn():
                return cs.fold_bwd(tabs, idx, g)
        for _ in range(5):
            fn()
        host, ev = [], []
        for _ in range(rounds):
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            h0 = time.perf_counter()
            for _ in range(calls):
                fn()
            h1 = time.perf_counter()
            e1.record()
            e1.synchronize()
            host.append(1e3 * (h1 - h0) / calls)
            ev.append(e0.elapsed_time(e1) / calls)
        out[name] = dict(host_ms=host, ms=ev)
    return out


def worker(tree, reps, names, n3=48, n2=128):
    """One process's timings of `tree`'s problems `names`: ``{name:
    {...}}``."""
    import numpy as np
    import torch
    sys.path.insert(0, tree)
    import chip_smoke
    from pyiga_tpu_torch import _cuda
    assert os.path.abspath(_cuda.__file__).startswith(tree)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device('cuda', 0)
    _cuda.library()
    counters = ('stage_bwd_f32', 'fold_bwd_f32')
    out = {}
    with chip_smoke.ComputeDtype(torch.float32):
        for name in names:
            if name == 'wrappers':
                out[name] = wrapper_times(device)
                continue
            fn, x0 = chip_smoke.diff_f32_problems(device, n3, n2,
                                                  only=name)[name]
            k = PROBLEMS.index(name)
            x = torch.as_tensor(np.asarray(x0, dtype=float),
                                dtype=torch.float64, device=device)
            with torch.no_grad():
                shape = fn(x).shape
            w = np.random.RandomState(k + 30).rand(*shape)
            fwd, bwd, host = [], [], []
            for r in range(reps + 1):
                if r == 1:
                    _cuda.reset_launches()
                xr = x.clone().requires_grad_(True)
                torch.cuda.synchronize()
                e = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                e[0].record()
                val = fn(xr)
                e[1].record()
                e[1].synchronize()
                wt = torch.as_tensor(w, dtype=val.dtype, device=device)
                e[2].record()
                h0 = time.perf_counter()
                (g,) = torch.autograd.grad((wt * val).sum(), xr)
                h1 = time.perf_counter()
                e[3].record()
                e[3].synchronize()
                if r:
                    fwd.append(e[0].elapsed_time(e[1]))
                    bwd.append(e[2].elapsed_time(e[3]))
                    host.append(1e3 * (h1 - h0))
            out[name] = dict(
                forward_ms=fwd, backward_ms=bwd, backward_host_ms=host,
                launches={c: _cuda.LAUNCHES[c] / reps for c in counters})
            del val, g
    return out


def run(cmd, timeout):
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    if p.returncode != 0:
        raise RuntimeError('%s failed (%d):\n%s\n%s' % (
            ' '.join(cmd), p.returncode, p.stdout[-3000:], p.stderr[-3000:]))
    return p.stdout


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--trees', default='.')
    ap.add_argument('--order', default=None)
    ap.add_argument('--reps', type=int, default=10)
    ap.add_argument('--only', default='')
    ap.add_argument('--worker', default=None, help=argparse.SUPPRESS)
    ap.add_argument('--build', default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('torch_diff_f32_ab: no CUDA device', file=sys.stderr)
        return 2
    only = [x for x in args.only.split(',') if x] or list(PROBLEMS)
    if args.build:
        sys.path.insert(0, args.build)
        from pyiga_tpu_torch import _cuda
        _cuda.library()
        print('built %s in %.1f s' % (args.build,
                                      _cuda.BUILD_INFO['seconds']))
        return 0
    if args.worker:
        print('RESULT ' + json.dumps(worker(args.worker, args.reps, only)))
        return 0
    trees = [os.path.abspath(os.path.join(REPO, t))
             for t in args.trees.split(',')]
    order = ([int(i) for i in args.order.split(',')] if args.order
             else list(range(len(trees))))
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    me = os.path.abspath(__file__)
    builds = [subprocess.Popen([sys.executable, me, '--build', t],
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
              for t in trees]
    for t, p in zip(trees, builds):
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError('build of %s failed:\n%s' % (t, log[-3000:]))
        print(log.strip(), flush=True)
    rec = dict(card=card, trees=trees, order=order, reps=args.reps,
               runs=[])
    for i in order:
        cmd = [sys.executable, me, '--worker', trees[i], '--reps',
               str(args.reps), '--only', args.only]
        res = None
        for ln in run(cmd, 1200).splitlines():
            if ln.startswith('RESULT '):
                res = json.loads(ln[7:])
        rec['runs'].append(dict(tree=trees[i], result=res))
        for name, r in res.items():
            if name == 'wrappers':
                for w, t in r.items():
                    print('%-40s wrapper %-12s host %s ms a call; events %s'
                          ' ms a call' % (
                              os.path.relpath(trees[i], REPO), w,
                              ' '.join('%.4f' % x for x in t['host_ms']),
                              ' '.join('%.4f' % x for x in t['ms'])),
                          flush=True)
                continue
            print('%-40s %-18s forward %s; backward %s (min %.3f, median '
                  '%.3f) ms; backward host %s ms; launches %s' % (
                      os.path.relpath(trees[i], REPO), name,
                      ' '.join('%.2f' % t for t in r['forward_ms']),
                      ' '.join('%.2f' % t for t in r['backward_ms']),
                      min(r['backward_ms']),
                      sorted(r['backward_ms'])[len(r['backward_ms']) // 2],
                      ' '.join('%.2f' % t for t in r['backward_host_ms']),
                      r['launches']), flush=True)
    os.makedirs(os.path.join(REPO, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(REPO, 'chiprun_out', 'diff_f32_ab.json'),
              'w') as f:
        json.dump(rec, f, indent=1)
    print('OK')
    return 0


if __name__ == '__main__':
    sys.exit(main())
