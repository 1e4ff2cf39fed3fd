"""Compare variants of the windowed route's kernel (K8 / K8f,
``pyiga_tpu_torch/csrc/windowed.cu``) on one GPU, time its parts in place
by cutting them out, and time an earlier version of the source beside it.

    python3 scripts/torch_windowed_variants.py [NAME,NAME,...]
        [--parent OLD.cu] [--cases 3d,2d]

Builds one library per variant, all ``nvcc`` processes at once, under
``build/windowed_variants/``, and calls its C entries directly.  A
variant is the shipped source built with the plan overrides or cut points
that ``windowed.cu`` reads from the preprocessor: two X stages at most
(``stages2``), r a lane forced to 1, 2 or 3 (``rpt1`` .. ``rpt3``), one
output span buffer (``ys1``) or none (``no_ys``: the lanes store
directly), X by
16-byte ``cp.async`` where tensor copies would serve (``no_tma``), one
producer warp instead of 4 (``producer1``), or parts cut out: the
products and stores (``loads_only``), the loads and stores
(``products_only``), the loads and products (``stores_only``), the
loads alone (``no_loads``), or every consumer (``producer_alone``: the
producer warps stream the X tiles through their ring by themselves).  ``--parent`` adds an earlier ``windowed.cu`` (``git show
REV:pyiga_tpu_torch/csrc/windowed.cu > build/windowed_parent.cu``) as
``parent``, built the same way.  A cut variant computes garbage; every
other one is held against the plain version to 1e-14 relative, bitwise
on a repeat, and compared bitwise with the parent.

Shapes: the 3D p=3 n=48 twisted box's stage 1 (192, 36,864), stage 2
(192, 68,544) and the fold of its 6 plan terms over (192, 127,449); the
2D p=3 n=128 quarter annulus's stage 1 (512, 512) and the fold of its
plan terms over (512, 917); seeded random fields.  A 2D case cycles
through copies of its operands larger than the L2 (50 MB) together.
Times: the device time of a launch, from a CUDA graph of launches timed
by CUDA events, in three rounds of alternating order; for the shipped
source and the parent also calls back to back without a graph, so that
a C entry's host time shows where it exceeds the device's.  Prints ptxas's
registers and spills of every kernel instance, each case's plan
(``pyiga_windowed_plan`` on the card against ``windowed_plan``), the
card's ``nvidia-smi`` name and power limit, and the times in ms; writes
``chiprun_out/windowed_variants.json``.  Exits nonzero without a CUDA
device.  Imports neither jax nor pyiga_tpu.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# name -> (preprocessor flags, checked against the plain version)
VARIANTS = {
    'shipped': ([], True),
    'stages2': (['-DPYIGA_WIN_STAGES=2'], True),
    'rpt1': (['-DPYIGA_WIN_RPT=1'], True),
    'rpt2': (['-DPYIGA_WIN_RPT=2'], True),
    'rpt3': (['-DPYIGA_WIN_RPT=3'], True),
    'ys1': (['-DPYIGA_WIN_MAX_YS=1'], True),
    'no_ys': (['-DPYIGA_WIN_NO_YS=1'], True),
    'no_tma': (['-DPYIGA_WIN_NO_TMA=1'], True),
    'producer1': (['-DPYIGA_WIN_PRODUCER_WARPS=1'], True),
    'loads_only': (['-DPYIGA_WIN_CUT=6'], False),
    'products_only': (['-DPYIGA_WIN_CUT=5'], False),
    'stores_only': (['-DPYIGA_WIN_CUT=3'], False),
    'no_loads': (['-DPYIGA_WIN_CUT=1'], False),
    'producer_alone': (['-DPYIGA_WIN_CUT=8'], False),
}
PLAN_KEYS = ('rpt', 'run', 'nruns', 'cap', 'box', 'ps', 'xs', 'stages', 'nys',
             'rtiles', 'cpr', 'smem')


def ptxas_lines(log):
    """'<kernel instance>: registers, spills' from nvcc's -Xptxas=-v."""
    out, name, spill = [], None, ''
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            t = re.search(r'windowed_kernelI([df])Li(\d+)ELi(\d+)E', name)
            if t:
                name = 'windowed_kernel<%s, %s, %s>' % (
                    {'d': 'double', 'f': 'float'}[t.group(1)],
                    t.group(2), t.group(3))
        elif 'spill' in ln:
            spill = ln.strip()
        elif 'Used' in ln and 'registers' in ln and name:
            regs = re.search(r'Used (\d+) registers', ln)
            out.append('%s: %s registers; %s' % (
                name, regs.group(1) if regs else '?', spill))
            name = None
    return out


def build(names, parent):
    from pyiga_tpu_torch import _cuda
    out = os.path.join(REPO, 'build', 'windowed_variants')
    os.makedirs(out, exist_ok=True)
    src = os.path.join(REPO, 'pyiga_tpu_torch', 'csrc', 'windowed.cu')
    procs = {}
    for name in names:
        path, flags = ((parent, []) if name == 'parent'
                       else (src, VARIANTS[name][0]))
        lib = os.path.join(out, 'lib%s.so' % name)
        procs[name] = (lib, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, *flags, '-I',
             os.path.join(REPO, 'pyiga_tpu_torch', 'csrc'), '-shared', '-o',
             lib, path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs, logs = {}, {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError('nvcc failed on %s:\n%s' % (name, log))
        logs[name] = ptxas_lines(log)
        cdll = ctypes.CDLL(lib)
        for fn in ('pyiga_windowed_stage_f64', 'pyiga_windowed_fold_f64'):
            getattr(cdll, fn).argtypes = list(_cuda._SIGNATURES[fn])
            getattr(cdll, fn).restype = ctypes.c_int
        if name != 'parent':
            cdll.pyiga_windowed_plan.argtypes = list(
                _cuda._SIGNATURES['pyiga_windowed_plan'])
            cdll.pyiga_windowed_plan.restype = ctypes.c_int
        libs[name] = cdll
    return libs, logs


class Case:
    """One shape: `copies` operand sets (each its terms' fields and an
    output), the terms' tables, and the plain output of the first set."""

    def __init__(self, name, xs_sets, tabs, idx, fs, nqp):
        from pyiga_tpu_torch.ops import cuda_sumfac as cs
        self.name, self.tabs, self.idx, self.fs, self.nqp = (
            name, tabs, idx, fs, nqp)
        self.fold = len(xs_sets[0]) > 1 or name.startswith('fold')
        self.xs_sets = xs_sets
        self.Q, self.R = xs_sets[0][0].shape
        self.n, self.b, self.wsz = tabs[0].shape
        self.ys = [torch.empty((self.R, self.b * self.n),
                               dtype=torch.float64, device=fs.device)
                   for _ in xs_sets]
        k = len(idx)
        self.ptrs = [((ctypes.c_uint64 * k)(*[X.data_ptr() for X in xs]),
                      (ctypes.c_uint64 * k)(*[tabs[i].data_ptr()
                                              for i in idx]))
                     for xs in xs_sets]
        self.ref = cs.windowed_fold_plain(xs_sets[0], tabs, idx, fs, nqp)

    def launch(self, lib, k, Y=None):
        Y = self.ys[k] if Y is None else Y
        stream = torch.cuda.current_stream().cuda_stream
        if not self.fold:
            err = lib.pyiga_windowed_stage_f64(
                self.xs_sets[k][0].data_ptr(),
                self.tabs[self.idx[0]].data_ptr(), self.fs.data_ptr(),
                Y.data_ptr(), self.Q, self.R, self.n, self.b, self.wsz,
                self.nqp, stream)
        else:
            xp, tp = self.ptrs[k]
            err = lib.pyiga_windowed_fold_f64(
                ctypes.cast(xp, ctypes.c_void_p),
                ctypes.cast(tp, ctypes.c_void_p), len(self.idx),
                self.fs.data_ptr(), Y.data_ptr(), self.Q, self.R, self.n,
                self.b, self.wsz, self.nqp, stream)
        if err != 0:
            raise RuntimeError('%s: launch failed (%d)' % (self.name, err))
        return Y

    def plan(self, lib, nsm):
        out = (ctypes.c_longlong * 12)()
        lib.pyiga_windowed_plan(self.Q, self.R, self.n, self.b, self.wsz,
                                self.nqp, len(self.tabs), nsm,
                                ctypes.cast(out, ctypes.c_void_p))
        return dict(zip(PLAN_KEYS, list(out)))


def make_cases(device, which):
    from pyiga_tpu_torch import assemblers, bspline, geometry
    from pyiga_tpu_torch.ops.sumfac import last_table_groups
    rng = np.random.RandomState(17)

    def rand(*shape):
        return torch.as_tensor(rng.rand(*shape), device=device)
    out = []
    for dim, nel in ((3, 48), (2, 128)):
        if '%dd' % dim not in which:
            continue
        geo = geometry.twisted_box() if dim == 3 else \
            geometry.quarter_annulus()
        asm = assemblers.StiffnessAssembler(
            dim * (bspline.make_knots(3, 0.0, 1.0, nel),), geo,
            device=device)
        wtabs, fss = asm.tables.windowed_term_tables(asm.terms)
        nqp = asm.tables.nqps[0]
        fs = torch.as_tensor(fss[0], device=device)
        Q = asm.tables.trial[0].shape[2]
        bn = wtabs[0][0].shape[0] * wtabs[0][0].shape[1]
        stage_rs = [(0, Q ** (dim - 1))] + ([(1, Q * bn)] if dim == 3
                                            else [])
        for k, R in stage_rs:
            copies = max(1, -(-60_000_000 // (8 * R * (Q + bn))))
            P = torch.as_tensor(wtabs[0][k], device=device)
            out.append(Case('stage %d %dD' % (k + 1, dim),
                            [[rand(Q, R)] for _ in range(copies)], [P],
                            [0], fs, nqp))
        plan = asm._fold()
        idx = list(last_table_groups([wtabs[t] for t, _m in plan]))
        tabs = [None] * (max(idx) + 1)
        for (t, _m), i in zip(plan, idx):
            tabs[i] = torch.as_tensor(wtabs[t][-1], device=device)
        R = bn ** (dim - 1)
        copies = max(1, -(-60_000_000 // (8 * R * (Q * len(plan) + bn))))
        out.append(Case('fold %dD' % dim,
                        [[rand(Q, R) for _ in plan] for _ in range(copies)],
                        tabs, idx, fs, nqp))
        del asm
    return out


def graph_ms(case, lib, reps):
    """Device ms a launch: a CUDA graph of `reps` launches cycling through
    the case's operand sets, replayed 3 times between two events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for k in range(len(case.xs_sets)):
            case.launch(lib, k)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode='relaxed'):
        for r in range(reps):
            case.launch(lib, r % len(case.xs_sets))
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def stream_ms(case, lib, reps):
    """Ms a call of the bare C entry, `reps` calls back to back on the
    stream between two events (no graph: the host's cost of a call shows
    where it exceeds the device's)."""
    for k in range(len(case.xs_sets)):
        case.launch(lib, k)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for r in range(reps):
        case.launch(lib, r % len(case.xs_sets))
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('names', nargs='?', default=','.join(VARIANTS))
    ap.add_argument('--parent', default=None)
    ap.add_argument('--cases', default='3d,2d')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('torch_windowed_variants: no CUDA device', file=sys.stderr)
        return 2
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    names = args.names.split(',')
    if args.parent:
        names = ['parent'] + [x for x in names if x != 'parent']
    device = torch.device('cuda', 0)
    nsm = torch.cuda.get_device_properties(0).multi_processor_count
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    libs, logs = build(names, args.parent)
    for name in names:
        for ln in logs[name]:
            print('%-14s %s' % (name, ln), flush=True)
    rec = {'card': card, 'nsm': nsm, 'ptxas': logs, 'times': {},
           'stream_times': {}, 'checks': {}, 'plans': {}}
    checked = [x for x in names if x == 'parent' or VARIANTS[x][1]]
    for case in make_cases(device, args.cases):
        plans = {}
        for name in names:
            if name == 'parent':
                continue
            plans[name] = case.plan(libs[name], nsm)
        mirror = cs.windowed_plan(case.Q, case.R, case.n, case.b, case.wsz,
                                  case.nqp, len(case.tabs), nsm)
        if 'shipped' in plans and plans['shipped'] != mirror:
            raise RuntimeError('%s: the card plan %s differs from '
                               'windowed_plan %s' % (case.name,
                                                     plans['shipped'],
                                                     mirror))
        rec['plans'][case.name] = plans
        print('%s: Q %d R %d n %d b %d, %d terms over %d tables, %d '
              'operand sets; plan %s' % (
                  case.name, case.Q, case.R, case.n, case.b, len(case.idx),
                  len(case.tabs), len(case.xs_sets),
                  plans.get('shipped', mirror)), flush=True)
        scale = float(case.ref.abs().max())
        outs = {}
        for name in checked:
            got = case.launch(libs[name], 0, torch.empty_like(case.ref))
            again = case.launch(libs[name], 0, torch.empty_like(case.ref))
            torch.cuda.synchronize()
            rel = float((got - case.ref).abs().max()) / scale
            same = bool(torch.equal(got, again))
            outs[name] = got
            vs_parent = (bool(torch.equal(got, outs['parent']))
                         if 'parent' in outs and name != 'parent' else None)
            rec['checks']['%s %s' % (case.name, name)] = dict(
                rel=rel, repeat_bitwise=same, parent_bitwise=vs_parent)
            print('  %-8s %-14s rel %.3e repeat %s parent %s' % (
                case.name, name, rel, 'bitwise' if same else 'DIFFERS',
                {None: '-', True: 'bitwise', False: 'differs'}[vs_parent]),
                flush=True)
            if not (rel <= 1e-14 and same):
                raise RuntimeError('%s %s disagrees' % (case.name, name))
            del again
        del outs
        reps = 10 if case.R * case.b * case.n > 10_000_000 else 40
        times = {name: [] for name in names}
        for rnd in range(3):
            order = names if rnd % 2 == 0 else names[::-1]
            for name in order:
                times[name].append(graph_ms(case, libs[name], reps))
        rec['times'][case.name] = times
        for name in names:
            print('  %-8s %-14s %s ms' % (case.name, name, ' '.join(
                '%.4f' % t for t in times[name])), flush=True)
        # the shipped source and the parent called back to back, no graph
        pair = [x for x in ('parent', 'shipped') if x in names]
        stream = {name: [] for name in pair}
        for rnd in range(3):
            for name in (pair if rnd % 2 == 0 else pair[::-1]):
                stream[name].append(stream_ms(case, libs[name], 4 * reps))
        rec['stream_times'][case.name] = stream
        for name in pair:
            print('  %-8s %-14s %s ms a call back to back' % (
                case.name, name, ' '.join('%.4f' % t
                                          for t in stream[name])),
                flush=True)
        del case
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(REPO, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(REPO, 'chiprun_out', 'windowed_variants.json'),
              'w') as f:
        json.dump(rec, f, indent=1)
    print('OK')
    return 0


if __name__ == '__main__':
    sys.exit(main())
