"""Compare variants of the float32 stage and fold kernel (K2f / K3f,
``fold_f32_kernel`` in ``pyiga_tpu_torch/csrc/sumfac_f32.cu``) on one GPU,
time its parts in place by cutting them out, and time an earlier version
of the source beside it.

    python3 scripts/torch_fold_f32_variants.py [NAME,NAME,...]
        [--parent OLD.cu] [--rounds 3]

Builds one library per variant, all ``nvcc`` processes at once, under
``build/fold_f32_variants/``, and calls its two C entries
(``pyiga_stage_f32``, ``pyiga_fold_f32``) directly.  A variant is the
shipped source built with the ``-D`` constants ``sumfac_f32.cu`` reads:
a lane's tile (``PYIGA_F32_TRQ`` r quads by ``PYIGA_F32_TMQ`` m quads),
the block's warps (``PYIGA_F32_WR`` along r, ``PYIGA_F32_WM`` along m),
the k slice (``PYIGA_F32_BK``), the shared ring's
depth (``PYIGA_F32_STAGES``), the blocks an SM the registers are held to
(``PYIGA_F32_MINB``), X by scalar loads at every R (``PYIGA_F32_SCALAR_X``),
X by
cp.async into the ring (``PYIGA_F32_XASYNC``), the next k's fragments
read by hand before this k's products (``PYIGA_F32_DBUF``),
or parts cut out (``PYIGA_F32_CUT``: the products, the loads, a group's
later terms, the stores, the products with their fragment reads kept).  ``--parent`` adds an earlier
``sumfac_f32.cu`` (``git show
8c64a17:pyiga_tpu_torch/csrc/sumfac_f32.cu > build/sumfac_f32_parent.cu``)
as ``parent``, built the same way.  A variant that does not build is
left out with nvcc's message.  A cut variant computes garbage and is
timed, never checked; every other one is held against the plain version
(``stage_plain`` / ``fold_plain``) to 1e-5 relative, bitwise on a repeat,
and compared bitwise with the first checked variant.

Shapes: the 3D p=3 n=48 f32 line's two stage shapes (K, R, M) = (192,
36,864, 357) and (192, 68,544, 357), and its fold of 6 terms over 3
tables at (192, 127,449, 357) in the plan's table order (0, 0, 1, 0, 1,
2); two ragged folds for the checks.  Seeded random operands.  Times: the
device time of a launch from a CUDA graph of bare C calls cycling
through operand copies larger than the L2 together, in `--rounds`
rounds of alternating order, beside one ``torch.matmul`` in float32
with TF32 off (the fold's over its operands concatenated along K).
The SM clock and power by ``nvidia-smi`` while one variant (``--clocks``)
runs each shape back to back for 2 s.
Prints ptxas's registers and spills of every kernel instance, the card's
``nvidia-smi`` name and power limit, and the times in ms; writes
``chiprun_out/fold_f32_variants.json``.  Exits nonzero without a CUDA
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
    # the k slice, the ring's depth, the fragments' double buffer
    'bk8': (['-DPYIGA_F32_BK=8'], True),
    'stages2': (['-DPYIGA_F32_STAGES=2'], True),
    'bk8_stages2': (['-DPYIGA_F32_BK=8', '-DPYIGA_F32_STAGES=2'], True),
    'no_dbuf': (['-DPYIGA_F32_DBUF=0'], True),
    # the block tile (r x m) at a lane's 8 x 8
    'tile256x128': (['-DPYIGA_F32_WR=8'], True),
    'tile64x128': (['-DPYIGA_F32_WR=2', '-DPYIGA_F32_MINB=4'], True),
    'tile128x64': (['-DPYIGA_F32_WM=1', '-DPYIGA_F32_MINB=4'], True),
    'tile96x128': (['-DPYIGA_F32_WR=3'], True),
    # a lane's tile: 8 r x 16 m or 16 r x 8 m, 128 threads, 2 blocks an SM
    'lane8x16': (['-DPYIGA_F32_TMQ=4', '-DPYIGA_F32_WM=1'], True),
    'lane16x8': (['-DPYIGA_F32_TRQ=4', '-DPYIGA_F32_WR=2'], True),
    # 12 r x 8 m (96 x 192 blocks of 192 threads)
    'lane12x8': (['-DPYIGA_F32_TRQ=3', '-DPYIGA_F32_WR=2',
                  '-DPYIGA_F32_WM=3'], True),
    # the registers: one block an SM
    'minb1': (['-DPYIGA_F32_MINB=1'], True),
    # the staging path of X
    'scalar_x': (['-DPYIGA_F32_SCALAR_X=1'], True),
    'xasync': (['-DPYIGA_F32_XASYNC=1'], True),
    # cuts: timed, never checked
    'no_products': (['-DPYIGA_F32_CUT=1'], False),
    'no_loads': (['-DPYIGA_F32_CUT=2'], False),
    'no_sums': (['-DPYIGA_F32_CUT=3'], False),
    'no_stores': (['-DPYIGA_F32_CUT=4'], False),
    'frag_reads': (['-DPYIGA_F32_CUT=5'], False),
}
ENTRIES = ('pyiga_stage_f32', 'pyiga_fold_f32')
F32_TOL = 1e-5
L2_BYTES = 50 * 2 ** 20


def ptxas_lines(log):
    """'<kernel instance>: registers, spills' from nvcc's -Xptxas=-v."""
    out, name, spill = [], None, ''
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            t = re.search(r'fold_f32_kernelI((?:Li\d+E)+)', name)
            if t:
                name = 'fold_f32_kernel<%s>' % ', '.join(
                    re.findall(r'Li(\d+)E', t.group(1)))
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
    out = os.path.join(REPO, 'build', 'fold_f32_variants')
    os.makedirs(out, exist_ok=True)
    src = os.path.join(REPO, 'pyiga_tpu_torch', 'csrc', 'sumfac_f32.cu')
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
        if proc.returncode != 0:             # the others still run
            print('nvcc failed on %s, left out:\n%s' % (name, log[-3000:]),
                  flush=True)
            continue
        logs[name] = ptxas_lines(log)
        cdll = ctypes.CDLL(lib)
        for fn in ENTRIES:
            getattr(cdll, fn).argtypes = list(_cuda._SIGNATURES[fn])
            getattr(cdll, fn).restype = ctypes.c_int
        libs[name] = cdll
    return libs, logs


class Case:
    """One shape: `copies` operand sets (each its terms' fields and an
    output), the terms' tables, the plain output of the first set and the
    matmul yardstick's operands."""

    def __init__(self, name, K, R, M, idx, device, rng, timed=True):
        from pyiga_tpu_torch.ops import cuda_sumfac as cs
        self.name, self.K, self.R, self.M, self.idx = name, K, R, M, idx
        self.fold = name.startswith('fold')
        ntab = max(idx) + 1
        per = 4 * (K * R * len(idx) + R * M)
        copies = max(1, -(-2 * L2_BYTES // per)) if timed else 1

        def rand(*shape):
            return torch.as_tensor(rng.rand(*shape), dtype=torch.float32,
                                   device=device)
        self.tabs = [rand(M, K) for _ in range(ntab)]
        self.xs_sets = [[rand(K, R) for _ in idx] for _ in range(copies)]
        self.outs = [torch.empty((R, M), dtype=torch.float32, device=device)
                     for _ in range(copies)]
        n = len(idx)
        self.ptrs = [((ctypes.c_uint64 * n)(*[X.data_ptr() for X in xs]),
                      (ctypes.c_uint64 * n)(*[self.tabs[i].data_ptr()
                                              for i in idx]))
                     for xs in self.xs_sets]
        xs = self.xs_sets[0]
        self.ref = (cs.fold_plain(xs, self.tabs, idx) if self.fold
                    else cs.stage_plain(xs[0], self.tabs[0]))
        self.flops = 2 * K * R * M * len(set(idx))
        if timed:
            self.xcat = torch.cat(xs, dim=0).t()
            self.tcat = torch.cat([self.tabs[i] for i in idx], dim=1).t()

    def launch(self, lib, k, out=None):
        out = self.outs[k] if out is None else out
        stream = torch.cuda.current_stream().cuda_stream
        if self.fold:
            xp, tp = self.ptrs[k]
            err = lib.pyiga_fold_f32(
                ctypes.cast(xp, ctypes.c_void_p),
                ctypes.cast(tp, ctypes.c_void_p), len(self.idx),
                out.data_ptr(), self.K, self.R, self.M, stream)
        else:
            err = lib.pyiga_stage_f32(
                self.xs_sets[k][0].data_ptr(), self.tabs[0].data_ptr(),
                out.data_ptr(), self.K, self.R, self.M, stream)
        if err != 0:
            raise RuntimeError('%s: launch failed (%d)' % (self.name, err))
        return out

    def matmul(self):
        if self.fold:
            return torch.matmul(self.xcat, self.tcat)
        return torch.matmul(self.xs_sets[0][0].t(), self.tabs[0].t())


def graph_ms(fn, reps):
    """Device ms a call of `fn(i)`: a CUDA graph of `reps` calls, replayed
    3 times between two events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode='relaxed'):
        for r in range(reps):
            fn(r)
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        g.replay()
    end.record()
    end.synchronize()
    del g
    return start.elapsed_time(end) / (3 * reps)


def sustained_clocks(case, lib, seconds=2.0):
    """The SM clock and power while `lib` runs `case` back to back for
    about `seconds` (``nvidia-smi`` sampled every 100 ms): the FFMA peak
    the card reaches at its power limit is 256 FLOP a clock an SM."""
    g = torch.cuda.CUDAGraph()
    case.launch(lib, 0)
    torch.cuda.synchronize()
    with torch.cuda.graph(g, capture_error_mode='relaxed'):
        for r in range(20):
            case.launch(lib, r % len(case.xs_sets))
    smi = subprocess.Popen(
        ['nvidia-smi', '--query-gpu=clocks.sm,power.draw',
         '--format=csv,noheader,nounits', '-lms', '100'],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    n = 0
    while True:
        g.replay()
        n += 1
        if n % 10 == 0:
            end.record()
            end.synchronize()
            if start.elapsed_time(end) > 1e3 * seconds:
                break
    smi.terminate()
    lines = smi.communicate()[0].split('\n')
    samples = []
    for ln in lines:
        parts = [x.strip() for x in ln.split(',')]
        try:
            samples.append((float(parts[0]), float(parts[1])))
        except (ValueError, IndexError):
            continue
    samples = samples[2:] or samples          # the ramp's first samples
    del g
    return dict(ms_per_launch=start.elapsed_time(end) / (20 * n),
                sm_mhz=[c for c, _p in samples],
                power_w=[p for _c, p in samples])


def sass_summary(lib_path, tag):
    """Each kernel instance's SASS by ``cuobjdump --dump-sass`` (written
    to ``chiprun_out/fold_f32_sass_<tag>.txt``): its opcode counts, and
    the opcode sequence with runs of one opcode folded (``FFMA*64``)."""
    from pyiga_tpu_torch import _cuda
    tool = os.path.join(os.path.dirname(_cuda._nvcc()), 'cuobjdump')
    sass = subprocess.run([tool, '--dump-sass', lib_path], check=True,
                          capture_output=True, text=True).stdout
    os.makedirs(os.path.join(REPO, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(REPO, 'chiprun_out',
                           'fold_f32_sass_%s.txt' % tag), 'w') as f:
        f.write(sass)
    out, fn, ops = {}, None, []
    for ln in sass.splitlines():
        if 'Function :' in ln:
            fn = ln.split('Function :')[1].strip()
            t = re.search(r'fold_f32_kernelI((?:Li\d+E)+)', fn)
            fn = ('fold_f32_kernel<%s>' % ', '.join(
                re.findall(r'Li(\d+)E', t.group(1))) if t else None)
            ops = out.setdefault(fn, []) if fn else None
            continue
        m = re.match(r'\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)',
                     ln)
        if m and ops is not None:
            ops.append(m.group(1))
    summary = {}
    for fn, seq in out.items():
        counts = {}
        for op in seq:
            base = op.split('.')[0]
            counts[base] = counts.get(base, 0) + 1
        runs, prev, n = [], None, 0
        for op in seq + [None]:
            if op == prev:
                n += 1
                continue
            if prev is not None:
                runs.append(prev if n == 1 else '%s*%d' % (prev, n))
            prev, n = op, 1
        summary[fn] = dict(counts=counts, runs=' '.join(runs))
    return summary


def check(case, libs, names, rec):
    """Each checked variant against the plain version, bitwise on a repeat
    and against the first checked variant's output."""
    scale = float(case.ref.double().abs().max())
    first = None
    for name in names:
        got = case.launch(libs[name], 0, torch.empty_like(case.ref))
        again = case.launch(libs[name], 0, torch.empty_like(case.ref))
        torch.cuda.synchronize()
        rel = float((got.double() - case.ref.double()).abs().max()) / scale
        same = bool(torch.equal(got, again))
        vs_first = None if first is None else bool(torch.equal(got, first))
        first = got if first is None else first
        rec['%s %s' % (case.name, name)] = dict(
            rel=rel, repeat_bitwise=same, first_bitwise=vs_first)
        print('  %-22s %-13s rel %.3e repeat %s vs first %s' % (
            case.name, name, rel, 'bitwise' if same else 'DIFFERS',
            {None: '-', True: 'bitwise', False: 'differs'}[vs_first]),
            flush=True)
        if not (rel <= F32_TOL and same and bool(torch.isfinite(got).all())):
            raise RuntimeError('%s %s disagrees' % (case.name, name))
        del again


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('names', nargs='?', default=','.join(VARIANTS))
    ap.add_argument('--parent', default=None)
    ap.add_argument('--rounds', type=int, default=3)
    ap.add_argument('--sass', default='shipped',
                    help='comma-separated variants whose SASS is summed up')
    ap.add_argument('--clocks', default='shipped',
                    help='the variant run back to back for 2 s a shape '
                         'while nvidia-smi samples the SM clock')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('torch_fold_f32_variants: no CUDA device', file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = args.names.split(',')
    if args.parent:
        names = ['parent'] + [x for x in names if x != 'parent']
    device = torch.device('cuda', 0)
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    libs, logs = build(names, args.parent)
    names = [x for x in names if x in libs]
    for name in names:
        for ln in logs[name]:
            print('%-13s %s' % (name, ln), flush=True)
    rec = {'card': card, 'ptxas': logs, 'times': {}, 'matmul': {},
           'checks': {}, 'bound_ms': {}, 'clocks': {}}
    rec['sass'] = {}
    for name in args.sass.split(','):
        if name not in libs:
            continue
        rec['sass'][name] = sass_summary(libs[name]._name, name)
        for fn, d in rec['sass'][name].items():
            print('%s %s: %s' % (name, fn, json.dumps(
                dict(sorted(d['counts'].items(), key=lambda kv: -kv[1])[
                    :14]))), flush=True)
            print('  %s' % d['runs'][:3000], flush=True)
    checked = [x for x in names if x == 'parent' or VARIANTS[x][1]]
    rng = np.random.RandomState(21)
    for name, K, R, M, idx in (('fold ragged 6/3', 13, 1001, 385,
                                (0, 1, 0, 2, 1, 2)),
                               ('fold ragged 16/5', 200, 4099, 1,
                                tuple(t % 5 for t in range(16)))):
        check(Case(name, K, R, M, idx, device, rng, timed=False), libs,
              checked, rec['checks'])
    for name, K, R, M, idx in (('stage R=36864', 192, 36864, 357, (0,)),
                               ('stage R=68544', 192, 68544, 357, (0,)),
                               ('fold 6 terms 3 tables', 192, 127449, 357,
                                (0, 0, 1, 0, 1, 2))):
        case = Case(name, K, R, M, idx, device, rng)
        check(case, libs, checked, rec['checks'])
        bound = case.flops / 67e9
        rec['bound_ms'][name] = bound
        print('%s: K %d R %d M %d, %d terms over %d tables, %d operand '
              'sets; bound %.4f ms (operations)' % (
                  name, K, R, M, len(idx), len(case.tabs),
                  len(case.xs_sets), bound), flush=True)
        reps = 10 if R > 100000 else 20
        times = {x: [] for x in names}
        mm = []
        for rnd in range(args.rounds):
            order = names if rnd % 2 == 0 else names[::-1]
            for x in order:
                times[x].append(graph_ms(
                    lambda i, lib=libs[x]: case.launch(
                        lib, i % len(case.xs_sets)), reps))
            mm.append(graph_ms(lambda i: case.matmul(), reps))
        rec['times'][name], rec['matmul'][name] = times, mm
        if args.clocks in libs:
            c = rec['clocks'][name] = sustained_clocks(case, libs[args.clocks])
            mhz = sorted(c['sm_mhz']) or [float('nan')]
            print('  %-22s %-13s %.4f ms a launch back to back; SM clock '
                  'median %.0f MHz (%.0f-%.0f), power median %.0f W: FFMA '
                  'peak there %.1f TFLOP/s' % (
                      name, args.clocks, c['ms_per_launch'],
                      mhz[len(mhz) // 2], mhz[0], mhz[-1],
                      sorted(c['power_w'] or [0])[len(c['power_w']) // 2],
                      132 * 256 * mhz[len(mhz) // 2] * 1e6 / 1e12),
                  flush=True)
        for x in names:
            print('  %-22s %-13s %s ms (%.0f %% of bound)' % (
                name, x, ' '.join('%.4f' % t for t in times[x]),
                100 * bound / min(times[x])), flush=True)
        print('  %-22s %-13s %s ms' % (name, 'matmul', ' '.join(
            '%.4f' % t for t in mm)), flush=True)
        del case
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(REPO, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(REPO, 'chiprun_out', 'fold_f32_variants.json'),
              'w') as f:
        json.dump(rec, f, indent=1)
    print('OK')
    return 0


if __name__ == '__main__':
    sys.exit(main())
