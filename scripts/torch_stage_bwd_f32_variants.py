"""Compare variants of the float32 stage backward kernel (K2-bwd f32 /
K3-bwd f32, ``stage_bwd_f32_kernel`` in
``pyiga_tpu_torch/csrc/sumfac_f32.cu``) on one GPU, time its parts in
place by cutting them out, time splits of M other than the plan's, and
time an earlier version of the source beside it.

    python3 scripts/torch_stage_bwd_f32_variants.py [NAME,NAME,...]
        [--parent OLD.cu] [--rounds 3]

Builds one library per variant, all ``nvcc`` processes at once, under
``build/stage_bwd_f32_variants/``, and calls its C entry
``pyiga_stage_bwd_f32`` directly with the plan of
``cuda_sumfac.stage_bwd_f32_plan`` (132 SMs) over the tiles that variant's
library reports (``pyiga_stage_bwd_f32_tiles``).  A variant is the
shipped source built with the ``-D`` constants ``sumfac_f32.cu`` reads:
Tile192's lane tile (``PYIGA_BWD32_TKQ``: 2, 3 or 4 k quads, so 8 x 8, 12
x 8 or 16 x 8 a lane), its r width (``PYIGA_BWD32_LR`` lanes of 8 r),
Tile128's lane tile and r width (``PYIGA_BWD32_T128_*``), the ring's
depth (``PYIGA_BWD32_STAGES``), the next m's fragments read by hand
before this m's products (``PYIGA_BWD32_DBUF``), or parts cut out
(``PYIGA_BWD32_CUT``: the products, the copies, the stores, the products
with their fragment reads kept); or a copy of the source under
``build/`` patched by the text replacements of :data:`PATCHES`: Tile128
at two blocks an SM, and the block's g slab resident in shared memory
with every table run over it (where the slab fits: K = 192, M = 345).  A
patch that no longer applies leaves its variant out.  ``--parent`` adds
an earlier ``sumfac_f32.cu`` whose ``pyiga_stage_bwd_f32`` takes no plan
(``git show ae5eb8f:pyiga_tpu_torch/csrc/sumfac_f32.cu >
build/sumfac_f32_parent.cu``) as ``parent``, built the same way.  A
variant that does not build is left out with nvcc's message; one that
refuses a shape is left out of it.  A cut variant computes garbage and is
timed, never checked; every other one is held against ``stage_bwd_plain``
to 1e-5 relative, bitwise on a repeat.  The shipped kernel is also timed
at other splits of M (``shipped S=<n>``; ``--splits-for``) at the 2D
n=128 shapes.

Shapes (K, R, M, tables): the 3D p=3 n=48 gradient's two stage shapes
(192, 36,864 / 66,240, 345) and its fold (192, 119,025, 345) over 3
tables; 2D n=128's stage (512, 512, 905) and its fold (512, 905, 905)
over 3 tables; ragged shapes for the checks.  Seeded random operands.
Times: the device time of a launch from a CUDA graph of bare C calls
cycling through operand copies larger than the L2 together, in
`--rounds` rounds of alternating order, beside one ``torch.matmul`` in
float32 with TF32 off (the tables concatenated along K).  Prints
ptxas's registers and spills of every kernel instance, the card's
``nvidia-smi`` name and power limit, each shape's plan and the times in
ms; writes ``chiprun_out/stage_bwd_f32_variants.json``.  Exits nonzero
without a CUDA device.  Imports neither jax nor pyiga_tpu.
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

# the g slab resident in shared memory, every table of the launch run
# over it by one block (the grid has no table axis): text replacements of
# the shipped source, each of which must match once
RESIDENT = (
    ('    const int i = (int)(b % (unsigned int)a.n);\n'
     '    b /= (unsigned int)a.n;\n', ''),
    ('    auto tbuf = [&](int s) { return smem + (s % kStages)'
     ' * TL::STAGE; };\n'
     '    auto gbuf = [&](int s) { return tbuf(s) + kSlice * PK; };\n',
     '    float* ring = smem + ns * kSlice * PR;      // the g slab first\n'
     '    auto tbuf = [&](int s) { return ring + (s % kStages) * kSlice'
     ' * PK; };\n'
     '    auto gbuf = [&](int s) { return smem + s * kSlice * PR; };\n'),
    ('    const float* T = a.t[i];\n',
     '    for (int i = 0; i < a.n; ++i) {\n    const float* T = a.t[i];\n'),
    ('        copy_g(gbuf(s), mb + s * kSlice);\n',
     '        if (i == 0) copy_g(gbuf(s), mb + s * kSlice);\n'),
    ('    float* Cs = smem;', '    float* Cs = ring;'),
    ('            dst[(long long)(kb + kq) * R + r0 + r] = v;\n'
     '        }\n        __syncthreads();\n    }\n}\n',
     '            dst[(long long)(kb + kq) * R + r0 + r] = v;\n'
     '        }\n        __syncthreads();\n    }\n    }\n}\n'),
    ('    const long long blocks = (long long)a.n\n',
     '    int maxns = 0;                  // the longest chunk, in slices\n'
     '    for (int c = 0; c < a.chunks; ++c) {\n'
     '        const int ns = (a.bounds[c + 1] - a.bounds[c] + kSlice - 1)'
     ' / kSlice;\n'
     '        maxns = ns > maxns ? ns : maxns;\n    }\n'
     '    const int smem = (maxns * kSlice * TL::PR + kStages * kSlice'
     ' * TL::PK) * (int)sizeof(float);\n'
     '    if (kStages * kSlice * TL::PK < TL::OUT || smem > 232448)\n'
     '        return (int)cudaErrorInvalidValue;  // no room for the slab\n'
     '    const long long blocks = 1LL\n'),
    ('MaxDynamicSharedMemorySize, TL::SMEM);',
     'MaxDynamicSharedMemorySize, smem);'),
    ('TL::THREADS, TL::SMEM, stream>>>', 'TL::THREADS, smem, stream>>>'),
)
# Tile128 at two blocks an SM (128 registers a thread)
T128_TWO = (('                     PYIGA_BWD32_T128_LR, 1>;',
             '                     PYIGA_BWD32_T128_LR, 2>;'),)
PATCHES = {'t128_8x8_2': T128_TWO, 't128_16x8_2': T128_TWO,
           'resident': RESIDENT}

# name -> (preprocessor flags, checked against the plain version); the
# source patched first where the name is in PATCHES
VARIANTS = {
    'shipped': ([], True),
    # Tile192's lane tile: 8 x 8 (24 x 16 lanes) and 16 x 8 (12 x 16)
    'lane8x8': (['-DPYIGA_BWD32_TKQ=2'], True),
    'lane16x8': (['-DPYIGA_BWD32_TKQ=4'], True),
    # Tile192's r width: 64 (128 threads) and 192 (384 threads)
    'br64': (['-DPYIGA_BWD32_LR=8'], True),
    'br192': (['-DPYIGA_BWD32_LR=24'], True),
    # Tile128 (K = 512): 8 x 8 at two blocks an SM (128 registers), 16 x
    # 8 (8 x 16 lanes) at two, 8 x 8 at 384 threads
    't128_8x8_2': ([], True),
    't128_16x8_2': (['-DPYIGA_BWD32_T128_TKQ=4'], True),
    't128_br192': (['-DPYIGA_BWD32_T128_LR=24'], True),
    # the ring's depth, the fragments' double buffer
    'stages2': (['-DPYIGA_BWD32_STAGES=2'], True),
    'stages4': (['-DPYIGA_BWD32_STAGES=4'], True),
    'no_dbuf': (['-DPYIGA_BWD32_DBUF=0'], True),
    # the g slab resident in shared memory, every table over it
    'resident': ([], True),
    # cuts: timed, never checked
    'no_products': (['-DPYIGA_BWD32_CUT=1'], False),
    'no_copies': (['-DPYIGA_BWD32_CUT=2'], False),
    'no_stores': (['-DPYIGA_BWD32_CUT=3'], False),
    'frag_reads': (['-DPYIGA_BWD32_CUT=4'], False),
}
SPLITS = (1, 2, 3, 4, 6, 8, 16)  # S timed beside the plan's at 2D n=128
F32_TOL = 1e-5
L2_BYTES = 50 * 2 ** 20
N_SM = 132


def ptxas_lines(log):
    """'<kernel instance>: registers, spills' from nvcc's -Xptxas=-v."""
    out, name, spill = [], None, ''
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            for k in ('stage_bwd_f32_kernel', 'chunk_sum_f32_kernel',
                      'fold_f32_kernel'):
                if k in name:
                    name = '%s<%s>' % (k, ', '.join(
                        re.findall(r'Li(\d+)E', name)))
        elif 'spill' in ln:
            spill = ln.strip()
        elif 'Used' in ln and 'registers' in ln and name:
            regs = re.search(r'Used (\d+) registers', ln)
            out.append('%s: %s registers; %s' % (
                name, regs.group(1) if regs else '?', spill))
            name = None
    return [x for x in out if 'bwd' in x or 'chunk_sum' in x
            or 'fold_f32_kernel<4, 1' in x]


def patched(src, out, name):
    """A copy of `src` under `out` with the replacements PATCHES[name],
    or None (with a message) if one does not match exactly once."""
    with open(src) as f:
        text = f.read()
    for old, new in PATCHES[name]:
        if text.count(old) != 1:
            print('%s: patch does not apply (%d matches of %r), left out'
                  % (name, text.count(old), old[:60]), flush=True)
            return None
        text = text.replace(old, new)
    path = os.path.join(out, '%s.cu' % name)
    with open(path, 'w') as f:
        f.write(text)
    return path


def build(names, parent):
    from pyiga_tpu_torch import _cuda
    out = os.path.join(REPO, 'build', 'stage_bwd_f32_variants')
    os.makedirs(out, exist_ok=True)
    src = os.path.join(REPO, 'pyiga_tpu_torch', 'csrc', 'sumfac_f32.cu')
    procs = {}
    for name in names:
        path, flags = ((parent, []) if name == 'parent'
                       else (src, VARIANTS[name][0]))
        if name in PATCHES:
            path = patched(src, out, name)
            if path is None:
                continue
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
        fn = cdll.pyiga_stage_bwd_f32
        fn.argtypes = (list(_cuda._SIGNATURES['pyiga_stage_bwd_f32'])
                       if name != 'parent' else
                       [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        if name != 'parent':
            q = cdll.pyiga_stage_bwd_f32_tiles
            q.argtypes = list(_cuda._SIGNATURES['pyiga_stage_bwd_f32_tiles'])
            q.restype = ctypes.c_int
        libs[name] = cdll
    return libs, logs


class Case:
    """One shape: its tables, `copies` gradients with an output and a
    scratch each, the plain output of the first, each library's plan (the
    shipped one's as ``plan``) and the matmul yardstick's operands."""

    def __init__(self, name, K, R, M, G, device, rng, libs, timed=True):
        from pyiga_tpu_torch.ops import cuda_sumfac as cs
        self.name, self.K, self.R, self.M, self.G = name, K, R, M, G
        self.plans = {x: cs.stage_bwd_f32_plan(
            K, R, M, G, N_SM, cs.stage_bwd_f32_tiles(lib))
            for x, lib in libs.items() if x != 'parent'}
        self.plan = self.plans.get('shipped') or next(
            iter(self.plans.values()))
        # the scratch of the largest split timed (2D n=128: SPLITS)
        nS = max(p['chunks'] for p in self.plans.values())
        if K == 512:
            nS = max(SPLITS + (nS,))
        per = 4 * (R * M + G * K * R * (1 + (nS if nS > 1 else 0)))
        copies = max(1, -(-2 * L2_BYTES // per)) if timed else 1

        def rand(*shape):
            return torch.as_tensor(rng.rand(*shape) - 0.5,
                                   dtype=torch.float32, device=device)
        self.tabs = [rand(M, K) for _ in range(G)]
        self.gs = [rand(R, M) for _ in range(copies)]
        self.outs = [torch.empty((G, K, R), dtype=torch.float32,
                                 device=device) for _ in range(copies)]
        self.scratch = [torch.empty((nS, G, K, R), dtype=torch.float32,
                                    device=device) for _ in range(copies)]
        self.tp = (ctypes.c_uint64 * G)(*[T.data_ptr() for T in self.tabs])
        self.ref = torch.stack([cs.stage_bwd_plain(T, self.gs[0])
                                for T in self.tabs])
        self.flops = 2 * K * R * M * G
        if timed:
            self.tcat = torch.cat(self.tabs, dim=1).t().contiguous()

    def bounds(self, S, plan):
        """The bounds of S chunks (`plan`'s own where S is None)."""
        if S is None:
            return plan['bounds']
        slices = -(-self.M // 16)
        return [16 * (c * slices // S) for c in range(S)] + [self.M]

    def launch(self, lib, k, parent=False, S=None, out=None, name=None):
        out = self.outs[k] if out is None else out
        stream = torch.cuda.current_stream().cuda_stream
        tp = ctypes.cast(self.tp, ctypes.c_void_p)
        if parent:
            err = lib.pyiga_stage_bwd_f32(
                tp, self.G, self.gs[k].data_ptr(), out.data_ptr(), self.K,
                self.R, self.M, stream)
        else:
            plan = self.plans[name] if name else self.plan
            b = self.bounds(S, plan)
            arr = (ctypes.c_int * len(b))(*b)
            err = lib.pyiga_stage_bwd_f32(
                tp, self.G, self.gs[k].data_ptr(), out.data_ptr(), self.K,
                self.R, self.M, plan['tile'], len(b) - 1,
                ctypes.cast(arr, ctypes.c_void_p),
                self.scratch[k].data_ptr(), stream)
        if err != 0:
            raise RuntimeError('%s: launch refused (%d)' % (self.name, err))
        return out

    def matmul(self):
        return torch.matmul(self.tcat, self.gs[0].t())


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


def runs(case, names, libs, split_names):
    """The (label, launcher) pairs timed at `case`: every variant that
    takes it, and at 2D n=128 the variants `split_names` at other
    splits."""
    out = []
    for x in names:
        parent = x == 'parent'
        try:
            case.launch(libs[x], 0, parent=parent,
                        out=torch.empty_like(case.ref), name=x)
            torch.cuda.synchronize()
        except RuntimeError as e:
            print('  %-22s %-13s left out: %s' % (case.name, x, e),
                  flush=True)
            continue
        out.append((x, lambda i, lib=libs[x], p=parent, x=x: case.launch(
            lib, i % len(case.gs), parent=p, name=x)))
    for x in split_names if case.K == 512 else ():
        for S in SPLITS:
            if x in libs and S != case.plans[x]['chunks'] \
                    and S <= -(-case.M // 16):
                out.append(('%s S=%d' % (x, S),
                            lambda i, S=S, lib=libs[x], x=x: case.launch(
                                lib, i % len(case.gs), S=S, name=x)))
    return out


def check(case, labels, libs, rec):
    """Each checked variant against the plain version, bitwise on a
    repeat."""
    scale = float(case.ref.double().abs().max())
    for name in labels:
        if name != 'parent' and not VARIANTS[name][1]:
            continue
        parent = name == 'parent'
        try:
            got = case.launch(libs[name], 0, parent=parent,
                              out=torch.empty_like(case.ref), name=name)
        except RuntimeError as e:           # a shape the variant refuses
            print('  %-22s %-13s left out: %s' % (case.name, name, e),
                  flush=True)
            continue
        again = case.launch(libs[name], 0, parent=parent,
                            out=torch.empty_like(case.ref), name=name)
        torch.cuda.synchronize()
        rel = float((got.double() - case.ref.double()).abs().max()) / scale
        same = bool(torch.equal(got, again))
        rec['%s %s' % (case.name, name)] = dict(rel=rel, repeat_bitwise=same)
        print('  %-22s %-13s rel %.3e repeat %s' % (
            case.name, name, rel, 'bitwise' if same else 'DIFFERS'),
            flush=True)
        if not (rel <= F32_TOL and same and bool(torch.isfinite(got).all())):
            raise RuntimeError('%s %s disagrees' % (case.name, name))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('names', nargs='?', default=','.join(VARIANTS))
    ap.add_argument('--parent', default=None)
    ap.add_argument('--rounds', type=int, default=3)
    ap.add_argument('--shapes', default=None,
                    help='comma-separated shape names (default: all)')
    ap.add_argument('--splits-for', default='shipped',
                    help='the variants timed at other splits at 2D n=128')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('torch_stage_bwd_f32_variants: no CUDA device',
              file=sys.stderr)
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
           'checks': {}, 'bound_ms': {}, 'plans': {}}
    rng = np.random.RandomState(24)
    for name, K, R, M, G in (('ragged fold', 33, 1001, 7, 2),
                             ('short last chunk', 64, 130, 1001, 1),
                             ('K = 1', 1, 999, 40, 1),
                             ('odd R 16 tables', 192, 4097, 345, 16)):
        case = Case(name, K, R, M, G, device, rng, libs, timed=False)
        check(case, names, libs, rec['checks'])
        del case
    shapes = (('n48 stage R=36864', 192, 36864, 345, 1),
              ('n48 stage R=66240', 192, 66240, 345, 1),
              ('n48 fold', 192, 119025, 345, 3),
              ('2D stage', 512, 512, 905, 1),
              ('2D fold', 512, 905, 905, 3))
    if args.shapes:
        keep = args.shapes.split(',')
        shapes = [s for s in shapes if s[0] in keep]
    for name, K, R, M, G in shapes:
        case = Case(name, K, R, M, G, device, rng, libs)
        timed = runs(case, names, libs, args.splits_for.split(','))
        check(case, [x for x, _f in timed if x in libs], libs,
              rec['checks'])
        torch.cuda.empty_cache()
        bound = case.flops / 67e9
        p = case.plan
        rec['bound_ms'][name] = bound
        rec['plans'][name] = {k: p[k] for k in ('bk', 'br', 'chunks',
                                                'blocks', 'waves')}
        print('%s: K %d R %d M %d, %d tables, %d operand sets; bound %.4f '
              'ms (operations); plan tile %d x %d, S %d, %d blocks, %.2f '
              'waves' % (name, K, R, M, G, len(case.gs), bound, p['bk'],
                         p['br'], p['chunks'], p['blocks'], p['waves']),
              flush=True)
        reps = 10 if R * M > 10 ** 7 else 40
        times = {x: [] for x, _f in timed}
        mm = []
        for rnd in range(args.rounds):
            order = timed if rnd % 2 == 0 else timed[::-1]
            for x, fn in order:
                times[x].append(graph_ms(fn, reps))
            mm.append(graph_ms(lambda i: case.matmul(), reps))
        rec['times'][name], rec['matmul'][name] = times, mm
        for x, _f in timed:
            print('  %-22s %-13s %s ms (%.0f %% of bound)' % (
                name, x, ' '.join('%.4f' % t for t in times[x]),
                100 * bound / min(times[x])), flush=True)
        print('  %-22s %-13s %s ms' % (name, 'matmul', ' '.join(
            '%.4f' % t for t in mm)), flush=True)
        del case, timed
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(REPO, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(REPO, 'chiprun_out',
                           'stage_bwd_f32_variants.json'), 'w') as f:
        json.dump(rec, f, indent=1)
    print('OK')
    return 0


if __name__ == '__main__':
    sys.exit(main())
