"""Compare variants of the windowed route's kernel (K8 / K8f,
``pyiga_tpu_torch/csrc/windowed.cu``) on one GPU, and time its parts in
place.

    python3 scripts/torch_windowed_variants.py [NAME,NAME,...]

Builds one library per variant of ``windowed.cu`` alone, all ``nvcc``
processes at once, under ``build/windowed_variants/``, and calls its C
entries directly.  A variant replaces text of the shipped source: the
largest shared-memory carveout asked for (``carve``), 8 r a lane
(``rpt8``: a block of 64 r) or 2 (``rpt2``: 16 r) instead of 4, the
table staged by 8-byte copies instead of 16-byte ones (``p8``), runs of
up to 32 or 48 dofs instead of 64 (``warps8``, ``warps12``; at 64 a run
covers the n=48 axis, so that one block writes each row of Y), or parts
cut out to time the rest in place: the
stores of Y (``no_store``), the products (``no_compute``), the copies of
X (``no_xstage``) or of the table (``no_pstage``), both products and
stores (``loads_only``), all but the block's frame (``skeleton``), all
(``empty``) or all after the window starts' loads (``empty_fs``).  Each library also reports the blocks an SM
of the p = 3 kernel at the 3D n=48 launch.  A cut variant computes
garbage; every other one is held against the plain version to 1e-14
relative and bitwise on a repeat.  Shapes: the 3D p=3 n=48 twisted
box's stage 1 (192, 36,864) and stage 2 (192, 68,544) and the fold of
its 6 plan terms over (192, 127,449); seeded random fields.  Times by
CUDA events in three rounds of alternating order.  Prints ptxas's
registers and spills, the card's ``nvidia-smi`` name and power limit,
and the times in ms; writes ``chiprun_out/windowed_variants.json``.
Exits nonzero without a CUDA device.  Imports neither jax nor pyiga_tpu.
"""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

COMPUTE = '        if (live) {\n            const double* xr'
STORE = '            y[i] = Ys[r * ys + o * run + i];\n'
RPT = 'constexpr int kRPT = 4;'
STAGEP = 'constexpr bool kStageP = true;'

PVEC = '    bool pvec = (wsz * B) % 2 == 0;'

CARVE = '    if (smem > 48 * 1024) {\n'
CARVE_ALL = ('    cudaFuncSetAttribute(kernel, '
             'cudaFuncAttributePreferredSharedMemoryCarveout, 100);\n'
             + CARVE)
# appended to every variant: the blocks an SM of the p = 3 kernel at the
# 3D n=48 launch (7 warps, a table and one X tile; `multi` adds a tile)
OCCUPANCY = r'''
PYIGA_EXPORT int pyiga_windowed_occupancy(int multi, int carve) {
    using namespace win;
    const int warps_total = 13, nruns = (warps_total + kMaxWarps - 1)
                                        / kMaxWarps;
    const int run = (warps_total + nruns - 1) / nruns * kDI;
    const int cap = (run - 1) * 4 + 16, ps = (16 * 7 + 3) / 4 * 4 + 2;
    const size_t smem = std::max((size_t)cap * kXS * (multi ? 2 : 1)
                                 + (size_t)run * ps,
                                 (size_t)kRT * (7 * run + 1)) * 8;
    auto kernel = windowed_kernel<7, 2>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    if (carve)
        cudaFuncSetAttribute(
            kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    int nb = -1;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kernel, 8 * run,
                                                  smem);
    return nb;
}
'''

XSTAGE = '        stage_x<VEC>(Xs, terms.x[t0], R, qa, rows, r0, nr);\n'
PLOOPS = [('e < nd * cpr;', 'e < 0;'), ('e < nd * bw;', 'e < 0;')]
NO_STORE = (STORE, '            if (Ys[r * ys + o * run + i] == 1.25e300) '
                   'y[i] = 0.0;\n')
NO_COMPUTE = (COMPUTE, COMPUTE.replace('live', 'live && R < 0'))
WARPS = 'constexpr int kMaxWarps = 16;'
ENTRY = '    extern __shared__ double smem[];\n'
FS_DONE = '    const int qrel = live ? (int)(fs[i0 + il] * nqp - qa) : 0;\n'

# name -> ([(old text, new text)], exact)
VARIANTS = {
    'shipped': ([], True),
    'warps8': ([(WARPS, WARPS.replace('16', '8'))], True),
    'warps12': ([(WARPS, WARPS.replace('16', '12'))], True),
    'rpt2': ([(RPT, RPT.replace('4', '2'))], True),
    'carve': ([(CARVE, CARVE_ALL)], True),
    'rpt8': ([(RPT, RPT.replace('4', '8'))], True),
    'p8': ([(PVEC, PVEC.replace('(wsz * B) % 2 == 0', 'false'))], True),
    'no_store': ([NO_STORE], False),
    'no_compute': ([NO_COMPUTE], False),
    'no_xstage': ([(XSTAGE, '')], False),
    'no_pstage': (PLOOPS, False),
    'loads_only': ([NO_STORE, NO_COMPUTE], False),
    'skeleton': ([NO_STORE, NO_COMPUTE, (XSTAGE, '')] + PLOOPS, False),
    'empty': ([(ENTRY, ENTRY + '    if (R > 0) return;\n')], False),
    'empty_fs': ([(FS_DONE, FS_DONE + '    if (qrel >= 0) return;\n')],
                 False),
}


def variant_source(src, edits):
    for old, new in edits:
        if old not in src:
            raise RuntimeError('variant text not found: %r' % old[:60])
        src = src.replace(old, new)
    return src


def build(names):
    from pyiga_tpu_torch import _cuda
    out = os.path.join(REPO, 'build', 'windowed_variants')
    os.makedirs(out, exist_ok=True)
    src = open(os.path.join(REPO, 'pyiga_tpu_torch', 'csrc',
                            'windowed.cu')).read()
    procs = {}
    for name in names:
        path = os.path.join(out, name + '.cu')
        with open(path, 'w') as f:
            f.write(variant_source(src, VARIANTS[name][0])
                    .replace('}  // namespace win\n}  // namespace\n',
                             '}  // namespace win\n}  // namespace\n'
                             + OCCUPANCY))
        lib = os.path.join(out, 'lib%s.so' % name)
        procs[name] = (lib, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, '-I',
             os.path.join(REPO, 'pyiga_tpu_torch', 'csrc'), '-shared', '-o',
             lib, path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs, logs = {}, {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError('nvcc failed on %s:\n%s' % (name, log))
        # ptxas -v of the b = 7 instances (p = 3)
        lines = log.splitlines()
        logs[name] = [ln.strip() for i, ln in enumerate(lines)
                      if ('registers' in ln or 'spill' in ln)
                      and any('ILi7E' in x for x in lines[max(0, i - 3):i])]
        cdll = ctypes.CDLL(lib)
        for fn in ('pyiga_windowed_stage_f64', 'pyiga_windowed_fold_f64'):
            getattr(cdll, fn).argtypes = list(_cuda._SIGNATURES[fn])
            getattr(cdll, fn).restype = ctypes.c_int
        cdll.pyiga_windowed_occupancy.argtypes = [ctypes.c_int,
                                                  ctypes.c_int]
        libs[name] = cdll
    return libs, logs


def cases(device):
    """(name, call(lib) -> Y, the plain output)."""
    from pyiga_tpu_torch import bspline, geometry
    from pyiga_tpu_torch.assemblers import StiffnessAssembler
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    from pyiga_tpu_torch.ops.sumfac import last_table_groups
    kvs = 3 * (bspline.make_knots(3, 0.0, 1.0, 48),)
    asm = StiffnessAssembler(kvs, geometry.twisted_box(), device=device)
    wtabs, fss = asm.tables.windowed_term_tables(asm.terms)
    nqp = asm.tables.nqps[0]
    fs = torch.as_tensor(fss[0], device=device)
    rng = np.random.RandomState(17)
    Q, bn = 192, 357

    def rand(*shape):
        return torch.as_tensor(rng.rand(*shape), device=device)

    def stage_call(X, P):
        def call(lib):
            Y = torch.empty((X.shape[1], bn), dtype=torch.float64,
                            device=device)
            err = lib.pyiga_windowed_stage_f64(
                X.data_ptr(), P.data_ptr(), fs.data_ptr(), Y.data_ptr(), Q,
                X.shape[1], 51, 7, 16, nqp,
                torch.cuda.current_stream().cuda_stream)
            assert err == 0, err
            return Y
        return call

    out = []
    for k, R in ((0, Q * Q), (1, Q * bn)):
        X, P = rand(Q, R), torch.as_tensor(wtabs[0][k], device=device)
        out.append(('stage %d' % (k + 1), stage_call(X, P),
                    cs.windowed_stage_plain(X, P, fs, nqp)))
    plan = asm._fold()
    idx = list(last_table_groups([wtabs[t] for t, _m in plan]))
    tabs = [None] * (max(idx) + 1)
    for (t, _m), i in zip(plan, idx):
        tabs[i] = torch.as_tensor(wtabs[t][-1], device=device)
    xs = [rand(Q, bn * bn) for _ in plan]

    def fold_call(lib):
        Y = torch.empty((bn * bn, bn), dtype=torch.float64, device=device)
        xp = (ctypes.c_uint64 * len(xs))(*[X.data_ptr() for X in xs])
        tp = (ctypes.c_uint64 * len(xs))(*[tabs[i].data_ptr() for i in idx])
        err = lib.pyiga_windowed_fold_f64(
            ctypes.cast(xp, ctypes.c_void_p), ctypes.cast(tp, ctypes.c_void_p),
            len(xs), fs.data_ptr(), Y.data_ptr(), Q, bn * bn, 51, 7, 16, nqp,
            torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return Y
    out.append(('fold', fold_call,
                cs.windowed_fold_plain(xs, tabs, idx, fs, nqp)))
    return out


def time_ms(fn, reps=20):
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main():
    if not torch.cuda.is_available():
        print('torch_windowed_variants: no CUDA device', file=sys.stderr)
        return 2
    names = sys.argv[1].split(',') if len(sys.argv) > 1 else list(VARIANTS)
    device = torch.device('cuda', 0)
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    libs, logs = build(names)
    for name in names:
        print('%-14s %s' % (name, ' | '.join(logs[name])), flush=True)
    rec = {'card': card, 'ptxas': logs, 'times': {}, 'checks': {},
           'blocks_per_sm': {}}
    for name in names:       # (one tile, two tiles) x (default, carveout)
        occ = [libs[name].pyiga_windowed_occupancy(m, c)
               for m in (0, 1) for c in (0, 1)]
        rec['blocks_per_sm'][name] = occ
        print('%-14s blocks an SM (stage, stage carved, fold, fold carved): '
              '%s' % (name, occ), flush=True)
    for cname, call, ref in cases(device):
        scale = float(ref.abs().max())
        for name in names:
            if not VARIANTS[name][1]:
                continue
            got = call(libs[name])
            torch.cuda.synchronize()
            rel = float((got - ref).abs().max()) / scale
            again = call(libs[name])
            torch.cuda.synchronize()
            ok = rel <= 1e-14 and torch.equal(got, again)
            rec['checks']['%s %s' % (cname, name)] = rel
            print('  %-8s %-14s rel %.3e repeat %s' % (
                cname, name, rel, 'bitwise' if torch.equal(got, again)
                else 'DIFFERS'), flush=True)
            if not ok:
                raise RuntimeError('%s %s disagrees' % (cname, name))
            del got, again
        times = {name: [] for name in names}
        for rnd in range(3):
            order = names if rnd % 2 == 0 else names[::-1]
            for name in order:
                times[name].append(time_ms(lambda: call(libs[name])))
        rec['times'][cname] = times
        for name in names:
            print('  %-8s %-14s %s ms' % (cname, name, ' '.join(
                '%.4f' % t for t in times[name])), flush=True)
        del ref
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(REPO, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(REPO, 'chiprun_out', 'windowed_variants.json'),
              'w') as f:
        json.dump(rec, f, indent=1)
    print('OK')
    return 0


if __name__ == '__main__':
    sys.exit(main())
