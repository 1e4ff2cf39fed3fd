"""Compare tiles of the port's stage backward kernel (``stage_bwd_kernel``,
K2-bwd / K3-bwd) on one GPU, and time its parts in place.

    python3 scripts/torch_stage_bwd_tiles.py [NAME,NAME,...]

Builds one library per variant of ``pyiga_tpu_torch/csrc/sumfac.cu``, all
``nvcc`` processes at once, under ``build/stage_bwd_tiles/``.  A variant
replaces ``Tile192`` (the tile of K = 192), adds K2's second barrier a
slice, or cuts parts out of the shipped kernel's mainloop to time the
rest in place: the DMMA products (``no_mma``: one add a fragment instead,
so the copies, the fragment loads and the barrier remain), the copies of
the gradient's slices (``no_gcopy``), of the table's (``no_tcopy``), of
both (``no_copy``: the products on whatever the buffers hold), or all of
them (``frags_only``: the fragment loads, the barrier and the epilogue).
A cut variant computes garbage; every other one is held against
``stage_bwd_plain`` to 1e-13 relative and bitwise on a repeat.
Shapes: the 3D p=3 n=48 compact chain (K = 192, M = 345; the two stage
shapes R = 36,864 and 66,240, and the fold's 3 tables at R = 119,025) and
2D n=128's (512, 512, 905); seeded random operands.  Times
by CUDA events in three rounds of alternating order, beside one
``torch.matmul`` of the same operands (tables concatenated).  Prints
ptxas's registers and spills, the card's ``nvidia-smi`` name and power
limit, and the times in ms; writes ``chiprun_out/stage_bwd_tiles.json``.
Exits nonzero without a CUDA device.  Imports neither jax nor pyiga_tpu.
"""

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

MMA = 'dmma::mma_16x8x4(acc[u][j], a[u][0], a[u][1], bf[j]);'
NO_MMA = [(MMA, 'acc[u][j][0] += a[u][0] + a[u][1] + bf[j];')]
GCOPY = ('        dmma::load_tile<TL::BN, kBK, VB, TL::THREADS>(\n'
         '            Bs, TL::PB, gr + m0, M, R - r0, M - m0);\n')
TCOPY = ('        dmma::load_tile<kBK, TL::BM, VA, TL::THREADS>(\n'
         '            As, TL::PA, T + (long long)m0 * K, K, M - m0, K - k0);\n')
LOOP_END = '        compute(st % TL::STAGES);\n    }\n'

# name -> (Tile192's replacement or None, [(old text, new text)], exact);
# the tiles are Tile<BM, BN, WM, WN, STAGES, MINB, THREADS>
VARIANTS = {
    'shipped': (None, [], True),
    # 256 threads, 48 x 32 warp tiles at one block an SM; then two blocks
    # (128 registers), four stages, 96 x 16 warp tiles
    'k192x64': ('Tile<192, 64, 48, 32, 3, 1>', [], True),
    'k192x64_2': ('Tile<192, 64, 48, 32, 3, 2>', [], True),
    'k192x64_4st': ('Tile<192, 64, 48, 32, 4, 1>', [], True),
    'k192x64_96x16': ('Tile<192, 64, 96, 16, 3, 1>', [], True),
    # k tiles below K = 192: more blocks, more reads of g
    'k96x96': ('Tile<96, 96, 48, 24, 3, 2>', [], True),
    'k96x128': ('Tile<96, 128, 48, 32, 3, 1>', [], True),
    'k64x128': ('Tile<64, 128, 32, 32, 3, 2>', [], True),
    'k64x128_64x16': ('Tile<64, 128, 64, 16, 3, 2>', [], True),
    # 12 and 16 warps
    'k192x64_384': ('Tile<192, 64, 32, 32, 3, 1, 384>', [], True),
    'k192x96_4st': ('Tile<192, 96, 48, 32, 4, 1, 384>', [], True),
    'k192x128_512': ('Tile<192, 128, 48, 32, 3, 1, 512>', [], True),
    # a second barrier a slice, after the products (K2's mainloop)
    'two_barriers': (None, [(LOOP_END, '        compute(st % TL::STAGES);\n'
                                        '        __syncthreads();\n    }\n')],
                     True),
    # parts cut out of the shipped kernel
    'no_mma': (None, NO_MMA, False),
    'no_gcopy': (None, [(GCOPY, '')], False),
    'no_tcopy': (None, [(TCOPY, '')], False),
    'no_copy': (None, [(GCOPY, ''), (TCOPY, '')], False),
    'frags_only': (None, [(GCOPY, ''), (TCOPY, '')] + NO_MMA, False),
}
# a stage_bwd_kernel instance in ptxas's output: its tile and copy widths
INSTANCE = re.compile(r'stage_bwd_kernel\w*?TileILi(\d+)ELi(\d+)ELi(\d+)ELi'
                      r'(\d+)ELi(\d+)ELi(\d+)ELi(\d+)EEELi(\d)ELi(\d)E')


def build(names):
    """One library per variant, all nvcc processes started together."""
    from pyiga_tpu_torch import _cuda
    src_dir = os.path.join(REPO, 'pyiga_tpu_torch', 'csrc')
    src = open(os.path.join(src_dir, 'sumfac.cu')).read()
    procs, info = {}, {}
    for name in names:
        tile, subs, _exact = VARIANTS[name]
        s = src
        if tile:
            s = re.sub(r'using Tile192 = Tile<[^;]*>;',
                       'using Tile192 = %s;' % tile, s)
        for old, new in subs:
            if old not in s:
                raise RuntimeError('%s: text to replace not found' % name)
            s = s.replace(old, new)
        d = os.path.join(REPO, 'build', 'stage_bwd_tiles', name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, 'sumfac.cu'), 'w') as f:
            f.write(s)
        for h in ('common.cuh', 'dmma.cuh'):
            with open(os.path.join(src_dir, h)) as fi, \
                    open(os.path.join(d, h), 'w') as fo:
                fo.write(fi.read())
        procs[name] = subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, '-shared', '-o',
             os.path.join(d, 'lib.so'), os.path.join(d, 'sumfac.cu')],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError('nvcc failed on %s:\n%s' % (name, log))
        lines = log.splitlines()
        info[name] = []
        for i, line in enumerate(lines):
            m = INSTANCE.search(line)
            if m and 'Compiling entry' in line:
                spill = next(x for x in lines[i:] if 'spill' in x)
                regs = next(x for x in lines[i:] if 'registers' in x)
                info[name].append('Tile<%s> VA=%s VB=%s: %s | %s' % (
                    ', '.join(m.groups()[:7]), m.group(8), m.group(9),
                    spill.strip(), regs.split(':', 1)[1].strip()))
                print('  %-14s %s' % (name, info[name][-1]))
        lib = ctypes.CDLL(os.path.join(REPO, 'build', 'stage_bwd_tiles',
                                       name, 'lib.so'))
        fn = lib.pyiga_stage_bwd_f64
        fn.argtypes = list(_cuda._SIGNATURES['pyiga_stage_bwd_f64'])
        fn.restype = ctypes.c_int
        libs[name] = lib
    return libs, info


def main():
    if not torch.cuda.is_available():
        print('torch_stage_bwd_tiles: no CUDA device available',
              file=sys.stderr)
        return 2
    import chip_smoke
    from pyiga_tpu_torch.ops import cuda_sumfac as cs

    names = sys.argv[1].split(',') if len(sys.argv) > 1 else list(VARIANTS)
    card = chip_smoke.nvidia_smi()
    print(card)
    libs, info = build(names)
    dev = torch.device('cuda', 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(0)

    def rand(*shape):
        return torch.as_tensor(rng.rand(*shape) - 0.5, dtype=torch.float64,
                               device=dev)
    K, M = 192, 345
    stage_tabs = [rand(M, K)]
    fold_tabs = [rand(M, K) for _ in range(3)]
    cases = {'K2-bwd R=36864': (stage_tabs, rand(K * K, M)),
             'K2-bwd R=66240': (stage_tabs, rand(K * M, M)),
             'K3-bwd 3 tables R=119025': (fold_tabs, rand(M * M, M)),
             'K2-bwd 2D n=128': ([rand(905, 512)], rand(512, 905))}
    stream = torch.cuda.current_stream().cuda_stream

    def run(lib, tabs, g):
        R, Mg = g.shape
        Kt = tabs[0].shape[1]
        out = torch.empty((len(tabs), Kt, R), dtype=torch.float64,
                          device=dev)
        tp = (ctypes.c_uint64 * len(tabs))(*[t.data_ptr() for t in tabs])
        err = lib.pyiga_stage_bwd_f64(ctypes.cast(tp, ctypes.c_void_p),
                                      len(tabs), g.data_ptr(),
                                      out.data_ptr(), Kt, R, Mg, stream)
        if err:
            raise RuntimeError('launch failed (%d)' % err)
        return out

    rec = dict(card=card, ptxas=info, rel={}, ms={}, matmul={}, bound={})
    for name, lib in libs.items():
        errs = []
        for tabs, g in cases.values():
            got = run(lib, tabs, g)
            ref = torch.stack([cs.stage_bwd_plain(t, g) for t in tabs])
            errs.append(float((got - ref).abs().max() / ref.abs().max()))
            if VARIANTS[name][2] and not torch.equal(run(lib, tabs, g), got):
                raise RuntimeError('%s: two launches differ' % name)
        rec['rel'][name] = max(errs)
        print('  %-14s max rel err %.2e%s' % (
            name, max(errs), '' if VARIANTS[name][2] else ' (cut variant)'))
        if VARIANTS[name][2] and not max(errs) <= 1e-13:
            raise RuntimeError('%s disagrees with the plain version' % name)

    for case, (tabs, g) in cases.items():
        R, Mg = g.shape
        Kt = tabs[0].shape[1]
        tcat = torch.cat(tabs, dim=1).t().contiguous()
        rec['matmul'][case] = chip_smoke.time_ms(
            lambda: torch.matmul(tcat, g.t()), dev)
        rec['bound'][case] = chip_smoke.bound(
            8 * (g.numel() + sum(t.numel() for t in tabs)
                 + len(tabs) * Kt * R),
            2 * Kt * R * Mg * len(tabs), chip_smoke.F64_TENSOR_PER_MS)
        rec['ms'][case] = {n: [] for n in libs}
    for rnd in range(3):
        order = list(libs) if rnd % 2 == 0 else list(libs)[::-1]
        for name in order:
            for case, (tabs, g) in cases.items():
                rec['ms'][case][name].append(chip_smoke.time_ms(
                    lambda: run(libs[name], tabs, g), dev, reps=10))
    for case in cases:
        b = rec['bound'][case]
        print('  %s: matmul %.4f ms, bound %.4f ms (%s)'
              % (case, rec['matmul'][case], b['bound_ms'], b['bound_by']))
        for name in libs:
            t = rec['ms'][case][name]
            print('    %-14s %s   (%.0f %% of bound)'
                  % (name, ' '.join('%.4f' % x for x in t),
                     100 * b['bound_ms'] / min(t)))
    out = os.path.join(REPO, 'chiprun_out')
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, 'stage_bwd_tiles.json'), 'w') as f:
        json.dump(rec, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
