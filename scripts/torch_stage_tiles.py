"""Compare tile shapes of the port's tensor-core stage kernels on one GPU.

    python3 scripts/torch_stage_tiles.py [NAME,NAME,...]

Builds one library per variant of ``pyiga_tpu_torch/csrc/sumfac.cu``, its
``TileMR`` (K2 and K7a) and ``TileFold`` (K3) tile types replaced, all
``nvcc`` processes at once, under ``build/stage_tiles/``.  Holds each
variant's K2, K7a and K3 against their plain PyTorch versions at the 3D
p=3 n=48 shapes (K = 192, M = 357; K2 at R = 36,864 and 68,544, K7a at
36,864, K3 over 6 terms of R = 127,449 on 3 tables; seeded random
operands) to 1e-13 relative, then times them by CUDA events in three
rounds of alternating order, beside one ``torch.matmul`` of the same
operands.  Prints ptxas's registers and spills per kernel, the card's
``nvidia-smi`` name and power limit, and the times in ms.  Exits nonzero
without a CUDA device.  Imports neither jax nor pyiga_tpu.
"""

import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# name -> (TileMR, TileFold); None keeps the source's own
VARIANTS = {
    'shipped': (None, None),
    # K7a's tile before: 32 x 32 warp tiles
    'mr_32x32': ('Tile<64, 128, 32, 32, 3, 2>', None),
    # K3's first tensor-core tile: 32 x 32 warp tiles at two blocks an SM
    # (the summed fragments spill), then at one
    'fold_128x64_2': (None, 'Tile<128, 64, 32, 32, 3, 2>'),
    'fold_128x64_1': (None, 'Tile<128, 64, 32, 32, 4, 1>'),
    # the shipped K3 tile with a 3-stage pipeline
    'fold_192x64_3': (None, 'Tile<192, 64, 96, 16, 3, 1>'),
}


def build(names):
    """One library per variant, all nvcc processes started together."""
    from pyiga_tpu_torch import _cuda
    src_dir = os.path.join(REPO, 'pyiga_tpu_torch', 'csrc')
    src = open(os.path.join(src_dir, 'sumfac.cu')).read()
    procs = {}
    for name in names:
        mr, fold = VARIANTS[name]
        d = os.path.join(REPO, 'build', 'stage_tiles', name)
        os.makedirs(d, exist_ok=True)
        s = src
        if mr:
            s = re.sub(r'using TileMR = Tile<[^;]*>;', 'using TileMR = %s;' % mr,
                       s)
        if fold:
            s = re.sub(r'using TileFold = Tile<[^;]*>;',
                       'using TileFold = %s;' % fold, s)
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
        for i, line in enumerate(lines):
            m = re.search(r'(stage_kernel|fold_kernel|stage_T_kernel)'
                          r'ILi(\d)ELi(\d)E', line)
            if m and 'Compiling entry' in line:
                spill = next(x for x in lines[i:] if 'spill' in x)
                regs = next(x for x in lines[i:] if 'registers' in x)
                print('  %-14s %-15s <%s, %s>  %s | %s'
                      % (name, m.group(1), m.group(2), m.group(3),
                         spill.strip(), regs.split(':', 1)[1].strip()))
        lib = ctypes.CDLL(os.path.join(REPO, 'build', 'stage_tiles', name,
                                       'lib.so'))
        for fn in ('pyiga_stage_f64', 'pyiga_fold_f64', 'pyiga_stage_T_f64'):
            getattr(lib, fn).argtypes = list(_cuda._SIGNATURES[fn])
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main():
    if not torch.cuda.is_available():
        print('torch_stage_tiles: no CUDA device available', file=sys.stderr)
        return 2
    import chip_smoke
    from pyiga_tpu_torch.ops import cuda_sumfac as cs

    names = sys.argv[1].split(',') if len(sys.argv) > 1 else list(VARIANTS)
    print(chip_smoke.nvidia_smi())
    libs = build(names)
    dev = torch.device('cuda', 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(0)

    def rand(*shape):
        return torch.as_tensor(rng.rand(*shape), dtype=torch.float64,
                               device=dev)
    K, M = 192, 357
    T = rand(M, K)
    Xs = [rand(K, R) for R in (K * K, K * M)]
    idx = [0, 0, 1, 0, 1, 2]
    tabs = [rand(M, K) for _ in range(3)]
    xs = [rand(K, M * M) for _ in idx]
    stream = torch.cuda.current_stream().cuda_stream
    xp = (ctypes.c_uint64 * len(xs))(*[x.data_ptr() for x in xs])
    tp = (ctypes.c_uint64 * len(xs))(*[tabs[i].data_ptr() for i in idx])

    def call(err):
        if err:
            raise RuntimeError('launch failed (%d)' % err)

    def stage(lib, X):
        out = torch.empty((X.shape[1], M), dtype=torch.float64, device=dev)
        call(lib.pyiga_stage_f64(X.data_ptr(), T.data_ptr(), out.data_ptr(),
                                 K, X.shape[1], M, stream))
        return out

    def stage_T(lib, X):
        out = torch.empty((M, X.shape[1]), dtype=torch.float64, device=dev)
        call(lib.pyiga_stage_T_f64(X.data_ptr(), T.data_ptr(),
                                   out.data_ptr(), K, X.shape[1], M, stream))
        return out

    def fold(lib):
        out = torch.empty((M * M, M), dtype=torch.float64, device=dev)
        call(lib.pyiga_fold_f64(ctypes.cast(xp, ctypes.c_void_p),
                                ctypes.cast(tp, ctypes.c_void_p), len(xs),
                                out.data_ptr(), K, M * M, M, stream))
        return out

    ref_fold = cs.fold_plain(xs, tabs, idx)
    ref_stage = [cs.stage_plain(X, T) for X in Xs]
    for name, lib in libs.items():
        errs = [float((fold(lib) - ref_fold).abs().max()
                      / ref_fold.abs().max())]
        for X, ref in zip(Xs, ref_stage):
            errs.append(float((stage(lib, X) - ref).abs().max()
                              / ref.abs().max()))
            errs.append(float((stage_T(lib, X) - ref.t()).abs().max()
                              / ref.abs().max()))
        print('  %-14s max rel err %.2e' % (name, max(errs)))
        if not max(errs) <= 1e-13:
            raise RuntimeError('%s disagrees with the plain versions' % name)

    times = {n: {'stage': [], 'stage_T': [], 'fold': []} for n in libs}
    for rnd in range(3):
        order = list(libs) if rnd % 2 == 0 else list(libs)[::-1]
        for name in order:
            lib = libs[name]
            times[name]['stage'].append(sum(chip_smoke.time_ms(
                lambda: stage(lib, X), dev) for X in Xs))
            times[name]['stage_T'].append(chip_smoke.time_ms(
                lambda: stage_T(lib, Xs[0]), dev))
            times[name]['fold'].append(chip_smoke.time_ms(
                lambda: fold(lib), dev, reps=5))
    xcat = torch.cat(xs).t()
    tcat = torch.cat([tabs[i] for i in idx], dim=1).t()
    print('  torch.matmul: K2 %.4f  K7a %.4f  K3 %.4f (K concatenated)'
          % (sum(chip_smoke.time_ms(lambda: torch.matmul(X.t(), T.t()), dev)
                 for X in Xs),
             chip_smoke.time_ms(lambda: torch.matmul(T, Xs[0]), dev),
             chip_smoke.time_ms(lambda: torch.matmul(xcat, tcat), dev,
                                reps=5)))
    for name in libs:
        print('  %-14s %s' % (name, '  '.join(
            '%s %s' % (k, ' '.join('%.4f' % t for t in v))
            for k, v in times[name].items())))
    return 0


if __name__ == '__main__':
    sys.exit(main())
