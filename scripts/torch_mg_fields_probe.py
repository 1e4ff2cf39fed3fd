"""Measure what sets the time of the port's K6 (local-MG V-cycle) and K1
(geometry fields) kernels on one GPU.

    python3 scripts/torch_mg_fields_probe.py

1. Grid and cluster barriers.  Builds a small CUDA source of its own
   (through ``_cuda.build_generated``) whose kernels do nothing but
   barriers, and times ``2000`` of them against none by CUDA events: the
   cooperative grid barrier (``cooperative_groups`` ``grid.sync()``) at
   132 blocks of 512 and 1024 threads and 264 blocks of 256, and the
   hardware cluster barrier (``cluster.sync()``) in one cluster of 16
   blocks (a non-portable size) of 512 and 1024 threads and one of 8.
   Also the event time of an empty launch, by ctypes from Python and 200
   back to back, the floor of any kernel timed through its wrapper.
2. K1's instruction mix.  Builds the port's library, dumps the SASS of
   every K1 kernel (``stiff_fields_kernel`` / ``geo_fields_kernel`` /
   ``geo_jac_fields_kernel`` instantiations, whichever the source has) with
   ``cuobjdump`` and counts per kernel its instructions, the f64 ones,
   the loads, the calls (the 64-bit integer and f64 division
   subroutines) and the 64-bit integer multiply-adds; prints ptxas's
   registers and spills for them.
3. K1's three kinds timed at the path shapes (3D p=3 n=48 twisted box
   for the stiffness and mass kinds, 2D p=3 n=128 NURBS quarter annulus
   for the ``jac`` kind), the ``jac`` kind also by its bare ctypes call
   into a preallocated output (the wrapper's share of its event time).
4. K6 on the (24, 3) and (48, 3) hierarchies through ``chip_smoke.py``'s
   own phase 4e (``check_vcycle_kernel``: ms a cycle, the kernel against
   its plain version) and phases 8 / 8b (``run_localmg``: the solve's
   wall time), so that a checkout of another commit, with this script
   copied into it, measures its own K6 the same way in the same call.

Writes everything to ``chiprun_out/mg_fields_probe.json`` and the SASS of the
3D B-spline mass kernel to ``chiprun_out/k1_mass_sass.txt``; prints the
card's ``nvidia-smi`` name and power limit.  Exits nonzero without a CUDA
device.  Imports neither jax nor pyiga_tpu.
"""

import collections
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, 'chiprun_out')

BARRIER_SRC = r'''
#include <cuda_runtime.h>
#include <cooperative_groups.h>
namespace cg = cooperative_groups;

__global__ void grid_barriers(int n) {
    cg::grid_group g = cg::this_grid();
    for (int i = 0; i < n; ++i) g.sync();
}

__global__ void cluster_barriers(int n) {
    cg::cluster_group c = cg::this_cluster();
    for (int i = 0; i < n; ++i) c.sync();
}

__global__ void empty_kernel() {}

extern "C" int probe_grid(int blocks, int threads, int n, void* stream) {
    void* args[] = {(void*)&n};
    cudaError_t e = cudaLaunchCooperativeKernel(
        (const void*)grid_barriers, dim3(blocks), dim3(threads), args, 0,
        (cudaStream_t)stream);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

extern "C" int probe_cluster(int blocks, int threads, int n, void* stream) {
    cudaError_t e = cudaFuncSetAttribute(
        cluster_barriers, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, cluster_barriers, n);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

extern "C" int probe_empty(void* stream) {
    empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}
'''


def events_ms(fn, reps):
    """Mean milliseconds of `fn()` over `reps` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def barriers():
    from pyiga_tpu_torch import _cuda
    lib = _cuda.build_generated('mg_barriers', BARRIER_SRC)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.probe_grid.argtypes = [I, I, I, P]
    lib.probe_cluster.argtypes = [I, I, I, P]
    lib.probe_empty.argtypes = [P]
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn, *args):
        err = fn(*args, stream)
        if err:
            raise RuntimeError('launch failed (%d)' % err)

    n = 2000
    out = {}
    for kind, fn, blocks, threads in (
            ('grid', lib.probe_grid, 132, 512),
            ('grid', lib.probe_grid, 132, 1024),
            ('grid', lib.probe_grid, 264, 256),
            ('cluster', lib.probe_cluster, 16, 512),
            ('cluster', lib.probe_cluster, 16, 1024),
            ('cluster', lib.probe_cluster, 8, 1024)):
        t0 = events_ms(lambda: call(fn, blocks, threads, 0), 20)
        tn = events_ms(lambda: call(fn, blocks, threads, n), 20)
        key = '%s_%dx%d' % (kind, blocks, threads)
        out[key] = dict(us_per_barrier=1e3 * (tn - t0) / n,
                        launch_ms=t0, launch_plus_barriers_ms=tn)
        print('  %-18s %.3f us a barrier (launch %.4f ms)'
              % (key, out[key]['us_per_barrier'], t0), flush=True)
    out['empty_launch_ms'] = events_ms(lambda: call(lib.probe_empty), 200)
    print('  empty launch (ctypes, back to back): %.4f ms'
          % out['empty_launch_ms'], flush=True)
    return out


K1_NAMES = ('stiff_fields_kernel', 'geo_fields_kernel',
            'geo_jac_fields_kernel')


def sass_mix(lib_path):
    """Per K1 kernel: instruction counts by class from the SASS."""
    from pyiga_tpu_torch import _cuda
    tool = os.path.join(os.path.dirname(_cuda._nvcc()), 'cuobjdump')
    sass = subprocess.run([tool, '--dump-sass', lib_path], check=True,
                          capture_output=True, text=True,
                          timeout=300).stdout
    funcs, fn = collections.OrderedDict(), None
    for line in sass.splitlines():
        if 'Function :' in line:
            fn = line.split('Function :')[1].strip()
            funcs[fn] = []
        elif fn is not None:
            m = re.match(r'\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)',
                         line)
            if m:
                funcs[fn].append((m.group(2), line.strip()))
    mix = {}
    for fn, ins in funcs.items():
        if not any(k in fn for k in K1_NAMES):
            continue
        ops = [op for op, _ in ins]
        base = [op.split('.')[0] for op in ops]
        mix[fn] = dict(
            total=len(ops), f64=sum(b in ('DFMA', 'DMUL', 'DADD', 'DSETP',
                                          'MUFU') for b in base),
            loads=sum(b in ('LDG', 'LDS', 'LD', 'LDL') for b in base),
            local=sum(b in ('LDL', 'STL') for b in base),
            calls=sum(b in ('CALL', 'BSSY') for b in base),
            imad_wide=sum(op.startswith('IMAD.WIDE') for op in ops),
            i64_div_hint=sum(b in ('I2F', 'F2I') and '64' in op
                             for op, b in zip(ops, base)))
        if 'Li3ELb0ELi1E' in fn and 'sass_mass' not in mix:
            with open(os.path.join(OUT, 'k1_mass_sass.txt'), 'w') as f:
                f.write('\n'.join(line for _, line in ins))
            mix['sass_mass'] = fn
    for fn, m in mix.items():
        if isinstance(m, dict):
            print('  %-60s %s' % (fn[:60], m), flush=True)
    return mix


def k1_times():
    import chip_smoke as cs_smoke
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    dev = torch.device('cuda', 0)
    asm = cs_smoke.main_path_setup(3, 48, dev)
    args, _ = cs._spline_stages(asm.geo_inputs())
    out = dict(
        stiffness_3d_n48=events_ms(lambda: cs.fields(*args), 50),
        mass_3d_n48=events_ms(lambda: cs.fields_mass(*args), 50))
    _, _, asm2, _ = cs_smoke.convdiff_setup(128, dev)
    ops = asm2._device_operands()
    Y, _ = cs.geo_stage12(ops['geo_tables'], ops['geo_coeffs'], 2)
    T = ops['geo_tables'][1][:2].contiguous()
    nurbs = asm2._geo_is_nurbs
    out['jac_2d_n128'] = events_ms(
        lambda: cs.geo_jac_fields(Y, T, nurbs), 200)
    # the same launch by ctypes alone, into one preallocated output: what
    # the wrapper's checks, allocation and device guard add
    from pyiga_tpu_torch import _cuda
    lib = _cuda.library()
    res = torch.empty((6,) + tuple(Y.shape[2:3]) + (T.shape[1],),
                      dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    args = (Y.data_ptr(), T.data_ptr(), res.data_ptr(), 2, 2, int(nurbs),
            Y.shape[2], T.shape[1], Y.shape[3], stream)
    out['jac_2d_n128_ctypes'] = events_ms(
        lambda: lib.pyiga_geo_jac_fields_f64(*args), 200)
    print('  K1 ms: %s' % out, flush=True)
    return out


def k6_times():
    import chip_smoke as cs_smoke
    dev = torch.device('cuda', 0)
    cases = cs_smoke.check_vcycle_kernel(dev)['vcycle']['cases']
    keys = ('ms', 'cycle_ms', 'solve_ms', 'cycles', 'plain_ms', 'bound_ms',
            'max_abs_err', 'rel')
    out = {name: {k: c.get(k) for k in keys} for name, c in cases.items()}
    for n0 in (24, 48):
        rec = cs_smoke.run_localmg(dev, n0)
        out['solve_%d_3' % n0] = {k: rec[k] for k in ('t_solve_ms', 'iters')}
    print('  K6: %s' % out, flush=True)
    return out


def main():
    if not torch.cuda.is_available():
        print('torch_mg_fields_probe: no CUDA device', file=sys.stderr)
        return 2
    from pyiga_tpu_torch import _cuda
    os.makedirs(OUT, exist_ok=True)
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    lib = str(_cuda.build())
    _cuda.library()
    rec = dict(card=card, barriers=barriers(), k1_sass=sass_mix(lib),
               k1_ms=k1_times(), k6=k6_times(),
               ptxas=_cuda.BUILD_INFO['log'])
    with open(os.path.join(OUT, 'mg_fields_probe.json'), 'w') as f:
        json.dump(rec, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
