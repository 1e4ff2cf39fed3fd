"""Build and measure the port's wavefront Gauss-Seidel kernels and the
paths that run them on one GPU, without the rest of ``chip_smoke.py``.

    python3 scripts/torch_wavefront_probe.py [--aca]

1. Builds the port's kernel library and prints what ptxas reports for
   ``wavefront_gs_kernel`` and ``vcycle_kernel`` (registers, spills).
2. ``chip_smoke.py`` phase 4j (``check_wavefront_kernels``): both
   wavefront kernels against their plain versions at (24, 3) and (96, 3),
   with ms a pass and a cycle.
3. Phase 8c (``run_localmg(device, 96)``: the (96, 3) hierarchy through
   ``solve_hmultigrid``'s defaults) and phase 8d
   (``local_mg_step(relax_backend='device')`` at (24, 3)).
4. With ``--aca``, phase 13 (``run_aca``: ``aca_3d_device`` at 3D p=3
   n=48) and 13b (``mass_fast`` / ``stiffness_fast`` against the
   fixtures).
5. With ``--micro``, what a wavefront level costs, part by part: a
   source of its own (built through ``_cuda.build_generated``) whose one
   block of 512 threads runs 20,000 model levels (25 rows of 96 entries,
   the (96, 3) hierarchy's largest; 4 rows of 64, about (24, 3)'s mean;
   one row of 64; a warp per row, two rows a warp, the local x of 9,828
   entries in shared memory), each variant adding parts to a bare
   ``__syncthreads()`` loop: the ``cp.async`` copy of a level's operands
   two levels ahead (``+copy``), the rows' dependent shared loads and
   FMAs (``rows``), the butterfly, the f64 division; ns a level by CUDA
   events, and cycles a level and the SM clock from ``clock64`` against
   ``%globaltimer`` inside the kernel.  The ``--micro`` run skips 2-4.

Writes the records to ``chiprun_out/wavefront_probe.json``; prints the
card's ``nvidia-smi`` name and power limit.  Exits nonzero without a CUDA
device.  Imports neither jax nor pyiga_tpu.
"""

import ctypes
import json
import os
import sys
import time

import torch

# model wavefront levels (see the module docstring, step 5): PARTS is a
# bit set of the parts a variant runs besides the barrier
MICRO_SRC = r'''
#include <cuda_runtime.h>
enum { COPY = 1, ROWS = 2, SHFL = 4, DIV = 8 };
constexpr int kNloc = 9828, kE = 25 * 96;

__device__ __forceinline__ void copy16(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;" ::"r"(d),
                 "l"(src) : "memory");
}

template <int PARTS>
__global__ void __launch_bounds__(512, 1)
levels(int n, int kRows, int kW, const double* gval, const int* gcol,
       double* out, long long* clk) {
    extern __shared__ double smem[];
    double* xs = smem;                                  // kNloc
    double* sv = xs + kNloc;                            // 3 slots x kE
    int* sc = reinterpret_cast<int*>(sv + 3 * kE);      // 3 slots x kE
    for (int j = threadIdx.x; j < kNloc; j += blockDim.x)
        xs[j] = 1.0 + 1e-3 * j;
    for (int j = threadIdx.x; j < 3 * kE; j += blockDim.x) {
        sv[j] = gval[j % kE];
        sc[j] = gcol[j % kE];
    }
    __syncthreads();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    double keep = 0.0;
    long long c0 = clock64(), t0;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
    for (int l = 0; l < n; ++l) {
        if (PARTS & COPY) {
            asm volatile("cp.async.wait_group 1;" ::: "memory");
        }
        __syncthreads();
        if (PARTS & COPY) {
            const int s = (l + 2) % 3;
            const long long g = (long long)(l % 64) * kE;
            for (int i = threadIdx.x * 2; i < kRows * kW; i += blockDim.x * 2)
                copy16(sv + s * kE + i, gval + g + i);
            for (int i = threadIdx.x * 4; i < kRows * kW; i += blockDim.x * 4)
                copy16(sc + s * kE + i, gcol + g + i);
            asm volatile("cp.async.commit_group;" ::: "memory");
        }
        if (PARTS & ROWS) {
            const double* v = sv + (l % 3) * kE;
            const int* c = sc + (l % 3) * kE;
            for (int p0 = warp; p0 < kRows; p0 += 32) {
                const int p1 = p0 + 16;
                const bool two = p1 < kRows;
                double a0 = 0.0, a1 = 0.0;
                for (int k = lane; k < kW; k += 32) {
                    a0 = fma(v[p0 * kW + k], xs[c[p0 * kW + k]], a0);
                    if (two) a1 = fma(v[p1 * kW + k], xs[c[p1 * kW + k]], a1);
                }
                if (PARTS & SHFL) {
#pragma unroll
                    for (int o = 16; o > 0; o >>= 1) {
                        a0 += __shfl_xor_sync(0xffffffffu, a0, o);
                        a1 += __shfl_xor_sync(0xffffffffu, a1, o);
                    }
                }
                const double d0 = 4.0 + 1e-3 * p0, d1 = 4.0 + 1e-3 * p1;
                double v0, v1;
                if (PARTS & DIV) {
                    v0 = (1.0 - a0) / d0;
                    v1 = (1.0 - a1) / d1;
                } else {
                    v0 = (1.0 - a0) * d0;
                    v1 = (1.0 - a1) * d1;
                }
                if (lane == 0) {
                    xs[(p0 * 389 + l) % kNloc] = 1e-3 * v0;
                    if (two) xs[(p1 * 389 + l) % kNloc] = 1e-3 * v1;
                }
            }
        }
        keep += xs[threadIdx.x];
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    out[threadIdx.x] = keep;
    long long c1 = clock64(), t1;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
    if (threadIdx.x == 0) {
        clk[0] = c1 - c0;
        clk[1] = t1 - t0;
    }
}

static const int kSmem = 8 * (kNloc + 3 * kE) + 4 * 3 * kE;

template <int PARTS>
static int run(int n, int rows, int w, const double* v, const int* c,
               double* out, long long* clk, void* stream) {
    cudaError_t e = cudaFuncSetAttribute(
        levels<PARTS>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return (int)e;
    levels<PARTS><<<1, 512, kSmem, (cudaStream_t)stream>>>(n, rows, w, v, c,
                                                           out, clk);
    return (int)cudaGetLastError();
}

extern "C" int micro_levels(int parts, int n, int rows, int w,
                            const double* v, const int* c, double* out,
                            long long* clk, void* stream) {
    switch (parts) {
#define CASE(P) case P: return run<P>(n, rows, w, v, c, out, clk, stream);
    CASE(0) CASE(COPY) CASE(COPY | ROWS) CASE(COPY | ROWS | SHFL)
    CASE(COPY | ROWS | SHFL | DIV) CASE(ROWS | SHFL | DIV) CASE(ROWS)
    CASE(ROWS | SHFL) CASE(ROWS | DIV)
#undef CASE
    }
    return -1;
}
'''
MICRO_VARIANTS = (('barrier', 0), ('+copy', 1), ('+rows', 3),
                  ('+butterfly', 7), ('+division (a level)', 15),
                  ('rows, butterfly, division, no copy', 14),
                  ('rows alone', 2), ('rows, butterfly', 6),
                  ('rows, division', 10))
# (rows, width) of a model level: (96, 3)'s largest, (24, 3)'s mean
MICRO_SHAPES = ((25, 96), (4, 64), (1, 64))


def micro(device, n=20000):
    """Step 5: ns a model level for each variant (see the docstring)."""
    import chip_smoke as cs
    from pyiga_tpu_torch import _cuda
    lib = _cuda.build_generated('wavefront_micro', MICRO_SRC)
    lib.micro_levels.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5
    gen = torch.Generator().manual_seed(0)
    kE = 25 * 96
    vals = torch.rand(64 * kE, generator=gen, dtype=torch.float64).to(device)
    cols = torch.randint(0, 9828, (64 * kE,), generator=gen,
                         dtype=torch.int32).to(device)
    out = torch.empty(512, dtype=torch.float64, device=device)
    clk = torch.zeros(2, dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    res = {}
    for rows, width in MICRO_SHAPES:
        for name, parts in MICRO_VARIANTS:
            def launch():
                err = lib.micro_levels(parts, n, rows, width, vals.data_ptr(),
                                       cols.data_ptr(), out.data_ptr(),
                                       clk.data_ptr(), stream)
                if err != 0:
                    raise RuntimeError('micro %s failed (%d)' % (name, err))
            ns = 1e6 * cs.time_ms(launch, device, reps=5, warmup=1) / n
            cycles, t_ns = clk.tolist()
            key = '%d rows x %d: %s' % (rows, width, name)
            res[key] = dict(ns=ns, clock_mhz=1e3 * cycles / t_ns,
                            cycles=cycles / n)
            cs.log('  %-52s %8.1f ns  %7.0f cycles a level  (SM clock %.0f '
                   'MHz)' % (key, ns, cycles / n, 1e3 * cycles / t_ns))
    return res

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    if not torch.cuda.is_available():
        print('torch_wavefront_probe: no CUDA device', file=sys.stderr)
        return 2
    import chip_smoke as cs
    from pyiga_tpu_torch import _cuda
    device = torch.device('cuda', 0)
    card = cs.nvidia_smi()
    t0 = time.perf_counter()
    _cuda.library()
    cs.log('build %.1f s -> %s' % (time.perf_counter() - t0,
                                   _cuda.BUILD_INFO['path']))
    lines = _cuda.BUILD_INFO['log'].splitlines()
    for i, line in enumerate(lines):
        if 'wavefront_gs_kernel' in line or 'vcycle_kernel' in line:
            for ln in lines[i:i + 4]:
                if 'Function properties' in ln or 'registers' in ln \
                        or 'spill' in ln or 'Compiling' in ln:
                    cs.log('  ' + ln.strip())
    rec = dict(card=card)
    if '--micro' in sys.argv[1:]:
        cs.log('model wavefront levels (1 block of 512 threads, (96, 3) '
               'shapes)')
        rec['micro_ns_per_level'] = micro(device)
        return finish(rec, card)
    cs.log('phase 4j')
    rec['kernels'] = cs.check_wavefront_kernels(device)
    torch.cuda.empty_cache()
    cs.log('phase 8c')
    rec['localmg_96_3'] = cs.run_localmg(device, 96)
    torch.cuda.empty_cache()
    cs.log('phase 8d')
    rec['localmg_step_device'] = cs.run_localmg_step_device(device)
    if '--aca' in sys.argv[1:]:
        torch.cuda.empty_cache()
        cs.log('phase 13')
        rec['aca3d'] = cs.run_aca(device)
        torch.cuda.empty_cache()
        cs.log('phase 13b')
        rec['fast_fixtures'] = cs.check_fast_fixtures(device)
    return finish(rec, card)


def finish(rec, card):
    os.makedirs(os.path.join(REPO, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(REPO, 'chiprun_out', 'wavefront_probe.json'),
              'w') as f:
        json.dump(rec, f, indent=1, default=str)
    print(card)
    return 0


if __name__ == '__main__':
    sys.exit(main())
