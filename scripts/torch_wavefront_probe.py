"""Build and measure the port's wavefront Gauss-Seidel kernels and the
paths that run them on one GPU, without the rest of ``chip_smoke.py``.

    python3 scripts/torch_wavefront_probe.py [--aca] [--sass]
    python3 scripts/torch_wavefront_probe.py --micro
    python3 scripts/torch_wavefront_probe.py --variants [NAME ...]

1. Builds the port's kernel library and prints what ptxas reports for
   ``wavefront_gs_kernel`` and ``vcycle_kernel`` (registers, spills; the
   whole log goes to ``chiprun_out/ptxas.log``).
2. ``chip_smoke.py`` phase 4j (``check_wavefront_kernels``): both
   wavefront kernels against their plain versions at (24, 3) and (96, 3),
   with ms a pass and a cycle, the reciprocal quotient against the
   division and the ``torch.triangular_solve`` yardstick.
3. Phase 8c (``run_localmg(device, 96)``: the (96, 3) hierarchy through
   ``solve_hmultigrid``'s defaults) and phase 8d
   (``local_mg_step(relax_backend='device')`` at (24, 3)).
4. With ``--aca``, phase 13 (``run_aca``: ``aca_3d_device`` at 3D p=3
   n=48) and 13b (``mass_fast`` / ``stiffness_fast`` against the
   fixtures).  With ``--sass``, the SASS of ``wavefront_gs_kernel`` to
   ``chiprun_out/``.
5. With ``--micro`` (instead of 2-4), what a wavefront level costs, part
   by part, in cycles of the SM clock:
   * the earlier design's level as a model (``MICRO_SRC``: a warp a row
     over all its entries; one block of 512 threads runs 20,000 model
     levels; shapes of
     (96, 3) and (24, 3); each variant adds parts to a bare
     ``__syncthreads()`` loop: ``cp.async`` copies two levels ahead, the
     rows' dependent shared loads and FMAs, the butterfly, the division);
   * one warp's dependent-chain latencies (``LATENCY_SRC``: ld.shared, a
     generic load, DFMA, DADD, an f64 shuffle, an L2 load) and a model of
     the new chain warp's level alone and beside spinning warps
     (``CHAIN_MODEL_SRC``);
   * the new level in place: ``csrc/mg.cu`` built with
     ``PYIGA_WF_TRACE`` (``traced_build``), one ``wavefront_gs`` pass at
     (24, 3) and (96, 3) with ``WavefrontSweeps.set_trace``, the median
     cycles of each part of the chain warp's and the producers' level
     and of the hand-offs between them (``TRACE_PARTS``).
6. With ``--variants``, the ``VARIANTS`` of ``csrc/mg.cu`` (text edits:
   a fresh depth of 3, three producer groups, sleeping waits, and
   diagnostics without the stale sums), each built and traced as in 5.

Writes the records to ``chiprun_out/wavefront_probe[_micro|_variants|
_aca].json``; prints the card's ``nvidia-smi`` name and power limit.
Exits nonzero without a CUDA device.  Imports neither jax nor pyiga_tpu.
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
# dependent-chain latencies of one warp (clock64 around 256 steps each)
LATENCY_SRC = r'''
#include <cuda_runtime.h>
__global__ void lat(const double* g, long long* out, int n) {
    extern __shared__ double sm[];
    for (int i = threadIdx.x; i < 4096; i += blockDim.x)
        sm[i] = (double)((i * 37 + 11) % 4096);
    __syncthreads();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    double v = lane, acc = 1.0;
    long long t0, t1;
    // 0: ld.shared (LDS) chain
    t0 = clock64();
    for (int i = 0; i < n; ++i) v = sm[((int)v + lane) & 4095];
    t1 = clock64(); if (lane == 0) out[0] = t1 - t0;
    // 1: generic loads of shared memory
    const double* gp = sm;
    asm volatile("" : "+l"(gp));
    t0 = clock64();
    for (int i = 0; i < n; ++i) v = gp[((int)v + lane) & 4095];
    t1 = clock64(); if (lane == 0) out[1] = t1 - t0;
    // 2: DFMA chain
    t0 = clock64();
    for (int i = 0; i < n; ++i) acc = fma(acc, 1.0000001, 1e-9);
    t1 = clock64(); if (lane == 0) out[2] = t1 - t0;
    // 3: SHFL of a double
    double w = v + acc;
    t0 = clock64();
    for (int i = 0; i < n; ++i) w = __shfl_sync(0xffffffffu, w, (lane + 1) & 31);
    t1 = clock64(); if (lane == 0) out[3] = t1 - t0;
    // 4: global load (L2) chain
    t0 = clock64();
    for (int i = 0; i < n; ++i) v = __ldcg(g + (((int)v + lane) & 4095));
    t1 = clock64(); if (lane == 0) out[4] = t1 - t0;
    // 5: DADD chain
    t0 = clock64();
    for (int i = 0; i < n; ++i) acc = acc + 1e-9;
    t1 = clock64(); if (lane == 0) out[5] = t1 - t0;
    if (lane == 0) out[6] = (long long)(v + acc + w);
}
extern "C" int latency(const double* g, long long* out, int n, void* s) {
    lat<<<1, 128, 4096 * 8, (cudaStream_t)s>>>(g, out, n);
    return (int)cudaGetLastError();
}
'''
# the chain warp's level alone: F fresh values by shuffles from the last
# two levels' registers, the FMA chain, the quotient, a store and
# __syncwarp; with `spin` other warps spinning on an mbarrier that never
# completes (try_wait), or sleeping between tries
CHAIN_MODEL_SRC = r'''
#include <cuda_runtime.h>
__device__ __forceinline__ unsigned su(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}
__global__ void chain_model(int n, int spin, long long* out) {
    __shared__ double xs[1024];
    __shared__ unsigned long long bar;
    __shared__ volatile int stop;
    if (threadIdx.x == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(su(&bar)));
        stop = 0;
    }
    for (int i = threadIdx.x; i < 1024; i += blockDim.x) xs[i] = 1.0 + i;
    __syncthreads();
    const int lane = threadIdx.x & 31;
    if (threadIdx.x >= 32) {
        while (!stop) {
            unsigned ok;
            asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\nselp.u32 %0, 1, 0, p;\n}" : "=r"(ok) : "r"(su(&bar)) : "memory");
            if (spin == 2) __nanosleep(200);
        }
        return;
    }
    double xh0 = lane, xh1 = 2.0 * lane, fv[4], part = 0.5;
    int fs[4];
    for (int i = 0; i < 4; ++i) {
        fv[i] = 1e-3 * (i + 1);
        fs[i] = ~(32 * (i & 1) + ((lane + 3 * i + 1) & 31));
    }
    const double b = 1.0, d = 4.0, r = 0.25;
    long long t0 = clock64();
    for (int l = 0; l < n; ++l) {
        double xv[4];
        for (int i = 0; i < 4; ++i) {
            const int q = ~fs[i] & 31, a = ~fs[i] >> 5;
            const double t0_ = __shfl_sync(0xffffffffu, xh0, q);
            const double t1_ = __shfl_sync(0xffffffffu, xh1, q);
            xv[i] = a == 0 ? t0_ : t1_;
        }
        double s = part;
        for (int i = 0; i < 4; ++i) s = fma(fv[i], xv[i], s);
        const double nn = b - s, qq = nn * r;
        const double xn = fma(fma(-qq, d, nn), r, qq);
        xh1 = xh0;
        xh0 = xn;
        xs[(lane * 7 + l) & 1023] = xn;
        __syncwarp();
        part = xs[(lane * 5 + l) & 1023] * 1e-6;
    }
    long long t1 = clock64();
    if (lane == 0) { out[0] = t1 - t0; out[1] = (long long)(xh0 * 1e3); }
    if (threadIdx.x == 0) stop = 1;
}
extern "C" int run_chain_model(int n, int warps, int spin, long long* out,
                               void* s) {
    chain_model<<<1, 32 * warps, 0, (cudaStream_t)s>>>(n, spin, out);
    return (int)cudaGetLastError();
}
'''


def chain_model(device, n=4096):
    """Cycles a level of CHAIN_MODEL_SRC's chain warp, alone, beside 8
    warps spinning on an mbarrier, and beside 8 sleeping between tries."""
    import chip_smoke as cs
    from pyiga_tpu_torch import _cuda
    lib = _cuda.build_generated('wavefront_chain_model', CHAIN_MODEL_SRC)
    lib.run_chain_model.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    out = torch.zeros(2, dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    res = {}
    for name, warps, spin in (('chain alone', 1, 0),
                              ('beside 8 spinning warps', 9, 1),
                              ('beside 8 sleeping warps', 9, 2)):
        for _ in range(2):
            if lib.run_chain_model(n, warps, spin, out.data_ptr(), stream):
                raise RuntimeError('chain model failed')
            torch.cuda.synchronize(device)
        res[name] = out[0].item() / n
        cs.log('  chain model, %-26s %6.1f cycles a level' % (name,
                                                             res[name]))
    return res


LATENCY_NAMES = ('ld.shared', 'generic load of shared', 'DFMA', 'SHFL f64',
                 'global load (L2)', 'DADD')


def latencies(device, n=256):
    """Cycles a step of one warp's dependent chains (LATENCY_SRC)."""
    import chip_smoke as cs
    from pyiga_tpu_torch import _cuda
    lib = _cuda.build_generated('wavefront_latency', LATENCY_SRC)
    lib.latency.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                            ctypes.c_void_p]
    g = torch.arange(4096, dtype=torch.float64, device=device)
    out = torch.zeros(8, dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    for _ in range(2):
        if lib.latency(g.data_ptr(), out.data_ptr(), n, stream):
            raise RuntimeError('latency kernel failed')
        torch.cuda.synchronize(device)
    res = {k: v / n for k, v in zip(LATENCY_NAMES, out.tolist())}
    for k, v in res.items():
        cs.log('  latency %-24s %6.1f cycles' % (k, v))
    return res


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

GROUPS = 2       # csrc/mg.cu kWfGroups
# (from, to) clocks of a traced level (WavefrontSweeps.set_trace; -1: the
# producers' previous level, GROUPS back; 7: the next level's start)
TRACE_PARTS = {
    'chain: fresh x, FMAs, quotient, store': (0, 1),
    'chain: __syncwarp, arrive': (1, 2),
    'chain: wait for the next level': (2, 3),
    'chain: read the next level': (3, 4),
    'chain: to the next level': (4, 7),
    'producers: from their last arrive': (-1, 8),
    'producers: wait for the level\'s copies': (8, 9),
    'producers: wait for the chain': (9, 10),
    'producers: stale sums': (10, 11),
    'producers: arrive': (11, 12),
}


def traced_levels(device, sizes=((24, 3), (96, 3)), launch=None,
                  check=True):
    """The redesigned level measured in place: one ``wavefront_gs``
    launch over level 2's forward pass with ``WavefrontSweeps.set_trace``
    on, and per part the median SM cycles over the pass's levels (the
    first and last 8 left out); a level's cycles are the chain's period
    from one level's start to the next."""
    if launch is None:
        launch = traced_build()[0]
    import numpy as np
    import chip_smoke as cs
    from pyiga_tpu_torch.ops import cuda_mg
    from pyiga_tpu_torch.ops.relax import DeviceIndexedGS
    out = {}
    for n0, L in sizes:
        _hs, _A, _f, As, lv_inds = cs.localmg_levels(n0, L,
                                                     torch.device('cpu'))
        gs = DeviceIndexedGS(As[L - 1], lv_inds[L - 1], device=device)
        sw = gs.sweeps
        nlev = sw.compact[0][0]['nlev']
        rng = np.random.RandomState(0)
        n = As[L - 1].shape[0]
        x = torch.as_tensor(rng.rand(n), device=device)
        b = torch.as_tensor(rng.rand(n), device=device)
        tr = torch.zeros(16 * nlev, dtype=torch.int64, device=device)

        def run(xx):
            err = launch(sw.words.data_ptr(), 0, 1, xx.data_ptr(),
                         b.data_ptr(), sw.smem_bytes,
                         torch.cuda.current_stream(device).cuda_stream)
            if err:
                raise RuntimeError('variant launch failed (%d)' % err)
            return xx
        ref = cuda_mg.wavefront_gs_plain(sw, 0, 1, x.clone(), b)
        got = run(x.clone())
        if check:
            cs.compare('traced pass (%d, %d)' % (n0, L), got, ref, 1e-13)
        us = 1e3 * cs.time_ms(lambda: run(x.clone()), device, reps=20) \
            / nlev
        sw.set_trace(tr)
        run(x.clone())
        sw.set_trace(None)
        t = tr.cpu().numpy().reshape(nlev, 16).astype(np.float64)
        g = np.arange(8, nlev - 8)
        rec = {'level (chain period)': float(np.median(t[g + 1, 0]
                                                        - t[g, 0])),
               'us a level, untraced': us}
        # the hand-offs: from the chain's arrive on done[g - D - 1] to the
        # producers of g passing their wait, and from those producers'
        # arrive on ready[g + 1] to the chain passing its wait at level g
        D = cuda_mg.WF_FRESH
        gg = g[g > D + 1]
        rec['hand-off: chain done -> producers see it'] = float(
            np.median(t[gg, 10] - t[gg - D - 1, 2]))
        rec['hand-off: producers ready -> chain sees it'] = float(
            np.median(t[g, 3] - t[g + 1, 12]))
        for name, (a, z) in TRACE_PARTS.items():
            start = t[g - GROUPS, 12] if a == -1 else t[g, a]
            end = t[g + 1, 0] if z == 7 else t[g, z]
            rec[name] = float(np.median(end - start))
        if t[g, 6].any():          # a variant timing one ld.shared
            rec['ld.shared in place'] = float(np.median(t[g, 6]))
        key = '(%d, %d) level 2 forward, %d levels' % (n0, L, nlev)
        out[key] = rec
        for name, v in rec.items():
            cs.log('  %s  %-46s %9.3f %s' % (key, name, v, 'us' if 'us'
                                               in name else 'cycles'))
    return out


# variants of csrc/mg.cu built side by side for --variants: text edits of
# the source (each must match), and the host pack's WF_FRESH
WAIT_LOOP = ('    while (!mb_test(a, parity))\n'
             '        if (globaltimer() - t0 > 2000000000LL) __trap();')
VARIANTS = {
    'as built': ([], 2),
    'fresh 3': ([('constexpr int kWfFresh = 2;',
                  'constexpr int kWfFresh = 3;'),
                 ('constexpr int kWfFreshRegs = 4;',
                  'constexpr int kWfFreshRegs = 6;')], 3),
    'three producer groups': ([('constexpr int kWfGroups = 2;',
                                'constexpr int kWfGroups = 3;')], 2),
    'waits sleep 100 ns': ([(WAIT_LOOP, '    while (!mb_test(a, parity)) {\n'
                             '        __nanosleep(100);\n'
                             '        if (globaltimer() - t0 > 2000000000LL) '
                             '__trap();\n    }')], 2),
    # diagnostics: wrong results, timed only
    'no stale sums': ([('        stale_sums(m, g, pu, v);\n', '')], -2),
    'no stale gathers': ([('fma(v%s, xs[q.%s], a%d)' % (v, c, i),
                           'fma(v%s, (double)q.%s, a%d)' % (v, c, i))
                          for i, (v, c) in enumerate(
                              (('01.x', 'x'), ('01.y', 'y'), ('23.x', 'z'),
                               ('23.y', 'w')))], -2),
}


def traced_build(edits=()):
    """csrc/mg.cu built on its own with PYIGA_WF_TRACE defined (the
    kernel then records a traced level's clocks) after the text `edits`;
    returns its ``pyiga_wavefront_gs_f64`` and the ptxas spill lines."""
    from pyiga_tpu_torch import _cuda
    src_dir = os.path.join(REPO, 'pyiga_tpu_torch', 'csrc')
    src = open(os.path.join(src_dir, 'mg.cu')).read().replace(
        '#include "common.cuh"',
        '#define PYIGA_WF_TRACE 1\n'
        + open(os.path.join(src_dir, 'common.cuh')).read())
    for a, z in edits:
        if a not in src:
            raise RuntimeError('%r not in mg.cu' % a)
        src = src.replace(a, z)
    lib = _cuda.build_generated('mg_traced', src)
    log = _cuda.GEN_BUILDS[str(lib._name)]['log']
    fn = lib.pyiga_wavefront_gs_f64
    fn.argtypes = list(_cuda._SIGNATURES['pyiga_wavefront_gs_f64'])
    fn.restype = ctypes.c_int
    return fn, [ln.strip() for ln in log.splitlines() if 'spill' in ln]


def variants(device, names=None):
    """Build the VARIANTS of csrc/mg.cu side by side (each its own traced
    library) and trace each on the (24, 3) and (96, 3) level-2 forward
    passes as traced_levels does, with each variant's ptxas spills."""
    import chip_smoke as cs
    from pyiga_tpu_torch.ops import cuda_mg
    out = {}
    for name, (edits, fresh) in VARIANTS.items():
        if names and name not in names:
            continue
        fn, spills = traced_build(edits)
        check = fresh > 0              # a diagnostic computes garbage
        fresh = abs(fresh)
        saved = cuda_mg.WF_FRESH, cuda_mg.WF_CHAIN
        cuda_mg.WF_FRESH = fresh
        cuda_mg.WF_CHAIN = cuda_mg.WF_STAGES + fresh + 1
        try:
            rec = traced_levels(device, launch=fn, check=check)
        finally:
            cuda_mg.WF_FRESH, cuda_mg.WF_CHAIN = saved
        out[name] = dict(spills=spills, cycles=rec)
        cs.log('  variant %-16s spills %s' % (name, spills))
    return out


def dump_sass(lib_path, fn='wavefront_gs_kernel'):
    """The SASS of each compiled copy of `fn` in the built library
    (``cuobjdump -sass``), written to ``chiprun_out/sass_<fn>.txt``;
    returns the instruction count of each copy."""
    import subprocess
    cuobjdump = os.path.join(os.path.dirname(_cuda_nvcc()), 'cuobjdump')
    res = subprocess.run([cuobjdump, '-sass', lib_path],
                         capture_output=True, text=True)
    parts = [p for p in res.stdout.split('Function :')[1:] if fn in
             p.splitlines()[0]]
    if not parts:
        parts = ['(none found; cuobjdump said: %s)' % res.stderr[-2000:]]
    with open(os.path.join(REPO, 'chiprun_out', 'sass_%s.txt' % fn),
              'w') as f:
        f.write('\n'.join('Function : ' + p for p in parts))
    return [sum(1 for ln in p.splitlines() if '/*0' in ln and ';' in ln)
            for p in parts]


def _cuda_nvcc():
    from pyiga_tpu_torch import _cuda
    return _cuda._nvcc()


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
    os.makedirs(os.path.join(REPO, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(REPO, 'chiprun_out', 'ptxas.log'), 'w') as f:
        f.write(_cuda.BUILD_INFO['log'])
    lines = _cuda.BUILD_INFO['log'].splitlines()
    # each compiled copy of the two kernels and of the wavefront function
    # they call: its frame and spills (a function appears once a kernel)
    rec = dict(card=card, ptxas=[])
    for i, line in enumerate(lines):
        if 'Function properties for' in line and (
                'wavefront' in line or 'vcycle' in line):
            name = line.split('Function properties for')[1].strip()
            rec['ptxas'].append([name, lines[i + 1].strip()])
            cs.log('  %s: %s' % (name[-60:], lines[i + 1].strip()))
    if '--micro' in sys.argv[1:]:
        cs.log('model wavefront levels (1 block of 512 threads, (96, 3) '
               'shapes)')
        rec['micro_ns_per_level'] = micro(device)
        cs.log('dependent-chain latencies and a model chain level')
        rec['latency_cycles'] = latencies(device)
        rec['chain_model_cycles'] = chain_model(device)
        cs.log('the redesigned level in place (wavefront_gs, traced)')
        rec['traced_cycles_per_level'] = traced_levels(device)
        return finish(rec, card)
    if '--sass' in sys.argv[1:]:
        rec['sass'] = dump_sass(_cuda.BUILD_INFO['path'])
    if '--variants' in sys.argv[1:]:
        names = [a for a in sys.argv[1:] if not a.startswith('--')]
        rec['variants'] = variants(device, names or None)
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
    mode = ''.join('_' + a[2:] for a in sys.argv[1:] if a in (
        '--micro', '--variants', '--aca'))
    with open(os.path.join(REPO, 'chiprun_out',
                           'wavefront_probe%s.json' % mode), 'w') as f:
        json.dump(rec, f, indent=1, default=str)
    print(card)
    return 0


if __name__ == '__main__':
    sys.exit(main())
