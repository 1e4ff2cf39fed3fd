// The windowed assembly route's stage kernels for Hopper (sm_90a), float64
// and float32.
//
// No Pallas site: the JAX package runs this route in XLA.
// K8  windowed_kernel, one term   replaces pyiga_tpu/ops/sumfac.py:395
//     `_windowed_stage` (XLA: p+1 shifted copies of the field
//     concatenated, a window gathered per dof, one einsum).
// K8f windowed_kernel, all terms  replaces the final stage and the term sum
//     of :433 `assemble_terms_windowed` (XLA: one final stage a term, the
//     results added).
//
//   Y[r, o n + i] = sum_{w < wsz} X[fs[i] nqp + w, r] P[i, o, w]
//
// X (Q, R) is the chain's field with the quadrature axis leading, P (n, b,
// wsz) the windowed pair table (b = 2p+1 band offsets, wsz = (p+1) nqp
// points of dof i's support window from span fs[i]), Y (R, b n) the
// banded-flat result with the band axis appended last (the chain's cyclic
// axis order, as K2).  K8f sums the fields of the terms that share a
// table first, in term order, runs one product a table and sums the
// products in registers (groups of one table in order of first
// appearance: a fixed order, bitwise-reproducible), and writes Y once.
//
// Bound: bytes.  At the 3D p=3 n=48 headline (Q = 192, n = 51, b = 7,
// wsz = 16) a stage does 16 multiply-adds an output entry, 2 flops a byte
// of Y: stage 1 moves 162 MB (0.048 ms at 3.35 TB/s) for 0.42 GFLOP (0.012
// ms at 34 TFLOP/s of f64 FMA); the fold of 6 terms 1.54 GB (0.46 ms).  No
// tensor cores: these are 16-term dots.
//
// Design: a persistent, warp-specialized kernel (one CTA an SM, at most).
// A tile is 8 rpt consecutive r (rpt = 2 or 3 where that still gives two
// thirds of the SMs a tile, else 1) by a run of up to 64 consecutive dofs
// (the runs of an axis balanced; at n=48 one run covers the axis).  A CTA
// keeps one run and walks its r tiles with the stride of the CTAs on that
// run.  Its warps:
// - 4 producer warps stream the X tiles of every term of every tile in
//   order through a ring of 2 to 4 stages, full / empty mbarriers handing
//   a stage over: the rows fs[i0] nqp to fs[i1] nqp + wsz (all 192 at
//   n=48) by one tensor copy (TMA, a box of rt + 2 columns: the padded
//   row stride) where X's rows start 16-byte aligned (R even); by 16-byte
//   cp.async from each row's aligned start where only X does (the 3D
//   fold's R = 357^2 is odd: a row's data then starts one slot on, which
//   the consumers read by its parity); by 8-byte cp.async otherwise.  A
//   bulk copy a row (192 B) cost ~60 cycles a request an SM and one
//   producer warp could not keep the 16-byte copies in flight;
// - the consumer warps (4 dofs each, 8 lanes a dof, a lane rpt r: r =
//   rsub + 8 rr) load the run's rows of every distinct table once and
//   keep them resident (not staged again a tile).  A lane keeps its b x
//   rpt sums in registers; a step w reads rpt X values and b table values
//   from shared memory for b rpt multiply-adds.  The strides (stage row
//   rt + 2 doubles, table 2 mod 4) put the 4 dofs of a warp on distinct
//   banks.  A group of several terms (K8f) is summed as its stages land:
//   the running sum is added into the newest stage (b = a + b, each
//   consumer thread its own elements), the older stage goes back to the
//   producers at once, and the product runs on the newest; one consumer
//   barrier, no pass between block-wide barriers, and the next loads keep
//   flowing.  (Tables compacted to the (p+1)^2 nqp entries a windowed
//   pair table can hold at an unclipped window made room for the fold's
//   output span, but the clipped dofs' products from global memory
//   stalled their warps: the fold 0.95 -> 1.08 ms.)  Times here:
//   scripts/torch_windowed_variants.py on an NVIDIA H100 80GB HBM3,
//   700.00 W;
// - the finished tile: where the run covers every dof, a tile is one
//   contiguous span of Y (rt rows of b n).  It is written into one of two
//   buffers in shared memory (one where two do not fit) in Y's own order
//   and sent out by one bulk asynchronous store (cp.async.bulk) that
//   drains while the next tiles compute (a buffer is reused once the
//   store that last used it has read it).  A ragged span (odd bytes /
//   8) goes out by a store loop from the buffer; with several runs, or
//   where no buffer fits (the fold's 3 resident tables), the lanes store
//   directly (4 consecutive doubles a row, partial sectors: ~3x slower a
//   byte; the X ring as the fold's span buffer, its next loads waiting
//   for the store, was slower still: 0.94 -> 1.02 ms).
// Every entry of Y is written, the padding (j = i + o - p outside [0, n),
// where P holds zeros) included: no memset.  Offsets are 64-bit (Y passes
// 2^31 bytes at n=96).  The sums run in the order of the earlier design
// (a block a tile, scripts/torch_windowed_variants.py builds it beside
// this one): w ascending a group, groups in order, a group's fields
// summed in term order first; so the two outputs are equal bitwise.
//
// Shared memory (232,448 bytes a block): at 3D n=48 a stage holds its
// table (52 x 114 doubles, 47 KB), two output spans of 16 rows (46 KB
// each) and three X stages of 192 x 18 doubles (28 KB each): 221,952
// bytes; the fold its 3 tables (142 KB) and two stages of 192 x 26
// doubles (222,336).  The plan (make_plan) is mirrored by
// pyiga_tpu_torch.ops.cuda_sumfac.windowed_plan and exported as
// pyiga_windowed_plan so that the two can be compared on the card.
//
// Float32 (the f32 line, pyiga_tpu_torch.config.set_dtype(np.float32);
// the JAX package casts the route's inputs and windowed tables to float32,
// pyiga_tpu/ops/sumfac.py:650-656): the kernel is templated on its scalar
// S and the float instance (pyiga_windowed_stage_f32 / _fold_f32) is the
// same design in 4-byte elements, float32 arithmetic throughout (fmaf).
// What an element's size changes is counted in elements of V = 16 /
// sizeof(S) (2 doubles, 4 floats a 16-byte copy): a stage row's stride is
// rt + V (room for a row shifted by up to V - 1 from its aligned start),
// the table's dof stride a multiple of V (16-byte copies) plus V, the
// tensor copy needs R % V == 0, a 16-byte cp.async row takes 32 / V
// lanes, and the plan's bytes (tables, stages, spans) halve, so more
// stages or spans fit.  The plan (make_plan, with the element size) and
// its mirror windowed_plan(..., esize) agree per element size.
//
// The window starts must be what SpaceTables.windowed_pair_table gives
// (non-decreasing from 0 in steps of at most 1, the last window inside
// X): the wrapper checks them once per tensor; the stage is sized by
// them.

#include <cuda.h>

#include <algorithm>

#include "common.cuh"

// Cut points and plan overrides for scripts/torch_windowed_variants.py;
// the package builds with none of them.
#ifndef PYIGA_WIN_CUT
#define PYIGA_WIN_CUT 0
#endif
#ifndef PYIGA_WIN_RPT
#define PYIGA_WIN_RPT 0
#endif
#ifndef PYIGA_WIN_STAGES
#define PYIGA_WIN_STAGES 0
#endif
#ifndef PYIGA_WIN_NO_YS
#define PYIGA_WIN_NO_YS 0
#endif
#ifndef PYIGA_WIN_NO_TMA
#define PYIGA_WIN_NO_TMA 0
#endif
#ifndef PYIGA_WIN_PRODUCER_WARPS
#define PYIGA_WIN_PRODUCER_WARPS 4
#endif
#ifndef PYIGA_WIN_MAX_YS
#define PYIGA_WIN_MAX_YS 2
#endif

namespace {
namespace win {

constexpr int kMaxTerms = 16;
constexpr int kDI = 4;            // dofs a consumer warp
constexpr int kMaxWarps = 16;     // consumer warps: dofs a run kDI kMaxWarps
constexpr int kMaxStages = 4;
constexpr int kProducerWarps = PYIGA_WIN_PRODUCER_WARPS;
constexpr int kMaxBox = 256;      // a tensor copy's rows at most
// how the producer copies X: 8-byte cp.async (X not 16-byte aligned),
// 16-byte cp.async from each row's aligned start (R odd), or one tensor
// copy (TMA) of the tile's rows
constexpr int kCopy8 = 0, kCopy16 = 1, kCopyTensor = 2;
constexpr size_t kSmem = 232448;  // shared bytes a block
// cuts: the producer's copies, the products, the stores of Y, and every
// consumer (the producer then streams alone)
constexpr int kCutLoads = 1, kCutProducts = 2, kCutStores = 4,
              kCutConsumers = 8;
constexpr int kCut = PYIGA_WIN_CUT;

// the fields grouped by table (as the fold of csrc/sumfac.cu)
template <class S>
struct Terms {
    const S* x[kMaxTerms];        // per term, its (Q, R) field, in order
    const S* p[kMaxTerms];        // per group, its (n, b, wsz) table
    int end[kMaxTerms];           // per group, one past its last term
    int groups;
};

// a 16-byte vector of the scalar: V = 16 / sizeof(S) elements
template <class S>
struct Vec16;
template <>
struct Vec16<double> {
    using type = double2;
    __device__ __forceinline__ static double2 add(double2 a, double2 b) {
        b.x = a.x + b.x;
        b.y = a.y + b.y;
        return b;
    }
    __device__ __forceinline__ static double fma(double a, double b,
                                                 double c) {
        return ::fma(a, b, c);
    }
};
template <>
struct Vec16<float> {
    using type = float4;
    __device__ __forceinline__ static float4 add(float4 a, float4 b) {
        b.x = a.x + b.x;
        b.y = a.y + b.y;
        b.z = a.z + b.z;
        b.w = a.w + b.w;
        return b;
    }
    __device__ __forceinline__ static float fma(float a, float b, float c) {
        return fmaf(a, b, c);
    }
};

// per term, the tensor map of its field (a box of xs columns by `box`
// rows), for kCopyTensor
struct Maps {
    CUtensorMap m[kMaxTerms];
};

// The launch's tiling and shared-memory layout (byte offsets).
struct Plan {
    int rpt;              // r a lane: a tile is 8 rpt r
    int run;              // dofs a run: kDI a consumer warp
    int nruns;
    int cap;              // X rows a stage holds
    int box;              // rows a tensor copy (cap a multiple of it)
    int ps;               // the table's dof stride (elements)
    int xs;               // a stage's row stride (elements)
    int stages;
    int nys;              // output spans through shared memory (0, 1, 2)
    long long rtiles;
    int cpr;              // CTAs a run: the grid is nruns cpr
    long long tab_off, stage_off, stage_bytes, ys_off, ys_bytes, smem;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mb_init(unsigned long long* b,
                                        unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                     smem_u32(b)),
                 "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mb_arrive(unsigned long long* b) {
    asm volatile(
        "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}" ::"r"(
            smem_u32(b))
        : "memory");
}

__device__ __forceinline__ bool mb_test(unsigned a, unsigned parity) {
    unsigned ok;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(ok)
        : "r"(a), "r"(parity)
        : "memory");
    return ok != 0;
}

__device__ __forceinline__ long long globaltimer() {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// Wait for the phase of this parity; a wait longer than two seconds is a
// lost arrive: trap (the launch fails) rather than hang the card.
__device__ __forceinline__ void mb_wait(unsigned long long* b,
                                        unsigned parity) {
    const unsigned a = smem_u32(b);
    if (mb_test(a, parity)) return;
    const long long t0 = globaltimer();
    while (!mb_test(a, parity))
        if (globaltimer() - t0 > 2000000000LL) __trap();
}

// a box of the 2D tensor map `map` at (column c0, row c1) into shared
// `dst` by the TMA, completing on the mbarrier `bar`
__device__ __forceinline__ void tensor_load(void* dst, const CUtensorMap* map,
                                            int c0, int c1,
                                            unsigned long long* bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
        ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(
            smem_u32(dst)),
        "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(c1),
        "r"(smem_u32(bar))
        : "memory");
}

// `bytes` (a multiple of 16) from shared `src` to global `dst` by the
// bulk-copy engine, in the thread's bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           unsigned bytes) {
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
        "cp.async.bulk.commit_group;" ::"l"(dst),
        "r"(smem_u32(src)), "r"(bytes)
        : "memory");
}

// `bytes` more of bulk copies expected on `bar`, without an arrival
__device__ __forceinline__ void mb_expect_tx(unsigned long long* bar,
                                             unsigned bytes) {
    asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;" ::"r"(
                     smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
}

// the thread's bulk stores but the last N have read their shared source
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
    asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// the thread's bulk stores are complete
__device__ __forceinline__ void bulk_wait() {
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// this thread's writes to shared memory, before the async proxy (bulk
// copies) reads or writes there
__device__ __forceinline__ void fence_async_shared() {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Copy 4, 8 or 16 bytes from global to shared memory, asynchronously.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
    if constexpr (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                         smem_u32(dst)),
                     "l"(src)
                     : "memory");
    else if constexpr (BYTES == 8)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                         smem_u32(dst)),
                     "l"(src)
                     : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                         smem_u32(dst)),
                     "l"(src)
                     : "memory");
}

// an arrival on `bar` once this thread's cp.async copies so far have
// landed (counted among the barrier's expected arrivals)
__device__ __forceinline__ void cp_async_arrive(unsigned long long* bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                     smem_u32(bar))
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::
                     : "memory");
}

// a barrier of the consumer warps alone (the producer never joins it)
__device__ __forceinline__ void consumer_sync(int threads) {
    asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

template <class S, int B, int RPT>
__global__ void __launch_bounds__(32 * (kMaxWarps + kProducerWarps), 1)
windowed_kernel(const Terms<S> terms, const __grid_constant__ Maps maps,
                const long long* __restrict__ fs, S* __restrict__ Y,
                long long Q, long long R, int n, int wsz, int nqp,
                const Plan pl, int mode, bool pvec, bool bulk_y) {
    constexpr int RT = 8 * RPT;
    constexpr int E = (int)sizeof(S);
    constexpr int V = 16 / E;                    // elements a 16-byte copy
    using Vec = typename Vec16<S>::type;
    extern __shared__ __align__(128) unsigned char smem_raw[];
    unsigned long long* full = reinterpret_cast<unsigned long long*>(smem_raw);
    unsigned long long* empty = full + kMaxStages;
    S* Ps = reinterpret_cast<S*>(smem_raw + pl.tab_off);
    S* Xst = reinterpret_cast<S*>(smem_raw + pl.stage_off);
    S* Ys = reinterpret_cast<S*>(smem_raw + pl.ys_off);
    const long long sdbl = pl.stage_bytes / E;   // a stage's elements
    const int nc = pl.run / kDI;                 // consumer warps
    const int nct = 32 * nc;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int NS = pl.stages;
    const int k0 = blockIdx.x % pl.cpr;
    const int i0 = blockIdx.x / pl.cpr * pl.run;
    const int nd = min(pl.run, n - i0);
    const long long qa = fs[i0] * nqp;
    const int rows = (int)(fs[i0 + nd - 1] * nqp + wsz - qa);
    const int nterms = terms.end[terms.groups - 1];
    // a stage row holds X[q, r0 - sh : ...] from its 16-byte aligned
    // start: sh = (its first element's index) mod V (kCopy16)
    const int shm = mode == kCopy16 ? V - 1 : 0;

    if (threadIdx.x == 0) {
        for (int s = 0; s < NS; ++s) {
            mb_init(&full[s], blockDim.x - nct);
            mb_init(&empty[s], nc);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (warp >= nc) {
        // the producer warps: every term's X tile of every tile, in order;
        // each producer thread arrives once a stage, when its cp.async
        // copies have landed, the tensor copies' bytes expected first
        const int pt = threadIdx.x - nct, pw = pt >> 5;
        const int npw = blockDim.x / 32 - nc;
        long long it = 0;
        for (long long t = k0; t < pl.rtiles; t += pl.cpr) {
            const long long r0 = t * RT;
            const int nr = (int)min((long long)RT, R - r0);
            for (int u = 0; u < nterms; ++u, ++it) {
                const int s = (int)(it % NS);
                const long long use = it / NS;
                if (use > 0) {
                    if (kCut & kCutConsumers)
                        mb_wait(&full[s], (unsigned)((use - 1) & 1));
                    else
                        mb_wait(&empty[s], (unsigned)((use - 1) & 1));
                }
                S* dst = Xst + s * sdbl;
                const S* X = terms.x[u];
                if (kCut & kCutLoads) {
                    mb_arrive(&full[s]);
                    continue;
                }
                if (mode == kCopyTensor) {
                    if (pt == 0) {
                        const int nch = (rows + pl.box - 1) / pl.box;
                        mb_expect_tx(&full[s],
                                     (unsigned)(nch * pl.box * pl.xs * E));
                        for (int h = 0; h < nch; ++h)
                            tensor_load(dst + (long long)h * pl.box * pl.xs,
                                        &maps.m[u], (int)r0,
                                        (int)(qa + h * pl.box), &full[s]);
                    }
                } else if (mode == kCopy16) {
                    // 32 / V lanes a row (16 for doubles, 8 for floats;
                    // 16 bytes a lane), V rows a warp: the row's elements
                    // from its aligned start, the last ones alone where a
                    // vector would pass the end of X
                    constexpr int LPR = 32 / V;
                    const int j2 = V * (lane & (LPR - 1));
                    for (int q = V * pw + (lane >> (V == 2 ? 4 : 3));
                         q < rows; q += V * npw) {
                        const long long e = (qa + q) * R + r0;
                        const int sh = (int)(e & (V - 1));
                        if (j2 < nr + sh) {
                            const long long a = e - sh + j2;
                            S* d = dst + q * pl.xs + j2;
                            if (a + V <= Q * R)
                                cp_async<16>(d, X + a);
                            else if constexpr (V == 2)
                                cp_async<8>(d, X + a);
                            else
                                for (int k = 0; a + k < Q * R; ++k)
                                    cp_async<4>(d + k, X + a + k);
                        }
                    }
                } else {
                    for (int q = pw; q < rows; q += npw)
                        for (int c = lane; c < nr; c += 32)
                            cp_async<E>(dst + q * pl.xs + c,
                                        X + (qa + q) * R + r0 + c);
                }
                cp_async_arrive(&full[s]);
            }
        }
        if (kCut & kCutConsumers) {       // the last stages landed
            for (long long u = it > NS ? it - NS : 0; u < it; ++u)
                mb_wait(&full[u % NS], (unsigned)((u / NS) & 1));
        }
        cp_async_wait_all();
        return;
    }
    if (kCut & kCutConsumers) return;

    // the consumers: dof il of the run, r = rsub + 8 rr of the tile
    const int ct = threadIdx.x;
    const int il = warp * kDI + (lane >> 3);
    const int rsub = lane & 7;
    const bool live = il < nd;
    const int qrel = live ? (int)(fs[i0 + il] * nqp - qa) : 0;
    const int bw = B * wsz;
    const long long bn = (long long)B * n;
    const long long gstride = (long long)pl.run * pl.ps;
    long long tile = 0;                          // tiles done (Ys buffer)

    // the run's rows of every distinct table, once (resident)
    for (int g = 0; g < terms.groups; ++g) {
        const S* P = terms.p[g] + (long long)i0 * bw;
        S* Pg = Ps + g * gstride;
        if (pvec) {
            const int cpr = bw / V;
            for (int e = ct; e < nd * cpr; e += nct) {
                const int i = e / cpr, c = V * (e - i * cpr);
                cp_async<16>(Pg + i * pl.ps + c, P + i * bw + c);
            }
        } else {
            for (int e = ct; e < nd * bw; e += nct) {
                const int i = e / bw, c = e - i * bw;
                cp_async<E>(Pg + i * pl.ps + c, P + e);
            }
        }
    }
    cp_async_wait_all();
    consumer_sync(nct);

    long long it = 0;
    for (long long t = k0; t < pl.rtiles; t += pl.cpr) {
        const long long r0 = t * RT;
        const int nr = (int)min((long long)RT, R - r0);
        S acc[B][RPT];
#pragma unroll
        for (int o = 0; o < B; ++o)
#pragma unroll
            for (int rr = 0; rr < RPT; ++rr) acc[o][rr] = S(0);

        for (int g = 0; g < terms.groups; ++g) {
            const int t0 = g ? terms.end[g - 1] : 0, t1 = terms.end[g];
            int s = (int)(it % NS);
            mb_wait(&full[s], (unsigned)((it / NS) & 1));
            ++it;
            // a group's further terms: the running sum into the newest
            // stage, in term order; the older stage goes back at once
            for (int u = t0 + 1; u < t1; ++u, ++it) {
                const int s2 = (int)(it % NS);
                mb_wait(&full[s2], (unsigned)((it / NS) & 1));
                const Vec* a = reinterpret_cast<const Vec*>(Xst + s * sdbl);
                Vec* b = reinterpret_cast<Vec*>(Xst + s2 * sdbl);
                const int half = pl.xs / V;   // a row's vectors, shift
                                              // included
                for (int c = ct; c < rows * half; c += nct)
                    b[c] = Vec16<S>::add(a[c], b[c]);
                fence_async_shared();
                __syncwarp();
                if (lane == 0) mb_arrive(&empty[s]);
                s = s2;
            }
            if (t1 - t0 > 1) consumer_sync(nct);
            if (live && !(kCut & kCutProducts)) {
                const S* xr = Xst + s * sdbl + qrel * pl.xs + rsub;
                // row qrel + w starts at slot sh: its first element's
                // index mod V where X's rows are copied in 16 bytes (for
                // doubles the parity, flipping each row where R is odd)
                const int par = (int)(((qa + qrel) * R + r0) & shm);
                const int rodd = (int)(R & shm);
                const S* pr = Ps + g * gstride + il * pl.ps;
                for (int w = 0; w < wsz; ++w) {
                    S x[RPT], p[B];
                    int sh;
                    if constexpr (V == 2)
                        sh = par ^ (w & rodd);
                    else
                        sh = (par + w * rodd) & shm;
                    const S* xw = xr + w * pl.xs + sh;
#pragma unroll
                    for (int rr = 0; rr < RPT; ++rr) x[rr] = xw[8 * rr];
#pragma unroll
                    for (int o = 0; o < B; ++o) p[o] = pr[o * wsz + w];
#pragma unroll
                    for (int o = 0; o < B; ++o)
#pragma unroll
                        for (int rr = 0; rr < RPT; ++rr)
                            acc[o][rr] =
                                Vec16<S>::fma(x[rr], p[o], acc[o][rr]);
                }
            }
            __syncwarp();
            if (lane == 0) mb_arrive(&empty[s]);
        }

        if (kCut & kCutStores) continue;
        if (pl.nys) {
            // the span Y[r0 : r0 + nr] (the run covers every dof) in Y's
            // order, once the bulk store that last used the buffer has
            // read it
            S* Yb = Ys + (pl.nys == 2 ? (tile & 1) : 0) * (pl.ys_bytes / E);
            ++tile;
            if (ct == 0) {
                if (pl.nys == 2)
                    bulk_wait_read<1>();
                else
                    bulk_wait_read<0>();
            }
            consumer_sync(nct);
            if (live) {
#pragma unroll
                for (int rr = 0; rr < RPT; ++rr)
#pragma unroll
                    for (int o = 0; o < B; ++o)
                        Yb[(rsub + 8 * rr) * bn + o * n + il] = acc[o][rr];
            }
            fence_async_shared();
            consumer_sync(nct);
            const long long span = nr * bn;
            if (bulk_y && span % V == 0) {
                if (ct == 0)
                    bulk_store(Y + r0 * bn, Yb, (unsigned)(span * E));
            } else {
                for (long long e = ct; e < span; e += nct)
                    Y[r0 * bn + e] = Yb[e];
            }
        } else if (live) {
#pragma unroll
            for (int rr = 0; rr < RPT; ++rr) {
                const int r = rsub + 8 * rr;
                if (r < nr) {
                    S* y = Y + (r0 + r) * bn + i0 + il;
#pragma unroll
                    for (int o = 0; o < B; ++o)
                        y[(long long)o * n] = acc[o][rr];
                }
            }
        }
    }
    if (pl.nys && ct == 0) bulk_wait();
}

inline long long r128(long long x) { return (x + 127) / 128 * 128; }

// The tiling of a launch (mirrored by cuda_sumfac.windowed_plan): runs of
// whole warps, balanced, at most kMaxWarps, fewer where nothing fits; r a
// lane 3 or 2 where that still gives two thirds of the SMs a tile, else
// 1, the wider tile first for a fold of several tables (it spreads the
// group sums over more r) and the narrower one first for one table (it
// leaves room for more stages and spans); for each, the most output span
// buffers (two at most; only where one run covers the axis) beside two X
// stages, and as many stages (up to kMaxStages) as the rest holds.  smem
// 0: nothing fits.  `esize`: the element's bytes (8 double, 4 float); the
// strides are in elements, V = 16 / esize of them a 16-byte copy.
Plan make_plan(long long Q, long long R, int n, int b, int wsz, int nqp,
               int groups, int nsm, int esize) {
    Plan pl{};
    const int V = 16 / esize;
    const int warps_total = (n + kDI - 1) / kDI;
    // a multiple of V (16-byte copies) plus V: the 4 dofs of a warp on
    // distinct banks
    const int ps = (wsz * b + 2 * V - 1) / (2 * V) * (2 * V) + V;
    for (int mw = kMaxWarps; mw >= 1; --mw) {
        const int nruns = (warps_total + mw - 1) / mw;
        const int run = (warps_total + nruns - 1) / nruns * kDI;
        // the rows of a run's windows, in tensor copies of `box` rows (a
        // multiple of 8: each box lands 128-byte aligned)
        long long cap = std::min(Q, (long long)(run - 1) * nqp + wsz);
        const long long nbox = (cap + kMaxBox - 1) / kMaxBox;
        const long long box = ((cap + nbox - 1) / nbox + 7) / 8 * 8;
        cap = nbox * box;
        const long long tab = r128((long long)groups * run * ps * esize);
        const long long fixed = 128 + tab;
        int order[3], no = 0;
        for (int k = 0; k < 2; ++k) {
            const int rpt = groups > 1 ? 3 - k : 2 + k;
            const long long rtiles = (R + 8 * rpt - 1) / (8 * rpt);
            if (PYIGA_WIN_RPT ? rpt == PYIGA_WIN_RPT
                              : 3 * nruns * rtiles >= 2LL * nsm)
                order[no++] = rpt;
        }
        if (!PYIGA_WIN_RPT || PYIGA_WIN_RPT == 1) order[no++] = 1;
        for (int c = 0; c < no; ++c) {
            const int rpt = order[c], rt = 8 * rpt;
            const int xs = rt + V;
            const long long stage = r128(cap * xs * esize);
            const long long ys = r128((long long)rt * b * n * esize);
            int nys = nruns == 1 && !PYIGA_WIN_NO_YS ? PYIGA_WIN_MAX_YS : 0;
            while (nys > 0 && fixed + nys * ys + 2 * stage > (long long)kSmem)
                --nys;
            const long long room = (long long)kSmem - fixed - nys * ys;
            if (room < 2 * stage) continue;
            int S = (int)std::min((long long)kMaxStages, room / stage);
            if (PYIGA_WIN_STAGES) S = std::min(S, PYIGA_WIN_STAGES);
            const long long rtiles = (R + rt - 1) / rt;
            pl.rpt = rpt;
            pl.run = run;
            pl.nruns = nruns;
            pl.cap = (int)cap;
            pl.box = (int)box;
            pl.ps = ps;
            pl.xs = xs;
            pl.stages = S;
            pl.nys = nys;
            pl.rtiles = rtiles;
            pl.cpr = (int)std::max(1LL, std::min(rtiles,
                                                 (long long)(nsm / nruns)));
            pl.tab_off = 128;
            pl.stage_off = fixed;
            pl.stage_bytes = stage;
            pl.ys_off = fixed + S * stage;
            pl.ys_bytes = ys;
            pl.smem = fixed + S * stage + nys * ys;
            return pl;
        }
    }
    return pl;
}

int sm_count() {
    static int cached[64] = {0};
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= 64) dev = 0;
    if (!cached[dev])
        cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    return cached[dev] > 0 ? cached[dev] : 1;
}

// cuTensorMapEncodeTiled from the driver, by the runtime (no link to
// libcuda); null where the driver has none
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    static bool tried = false;
    if (!tried) {
        tried = true;
        void* f = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        const cudaError_t e = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
        const cudaError_t e = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
        if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(f);
        cudaGetLastError();
    }
    return fn;
}

// the copy path of the last launch (for the checks of chip_smoke.py)
int last_mode = -1;

template <class S, int B, int RPT>
int launch_rpt(const Terms<S>& terms, const Maps& maps, const long long* fs,
               S* Y, long long Q, long long R, int n, int wsz, int nqp,
               const Plan& pl, int mode, bool pvec, bool bulk_y,
               cudaStream_t s) {
    auto kernel = windowed_kernel<S, B, RPT>;
    if (pl.smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)pl.smem);
        if (e != cudaSuccess) return (int)e;
    }
    const unsigned grid = (unsigned)pl.nruns * (unsigned)pl.cpr;
    const unsigned threads = (unsigned)(pl.run / kDI + kProducerWarps) * 32;
    kernel<<<grid, threads, (size_t)pl.smem, s>>>(
        terms, maps, fs, Y, Q, R, n, wsz, nqp, pl, mode, pvec, bulk_y);
    return (int)cudaGetLastError();
}

template <class S, int B>
int launch_b(const Terms<S>& terms, const long long* fs, S* Y, long long Q,
             long long R, int n, int wsz, int nqp, cudaStream_t s) {
    constexpr int E = (int)sizeof(S), V = 16 / E;
    const Plan pl = make_plan(Q, R, n, B, wsz, nqp, terms.groups,
                              sm_count(), E);
    if (pl.smem <= 0) return (int)cudaErrorInvalidValue;
    // 16-byte table copies where its rows allow them; the bulk output
    // store where Y starts 16-byte aligned
    bool pvec = (wsz * B) % V == 0;
    for (int g = 0; g < terms.groups; ++g)
        pvec = pvec && reinterpret_cast<uintptr_t>(terms.p[g]) % 16 == 0;
    const bool bulk_y = reinterpret_cast<uintptr_t>(Y) % 16 == 0;
    // X by tensor copies where every X starts 16-byte aligned and its rows
    // do (R a multiple of V), by 16-byte cp.async where only the starts
    // are, else by cp.async of one element
    const int nterms = terms.end[terms.groups - 1];
    bool aligned = true;
    for (int t = 0; t < nterms; ++t)
        aligned = aligned && reinterpret_cast<uintptr_t>(terms.x[t]) % 16 == 0;
    int mode = !aligned ? kCopy8 : kCopy16;
    Maps maps;
    const EncodeTiled encode = encode_tiled();
    if (aligned && R % V == 0 && encode && !PYIGA_WIN_NO_TMA &&
        R < (1LL << 31) && Q < (1LL << 31)) {
        mode = kCopyTensor;
        const cuuint64_t dims[2] = {(cuuint64_t)R, (cuuint64_t)Q};
        const cuuint64_t strides[1] = {(cuuint64_t)R * E};
        const cuuint32_t box[2] = {(cuuint32_t)pl.xs, (cuuint32_t)pl.box};
        const cuuint32_t one[2] = {1, 1};
        for (int t = 0; t < nterms && mode == kCopyTensor; ++t)
            if (encode(&maps.m[t],
                       E == 8 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT64
                              : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                       2, const_cast<S*>(terms.x[t]), dims, strides, box,
                       one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                       CU_TENSOR_MAP_SWIZZLE_NONE,
                       CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                       CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
                mode = kCopy16;
    }
    last_mode = mode;
    switch (pl.rpt) {
    case 1: return launch_rpt<S, B, 1>(terms, maps, fs, Y, Q, R, n, wsz,
                                       nqp, pl, mode, pvec, bulk_y, s);
    case 2: return launch_rpt<S, B, 2>(terms, maps, fs, Y, Q, R, n, wsz,
                                       nqp, pl, mode, pvec, bulk_y, s);
    case 3: return launch_rpt<S, B, 3>(terms, maps, fs, Y, Q, R, n, wsz,
                                       nqp, pl, mode, pvec, bulk_y, s);
    default: return (int)cudaErrorInvalidValue;
    }
}

template <class S>
int launch(const Terms<S>& terms, const long long* fs, S* Y, long long Q,
           long long R, int n, int b, int wsz, int nqp, void* stream) {
    if (n < 1 || R < 1 || wsz < 1 || nqp < 1 || Q < wsz)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (b) {
    case 1: return launch_b<S, 1>(terms, fs, Y, Q, R, n, wsz, nqp, s);
    case 3: return launch_b<S, 3>(terms, fs, Y, Q, R, n, wsz, nqp, s);
    case 5: return launch_b<S, 5>(terms, fs, Y, Q, R, n, wsz, nqp, s);
    case 7: return launch_b<S, 7>(terms, fs, Y, Q, R, n, wsz, nqp, s);
    case 9: return launch_b<S, 9>(terms, fs, Y, Q, R, n, wsz, nqp, s);
    default: return (int)cudaErrorInvalidValue;
    }
}

template <class S>
int launch_stage(const S* X, const S* P, const long long* fs, S* Y,
                 long long Q, long long R, int n, int b, int wsz, int nqp,
                 void* stream) {
    Terms<S> terms;
    terms.x[0] = X;
    terms.p[0] = P;
    terms.end[0] = 1;
    terms.groups = 1;
    return launch(terms, fs, Y, Q, R, n, b, wsz, nqp, stream);
}

// groups of one table in order of first appearance, terms in order
template <class S>
int launch_fold(const uint64_t* x_ptrs, const uint64_t* p_ptrs,
                int n_terms, const long long* fs, S* Y, long long Q,
                long long R, int n, int b, int wsz, int nqp, void* stream) {
    if (n_terms < 1 || n_terms > kMaxTerms)
        return (int)cudaErrorInvalidValue;
    Terms<S> terms;
    int q = 0, groups = 0;
    for (int u = 0; u < n_terms; ++u) {
        bool first = true;
        for (int v = 0; v < u; ++v) first = first && p_ptrs[v] != p_ptrs[u];
        if (!first) continue;
        terms.p[groups] = reinterpret_cast<const S*>(p_ptrs[u]);
        for (int t = u; t < n_terms; ++t)
            if (p_ptrs[t] == p_ptrs[u])
                terms.x[q++] = reinterpret_cast<const S*>(x_ptrs[t]);
        terms.end[groups++] = q;
    }
    terms.groups = groups;
    return launch(terms, fs, Y, Q, R, n, b, wsz, nqp, stream);
}

void plan_out(const Plan& pl, long long* out) {
    const long long v[12] = {pl.rpt, pl.run,    pl.nruns, pl.cap,
                             pl.box, pl.ps,     pl.xs,    pl.stages,
                             pl.nys, pl.rtiles, pl.cpr,   pl.smem};
    for (int k = 0; k < 12; ++k) out[k] = v[k];
}

}  // namespace win
}  // namespace

// K8: one term.  X (Q, R), P (n, b, wsz), fs (n,) int64, Y (R, b n).
PYIGA_EXPORT int pyiga_windowed_stage_f64(const double* X, const double* P,
                                          const long long* fs, double* Y,
                                          long long Q, long long R, int n,
                                          int b, int wsz, int nqp,
                                          void* stream) {
    return win::launch_stage(X, P, fs, Y, Q, R, n, b, wsz, nqp, stream);
}

// K8f: x_ptrs / p_ptrs: host arrays of n_terms device pointers (term t's
// (Q, R) field and its deduplicated table).
PYIGA_EXPORT int pyiga_windowed_fold_f64(const uint64_t* x_ptrs,
                                         const uint64_t* p_ptrs, int n_terms,
                                         const long long* fs, double* Y,
                                         long long Q, long long R, int n,
                                         int b, int wsz, int nqp,
                                         void* stream) {
    return win::launch_fold(x_ptrs, p_ptrs, n_terms, fs, Y, Q, R, n, b, wsz,
                            nqp, stream);
}

// K8 and K8f in float32 (the f32 line): the same arguments in float.
PYIGA_EXPORT int pyiga_windowed_stage_f32(const float* X, const float* P,
                                          const long long* fs, float* Y,
                                          long long Q, long long R, int n,
                                          int b, int wsz, int nqp,
                                          void* stream) {
    return win::launch_stage(X, P, fs, Y, Q, R, n, b, wsz, nqp, stream);
}

PYIGA_EXPORT int pyiga_windowed_fold_f32(const uint64_t* x_ptrs,
                                         const uint64_t* p_ptrs, int n_terms,
                                         const long long* fs, float* Y,
                                         long long Q, long long R, int n,
                                         int b, int wsz, int nqp,
                                         void* stream) {
    return win::launch_fold(x_ptrs, p_ptrs, n_terms, fs, Y, Q, R, n, b, wsz,
                            nqp, stream);
}

// The copy path of the last launch: 0 cp.async of one element (X not
// 16-byte aligned), 1 16-byte cp.async from each row's aligned start, 2
// tensor copies (TMA); -1 before the first.
PYIGA_EXPORT int pyiga_windowed_last_copy() { return win::last_mode; }

// The plan of a launch over `groups` distinct tables on `nsm` SMs, for
// comparison with cuda_sumfac.windowed_plan: out[0..11] = rpt, run,
// nruns, cap, box, ps, xs, stages, nys, rtiles, cpr, smem (smem 0: none
// fits); pyiga_windowed_plan for double elements, _plan_f32 for float.
PYIGA_EXPORT int pyiga_windowed_plan(long long Q, long long R, int n, int b,
                                     int wsz, int nqp, int groups, int nsm,
                                     long long* out) {
    win::plan_out(win::make_plan(Q, R, n, b, wsz, nqp, groups, nsm, 8), out);
    return 0;
}

PYIGA_EXPORT int pyiga_windowed_plan_f32(long long Q, long long R, int n,
                                         int b, int wsz, int nqp, int groups,
                                         int nsm, long long* out) {
    win::plan_out(win::make_plan(Q, R, n, b, wsz, nqp, groups, nsm, 4), out);
    return 0;
}
