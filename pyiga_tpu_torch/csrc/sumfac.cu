// Sum-factorization assembly kernels for Hopper (sm_90a), float64.  The
// geometry-field kernels K1 and K1' that feed them are in fields.cu.
//
// K2  stage_kernel         replaces `_stage_call` (pallas_call at :353,
//     bodies `_stage_kernel` / `_stage_kernel_acc`).
// K3  fold_kernel          replaces `_stage_call_fold` (pallas_call at
//     :781, body `_fold_kernel`).
// K7a stage_T_kernel       replaces `_stage_call_T` (pallas_call at :436,
//     body `_stage_kernel_T`); f64 tensor cores (dmma.cuh).
// K7b tail_kernel          replaces `_tail_fused_call` (pallas_call at
//     :563, body `_tail_kernel`); f64 tensor cores (dmma.cuh).
//
// The TPU kernels carry float64 as two-float f32 pairs and split every
// contraction into six bf16 mantissa chunks (21 chunk dots with exact f32
// accumulation), because the v5e has no f64 arithmetic.  Hopper has native
// f64, so these kernels compute in double directly and none of that
// machinery is ported.

#include <type_traits>

#include "common.cuh"
#include "dmma.cuh"

// --------------------------------------------------------------------------
// K2, K3 and K7a: sum-factorization stages on the f64 tensor cores.
//
// K2  stage_kernel    out[r, m] = sum_k X[k, r] T[m, k] for X (K, R) and a
//     basis-pair table T (M, K); out (R, M).  Replaces `_stage_call`
//     (pyiga_tpu/ops/pallas_sumfac.py, pallas_call at :353, bodies
//     `_stage_kernel` / `_stage_kernel_acc`).
// K3  fold_kernel     the sum over terms t of K2(X_t, T_idx[t]), written
//     once.  Replaces `_stage_call_fold` (pallas_call at :781, body
//     `_fold_kernel`).
// K7a stage_T_kernel  K2 with the transposed output out[m, r], (M, R).
//     Replaces `_stage_call_T` (pallas_call at :436, body
//     `_stage_kernel_T`); K7b then reads term t's output as (M1, K2, K3)
//     slabs with no transpose.
//
// X has the contraction axis leading and out appends the band axis last,
// so a d-stage chain maps (K_1, ..., K_d) to (M_1, ..., M_d) with no
// transposes (the chain convention of pallas_sumfac).  At the 3D n=48
// headline K = 192 and M = 357 in every stage; R = 36,864 (stage 1),
// 68,544 (stage 2) and 127,449 (K3: 6 terms over 3 distinct tables).
//
// Bounds at n=48 (67 TFLOP/s on the f64 tensor cores, 3.35 TB/s): K2 does
// 5.05 and 9.40 GFLOP over 162 and 302 MB, 0.075 and 0.140 ms of
// operations.  K3 sums the terms that share a table before the product:
// 3 x 2 x 192 x 127,449 x 357 = 52.4 GFLOP, 0.782 ms (104.8 GFLOP, 1.565
// ms, term by term) against 1.54 GB, 0.46 ms: operations.
//
// Design: one mainloop (`product`) for the three kernels, DMMA (mma.sync
// m16n8k4, dmma.cuh).  T is the A operand, staged as [m][k] tiles, X the B
// operand, staged as [k][r] tiles.  A block owns a BM (m) x BN (r) output
// tile in 8 warp tiles.  K runs in 16-deep slices through a cp.async
// pipeline; each operand takes 16-byte copies where its rows have even
// length and it is 16-byte aligned, else 8-byte ones.  Ragged K, M and R
// are zero-filled by the copies and skipped on store.  The T tile has a
// row stride of 20 doubles and the X tile BN + 4 (both 4 mod 16), so the
// fragment loads of each half-warp hit 16 distinct bank pairs.  The m
// tiles are the grid's fastest axis: the blocks that share an X tile run
// together, and X (57 to 196 MB at n=48, above the 50 MB L2) comes from
// device memory once.
//   K2 and K7a: 64 x 128 blocks of 64 x 16 warp tiles (4 x 2 DMMA tiles),
// a 3-stage pipeline, two blocks an SM (128 registers a thread, 80 KiB of
// shared memory a block).  At n=48 the m axis pads 357 to 384 (7 % of the
// products are zeros).
//   K3: the C entry orders the terms by table, groups in order of first
// appearance and terms in their given order within a group (the
// association of ops/sumfac._sum_chains_merged).  The pipeline walks
// (group, k slice, term): every step brings one X slice, the group's last
// term also the table slice.  Each thread adds the B fragments of the
// group's X slices in that order in registers, and the group runs one DMMA
// product a slice: 3 products instead of 6 at n=48.  All groups accumulate
// into the same registers and the tile is written once: no atomics, a
// fixed order, bitwise-reproducible.  Its block is 192 x 64 in 96 x 16
// warp tiles (6 x 2 DMMA tiles: 48 accumulators and 8 summed fragments a
// thread), a 4-stage pipeline (154 KiB), one block an SM.  Per group and
// slice a block reads a 192-row table slice and one 64-column X slice a
// term from L2: at n=48 5.9 GB in all, against 7.0 GB for 128 x 64 blocks
// and 8.8 GB for 64 x 128 (the X side, one slice a term, outweighs the
// table side, one a group), and the m axis pads 357 to 384 in two tiles.
// 32 x 32 warp tiles (K7a's earlier tile) spilled at two blocks an SM
// with the summed fragments; a shared-memory sum of the group's slices
// instead of the register sum was slower at every tile size tried.
//   Epilogue: the output tile is staged through the pipeline's shared
// memory.  K7a writes rows of out (M, R) along r (stride BN + 8, 8 mod 16:
// the 16-byte fragment stores of a quarter-warp cover all 32 banks).  K2
// and K3 stage the tile transposed and write rows of out (R, M) along m
// (stride BM + 2, 2 mod 16: the 8-byte stores of a half-warp, at rows 2t
// and columns g, hit 16 distinct bank pairs).  Each warp stores 256 or 512
// contiguous bytes; 16-byte stores where a row's length is even and out is
// 16-byte aligned (M = 357 is odd at n=48: 8-byte stores there).
// --------------------------------------------------------------------------

namespace {

constexpr int kMaxTerms = 16;

constexpr int cmax(int a, int b) { return a > b ? a : b; }

namespace tc {

constexpr int kBK = 16;            // contraction slice
constexpr int kThreads = 256;      // 8 warps

// A block's BM (m) x BN (r) output tile in 8 warp tiles of WM x WN (MI x
// NJ DMMA tiles), its cp.async pipeline depth, the blocks an SM holds (the
// register budget: 65,536 / (256 MINB) a thread) and its shared-memory
// layout.
template <int BM_, int BN_, int WM_, int WN_, int STAGES_, int MINB_>
struct Tile {
    static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
    static constexpr int STAGES = STAGES_, MINB = MINB_;
    static constexpr int MI = WM / 16, NJ = WN / 8;
    static constexpr int WARPS_N = BN / WN;      // warps along r
    static_assert((BM / WM) * WARPS_N == kThreads / 32, "8 warps");
    static_assert(BM % 16 == 0 && BN % 16 == 0, "strides below");
    static constexpr int PA = kBK + 4;           // T tile stride (4 mod 16)
    static constexpr int PB = BN + 4;            // X tile stride (4 mod 16)
    static constexpr int PC = BN + 8;            // [m][r] staging (8 mod 16)
    static constexpr int PCT = BM + 2;           // [r][m] staging (2 mod 16)
    static constexpr int STAGE = BM * PA + kBK * PB;
    static constexpr int SMEM =
        cmax(STAGES * STAGE, cmax(BM * PC, BN * PCT)) * (int)sizeof(double);
    // the warp's first row (m) and column (r) in the block tile
    static __device__ __forceinline__ int wm0() {
        return (int)(threadIdx.x >> 5) / WARPS_N * WM;
    }
    static __device__ __forceinline__ int wn0() {
        return (int)(threadIdx.x >> 5) % WARPS_N * WN;
    }
};
using TileMR = Tile<64, 128, 64, 16, 3, 2>;     // K2, K7a
using TileFold = Tile<192, 64, 96, 16, 4, 1>;   // K3

template <class TL>
using Acc = double[TL::MI][TL::NJ][4];

// K2, K7a: one field and one table
struct One {
    const double* x;
    const double* t;
};

// K3: the fields grouped by table (see pyiga_fold_f64)
struct Terms {
    const double* x[kMaxTerms];    // per term, its (K, R) field, in order
    const double* t[kMaxTerms];    // per group, its (M, K) table
    int end[kMaxTerms];            // per group, one past its last term
    int groups;
};

// acc += the block's (m0, r0) tile of T X (One) or of
// sum_g T_g (sum_{t in g} X_t) (Terms), in the warp's MI x NJ DMMA tiles.
// Ends with every thread past its last shared-memory read.
template <class TL, int VA, int VB, class S>
__device__ __forceinline__ void product(const S& src, int K, long long R,
                                        int M, int m0, long long r0,
                                        double* smem, Acc<TL>& acc) {
    constexpr bool kGrouped = std::is_same<S, Terms>::value;
    const int wm = TL::wm0(), wn = TL::wn0();
    const int nk = (K + kBK - 1) / kBK;
    int nsteps = nk;
    if constexpr (kGrouped) nsteps *= src.end[src.groups - 1];

    // the (group, k slice, term) of the next step to load and to compute
    struct Cursor { int g, k, q; };
    Cursor ld{0, 0, 0}, cp{0, 0, 0};
    auto advance = [&](Cursor& c) {
        if constexpr (kGrouped) {
            if (++c.q < src.end[c.g]) return;
            if (++c.k < nk) {
                c.q = c.g ? src.end[c.g - 1] : 0;
                return;
            }
            c.k = 0;                       // c.q opens the next group
            ++c.g;
        } else {
            ++c.k;
        }
    };

    auto load = [&](int buf) {
        double* As = smem + buf * TL::STAGE;
        double* Bs = As + TL::BM * TL::PA;
        const int k0 = ld.k * kBK;
        const double* X;
        const double* T;
        bool table = true;
        if constexpr (kGrouped) {          // the group's last term brings
            X = src.x[ld.q];               // the table slice
            T = src.t[ld.g];
            table = ld.q == src.end[ld.g] - 1;
        } else {
            X = src.x;
            T = src.t;
        }
        dmma::load_tile<kBK, TL::BN, VB, kThreads>(
            Bs, TL::PB, X + (long long)k0 * R + r0, R, K - k0, R - r0);
        if (table)
            dmma::load_tile<TL::BM, kBK, VA, kThreads>(
                As, TL::PA, T + (long long)m0 * K + k0, K, M - m0, K - k0);
        dmma::cp_async_commit();
        advance(ld);
    };

    // one 4-deep step of the product: a warp's MI x NJ DMMA tiles
    auto load_a4 = [&](const double* As, int kk, double (&a)[TL::MI][2]) {
#pragma unroll
        for (int i = 0; i < TL::MI; ++i)
            dmma::load_a(As, TL::PA, wm + 16 * i, kk, a[i][0], a[i][1]);
    };
    auto mma4 = [&](const double (&a)[TL::MI][2], const double (&b)[TL::NJ]) {
#pragma unroll
        for (int i = 0; i < TL::MI; ++i)
#pragma unroll
            for (int j = 0; j < TL::NJ; ++j)
                dmma::mma_16x8x4(acc[i][j], a[i][0], a[i][1], b[j]);
    };
    auto mma_slice = [&](const double* As, const double* Bs) {
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 4) {
            double a[TL::MI][2], b[TL::NJ];
            load_a4(As, kk, a);
#pragma unroll
            for (int j = 0; j < TL::NJ; ++j)
                b[j] = dmma::load_b_kn(Bs, TL::PB, kk, wn + 8 * j);
            mma4(a, b);
        }
    };

    double bsum[kBK / 4][TL::NJ];          // K3: a slice's summed fragments
#pragma unroll
    for (int s = 0; s < kBK / 4; ++s)
#pragma unroll
        for (int j = 0; j < TL::NJ; ++j) bsum[s][j] = 0.0;
    auto compute = [&](int buf) {
        const double* As = smem + buf * TL::STAGE;
        const double* Bs = As + TL::BM * TL::PA;
        if constexpr (kGrouped) {
            const bool first = cp.q == (cp.g ? src.end[cp.g - 1] : 0);
            const bool last = cp.q == src.end[cp.g] - 1;
#pragma unroll
            for (int s = 0; s < kBK / 4; ++s)
#pragma unroll
                for (int j = 0; j < TL::NJ; ++j) {
                    const double v =
                        dmma::load_b_kn(Bs, TL::PB, 4 * s, wn + 8 * j);
                    bsum[s][j] = first ? v : bsum[s][j] + v;
                }
            if (last) {
#pragma unroll
                for (int s = 0; s < kBK / 4; ++s) {
                    double a[TL::MI][2];
                    load_a4(As, 4 * s, a);
                    mma4(a, bsum[s]);
                }
            }
            advance(cp);
        } else {
            mma_slice(As, Bs);
        }
    };

    for (int s = 0; s < TL::STAGES - 1; ++s) {
        if (s < nsteps)
            load(s);
        else
            dmma::cp_async_commit();       // an empty group keeps the count
    }
    for (int st = 0; st < nsteps; ++st) {
        if (st + TL::STAGES - 1 < nsteps)
            load((st + TL::STAGES - 1) % TL::STAGES);
        else
            dmma::cp_async_commit();
        dmma::cp_async_wait<TL::STAGES - 1>();
        __syncthreads();
        compute(st % TL::STAGES);
        __syncthreads();
    }
    dmma::cp_async_wait<0>();
}

// the block's (m0, r0) and zeroed accumulators: m tiles fastest, so the
// blocks that share an X tile run together
template <class TL>
__device__ __forceinline__ void block_start(int M, int& m0, long long& r0,
                                            Acc<TL>& acc) {
    const unsigned int mt = (M + TL::BM - 1) / TL::BM;
    m0 = (int)(blockIdx.x % mt) * TL::BM;
    r0 = (long long)(blockIdx.x / mt) * TL::BN;
#pragma unroll
    for (int i = 0; i < TL::MI; ++i)
#pragma unroll
        for (int j = 0; j < TL::NJ; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0;
}

// Copy a staged ROWS x COLS tile (row stride ld) to `out` (row stride ldo),
// VEC doubles a store, skipping rows >= rlim and columns >= clim (VEC = 2
// needs an even clim and 16-byte aligned rows).
template <int ROWS, int COLS, int VEC>
__device__ __forceinline__ void write_tile(const double* Cs, int ld,
                                           double* out, long long ldo,
                                           long long rlim, long long clim) {
    constexpr int CPR = COLS / VEC;
    for (int i = threadIdx.x; i < ROWS * CPR; i += kThreads) {
        const int row = i / CPR, col = (i % CPR) * VEC;
        if (row >= rlim || col >= clim) continue;
        double* o = out + row * ldo + col;
        const double* c = Cs + row * ld + col;
        if constexpr (VEC == 2)
            *reinterpret_cast<double2*>(o) =
                *reinterpret_cast<const double2*>(c);
        else
            o[0] = c[0];
    }
}

// K7a's epilogue: the tile to out (M, R), rows along r
template <class TL>
__device__ __forceinline__ void store_mr(const Acc<TL>& acc, double* Cs,
                                         double* out, long long R, int M,
                                         int m0, long long r0, bool vec) {
    const int wm = TL::wm0(), wn = TL::wn0();
    const int g = dmma::lane_g(), t = dmma::lane_t();
#pragma unroll
    for (int i = 0; i < TL::MI; ++i)
#pragma unroll
        for (int j = 0; j < TL::NJ; ++j) {
            const int row = wm + 16 * i + g, col = wn + 8 * j + 2 * t;
            *reinterpret_cast<double2*>(Cs + row * TL::PC + col) =
                make_double2(acc[i][j][0], acc[i][j][1]);
            *reinterpret_cast<double2*>(Cs + (row + 8) * TL::PC + col) =
                make_double2(acc[i][j][2], acc[i][j][3]);
        }
    __syncthreads();
    double* o = out + (long long)m0 * R + r0;
    if (vec)                               // R is even
        write_tile<TL::BM, TL::BN, 2>(Cs, TL::PC, o, R, M - m0, R - r0);
    else
        write_tile<TL::BM, TL::BN, 1>(Cs, TL::PC, o, R, M - m0, R - r0);
}

// K2's and K3's epilogue: the tile transposed to out (R, M), rows along m
template <class TL>
__device__ __forceinline__ void store_rm(const Acc<TL>& acc, double* Cs,
                                         double* out, long long R, int M,
                                         int m0, long long r0, bool vec) {
    const int wm = TL::wm0(), wn = TL::wn0();
    const int g = dmma::lane_g(), t = dmma::lane_t();
#pragma unroll
    for (int i = 0; i < TL::MI; ++i)
#pragma unroll
        for (int j = 0; j < TL::NJ; ++j) {
            const int m = wm + 16 * i + g, r = wn + 8 * j + 2 * t;
            Cs[r * TL::PCT + m] = acc[i][j][0];
            Cs[(r + 1) * TL::PCT + m] = acc[i][j][1];
            Cs[r * TL::PCT + m + 8] = acc[i][j][2];
            Cs[(r + 1) * TL::PCT + m + 8] = acc[i][j][3];
        }
    __syncthreads();
    double* o = out + r0 * M + m0;
    if (vec)                               // M is even
        write_tile<TL::BN, TL::BM, 2>(Cs, TL::PCT, o, M, R - r0, M - m0);
    else
        write_tile<TL::BN, TL::BM, 1>(Cs, TL::PCT, o, M, R - r0, M - m0);
}

template <int VA, int VB>
__global__ void __launch_bounds__(kThreads, TileMR::MINB)
stage_kernel(const double* __restrict__ X, const double* __restrict__ T,
             int K, long long R, int M, double* __restrict__ out, int vec) {
    using TL = TileMR;
    extern __shared__ __align__(16) double smem[];
    int m0;
    long long r0;
    Acc<TL> acc;
    block_start<TL>(M, m0, r0, acc);
    product<TL, VA, VB>(One{X, T}, K, R, M, m0, r0, smem, acc);
    store_rm<TL>(acc, smem, out, R, M, m0, r0, vec);
}

template <int VA, int VB>
__global__ void __launch_bounds__(kThreads, TileFold::MINB)
fold_kernel(const __grid_constant__ Terms terms, int K, long long R, int M,
            double* __restrict__ out, int vec) {
    using TL = TileFold;
    extern __shared__ __align__(16) double smem[];
    int m0;
    long long r0;
    Acc<TL> acc;
    block_start<TL>(M, m0, r0, acc);
    product<TL, VA, VB>(terms, K, R, M, m0, r0, smem, acc);
    store_rm<TL>(acc, smem, out, R, M, m0, r0, vec);
}

template <int VA, int VB>
__global__ void __launch_bounds__(kThreads, TileMR::MINB)
stage_T_kernel(const double* __restrict__ X, const double* __restrict__ T,
               int K, long long R, int M, double* __restrict__ out,
               int vec) {
    using TL = TileMR;
    extern __shared__ __align__(16) double smem[];
    int m0;
    long long r0;
    Acc<TL> acc;
    block_start<TL>(M, m0, r0, acc);
    product<TL, VA, VB>(One{X, T}, K, R, M, m0, r0, smem, acc);
    store_mr<TL>(acc, smem, out, R, M, m0, r0, vec);
}

// One launch of `kernel` over the (M, R) output in TL's tiles.
template <class TL, class... P, class... A>
static int launch(void (*kernel)(P...), long long R, int M, cudaStream_t s,
                  A... args) {
    const long long blocks =
        (long long)((M + TL::BM - 1) / TL::BM) * ((R + TL::BN - 1) / TL::BN);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned int)blocks, kThreads, TL::SMEM, s>>>(args...);
    return (int)cudaGetLastError();
}

}  // namespace tc

// KERNEL<VA, VB>: the copy widths (1 or 2 doubles) of its T and X tiles
#define PYIGA_TC_PICK(KERNEL, VA, VB)                                       \
    ((VA) == 2 ? ((VB) == 2 ? KERNEL<2, 2> : KERNEL<2, 1>)                  \
               : ((VB) == 2 ? KERNEL<1, 2> : KERNEL<1, 1>))

struct TailTerms {
    const double* x[kMaxTerms];
    const double* t2[kMaxTerms];
    const double* t3[kMaxTerms];
    int n;
};

// --------------------------------------------------------------------------
// K7b: stage 2 and the folded final stage of all terms of a 3-axis chain
// in one kernel,
//   out[a, b, c] = sum_t sum_{j,k} x1T_t[a, j, k] T2_t[b, j] T3_t[c, k],
// x1T_t (M1, K2, K3) the K7a output of term t, T2_t (M2, K2) and T3_t
// (M3, K3) its stage-2 and stage-3 tables (deduplicated on the host),
// out (M1, M2, M3) written once.  Replaces `_tail_fused_call`
// (pyiga_tpu/ops/pallas_sumfac.py, pallas_call at :563, body
// `_tail_kernel`): the stage-2 intermediate never reaches device memory
// (6 x 357^2 x 192 x 8 B = 1.17 GB at the 3D n=48 headline).
//
// Bound at n=48 (6 terms, 3 distinct final tables, K = 192, M = 357):
// stage 2 is 56.4 GFLOP; the final stage is 52.4 GFLOP once the terms
// that share a final table are summed before it (104.8 term by term):
// 108.8 GFLOP, 1.62 ms at 67 TFLOP/s (f64 tensor cores).  It moves about
// 1.0 GB (0.3 ms), so it is compute-bound.
//
// Design.  A block owns an output slab of 32 m2 rows (one a) x 384 m3
// columns, in registers across all terms.  The C entry orders the terms
// by final table (groups in order of first appearance).  Per group the
// block (1) builds Y2[r, k] = sum_{t in group} sum_j T2_t[b0 + r, j]
// x1T_t[a, j, k] in shared memory, a (32 x 192) x (192 x 192) DMMA product
// per term over 16-deep j slices, (2) adds Y2 T3^T into the slab, a
// (32 x 192) x (192 x 384) DMMA product over 16-deep k slices; after the
// last group (3) it stores the slab once.  256 threads as 8 warps, one
// column group each: in the final stage a warp holds 32 x 48 outputs (2 x
// 6 DMMA tiles, 48 doubles a thread), in stage 2 32 x 24 of Y2 (24
// doubles).  ptxas gives the n=48 instance 255 registers a thread (65,280
// a block; about 80 bytes spill), and 192 KiB of shared memory hold Y2
// (48 KiB) and three T3 slices (144 KiB; stage 2's slices share that
// space): one block an SM.
//   What the earlier 16-row FMA kernel lost, and what this does:
//   - FMA issue: both contractions are DMMA (m16n8k4), and the summed
//     groups halve the final stage at n=48.
//   - L2 restreaming: a block streams, per group, the whole T3 table (548
//     KB) and, per term, the x1T[a] slab (295 KB) and 32 T2 rows (49 KB).
//     With 12 x 357 = 4,284 blocks (against 8,211 of 16 rows) that is 7.0
//     + 7.6 + 1.3 = 15.9 GB per assembly, against ~27 + ~14.5 GB.  The
//     slab is what the register file allows: 32 x 384 doubles are 37.5 %
//     of it, and 64 rows would need 96 accumulators a thread.  The m2
//     tiles are the grid's fastest axis, so the 12 blocks of one a run
//     together and x1T (631 MB) comes from device memory about once.
//   - Bank conflicts: the T2 and x1T tiles are padded to row strides of
//     20 and 196 doubles (4 mod 16: conflict-free fragment loads); the T3
//     slices (stride 16) and Y2 (stride 192) XOR-swizzle their columns by
//     row, so fragment loads and Y2's 16-byte stores hit distinct banks.
//     cp.async runs a 3-stage pipeline over every slice.
// K3 runs in chunks of 192 (stage 2's column width), each built and
// contracted before the next: no recomputation.  M3 above 384 splits into
// column chunks (gridDim.z), each rebuilding Y2: at n=96 (M3 = 693, two
// chunks) that is one more stage 2, 6 x 2 x 693^2 x 384^2 = 0.85 TFLOP,
// against holding a 693-column slab (twice the registers there are).
// No atomics, a fixed
// order of groups, terms and k: deterministic.
// --------------------------------------------------------------------------

namespace k7b {

constexpr int kRows = 32;          // m2 rows of a block's slab
constexpr int kThreads = 256;      // 8 warps, one column group each
constexpr int kKC = 192;           // Y2 columns (k) per chunk: 8 x 3 x 8
constexpr int kJS = 16;            // stage-2 contraction slice (over K2)
constexpr int kKS = 16;            // final-stage contraction slice (K3)
constexpr int kPT2 = kJS + 4;      // T2 tile row stride (4 mod 16)
constexpr int kPX = kKC + 4;       // x1T tile row stride (4 mod 16)
constexpr int kStages = 3;         // cp.async pipeline depth
constexpr int kS2Stage = kRows * kPT2 + kJS * kPX;

constexpr int kNT = 6;             // DMMA column tiles per warp
constexpr int kCW = 8 * 8 * kNT;   // slab columns: 8 warps x kNT x 8
constexpr int kT3Stage = kCW * kKS;  // a T3 slice, swizzled (stride 16)
constexpr int kSmem = (kRows * kKC + (kS2Stage > kT3Stage ? kS2Stage
                                                          : kT3Stage)
                                     * kStages)
                      * (int)sizeof(double);

// Y2 index: row stride kKC (0 mod 16), columns XOR-swizzled by row so
// that rows g = 0..3 of a half-warp's A-fragment loads land on distinct
// bank groups and the two rows of a quarter-warp's 16-byte stores on
// distinct halves of the banks
__device__ __forceinline__ int y2_at(int r, int k) {
    return r * kKC + (k ^ (((r & 1) << 3) | ((r & 2) << 1)));
}

template <int VEC>
__global__ void __launch_bounds__(kThreads, 1)
tail_kernel(TailTerms terms, int K2, int K3, int M2, int M3,
            double* __restrict__ out) {
    extern __shared__ __align__(16) double smem[];
    double* Y2s = smem;                    // [kRows][kKC], swizzled
    double* buf = smem + kRows * kKC;      // stage 2's or T3's slices
    const int b0 = blockIdx.x * kRows;    // the 12 m2 tiles of one a run
    const int a = blockIdx.y;              // together: x1T[a] is read once
    const int c0 = blockIdx.z * kCW;
    const int wc = threadIdx.x >> 5;       // the warp's column group
    const int g = dmma::lane_g(), t = dmma::lane_t();

    double acc[2][kNT][4];                  // [row tile][column tile]
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < kNT; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[h][i][q] = 0.0;

    // terms come grouped by their final table (pyiga_tail_fused_f64): the
    // group's stage-2 products sum into one Y2, contracted with T3 once
    for (int q0 = 0; q0 < terms.n;) {
        int q1 = q0 + 1;
        while (q1 < terms.n && terms.t3[q1] == terms.t3[q0]) ++q1;
        const double* T3 = terms.t3[q0] + (long long)c0 * K3;
        for (int kc0 = 0; kc0 < K3; kc0 += kKC) {
            // (1) stage 2: Y2[r, k] = sum_{t in group} sum_j
            //     T2_t[b0 + r, j] x1T_t[a, j, kc0 + k], one pipeline over
            //     the group's (term, j slice) pairs
            double y[2][3][4];
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int i = 0; i < 3; ++i)
#pragma unroll
                    for (int q = 0; q < 4; ++q) y[h][i][q] = 0.0;
            const int nj = (K2 + kJS - 1) / kJS;
            const int ns2 = (q1 - q0) * nj;
            auto load2 = [&](int s, int step) {
                const int term = q0 + step / nj, j0 = (step % nj) * kJS;
                double* T2s = buf + s * kS2Stage;
                double* Xs = T2s + kRows * kPT2;
                dmma::load_tile<kRows, kJS, VEC, kThreads>(
                    T2s, kPT2, terms.t2[term] + (long long)b0 * K2 + j0, K2,
                    M2 - b0, K2 - j0);
                dmma::load_tile<kJS, kKC, VEC, kThreads>(
                    Xs, kPX,
                    terms.x[term] + ((long long)a * K2 + j0) * K3 + kc0, K3,
                    K2 - j0, K3 - kc0);
                dmma::cp_async_commit();
            };
            for (int s = 0; s < kStages - 1; ++s) {
                if (s < ns2)
                    load2(s, s);
                else
                    dmma::cp_async_commit();  // an empty group keeps the count
            }
            for (int st = 0; st < ns2; ++st) {
                const int sn = st + kStages - 1;
                if (sn < ns2)
                    load2(sn % kStages, sn);
                else
                    dmma::cp_async_commit();
                dmma::cp_async_wait<kStages - 1>();
                __syncthreads();
                const double* T2s = buf + (st % kStages) * kS2Stage;
                const double* Xs = T2s + kRows * kPT2;
#pragma unroll
                for (int jj = 0; jj < kJS; jj += 4) {
                    double a[2][2], b[3];
#pragma unroll
                    for (int h = 0; h < 2; ++h)
                        dmma::load_a(T2s, kPT2, 16 * h, jj, a[h][0], a[h][1]);
#pragma unroll
                    for (int i = 0; i < 3; ++i)
                        b[i] = dmma::load_b_kn(Xs, kPX, jj, wc * 24 + 8 * i);
#pragma unroll
                    for (int h = 0; h < 2; ++h)
#pragma unroll
                        for (int i = 0; i < 3; ++i)
                            dmma::mma_16x8x4(y[h][i], a[h][0], a[h][1], b[i]);
                }
                __syncthreads();
            }
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int i = 0; i < 3; ++i) {
                    const int row = 16 * h + g, col = wc * 24 + 8 * i + 2 * t;
                    *reinterpret_cast<double2*>(Y2s + y2_at(row, col)) =
                        make_double2(y[h][i][0], y[h][i][1]);
                    *reinterpret_cast<double2*>(Y2s + y2_at(row + 8, col)) =
                        make_double2(y[h][i][2], y[h][i][3]);
                }
            __syncthreads();

            // (2) final stage: slab[r, c] +=
            //     sum_k Y2[r, k] T3[c0 + c, kc0 + k]
            const int kn = min(kKC, K3 - kc0);
            const int nks = (kn + kKS - 1) / kKS;
            auto load3 = [&](int s, int k0) {
                dmma::load_tile<kCW, kKS, VEC, kThreads, true>(
                    buf + s * kT3Stage, kKS, T3 + kc0 + k0, K3, M3 - c0,
                    kn - k0);
                dmma::cp_async_commit();
            };
            for (int s = 0; s < kStages - 1; ++s) {
                if (s < nks)
                    load3(s, s * kKS);
                else
                    dmma::cp_async_commit();
            }
            for (int ks = 0; ks < nks; ++ks) {
                const int kn2 = ks + kStages - 1;
                if (kn2 < nks)
                    load3(kn2 % kStages, kn2 * kKS);
                else
                    dmma::cp_async_commit();
                dmma::cp_async_wait<kStages - 1>();
                __syncthreads();
                const double* T3s = buf + (ks % kStages) * kT3Stage;
#pragma unroll
                for (int kk = 0; kk < kKS; kk += 4) {
                    const int k = ks * kKS + kk + t;
                    double a[2][2], b[kNT];
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        a[h][0] = Y2s[y2_at(16 * h + g, k)];
                        a[h][1] = Y2s[y2_at(16 * h + g + 8, k)];
                    }
#pragma unroll
                    for (int i = 0; i < kNT; ++i)
                        b[i] = dmma::load_b_nk_swz(T3s, kk,
                                                   wc * 8 * kNT + 8 * i);
#pragma unroll
                    for (int h = 0; h < 2; ++h)
#pragma unroll
                        for (int i = 0; i < kNT; ++i)
                            dmma::mma_16x8x4(acc[h][i], a[h][0], a[h][1],
                                             b[i]);
                }
                __syncthreads();
            }
        }
        q0 = q1;
    }
    dmma::cp_async_wait<0>();

    // (3) one store of the slab
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < kNT; ++i) {
            const int c = c0 + wc * 8 * kNT + 8 * i + 2 * t;
#pragma unroll
            for (int u = 0; u < 2; ++u) {
                const int b = b0 + 16 * h + g + 8 * u;
                if (b >= M2) continue;
                double* o = out + ((long long)a * M2 + b) * M3;
                if (c < M3) o[c] = acc[h][i][2 * u];
                if (c + 1 < M3) o[c + 1] = acc[h][i][2 * u + 1];
            }
        }
}

template <int VEC>
static int launch(const TailTerms& terms, int M1, int K2, int K3, int M2,
                  int M3, double* out, cudaStream_t s) {
    cudaError_t err = cudaFuncSetAttribute(
        tail_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned int)((M2 + kRows - 1) / kRows),
                    (unsigned int)M1,
                    (unsigned int)((M3 + kCW - 1) / kCW));
    tail_kernel<VEC><<<grid, kThreads, kSmem, s>>>(terms, K2, K3, M2, M3,
                                                       out);
    return (int)cudaGetLastError();
}

}  // namespace k7b

}  // namespace

static bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The order in which K3 and K7b visit n terms: grouped by their table
// pointer `tab[t]`, groups in order of first appearance, terms in their
// given order within a group (a fixed order: the kernels are
// deterministic).  Fills order[n] with term indices and end[g] with one
// past group g's last position; returns the number of groups.
static int group_by_table(const uint64_t* tab, int n, int* order, int* end) {
    int q = 0, groups = 0;
    for (int u = 0; u < n; ++u) {
        bool first = true;
        for (int v = 0; v < u; ++v) first = first && tab[v] != tab[u];
        if (!first) continue;
        for (int t = u; t < n; ++t)
            if (tab[t] == tab[u]) order[q++] = t;
        end[groups++] = q;
    }
    return groups;
}

PYIGA_EXPORT int pyiga_stage_f64(const double* X, const double* T, double* out,
                                 int K, long long R, int M, void* stream) {
    if (K < 1 || R < 1 || M < 1) return (int)cudaErrorInvalidValue;
    const int va = K % 2 == 0 && aligned16(T) ? 2 : 1;
    const int vb = R % 2 == 0 && aligned16(X) ? 2 : 1;
    const int vec = M % 2 == 0 && aligned16(out);
    return tc::launch<tc::TileMR>(PYIGA_TC_PICK(tc::stage_kernel, va, vb), R,
                                  M, (cudaStream_t)stream, X, T, K, R, M,
                                  out, vec);
}

// x_ptrs / t_ptrs: host arrays of n_terms device pointers (term t's field
// and its deduplicated table).
PYIGA_EXPORT int pyiga_fold_f64(const uint64_t* x_ptrs, const uint64_t* t_ptrs,
                                int n_terms, double* out, int K, long long R,
                                int M, void* stream) {
    if (n_terms < 1 || n_terms > kMaxTerms || K < 1 || R < 1 || M < 1)
        return (int)cudaErrorInvalidValue;
    int order[kMaxTerms];
    tc::Terms terms;
    terms.groups = group_by_table(t_ptrs, n_terms, order, terms.end);
    bool va = K % 2 == 0, vb = R % 2 == 0;
    for (int g = 0, q = 0; g < terms.groups; ++g) {
        terms.t[g] = reinterpret_cast<const double*>(t_ptrs[order[q]]);
        va = va && aligned16(terms.t[g]);
        for (; q < terms.end[g]; ++q) {
            terms.x[q] = reinterpret_cast<const double*>(x_ptrs[order[q]]);
            vb = vb && aligned16(terms.x[q]);
        }
    }
    const int vec = M % 2 == 0 && aligned16(out);
    return tc::launch<tc::TileFold>(
        PYIGA_TC_PICK(tc::fold_kernel, va ? 2 : 1, vb ? 2 : 1), R, M,
        (cudaStream_t)stream, terms, K, R, M, out, vec);
}

PYIGA_EXPORT int pyiga_stage_T_f64(const double* X, const double* T,
                                   double* out, int K, long long R, int M,
                                   void* stream) {
    if (K < 1 || R < 1 || M < 1) return (int)cudaErrorInvalidValue;
    const int va = K % 2 == 0 && aligned16(T) ? 2 : 1;
    const int vb = R % 2 == 0 && aligned16(X) ? 2 : 1;
    const int vec = R % 2 == 0 && aligned16(out);
    return tc::launch<tc::TileMR>(PYIGA_TC_PICK(tc::stage_T_kernel, va, vb),
                                  R, M, (cudaStream_t)stream, X, T, K, R, M,
                                  out, vec);
}

// x_ptrs / t2_ptrs / t3_ptrs: host arrays of n_terms device pointers (term
// t's (M1, K2, K3) stage-1 output and its deduplicated tables)
PYIGA_EXPORT int pyiga_tail_fused_f64(const uint64_t* x_ptrs,
                                      const uint64_t* t2_ptrs,
                                      const uint64_t* t3_ptrs, int n_terms,
                                      double* out, int M1, int K2, int K3,
                                      int M2, int M3, void* stream) {
    if (n_terms < 1 || n_terms > kMaxTerms || M1 < 1 || M2 < 1 || M3 < 1
        || K2 < 1 || K3 < 1)
        return (int)cudaErrorInvalidValue;
    if (M1 > 65535) return (int)cudaErrorInvalidValue;   // gridDim.y
    // the kernel finds the groups as runs of one final table
    int order[kMaxTerms], end[kMaxTerms];
    group_by_table(t3_ptrs, n_terms, order, end);
    TailTerms terms;
    terms.n = n_terms;
    bool vec = K2 % 2 == 0 && K3 % 2 == 0;
    for (int q = 0; q < n_terms; ++q) {
        const int t = order[q];
        terms.x[q] = reinterpret_cast<const double*>(x_ptrs[t]);
        terms.t2[q] = reinterpret_cast<const double*>(t2_ptrs[t]);
        terms.t3[q] = reinterpret_cast<const double*>(t3_ptrs[t]);
        vec = vec && aligned16(terms.x[q]) && aligned16(terms.t2[q])
              && aligned16(terms.t3[q]);
    }
    cudaStream_t s = (cudaStream_t)stream;
    if (vec) return k7b::launch<2>(terms, M1, K2, K3, M2, M3, out, s);
    return k7b::launch<1>(terms, M1, K2, K3, M2, M3, out, s);
}

PYIGA_EXPORT const char* pyiga_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
