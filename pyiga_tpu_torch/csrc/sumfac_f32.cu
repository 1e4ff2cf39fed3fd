// K2 and K3 in float32 for Hopper (sm_90a): the stage and the fold of the
// f32 line (pyiga_tpu_torch.config.set_dtype(np.float32)).
//
// K2f pyiga_stage_f32  out[r, m] = sum_k X[k, r] T[m, k] for X (K, R) and
//     a basis-pair table T (M, K); out (R, M): K2's function in float32.
// K3f pyiga_fold_f32   the sum over terms t of K2f(X_t, T_idx[t]), written
//     once, the terms that share a table summed before its product: K3's
//     function in float32.
// K2-bwd f32 / K3-bwd f32 pyiga_stage_bwd_f32  gX_i[k, r] = sum_m T_i[m, k]
//     g[r, m] for up to 16 tables T_i (M, K) and the gradient g (R, M) of
//     a stage's or a fold's output; out (G, K, R): the backward of K2f and
//     K3f, the float32 instance of sumfac.cu's stage_bwd_kernel.
// K2f and K3f launch fold_f32_kernel, K2f as its case of one term: one
// mainloop.  The backward has a kernel of its own, stage_bwd_f32_kernel
// (its design below the forward's).
//
// The JAX package's f32 line runs these contractions as XLA tensordots at
// Precision.HIGHEST (pyiga_tpu/ops/sumfac.py:55 `contract_chain` and :291
// `_contract_last`, reached through bench.py:333-361); on the TPU its
// Pallas stage kernels `_stage_call` (ops/pallas_sumfac.py:353) and
// `_stage_call_fold` (:781) carry the two-float pair of the f64 route.
// So these replace no Pallas site of their own: they are K2's and K3's
// float32 instances.  DMMA (dmma.cuh) is float64 only, and TF32 keeps
// about three decimal digits where the JAX chain is exact float32, so
// the products run on the FMA units (FFMA), in full float32.
//
// Bound: operations, on the FMA units at 67 TFLOP/s.  At the 3D n=48 f32
// line K = 192, M = 357: the two stage shapes (R = 36,864 and 68,544) do
// 14.5 GFLOP (0.216 ms) over 226 MB (0.067 ms); the fold, 3 tables of 2
// terms at R = 127,449, 52.4 GFLOP (0.782 ms) over 769 MB (0.230 ms).
// The backward's bounds are in its own section below.
//
// Design.  A step of the mainloop is (table group, k slice), and every
// step runs a product.  A block of 256 threads owns a 128 (r) x 128 (m)
// output tile: 8 warps as 4 (r) x 2 (m), a warp 32 r x 64 m, a lane 8 r x
// 8 m (64 accumulators) as two r quads 16 apart times two m quads 32
// apart; 2 blocks an SM at 128 registers.  K runs in 16-deep slices
// through a ring of 3 shared buffers.  A k step reads two float4 of the X
// slice and two of the table slice for 64 FFMA (1 byte a lane an FFMA),
// the next k's fragments read before this k's products.  These reads
// set the pace: at one wavefront a quarter-warp, an LDS.128 holds the
// SM's shared-memory port 4 cycles, so a k step's 16 take it as long as
// the warp's 64 FFMA take the FMA issue, and the fragment reads alone,
// without their FFMA, take 66-68 % of the kernel's time at the n=48
// shapes.  Wider lane tiles (8 x 16, 16 x 8) read less a FFMA but need
// 128 threads a block at 2 blocks an SM, and lose more to latency.
// The group's fields come through registers: at the start of a step each
// lane loads its part of the next step's X slice of the group's first
// two fields (one where every group has one, as K2f) (scalar loads, a warp's 32 lanes on 32 consecutive r:
// coalesced at any R and any alignment; float4 where R is a multiple of 4
// and every field 16-byte aligned; predicated and not branched around,
// so that the compiler keeps them ahead of the products), the products
// of this step run, then the lane adds them in term order (a group's
// third and later fields are loaded and added there) and stores the sum
// once into the next stage's X buffer.  The table slice, T[m, k]
// transposed into [k][m], comes by 4-byte cp.async (the table stays in
// the L2: 274 KB at M = 357), kStages - 1 steps ahead.  One barrier a
// step.  Ragged K, M and R are zero-filled on the way in and skipped on
// the way out.
// The output tile goes out through shared memory, a warp's 16 rows at a
// time, so that a warp stores runs of one row of out (R, M): 128 bytes a
// store at any M, float2 / float4 stores where M and out allow them.
// Every output element is written once, its sum over k and the groups in
// a fixed order: deterministic.  The m tiles are the grid's fastest axis,
// so the blocks that share an X tile run together and X comes from device
// memory once.  Offsets into X, T and out are 64-bit (R M passes 2^31
// elements at 3D n=96).  M = 357 pads to 384: 7 % of the FFMA are lost.
//
// The -D constants below let scripts/torch_fold_f32_variants.py rebuild
// the source with other tiles, depths and staging paths, and with parts
// cut out (PYIGA_F32_CUT: timed, never checked).

#include <type_traits>

#include "common.cuh"

#ifndef PYIGA_F32_TRQ
#define PYIGA_F32_TRQ 2         // r quads a lane, 16 apart
#endif
#ifndef PYIGA_F32_TMQ
#define PYIGA_F32_TMQ 2         // m quads a lane, 32 apart
#endif
#ifndef PYIGA_F32_WR
#define PYIGA_F32_WR 4          // warps along r (16 TRQ r each)
#endif
#ifndef PYIGA_F32_WM
#define PYIGA_F32_WM 2          // warps along m (32 TMQ m each)
#endif
#ifndef PYIGA_F32_BK
#define PYIGA_F32_BK 16         // k a slice
#endif
#ifndef PYIGA_F32_STAGES
#define PYIGA_F32_STAGES 3      // shared buffers of the ring
#endif
#ifndef PYIGA_F32_SCALAR_X
#define PYIGA_F32_SCALAR_X 0    // 1: X by scalar loads at every R
#endif
#ifndef PYIGA_F32_XASYNC
#define PYIGA_F32_XASYNC 0      // 1: X by cp.async into the ring, kStages
#endif                          // - 1 steps ahead, a pair summed in place
#ifndef PYIGA_F32_DBUF
#define PYIGA_F32_DBUF 1        // the next k's fragments read before this
#endif                          // k's FFMA, by hand (0: left to ptxas)
#ifndef PYIGA_F32_CUT
#define PYIGA_F32_CUT 0         // 1 no products, 2 no loads, 3 a group's
#endif                          // first term only, 4 no stores, 5 the
                                // fragment reads without their FFMA

namespace {
namespace f32 {

constexpr int kMaxTerms = 16;
constexpr int kTRQ = PYIGA_F32_TRQ, kTMQ = PYIGA_F32_TMQ;
constexpr int kTR = 4 * kTRQ, kTM = 4 * kTMQ;   // a lane's r and m
constexpr int kWR = PYIGA_F32_WR, kWM = PYIGA_F32_WM;
constexpr int kBR = 16 * kTRQ * kWR;    // r a block (a warp: 4 lanes of
constexpr int kBM = 32 * kTMQ * kWM;    // r by 8 of m)
constexpr int kBK = PYIGA_F32_BK;
constexpr int kThreads = 32 * kWR * kWM;
#ifdef PYIGA_F32_MINB
constexpr int kMinBlocks = PYIGA_F32_MINB;
#else
constexpr int kMinBlocks = kThreads <= 256 ? 2 : 1;
#endif
constexpr int kStages = PYIGA_F32_STAGES;
constexpr int kPR = kBR + 4;            // X slice [k][r] row stride
constexpr int kPM = kBM + 4;            // table slice [k][m] row stride
constexpr int kXSlots = PYIGA_F32_XASYNC ? 2 : 1;  // X slices a stage
constexpr int kStage = kBK * (kXSlots * kPR + kPM);     // floats
constexpr int kWMW = 32 * kTMQ;         // m a warp
constexpr int kPO = kWMW + 4;           // a warp's staged rows [16][kPO]
constexpr int kOut = kWR * kWM * 16 * kPO;
constexpr int kSmem =
    (kStages * kStage > kOut ? kStages * kStage : kOut) * (int)sizeof(float);
constexpr int kXN = kBK * kBR / kThreads;   // X floats a lane a term
constexpr int kTS = kThreads / kBK;         // table rows a pass
constexpr int kTN = (kBM + kTS - 1) / kTS;  // table copies a lane
static_assert(kStages >= 2, "the ring needs two buffers");
static_assert(kXN % 4 == 0 && kXN >= 4 && kThreads % kBR == 0,
              "a lane's X part: whole float4 at one r");
static_assert(kThreads % kBK == 0 && kTN <= 32,
              "one k of the table slice a lane, a row mask of 32 bits");

__host__ __device__ constexpr int ilog2(int n) {
    return n <= 1 ? 0 : 1 + ilog2(n / 2);
}

// the fields grouped by table; K2f is one group of one term
struct Terms {
    const float* x[kMaxTerms];    // per term, its (K, R) field, in order
    const float* t[kMaxTerms];    // per group, its (M, K) table
    int end[kMaxTerms];           // per group, one past its last term
    int groups;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
    const unsigned int d =
        static_cast<unsigned int>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
    const unsigned int d =
        static_cast<unsigned int>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// A lane's fixed place in the table slice T[m0 + m, k0 + kq] -> Ts[kq][m]:
// one k (kq) and up to kTN rows m = tid / kBK + j kTS.  The offset is
// taken once; a step adds its k0.
struct TableMap {
    long long off;                // (m0 + m) K + kq
    int rstride;                  // K kTS: row j to row j + 1
    unsigned int rows;            // bit j: row j inside the tile and M
    int kq, m;

    __device__ __forceinline__ TableMap(int K, int M, int m0) {
        kq = (int)threadIdx.x % kBK;
        m = (int)threadIdx.x / kBK;
        off = (long long)(m0 + m) * K + kq;
        rstride = K * kTS;
        rows = 0;
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
            const int mj = m + j * kTS;
            rows |= (mj < kBM && m0 + mj < M ? 1u : 0u) << j;
        }
    }

    // the copies of one slice, out of M or K zero-filled
    __device__ __forceinline__ void copy(float* Ts, const float* T, int k0,
                                         int K) const {
#if PYIGA_F32_CUT == 2
        return;
#endif
        const bool kin = kq < K - k0;
        const float* p = T + off + k0;
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
            if (kBM % kTS && m + j * kTS >= kBM) break;    // past the tile
            const bool in = kin && (rows >> j & 1u);
            cp_async4(Ts + kq * kPM + m + j * kTS,
                      in ? p + (long long)j * rstride : T, in);
        }
    }
};

// A lane's fixed place in an X slice X[k0 + kk, r0 + c] -> Xs[kk][c]:
// VB = 1, kXN scalars at c = tid % kBR and kk = tid / kBR + j kThreads /
// kBR; VB = 4, kXN / 4 float4 at c = 4 (tid % (kBR / 4)) and kk = tid /
// (kBR / 4) + j 4 kThreads / kBR.  A step adds k0 R to the offset.
template <int VB>
struct XMap {
    static constexpr int Q = kBR / VB;          // copies a row
    static constexpr int KS = kThreads / Q;     // k between a lane's copies
    static constexpr int N = kXN / VB;          // copies a lane
    long long off;                // kk R + r0 + c
    long long stride;             // KS R
    int kk, c;
    bool rin;

    __device__ __forceinline__ XMap(long long R, long long r0) {
        c = VB * ((int)threadIdx.x % Q);
        kk = (int)threadIdx.x / Q;
        off = (long long)kk * R + r0 + c;
        stride = (long long)KS * R;
        rin = r0 + c < R;         // VB = 4: R a multiple of 4, whole quads
    }

    __device__ __forceinline__ bool in(int j, int kleft) const {
        return rin && kk + j * KS < kleft;
    }

    __device__ __forceinline__ float* at(float* Xs, int j) const {
        return Xs + (kk + j * KS) * kPR + c;
    }
};

// A group's first fields, a lane's part of a slice, in registers
template <int VB>
struct XPart {
    float v[kXN];

    // load X at the slice whose offset is base (k0 R), kleft = K - k0;
    // `use` false: zeros (no load)
    __device__ __forceinline__ void load(const XMap<VB>& mp, const float* X,
                                         long long base, int kleft,
                                         bool use) {
#if PYIGA_F32_CUT == 2
        use = false;
#endif
        const float* p = X + base + mp.off;
#pragma unroll
        for (int j = 0; j < XMap<VB>::N; ++j) {
            const bool in = use && mp.in(j, kleft);
            if constexpr (VB == 1) {
                v[j] = in ? __ldg(p + j * mp.stride) : 0.0f;
            } else {
                float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                if (in) q = __ldg(reinterpret_cast<const float4*>(
                            p + j * mp.stride));
                v[4 * j] = q.x;
                v[4 * j + 1] = q.y;
                v[4 * j + 2] = q.z;
                v[4 * j + 3] = q.w;
            }
        }
    }

    __device__ __forceinline__ void add(const XPart& o) {
#pragma unroll
        for (int j = 0; j < kXN; ++j) v[j] += o.v[j];
    }

    __device__ __forceinline__ void store(const XMap<VB>& mp,
                                          float* Xs) const {
#pragma unroll
        for (int j = 0; j < XMap<VB>::N; ++j) {
            float* o = mp.at(Xs, j);
            if constexpr (VB == 1)
                *o = v[j];
            else
                *reinterpret_cast<float4*>(o) = make_float4(
                    v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
        }
    }
};

// XASYNC: a lane's part of an X slice into Xs by cp.async
template <int VB>
__device__ __forceinline__ void copy_x(const XMap<VB>& mp, float* Xs,
                                       const float* X, long long base,
                                       int kleft) {
#if PYIGA_F32_CUT == 2
    return;
#endif
    const float* p = X + base + mp.off;
#pragma unroll
    for (int j = 0; j < XMap<VB>::N; ++j) {
        const bool in = mp.in(j, kleft);
        const float* src = in ? p + j * mp.stride : X;
        if constexpr (VB == 1)
            cp_async4(mp.at(Xs, j), src, in);
        else
            cp_async16(mp.at(Xs, j), src, in);
    }
}

// XASYNC: a lane's part of Xs summed in place with its part of Xs2 (a
// group's second field, landed) and of the group's later fields, read
// from device memory, in term order
template <int VB>
__device__ __forceinline__ void sum_x(const XMap<VB>& mp, float* Xs,
                                      const float* Xs2,
                                      const float* const* later, int nlater,
                                      long long base, int kleft) {
#pragma unroll
    for (int j = 0; j < XMap<VB>::N; ++j) {
        float* o = mp.at(Xs, j);
        const float* o2 = mp.at(const_cast<float*>(Xs2), j);
        float v[VB];
#pragma unroll
        for (int u = 0; u < VB; ++u) v[u] = o[u] + o2[u];
        const bool in = mp.in(j, kleft);
#pragma unroll 1
        for (int q = 0; q < nlater; ++q)
#pragma unroll
            for (int u = 0; u < VB; ++u)
                v[u] += in ? __ldg(later[q] + base + mp.off + j * mp.stride
                                   + u)
                           : 0.0f;
#pragma unroll
        for (int u = 0; u < VB; ++u) o[u] = v[u];
    }
}

// acc += the lane's kTR x kTM part of Xs^T Ts over one slice: r rows
// ra + 16 a + {0..3}, m columns ma + 32 b + {0..3}.
__device__ __forceinline__ void mma_slice(const float* Xs, const float* Ts,
                                          int ra, int ma,
                                          float (&acc)[kTR][kTM]) {
#if PYIGA_F32_CUT == 1
    return;
#endif
    float xv[2][kTR], tv[2][kTM];
    auto put = [](float* d, float4 v) {
        d[0] = v.x;
        d[1] = v.y;
        d[2] = v.z;
        d[3] = v.w;
    };
    auto frags = [&](int k, int b) {
#pragma unroll
        for (int a = 0; a < kTRQ; ++a)
            put(xv[b] + 4 * a, *reinterpret_cast<const float4*>(
                                   Xs + k * kPR + ra + 16 * a));
#pragma unroll
        for (int q = 0; q < kTMQ; ++q)
            put(tv[b] + 4 * q, *reinterpret_cast<const float4*>(
                                   Ts + k * kPM + ma + 32 * q));
    };
    if (PYIGA_F32_DBUF) frags(0, 0);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
        const int b = PYIGA_F32_DBUF ? k & 1 : 0;
        if (!PYIGA_F32_DBUF)
            frags(k, 0);
        else if (k + 1 < kBK)
            frags(k + 1, b ^ 1);
#if PYIGA_F32_CUT == 5
#pragma unroll
        for (int i = 0; i < kTR; ++i) acc[i][0] += xv[b][i];
#pragma unroll
        for (int j = 0; j < kTM; ++j) acc[0][j] += tv[b][j];
        continue;
#endif
#pragma unroll
        for (int i = 0; i < kTR; ++i)
#pragma unroll
            for (int j = 0; j < kTM; ++j)
                acc[i][j] = fmaf(xv[b][i], tv[b][j], acc[i][j]);
    }
}

// PRE: the terms of a group whose X slices are fetched ahead (1 where
// every group has one term: K2f; else 2).  lvo: log2 of the output
// store's width in floats (0, 1 or 2).
template <int VB, int PRE>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fold_f32_kernel(const __grid_constant__ Terms terms, int K, long long R,
                int M, float* __restrict__ out, int lvo) {
    extern __shared__ __align__(16) float smem[];
    const int warp = (int)threadIdx.x / 32, lane = (int)threadIdx.x % 32;
    const int wr = 16 * kTRQ * (warp % kWR), wm = kWMW * (warp / kWR);
    const int ra = wr + 4 * (lane / 8), ma = wm + 4 * (lane % 8);
    const unsigned int mt = (M + kBM - 1) / kBM;
    const int m0 = (int)(blockIdx.x % mt) * kBM;
    const long long r0 = (long long)(blockIdx.x / mt) * kBR;
    float acc[kTR][kTM];
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int j = 0; j < kTM; ++j) acc[i][j] = 0.0f;

    const TableMap tm(K, M, m0);
    const XMap<VB> xm(R, r0);
    const int nsteps = (K + kBK - 1) / kBK * terms.groups;
    auto xbuf = [&](int s) { return smem + (s % kStages) * kStage; };
    auto tbuf = [&](int s) { return xbuf(s) + kXSlots * kBK * kPR; };
    // a step: (group g, slice at k0); the table's copies and the fields'
    // loads and sums each walk the steps with a cursor of their own
    struct Cursor {
        int g, k0;
        __device__ __forceinline__ void advance(int K) {
            if ((k0 += kBK) >= K) {
                k0 = 0;
                ++g;
            }
        }
    };
    Cursor tc{0, 0};
    auto copy_table = [&](int s) {
        tm.copy(tbuf(s), terms.t[tc.g], tc.k0, K);
    };
#if PYIGA_F32_XASYNC
    Cursor sc{0, 0};
    auto load_step = [&](int s) {
        const int q0 = tc.g ? terms.end[tc.g - 1] : 0;
        const long long base = (long long)tc.k0 * R;
        copy_x<VB>(xm, xbuf(s), terms.x[q0], base, K - tc.k0);
        if (PRE > 1 && PYIGA_F32_CUT != 3 && q0 + 1 < terms.end[tc.g])
            copy_x<VB>(xm, xbuf(s) + kBK * kPR, terms.x[q0 + 1], base,
                       K - tc.k0);
        copy_table(s);
        tc.advance(K);
    };
    auto sum_step = [&](int s) {
        const int q0 = sc.g ? terms.end[sc.g - 1] : 0;
        const int q1 = PYIGA_F32_CUT == 3 ? q0 + 1 : terms.end[sc.g];
        if (PRE > 1 && q1 > q0 + 1)
            sum_x<VB>(xm, xbuf(s), xbuf(s) + kBK * kPR, terms.x + q0 + 2,
                      q1 - q0 - 2, (long long)sc.k0 * R, K - sc.k0);
        sc.advance(K);
    };
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < nsteps) load_step(s);
        cp_async_commit();              // an empty group keeps the count
    }
    cp_async_wait<kStages - 2>();
    sum_step(0);
    __syncthreads();
    for (int s = 0; s < nsteps; ++s) {
        if (s + kStages - 1 < nsteps) load_step(s + kStages - 1);
        cp_async_commit();
        mma_slice(xbuf(s), tbuf(s), ra, ma, acc);
        cp_async_wait<kStages - 2>();
        if (s + 1 < nsteps) sum_step(s + 1);
        __syncthreads();
    }
#else
    // the fields through registers: at the start of a step the lane loads
    // its part of the next step's slice of the group's first PRE fields
    // (predicated, no branch: the loads stay ahead of the products), then
    // adds them in term order, loads and adds the group's later fields,
    // and stores the sum into the next stage's X buffer
    Cursor xc{0, 0};
    XPart<VB> xr[PRE];
    auto issue_x = [&](bool use) {
        const int g = use ? xc.g : 0;
        const int q0 = g ? terms.end[g - 1] : 0;
        const int n = terms.end[g] - q0;
        const long long base = (long long)xc.k0 * R;
#pragma unroll
        for (int p = 0; p < PRE; ++p)
            xr[p].load(xm, terms.x[q0 + (p < n ? p : 0)], base, K - xc.k0,
                       use && p < n && (p == 0 || PYIGA_F32_CUT != 3));
    };
    auto store_x = [&](int s) {
        const int q0 = xc.g ? terms.end[xc.g - 1] : 0;
        const int q1 = PYIGA_F32_CUT == 3 ? q0 + 1 : terms.end[xc.g];
        const long long base = (long long)xc.k0 * R;
#pragma unroll
        for (int p = 1; p < PRE; ++p) xr[0].add(xr[p]);   // zeros past q1
#pragma unroll 1
        for (int q = q0 + PRE; q < q1; ++q) {
            XPart<VB> later;
            later.load(xm, terms.x[q], base, K - xc.k0, true);
            xr[0].add(later);
        }
        xr[0].store(xm, xbuf(s));
        xc.advance(K);
    };

    for (int s = 0; s < kStages - 1; ++s) {
        if (s < nsteps) {
            copy_table(s);
            tc.advance(K);
        }
        cp_async_commit();              // an empty group keeps the count
    }
    issue_x(true);
    store_x(0);
    cp_async_wait<kStages - 2>();
    __syncthreads();
    for (int s = 0; s < nsteps; ++s) {
        if (s + kStages - 1 < nsteps) {
            copy_table(s + kStages - 1);
            tc.advance(K);
        }
        cp_async_commit();
        const bool more = s + 1 < nsteps;
        issue_x(more);
        mma_slice(xbuf(s), tbuf(s), ra, ma, acc);
        if (more) store_x(s + 1);
        cp_async_wait<kStages - 2>();
        __syncthreads();
    }
#endif
    cp_async_wait<0>();

    // The tile to out (R, M) through shared memory: a warp stages 16 of
    // its rows (one r quad of each lane) at a time, then stores each row's
    // kWMW m as runs of 2^lvo floats (32 lanes: 128 bytes of one row a
    // store at lvo = 0).
    static_assert(1 << ilog2(kWMW) == kWMW, "a warp's m: a power of 2");
    const int lpr = ilog2(kWMW) - lvo;          // stores a row: 2^lpr
    float* W = smem + warp * 16 * kPO;
#pragma unroll
    for (int h = 0; h < kTRQ; ++h) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float* w = W + (4 * (lane / 8) + i) * kPO + 4 * (lane % 8);
#pragma unroll
            for (int b = 0; b < kTMQ; ++b)
                *reinterpret_cast<float4*>(w + 32 * b) = make_float4(
                    acc[4 * h + i][4 * b], acc[4 * h + i][4 * b + 1],
                    acc[4 * h + i][4 * b + 2], acc[4 * h + i][4 * b + 3]);
        }
        __syncwarp();
        for (int e = lane; e < 16 << lpr; e += 32) {
            const int q = e >> lpr, c = (e & ((1 << lpr) - 1)) << lvo;
            const long long r = r0 + wr + 16 * h + q;
            const int m = m0 + wm + c;
            if (r >= R || m >= M) continue;    // M a multiple of 2^lvo
            const float* w = W + q * kPO + c;
            float* o = out + r * M + m;
#if PYIGA_F32_CUT == 4
            if (w[0] != 1.5e38f) continue;     // never stores; keeps the sums
#endif
            if (lvo == 2)
                *reinterpret_cast<float4*>(o) =
                    *reinterpret_cast<const float4*>(w);
            else if (lvo == 1)
                *reinterpret_cast<float2*>(o) =
                    *reinterpret_cast<const float2*>(w);
            else
                *o = *w;
        }
        __syncwarp();
    }
}

int launch(const Terms& terms, int K, long long R, int M, float* out,
           void* stream) {
    if (K < 1 || R < 1 || M < 1) return (int)cudaErrorInvalidValue;
    const long long blocks = (long long)((M + kBM - 1) / kBM)
                             * ((R + kBR - 1) / kBR);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    bool vb = !PYIGA_F32_SCALAR_X && R % 4 == 0;
    for (int q = 0; q < terms.end[terms.groups - 1]; ++q)
        vb = vb && aligned16(terms.x[q]);
    bool pairs = false;
    for (int g = 0; g < terms.groups; ++g)
        pairs = pairs || terms.end[g] - (g ? terms.end[g - 1] : 0) > 1;
    const uintptr_t o = reinterpret_cast<uintptr_t>(out);
    const int lvo = M % 4 == 0 && o % 16 == 0 ? 2
                  : M % 2 == 0 && o % 8 == 0 ? 1 : 0;
    auto kernel = vb ? (pairs ? fold_f32_kernel<4, 2> : fold_f32_kernel<4, 1>)
                     : (pairs ? fold_f32_kernel<1, 2> : fold_f32_kernel<1, 1>);
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned int)blocks, kThreads, kSmem, (cudaStream_t)stream>>>(
        terms, K, R, M, out, lvo);
    return (int)cudaGetLastError();
}

}  // namespace f32

// --------------------------------------------------------------------------
// K2-bwd f32 / K3-bwd f32  stage_bwd_f32_kernel: the backward of a stage
// for G >= 1 tables of one gradient at once,
//   gX_i[k, r] = sum_m T_i[m, k] g[r, m],
// T_i (M, K) the stage's tables, g (R, M) the gradient of its output, gX
// (G, K, R) written once.  No Pallas site: the JAX package differentiates
// the XLA forms of K2 / K3 (pyiga_tpu/diff.py); sumfac.cu's
// stage_bwd_kernel is the float64 instance.
//
// Bound: operations, 2 K R M a table on the FMA units at 67 TFLOP/s.  At
// the 3D n=48 gradient's compact chain (K = 192, M = 345) the two stage
// shapes (R = 36,864 and 66,240) do 13.7 GFLOP, 0.2039 ms; the fold (3
// tables, R = 119,025) 47.3 GFLOP, 0.7060 ms.  2D n=128: the stage
// (512, 512, 905) 0.47 GFLOP, 0.0071 ms; the fold (512, 905, 905) 0.84
// GFLOP a table.
//
// Design.
//   - the block's rows are K: one tile spans all of K = 192 with no
//     padded row (a 128-row tile would put a quarter of the second tile's
//     products on zeros).  Tile192: 192 (k) x 128 (r), 16 x 16 lanes of
//     12 k x 8 r (96 accumulators), one block an SM; Tile128 (K = 512 at
//     2D n=128, 4 k tiles, none padded; one block an SM: at two, 128
//     registers spill) and Tile64 (K <= 64) run 8 x 8 a lane.  The plan
//     (cuda_sumfac.stage_bwd_f32_plan, over the geometry that
//     pyiga_stage_bwd_f32_tiles reports) takes the tile that pads K
//     least, the larger on a tie, as stage_bwd_kernel's pick_tile;
//   - a lane's k rows are TKQ quads 4 LK apart and its r columns two quads
//     4 LR apart, so that the 8 lanes of a quarter-warp read 8 consecutive
//     16-byte chunks of the T slice and one of the g slice.  A step of m
//     reads TKQ + 2 float4 for 8 TK FFMA: at 12 x 8, 5 LDS.128 (20 cycles
//     of the SM's shared-memory port, 4 a quarter-warp wavefront) for 96
//     FFMA (24 cycles of the FMA issue a warp), where the forward's 8 x 8
//     is 16 against 16.  The next m's fragments are read before this m's
//     products;
//   - T_i's 16-deep slice is 16 rows of contiguous K: 16-byte cp.async
//     (.cg: the tables stay in the L2) where K is a multiple of 4 and
//     the tables 16-byte aligned, else 4-byte.  g must be transposed to
//     [m][r]; its rows are 4 M bytes with M odd at the paths' shapes, so
//     it comes by 4-byte cp.async, a warp's lanes on 8 m of 4 rows (8
//     lanes read 32 contiguous bytes), into a [m][r] slice of stride BR +
//     4 (4 mod 32): the transposed stores land on bank (4 m + r) mod 32,
//     distinct for the 32 lanes, and the fragment reads stay 16-byte
//     aligned.  Both operands walk M through a ring of 3 buffers, kStages
//     - 1 slices ahead, one barrier a slice; ragged K, R and M are
//     zero-filled by the copies and skipped on the way out;
//   - the grid runs (table, k tile, chunk, r tile) with the table
//     fastest, so the blocks that read one g slab run together and g
//     comes from device memory once a launch;
//   - where the output tiles cannot fill the card (ceil(K / BK) ceil(R /
//     BR) G blocks within half a wave; 2D n=128's stage has 16), the plan
//     splits M into as many chunks as fit one wave, on 16-deep slice
//     bounds (a second wave of shorter chunks would take as long).  Chunk
//     c's blocks write their partial tiles to scratch (S, G, K, R) and a
//     second pass
//     (chunk_sum_f32_kernel) sums the chunks in chunk order: no float
//     atomics, every output element summed in one fixed order, bitwise the
//     same on a repeat.  The entry refuses a plan it cannot run;
//   - the epilogue stages the tile through shared memory in TKQ passes of
//     4 LK rows (row kq's r chunk at chunk ^ ((kq >> 2) & 7): conflict-
//     free float4 stores and row reads), then a warp writes 32 consecutive
//     r of one row.  Offsets into g, out and scratch are 64-bit.
// The -D constants below let scripts/torch_stage_bwd_f32_variants.py
// rebuild the source with other lane tiles (Tile192's TKQ), r widths and
// depths, and with parts cut out (PYIGA_BWD32_CUT: timed, never checked).

#ifndef PYIGA_BWD32_TKQ
#define PYIGA_BWD32_TKQ 3       // Tile192: k quads a lane (48 / TKQ lanes
#endif                          // along k)
#ifndef PYIGA_BWD32_LR
#define PYIGA_BWD32_LR 16       // Tile192: lanes along r, 8 r each
#endif
#ifndef PYIGA_BWD32_T128_TKQ
#define PYIGA_BWD32_T128_TKQ 2  // Tile128: k quads a lane (32 / TKQ lanes
#endif                          // along k)
#ifndef PYIGA_BWD32_T128_LR
#define PYIGA_BWD32_T128_LR 16  // Tile128: lanes along r
#endif
#ifndef PYIGA_BWD32_STAGES
#define PYIGA_BWD32_STAGES 3    // shared buffers of the ring
#endif
#ifndef PYIGA_BWD32_DBUF
#define PYIGA_BWD32_DBUF 1      // the next m's fragments read before this
#endif                          // m's FFMA
#ifndef PYIGA_BWD32_CUT
#define PYIGA_BWD32_CUT 0       // 1 no products, 2 no copies, 3 no stores,
#endif                          // 4 the fragment reads without their FFMA

namespace bwd32 {

constexpr int kMaxTables = 16;
constexpr int kMaxChunks = 64;
constexpr int kSlice = 16;              // m a slice
constexpr int kStages = PYIGA_BWD32_STAGES;

constexpr int cmax(int a, int b) { return a > b ? a : b; }

struct Args {
    const float* t[kMaxTables];  // the distinct (M, K) tables
    int n;                       // tables
    int chunks;                  // S
    int bounds[kMaxChunks + 1];  // chunk c: m in [bounds[c], bounds[c + 1])
};

// A block's BK (k) x BR (r) output tile: LK x LR lanes, a lane TK k (TKQ
// quads 4 LK apart) by 8 r (two quads 4 LR apart); MINB blocks an SM.
template <int TKQ_, int LK_, int LR_, int MINB_>
struct Tile {
    static constexpr int TKQ = TKQ_, LK = LK_, LR = LR_, MINB = MINB_;
    static constexpr int TK = 4 * TKQ, BK = TK * LK, BR = 8 * LR;
    static constexpr int THREADS = LK * LR;
    static constexpr int PK = BK;            // [m][k] T slice row stride
    static constexpr int PR = BR + 4;        // [m][r] g slice (4 mod 32)
    static constexpr int OUT = 4 * LK * BR;  // a pass of the epilogue
    static constexpr int STAGE = kSlice * (PK + PR);
    static constexpr int SMEM =
        cmax(kStages * STAGE, OUT) * (int)sizeof(float);
    static_assert(THREADS % 64 == 0 && BR % 32 == 0,
                  "whole warp pairs, r chunks in groups of 8");
};
using Tile192 = Tile<PYIGA_BWD32_TKQ, 48 / PYIGA_BWD32_TKQ, PYIGA_BWD32_LR,
                     1>;                 // K = 192 (n=48)
using Tile128 = Tile<PYIGA_BWD32_T128_TKQ, 32 / PYIGA_BWD32_T128_TKQ,
                     PYIGA_BWD32_T128_LR, 1>;    // K = 512 (2D n=128)
using Tile64 = Tile<2, 8, 16, 2>;        // K <= 64

__device__ __forceinline__ void put4(float* d, float4 v) {
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
}

// VA: the T copies' width in floats (4: K a multiple of 4 and every
// table 16-byte aligned).  Writes out (G, K, R), or with S > 1 chunks
// each chunk's partial tile to scratch (S, G, K, R).
template <class TL, int VA>
__global__ void __launch_bounds__(TL::THREADS, TL::MINB)
stage_bwd_f32_kernel(const __grid_constant__ Args a,
                     const float* __restrict__ g, int K, long long R, int M,
                     float* __restrict__ out, float* __restrict__ scratch) {
    extern __shared__ __align__(16) float smem[];
    constexpr int TK = TL::TK, BK = TL::BK, BR = TL::BR, LK = TL::LK;
    constexpr int PK = TL::PK, PR = TL::PR, THREADS = TL::THREADS;
    const int tid = (int)threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    // tables fastest, then k tiles, chunks and r tiles: the blocks that
    // read one g slab run together
    const unsigned int kt = (K + BK - 1) / BK;
    unsigned int b = blockIdx.x;
    const int i = (int)(b % (unsigned int)a.n);
    b /= (unsigned int)a.n;
    const int k0 = (int)(b % kt) * BK;
    b /= kt;
    const int c = (int)(b % (unsigned int)a.chunks);
    const long long r0 = (long long)(b / (unsigned int)a.chunks) * BR;
    const int mb = a.bounds[c], me = a.bounds[c + 1];
    const int ns = (me - mb + kSlice - 1) / kSlice;
    const int kl = tid % LK, rl = tid / LK;
    auto tbuf = [&](int s) { return smem + (s % kStages) * TL::STAGE; };
    auto gbuf = [&](int s) { return tbuf(s) + kSlice * PK; };

    // T's 16-deep slice: 16 rows of contiguous k, [m][k]
    constexpr int CPR = BK / VA;                    // copies a row
    constexpr int TN = (kSlice * CPR + THREADS - 1) / THREADS;
    auto copy_t = [&](const float* T, float* Ts, int m0) {
#if PYIGA_BWD32_CUT == 2
        return;
#endif
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int e = tid + j * THREADS;
            if (kSlice * CPR % THREADS && e >= kSlice * CPR) break;
            const int m = e / CPR, kk = (e % CPR) * VA;
            const bool in = m0 + m < me && k0 + kk < K;
            const float* src = in ? T + (long long)(m0 + m) * K + k0 + kk : T;
            if constexpr (VA == 4)
                f32::cp_async16(Ts + m * PK + kk, src, in);
            else
                f32::cp_async4(Ts + m * PK + kk, src, in);
        }
    };
    // g's slice transposed, [m][r]: a warp's lanes take 8 m of 4 rows (8
    // lanes read 32 bytes of a g row), stored at bank (4 m + r) mod 32
    // (PR = 4 mod 32): no two lanes on one bank
    constexpr int RSTEP = THREADS / 16;             // rows between copies
    constexpr int GN = (BR + RSTEP - 1) / RSTEP;
    const int gm = 8 * (warp % 2) + lane % 8, gr = 4 * (warp / 2) + lane / 8;
    const long long goff = (r0 + gr) * M + gm;
    auto copy_g = [&](float* Gs, int m0) {
#if PYIGA_BWD32_CUT == 2
        return;
#endif
        const bool mok = m0 + gm < me;
#pragma unroll
        for (int j = 0; j < GN; ++j) {
            const int r = gr + j * RSTEP;
            if (BR % RSTEP && r >= BR) break;
            const bool in = mok && r0 + r < R;
            f32::cp_async4(Gs + gm * PR + r,
                           in ? g + goff + m0 + (long long)j * RSTEP * M : g,
                           in);
        }
    };

    float acc[TK][8];
    // acc += the lane's TK x 8 part of Ts^T Gs over one slice: k rows 4 kl
    // + 4 LK q + {0..3}, r columns 4 rl + 4 LR h + {0..3}
    auto product = [&](const float* Ts, const float* Gs) {
#if PYIGA_BWD32_CUT == 1
        return;
#endif
        float av[2][TK], bv[2][8];
        auto frags = [&](int m, int u) {
#pragma unroll
            for (int q = 0; q < TL::TKQ; ++q)
                put4(av[u] + 4 * q, *reinterpret_cast<const float4*>(
                                        Ts + m * PK + 4 * kl + 4 * LK * q));
#pragma unroll
            for (int h = 0; h < 2; ++h)
                put4(bv[u] + 4 * h,
                     *reinterpret_cast<const float4*>(
                         Gs + m * PR + 4 * rl + 4 * TL::LR * h));
        };
        if (PYIGA_BWD32_DBUF) frags(0, 0);
#pragma unroll
        for (int m = 0; m < kSlice; ++m) {
            const int u = PYIGA_BWD32_DBUF ? m & 1 : 0;
            if (!PYIGA_BWD32_DBUF)
                frags(m, 0);
            else if (m + 1 < kSlice)
                frags(m + 1, u ^ 1);
#if PYIGA_BWD32_CUT == 4
#pragma unroll
            for (int x = 0; x < TK; ++x) acc[x][0] += av[u][x];
#pragma unroll
            for (int y = 0; y < 8; ++y) acc[0][y] += bv[u][y];
            continue;
#endif
#pragma unroll
            for (int x = 0; x < TK; ++x)
#pragma unroll
                for (int y = 0; y < 8; ++y)
                    acc[x][y] = fmaf(av[u][x], bv[u][y], acc[x][y]);
        }
    };

    const long long KR = (long long)K * R;
    const int rn = (int)(R - r0 < BR ? R - r0 : BR);
    const float* T = a.t[i];
#pragma unroll
    for (int x = 0; x < TK; ++x)
#pragma unroll
        for (int y = 0; y < 8; ++y) acc[x][y] = 0.0f;
    auto load = [&](int s) {
        copy_t(T, tbuf(s), mb + s * kSlice);
        copy_g(gbuf(s), mb + s * kSlice);
    };
    // one barrier a slice: it publishes slice s and frees the buffer
    // of slice s - 1, which the copies of slice s + kStages - 1 refill
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < ns) load(s);
        f32::cp_async_commit();         // an empty group keeps the count
    }
    for (int s = 0; s < ns; ++s) {
        f32::cp_async_wait<kStages - 2>();
        __syncthreads();
        if (s + kStages - 1 < ns) load(s + kStages - 1);
        f32::cp_async_commit();
        product(tbuf(s), gbuf(s));
    }
    f32::cp_async_wait<0>();
    __syncthreads();                    // the epilogue reuses the ring

    // the tile to its (K, R) rows in TKQ passes of 4 LK rows through
    // shared memory: row kq's r chunk cc at cc ^ ((kq >> 2) & 7), so
    // that a quarter-warp's float4 stores (8 lanes of consecutive kl)
    // and a warp's reads of 32 r of one row hit distinct banks; a warp
    // then stores 32 consecutive r of one row
    float* dst = (a.chunks > 1 ? scratch + (long long)c * a.n * KR : out)
                 + (long long)i * KR;
    float* Cs = smem;
#pragma unroll
    for (int q = 0; q < TL::TKQ; ++q) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int kq = 4 * kl + j, sw = kl & 7;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int cc = rl + TL::LR * h;
                *reinterpret_cast<float4*>(Cs + kq * BR + 4 * (cc ^ sw)) =
                    make_float4(acc[4 * q + j][4 * h],
                                acc[4 * q + j][4 * h + 1],
                                acc[4 * q + j][4 * h + 2],
                                acc[4 * q + j][4 * h + 3]);
            }
        }
        __syncthreads();
        const int kb = k0 + 4 * LK * q, kn = K - kb;
        for (int e = tid; e < TL::OUT; e += THREADS) {
            const int kq = e / BR, r = e % BR;
            if (kq >= kn || r >= rn) continue;
            const float v =
                Cs[kq * BR + 4 * ((r >> 2) ^ ((kq >> 2) & 7)) + (r & 3)];
#if PYIGA_BWD32_CUT == 3
            if (v != 1.5e38f) continue;   // never stores; keeps the sums
#endif
            dst[(long long)(kb + kq) * R + r0 + r] = v;
        }
        __syncthreads();
    }
}

// The split's second pass: out[e] = the S chunks' partials of e summed in
// chunk order, part (S, n); V floats a thread and step
template <int V>
__global__ void __launch_bounds__(256)
chunk_sum_f32_kernel(const float* __restrict__ part, float* __restrict__ out,
                     long long n, int S) {
    using Vec = typename std::conditional<V == 4, float4, float>::type;
    const long long nv = n / V;
    const Vec* p = reinterpret_cast<const Vec*>(part);
    Vec* o = reinterpret_cast<Vec*>(out);
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         e < nv; e += (long long)gridDim.x * blockDim.x) {
        Vec s = p[e];
        for (int k = 1; k < S; ++k) {
            const Vec v = p[(long long)k * nv + e];
            if constexpr (V == 4) {
                s.x += v.x;
                s.y += v.y;
                s.z += v.z;
                s.w += v.w;
            } else {
                s += v;
            }
        }
        o[e] = s;
    }
}

template <class TL>
int launch(const Args& a, const float* g, float* out, float* scratch, int K,
           long long R, int M, cudaStream_t stream) {
    bool va = K % 4 == 0;
    for (int i = 0; i < a.n; ++i) va = va && aligned16(a.t[i]);
    auto kernel = va ? stage_bwd_f32_kernel<TL, 4>
                     : stage_bwd_f32_kernel<TL, 1>;
    const long long blocks = (long long)a.n
                             * ((K + TL::BK - 1) / TL::BK) * a.chunks
                             * ((R + TL::BR - 1) / TL::BR);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned int)blocks, TL::THREADS, TL::SMEM, stream>>>(
        a, g, K, R, M, out, scratch);
    if (a.chunks > 1) {
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        const long long n = (long long)a.n * K * R;
        const bool v4 = n % 4 == 0 && aligned16(scratch) && aligned16(out);
        const unsigned int grid = pyiga_grid_1d(v4 ? n / 4 : n, 256);
        if (v4)
            chunk_sum_f32_kernel<4><<<grid, 256, 0, stream>>>(scratch, out, n,
                                                              a.chunks);
        else
            chunk_sum_f32_kernel<1><<<grid, 256, 0, stream>>>(scratch, out, n,
                                                              a.chunks);
    }
    return (int)cudaGetLastError();
}

}  // namespace bwd32
}  // namespace

// K2f: one field X (K, R) and one table T (M, K) -> out (R, M).
PYIGA_EXPORT int pyiga_stage_f32(const float* X, const float* T, float* out,
                                 int K, long long R, int M, void* stream) {
    f32::Terms terms;
    terms.x[0] = X;
    terms.t[0] = T;
    terms.end[0] = 1;
    terms.groups = 1;
    return f32::launch(terms, K, R, M, out, stream);
}

// K3f.  x_ptrs / t_ptrs: host arrays of n_terms device pointers (term t's
// field and its deduplicated table).
PYIGA_EXPORT int pyiga_fold_f32(const uint64_t* x_ptrs, const uint64_t* t_ptrs,
                                int n_terms, float* out, int K, long long R,
                                int M, void* stream) {
    if (n_terms < 1 || n_terms > f32::kMaxTerms)
        return (int)cudaErrorInvalidValue;
    int order[f32::kMaxTerms];
    f32::Terms terms;
    terms.groups = group_by_table(t_ptrs, n_terms, order, terms.end);
    for (int g = 0, q = 0; g < terms.groups; ++g) {
        terms.t[g] = reinterpret_cast<const float*>(t_ptrs[order[q]]);
        for (; q < terms.end[g]; ++q)
            terms.x[q] = reinterpret_cast<const float*>(x_ptrs[order[q]]);
    }
    return f32::launch(terms, K, R, M, out, stream);
}

// K2-bwd f32 / K3-bwd f32: gX_i[k, r] = sum_m T_i[m, k] g[r, m] for up to
// 16 distinct tables T_i (M, K) (t_ptrs: a host array of their device
// pointers) and the output's gradient g (R, M); out (n_tables, K, R),
// table i's gradient at out + i K R.  The plan (cuda_sumfac.
// stage_bwd_f32_plan over pyiga_stage_bwd_f32_tiles): `tile` (0 Tile192,
// 1 Tile128, 2 Tile64) and n_chunks chunks of M, chunk c over m in
// [bounds[c], bounds[c + 1])
// (bounds: a host array of n_chunks + 1 ints, 0 first and M last, every
// inner bound a multiple of 16); with n_chunks > 1 the chunks' partials go
// to scratch (n_chunks, n_tables, K, R) and a second pass sums them into
// out in chunk order.  A plan the kernel cannot run is refused
// (cudaErrorInvalidValue), never replaced.
PYIGA_EXPORT int pyiga_stage_bwd_f32(const uint64_t* t_ptrs, int n_tables,
                                     const float* g, float* out, int K,
                                     long long R, int M, int tile,
                                     int n_chunks, const int* bounds,
                                     float* scratch, void* stream) {
    using namespace bwd32;
    if (n_tables < 1 || n_tables > kMaxTables || K < 1 || R < 1 || M < 1
        || n_chunks < 1 || n_chunks > kMaxChunks || bounds == nullptr
        || (n_chunks > 1 && scratch == nullptr))
        return (int)cudaErrorInvalidValue;
    Args a;
    a.n = n_tables;
    a.chunks = n_chunks;
    for (int i = 0; i < n_tables; ++i)
        a.t[i] = reinterpret_cast<const float*>(t_ptrs[i]);
    if (bounds[0] != 0 || bounds[n_chunks] != M)
        return (int)cudaErrorInvalidValue;
    for (int c = 0; c <= n_chunks; ++c) {
        if (c > 0 && bounds[c] <= bounds[c - 1])
            return (int)cudaErrorInvalidValue;
        if (c < n_chunks && bounds[c] % kSlice)
            return (int)cudaErrorInvalidValue;
        a.bounds[c] = bounds[c];
    }
    cudaStream_t s = (cudaStream_t)stream;
    switch (tile) {
    case 0:
        return launch<Tile192>(a, g, out, scratch, K, R, M, s);
    case 1:
        return launch<Tile128>(a, g, out, scratch, K, R, M, s);
    case 2:
        return launch<Tile64>(a, g, out, scratch, K, R, M, s);
    default:
        return (int)cudaErrorInvalidValue;
    }
}

// The tiles of pyiga_stage_bwd_f32 in its numbering, the geometry its
// plan is built from (cuda_sumfac.stage_bwd_f32_plan): tile i's k rows,
// r columns and blocks an SM at out[3 i], out[3 i + 1], out[3 i + 2] (out:
// room for 3 n ints).  Returns n, or -1 if n_max is too small.
PYIGA_EXPORT int pyiga_stage_bwd_f32_tiles(int* out, int n_max) {
    using namespace bwd32;
    const int t[] = {Tile192::BK, Tile192::BR, Tile192::MINB,
                     Tile128::BK, Tile128::BR, Tile128::MINB,
                     Tile64::BK,  Tile64::BR,  Tile64::MINB};
    const int n = (int)(sizeof(t) / sizeof(t[0])) / 3;
    if (n_max < n) return -1;
    for (int i = 0; i < 3 * n; ++i) out[i] = t[i];
    return n;
}
