// K2 and K3 in float32 for Hopper (sm_90a): the stage and the fold of the
// f32 line (pyiga_tpu_torch.config.set_dtype(np.float32)).
//
// K2f pyiga_stage_f32  out[r, m] = sum_k X[k, r] T[m, k] for X (K, R) and
//     a basis-pair table T (M, K); out (R, M): K2's function in float32.
// K3f pyiga_fold_f32   the sum over terms t of K2f(X_t, T_idx[t]), written
//     once, the terms that share a table summed before its product: K3's
//     function in float32.
// Both launch fold_f32_kernel, K2f as its case of one term: one mainloop.
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
//
// Design (simple first): a block of 256 threads owns a 64 (m) x 128 (r)
// output tile, a thread 4 m x 8 r of it (32 accumulators).  K runs in
// 16-deep slices through a 3-stage cp.async pipeline: the table slice is
// staged transposed, [k][m] (stride 68), by 4-byte copies; the X slice
// [k][r] (stride 132) by 16-byte copies where R is a multiple of 4 and
// every X 16-byte aligned, else 4-byte ones.  Ragged K, M and R are
// zero-filled by the copies and skipped on store.  A k step reads one
// float4 of the table slice and two of X: a quarter-warp's 8 lanes read 8
// consecutive m (128 bytes, no conflict) and one r quad (a broadcast).
// The fold walks (group, k slice, term) as K3 does: the group's last term
// brings the table slice; a group of several terms sums their X slices in
// term order into a shared buffer, and runs one product a slice from it.
// Every output element is written once, in a fixed order: deterministic.
// The m tiles are the grid's fastest axis, so the blocks that share an X
// tile run together and X comes from device memory once.  Offsets into
// X, T and out are 64-bit (R M passes 2^31 elements at 3D n=96).

#include "common.cuh"

namespace {
namespace f32 {

constexpr int kMaxTerms = 16;
constexpr int kBM = 64;                 // m a block
constexpr int kBN = 128;                // r a block
constexpr int kBK = 16;                 // k a slice
constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kPA = kBM + 4;            // table slice [k][m] row stride
constexpr int kPB = kBN + 4;            // X slice [k][r] row stride
constexpr int kStage = kBK * kPA + kBK * kPB;           // floats
constexpr int kSmem = (kStages * kStage + kBK * kPB) * (int)sizeof(float);

// the fields grouped by table; K2f is one group of one term
struct Terms {
    const float* x[kMaxTerms];    // per term, its (K, R) field, in order
    const float* t[kMaxTerms];    // per group, its (M, K) table
    int end[kMaxTerms];           // per group, one past its last term
    int groups;
};

// Copy BYTES (4 or 16) from global `src` to shared `dst`, the first
// `src_bytes` read and the rest zero-filled.
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int src_bytes) {
    const unsigned int d =
        static_cast<unsigned int>(__cvta_generic_to_shared(dst));
    if constexpr (BYTES == 16) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(d), "l"(src), "r"(src_bytes));
    } else {
        static_assert(BYTES == 4, "cp_async copies 4 or 16 bytes");
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     :: "r"(d), "l"(src), "r"(src_bytes));
    }
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// The table slice T[m0 : m0 + 64, k0 : k0 + 16] transposed into As[k][m].
__device__ __forceinline__ void load_table(float* As, const float* T, int K,
                                           int M, int m0, int k0) {
#pragma unroll
    for (int j = 0; j < kBM * kBK / kThreads; ++j) {
        const int e = (int)threadIdx.x + j * kThreads;
        const int m = e / kBK, k = e % kBK;
        const bool in = m0 + m < M && k0 + k < K;
        const float* src = in ? T + (long long)(m0 + m) * K + k0 + k : T;
        cp_async<4>(As + k * kPA + m, src, in ? 4 : 0);
    }
}

// The X slice X[k0 : k0 + 16, r0 : r0 + 128] into Bs[k][r], VB floats a
// copy (VB = 4 needs R a multiple of 4 and X 16-byte aligned).
template <int VB>
__device__ __forceinline__ void load_field(float* Bs, const float* X, int K,
                                           long long R, int k0,
                                           long long r0) {
    constexpr int CPR = kBN / VB;       // copies a row
#pragma unroll
    for (int j = 0; j < kBK * CPR / kThreads; ++j) {
        const int e = (int)threadIdx.x + j * kThreads;
        const int k = e / CPR, c = (e % CPR) * VB;
        long long n = 0;
        if (k0 + k < K) {
            n = R - (r0 + c);
            n = n < 0 ? 0 : (n > VB ? VB : n);
        }
        const float* src = n > 0 ? X + (long long)(k0 + k) * R + r0 + c : X;
        cp_async<VB * 4>(Bs + k * kPB + c, src, (int)n * 4);
    }
}

// acc += the thread's 4 x 8 part of As^T Bs over one 16-deep slice
__device__ __forceinline__ void mma_slice(const float* As, const float* Bs,
                                          int tm, int tn,
                                          float (&acc)[4][8]) {
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(As + k * kPA
                                                          + 4 * tm);
        const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * kPB
                                                           + 4 * tn);
        const float4 b1 = *reinterpret_cast<const float4*>(
            Bs + k * kPB + kBN / 2 + 4 * tn);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
                acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
}

template <int VB>
__global__ void __launch_bounds__(kThreads, 2)
fold_f32_kernel(const __grid_constant__ Terms terms, int K, long long R,
                int M, float* __restrict__ out, int vec) {
    extern __shared__ __align__(16) float smem[];
    float* Ss = smem + kStages * kStage;         // a group's summed slice
    const int tm = (int)threadIdx.x % 16, tn = (int)threadIdx.x / 16;
    const unsigned int mt = (M + kBM - 1) / kBM;
    const int m0 = (int)(blockIdx.x % mt) * kBM;
    const long long r0 = (long long)(blockIdx.x / mt) * kBN;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    const int nk = (K + kBK - 1) / kBK;
    const int nsteps = nk * terms.end[terms.groups - 1];
    // the (group, k slice, term) of the next step to load and to compute
    struct Cursor { int g, k, q; };
    Cursor ld{0, 0, 0}, cp{0, 0, 0};
    auto advance = [&](Cursor& c) {
        if (++c.q < terms.end[c.g]) return;
        if (++c.k < nk) {
            c.q = c.g ? terms.end[c.g - 1] : 0;
            return;
        }
        c.k = 0;                           // c.q opens the next group
        ++c.g;
    };
    auto load = [&](int buf) {
        float* As = smem + buf * kStage;
        float* Bs = As + kBK * kPA;
        const int k0 = ld.k * kBK;
        load_field<VB>(Bs, terms.x[ld.q], K, R, k0, r0);
        if (ld.q == terms.end[ld.g] - 1)   // the group's last term brings
            load_table(As, terms.t[ld.g], K, M, m0, k0);   // the table
        cp_async_commit();
        advance(ld);
    };
    auto compute = [&](int buf) {
        const float* As = smem + buf * kStage;
        const float* Bs = As + kBK * kPA;
        const bool first = cp.q == (cp.g ? terms.end[cp.g - 1] : 0);
        const bool last = cp.q == terms.end[cp.g] - 1;
        if (first && last) {
            mma_slice(As, Bs, tm, tn, acc);
        } else {
            for (int e = (int)threadIdx.x; e < kBK * kBN; e += kThreads) {
                const int o = e / kBN * kPB + e % kBN;
                Ss[o] = first ? Bs[o] : Ss[o] + Bs[o];
            }
            if (last) {
                __syncthreads();
                mma_slice(As, Ss, tm, tn, acc);
            }
        }
        advance(cp);
    };

    for (int s = 0; s < kStages - 1; ++s) {
        if (s < nsteps)
            load(s);
        else
            cp_async_commit();             // an empty group keeps the count
    }
    for (int st = 0; st < nsteps; ++st) {
        if (st + kStages - 1 < nsteps)
            load((st + kStages - 1) % kStages);
        else
            cp_async_commit();
        cp_async_wait<kStages - 1>();
        __syncthreads();
        compute(st % kStages);
        __syncthreads();
    }
    cp_async_wait<0>();

    // the tile to out (R, M): a warp writes 16 m quads of two rows
    const int mb = m0 + 4 * tm;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const long long r = r0 + (j < 4 ? 4 * tn + j : kBN / 2 + 4 * tn + j
                                                       - 4);
        if (r >= R) continue;
        float* o = out + r * M + mb;
        if (vec) {                         // M a multiple of 4
            if (mb < M)
                *reinterpret_cast<float4*>(o) =
                    make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
        } else {
#pragma unroll
            for (int i = 0; i < 4; ++i)
                if (mb + i < M) o[i] = acc[i][j];
        }
    }
}

int launch(const Terms& terms, int K, long long R, int M, float* out,
           void* stream) {
    if (K < 1 || R < 1 || M < 1) return (int)cudaErrorInvalidValue;
    const long long blocks =
        (long long)((M + kBM - 1) / kBM) * ((R + kBN - 1) / kBN);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    bool vb = R % 4 == 0;
    for (int q = 0; q < terms.end[terms.groups - 1]; ++q)
        vb = vb && aligned16(terms.x[q]);
    const int vec = M % 4 == 0 && aligned16(out);
    auto kernel = vb ? fold_f32_kernel<4> : fold_f32_kernel<1>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned int)blocks, kThreads, kSmem, (cudaStream_t)stream>>>(
        terms, K, R, M, out, vec);
    return (int)cudaGetLastError();
}

}  // namespace f32
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
