// The windowed assembly route's stage kernels for Hopper (sm_90a), float64.
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
// axis order, as K2).  K8f adds the X tiles of the terms that share a
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
// Design.  A block owns kRT = 32 consecutive r and a run of up to 64
// consecutive dofs (4 a warp; the runs of an axis balanced): at n=48 one
// run covers the axis, so that one block writes whole rows of Y (stage
// 1 0.154 -> 0.105 ms against runs of 32 dofs, two blocks an SM; one
// block of 13 warps an SM here, at 100 registers).  For each group it
// puts every copy in flight at once by cp.async: the run's rows of the
// table and the X rows that the run's windows cover, fs[i0] nqp to
// fs[i1] nqp + wsz (all 192 at n=48), as a [q][r] tile (a group's
// second term into a second tile, added to the first in term order, and
// so on).  A lane owns one dof and 4 r (r = rsub + 8 rr) and keeps the
// b x 4 sums in registers: a step w reads 4 X values and b table values
// from shared memory for 4 b multiply-adds; the 8 lanes of a dof read one
// window (broadcasts), and the strides (X tile 34 doubles, table 2 mod
// 4) put the 4 dofs of a warp on distinct banks.  The finished tile
// goes through shared memory [r][o][i], so that a warp stores runs of nd
// consecutive entries of a row of Y (0.22 -> 0.14 ms at stage 1 against
// stores straight from the registers, 4 entries of 8 rows a store).
// Every entry of Y is written, the padding (j = i + o - p outside
// [0, n), where P holds zeros) included: no memset.  Offsets are 64-bit
// (Y passes 2^31 bytes at n=96).
//
// The window starts must be what SpaceTables.windowed_pair_table gives
// (non-decreasing from 0 in steps of at most 1, the last window inside
// X): the wrapper checks them once per tensor; the staged tile is sized by
// them.

#include <algorithm>

#include "common.cuh"

namespace {
namespace win {

constexpr int kMaxTerms = 16;
constexpr int kRPT = 4;           // r a lane: rsub + 8 rr
constexpr int kRT = 8 * kRPT;     // r a block
constexpr int kXS = kRT + 2;      // X tile row stride (2 mod 4)
constexpr int kDI = 4;            // dofs a warp
constexpr int kMaxWarps = 16;     // dofs a run: kDI kMaxWarps

// the fields grouped by table (as the fold of csrc/sumfac.cu)
struct Terms {
    const double* x[kMaxTerms];   // per term, its (Q, R) field, in order
    const double* p[kMaxTerms];   // per group, its (n, b, wsz) table
    int end[kMaxTerms];           // per group, one past its last term
    int groups;
};

// Copy 8 or 16 bytes from global to shared memory, asynchronously; the
// first `src_bytes` are read and the rest zero-filled.
template <int BYTES>
__device__ __forceinline__ void cp_async(double* dst, const double* src,
                                         int src_bytes) {
    const unsigned int d =
        static_cast<unsigned int>(__cvta_generic_to_shared(dst));
    if constexpr (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(d), "l"(src), "r"(src_bytes));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                     :: "r"(d), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Copy the tile rows [qa, qa + rows) x [r0, r0 + nr) of X into `dst` (row
// stride kXS), VEC doubles a copy, zeros past nr.
template <int VEC>
__device__ __forceinline__ void stage_x(double* dst, const double* X,
                                        long long R, long long qa, int rows,
                                        long long r0, int nr) {
    constexpr int CPR = kRT / VEC;
    for (int e = threadIdx.x; e < rows * CPR; e += blockDim.x) {
        const int q = e / CPR, c = (e % CPR) * VEC;
        const int nb = max(0, min(VEC, nr - c));
        const double* src = X + (qa + q) * R + r0 + (nb > 0 ? c : 0);
        cp_async<VEC * 8>(dst + q * kXS + c, src, nb * 8);
    }
}

template <int B, int VEC>
__global__ void __launch_bounds__(32 * kMaxWarps)
windowed_kernel(const Terms terms, const long long* __restrict__ fs,
                double* __restrict__ Y, long long R, int n, int wsz,
                int nqp, int run, int ps, bool pvec) {
    extern __shared__ double smem[];
    const int cap = (run - 1) * nqp + wsz;     // X rows staged at most
    double* Ps = smem;                          // run x ps: [i][o][w]
    double* Xs = smem + (size_t)run * ps;       // the group's X
    double* Xt = Xs + (size_t)cap * kXS;        // a further term's X
    const int i0 = blockIdx.y * run;
    const int nd = min(run, n - i0);
    const long long r0 = (long long)blockIdx.x * kRT;
    const int nr = (int)min((long long)kRT, R - r0);
    const long long qa = fs[i0] * nqp;
    const int rows = (int)(fs[i0 + nd - 1] * nqp + wsz - qa);

    const int lane = threadIdx.x & 31;
    const int il = (threadIdx.x >> 5) * kDI + (lane >> 3);
    const int rsub = lane & 7;
    const bool live = il < nd;
    const int qrel = live ? (int)(fs[i0 + il] * nqp - qa) : 0;
    const int bw = B * wsz;

    double acc[B][kRPT];
#pragma unroll
    for (int o = 0; o < B; ++o)
#pragma unroll
        for (int rr = 0; rr < kRPT; ++rr) acc[o][rr] = 0.0;

    for (int g = 0; g < terms.groups; ++g) {
        const int t0 = g ? terms.end[g - 1] : 0, t1 = terms.end[g];
        if (g) __syncthreads();          // the last group's reads are done
        // every copy of the group in flight at once: the run's rows of its
        // table (dof stride ps), its first term's X tile and, where it has
        // one, its second's
        const double* P = terms.p[g] + (long long)i0 * bw;
        if (pvec) {
            const int cpr = bw / 2;
            for (int e = threadIdx.x; e < nd * cpr; e += blockDim.x) {
                const int i = e / cpr, c = 2 * (e - i * cpr);
                cp_async<16>(Ps + i * ps + c, P + i * bw + c, 16);
            }
        } else {
            for (int e = threadIdx.x; e < nd * bw; e += blockDim.x) {
                const int i = e / bw, c = e - i * bw;
                cp_async<8>(Ps + i * ps + c, P + e, 8);
            }
        }
        stage_x<VEC>(Xs, terms.x[t0], R, qa, rows, r0, nr);
        for (int t = t0 + 1; t < t1; ++t) {
            if (t == t0 + 1)
                stage_x<VEC>(Xt, terms.x[t], R, qa, rows, r0, nr);
            cp_async_wait_all();
            __syncthreads();
            // the group's sum, in term order: Xs += Xt
            for (int e = threadIdx.x; e < rows * kRT; e += blockDim.x) {
                const int q = e / kRT, c = e % kRT;
                Xs[q * kXS + c] += Xt[q * kXS + c];
            }
            __syncthreads();
            if (t + 1 < t1)
                stage_x<VEC>(Xt, terms.x[t + 1], R, qa, rows, r0, nr);
        }
        cp_async_wait_all();
        __syncthreads();
        if (live) {
            const double* xr = Xs + qrel * kXS + rsub;
            const double* pr = Ps + il * ps;
            for (int w = 0; w < wsz; ++w) {
                double x[kRPT], p[B];
#pragma unroll
                for (int rr = 0; rr < kRPT; ++rr)
                    x[rr] = xr[w * kXS + 8 * rr];
#pragma unroll
                for (int o = 0; o < B; ++o) p[o] = pr[o * wsz + w];
#pragma unroll
                for (int o = 0; o < B; ++o)
#pragma unroll
                    for (int rr = 0; rr < kRPT; ++rr)
                        acc[o][rr] = fma(x[rr], p[o], acc[o][rr]);
            }
        }
    }
    // the output tile through shared memory, [r][o][i], so that a warp
    // writes one run of nd consecutive entries of a row of Y at a time
    const int ys = B * run + 1;
    double* Ys = smem;                          // kRT x ys
    __syncthreads();                            // the last reads are done
    if (live) {
#pragma unroll
        for (int rr = 0; rr < kRPT; ++rr)
#pragma unroll
            for (int o = 0; o < B; ++o)
                Ys[(rsub + 8 * rr) * ys + o * run + il] = acc[o][rr];
    }
    __syncthreads();
    const long long bn = (long long)B * n;
    for (int ro = threadIdx.x >> 5; ro < nr * B; ro += blockDim.x >> 5) {
        const int r = ro / B, o = ro - r * B;
        double* y = Y + (r0 + r) * bn + (long long)o * n + i0;
        for (int i = lane; i < nd; i += 32)
            y[i] = Ys[r * ys + o * run + i];
    }
}

template <int B>
int launch_b(const Terms& terms, const long long* fs, double* Y, long long R,
             int n, int wsz, int nqp, cudaStream_t s) {
    // the table's dof stride in shared memory: 2 mod 4 doubles, so that
    // the 4 dofs of a warp read 4 bank pairs; 16-byte copies where the
    // table's rows allow them
    const int ps = (wsz * B + 3) / 4 * 4 + 2;
    bool pvec = (wsz * B) % 2 == 0;
    for (int g = 0; g < terms.groups; ++g)
        pvec = pvec && reinterpret_cast<uintptr_t>(terms.p[g]) % 16 == 0;
    // a second X tile for the groups of more than one term
    bool multi = false;
    for (int g = 0; g < terms.groups; ++g)
        multi = multi || terms.end[g] - (g ? terms.end[g - 1] : 0) > 1;
    // runs of whole warps (kDI dofs each), balanced, at most kMaxWarps, or
    // fewer where the staged table and X tiles, then the output tile in
    // their place, would not fit in shared memory
    const int warps_total = (n + kDI - 1) / kDI;
    int run = 0;
    size_t smem = 0;
    for (int max_warps = kMaxWarps; max_warps >= 1; --max_warps) {
        const int nruns = (warps_total + max_warps - 1) / max_warps;
        run = (warps_total + nruns - 1) / nruns * kDI;
        const int cap = (run - 1) * nqp + wsz;
        smem = std::max((size_t)cap * kXS * (multi ? 2 : 1)
                        + (size_t)run * ps, (size_t)kRT * (B * run + 1))
               * sizeof(double);
        if (smem <= 232448) break;
    }
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    // 16-byte copies where every X row starts 16-byte aligned
    bool vec = R % 2 == 0;
    for (int t = 0; t < terms.end[terms.groups - 1]; ++t)
        vec = vec && reinterpret_cast<uintptr_t>(terms.x[t]) % 16 == 0;
    auto kernel = vec ? windowed_kernel<B, 2> : windowed_kernel<B, 1>;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const long long rtiles = (R + kRT - 1) / kRT;
    if (rtiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned int)rtiles, (unsigned int)((n + run - 1) / run));
    kernel<<<grid, run / kDI * 32, smem, s>>>(terms, fs, Y, R, n, wsz, nqp,
                                              run, ps, pvec);
    return (int)cudaGetLastError();
}

int launch(const Terms& terms, const long long* fs, double* Y, long long Q,
           long long R, int n, int b, int wsz, int nqp, void* stream) {
    if (n < 1 || R < 1 || wsz < 1 || nqp < 1 || Q < wsz)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (b) {
    case 1: return launch_b<1>(terms, fs, Y, R, n, wsz, nqp, s);
    case 3: return launch_b<3>(terms, fs, Y, R, n, wsz, nqp, s);
    case 5: return launch_b<5>(terms, fs, Y, R, n, wsz, nqp, s);
    case 7: return launch_b<7>(terms, fs, Y, R, n, wsz, nqp, s);
    case 9: return launch_b<9>(terms, fs, Y, R, n, wsz, nqp, s);
    default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace win
}  // namespace

// K8: one term.  X (Q, R), P (n, b, wsz), fs (n,) int64, Y (R, b n).
PYIGA_EXPORT int pyiga_windowed_stage_f64(const double* X, const double* P,
                                          const long long* fs, double* Y,
                                          long long Q, long long R, int n,
                                          int b, int wsz, int nqp,
                                          void* stream) {
    win::Terms terms;
    terms.x[0] = X;
    terms.p[0] = P;
    terms.end[0] = 1;
    terms.groups = 1;
    return win::launch(terms, fs, Y, Q, R, n, b, wsz, nqp, stream);
}

// K8f: x_ptrs / p_ptrs: host arrays of n_terms device pointers (term t's
// (Q, R) field and its deduplicated table).
PYIGA_EXPORT int pyiga_windowed_fold_f64(const uint64_t* x_ptrs,
                                         const uint64_t* p_ptrs, int n_terms,
                                         const long long* fs, double* Y,
                                         long long Q, long long R, int n,
                                         int b, int wsz, int nqp,
                                         void* stream) {
    if (n_terms < 1 || n_terms > win::kMaxTerms)
        return (int)cudaErrorInvalidValue;
    // groups of one table in order of first appearance, terms in order
    win::Terms terms;
    int q = 0, groups = 0;
    for (int u = 0; u < n_terms; ++u) {
        bool first = true;
        for (int v = 0; v < u; ++v) first = first && p_ptrs[v] != p_ptrs[u];
        if (!first) continue;
        terms.p[groups] = reinterpret_cast<const double*>(p_ptrs[u]);
        for (int t = u; t < n_terms; ++t)
            if (p_ptrs[t] == p_ptrs[u])
                terms.x[q++] = reinterpret_cast<const double*>(x_ptrs[t]);
        terms.end[groups++] = q;
    }
    terms.groups = groups;
    return win::launch(terms, fs, Y, Q, R, n, b, wsz, nqp, stream);
}
