// Sum-factorization assembly kernels for Hopper (sm_90a), float64.
//
// K1  stiff_fields_kernel  replaces pyiga_tpu/ops/pallas_sumfac.py
//     `_fields_fused` (pallas_call at :1087, body
//     `_make_stiff_fields_fused_kernel`), kinds 'stiffness' and 'mass'.
// K1  geo_jac_fields_kernel  replaces the same call site's kind='jac'.
// K1' host_jac_fields_kernel replaces `stiffness_fields_pallas`'s
//     host-Jacobian branch (pallas_call at :1163).
// K2  stage_kernel         replaces `_stage_call` (pallas_call at :353,
//     bodies `_stage_kernel` / `_stage_kernel_acc`).
// K3  fold_kernel          replaces `_stage_call_fold` (pallas_call at
//     :781, body `_fold_kernel`).
//
// The TPU kernels carry float64 as two-float f32 pairs and split every
// contraction into six bf16 mantissa chunks (21 chunk dots with exact f32
// accumulation), because the v5e has no f64 arithmetic.  Hopper has native
// f64, so these kernels compute in double directly and none of that
// machinery is ported.

#include "common.cuh"

// --------------------------------------------------------------------------
// Per-point algebra shared by the field kernels: determinant, inverse by
// the adjugate (as ops/geom.det_and_inv) and the unique stiffness fields.
// --------------------------------------------------------------------------

template <int D>
__device__ __forceinline__ double det_of(double (&J)[D][D]) {
    if constexpr (D == 2) {
        return J[0][0] * J[1][1] - J[0][1] * J[1][0];
    } else {
        const double c00 = J[1][1] * J[2][2] - J[1][2] * J[2][1];
        const double c01 = J[1][2] * J[2][0] - J[1][0] * J[2][2];
        const double c02 = J[1][0] * J[2][1] - J[1][1] * J[2][0];
        return J[0][0] * c00 + J[0][1] * c01 + J[0][2] * c02;
    }
}

template <int D>
__device__ __forceinline__ double det_and_inv(double (&J)[D][D],
                                              double (&inv)[D][D]) {
    const double det = det_of<D>(J);
    if constexpr (D == 2) {
        inv[0][0] = J[1][1] / det;
        inv[0][1] = -J[0][1] / det;
        inv[1][0] = -J[1][0] / det;
        inv[1][1] = J[0][0] / det;
    } else {
        const double adj[3][3] = {
            {J[1][1] * J[2][2] - J[1][2] * J[2][1],
             J[0][2] * J[2][1] - J[0][1] * J[2][2],
             J[0][1] * J[1][2] - J[0][2] * J[1][1]},
            {J[1][2] * J[2][0] - J[1][0] * J[2][2],
             J[0][0] * J[2][2] - J[0][2] * J[2][0],
             J[0][2] * J[1][0] - J[0][0] * J[1][2]},
            {J[1][0] * J[2][1] - J[1][1] * J[2][0],
             J[0][1] * J[2][0] - J[0][0] * J[2][1],
             J[0][0] * J[1][1] - J[0][1] * J[1][0]}};
        for (int a = 0; a < D; ++a)
            for (int b = 0; b < D; ++b) inv[a][b] = adj[a][b] / det;
    }
    return det;
}

// out[o * N + g] = W (J^-1 J^-T)_ab for the unique a <= b, row-major
template <int D>
__device__ __forceinline__ void store_stiffness(double (&inv)[D][D],
                                                double W, double* out,
                                                long long N, long long g) {
    int o = 0;
    for (int a = 0; a < D; ++a) {
        for (int b = a; b < D; ++b) {
            double s = 0.0;
            for (int m = 0; m < D; ++m) s += inv[a][m] * inv[b][m];
            out[(long long)o * N + g] = W * s;
            ++o;
        }
    }
}

// --------------------------------------------------------------------------
// K1: geometry fields on the Gauss grid, one thread per Gauss point.
//
// KIND kStiffness: B_ab = W (J^-1 J^-T)_ab, W = gw |det J| (replaces
// pyiga_tpu/ops/pallas_sumfac.py `_fields_fused`, pallas_call at :1087,
// body `_make_stiff_fields_fused_kernel`).
// KIND kMass: the mass field W = gw |det J| alone (the same call site with
// kind='mass', reached through `mass_fields_pallas`, :1411); no inverse.
//
// Inputs (all row-major float64):
//   Y    (D, C, Q12, nL)  stage-1/2 geometry partials from K2: entry
//        [t, c, q12, j] holds component c contracted over the leading D-1
//        axes with the derivative table on axis t (t = D-1: all values),
//        the last coefficient axis j still open.
//   T    (2, QL, nL)      last-axis value (0) and derivative (1) tables.
//   w12  (Q12,)           product of the leading axes' Gauss weights.
//   wL   (QL,)            last-axis Gauss weights.
// Output: kStiffness out (D(D+1)/2, Q12, QL), the unique B_ab (a <= b,
// row-major) in grid order; kMass out (Q12, QL).  C = D components for a
// B-spline map, D + 1 (homogeneous, weight last) for NURBS, whose
// quotient rule runs before the determinant.
//
// Bound: device-memory writes (D(D+1)/2 doubles per point for stiffness,
// one for mass) and f64 divisions; the Y rows are shared by the QL
// consecutive threads of one q12 and come from L1.  Both kinds share the
// last-axis contraction, as the TPU kernel shares it through `kind=`; every
// intermediate (Jacobian, quotient rule, inverse) stays in registers: one
// read of the small inputs, one coalesced write per output field.
// --------------------------------------------------------------------------

enum FieldsKind { kStiffness = 0, kMass = 1 };

template <int D, bool NURBS, int KIND>
__global__ void stiff_fields_kernel(const double* __restrict__ Y,
                                    const double* __restrict__ T,
                                    const double* __restrict__ w12,
                                    const double* __restrict__ wL,
                                    double* __restrict__ out,
                                    long long Q12, int QL, int nL) {
    constexpr int C = D + (NURBS ? 1 : 0);
    const long long N = Q12 * QL;
    for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         g < N; g += (long long)gridDim.x * blockDim.x) {
        const long long q12 = g / QL;
        const int qL = (int)(g - q12 * QL);
        const double* Tv = T + (long long)qL * nL;
        const double* Td = T + ((long long)QL + qL) * nL;

        // last-axis contraction: jac[c][k] (derivative axis k), val[c]
        double jac[C][D];
        double val[C];
        for (int c = 0; c < C; ++c) {
            for (int k = 0; k < D; ++k) {
                const int t = k < D - 1 ? k : D - 1;
                const double* tab = k == D - 1 ? Td : Tv;
                const double* y = Y + (((long long)t * C + c) * Q12 + q12) * nL;
                double s = 0.0;
                for (int j = 0; j < nL; ++j) s += tab[j] * y[j];
                jac[c][k] = s;
            }
            if constexpr (NURBS) {
                const double* y =
                    Y + (((long long)(D - 1) * C + c) * Q12 + q12) * nL;
                double s = 0.0;
                for (int j = 0; j < nL; ++j) s += Tv[j] * y[j];
                val[c] = s;
            }
        }

        // physical Jacobian J[c][k]; NURBS: quotient rule on V / W
        double J[D][D];
        if constexpr (NURBS) {
            const double W = val[C - 1];
            const double WW = W * W;
            for (int c = 0; c < D; ++c)
                for (int k = 0; k < D; ++k)
                    J[c][k] = (jac[c][k] * W - val[c] * jac[C - 1][k]) / WW;
        } else {
            for (int c = 0; c < D; ++c)
                for (int k = 0; k < D; ++k) J[c][k] = jac[c][k];
        }

        const double gw = w12[q12] * wL[qL];
        if constexpr (KIND == kMass) {
            out[g] = gw * fabs(det_of<D>(J));
        } else {
            double inv[D][D];
            const double det = det_and_inv<D>(J, inv);
            store_stiffness<D>(inv, gw * fabs(det), out, N, g);
        }
    }
}

template <int KIND>
static int launch_fields(const double* Y, const double* T, const double* w12,
                         const double* wL, double* out, int d, int nurbs,
                         long long Q12, int QL, int nL, void* stream) {
    const int threads = 256;
    const unsigned int grid = pyiga_grid_1d(Q12 * QL, threads);
    cudaStream_t s = (cudaStream_t)stream;
#define PYIGA_FIELDS(DD, NN)                                             \
    stiff_fields_kernel<DD, NN, KIND><<<grid, threads, 0, s>>>(          \
        Y, T, w12, wL, out, Q12, QL, nL)
    if (d == 2 && nurbs) PYIGA_FIELDS(2, true);
    else if (d == 2) PYIGA_FIELDS(2, false);
    else if (d == 3 && nurbs) PYIGA_FIELDS(3, true);
    else if (d == 3) PYIGA_FIELDS(3, false);
    else return (int)cudaErrorInvalidValue;
#undef PYIGA_FIELDS
    return (int)cudaGetLastError();
}

PYIGA_EXPORT int pyiga_stiff_fields_f64(const double* Y, const double* T,
                                        const double* w12, const double* wL,
                                        double* out, int d, int nurbs,
                                        long long Q12, int QL, int nL,
                                        void* stream) {
    return launch_fields<kStiffness>(Y, T, w12, wL, out, d, nurbs, Q12, QL,
                                     nL, stream);
}

PYIGA_EXPORT int pyiga_mass_fields_f64(const double* Y, const double* T,
                                       const double* w12, const double* wL,
                                       double* out, int d, int nurbs,
                                       long long Q12, int QL, int nL,
                                       void* stream) {
    return launch_fields<kMass>(Y, T, w12, wL, out, d, nurbs, Q12, QL, nL,
                                stream);
}

// --------------------------------------------------------------------------
// K1': stiffness fields from a Jacobian evaluated on the host, one thread
// per Gauss point.  Replaces the non-spline branch of
// `stiffness_fields_pallas` (pyiga_tpu/ops/pallas_sumfac.py, pallas_call
// at :1163, body `_make_stiff_fields_kernel`, :930), which runs for a
// geometry given as a user function (`geometry.UserFunction`).
//
// Inputs (row-major float64): jac (D, D, N), the level-ordered Jacobian
// J[a][b] at every Gauss point; gw (N,), the Gauss weight product.
// Output: out (D(D+1)/2, N), the unique B_ab = gw |det J| (J^-1 J^-T)_ab
// for a <= b, row-major (the order the assembler expands).
//
// Bound: device memory, D*D + 1 doubles read and D(D+1)/2 written per
// point, every access coalesced across the warp (the field axis leads, the
// point axis is contiguous).  No lane padding: N needs no multiple of 128
// (that gate is the TPU's (8, 128) tiling rule).
// --------------------------------------------------------------------------

template <int D>
__global__ void host_jac_fields_kernel(const double* __restrict__ jac,
                                       const double* __restrict__ gw,
                                       double* __restrict__ out,
                                       long long N) {
    for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         g < N; g += (long long)gridDim.x * blockDim.x) {
        double J[D][D];
        for (int a = 0; a < D; ++a)
            for (int b = 0; b < D; ++b)
                J[a][b] = jac[(long long)(a * D + b) * N + g];
        double inv[D][D];
        const double det = det_and_inv<D>(J, inv);
        store_stiffness<D>(inv, gw[g] * fabs(det), out, N, g);
    }
}

PYIGA_EXPORT int pyiga_host_jac_fields_f64(const double* jac,
                                           const double* gw, double* out,
                                           int d, long long N, void* stream) {
    const int threads = 256;
    const unsigned int grid = pyiga_grid_1d(N, threads);
    cudaStream_t s = (cudaStream_t)stream;
    if (d == 2)
        host_jac_fields_kernel<2><<<grid, threads, 0, s>>>(jac, gw, out, N);
    else if (d == 3)
        host_jac_fields_kernel<3><<<grid, threads, 0, s>>>(jac, gw, out, N);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

// --------------------------------------------------------------------------
// K1, `jac` kind: physical geometry values and Jacobian, one thread per
// Gauss point.  Replaces the same `_fields_fused` call site with
// kind='jac' (`geo_jac_fields_pallas`, pallas_sumfac.py:1421; kernel body
// `_make_stiff_fields_fused_kernel`, :979-1002), which feeds the generic
// VForm coefficient fields.
//
// Inputs as stiff_fields_kernel (Y, T; no weights).  Output:
// out (D + D*D, Q12, QL), rows 0..D-1 the physical values x_c (level
// order), then J[c][k] = d x_c / d xi_k row-major; for NURBS the quotient
// V / W and its quotient-rule Jacobian.  Bound: the D(D+1) coalesced
// f64 writes per point; the last-axis contraction reads Y rows shared by
// QL consecutive threads (L1) and keeps everything in registers.
// --------------------------------------------------------------------------

template <int D, bool NURBS>
__global__ void geo_jac_fields_kernel(const double* __restrict__ Y,
                                      const double* __restrict__ T,
                                      double* __restrict__ out,
                                      long long Q12, int QL, int nL) {
    constexpr int C = D + (NURBS ? 1 : 0);
    const long long N = Q12 * QL;
    for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         g < N; g += (long long)gridDim.x * blockDim.x) {
        const long long q12 = g / QL;
        const int qL = (int)(g - q12 * QL);
        const double* Tv = T + (long long)qL * nL;
        const double* Td = T + ((long long)QL + qL) * nL;

        double jac[C][D];
        double val[C];
        for (int c = 0; c < C; ++c) {
            for (int k = 0; k < D; ++k) {
                const int t = k < D - 1 ? k : D - 1;
                const double* tab = k == D - 1 ? Td : Tv;
                const double* y = Y + (((long long)t * C + c) * Q12 + q12) * nL;
                double s = 0.0;
                for (int j = 0; j < nL; ++j) s += tab[j] * y[j];
                jac[c][k] = s;
            }
            const double* y = Y + (((long long)(D - 1) * C + c) * Q12 + q12) * nL;
            double s = 0.0;
            for (int j = 0; j < nL; ++j) s += Tv[j] * y[j];
            val[c] = s;
        }
        if constexpr (NURBS) {
            const double W = val[C - 1];
            const double WW = W * W;
            for (int c = 0; c < D; ++c)
                for (int k = 0; k < D; ++k)
                    jac[c][k] = (jac[c][k] * W - val[c] * jac[C - 1][k]) / WW;
            for (int c = 0; c < D; ++c) val[c] = val[c] / W;
        }
        for (int c = 0; c < D; ++c) out[(long long)c * N + g] = val[c];
        for (int c = 0; c < D; ++c)
            for (int k = 0; k < D; ++k)
                out[(long long)(D + c * D + k) * N + g] = jac[c][k];
    }
}

PYIGA_EXPORT int pyiga_geo_jac_fields_f64(const double* Y, const double* T,
                                          double* out, int d, int nurbs,
                                          long long Q12, int QL, int nL,
                                          void* stream) {
    const int threads = 256;
    const unsigned int grid = pyiga_grid_1d(Q12 * QL, threads);
    cudaStream_t s = (cudaStream_t)stream;
#define PYIGA_GEO_JAC(DD, NN)                                            \
    geo_jac_fields_kernel<DD, NN><<<grid, threads, 0, s>>>(Y, T, out, Q12, \
                                                            QL, nL)
    if (d == 1 && nurbs) PYIGA_GEO_JAC(1, true);
    else if (d == 1) PYIGA_GEO_JAC(1, false);
    else if (d == 2 && nurbs) PYIGA_GEO_JAC(2, true);
    else if (d == 2) PYIGA_GEO_JAC(2, false);
    else if (d == 3 && nurbs) PYIGA_GEO_JAC(3, true);
    else if (d == 3) PYIGA_GEO_JAC(3, false);
    else return (int)cudaErrorInvalidValue;
#undef PYIGA_GEO_JAC
    return (int)cudaGetLastError();
}

// --------------------------------------------------------------------------
// K2 / K3: one sum-factorization stage, out[r, m] = sum_k X[k, r] T[m, k]
// (K3: summed over terms t, each with its own X_t and table T_idx[t]).
//
// X (K, R) row-major is the field with the contraction axis leading; T
// (M, K) is a basis-pair table; out (R, M) appends the band axis last, so
// a d-stage chain maps (K_1, ..., K_d) to (M_1, ..., M_d) with no
// transposes (the chain convention of pallas_sumfac).  At the 3D n=48
// headline: K = 192 and M = 357 in every stage; R = 36,864 (stage 1),
// 68,544 (stage 2) and 127,449 (the folded final stage).
//
// Bound: f64 FMA issue and shared-memory bandwidth (arithmetic intensity
// is K-fold; the compute is ~190 GFLOP for the headline assembly).  The
// design is a plain shared-memory tiled product: 64 x 64 output tiles,
// 16-deep K slices, 256 threads each holding a 4 x 4 register tile whose
// columns are strided by 16 so that every warp's stores hit consecutive
// m (coalesced rows of `out`).  Ragged K, R and M are masked with zeros
// on load and skipped on store; no lane padding exists anywhere.  K3
// loops over the terms inside the block and writes its tile once: no
// atomics, so the result is deterministic.  (DMMA tensor cores, TMA and
// deeper pipelining are later work.)
// --------------------------------------------------------------------------

namespace {

constexpr int kBR = 64;       // output rows (r) per block
constexpr int kBM = 64;       // output columns (m) per block
constexpr int kBK = 16;       // contraction slice
constexpr int kThreads = 256;
constexpr int kMaxTerms = 16;

struct FoldTerms {
    const double* x[kMaxTerms];
    const double* t[kMaxTerms];
    int n;
};

__device__ __forceinline__ void accumulate_term(
        const double* __restrict__ X, const double* __restrict__ T, int K,
        long long R, int M, long long r0, int m0,
        double (*Xs)[kBR], double (*Ts)[kBM + 1], double acc[4][4]) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    for (int k0 = 0; k0 < K; k0 += kBK) {
        for (int i = threadIdx.x; i < kBK * kBR; i += kThreads) {
            const int kk = i / kBR, rr = i % kBR;
            const int k = k0 + kk;
            const long long r = r0 + rr;
            Xs[kk][rr] = (k < K && r < R) ? X[(long long)k * R + r] : 0.0;
        }
        for (int i = threadIdx.x; i < kBK * kBM; i += kThreads) {
            const int mm = i / kBK, kk = i % kBK;
            const int k = k0 + kk, m = m0 + mm;
            Ts[kk][mm] = (k < K && m < M) ? T[(long long)m * K + k] : 0.0;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kBK; ++kk) {
            double a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = Xs[kk][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = Ts[kk][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }
}

__device__ __forceinline__ void store_tile(double* __restrict__ out,
                                           long long R, int M, long long r0,
                                           int m0, const double acc[4][4]) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const long long r = r0 + ty + 16 * i;
        if (r >= R) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int m = m0 + tx + 16 * j;
            if (m < M) out[r * M + m] = acc[i][j];
        }
    }
}

__global__ void __launch_bounds__(kThreads)
stage_kernel(const double* __restrict__ X, const double* __restrict__ T,
             int K, long long R, int M, double* __restrict__ out) {
    __shared__ double Xs[kBK][kBR];
    __shared__ double Ts[kBK][kBM + 1];
    const long long r0 = (long long)blockIdx.x * kBR;
    const int m0 = blockIdx.y * kBM;
    double acc[4][4] = {};
    accumulate_term(X, T, K, R, M, r0, m0, Xs, Ts, acc);
    store_tile(out, R, M, r0, m0, acc);
}

__global__ void __launch_bounds__(kThreads)
fold_kernel(FoldTerms terms, int K, long long R, int M,
            double* __restrict__ out) {
    __shared__ double Xs[kBK][kBR];
    __shared__ double Ts[kBK][kBM + 1];
    const long long r0 = (long long)blockIdx.x * kBR;
    const int m0 = blockIdx.y * kBM;
    double acc[4][4] = {};
    for (int t = 0; t < terms.n; ++t)
        accumulate_term(terms.x[t], terms.t[t], K, R, M, r0, m0, Xs, Ts, acc);
    store_tile(out, R, M, r0, m0, acc);
}

}  // namespace

PYIGA_EXPORT int pyiga_stage_f64(const double* X, const double* T, double* out,
                                 int K, long long R, int M, void* stream) {
    const dim3 grid((unsigned int)((R + kBR - 1) / kBR),
                    (unsigned int)((M + kBM - 1) / kBM));
    stage_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(X, T, K, R, M,
                                                               out);
    return (int)cudaGetLastError();
}

// x_ptrs / t_ptrs: host arrays of n_terms device pointers (term t's field
// and its deduplicated table).
PYIGA_EXPORT int pyiga_fold_f64(const uint64_t* x_ptrs, const uint64_t* t_ptrs,
                                int n_terms, double* out, int K, long long R,
                                int M, void* stream) {
    if (n_terms < 1 || n_terms > kMaxTerms) return (int)cudaErrorInvalidValue;
    FoldTerms terms;
    terms.n = n_terms;
    for (int t = 0; t < n_terms; ++t) {
        terms.x[t] = reinterpret_cast<const double*>(x_ptrs[t]);
        terms.t[t] = reinterpret_cast<const double*>(t_ptrs[t]);
    }
    const dim3 grid((unsigned int)((R + kBR - 1) / kBR),
                    (unsigned int)((M + kBM - 1) / kBM));
    fold_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(terms, K, R, M,
                                                              out);
    return (int)cudaGetLastError();
}

PYIGA_EXPORT const char* pyiga_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
