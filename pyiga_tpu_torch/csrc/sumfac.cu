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
// K7a stage_T_kernel       replaces `_stage_call_T` (pallas_call at :436,
//     body `_stage_kernel_T`).
// K7b tail_kernel          replaces `_tail_fused_call` (pallas_call at
//     :563, body `_tail_kernel`).
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

// acc[i][j] holds the output (r, m) = (r0 + ry + 16 i, m0 + mx + 16 j).
// kRByTx = false (K2, K3): ry = ty, mx = tx, so a warp's 16 consecutive
// threads hold consecutive m (coalesced stores of the (R, M) output);
// kRByTx = true (K7a): ry = tx, mx = ty, consecutive r for the (M, R) one.
template <bool kRByTx>
__device__ __forceinline__ void accumulate_term(
        const double* __restrict__ X, const double* __restrict__ T, int K,
        long long R, int M, long long r0, int m0,
        double (*Xs)[kBR], double (*Ts)[kBM + 1], double acc[4][4]) {
    const int tx = kRByTx ? threadIdx.x / 16 : threadIdx.x % 16;
    const int ty = kRByTx ? threadIdx.x % 16 : threadIdx.x / 16;
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

// the transposed store of K7a: out (M, R), consecutive threads on
// consecutive r (the accumulate_term<true> mapping)
__device__ __forceinline__ void store_tile_T(double* __restrict__ out,
                                             long long R, int M, long long r0,
                                             int m0, const double acc[4][4]) {
    const int rx = threadIdx.x % 16, my = threadIdx.x / 16;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int m = m0 + my + 16 * j;
        if (m >= M) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const long long r = r0 + rx + 16 * i;
            if (r < R) out[(long long)m * R + r] = acc[i][j];
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
    accumulate_term<false>(X, T, K, R, M, r0, m0, Xs, Ts, acc);
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
        accumulate_term<false>(terms.x[t], terms.t[t], K, R, M, r0, m0, Xs,
                               Ts, acc);
    store_tile(out, R, M, r0, m0, acc);
}

// --------------------------------------------------------------------------
// K7a: one stage with the transposed output, out[m, r] = sum_k X[k, r]
// T[m, k]: X (K, R), T (M, K), out (M, R).  Replaces `_stage_call_T`
// (pyiga_tpu/ops/pallas_sumfac.py, pallas_call at :436).  It is K2's body
// (the same 64 x 64 tiles and 16-deep K slices) with the thread mapping
// and the store transposed, so that stores stay coalesced along r; the
// tail (K7b) then reads term t's output as (M1, K2, K3) slabs with no
// transpose.  Bound at the 3D n=48 headline (K = 192, R = 36,864,
// M = 357, six launches): 30.3 GFLOP in all, compute (0.45 ms at the
// datasheet's 67 TFLOP/s f64 tensor rate) over bytes (972 MB, 0.29 ms at
// 3.35 TB/s).
// --------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
stage_T_kernel(const double* __restrict__ X, const double* __restrict__ T,
               int K, long long R, int M, double* __restrict__ out) {
    __shared__ double Xs[kBK][kBR];
    __shared__ double Ts[kBK][kBM + 1];
    const long long r0 = (long long)blockIdx.x * kBR;
    const int m0 = blockIdx.y * kBM;
    double acc[4][4] = {};
    accumulate_term<true>(X, T, K, R, M, r0, m0, Xs, Ts, acc);
    store_tile_T(out, R, M, r0, m0, acc);
}

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
// Bound at n=48 (6 terms, K = 192, M = 357): stage 2 is 56.4 GFLOP and
// the final stage 104.8, 161 GFLOP in all: 2.4 ms at 67 TFLOP/s (f64
// tensor cores), 4.8 ms at the 34 TFLOP/s of plain f64 FMA; it moves
// about 1.0 GB (0.3 ms), so it is compute-bound.
//
// Design.  The TPU grid (m1, m2-tile, m3-tile) runs in order and keeps Y2
// in VMEM scratch across the sequential m3 axis; here blocks run in
// parallel, so a block owns everything it reuses.  One block per (m1,
// 16-row m2 tile, m3 chunk of 64 NC columns, one chunk when M3 <= 512),
// 256 threads as 4 row groups of 4 m2 rows x 64 column lanes: each
// thread keeps its 4 x NC outputs in registers across all terms.  Per
// term the block (1) builds Y2_t[k, bb] = sum_j x1T_t[a, j, k]
// T2_t[b0 + bb, j] for all k as a (K3 x 16) tile in shared memory (j in
// 16-deep slices, each thread 3 k x 4 rows), (2) accumulates Y2_t^T
// T3_t^T into its registers, T3 streamed through shared memory in 8-deep
// k slices, and after the last term (3) stores the slab once.  No
// atomics, a fixed summation order: deterministic.  Nothing is recomputed
// while M3 <= 512 (n <= 70 at p=3); larger M3 splits into chunks that
// rebuild Y2 each.  DMMA (mma.sync f64), TMA and deeper pipelining are
// later work.
// --------------------------------------------------------------------------

constexpr int kTailRows = 16;     // m2 rows per block (4 groups of 4)
constexpr int kTailLanes = 64;    // column lanes per row group
constexpr int kTailJ = 16;        // stage-2 contraction slice (over K2)
constexpr int kTailKc = 192;      // stage-2 k chunk: 64 lanes x 3
constexpr int kTailKs = 8;        // final-stage contraction slice (K3)
constexpr int kTailMaxNC = 8;     // columns per thread: M3 chunk <= 512

struct TailTerms {
    const double* x[kMaxTerms];
    const double* t2[kMaxTerms];
    const double* t3[kMaxTerms];
    int n;
};

template <int NC>
__global__ void __launch_bounds__(kThreads)
tail_kernel(TailTerms terms, int K2, int K3, int M2, int M3,
            double* __restrict__ out) {
    extern __shared__ double smem[];
    double* Y2s = smem;                           // [K3][kTailRows]
    double* scr = smem + (long long)K3 * kTailRows;
    const int a = blockIdx.x;
    const int b0 = blockIdx.y * kTailRows;
    const int c0 = blockIdx.z * kTailLanes * NC;
    const int lane = threadIdx.x % kTailLanes;
    const int row0 = (threadIdx.x / kTailLanes) * 4;
    constexpr int CW = kTailLanes * NC;

    double acc[4][NC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = 0.0;

    for (int t = 0; t < terms.n; ++t) {
        const double* __restrict__ X = terms.x[t] + (long long)a * K2 * K3;
        const double* __restrict__ T2 = terms.t2[t];
        const double* __restrict__ T3 = terms.t3[t];

        // (1) stage 2 into shared memory
        double* Xs = scr;                         // [kTailJ][kTailKc]
        double* T2s = scr + kTailJ * kTailKc;     // [kTailJ][kTailRows]
        for (int k0 = 0; k0 < K3; k0 += kTailKc) {
            double y[3][4];
#pragma unroll
            for (int q = 0; q < 3; ++q)
#pragma unroll
                for (int r = 0; r < 4; ++r) y[q][r] = 0.0;
            for (int j0 = 0; j0 < K2; j0 += kTailJ) {
                for (int i = threadIdx.x; i < kTailJ * kTailKc; i += kThreads) {
                    const int j = j0 + i / kTailKc, k = k0 + i % kTailKc;
                    Xs[i] = (j < K2 && k < K3) ? X[(long long)j * K3 + k] : 0.0;
                }
                for (int i = threadIdx.x; i < kTailJ * kTailRows;
                     i += kThreads) {
                    const int bb = i / kTailJ, jj = i % kTailJ;
                    const int b = b0 + bb, j = j0 + jj;
                    T2s[jj * kTailRows + bb] =
                        (b < M2 && j < K2) ? T2[(long long)b * K2 + j] : 0.0;
                }
                __syncthreads();
#pragma unroll 4
                for (int jj = 0; jj < kTailJ; ++jj) {
                    double xv[3], tv[4];
#pragma unroll
                    for (int q = 0; q < 3; ++q)
                        xv[q] = Xs[jj * kTailKc + lane + kTailLanes * q];
#pragma unroll
                    for (int r = 0; r < 4; ++r)
                        tv[r] = T2s[jj * kTailRows + row0 + r];
#pragma unroll
                    for (int q = 0; q < 3; ++q)
#pragma unroll
                        for (int r = 0; r < 4; ++r)
                            y[q][r] = fma(xv[q], tv[r], y[q][r]);
                }
                __syncthreads();
            }
#pragma unroll
            for (int q = 0; q < 3; ++q) {
                const int k = k0 + lane + kTailLanes * q;
                if (k < K3) {
#pragma unroll
                    for (int r = 0; r < 4; ++r)
                        Y2s[k * kTailRows + row0 + r] = y[q][r];
                }
            }
        }
        __syncthreads();

        // (2) the final stage into the registers
        double* T3s = scr;                        // [kTailKs][CW]
        for (int k0 = 0; k0 < K3; k0 += kTailKs) {
            for (int i = threadIdx.x; i < kTailKs * CW; i += kThreads) {
                const int cc = i / kTailKs, kk = i % kTailKs;
                const int c = c0 + cc, k = k0 + kk;
                T3s[kk * CW + cc] =
                    (c < M3 && k < K3) ? T3[(long long)c * K3 + k] : 0.0;
            }
            __syncthreads();
            const int kn = min(kTailKs, K3 - k0);
            for (int kk = 0; kk < kn; ++kk) {
                double yv[4], tv[NC];
#pragma unroll
                for (int r = 0; r < 4; ++r)
                    yv[r] = Y2s[(k0 + kk) * kTailRows + row0 + r];
#pragma unroll
                for (int c = 0; c < NC; ++c)
                    tv[c] = T3s[kk * CW + lane + kTailLanes * c];
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int c = 0; c < NC; ++c)
                        acc[r][c] = fma(yv[r], tv[c], acc[r][c]);
            }
            __syncthreads();
        }
    }

    // (3) one store of the slab
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int b = b0 + row0 + r;
        if (b >= M2) continue;
        double* o = out + ((long long)a * M2 + b) * M3;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            const int cc = c0 + lane + kTailLanes * c;
            if (cc < M3) o[cc] = acc[r][c];
        }
    }
}

template <int NC>
static int launch_tail(const TailTerms& terms, int M1, int K2, int K3,
                       int M2, int M3, double* out, cudaStream_t s) {
    const int scratch = kTailJ * kTailKc + kTailJ * kTailRows;
    const int scratch3 = kTailKs * kTailLanes * NC;
    const size_t bytes = sizeof(double) *
        ((size_t)K3 * kTailRows + (scratch > scratch3 ? scratch : scratch3));
    cudaError_t err = cudaFuncSetAttribute(
        tail_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned int)M1,
                    (unsigned int)((M2 + kTailRows - 1) / kTailRows),
                    (unsigned int)((M3 + kTailLanes * NC - 1)
                                   / (kTailLanes * NC)));
    tail_kernel<NC><<<grid, kThreads, bytes, s>>>(terms, K2, K3, M2, M3,
                                                  out);
    return (int)cudaGetLastError();
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

PYIGA_EXPORT int pyiga_stage_T_f64(const double* X, const double* T,
                                   double* out, int K, long long R, int M,
                                   void* stream) {
    const dim3 grid((unsigned int)((R + kBR - 1) / kBR),
                    (unsigned int)((M + kBM - 1) / kBM));
    stage_T_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(X, T, K, R,
                                                                 M, out);
    return (int)cudaGetLastError();
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
    TailTerms terms;
    terms.n = n_terms;
    for (int t = 0; t < n_terms; ++t) {
        terms.x[t] = reinterpret_cast<const double*>(x_ptrs[t]);
        terms.t2[t] = reinterpret_cast<const double*>(t2_ptrs[t]);
        terms.t3[t] = reinterpret_cast<const double*>(t3_ptrs[t]);
    }
    int nc = (M3 + kTailLanes - 1) / kTailLanes;
    if (nc > kTailMaxNC) nc = kTailMaxNC;
    cudaStream_t s = (cudaStream_t)stream;
    switch (nc) {
#define PYIGA_TAIL(N) \
    case N: return launch_tail<N>(terms, M1, K2, K3, M2, M3, out, s)
        PYIGA_TAIL(1); PYIGA_TAIL(2); PYIGA_TAIL(3); PYIGA_TAIL(4);
        PYIGA_TAIL(5); PYIGA_TAIL(6); PYIGA_TAIL(7); PYIGA_TAIL(8);
#undef PYIGA_TAIL
        default: return (int)cudaErrorInvalidValue;
    }
}

PYIGA_EXPORT const char* pyiga_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
