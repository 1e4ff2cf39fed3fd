// Geometry-field kernels for Hopper (sm_90a), float64.
//
// K1  geo_fields_kernel<D, G, NURBS, KIND, NL>  replaces
//     pyiga_tpu/ops/pallas_sumfac.py `_fields_fused` (pallas_call at :1087,
//     body `_make_stiff_fields_fused_kernel`) in its three kinds:
//     'stiffness', 'mass' (through `mass_fields_pallas`, :1411) and 'jac'
//     (through `geo_jac_fields_pallas`, :1421, for the generic VForm
//     fields).
// K1 backward geo_fields_bwd_kernel<D, G, NURBS, KIND, NL>: the gradient
//     of the three kinds with respect to Y, for the differentiable
//     assembly (pyiga_tpu_torch/diff.py; the JAX package differentiates
//     K1's XLA form).
// K1' host_jac_fields_kernel  replaces `stiffness_fields_pallas`'s
//     host-Jacobian branch (pallas_call at :1163, body
//     `_make_stiff_fields_kernel`, :930).
//
// The TPU kernels carry float64 as two-float f32 pairs because the v5e has
// no f64 arithmetic; Hopper has native f64, so these compute in double
// directly.

#include "common.cuh"

// --------------------------------------------------------------------------
// Per-point algebra: determinant, inverse by the adjugate (as
// ops/geom.det_and_inv and the JAX package's geom.py) and the unique
// stiffness fields.
// --------------------------------------------------------------------------

template <int D>
__device__ __forceinline__ double det_of(double (&J)[D][D]) {
    if constexpr (D == 1) {
        return J[0][0];
    } else if constexpr (D == 2) {
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
    static_assert(D == 2 || D == 3, "the stiffness fields need D = 2, 3");
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
// K1: geometry fields on the Gauss grid.
//
// KIND kStiffness: B_ab = W (J^-1 J^-T)_ab, W = gw |det J|; out
//   (D(D+1)/2, Q12, QL), the unique B_ab (a <= b, row-major).
// KIND kMass: the mass field W = gw |det J| alone; out (Q12, QL).
// KIND kJac: out (G + G*D, Q12, QL), rows 0..G-1 the physical values x_c
//   (level order), then J[c][k] = d x_c / d xi_k row-major; for NURBS the
//   quotient V / W and its quotient-rule Jacobian.  G, the geometry's
//   output dimension, is D for a volume map and D + 1 for a surface (a
//   3D surface over a 2D space, a 2D curve over a 1D one); the stiffness
//   and mass kinds take G = D.
//
// Inputs (all row-major float64):
//   Y    (D, C, Q12, nL)  stage-1/2 geometry partials from K2: entry
//        [t, c, q12, j] holds component c contracted over the leading D-1
//        axes with the derivative table on axis t (t = D-1: all values),
//        the last coefficient axis j still open.
//   T    (2, QL, nL)      last-axis value (0) and derivative (1) tables.
//   w12  (Q12,), wL (QL,) the Gauss weights (not read by kJac).
// C = G components for a B-spline map, G + 1 (homogeneous, weight last)
// for NURBS, whose quotient rule runs before the determinant.
// A boundary Gauss grid collapses one axis to a point: QL = 1 leaves one
// active thread a block (a launch of 32 threads), Q12 = Q_1 = 1 (a 2D
// 'bottom' face) one block of rows; both run the general code.
//
// Bound: the output writes (6, 1 and 12 doubles a point at 3D), one
// coalesced store per field.  A point's work is small, so the instructions
// per point decide how near the bound a kernel comes: with nL known only
// at run time, each of the C x D dots compiles into unrolled bodies with
// remainder branches and 64-bit address arithmetic (2,280 SASS
// instructions for the 3D mass kind of a one-thread-a-point grid-stride
// loop, which also divides the 64-bit point index).  So:
// * a block owns RB rows q12 and all QL points of each: its Y rows (D x C
//   x RB x nL doubles) come into shared memory once, in one coalesced
//   copy, and a thread's column qL keeps its table values (2 x nL) in
//   registers across the RB points it computes;
// * nL is a template parameter for 1..4 (every geometry on the paths has
//   nL = 2), the dots fully unrolled; above 4 a runtime loop (NL = 0);
// * no division of indices: the block's rows and the thread's columns
//   come from blockIdx and threadIdx; a thread's row loop is unrolled
//   twice, two points in flight;
// * the per-point algebra is the first design's, in the JAX package's
//   order (adj / det, no reciprocal).
// --------------------------------------------------------------------------

enum FieldsKind { kStiffness = 0, kMass = 1, kJac = 2 };

// The last-axis value and derivative tables of column qL: in registers for
// a compile-time nL, read from memory at each dot otherwise.
template <int NL>
struct LastTables {
    double v[NL], d[NL];
    __device__ __forceinline__ LastTables(const double* T, int QL, int qL,
                                          int) {
#pragma unroll
        for (int j = 0; j < NL; ++j) {
            v[j] = __ldg(T + (long long)qL * NL + j);
            d[j] = __ldg(T + ((long long)QL + qL) * NL + j);
        }
    }
    __device__ __forceinline__ double dot(bool deriv, const double* y) const {
        double s = 0.0;
#pragma unroll
        for (int j = 0; j < NL; ++j) s += (deriv ? d[j] : v[j]) * y[j];
        return s;
    }
};

template <>
struct LastTables<0> {
    const double* v;
    const double* d;
    int nL;
    __device__ __forceinline__ LastTables(const double* T, int QL, int qL,
                                          int nL_)
        : v(T + (long long)qL * nL_), d(T + ((long long)QL + qL) * nL_),
          nL(nL_) {}
    __device__ __forceinline__ double dot(bool deriv, const double* y) const {
        const double* t = deriv ? d : v;
        double s = 0.0;
        for (int j = 0; j < nL; ++j) s += __ldg(t + j) * y[j];
        return s;
    }
};

template <int D, int G, bool NURBS, int KIND, int NL>
__global__ void __launch_bounds__(256)
geo_fields_kernel(const double* __restrict__ Y, const double* __restrict__ T,
                  const double* __restrict__ w12,
                  const double* __restrict__ wL, double* __restrict__ out,
                  int Q12, int QL, int nL_, int RB) {
    static_assert(KIND == kJac || G == D, "only the jac kind takes G != D");
    constexpr int C = G + (NURBS ? 1 : 0);
    const int nL = NL ? NL : nL_;
    extern __shared__ double sY[];      // [D * C][RB][nL]
    const int r0 = blockIdx.x * RB;
    const int rows = min(RB, Q12 - r0);
    const int seg = rows * nL;
    for (int k = threadIdx.x; k < D * C * seg; k += blockDim.x) {
        const int tc = k / seg, e = k - tc * seg;
        sY[tc * RB * nL + e] = __ldg(Y + ((long long)tc * Q12 + r0) * nL + e);
    }
    __syncthreads();

    const long long N = (long long)Q12 * QL;
    for (int qL = threadIdx.x; qL < QL; qL += blockDim.x) {
        const LastTables<NL> tab(T, QL, qL, nL);
        const double wl = KIND == kJac ? 0.0 : __ldg(wL + qL);
#pragma unroll 2
        for (int r = 0; r < rows; ++r) {
            const double* yr = sY + r * nL;
            // last-axis contraction: jac[c][k] (derivative axis k), val[c]
            double jac[C][D];
            double val[C];
#pragma unroll
            for (int c = 0; c < C; ++c) {
#pragma unroll
                for (int k = 0; k < D; ++k) {
                    const int t = k < D - 1 ? k : D - 1;
                    jac[c][k] = tab.dot(k == D - 1,
                                        yr + (t * C + c) * RB * nL);
                }
                if constexpr (NURBS || KIND == kJac)
                    val[c] = tab.dot(false, yr + ((D - 1) * C + c) * RB * nL);
            }
            const long long g = (long long)(r0 + r) * QL + qL;
            if constexpr (KIND == kJac) {
                if constexpr (NURBS) {
                    const double W = val[C - 1];
                    const double WW = W * W;
#pragma unroll
                    for (int c = 0; c < G; ++c)
#pragma unroll
                        for (int k = 0; k < D; ++k)
                            jac[c][k] = (jac[c][k] * W
                                         - val[c] * jac[C - 1][k]) / WW;
#pragma unroll
                    for (int c = 0; c < G; ++c) val[c] = val[c] / W;
                }
#pragma unroll
                for (int c = 0; c < G; ++c) out[(long long)c * N + g] = val[c];
#pragma unroll
                for (int c = 0; c < G; ++c)
#pragma unroll
                    for (int k = 0; k < D; ++k)
                        out[(long long)(G + c * D + k) * N + g] = jac[c][k];
            } else {
                // physical Jacobian J[c][k]; NURBS: quotient rule on V / W
                double J[D][D];
                if constexpr (NURBS) {
                    const double W = val[C - 1];
                    const double WW = W * W;
#pragma unroll
                    for (int c = 0; c < D; ++c)
#pragma unroll
                        for (int k = 0; k < D; ++k)
                            J[c][k] = (jac[c][k] * W - val[c] * jac[C - 1][k])
                                      / WW;
                } else {
#pragma unroll
                    for (int c = 0; c < D; ++c)
#pragma unroll
                        for (int k = 0; k < D; ++k) J[c][k] = jac[c][k];
                }
                const double gw = __ldg(w12 + r0 + r) * wl;
                if constexpr (KIND == kMass) {
                    out[g] = gw * fabs(det_of<D>(J));
                } else {
                    double inv[D][D];
                    const double det = det_and_inv<D>(J, inv);
                    store_stiffness<D>(inv, gw * fabs(det), out, N, g);
                }
            }
        }
    }
}

// --------------------------------------------------------------------------
// K1's backward: geo_fields_bwd_kernel<D, G, NURBS, KIND, NL>.
//
// The JAX package differentiates the XLA form of K1 (pyiga_tpu/diff.py
// builds on `asm.field_fn` with mode='exact', no Pallas kernel); the
// port's forward on the card is K1 itself, so its gradient is a kernel
// too.  In: Y, T (and w12, wL for the stiffness and mass kinds) as the
// forward takes them, and gout, the gradient of the forward's output (its
// shape).  Out: gY (D, C, Q12, nL), the gradient of Y.
//
// Per Gauss point the kernel recomputes the homogeneous Jacobian jh[c][k]
// and the values val[c] from the staged Y rows and the column's last-axis
// tables, as the forward does, then applies the VJP of the kind:
//   stiffness B = s J^-1 J^-T (s = gw |det J|, the unique a <= b stored;
//     the off-diagonal gradient split between the mirrored entries into a
//     symmetric Gs): gJ = s ((Gs : M) J^-T - 2 J^-T Gs M), M = J^-1 J^-T;
//   mass s: gJ = g s J^-T;
//   jac (x, J): the gradients as they come;
// then, for NURBS, the quotient rule's (J = (jh W - val jh_W) / W^2,
// x = val / W).  That leaves per point and (t, c) the coefficients a_v of
// the value table and (t = D-1 only) a_d of the derivative table:
//   gY[t, c, q12, j] = sum_qL a_v[t][c] Tv[qL, j] + a_d[c] Td[qL, j].
// The order of the algebra is that of the formulas in
// ops/cuda_sumfac._fields_vjp_plain.
//
// The sum over the last axis: a block owns RB rows q12 (their Y rows in
// shared memory, as the forward), and walks them one at a time.  For a
// row, each thread computes the a's of one column qL (chunks of
// blockDim.x columns when QL is larger) into shared memory; then each
// warp takes outputs (t, c, j) in turn, its lanes sum the chunk's columns
// lane, lane + 32, ..., and a butterfly of shuffles adds the lanes; lane 0
// adds the chunk's sum to the row's.  Every sum has a fixed order: no
// atomics, bitwise equal on a repeat.
//
// Bound: bytes, Y read once, gout read once, gY written once (gout
// dominates: 6, 1 or 12 doubles a point at 3D).  The per-point algebra is
// some 150-250 flops (stiffness, 3D), above the forward's, so this kernel
// is further from its bound than the forward; a first, plain design.
// --------------------------------------------------------------------------

template <int D, int G, bool NURBS, int KIND, int NL>
__global__ void __launch_bounds__(256)
geo_fields_bwd_kernel(const double* __restrict__ Y,
                      const double* __restrict__ T,
                      const double* __restrict__ w12,
                      const double* __restrict__ wL,
                      const double* __restrict__ gout,
                      double* __restrict__ gY, int Q12, int QL, int nL_,
                      int RB) {
    static_assert(KIND == kJac || G == D, "only the jac kind takes G != D");
    constexpr int C = G + (NURBS ? 1 : 0);
    constexpr int NA = (D + 1) * C;     // a_v[t][c], then a_d[c]
    const int nL = NL ? NL : nL_;
    const int bd = blockDim.x;
    extern __shared__ double smem[];
    double* sY = smem;                          // [D * C][RB][nL]
    double* sA = sY + D * C * RB * nL;          // [NA][bd]
    double* sG = sA + NA * bd;                  // [D * C][nL], a row's sums
    const int r0 = blockIdx.x * RB;
    const int rows = min(RB, Q12 - r0);
    const int seg = rows * nL;
    for (int k = threadIdx.x; k < D * C * seg; k += bd) {
        const int tc = k / seg, e = k - tc * seg;
        sY[tc * RB * nL + e] = __ldg(Y + ((long long)tc * Q12 + r0) * nL + e);
    }
    __syncthreads();

    const long long N = (long long)Q12 * QL;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = bd >> 5;
    const int NO = D * C * nL;
    for (int r = 0; r < rows; ++r) {
        const double* yr = sY + r * nL;
        for (int q0 = 0; q0 < QL; q0 += bd) {
            const int qL = q0 + threadIdx.x;
            double av[D][C], ad[C];
#pragma unroll
            for (int c = 0; c < C; ++c) {
                ad[c] = 0.0;
#pragma unroll
                for (int t = 0; t < D; ++t) av[t][c] = 0.0;
            }
            if (qL < QL) {
                const LastTables<NL> tab(T, QL, qL, nL);
                double jac[C][D], val[C];
#pragma unroll
                for (int c = 0; c < C; ++c) {
#pragma unroll
                    for (int k = 0; k < D; ++k) {
                        const int t = k < D - 1 ? k : D - 1;
                        jac[c][k] = tab.dot(k == D - 1,
                                            yr + (t * C + c) * RB * nL);
                    }
                    val[c] = (NURBS || KIND == kJac)
                        ? tab.dot(false, yr + ((D - 1) * C + c) * RB * nL)
                        : 0.0;
                }
                const long long g = (long long)(r0 + r) * QL + qL;
                double gJ[G][D], gx[G];
                if constexpr (KIND == kJac) {
#pragma unroll
                    for (int c = 0; c < G; ++c) {
                        gx[c] = __ldg(gout + (long long)c * N + g);
#pragma unroll
                        for (int k = 0; k < D; ++k)
                            gJ[c][k] = __ldg(gout + (long long)(G + c * D + k)
                                                        * N + g);
                    }
                } else {
                    double J[D][D];
#pragma unroll
                    for (int c = 0; c < D; ++c)
#pragma unroll
                        for (int k = 0; k < D; ++k)
                            J[c][k] = NURBS
                                ? (jac[c][k] * val[C - 1]
                                   - val[c] * jac[C - 1][k])
                                      / (val[C - 1] * val[C - 1])
                                : jac[c][k];
                    double inv[D][D];
                    const double det = det_and_inv<D>(J, inv);
                    const double s = __ldg(w12 + r0 + r) * __ldg(wL + qL)
                                     * fabs(det);
                    if constexpr (KIND == kMass) {
                        const double gs = __ldg(gout + g) * s;
#pragma unroll
                        for (int c = 0; c < D; ++c)
#pragma unroll
                            for (int k = 0; k < D; ++k)
                                gJ[c][k] = gs * inv[k][c];
                    } else {
                        double Gs[D][D], M[D][D];
                        int o = 0;
#pragma unroll
                        for (int a = 0; a < D; ++a)
#pragma unroll
                            for (int b = a; b < D; ++b) {
                                const double v =
                                    __ldg(gout + (long long)o * N + g);
                                Gs[a][b] = a == b ? v : 0.5 * v;
                                Gs[b][a] = Gs[a][b];
                                ++o;
                            }
#pragma unroll
                        for (int a = 0; a < D; ++a)
#pragma unroll
                            for (int b = 0; b < D; ++b) {
                                double m = 0.0;
#pragma unroll
                                for (int k = 0; k < D; ++k)
                                    m += inv[a][k] * inv[b][k];
                                M[a][b] = m;
                            }
                        double GM = 0.0;
#pragma unroll
                        for (int a = 0; a < D; ++a)
#pragma unroll
                            for (int b = 0; b < D; ++b) GM += Gs[a][b] * M[a][b];
                        double GMm[D][D];
#pragma unroll
                        for (int a = 0; a < D; ++a)
#pragma unroll
                            for (int j = 0; j < D; ++j) {
                                double m = 0.0;
#pragma unroll
                                for (int b = 0; b < D; ++b)
                                    m += Gs[a][b] * M[b][j];
                                GMm[a][j] = m;
                            }
#pragma unroll
                        for (int i = 0; i < D; ++i)
#pragma unroll
                            for (int j = 0; j < D; ++j) {
                                double p = 0.0;
#pragma unroll
                                for (int a = 0; a < D; ++a)
                                    p += inv[a][i] * GMm[a][j];
                                gJ[i][j] = s * (GM * inv[j][i] - 2.0 * p);
                            }
                    }
                }
                if constexpr (NURBS) {
                    const double W = val[C - 1];
                    const double WW = W * W;
                    double gW = 0.0;
#pragma unroll
                    for (int c = 0; c < G; ++c)
#pragma unroll
                        for (int k = 0; k < D; ++k)
                            gW += gJ[c][k] * (2.0 * val[c] * jac[C - 1][k]
                                              / (WW * W) - jac[c][k] / WW);
#pragma unroll
                    for (int k = 0; k < D; ++k) {
                        double m = 0.0;
#pragma unroll
                        for (int c = 0; c < G; ++c) m += gJ[c][k] * val[c];
                        const double gjw = -m / WW;
                        if (k < D - 1) av[k][C - 1] = gjw;
                        else ad[C - 1] = gjw;
                    }
#pragma unroll
                    for (int c = 0; c < G; ++c) {
                        double m = 0.0;
#pragma unroll
                        for (int k = 0; k < D; ++k) m += gJ[c][k] * jac[C - 1][k];
                        double gv = -m / WW;
                        if constexpr (KIND == kJac) gv = gv + gx[c] / W;
                        av[D - 1][c] = gv;
#pragma unroll
                        for (int k = 0; k < D; ++k) {
                            if (k < D - 1) av[k][c] = gJ[c][k] / W;
                            else ad[c] = gJ[c][k] / W;
                        }
                    }
                    if constexpr (KIND == kJac) {
                        double m = 0.0;
#pragma unroll
                        for (int c = 0; c < G; ++c) m += gx[c] * val[c];
                        gW = gW - m / WW;
                    }
                    av[D - 1][C - 1] = gW;
                } else {
#pragma unroll
                    for (int c = 0; c < G; ++c) {
#pragma unroll
                        for (int k = 0; k < D; ++k) {
                            if (k < D - 1) av[k][c] = gJ[c][k];
                            else ad[c] = gJ[c][k];
                        }
                        if constexpr (KIND == kJac) av[D - 1][c] = gx[c];
                    }
                }
            }
#pragma unroll
            for (int c = 0; c < C; ++c) {
                sA[(D * C + c) * bd + threadIdx.x] = ad[c];
#pragma unroll
                for (int t = 0; t < D; ++t)
                    sA[(t * C + c) * bd + threadIdx.x] = av[t][c];
            }
            __syncthreads();
            const int len = min(bd, QL - q0);
            for (int o = warp; o < NO; o += nwarps) {
                const int tc = o / nL, j = o - tc * nL;
                const int c = tc % C;
                const bool last = tc >= (D - 1) * C;
                double s = 0.0;
                for (int q = lane; q < len; q += 32) {
                    const long long qq = q0 + q;
                    double v = sA[tc * bd + q] * __ldg(T + qq * nL + j);
                    if (last)
                        v += sA[(D * C + c) * bd + q]
                             * __ldg(T + ((long long)QL + qq) * nL + j);
                    s += v;
                }
#pragma unroll
                for (int off = 16; off > 0; off >>= 1)
                    s += __shfl_xor_sync(0xffffffffu, s, off);
                if (lane == 0) sG[o] = q0 == 0 ? s : sG[o] + s;
            }
            __syncthreads();
        }
        for (int o = threadIdx.x; o < NO; o += bd) {
            const int tc = o / nL, j = o - tc * nL;
            gY[((long long)tc * Q12 + r0 + r) * nL + j] = sG[o];
        }
    }
}

// --------------------------------------------------------------------------
// Launches of K1 and its backward.  The block takes min(256, QL rounded up
// to a warp) threads and RB rows: 16, halved while the grid has fewer than
// two blocks an SM or the shared memory would pass 48 KB (the backward's
// adds a chunk of per-point coefficients and a row's sums to the staged
// rows); past 48 KB at one row the kernel is given the larger limit.
// --------------------------------------------------------------------------

struct FieldsArgs {
    const double* Y;
    const double* T;
    const double* w12;
    const double* wL;
    const double* gout;     // backward only
    double* out;            // the output, or gY for the backward
    int Q12, QL, nL;
    cudaStream_t s;
};

template <int D, int G, bool NURBS, int KIND, int NL, bool BWD>
static int launch_one(const FieldsArgs& a) {
    constexpr int C = G + (NURBS ? 1 : 0);
    int threads = (a.QL + 31) / 32 * 32;
    if (threads > 256) threads = 256;
    const long long per_row = 8LL * D * C * a.nL;
    const long long extra =
        BWD ? 8LL * (D + 1) * C * threads + 8LL * D * C * a.nL : 0;
    int rb = 16;
    while (rb > 1 && ((a.Q12 + rb - 1) / rb < 2 * 132
                      || rb * per_row + extra > 49152))
        rb /= 2;
    const long long smem = rb * per_row + extra;
    const unsigned int grid = (unsigned int)((a.Q12 + rb - 1) / rb);
    if constexpr (BWD) {
        auto kernel = geo_fields_bwd_kernel<D, G, NURBS, KIND, NL>;
        if (smem > 49152) {
            const cudaError_t e = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)smem);
            if (e != cudaSuccess) return (int)e;
        }
        kernel<<<grid, threads, (size_t)smem, a.s>>>(
            a.Y, a.T, a.w12, a.wL, a.gout, a.out, a.Q12, a.QL, a.nL, rb);
    } else {
        auto kernel = geo_fields_kernel<D, G, NURBS, KIND, NL>;
        if (smem > 49152) {
            const cudaError_t e = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)smem);
            if (e != cudaSuccess) return (int)e;
        }
        kernel<<<grid, threads, (size_t)smem, a.s>>>(
            a.Y, a.T, a.w12, a.wL, a.out, a.Q12, a.QL, a.nL, rb);
    }
    return (int)cudaGetLastError();
}

template <int D, int G, bool NURBS, int KIND, bool BWD>
static int launch_nl(const FieldsArgs& a) {
    switch (a.nL) {
        case 1: return launch_one<D, G, NURBS, KIND, 1, BWD>(a);
        case 2: return launch_one<D, G, NURBS, KIND, 2, BWD>(a);
        case 3: return launch_one<D, G, NURBS, KIND, 3, BWD>(a);
        case 4: return launch_one<D, G, NURBS, KIND, 4, BWD>(a);
        default: return launch_one<D, G, NURBS, KIND, 0, BWD>(a);
    }
}

template <int D, int G, int KIND, bool BWD>
static int launch_nurbs(const FieldsArgs& a, int nurbs) {
    return nurbs ? launch_nl<D, G, true, KIND, BWD>(a)
                 : launch_nl<D, G, false, KIND, BWD>(a);
}

// d the parametric dimension, g the geometry's output dimension (d for
// the stiffness and mass kinds; d or d + 1 for the jac kind)
template <int KIND, bool BWD>
static int launch_fields(const double* Y, const double* T, const double* w12,
                         const double* wL, const double* gout, double* out,
                         int d, int g, int nurbs, long long Q12, int QL,
                         int nL, void* stream) {
    if (Q12 < 1 || QL < 1 || nL < 1 || Q12 >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    const FieldsArgs a{Y, T, w12, wL, gout, out, (int)Q12, QL, nL,
                       (cudaStream_t)stream};
    if constexpr (KIND == kJac) {
        if (d == 1 && g == 1)     // 1D: no leading axes, nL at run time
            return nurbs ? launch_one<1, 1, true, kJac, 0, BWD>(a)
                         : launch_one<1, 1, false, kJac, 0, BWD>(a);
        if (d == 1 && g == 2)     // a curve in the plane
            return nurbs ? launch_one<1, 2, true, kJac, 0, BWD>(a)
                         : launch_one<1, 2, false, kJac, 0, BWD>(a);
        if (d == 2 && g == 3)     // a surface in space
            return launch_nurbs<2, 3, kJac, BWD>(a, nurbs);
    }
    if (g != d) return (int)cudaErrorInvalidValue;
    if (d == 2) return launch_nurbs<2, 2, KIND, BWD>(a, nurbs);
    if (d == 3) return launch_nurbs<3, 3, KIND, BWD>(a, nurbs);
    return (int)cudaErrorInvalidValue;
}

PYIGA_EXPORT int pyiga_stiff_fields_f64(const double* Y, const double* T,
                                        const double* w12, const double* wL,
                                        double* out, int d, int nurbs,
                                        long long Q12, int QL, int nL,
                                        void* stream) {
    return launch_fields<kStiffness, false>(Y, T, w12, wL, nullptr, out, d,
                                            d, nurbs, Q12, QL, nL, stream);
}

PYIGA_EXPORT int pyiga_mass_fields_f64(const double* Y, const double* T,
                                       const double* w12, const double* wL,
                                       double* out, int d, int nurbs,
                                       long long Q12, int QL, int nL,
                                       void* stream) {
    return launch_fields<kMass, false>(Y, T, w12, wL, nullptr, out, d, d,
                                       nurbs, Q12, QL, nL, stream);
}

PYIGA_EXPORT int pyiga_geo_jac_fields_f64(const double* Y, const double* T,
                                          double* out, int d, int g,
                                          int nurbs, long long Q12, int QL,
                                          int nL, void* stream) {
    return launch_fields<kJac, false>(Y, T, nullptr, nullptr, nullptr, out,
                                      d, g, nurbs, Q12, QL, nL, stream);
}

// K1's backward of `kind` (0 stiffness, 1 mass, 2 jac): gY from gout.
PYIGA_EXPORT int pyiga_fields_bwd_f64(int kind, const double* Y,
                                      const double* T, const double* w12,
                                      const double* wL, const double* gout,
                                      double* gY, int d, int g, int nurbs,
                                      long long Q12, int QL, int nL,
                                      void* stream) {
    switch (kind) {
        case kStiffness:
            return launch_fields<kStiffness, true>(Y, T, w12, wL, gout, gY,
                                                   d, g, nurbs, Q12, QL, nL,
                                                   stream);
        case kMass:
            return launch_fields<kMass, true>(Y, T, w12, wL, gout, gY, d, g,
                                              nurbs, Q12, QL, nL, stream);
        case kJac:
            return launch_fields<kJac, true>(Y, T, w12, wL, gout, gY, d, g,
                                             nurbs, Q12, QL, nL, stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

// --------------------------------------------------------------------------
// K1': stiffness fields from a Jacobian evaluated on the host.  Replaces
// the non-spline branch of `stiffness_fields_pallas`
// (pyiga_tpu/ops/pallas_sumfac.py, pallas_call at :1163, body
// `_make_stiff_fields_kernel`, :930), which runs for a geometry given as
// a user function (`geometry.UserFunction`).
//
// Inputs (row-major float64): jac (D, D, Q12, QL), the level-ordered
// Jacobian J[a][b] at every Gauss point; w12 (Q12,) and wL (QL,), the
// Gauss weights as K1 takes them (w12 the product of the leading axes'
// weights), so gw = w12[r] wL[c] is gauss_weight_field's (w0 w1) w2.
// Output: out (D(D+1)/2, Q12, QL), the unique B_ab = gw |det J|
// (J^-1 J^-T)_ab for a <= b, row-major (the order the assembler expands).
//
// Bound: device memory, D*D doubles read and D(D+1)/2 written per point,
// every access coalesced across the warp (the field axis leads, the point
// axis is contiguous).  No lane padding: any QL (the TPU's multiple of 128
// is its (8, 128) tiling rule).  K1's mapping: a block owns RB rows, a
// thread a column qL of each, the row loop unrolled twice (two points in
// flight); no index is divided; the algebra is K1's, adj / det.
// --------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(256)
host_jac_fields_kernel(const double* __restrict__ jac,
                       const double* __restrict__ w12,
                       const double* __restrict__ wL,
                       double* __restrict__ out, int Q12, int QL, int RB) {
    const long long N = (long long)Q12 * QL;
    const int r0 = blockIdx.x * RB;
    const int rows = min(RB, Q12 - r0);
    for (int qL = threadIdx.x; qL < QL; qL += blockDim.x) {
        const double wl = __ldg(wL + qL);
#pragma unroll 2
        for (int r = 0; r < rows; ++r) {
            const long long g = (long long)(r0 + r) * QL + qL;
            double J[D][D];
#pragma unroll
            for (int a = 0; a < D; ++a)
#pragma unroll
                for (int b = 0; b < D; ++b)
                    J[a][b] = __ldg(jac + (a * D + b) * N + g);
            double inv[D][D];
            const double det = det_and_inv<D>(J, inv);
            const double gw = __ldg(w12 + r0 + r) * wl;
            store_stiffness<D>(inv, gw * fabs(det), out, N, g);
        }
    }
}

// RB and the threads as K1's launch_one: 16 rows, halved while the grid
// has fewer than two blocks an SM; min(256, QL rounded up to a warp).
PYIGA_EXPORT int pyiga_host_jac_fields_f64(const double* jac,
                                           const double* w12,
                                           const double* wL, double* out,
                                           int d, long long Q12, int QL,
                                           void* stream) {
    if (Q12 < 1 || QL < 1 || Q12 >= (1LL << 31) - 16)
        return (int)cudaErrorInvalidValue;
    const int q = (int)Q12;
    int rb = 16;
    while (rb > 1 && (q + rb - 1) / rb < 2 * 132) rb /= 2;
    int threads = (QL + 31) / 32 * 32;
    if (threads > 256) threads = 256;
    const unsigned int grid = (unsigned int)((q + rb - 1) / rb);
    cudaStream_t s = (cudaStream_t)stream;
    if (d == 2)
        host_jac_fields_kernel<2><<<grid, threads, 0, s>>>(jac, w12, wL, out,
                                                            q, QL, rb);
    else if (d == 3)
        host_jac_fields_kernel<3><<<grid, threads, 0, s>>>(jac, w12, wL, out,
                                                            q, QL, rb);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}
