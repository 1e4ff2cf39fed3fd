// Geometry-field kernels for Hopper (sm_90a), float64.
//
// K1  geo_fields_kernel<D, G, NURBS, KIND, NL>  replaces
//     pyiga_tpu/ops/pallas_sumfac.py `_fields_fused` (pallas_call at :1087,
//     body `_make_stiff_fields_fused_kernel`) in its three kinds:
//     'stiffness', 'mass' (through `mass_fields_pallas`, :1411) and 'jac'
//     (through `geo_jac_fields_pallas`, :1421, for the generic VForm
//     fields).
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

// Launch K1 of `kind` (0 stiffness, 1 mass, 2 jac).  The block takes
// min(256, QL rounded up to a warp) threads and RB rows: 16, halved while
// the grid has fewer than two blocks an SM or the staged rows would take
// more than 48 KB of shared memory.
template <int D, int G, bool NURBS, int KIND, int NL>
static int launch_one(const double* Y, const double* T, const double* w12,
                      const double* wL, double* out, int Q12, int QL, int nL,
                      cudaStream_t s) {
    int rb = 16;
    const long long per_row = 8LL * D * (G + (NURBS ? 1 : 0)) * nL;
    while (rb > 1 && ((Q12 + rb - 1) / rb < 2 * 132 || rb * per_row > 49152))
        rb /= 2;
    const long long smem = rb * per_row;
    auto kernel = geo_fields_kernel<D, G, NURBS, KIND, NL>;
    if (smem > 49152) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    int threads = (QL + 31) / 32 * 32;
    if (threads > 256) threads = 256;
    kernel<<<(Q12 + rb - 1) / rb, threads, (size_t)smem, s>>>(
        Y, T, w12, wL, out, Q12, QL, nL, rb);
    return (int)cudaGetLastError();
}

template <int D, int G, bool NURBS, int KIND>
static int launch_nl(const double* Y, const double* T, const double* w12,
                     const double* wL, double* out, int Q12, int QL, int nL,
                     cudaStream_t s) {
    switch (nL) {
        case 1: return launch_one<D, G, NURBS, KIND, 1>(Y, T, w12, wL, out,
                                                        Q12, QL, nL, s);
        case 2: return launch_one<D, G, NURBS, KIND, 2>(Y, T, w12, wL, out,
                                                        Q12, QL, nL, s);
        case 3: return launch_one<D, G, NURBS, KIND, 3>(Y, T, w12, wL, out,
                                                        Q12, QL, nL, s);
        case 4: return launch_one<D, G, NURBS, KIND, 4>(Y, T, w12, wL, out,
                                                        Q12, QL, nL, s);
        default: return launch_one<D, G, NURBS, KIND, 0>(Y, T, w12, wL, out,
                                                         Q12, QL, nL, s);
    }
}

template <int D, int G, int KIND>
static int launch_nurbs(const double* Y, const double* T, const double* w12,
                        const double* wL, double* out, int nurbs, int q,
                        int QL, int nL, cudaStream_t s) {
    return nurbs ? launch_nl<D, G, true, KIND>(Y, T, w12, wL, out, q, QL, nL,
                                               s)
                 : launch_nl<D, G, false, KIND>(Y, T, w12, wL, out, q, QL,
                                                nL, s);
}

// d the parametric dimension, g the geometry's output dimension (d for
// the stiffness and mass kinds; d or d + 1 for the jac kind)
template <int KIND>
static int launch_fields(const double* Y, const double* T, const double* w12,
                         const double* wL, double* out, int d, int g,
                         int nurbs, long long Q12, int QL, int nL,
                         void* stream) {
    if (Q12 < 1 || QL < 1 || nL < 1 || Q12 >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int q = (int)Q12;
    if constexpr (KIND == kJac) {
        if (d == 1 && g == 1)     // 1D: no leading axes, nL at run time
            return nurbs ? launch_one<1, 1, true, kJac, 0>(
                               Y, T, w12, wL, out, q, QL, nL, s)
                         : launch_one<1, 1, false, kJac, 0>(
                               Y, T, w12, wL, out, q, QL, nL, s);
        if (d == 1 && g == 2)     // a curve in the plane
            return nurbs ? launch_one<1, 2, true, kJac, 0>(
                               Y, T, w12, wL, out, q, QL, nL, s)
                         : launch_one<1, 2, false, kJac, 0>(
                               Y, T, w12, wL, out, q, QL, nL, s);
        if (d == 2 && g == 3)     // a surface in space
            return launch_nurbs<2, 3, kJac>(Y, T, w12, wL, out, nurbs, q, QL,
                                            nL, s);
    }
    if (g != d) return (int)cudaErrorInvalidValue;
    if (d == 2)
        return launch_nurbs<2, 2, KIND>(Y, T, w12, wL, out, nurbs, q, QL, nL,
                                        s);
    if (d == 3)
        return launch_nurbs<3, 3, KIND>(Y, T, w12, wL, out, nurbs, q, QL, nL,
                                        s);
    return (int)cudaErrorInvalidValue;
}

PYIGA_EXPORT int pyiga_stiff_fields_f64(const double* Y, const double* T,
                                        const double* w12, const double* wL,
                                        double* out, int d, int nurbs,
                                        long long Q12, int QL, int nL,
                                        void* stream) {
    return launch_fields<kStiffness>(Y, T, w12, wL, out, d, d, nurbs, Q12,
                                     QL, nL, stream);
}

PYIGA_EXPORT int pyiga_mass_fields_f64(const double* Y, const double* T,
                                       const double* w12, const double* wL,
                                       double* out, int d, int nurbs,
                                       long long Q12, int QL, int nL,
                                       void* stream) {
    return launch_fields<kMass>(Y, T, w12, wL, out, d, d, nurbs, Q12, QL, nL,
                                stream);
}

PYIGA_EXPORT int pyiga_geo_jac_fields_f64(const double* Y, const double* T,
                                          double* out, int d, int g,
                                          int nurbs, long long Q12, int QL,
                                          int nL, void* stream) {
    return launch_fields<kJac>(Y, T, nullptr, nullptr, out, d, g, nurbs, Q12,
                               QL, nL, stream);
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
