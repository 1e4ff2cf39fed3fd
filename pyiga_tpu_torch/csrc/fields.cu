// Geometry-field kernels for Hopper (sm_90a), float64; K1 (all three
// kinds, forward and backward) and K1' also in float32.
//
// K1  geo_fields_kernel<D, G, NURBS, KIND, NL, ROWS, S>  replaces
//     pyiga_tpu/ops/pallas_sumfac.py `_fields_fused` (pallas_call at :1087,
//     body `_make_stiff_fields_fused_kernel`) in its three kinds:
//     'stiffness', 'mass' (through `mass_fields_pallas`, :1411) and 'jac'
//     (through `geo_jac_fields_pallas`, :1421, for the generic VForm
//     fields).
// K1 backward geo_fields_bwd_kernel<D, G, NURBS, KIND, NL, S>: the
//     gradient of the three kinds with respect to Y, for the
//     differentiable assembly (pyiga_tpu_torch/diff.py; the JAX package
//     differentiates K1's XLA form).
// K1' host_jac_fields_kernel<D, S>  replaces `stiffness_fields_pallas`'s
//     host-Jacobian branch (pallas_call at :1163, body
//     `_make_stiff_fields_kernel`, :930).
// K1-jvp geo_fields_jvp_kernel (fields_jvp.cu) and K1-hvp
//     geo_fields_hvp_kernel (fields_hvp.cu): the tangents of K1 and of
//     K1-bwd, the forward mode and the second derivatives of the
//     differentiable assembly.
//
// The templates of K1, K1-bwd, K1-jvp and K1-hvp are in fields.cuh; the
// float32 entries of K1 and K1-bwd are in fields_f32.cu (K1-jvp's in
// fields_jvp_f32.cu), so that nvcc compiles the two scalars' instances
// side by side.
//
// The TPU kernels carry float64 as two-float f32 pairs because the v5e has
// no f64 arithmetic; Hopper has native f64, so these compute in double
// directly.  K1 (forward and backward) and K1' are templated on their
// scalar S: the float32 instances (pyiga_stiff_fields_f32,
// pyiga_mass_fields_f32, pyiga_geo_jac_fields_f32,
// pyiga_host_jac_fields_f32, pyiga_fields_bwd_f32) are the f32 line's
// (pyiga_tpu_torch.config.set_dtype(np.float32)), which the JAX package
// runs by casting the geometry inputs to float32 before the same fields
// (pyiga_tpu/ops/sumfac.py:676, pyiga_tpu/compile.py:1250-1262) and
// differentiating that float32 form (pyiga_tpu/diff.py:118-132): the
// contraction, the NURBS quotient, det J, the inverse, the VJP and the
// sum back over the last axis all run in float32, never in double
// rounded at the end (no double literal, no double function: fabsf and
// copysignf through sabs and scopysign; the sum in the double kernel's
// fixed order).  Their bound is the same bytes at half the size; the
// design is the double one's.

#include "fields.cuh"

PYIGA_EXPORT int pyiga_stiff_fields_f64(const double* Y, const double* T,
                                        const double* w12, const double* wL,
                                        double* out, int d, int nurbs,
                                        long long Q12, int QL, int nL,
                                        void* stream) {
    return launch_fields<kStiffness, kFwd>(Y, T, w12, wL, nullptr, nullptr,
                                           out, d, d, nurbs, Q12, QL, nL,
                                           stream);
}

PYIGA_EXPORT int pyiga_mass_fields_f64(const double* Y, const double* T,
                                       const double* w12, const double* wL,
                                       double* out, int d, int nurbs,
                                       long long Q12, int QL, int nL,
                                       void* stream) {
    return launch_fields<kMass, kFwd>(Y, T, w12, wL, nullptr, nullptr, out,
                                      d, d, nurbs, Q12, QL, nL, stream);
}

PYIGA_EXPORT int pyiga_geo_jac_fields_f64(const double* Y, const double* T,
                                          double* out, int d, int g,
                                          int nurbs, long long Q12, int QL,
                                          int nL, void* stream) {
    return launch_fields<kJac, kFwd>(Y, T, nullptr, nullptr, nullptr, nullptr,
                                     out, d, g, nurbs, Q12, QL, nL, stream);
}

// K1's backward of `kind` (0 stiffness, 1 mass, 2 jac): gY from gout.
PYIGA_EXPORT int pyiga_fields_bwd_f64(int kind, const double* Y,
                                      const double* T, const double* w12,
                                      const double* wL, const double* gout,
                                      double* gY, int d, int g, int nurbs,
                                      long long Q12, int QL, int nL,
                                      void* stream) {
    return fields_of_kind<kBwd>(kind, Y, T, w12, wL, gout, nullptr, gY, d, g,
                                nurbs, Q12, QL, nL, stream);
}

// --------------------------------------------------------------------------
// K1': stiffness fields from a Jacobian evaluated on the host.  Replaces
// the non-spline branch of `stiffness_fields_pallas`
// (pyiga_tpu/ops/pallas_sumfac.py, pallas_call at :1163, body
// `_make_stiff_fields_kernel`, :930), which runs for a geometry given as
// a user function (`geometry.UserFunction`).
//
// Inputs (row-major, all of the scalar S): jac (D, D, Q12, QL), the
// level-ordered Jacobian J[a][b] at every Gauss point; w12 (Q12,) and wL
// (QL,), the Gauss weights as K1 takes them (w12 the product of the
// leading axes' weights), so gw = w12[r] wL[c] is gauss_weight_field's
// (w0 w1) w2.
// Output: out (D(D+1)/2, Q12, QL), the unique B_ab = gw |det J|
// (J^-1 J^-T)_ab for a <= b, row-major (the order the assembler expands).
//
// Bound: device memory, D*D scalars read and D(D+1)/2 written per point,
// every access coalesced across the warp (the field axis leads, the point
// axis is contiguous).  No lane padding: any QL (the TPU's multiple of 128
// is its (8, 128) tiling rule).  K1's mapping: a block owns RB rows, a
// thread a column qL of each, the row loop unrolled twice (two points in
// flight); no index is divided; the algebra is K1's, adj / det.
// --------------------------------------------------------------------------

template <int D, class S>
__global__ void __launch_bounds__(256)
host_jac_fields_kernel(const S* __restrict__ jac, const S* __restrict__ w12,
                       const S* __restrict__ wL, S* __restrict__ out,
                       int Q12, int QL, int RB) {
    const long long N = (long long)Q12 * QL;
    const int r0 = blockIdx.x * RB;
    const int rows = min(RB, Q12 - r0);
    for (int qL = threadIdx.x; qL < QL; qL += blockDim.x) {
        const S wl = __ldg(wL + qL);
#pragma unroll 2
        for (int r = 0; r < rows; ++r) {
            const long long g = (long long)(r0 + r) * QL + qL;
            S J[D][D];
#pragma unroll
            for (int a = 0; a < D; ++a)
#pragma unroll
                for (int b = 0; b < D; ++b)
                    J[a][b] = __ldg(jac + (a * D + b) * N + g);
            S inv[D][D];
            const S det = det_and_inv<D>(J, inv);
            const S gw = __ldg(w12 + r0 + r) * wl;
            store_stiffness<D>(inv, gw * sabs(det), out, N, g);
        }
    }
}

// RB and the threads as K1's launch_one: 16 rows, halved while the grid
// has fewer than two blocks an SM; min(256, QL rounded up to a warp).
template <class S>
static int launch_host_jac(const S* jac, const S* w12, const S* wL, S* out,
                           int d, long long Q12, int QL, void* stream) {
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
        host_jac_fields_kernel<2, S><<<grid, threads, 0, s>>>(
            jac, w12, wL, out, q, QL, rb);
    else if (d == 3)
        host_jac_fields_kernel<3, S><<<grid, threads, 0, s>>>(
            jac, w12, wL, out, q, QL, rb);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

PYIGA_EXPORT int pyiga_host_jac_fields_f64(const double* jac,
                                           const double* w12,
                                           const double* wL, double* out,
                                           int d, long long Q12, int QL,
                                           void* stream) {
    return launch_host_jac(jac, w12, wL, out, d, Q12, QL, stream);
}

// K1' in float32 (the f32 line's UserFunction geometries): the same
// arguments in float.
PYIGA_EXPORT int pyiga_host_jac_fields_f32(const float* jac, const float* w12,
                                           const float* wL, float* out, int d,
                                           long long Q12, int QL,
                                           void* stream) {
    return launch_host_jac(jac, w12, wL, out, d, Q12, QL, stream);
}
