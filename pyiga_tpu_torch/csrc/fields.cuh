// K1's templates for Hopper (sm_90a), shared by the three translation units
// that instantiate them, compiled in parallel: fields.cu (K1 and K1-bwd,
// and K1'), fields_jvp.cu (K1-jvp) and fields_hvp.cu (K1-hvp).  Each
// kernel is templated on its scalar S (double; float for the f32 line's
// instances).  See fields.cu for what each kernel replaces.

#pragma once

#include <type_traits>

#include "common.cuh"
#include "dmma.cuh"      // cp.async

// |x| in the scalar's own precision (fabs of a float would go through
// double)
__device__ __forceinline__ double sabs(double x) { return fabs(x); }
__device__ __forceinline__ float sabs(float x) { return fabsf(x); }
// |x| with the sign of y, likewise
__device__ __forceinline__ double scopysign(double x, double y) {
    return copysign(x, y);
}
__device__ __forceinline__ float scopysign(float x, float y) {
    return copysignf(x, y);
}

// one scalar from global to shared memory by cp.async (8 bytes a double,
// 4 a float)
__device__ __forceinline__ void cp_async_scalar(double* dst,
                                                const double* src) {
    dmma::cp_async<8>(dst, src, 8);
}
__device__ __forceinline__ void cp_async_scalar(float* dst,
                                                const float* src) {
    const unsigned int d =
        static_cast<unsigned int>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, 4;\n"
                 :: "r"(d), "l"(src));
}

// A scalar and its tangent: forward mode by operator overloading, for
// K1-jvp (K1's per-point algebra on Dual<S>, the tangent of its output)
// and K1-hvp (K1-bwd's point VJP on Dual<S>).  The operators are hidden
// friends, so a plain S (a constant: zero tangent) converts where it
// meets a Dual.  Each rule is the derivative of the operation as
// written, the quotient's (da - q db) / b, as in torch's forward mode.
template <class S>
struct Dual {
    S v, d;
    __device__ __forceinline__ Dual() {}
    __device__ __forceinline__ Dual(S x) : v(x), d(S(0)) {}
    __device__ __forceinline__ Dual(S x, S t) : v(x), d(t) {}
    friend __device__ __forceinline__ Dual operator+(Dual a, Dual b) {
        return Dual(a.v + b.v, a.d + b.d);
    }
    friend __device__ __forceinline__ Dual operator-(Dual a, Dual b) {
        return Dual(a.v - b.v, a.d - b.d);
    }
    friend __device__ __forceinline__ Dual operator*(Dual a, Dual b) {
        return Dual(a.v * b.v, a.d * b.v + a.v * b.d);
    }
    friend __device__ __forceinline__ Dual operator/(Dual a, Dual b) {
        const S q = a.v / b.v;
        return Dual(q, (a.d - q * b.d) / b.v);
    }
    friend __device__ __forceinline__ Dual operator-(Dual a) {
        return Dual(-a.v, -a.d);
    }
    __device__ __forceinline__ Dual& operator+=(Dual b) {
        v += b.v;
        d += b.d;
        return *this;
    }
    __device__ __forceinline__ Dual& operator-=(Dual b) {
        v -= b.v;
        d -= b.d;
        return *this;
    }
};
// |x|: the tangent times sign(x) (0 at 0, as torch.sign)
template <class S>
__device__ __forceinline__ Dual<S> sabs(Dual<S> x) {
    return Dual<S>(sabs(x.v), x.v > S(0) ? x.d : (x.v < S(0) ? -x.d : S(0)));
}
// |x| with the sign of y: the tangent of x, negated where the sign flips
template <class S>
__device__ __forceinline__ Dual<S> scopysign(Dual<S> x, Dual<S> y) {
    const S r = scopysign(x.v, y.v);
    return Dual<S>(r, signbit(r) == signbit(x.v) ? x.d : -x.d);
}
// what a kernel stores of a point's result: the value, or the tangent
template <class S>
__device__ __forceinline__ S stored(S x) {
    return x;
}
template <class S>
__device__ __forceinline__ S stored(Dual<S> x) {
    return x.d;
}

// --------------------------------------------------------------------------
// Per-point algebra: determinant, inverse by the adjugate (as
// ops/geom.det_and_inv and the JAX package's geom.py) and the unique
// stiffness fields.
// --------------------------------------------------------------------------

template <int D, class S>
__device__ __forceinline__ S det_of(S (&J)[D][D]) {
    if constexpr (D == 1) {
        return J[0][0];
    } else if constexpr (D == 2) {
        return J[0][0] * J[1][1] - J[0][1] * J[1][0];
    } else {
        const S c00 = J[1][1] * J[2][2] - J[1][2] * J[2][1];
        const S c01 = J[1][2] * J[2][0] - J[1][0] * J[2][2];
        const S c02 = J[1][0] * J[2][1] - J[1][1] * J[2][0];
        return J[0][0] * c00 + J[0][1] * c01 + J[0][2] * c02;
    }
}

template <int D, class S>
__device__ __forceinline__ S det_and_inv(S (&J)[D][D], S (&inv)[D][D]) {
    static_assert(D == 2 || D == 3, "the stiffness fields need D = 2, 3");
    const S det = det_of<D>(J);
    if constexpr (D == 2) {
        inv[0][0] = J[1][1] / det;
        inv[0][1] = -J[0][1] / det;
        inv[1][0] = -J[1][0] / det;
        inv[1][1] = J[0][0] / det;
    } else {
        const S adj[3][3] = {
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

// out[o * N + g] = W (J^-1 J^-T)_ab for the unique a <= b, row-major (of
// a Dual, its tangent)
template <int D, class V, class S>
__device__ __forceinline__ void store_stiffness(V (&inv)[D][D], V W, S* out,
                                                long long N, long long g) {
    int o = 0;
    for (int a = 0; a < D; ++a) {
        for (int b = a; b < D; ++b) {
            V s = V(S(0));
            for (int m = 0; m < D; ++m) s += inv[a][m] * inv[b][m];
            out[(long long)o * N + g] = stored(W * s);
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
// Inputs (all row-major, of the scalar S: double, or float for the
// float32 instances):
//   Y    (D, C, Q12, nL)  stage-1/2 geometry partials from K2: entry
//        [t, c, q12, j] holds component c contracted over the leading D-1
//        axes with the derivative table on axis t (t = D-1: all values),
//        the last coefficient axis j still open.
//   T    (2, QL, nL)      last-axis value (0) and derivative (1) tables.
//   w12  (Q12,), wL (QL,) the Gauss weights (not read by kJac).
// C = G components for a B-spline map, G + 1 (homogeneous, weight last)
// for NURBS, whose quotient rule runs before the determinant.
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
// * a last axis of fewer than kRowsQL points (a boundary Gauss grid has
//   QL = 1) maps a thread to a row instead (ROWS): it walks the row's QL
//   points and reads the row's Y in place, coalesced across the warp;
//   mapped to the last axis, such a grid would leave one lane of each
//   32-thread block working;
// * nL is a template parameter for 1..4 (every geometry on the paths has
//   nL = 2), the dots fully unrolled; above 4 a runtime loop (NL = 0);
// * no division of indices: the block's rows and the thread's columns
//   come from blockIdx and threadIdx; a thread's row loop is unrolled
//   twice, two points in flight;
// * the per-point algebra is the first design's, in the JAX package's
//   order (adj / det, no reciprocal), the same in both mappings.
// --------------------------------------------------------------------------

enum FieldsKind { kStiffness = 0, kMass = 1, kJac = 2 };

// a last axis shorter than this maps K1's threads to rows
constexpr int kRowsQL = 8;

// The last-axis value and derivative tables of column qL: in registers for
// a compile-time nL, read from memory at each dot otherwise.
template <int NL, class S>
struct LastTables {
    S v[NL], d[NL];
    __device__ __forceinline__ LastTables(const S* T, int QL, int qL, int) {
#pragma unroll
        for (int j = 0; j < NL; ++j) {
            v[j] = __ldg(T + (long long)qL * NL + j);
            d[j] = __ldg(T + ((long long)QL + qL) * NL + j);
        }
    }
    __device__ __forceinline__ S dot(bool deriv, const S* y) const {
        S s = S(0);
#pragma unroll
        for (int j = 0; j < NL; ++j) s += (deriv ? d[j] : v[j]) * y[j];
        return s;
    }
};

template <class S>
struct LastTables<0, S> {
    const S* v;
    const S* d;
    int nL;
    __device__ __forceinline__ LastTables(const S* T, int QL, int qL, int nL_)
        : v(T + (long long)qL * nL_), d(T + ((long long)QL + qL) * nL_),
          nL(nL_) {}
    __device__ __forceinline__ S dot(bool deriv, const S* y) const {
        const S* t = deriv ? d : v;
        S s = S(0);
        for (int j = 0; j < nL; ++j) s += __ldg(t + j) * y[j];
        return s;
    }
};

// K1's algebra at one Gauss point after the last-axis contraction, in the
// scalar V (S; Dual<S> for K1-jvp, which stores the tangents): from the
// homogeneous Jacobian jac[c][k] and the values val[c] (NURBS or kJac)
// to the output's rows at point g of N; the Gauss weight is
// w12[q12] wl.
template <int D, int G, bool NURBS, int KIND, class V, class S>
__device__ __forceinline__ void fields_tail(V (&jac)[G + (NURBS ? 1 : 0)][D],
                                            V (&val)[G + (NURBS ? 1 : 0)],
                                            const S* w12, int q12, S wl,
                                            S* out, long long N,
                                            long long g) {
    constexpr int C = G + (NURBS ? 1 : 0);
    if constexpr (KIND == kJac) {
        if constexpr (NURBS) {
            const V W = val[C - 1];
            const V WW = W * W;
#pragma unroll
            for (int c = 0; c < G; ++c)
#pragma unroll
                for (int k = 0; k < D; ++k)
                    jac[c][k] = (jac[c][k] * W - val[c] * jac[C - 1][k]) / WW;
#pragma unroll
            for (int c = 0; c < G; ++c) val[c] = val[c] / W;
        }
#pragma unroll
        for (int c = 0; c < G; ++c) out[(long long)c * N + g] = stored(val[c]);
#pragma unroll
        for (int c = 0; c < G; ++c)
#pragma unroll
            for (int k = 0; k < D; ++k)
                out[(long long)(G + c * D + k) * N + g] = stored(jac[c][k]);
    } else {
        // physical Jacobian J[c][k]; NURBS: quotient rule on V / W
        V J[D][D];
        if constexpr (NURBS) {
            const V W = val[C - 1];
            const V WW = W * W;
#pragma unroll
            for (int c = 0; c < D; ++c)
#pragma unroll
                for (int k = 0; k < D; ++k)
                    J[c][k] = (jac[c][k] * W - val[c] * jac[C - 1][k]) / WW;
        } else {
#pragma unroll
            for (int c = 0; c < D; ++c)
#pragma unroll
                for (int k = 0; k < D; ++k) J[c][k] = jac[c][k];
        }
        const V gw = V(__ldg(w12 + q12) * wl);
        if constexpr (KIND == kMass) {
            out[g] = stored(gw * sabs(det_of<D>(J)));
        } else {
            V inv[D][D];
            const V det = det_and_inv<D>(J, inv);
            store_stiffness<D>(inv, gw * sabs(det), out, N, g);
        }
    }
}

// One Gauss point of K1: row q12 (its Y rows at yat(t * C + c)), column
// qL (its tables `tab`, its weight wl), output index g of N.  JVP (K1-jvp):
// the rows of dY at dyat(t * C + c) contracted beside Y's as the tangents
// of a Dual<S> algebra, and the output's tangent stored.
template <int D, int G, bool NURBS, int KIND, int NL, bool JVP, class S,
          class YAt, class DYAt>
__device__ __forceinline__ void fields_point(const LastTables<NL, S>& tab,
                                             YAt yat, DYAt dyat, const S* w12,
                                             int q12, S wl, S* out,
                                             long long N, long long g) {
    constexpr int C = G + (NURBS ? 1 : 0);
    using V = typename std::conditional<JVP, Dual<S>, S>::type;
    // last-axis contraction: jac[c][k] (derivative axis k), val[c]
    V jac[C][D];
    V val[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int k = 0; k < D; ++k) {
            const int t = k < D - 1 ? k : D - 1;
            if constexpr (JVP)
                jac[c][k] = V(tab.dot(k == D - 1, yat(t * C + c)),
                              tab.dot(k == D - 1, dyat(t * C + c)));
            else
                jac[c][k] = tab.dot(k == D - 1, yat(t * C + c));
        }
        if constexpr (NURBS || KIND == kJac) {
            if constexpr (JVP)
                val[c] = V(tab.dot(false, yat((D - 1) * C + c)),
                           tab.dot(false, dyat((D - 1) * C + c)));
            else
                val[c] = tab.dot(false, yat((D - 1) * C + c));
        }
    }
    fields_tail<D, G, NURBS, KIND>(jac, val, w12, q12, wl, out, N, g);
}

// K1's body, shared by geo_fields_kernel and (JVP) geo_fields_jvp_kernel,
// which stages dY's rows beside Y's and stores the output's tangent.
template <int D, int G, bool NURBS, int KIND, int NL, bool ROWS, bool JVP,
          class S>
__device__ __forceinline__ void fields_fwd_body(
        const S* __restrict__ Y, const S* __restrict__ dY,
        const S* __restrict__ T, const S* __restrict__ w12,
        const S* __restrict__ wL, S* __restrict__ out, int Q12, int QL,
        int nL_, int RB) {
    static_assert(KIND == kJac || G == D, "only the jac kind takes G != D");
    constexpr int C = G + (NURBS ? 1 : 0);
    const int nL = NL ? NL : nL_;
    const long long N = (long long)Q12 * QL;
    if constexpr (ROWS) {
        // a thread a row, its QL (< kRowsQL) points in turn
        const int r = blockIdx.x * blockDim.x + threadIdx.x;
        if (r >= Q12) return;
        const S* yg = Y + (long long)r * nL;
        const S* dyg = JVP ? dY + (long long)r * nL : yg;
        const long long ys = (long long)Q12 * nL;
        auto yat = [&](int tc) { return yg + tc * ys; };
        auto dyat = [&](int tc) { return dyg + tc * ys; };
        for (int qL = 0; qL < QL; ++qL) {
            const LastTables<NL, S> tab(T, QL, qL, nL);
            const S wl = KIND == kJac ? S(0) : __ldg(wL + qL);
            fields_point<D, G, NURBS, KIND, NL, JVP>(
                tab, yat, dyat, w12, r, wl, out, N, (long long)r * QL + qL);
        }
    } else {
        // [D * C][RB][nL], and for JVP dY's rows after them; declared as
        // double for its alignment
        extern __shared__ double sYd[];
        S* sY = reinterpret_cast<S*>(sYd);
        S* sdY = sY + (JVP ? D * C * RB * nL : 0);
        const int r0 = blockIdx.x * RB;
        const int rows = min(RB, Q12 - r0);
        const int seg = rows * nL;
        for (int k = threadIdx.x; k < D * C * seg; k += blockDim.x) {
            const int tc = k / seg, e = k - tc * seg;
            const long long src = ((long long)tc * Q12 + r0) * nL + e;
            sY[tc * RB * nL + e] = __ldg(Y + src);
            if constexpr (JVP) sdY[tc * RB * nL + e] = __ldg(dY + src);
        }
        __syncthreads();

        for (int qL = threadIdx.x; qL < QL; qL += blockDim.x) {
            const LastTables<NL, S> tab(T, QL, qL, nL);
            const S wl = KIND == kJac ? S(0) : __ldg(wL + qL);
#pragma unroll 2
            for (int r = 0; r < rows; ++r) {
                const S* yr = sY + r * nL;
                const S* dyr = sdY + r * nL;
                auto yat = [&](int tc) { return yr + tc * RB * nL; };
                auto dyat = [&](int tc) { return dyr + tc * RB * nL; };
                fields_point<D, G, NURBS, KIND, NL, JVP>(
                    tab, yat, dyat, w12, r0 + r, wl, out, N,
                    (long long)(r0 + r) * QL + qL);
            }
        }
    }
}

template <int D, int G, bool NURBS, int KIND, int NL, bool ROWS,
          class S = double>
__global__ void __launch_bounds__(256)
geo_fields_kernel(const S* __restrict__ Y, const S* __restrict__ T,
                  const S* __restrict__ w12, const S* __restrict__ wL,
                  S* __restrict__ out, int Q12, int QL, int nL_, int RB) {
    fields_fwd_body<D, G, NURBS, KIND, NL, ROWS, false, S>(
        Y, nullptr, T, w12, wL, out, Q12, QL, nL_, RB);
}

// --------------------------------------------------------------------------
// K1-jvp: geo_fields_jvp_kernel<D, G, NURBS, KIND, NL, ROWS, S>, the
// tangent of K1's output of each kind at Y in the direction dY (the
// forward mode of the differentiable assembly, pyiga_tpu_torch/diff.py;
// the JAX package runs jax.jvp through K1's XLA form).  K1's mapping and
// per-point algebra, on Dual<S>: each point contracts Y's and dY's rows
// with the column's last-axis tables (the contraction is linear, so dY's
// is the Jacobian's tangent), then runs K1's algebra in K1's order
// (adj / det) on the pairs and stores the tangents in K1's output layout;
// for NURBS the quotient rule's tangent comes with it, for a B-spline
// 'jac' the output is linear and its tangent is K1 of dY.  dY's rows are
// staged in shared memory beside Y's (twice K1's bytes a row); a
// one-point last axis takes the ROWS mapping.
//
// Bound: Y, dY, the tables and weights read once, the tangent written
// once (K1's output: 6, 1 and 12 scalars a point at 3D) -- the bytes of
// the output dominate, as K1's.
// --------------------------------------------------------------------------

template <int D, int G, bool NURBS, int KIND, int NL, bool ROWS,
          class S = double>
__global__ void __launch_bounds__(256)
geo_fields_jvp_kernel(const S* __restrict__ Y, const S* __restrict__ dY,
                      const S* __restrict__ T, const S* __restrict__ w12,
                      const S* __restrict__ wL, S* __restrict__ out, int Q12,
                      int QL, int nL_, int RB) {
    fields_fwd_body<D, G, NURBS, KIND, NL, ROWS, true, S>(
        Y, dY, T, w12, wL, out, Q12, QL, nL_, RB);
}

// --------------------------------------------------------------------------
// K1's backward: geo_fields_bwd_kernel<D, G, NURBS, KIND, NL, S>.
//
// The JAX package differentiates the XLA form of K1 (pyiga_tpu/diff.py
// builds on `asm.field_fn` with mode='exact', no Pallas kernel); the
// port's forward on the card is K1 itself, so its gradient is a kernel
// too.  In: Y, T (and w12, wL for the stiffness and mass kinds) as the
// forward takes them, and gout, the gradient of the forward's output (its
// shape).  Out: gY (D, C, Q12, nL), the gradient of Y.
//
// Per Gauss point the kernel recomputes the homogeneous Jacobian jh[c][k]
// and the values val[c] from the row's Y and the column's last-axis
// tables, as the forward does, then applies the VJP of the kind, with
// adj J = det J J^-1 and one reciprocal a point at most:
//   stiffness B = s J^-1 J^-T (s = gw |det J|, the unique a <= b stored;
//     the off-diagonal gradient split between the mirrored entries into a
//     symmetric Gs): gJ = s ((Gs : M) J^-T - 2 J^-T Gs M), M = J^-1 J^-T,
//     computed as f ((Gs : A) adj^T - 2 (adj^T Gs adj) adj^T) with A =
//     adj adj^T and f = gw sign(det) / det^2;
//   mass s: gJ = g s J^-T = g gw sign(det) adj^T (no division);
//   jac (x, J): the gradients as they come;
// then, for NURBS, the quotient rule's (J = (jh W - val jh_W) / W^2,
// x = val / W), by the reciprocal of W.  That leaves per point and (t, c)
// the coefficients a_v of the value table and (t = D-1 only) a_d of the
// derivative table:
//   gY[t, c, q12, j] = sum_qL a_v[t][c] Tv[qL, j] + a_d[c] Td[qL, j].
// The formulas are those of ops/cuda_sumfac._fields_vjp_plain, in another
// association (the kernel agrees with it to rounding, 1e-13 relative).
//
// The sum over the last axis: a team of P lanes (a power of two, chosen
// per launch from Q12, QL and the kind) owns a row q12; lane k of the
// team walks the row's points k, k + P, ... (a warp's load of gout covers
// 32 / P rows' runs of P consecutive points: every 32-byte sector it
// touches is used whole), keeps the row's Y (compile-time nL) and its
// D C nL partial sums in registers across its points, and has the gout
// (and wL) of the next PF points in flight while it computes one.  At
// the end of the row one fixed-order combine: a butterfly of shuffles
// over the team's lanes, and for a team of several warps (P > 32) a pass
// over the warps' sums in shared memory in warp order.  No block barrier
// while a chunk's points run, no atomics: bitwise equal on a repeat.  The
// tables come into shared memory once a block, kBwdChunk points at a time
// (one chunk up to 512 points; a barrier between chunks).  A boundary
// grid (QL = 1) takes P = 1: a thread a row, no sum.  nL above 4 (NL = 0)
// reads the tables in place and runs the points once for each run of
// kBwdJC outputs j, the sums of that run in registers.
//
// Bound: Y, gout and the weights read once, gY written once (gout
// dominates: 6, 1 or 12 scalars a point at 3D; a float32 instance moves
// half the bytes of the double one and does the same operations on the
// FMA units' float32 rate), against the operations
// of the body as written (chip_smoke.fields_bwd_flops: 310, 116 and 96 a
// point at 3D n=48, nL = 2): bytes bound the stiffness and jac kinds,
// operations the mass kind.  What the design does about it: the gout
// loads stay in flight (the ring), no barrier or shuffle runs per point,
// the tables are shared-memory reads, registers hold the row.
// --------------------------------------------------------------------------

// The backward's mapping (scripts/torch_fields_bwd_variants.py builds
// variants of these lines and times them side by side).
constexpr int kBwdThreads = 128;        // threads a block
constexpr int kBwdMinThreads = 32768;   // a row's team widens while fewer
                                        // lanes than this run
// a kind's own: the blocks an SM that __launch_bounds__ asks for (so the
// registers a thread may take), the points a lane walks before a row's
// team of lanes widens, the points whose gout a lane has in flight
template <int KIND>
struct BwdTune {
    static constexpr int minb = KIND == kStiffness ? 3 : KIND == kMass ? 4 : 1;
    static constexpr int pts = KIND == kStiffness ? 12 : KIND == kMass ? 24 : 12;
    static constexpr int pf = KIND == kStiffness ? 2 : KIND == kMass ? 4 : 1;
};
constexpr int kBwdJC = 4;           // NL = 0: outputs j a pass
constexpr int kBwdChunk = 512;      // NL > 0: points of the tables staged

// adj J (J^-1 = adj / det) and det J, det by the first row (det_of's sum)
template <int D, class S>
__device__ __forceinline__ S adj_det(const S (&J)[D][D],
                                          S (&adj)[D][D]) {
    if constexpr (D == 2) {
        adj[0][0] = J[1][1];
        adj[0][1] = -J[0][1];
        adj[1][0] = -J[1][0];
        adj[1][1] = J[0][0];
        return J[0][0] * J[1][1] - J[0][1] * J[1][0];
    } else {
        adj[0][0] = J[1][1] * J[2][2] - J[1][2] * J[2][1];
        adj[0][1] = J[0][2] * J[2][1] - J[0][1] * J[2][2];
        adj[0][2] = J[0][1] * J[1][2] - J[0][2] * J[1][1];
        adj[1][0] = J[1][2] * J[2][0] - J[1][0] * J[2][2];
        adj[1][1] = J[0][0] * J[2][2] - J[0][2] * J[2][0];
        adj[1][2] = J[0][2] * J[1][0] - J[0][0] * J[1][2];
        adj[2][0] = J[1][0] * J[2][1] - J[1][1] * J[2][0];
        adj[2][1] = J[0][1] * J[2][0] - J[0][0] * J[2][1];
        adj[2][2] = J[0][0] * J[1][1] - J[0][1] * J[1][0];
        return J[0][0] * adj[0][0] + J[0][1] * adj[1][0]
               + J[0][2] * adj[2][0];
    }
}

// scalars of the forward's output a point
template <int D, int G, int KIND>
struct GoutFields {
    static constexpr int value =
        KIND == kJac ? G + G * D : KIND == kMass ? 1 : D * (D + 1) / 2;
};

// The VJP of one point: from the homogeneous Jacobian jh[c][k], the values
// val[c] (NURBS or kJac), the output's gradient go and the Gauss weight gw
// to the table coefficients av[t][c] and ad[c].
template <int D, int G, bool NURBS, int KIND, class S>
__device__ __forceinline__ void point_vjp(
        const S (&jh)[G + (NURBS ? 1 : 0)][D],
        const S (&val)[G + (NURBS ? 1 : 0)],
        const S (&go)[GoutFields<D, G, KIND>::value], S gw,
        S (&av)[D][G + (NURBS ? 1 : 0)],
        S (&ad)[G + (NURBS ? 1 : 0)]) {
    constexpr int C = G + (NURBS ? 1 : 0);
    S gJ[G][D], gx[G];
    S iW = S(0), iWW = S(0), xv[G];
    if constexpr (NURBS) {
        iW = S(1) / val[C - 1];
        iWW = iW * iW;
#pragma unroll
        for (int c = 0; c < G; ++c) xv[c] = val[c] * iW;
    }
    if constexpr (KIND == kJac) {
#pragma unroll
        for (int c = 0; c < G; ++c) {
            gx[c] = go[c];
#pragma unroll
            for (int k = 0; k < D; ++k) gJ[c][k] = go[G + c * D + k];
        }
    } else {
        S J[D][D];
#pragma unroll
        for (int c = 0; c < D; ++c)
#pragma unroll
            for (int k = 0; k < D; ++k)
                if constexpr (NURBS)
                    J[c][k] = (jh[c][k] - xv[c] * jh[C - 1][k]) * iW;
                else
                    J[c][k] = jh[c][k];
        S adj[D][D];
        const S det = adj_det<D>(J, adj);
        if constexpr (KIND == kMass) {
            const S f = scopysign(gw, det) * go[0];
#pragma unroll
            for (int c = 0; c < D; ++c)
#pragma unroll
                for (int k = 0; k < D; ++k) gJ[c][k] = f * adj[k][c];
        } else {
            S Gs[D][D];
            int o = 0;
#pragma unroll
            for (int a = 0; a < D; ++a)
#pragma unroll
                for (int b = a; b < D; ++b) {
                    Gs[a][b] = a == b ? go[o] : S(0.5) * go[o];
                    Gs[b][a] = Gs[a][b];
                    ++o;
                }
            const S r = S(1) / det;
            const S f = scopysign(gw * r * r, det);
            S P1[D][D];            // Gs adj
#pragma unroll
            for (int a = 0; a < D; ++a)
#pragma unroll
                for (int m = 0; m < D; ++m) {
                    S s = S(0);
#pragma unroll
                    for (int b = 0; b < D; ++b) s += Gs[a][b] * adj[b][m];
                    P1[a][m] = s;
                }
            S GA = S(0);            // Gs : adj adj^T
#pragma unroll
            for (int a = 0; a < D; ++a)
#pragma unroll
                for (int m = 0; m < D; ++m) GA += P1[a][m] * adj[a][m];
            S Q[D][D];             // adj^T Gs adj, symmetric
#pragma unroll
            for (int i = 0; i < D; ++i)
#pragma unroll
                for (int j = i; j < D; ++j) {
                    S s = S(0);
#pragma unroll
                    for (int a = 0; a < D; ++a) s += adj[a][i] * P1[a][j];
                    Q[i][j] = s;
                    Q[j][i] = s;
                }
#pragma unroll
            for (int i = 0; i < D; ++i)
#pragma unroll
                for (int j = 0; j < D; ++j) {
                    S s = S(0);
#pragma unroll
                    for (int m = 0; m < D; ++m) s += Q[i][m] * adj[j][m];
                    gJ[i][j] = f * (GA * adj[j][i] - S(2) * s);
                }
        }
    }
    if constexpr (NURBS) {
        S gW = S(0);
#pragma unroll
        for (int c = 0; c < G; ++c)
#pragma unroll
            for (int k = 0; k < D; ++k)
                gW += gJ[c][k] * (S(2) * xv[c] * jh[C - 1][k] - jh[c][k]);
#pragma unroll
        for (int k = 0; k < D; ++k) {
            S m = S(0);
#pragma unroll
            for (int c = 0; c < G; ++c) m += gJ[c][k] * val[c];
            if (k < D - 1) av[k][C - 1] = -m * iWW;
            else ad[C - 1] = -m * iWW;
        }
#pragma unroll
        for (int c = 0; c < G; ++c) {
            S m = S(0);
#pragma unroll
            for (int k = 0; k < D; ++k) m += gJ[c][k] * jh[C - 1][k];
            S gv = -m * iWW;
            if constexpr (KIND == kJac) gv += gx[c] * iW;
            av[D - 1][c] = gv;
#pragma unroll
            for (int k = 0; k < D; ++k) {
                if (k < D - 1) av[k][c] = gJ[c][k] * iW;
                else ad[c] = gJ[c][k] * iW;
            }
        }
        if constexpr (KIND == kJac) {
#pragma unroll
            for (int c = 0; c < G; ++c) gW -= gx[c] * val[c];
        }
        av[D - 1][C - 1] = gW * iWW;
    } else {
#pragma unroll
        for (int c = 0; c < G; ++c) {
#pragma unroll
            for (int k = 0; k < D; ++k) {
                if (k < D - 1) av[k][c] = gJ[c][k];
                else ad[c] = gJ[c][k];
            }
            av[D - 1][c] = KIND == kJac ? gx[c] : S(0);
        }
    }
}

// K1-bwd's body, shared by geo_fields_bwd_kernel and (HVP)
// geo_fields_hvp_kernel: the latter also holds dY's row, contracts it
// beside Y's, runs point_vjp on Dual<S> and sums the tangents of the
// table coefficients where the former sums their values.
template <int D, int G, bool NURBS, int KIND, int NL, bool HVP, class S>
__device__ __forceinline__ void fields_bwd_body(
        const S* __restrict__ Y, const S* __restrict__ dY,
        const S* __restrict__ T, const S* __restrict__ w12,
        const S* __restrict__ wL, const S* __restrict__ gout,
        S* __restrict__ gY, int Q12, int QL, int nL_, int lp) {
    static_assert(KIND == kJac || G == D, "only the jac kind takes G != D");
    constexpr int C = G + (NURBS ? 1 : 0);
    constexpr int NTC = D * C;
    constexpr int JC = NL ? NL : kBwdJC;         // sums j held a pass
    constexpr int NO = NTC * JC;
    constexpr int NG = GoutFields<D, G, KIND>::value;
    constexpr int NF = NG + (KIND == kJac ? 0 : 1);  // gout, then wL
    constexpr int PF = BwdTune<KIND>::pf;
    constexpr bool VALS = NURBS || KIND == kJac;
    const int nL = NL ? NL : nL_;
    const int P = 1 << lp;
    const int k = threadIdx.x & (P - 1);
    const int q12 = blockIdx.x * (kBwdThreads >> lp) + (threadIdx.x >> lp);
    const bool active = q12 < Q12;
    extern __shared__ double smem_d[];  // declared double: its alignment
    S* smem = reinterpret_cast<S*>(smem_d);
    constexpr int NS = PF + 1;                   // ring slots a lane
    const int CQ = NL ? min(QL, kBwdChunk) : QL;  // points a chunk
    S* sR = smem;                  // [warps][NO] when P > 32
    S* sT = sR + (P > 32 ? (kBwdThreads / 32) * NO : 0);  // [2][CQ][NL]
    S* sG = sT + (NL ? 2 * CQ * NL : 0);    // [NS][NF][threads]

    const long long N = (long long)Q12 * QL;
    const long long ys = (long long)Q12 * nL;
    const S* yg = Y + (long long)(active ? q12 : 0) * nL;
    const S* dyg = HVP ? dY + (long long)(active ? q12 : 0) * nL : yg;
    S yr[NL ? NTC : 1][NL ? NL : 1];       // the row's Y (NL > 0)
    S dyr[HVP && NL ? NTC : 1][HVP && NL ? NL : 1];   // and its dY
    if constexpr (NL > 0) {
#pragma unroll
        for (int tc = 0; tc < NTC; ++tc)
#pragma unroll
            for (int j = 0; j < NL; ++j) {
                yr[tc][j] = active ? __ldg(yg + tc * ys + j) : S(0);
                if constexpr (HVP)
                    dyr[tc][j] = active ? __ldg(dyg + tc * ys + j) : S(0);
            }
    }
    const S w = (KIND != kJac && active) ? __ldg(w12 + q12) : S(0);
    const long long g0 = (long long)q12 * QL;
    // a point's gout and wL into ring slot `slot`, by cp.async (no
    // register holds it in flight)
    auto fetch = [&](int q, int slot) {
        S* dst = sG + slot * NF * kBwdThreads + threadIdx.x;
#pragma unroll
        for (int f = 0; f < NG; ++f)
            cp_async_scalar(dst + f * kBwdThreads, gout + f * N + g0 + q);
        if constexpr (KIND != kJac)
            cp_async_scalar(dst + NG * kBwdThreads, wL + q);
    };

    for (int jb = 0; jb < nL; jb += JC) {
        S acc[NTC][JC];
#pragma unroll
        for (int tc = 0; tc < NTC; ++tc)
#pragma unroll
            for (int jj = 0; jj < JC; ++jj) acc[tc][jj] = S(0);
        // the last axis in chunks of kBwdChunk points (a multiple of P),
        // each chunk's tables staged in shared memory (NL > 0); the
        // runtime nL reads them in place, in one chunk
        for (int c0 = 0; c0 < QL; c0 += CQ) {
            const int cend = min(QL, c0 + CQ);
            if constexpr (NL > 0) {
                const int seg = (cend - c0) * NL;
                if (c0 > 0) __syncthreads();
                for (int i = threadIdx.x; i < 2 * seg; i += kBwdThreads) {
                    const int tb = i >= seg;
                    sT[tb * CQ * NL + i - tb * seg] =
                        __ldg(T + ((long long)tb * QL + c0) * NL + i - tb * seg);
                }
                __syncthreads();
            }
            // lane k's points c0 + k, c0 + k + P, ...: the gout and wL of
            // PF of them in flight ahead of the one computed, point i of
            // the chunk in slot i mod NS, one cp.async group a point
            int q = active ? c0 + k : cend;
#pragma unroll
            for (int i = 0; i < PF; ++i) {
                if (q + i * P < cend) fetch(q + i * P, i);
                dmma::cp_async_commit();
            }
            for (int slot = 0; q < cend; q += P) {
                const int fill = slot + PF < NS ? slot + PF : slot + PF - NS;
                if (q + PF * P < cend) fetch(q + PF * P, fill);
                dmma::cp_async_commit();
                dmma::cp_async_wait<PF>();      // point q's group landed
                S cur[NF];
#pragma unroll
                for (int f = 0; f < NF; ++f)
                    cur[f] = sG[(slot * NF + f) * kBwdThreads + threadIdx.x];
                slot = slot + 1 < NS ? slot + 1 : 0;

                S jh[C][D], val[C];
                S djh[HVP ? C : 1][D], dval[HVP ? C : 1];  // their tangents
                S ta[JC], tb[JC];  // the pass's table values
                if constexpr (NL > 0) {
                    const S* tv = sT + (q - c0) * NL;
                    const S* td = tv + CQ * NL;
#pragma unroll
                    for (int j = 0; j < NL; ++j) {
                        ta[j] = tv[j];
                        tb[j] = td[j];
                    }
#pragma unroll
                    for (int c = 0; c < C; ++c) {
#pragma unroll
                        for (int kk = 0; kk < D; ++kk) {
                            const int t = kk < D - 1 ? kk : D - 1;
                            S s = S(0);
#pragma unroll
                            for (int j = 0; j < NL; ++j)
                                s += (kk == D - 1 ? tb[j] : ta[j])
                                     * yr[t * C + c][j];
                            jh[c][kk] = s;
                            if constexpr (HVP) {
                                S u = S(0);
#pragma unroll
                                for (int j = 0; j < NL; ++j)
                                    u += (kk == D - 1 ? tb[j] : ta[j])
                                         * dyr[t * C + c][j];
                                djh[c][kk] = u;
                            }
                        }
                        S s = S(0), u = S(0);
                        if constexpr (VALS) {
#pragma unroll
                            for (int j = 0; j < NL; ++j) {
                                s += ta[j] * yr[(D - 1) * C + c][j];
                                if constexpr (HVP)
                                    u += ta[j] * dyr[(D - 1) * C + c][j];
                            }
                        }
                        val[c] = s;
                        if constexpr (HVP) dval[c] = u;
                    }
                } else {
                    const S* pv = T + (long long)q * nL;
                    const S* pd = T + ((long long)QL + q) * nL;
#pragma unroll
                    for (int c = 0; c < C; ++c) {
#pragma unroll
                        for (int kk = 0; kk < D; ++kk) {
                            const int t = kk < D - 1 ? kk : D - 1;
                            const S* tab = kk == D - 1 ? pd : pv;
                            const S* y = yg + (t * C + c) * ys;
                            const S* dy = dyg + (t * C + c) * ys;
                            S s = S(0), u = S(0);
                            for (int j = 0; j < nL; ++j) {
                                s += __ldg(tab + j) * __ldg(y + j);
                                if constexpr (HVP)
                                    u += __ldg(tab + j) * __ldg(dy + j);
                            }
                            jh[c][kk] = s;
                            if constexpr (HVP) djh[c][kk] = u;
                        }
                        S s = S(0), u = S(0);
                        if constexpr (VALS) {
                            const S* y = yg + ((D - 1) * C + c) * ys;
                            const S* dy = dyg + ((D - 1) * C + c) * ys;
                            for (int j = 0; j < nL; ++j) {
                                s += __ldg(pv + j) * __ldg(y + j);
                                if constexpr (HVP)
                                    u += __ldg(pv + j) * __ldg(dy + j);
                            }
                        }
                        val[c] = s;
                        if constexpr (HVP) dval[c] = u;
                    }
#pragma unroll
                    for (int jj = 0; jj < JC; ++jj) {
                        const bool in = jb + jj < nL;
                        ta[jj] = in ? __ldg(pv + jb + jj) : S(0);
                        tb[jj] = in ? __ldg(pd + jb + jj) : S(0);
                    }
                }
                const S gw = KIND == kJac ? S(0) : w * cur[NF - 1];
                S go[NG];
#pragma unroll
                for (int f = 0; f < NG; ++f) go[f] = cur[f];
                S av[D][C], ad[C];
                if constexpr (HVP) {
                    // the point VJP on Dual<S>: dY's contraction the
                    // tangent, gout and the weight held; its tangents
                    // are the coefficients summed
                    Dual<S> hj[C][D], hv[C], hg[NG], hav[D][C], had[C];
#pragma unroll
                    for (int c = 0; c < C; ++c) {
#pragma unroll
                        for (int kk = 0; kk < D; ++kk)
                            hj[c][kk] = Dual<S>(jh[c][kk], djh[c][kk]);
                        hv[c] = Dual<S>(val[c], dval[c]);
                    }
#pragma unroll
                    for (int f = 0; f < NG; ++f) hg[f] = Dual<S>(go[f]);
                    point_vjp<D, G, NURBS, KIND>(hj, hv, hg, Dual<S>(gw),
                                                 hav, had);
#pragma unroll
                    for (int c = 0; c < C; ++c) {
#pragma unroll
                        for (int t = 0; t < D; ++t) av[t][c] = hav[t][c].d;
                        ad[c] = had[c].d;
                    }
                } else {
                    point_vjp<D, G, NURBS, KIND>(jh, val, go, gw, av, ad);
                }
#pragma unroll
                for (int c = 0; c < C; ++c) {
#pragma unroll
                    for (int t = 0; t < D - 1; ++t)
#pragma unroll
                        for (int jj = 0; jj < JC; ++jj)
                            acc[t * C + c][jj] += av[t][c] * ta[jj];
#pragma unroll
                    for (int jj = 0; jj < JC; ++jj) {
                        S a = acc[(D - 1) * C + c][jj];
                        if constexpr (VALS) a += av[D - 1][c] * ta[jj];
                        acc[(D - 1) * C + c][jj] = a + ad[c] * tb[jj];
                    }
                }
            }
        }

        // the team's lanes combined in a fixed order
        for (int off = (P < 32 ? P : 32) >> 1; off > 0; off >>= 1) {
#pragma unroll
            for (int tc = 0; tc < NTC; ++tc)
#pragma unroll
                for (int jj = 0; jj < JC; ++jj)
                    acc[tc][jj] += __shfl_xor_sync(0xffffffffu, acc[tc][jj],
                                                   off);
        }
        if (P <= 32) {
            if (active) {
#pragma unroll
                for (int tc = 0; tc < NTC; ++tc)
#pragma unroll
                    for (int jj = 0; jj < JC; ++jj)
                        if (((tc * JC + jj) & (P - 1)) == k
                            && (NL > 0 || jb + jj < nL))
                            gY[((long long)tc * Q12 + q12) * nL + jb + jj] =
                                acc[tc][jj];
            }
        } else {
            // a team of P / 32 warps: each warp's sums to shared memory,
            // then lane o of the team adds output o over them in order
            const int warp = threadIdx.x >> 5;
            if ((threadIdx.x & 31) == 0) {
#pragma unroll
                for (int tc = 0; tc < NTC; ++tc)
#pragma unroll
                    for (int jj = 0; jj < JC; ++jj)
                        sR[warp * NO + tc * JC + jj] = acc[tc][jj];
            }
            __syncthreads();
            if (active && k < NO) {
                const int w0 = (threadIdx.x >> lp) * (P >> 5);
                S s = S(0);
                for (int v = 0; v < (P >> 5); ++v) s += sR[(w0 + v) * NO + k];
                const int tc = k / JC, jj = k - tc * JC;
                if (NL > 0 || jb + jj < nL)
                    gY[((long long)tc * Q12 + q12) * nL + jb + jj] = s;
            }
            __syncthreads();
        }
    }
}

template <int D, int G, bool NURBS, int KIND, int NL, class S>
__global__ void __launch_bounds__(kBwdThreads, BwdTune<KIND>::minb)
geo_fields_bwd_kernel(const S* __restrict__ Y,
                      const S* __restrict__ T,
                      const S* __restrict__ w12,
                      const S* __restrict__ wL,
                      const S* __restrict__ gout,
                      S* __restrict__ gY, int Q12, int QL, int nL_,
                      int lp) {
    fields_bwd_body<D, G, NURBS, KIND, NL, false, S>(
        Y, nullptr, T, w12, wL, gout, gY, Q12, QL, nL_, lp);
}

// --------------------------------------------------------------------------
// K1-hvp: geo_fields_hvp_kernel<D, G, NURBS, KIND, NL, S>, the tangent of
// K1-bwd's gY at Y in the direction dY for a fixed gout: the Hessian of
// <gout, K1(Y)> applied to dY (second derivatives through the
// differentiable assembly: forward over reverse, and K1-bwd's own
// backward, which by the Hessian's symmetry is the same product).
// K1-bwd's body: a team of lanes a row, gout in flight by cp.async, the
// tables staged, the row's Y -- and here its dY -- in registers; per point
// the Jacobian and values of Y and of dY by the same contraction, then
// point_vjp on Dual<S> (gout and the weight with no tangent), whose
// tangents are the table coefficients summed over the row's points in
// registers and combined by K1-bwd's fixed-order butterfly: bitwise equal
// on a repeat.  The point's work is about twice K1-bwd's (every product
// of the VJP carries its tangent), so HvpTune lets a thread take more
// registers than K1-bwd's.
//
// Bound: Y, dY, gout and the weights read once, the result written once,
// against the body's operations (chip_smoke.fields_hvp_flops).
// --------------------------------------------------------------------------

template <int KIND>
struct HvpTune {
    static constexpr int minb = KIND == kJac ? 1 : 2;
};

template <int D, int G, bool NURBS, int KIND, int NL, class S>
__global__ void __launch_bounds__(kBwdThreads, HvpTune<KIND>::minb)
geo_fields_hvp_kernel(const S* __restrict__ Y, const S* __restrict__ dY,
                      const S* __restrict__ T, const S* __restrict__ w12,
                      const S* __restrict__ wL, const S* __restrict__ gout,
                      S* __restrict__ gY, int Q12, int QL, int nL_, int lp) {
    fields_bwd_body<D, G, NURBS, KIND, NL, true, S>(
        Y, dY, T, w12, wL, gout, gY, Q12, QL, nL_, lp);
}

// --------------------------------------------------------------------------
// Launches of K1 and its backward, and of K1-jvp and K1-hvp, which take
// K1's and K1-bwd's.  K1: a block of min(256, QL rounded up to a warp)
// threads and RB rows: 16, halved while the grid has fewer than two
// blocks an SM or the shared memory would pass 48 KB (past 48 KB at one
// row the kernel is given the larger limit; K1-jvp stages twice the bytes
// a row); below kRowsQL points a row, 128 threads a block, a thread a
// row.  The backward: kBwdThreads a block, teams of P lanes a row, P
// doubled from 1 while it is below QL and a lane would walk more than
// BwdTune::pts points or the grid would run fewer than kBwdMinThreads
// lanes, up to the block.  K1-jvp and K1-hvp compile nL = 2 (every
// geometry on the paths) and the runtime nL; K1 and K1-bwd nL = 1..4 too.
// --------------------------------------------------------------------------

enum FieldsMode { kFwd = 0, kBwd = 1, kJvp = 2, kHvp = 3 };

// S: the scalar (double; float for the float32 instances)
template <class S>
struct FieldsArgsT {
    const S* Y;
    const S* T;
    const S* w12;
    const S* wL;
    const S* gout;          // backward and K1-hvp
    const S* dY;            // K1-jvp and K1-hvp
    S* out;                 // the output, or gY for the backward
    int Q12, QL, nL;
    cudaStream_t s;
};

template <int D, int G, bool NURBS, int KIND, int NL, bool JVP, class S>
static int launch_fwd(const FieldsArgsT<S>& a) {
    constexpr int C = G + (NURBS ? 1 : 0);
    if (a.QL < kRowsQL) {
        const unsigned int grid = (unsigned int)((a.Q12 + 127) / 128);
        if constexpr (JVP)
            geo_fields_jvp_kernel<D, G, NURBS, KIND, NL, true, S>
                <<<grid, 128, 0, a.s>>>(a.Y, a.dY, a.T, a.w12, a.wL, a.out,
                                        a.Q12, a.QL, a.nL, 1);
        else
            geo_fields_kernel<D, G, NURBS, KIND, NL, true, S>
                <<<grid, 128, 0, a.s>>>(a.Y, a.T, a.w12, a.wL, a.out, a.Q12,
                                        a.QL, a.nL, 1);
        return (int)cudaGetLastError();
    }
    int threads = (a.QL + 31) / 32 * 32;
    if (threads > 256) threads = 256;
    const long long per_row =
        (long long)sizeof(S) * D * C * a.nL * (JVP ? 2 : 1);
    int rb = 16;
    while (rb > 1 && ((a.Q12 + rb - 1) / rb < 2 * 132 || rb * per_row > 49152))
        rb /= 2;
    const long long smem = rb * per_row;
    const unsigned int grid = (unsigned int)((a.Q12 + rb - 1) / rb);
    if constexpr (JVP) {
        auto kernel = geo_fields_jvp_kernel<D, G, NURBS, KIND, NL, false, S>;
        if (smem > 49152) {
            const cudaError_t e = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)smem);
            if (e != cudaSuccess) return (int)e;
        }
        kernel<<<grid, threads, (size_t)smem, a.s>>>(
            a.Y, a.dY, a.T, a.w12, a.wL, a.out, a.Q12, a.QL, a.nL, rb);
    } else {
        auto kernel = geo_fields_kernel<D, G, NURBS, KIND, NL, false, S>;
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

template <int D, int G, bool NURBS, int KIND, int NL, bool HVP, class S>
static int launch_bwd(const FieldsArgsT<S>& a) {
    constexpr int C = G + (NURBS ? 1 : 0);
    constexpr int NO = D * C * (NL ? NL : kBwdJC);
    int lp = 0;
    while ((1 << lp) < kBwdThreads && (1 << lp) < a.QL
           && ((long long)BwdTune<KIND>::pts << lp < a.QL
               || (long long)a.Q12 << lp < kBwdMinThreads))
        ++lp;
    const int rows = kBwdThreads >> lp;
    constexpr int NF = GoutFields<D, G, KIND>::value + (KIND == kJac ? 0 : 1);
    constexpr long long E = sizeof(S);
    const long long smem =
        ((1 << lp) > 32 ? E * (kBwdThreads / 32) * NO : 0)
        + (NL ? 2 * E * (a.QL < kBwdChunk ? a.QL : kBwdChunk) * NL : 0)
        + E * (BwdTune<KIND>::pf + 1) * NF * kBwdThreads;
    const unsigned int grid = (unsigned int)((a.Q12 + rows - 1) / rows);
    if constexpr (HVP) {
        auto kernel = geo_fields_hvp_kernel<D, G, NURBS, KIND, NL, S>;
        if (smem > 49152) {
            const cudaError_t e = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)smem);
            if (e != cudaSuccess) return (int)e;
        }
        kernel<<<grid, kBwdThreads, (size_t)smem, a.s>>>(
            a.Y, a.dY, a.T, a.w12, a.wL, a.gout, a.out, a.Q12, a.QL, a.nL,
            lp);
    } else {
        auto kernel = geo_fields_bwd_kernel<D, G, NURBS, KIND, NL, S>;
        if (smem > 49152) {
            const cudaError_t e = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)smem);
            if (e != cudaSuccess) return (int)e;
        }
        kernel<<<grid, kBwdThreads, (size_t)smem, a.s>>>(
            a.Y, a.T, a.w12, a.wL, a.gout, a.out, a.Q12, a.QL, a.nL, lp);
    }
    return (int)cudaGetLastError();
}

template <int D, int G, bool NURBS, int KIND, int NL, int MODE, class A>
static int launch_one(const A& a) {
    if constexpr (MODE == kBwd || MODE == kHvp)
        return launch_bwd<D, G, NURBS, KIND, NL, MODE == kHvp>(a);
    else
        return launch_fwd<D, G, NURBS, KIND, NL, MODE == kJvp>(a);
}

template <int D, int G, bool NURBS, int KIND, int MODE, class A>
static int launch_nl(const A& a) {
    if constexpr (MODE == kJvp || MODE == kHvp) {
        return a.nL == 2 ? launch_one<D, G, NURBS, KIND, 2, MODE>(a)
                         : launch_one<D, G, NURBS, KIND, 0, MODE>(a);
    } else {
        switch (a.nL) {
            case 1: return launch_one<D, G, NURBS, KIND, 1, MODE>(a);
            case 2: return launch_one<D, G, NURBS, KIND, 2, MODE>(a);
            case 3: return launch_one<D, G, NURBS, KIND, 3, MODE>(a);
            case 4: return launch_one<D, G, NURBS, KIND, 4, MODE>(a);
            default: return launch_one<D, G, NURBS, KIND, 0, MODE>(a);
        }
    }
}

template <int D, int G, int KIND, int MODE, class A>
static int launch_nurbs(const A& a, int nurbs) {
    return nurbs ? launch_nl<D, G, true, KIND, MODE>(a)
                 : launch_nl<D, G, false, KIND, MODE>(a);
}

// d the parametric dimension, g the geometry's output dimension (d for
// the stiffness and mass kinds; d or d + 1 for the jac kind)
// S is deduced from Y, T and out (the weights, gout and dY may be nullptr)
template <class S>
struct Same {
    using type = S;
};

template <int KIND, int MODE, class S>
static int launch_fields(const S* Y, const S* T,
                         const typename Same<S>::type* w12,
                         const typename Same<S>::type* wL,
                         const typename Same<S>::type* gout,
                         const typename Same<S>::type* dY, S* out, int d,
                         int g, int nurbs, long long Q12, int QL, int nL,
                         void* stream) {
    if (Q12 < 1 || QL < 1 || nL < 1 || Q12 >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    const FieldsArgsT<S> a{Y, T, w12, wL, gout, dY, out, (int)Q12, QL, nL,
                           (cudaStream_t)stream};
    if constexpr (KIND == kJac) {
        if (d == 1 && g == 1)     // 1D: no leading axes, nL at run time
            return nurbs ? launch_one<1, 1, true, kJac, 0, MODE>(a)
                         : launch_one<1, 1, false, kJac, 0, MODE>(a);
        if (d == 1 && g == 2)     // a curve in the plane
            return nurbs ? launch_one<1, 2, true, kJac, 0, MODE>(a)
                         : launch_one<1, 2, false, kJac, 0, MODE>(a);
        if (d == 2 && g == 3)     // a surface in space
            return launch_nurbs<2, 3, kJac, MODE>(a, nurbs);
    }
    if (g != d) return (int)cudaErrorInvalidValue;
    if (d == 2) return launch_nurbs<2, 2, KIND, MODE>(a, nurbs);
    if (d == 3) return launch_nurbs<3, 3, KIND, MODE>(a, nurbs);
    return (int)cudaErrorInvalidValue;
}

// K1-bwd, K1-jvp or K1-hvp (MODE) of `kind` (0 stiffness, 1 mass, 2 jac)
template <int MODE, class S>
static int fields_of_kind(int kind, const S* Y, const S* T,
                          const typename Same<S>::type* w12,
                          const typename Same<S>::type* wL,
                          const typename Same<S>::type* gout,
                          const typename Same<S>::type* dY, S* out, int d,
                          int g, int nurbs, long long Q12, int QL, int nL,
                          void* stream) {
    switch (kind) {
        case kStiffness:
            return launch_fields<kStiffness, MODE>(Y, T, w12, wL, gout, dY,
                                                   out, d, g, nurbs, Q12, QL,
                                                   nL, stream);
        case kMass:
            return launch_fields<kMass, MODE>(Y, T, w12, wL, gout, dY, out,
                                              d, g, nurbs, Q12, QL, nL,
                                              stream);
        case kJac:
            return launch_fields<kJac, MODE>(Y, T, w12, wL, gout, dY, out, d,
                                             g, nurbs, Q12, QL, nL, stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
