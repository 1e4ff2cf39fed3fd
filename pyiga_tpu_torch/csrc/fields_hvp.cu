// K1-hvp for Hopper (sm_90a): geo_fields_hvp_kernel<D, G, NURBS, KIND, NL,
// S> (fields.cuh), the tangent of K1-bwd's gY at Y in the direction dY
// for a fixed output gradient gout.  No Pallas site of its own: it is the
// second derivative of K1, which replaces pyiga_tpu/ops/pallas_sumfac.py
// `_fields_fused` (pallas_call at :1087); the JAX package differentiates
// K1's XLA form twice (jax.hessian, jax.jvp of jax.grad).  Its own
// translation unit, so that nvcc compiles it beside fields.cu and
// fields_jvp.cu.

#include "fields.cuh"

// K1-hvp of `kind` (0 stiffness, 1 mass, 2 jac): gY (Y's shape), the
// Hessian of <gout, K1(Y)> applied to dY; the other arguments as K1's
// backward entry takes them.
PYIGA_EXPORT int pyiga_fields_hvp_f64(int kind, const double* Y,
                                      const double* T, const double* w12,
                                      const double* wL, const double* gout,
                                      const double* dY, double* gY, int d,
                                      int g, int nurbs, long long Q12, int QL,
                                      int nL, void* stream) {
    return fields_of_kind<kHvp>(kind, Y, T, w12, wL, gout, dY, gY, d, g,
                                nurbs, Q12, QL, nL, stream);
}

// K1-hvp in float32 (the f32 line): the same arguments in float.
PYIGA_EXPORT int pyiga_fields_hvp_f32(int kind, const float* Y,
                                      const float* T, const float* w12,
                                      const float* wL, const float* gout,
                                      const float* dY, float* gY, int d,
                                      int g, int nurbs, long long Q12, int QL,
                                      int nL, void* stream) {
    return fields_of_kind<kHvp>(kind, Y, T, w12, wL, gout, dY, gY, d, g,
                                nurbs, Q12, QL, nL, stream);
}
