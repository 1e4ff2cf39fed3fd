// K1-jvp for Hopper (sm_90a): geo_fields_jvp_kernel<D, G, NURBS, KIND, NL,
// ROWS, S> (fields.cuh), the tangent of K1's output of each kind at Y in
// the direction dY.  No Pallas site of its own: it is the forward mode of
// K1, which replaces pyiga_tpu/ops/pallas_sumfac.py `_fields_fused`
// (pallas_call at :1087); the JAX package runs jax.jvp / jax.jacfwd
// through K1's XLA form (pyiga_tpu/diff.py builds on `asm.field_fn` with
// mode='exact').  Its own translation unit, so that nvcc compiles it
// beside fields.cu and fields_hvp.cu; the float32 entry is in
// fields_jvp_f32.cu.

#include "fields.cuh"

// K1-jvp of `kind` (0 stiffness, 1 mass, 2 jac): out, in K1's output
// layout, the tangent at Y in the direction dY (Y's shape); the other
// arguments as K1's backward entry takes them.
PYIGA_EXPORT int pyiga_fields_jvp_f64(int kind, const double* Y,
                                      const double* T, const double* w12,
                                      const double* wL, const double* dY,
                                      double* out, int d, int g, int nurbs,
                                      long long Q12, int QL, int nL,
                                      void* stream) {
    return fields_of_kind<kJvp>(kind, Y, T, w12, wL, nullptr, dY, out, d, g,
                                nurbs, Q12, QL, nL, stream);
}
