// K1-jvp in float32 for Hopper (sm_90a): the f32 line's entry of
// geo_fields_jvp_kernel (fields.cuh), beside the float64 one of
// fields_jvp.cu (see there for the Pallas site it differentiates).  A
// translation unit of its own, so that nvcc compiles it beside
// fields_jvp.cu.

#include "fields.cuh"

// K1-jvp in float32 (the f32 line): the same arguments in float.
PYIGA_EXPORT int pyiga_fields_jvp_f32(int kind, const float* Y,
                                      const float* T, const float* w12,
                                      const float* wL, const float* dY,
                                      float* out, int d, int g, int nurbs,
                                      long long Q12, int QL, int nL,
                                      void* stream) {
    return fields_of_kind<kJvp>(kind, Y, T, w12, wL, nullptr, dY, out, d, g,
                                nurbs, Q12, QL, nL, stream);
}
