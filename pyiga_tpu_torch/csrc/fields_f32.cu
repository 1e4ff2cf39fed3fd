// K1 and K1-bwd in float32 for Hopper (sm_90a): the f32 line's entries of
// geo_fields_kernel and geo_fields_bwd_kernel (fields.cuh), beside the
// float64 ones of fields.cu (see there for the Pallas sites they
// replace).  A translation unit of its own, so that nvcc compiles the
// float32 instances beside the float64 ones.

#include "fields.cuh"

// K1's float32 instance, stiffness and mass kinds (the f32 line): the same
// arguments in float.
PYIGA_EXPORT int pyiga_stiff_fields_f32(const float* Y, const float* T,
                                        const float* w12, const float* wL,
                                        float* out, int d, int nurbs,
                                        long long Q12, int QL, int nL,
                                        void* stream) {
    return launch_fields<kStiffness, kFwd>(Y, T, w12, wL, nullptr, nullptr,
                                           out, d, d, nurbs, Q12, QL, nL,
                                           stream);
}

PYIGA_EXPORT int pyiga_mass_fields_f32(const float* Y, const float* T,
                                       const float* w12, const float* wL,
                                       float* out, int d, int nurbs,
                                       long long Q12, int QL, int nL,
                                       void* stream) {
    return launch_fields<kMass, kFwd>(Y, T, w12, wL, nullptr, nullptr, out,
                                      d, d, nurbs, Q12, QL, nL, stream);
}

// K1's float32 instance, jac kind (the f32 line's VForm fields): every
// (d, g, NURBS, nL, mapping) the float64 entry takes, in float.
PYIGA_EXPORT int pyiga_geo_jac_fields_f32(const float* Y, const float* T,
                                          float* out, int d, int g,
                                          int nurbs, long long Q12, int QL,
                                          int nL, void* stream) {
    return launch_fields<kJac, kFwd>(Y, T, nullptr, nullptr, nullptr, nullptr,
                                     out, d, g, nurbs, Q12, QL, nL, stream);
}

// K1's backward in float32 (the f32 line's differentiable assembly): the
// same arguments in float, every kind, (d, g, NURBS, nL) and mapping.
PYIGA_EXPORT int pyiga_fields_bwd_f32(int kind, const float* Y,
                                      const float* T, const float* w12,
                                      const float* wL, const float* gout,
                                      float* gY, int d, int g, int nurbs,
                                      long long Q12, int QL, int nL,
                                      void* stream) {
    return fields_of_kind<kBwd>(kind, Y, T, w12, wL, gout, nullptr, gY, d, g,
                                nurbs, Q12, QL, nL, stream);
}
