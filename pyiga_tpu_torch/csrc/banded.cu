// K4: flat banded matvec for Hopper (sm_90a), float64 and float32.
//
// Replaces pyiga_tpu/ops/banded.py `_flat_call` (pallas_call at :515, f32)
// and `_flat_call_pair` (:541, two-float pair), body `_make_flat_kernel`,
// together with their row-blocked forms `_flat_call_blocked` (:699) and
// `_flat_call_pair_blocked` (:735), body `_make_flat_kernel_blocked`.  The
// TPU needs the blocked forms above ~500k dofs because x and y must fit its
// 16 MB VMEM; this kernel keeps nothing resident and has no such gate.  The
// f64 residual matvec, a two-float pair kernel on the TPU, is a native
// double instantiation here.
//
//   y[i] = sum_c D[c, i] * x[i + off_c]      (c over the prod(2b_k+1) band
//                                             combos, 343 at p=3 in 3D)
//
// D is (C, F) combo-major over the unpadded flat dof grid, with zeros
// wherever the band leaves the matrix; those zeros mask the reads that
// wrap across an axis boundary (ops/banded.flat_banded_layout).  xp is x
// with `lead` zeros in front and `lead` behind, so every shifted read is
// in bounds.
//
// Bound: device-memory reads of D (C * F elements, read once; 364 MB in
// f64 at the 3D n=48 headline).  One thread per row i: for each combo the
// warp reads 32 consecutive D entries (coalesced), and the shifted x reads
// of neighbouring threads are neighbouring addresses served from L1/L2 (x
// is 1 MB).  The combo offsets sit in shared memory.  Offsets and indices
// are 64-bit: C * F * 8 bytes exceeds 2^31 at n=96.

#include "common.cuh"

namespace {

template <typename T>
__global__ void flat_banded_kernel(const T* __restrict__ D,
                                   const T* __restrict__ xp,
                                   const long long* __restrict__ offs,
                                   T* __restrict__ y, int C, long long F,
                                   long long lead) {
    extern __shared__ long long s_offs[];
    for (int c = threadIdx.x; c < C; c += blockDim.x) s_offs[c] = offs[c];
    __syncthreads();
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < F; i += (long long)gridDim.x * blockDim.x) {
        const T* xi = xp + lead + i;
        T acc = T(0);
        for (int c = 0; c < C; ++c)
            acc += D[(long long)c * F + i] * __ldg(xi + s_offs[c]);
        y[i] = acc;
    }
}

template <typename T>
int launch_flat_banded(const T* D, const T* xp, const long long* offs, T* y,
                       int C, long long F, long long lead, void* stream) {
    const int threads = 256;
    const size_t smem = (size_t)C * sizeof(long long);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    flat_banded_kernel<T><<<pyiga_grid_1d(F, threads), threads, smem,
                            (cudaStream_t)stream>>>(D, xp, offs, y, C, F,
                                                    lead);
    return (int)cudaGetLastError();
}

}  // namespace

PYIGA_EXPORT int pyiga_flat_banded_f64(const double* D, const double* xp,
                                       const long long* offs, double* y,
                                       int C, long long F, long long lead,
                                       void* stream) {
    return launch_flat_banded<double>(D, xp, offs, y, C, F, lead, stream);
}

PYIGA_EXPORT int pyiga_flat_banded_f32(const float* D, const float* xp,
                                       const long long* offs, float* y, int C,
                                       long long F, long long lead,
                                       void* stream) {
    return launch_flat_banded<float>(D, xp, offs, y, C, F, lead, stream);
}
