// f64 tensor-core tiles for Hopper (sm_90): DMMA through
// mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64, fed from shared
// memory that cp.async fills.
//
// Hopper's wgmma has no f64 form; the f64 tensor-core path is mma.sync
// (the m16n8k* shapes need sm_90, PTX ISA 7.8).  One instruction is a
// warp-wide 16 x 8 x 4 product (512 FMA).  Fragment layout (g = lane / 4,
// t = lane % 4; PTX ISA "matrix fragments for mma.m16n8k4", .f64):
//   A (16 x 4, rows m, columns k): a0 = A[g][t], a1 = A[g + 8][t]
//   B (4 x 8, rows k, columns n):  b0 = B[t][g]
//   C (16 x 8):                    c0, c1 = C[g][2t], C[g][2t + 1]
//                                  c2, c3 = C[g + 8][2t], C[g + 8][2t + 1]
// A 64-bit shared-memory load of a warp is served per half-warp (16
// lanes: g in 0..3, t in 0..3) from 16 eight-byte bank pairs.  The
// fragment loads below are conflict-free when the row stride of the
// buffer, in doubles, is 4 mod 16 (g * stride + t covers 16 distinct
// pairs); the callers pad their buffers so.

#pragma once

#include "common.cuh"

namespace dmma {

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// c += A (16 x 4) * B (4 x 8)
__device__ __forceinline__ void mma_16x8x4(double (&c)[4], double a0,
                                           double a1, double b0) {
    asm volatile(
        "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a0), "d"(a1), "d"(b0));
}

// A fragment from a buffer holding A row-major (k contiguous), stride ld:
// rows row0 .. row0 + 15, columns k0 .. k0 + 3.
__device__ __forceinline__ void load_a(const double* s, int ld, int row0,
                                       int k0, double& a0, double& a1) {
    const double* p = s + (row0 + lane_g()) * ld + k0 + lane_t();
    a0 = p[0];
    a1 = p[8 * ld];
}

// A fragment from a buffer holding A transposed ([k][m], m contiguous),
// stride ld: rows row0 .. row0 + 15, columns k0 .. k0 + 3.
__device__ __forceinline__ void load_a_km(const double* s, int ld, int row0,
                                          int k0, double& a0, double& a1) {
    const double* p = s + (k0 + lane_t()) * ld + row0 + lane_g();
    a0 = p[0];
    a1 = p[8];
}

// B fragment from a buffer holding B transposed ([n][k], k contiguous),
// stride ld: rows k0 .. k0 + 3, columns n0 .. n0 + 7.
__device__ __forceinline__ double load_b_nk(const double* s, int ld, int k0,
                                            int n0) {
    return s[(n0 + lane_g()) * ld + k0 + lane_t()];
}

// B fragment from a buffer holding B with k leading ([k][n], n
// contiguous), stride ld: rows k0 .. k0 + 3, columns n0 .. n0 + 7.
__device__ __forceinline__ double load_b_kn(const double* s, int ld, int k0,
                                            int n0) {
    return s[(k0 + lane_t()) * ld + n0 + lane_g()];
}

// B fragment from a buffer holding B transposed ([n][k], k contiguous)
// with row stride 16 and its columns XOR-swizzled by row (k ^ 4 (n % 4),
// see load_tile): conflict-free without padding.
__device__ __forceinline__ double load_b_nk_swz(const double* s, int k0,
                                                int n0) {
    const int g = lane_g();
    return s[(n0 + g) * 16 + ((k0 + lane_t()) ^ ((g & 3) << 2))];
}

// ---- cp.async: global -> shared without registers -----------------------

// Copy BYTES (8 or 16) from global `src` to shared `dst`, of which the
// first `src_bytes` are read and the rest zero-filled (0: all zeros;
// `src` must still be a valid address).
template <int BYTES>
__device__ __forceinline__ void cp_async(double* dst, const double* src,
                                         int src_bytes) {
    const unsigned int d =
        static_cast<unsigned int>(__cvta_generic_to_shared(dst));
    if constexpr (BYTES == 16) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(d), "l"(src), "r"(src_bytes));
    } else {
        static_assert(BYTES == 8, "cp_async copies 8 or 16 bytes");
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                     :: "r"(d), "l"(src), "r"(src_bytes));
    }
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Stage a ROWS x COLS tile of a row-major global matrix (row stride ldg;
// the tile's first element at g) into shared memory (row stride ps), VEC
// doubles per copy (VEC = 2 needs 16-byte aligned rows and columns).
// Rows >= rlim and columns >= clim are zero-filled, so a ragged edge
// contributes exact zeros to the products.  SWZ stores column c of row r
// at c ^ 4 (r % 4) (for load_b_nk_swz; COLS a multiple of 16).
template <int ROWS, int COLS, int VEC, int THREADS, bool SWZ = false>
__device__ __forceinline__ void load_tile(double* s, int ps, const double* g,
                                          long long ldg, long long rlim,
                                          long long clim) {
    constexpr int CPR = COLS / VEC;              // copies per row
    static_assert(COLS % VEC == 0, "tile width is a multiple of VEC");
#pragma unroll
    for (int i0 = 0; i0 < ROWS * CPR; i0 += THREADS) {
        const int i = i0 + (int)threadIdx.x;
        if (ROWS * CPR % THREADS != 0 && i >= ROWS * CPR) break;
        const int r = i / CPR, c = (i % CPR) * VEC;
        long long n = 0;
        if (r < rlim) {
            n = clim - c;
            n = n < 0 ? 0 : (n > VEC ? VEC : n);
        }
        const double* src = n > 0 ? g + r * ldg + c : g;
        const int cs = SWZ ? (c ^ ((r & 3) << 2)) : c;
        cp_async<VEC * 8>(s + r * ps + cs, src, (int)n * 8);
    }
}

}  // namespace dmma
