// K6: one whole local-multigrid V-cycle per launch, for Hopper (sm_90a),
// float64.
//
// Replaces pyiga_tpu/ops/mg_pallas.py `make_solve` -> `vcycle_call`
// (pallas_call at :493), kernel body `_vcycle_kernel` (:250), host pack
// `build` (:72).  The TPU kernel carries every vector as a two-float f32
// pair with Dekker products and compensated trees, streams transposed
// zero-padded (128, 256) matrix tiles by DMA, and selects and scatters
// through one-hot matrices, all because the v5e has no f64 and favours
// dense tiles; it is gated by a VMEM budget.  Here the arithmetic is
// native f64, the sparse matrices are padded ELL, the one-hot matrices
// are exact index gathers and scatters, and there is no size gate.
//
// Per launch, with the operands described by the int64 descriptor `d`
// (ops/cuda_mg.py VCycleOperands._build_desc):
//   1. descend, lv = L-1 .. 1: `steps` x the pre-smoothing directions of
//        rS = b_lv[S] - A_lv[S, :] x_lv ;  x_lv[S] += T_dir rS
//      then r = b_lv - A_lv x_lv and b_{lv-1} = P^T r, x_{lv-1} = 0;
//   2. coarse solve: x_0[ind0] = Cinv b_0[ind0];
//   3. ascend, lv = 1 .. L-1: x_lv += P x_{lv-1}, then the post-smoothing;
//   4. res2 = ||(f - A x) * mask||^2.
// The finest level's x is updated in place; b_{L-1} is f.
//
// Design: one cooperative launch (all blocks co-resident, the grid sized
// by the occupancy calculator); one warp per output row in every step, its
// lanes striding the row and a shuffle butterfly summing them; a grid-wide
// barrier between dependent steps (about 25 per cycle for the 'gs'
// smoother with 2 steps on 3 levels).  Every reduction has a fixed order
// and no atomics, so a launch is deterministic and the solver's iteration
// counts do not change from run to run.  Vectors written inside the
// launch are read through L2 (__ldcg), never the non-coherent path.
//
// Bound: the dense triangular inverses T (m x m per level and sweep
// direction) and the coarse inverse dominate the bytes: 2.9 MB per pass
// at m = 604 (the (24, 3) bench hierarchy), 44 MB at m = 2356 (48, 3).  A
// warp reads a row of T coalesced.  At the small shapes the ~25 grid
// barriers, not the bytes, set the time.

#include "common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 2;

// descriptor layout: a header, then kLv words per level
constexpr int kHdr = 16;
constexpr int kLv = 32;
enum Header { H_L = 0, H_STEPS, H_NPRE, H_NPOST, H_M0, H_IND0, H_CINV,
              H_MASK, H_RS, H_R };
enum Level { V_N = 0, V_ACOLS, V_AVALS, V_AW, V_M, V_S, V_ASCOLS, V_ASVALS,
             V_ASW, V_PRE0, V_PRE1, V_POST0, V_POST1, V_PCOLS, V_PVALS,
             V_PW, V_PTCOLS, V_PTVALS, V_PTW, V_X, V_RHS };

struct Ell {
    const int* cols;
    const double* vals;
    int w;
};

struct Warp {
    long long id, count;
    int lane;
};

__device__ __forceinline__ long long word(const long long* d, int k) {
    return __ldg(d + k);
}

template <typename T>
__device__ __forceinline__ T* addr(const long long* d, int k) {
    return reinterpret_cast<T*>(word(d, k));
}

__device__ __forceinline__ const long long* level(const long long* d,
                                                  int lv) {
    return d + kHdr + kLv * lv;
}

__device__ __forceinline__ Ell ell(const long long* lvd, int k) {
    return Ell{addr<const int>(lvd, k), addr<const double>(lvd, k + 1),
               (int)word(lvd, k + 2)};
}

// x and b of a level: the finest level's are the launch arguments, the
// others live in the work buffer
__device__ __forceinline__ double* level_x(const long long* d, int lv,
                                           int L, double* x, double* work) {
    return lv == L - 1 ? x : work + word(level(d, lv), V_X);
}

__device__ __forceinline__ const double* level_b(const long long* d, int lv,
                                                 int L, const double* f,
                                                 double* work) {
    return lv == L - 1 ? f : work + word(level(d, lv), V_RHS);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// Row i of an ELL matrix times x (every lane gets the sum).
__device__ __forceinline__ double ell_row(const Ell& M, long long i,
                                          const double* x, int lane) {
    const int* c = M.cols + i * M.w;
    const double* v = M.vals + i * M.w;
    double acc = 0.0;
    for (int k = lane; k < M.w; k += 32)
        acc += __ldg(v + k) * __ldcg(x + __ldg(c + k));
    return warp_sum(acc);
}

// Row i of a dense (m, m) matrix times the gathered vector b[idx] (idx
// null: b itself).
__device__ __forceinline__ double dense_row(const double* M, long long i,
                                            long long m, const double* b,
                                            const int* idx, int lane) {
    const double* Mi = M + i * m;
    double acc = 0.0;
    for (long long k = lane; k < m; k += 32)
        acc += __ldg(Mi + k) * __ldcg(b + (idx ? (long long)__ldg(idx + k)
                                                 : k));
    return warp_sum(acc);
}

// One Gauss-Seidel sweep over the level's smoothing set S in its algebraic
// form x[S] += T (b[S] - A[S, :] x).
__device__ void smooth_pass(cg::grid_group& grid, const Warp& w,
                            const long long* lvd, const double* T,
                            double* x, const double* b, double* rS) {
    const long long m = word(lvd, V_M);
    const int* S = addr<const int>(lvd, V_S);
    const Ell AS = ell(lvd, V_ASCOLS);
    for (long long i = w.id; i < m; i += w.count) {
        const double z = ell_row(AS, i, x, w.lane);
        if (w.lane == 0) rS[i] = __ldcg(b + __ldg(S + i)) - z;
    }
    grid.sync();
    for (long long i = w.id; i < m; i += w.count) {
        const double dx = dense_row(T, i, m, rS, nullptr, w.lane);
        if (w.lane == 0) {
            const int s = __ldg(S + i);
            x[s] = __ldcg(x + s) + dx;
        }
    }
    grid.sync();
}

__global__ void __launch_bounds__(kThreads)
vcycle_kernel(const long long* __restrict__ d, double* x,
              const double* __restrict__ f, double* work, double* res2) {
    cg::grid_group grid = cg::this_grid();
    __shared__ double part[kThreads];
    Warp w;
    w.lane = threadIdx.x & 31;
    w.id = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
    w.count = ((long long)gridDim.x * blockDim.x) >> 5;
    const int L = (int)word(d, H_L);
    const int steps = (int)word(d, H_STEPS);
    const int npre = (int)word(d, H_NPRE);
    const int npost = (int)word(d, H_NPOST);
    double* rS = work + word(d, H_RS);
    double* r = work + word(d, H_R);

    // 1. descend
    for (int lv = L - 1; lv >= 1; --lv) {
        const long long* lvd = level(d, lv);
        double* xl = level_x(d, lv, L, x, work);
        const double* bl = level_b(d, lv, L, f, work);
        for (int s = 0; s < steps; ++s)
            for (int k = 0; k < npre; ++k)
                smooth_pass(grid, w, lvd, addr<const double>(lvd, V_PRE0 + k),
                            xl, bl, rS);
        const long long n = word(lvd, V_N);
        const Ell A = ell(lvd, V_ACOLS);
        for (long long i = w.id; i < n; i += w.count) {
            const double z = ell_row(A, i, xl, w.lane);
            if (w.lane == 0) r[i] = __ldcg(bl + i) - z;
        }
        grid.sync();
        const long long nc = word(level(d, lv - 1), V_N);
        const Ell PT = ell(lvd, V_PTCOLS);
        double* xc = level_x(d, lv - 1, L, x, work);
        double* bc = work + word(level(d, lv - 1), V_RHS);
        for (long long j = w.id; j < nc; j += w.count) {
            const double z = ell_row(PT, j, r, w.lane);
            if (w.lane == 0) {
                bc[j] = z;
                xc[j] = 0.0;
            }
        }
        grid.sync();
    }

    // 2. coarse solve on the coarsest smoothing set
    {
        double* x0 = level_x(d, 0, L, x, work);
        const double* b0 = level_b(d, 0, L, f, work);
        if (L == 1) {
            const long long n0 = word(level(d, 0), V_N);
            for (long long i = blockIdx.x * (long long)blockDim.x +
                               threadIdx.x;
                 i < n0; i += (long long)gridDim.x * blockDim.x)
                x0[i] = 0.0;
            grid.sync();
        }
        const long long m0 = word(d, H_M0);
        const int* ind0 = addr<const int>(d, H_IND0);
        const double* Cinv = addr<const double>(d, H_CINV);
        for (long long i = w.id; i < m0; i += w.count) {
            const double v = dense_row(Cinv, i, m0, b0, ind0, w.lane);
            if (w.lane == 0) x0[__ldg(ind0 + i)] = v;
        }
        grid.sync();
    }

    // 3. ascend
    for (int lv = 1; lv < L; ++lv) {
        const long long* lvd = level(d, lv);
        double* xl = level_x(d, lv, L, x, work);
        const double* bl = level_b(d, lv, L, f, work);
        const double* xc = level_x(d, lv - 1, L, x, work);
        const long long n = word(lvd, V_N);
        const Ell P = ell(lvd, V_PCOLS);
        for (long long i = w.id; i < n; i += w.count) {
            const double z = ell_row(P, i, xc, w.lane);
            if (w.lane == 0) xl[i] = __ldcg(xl + i) + z;
        }
        grid.sync();
        for (int s = 0; s < steps; ++s)
            for (int k = 0; k < npost; ++k)
                smooth_pass(grid, w, lvd,
                            addr<const double>(lvd, V_POST0 + k), xl, bl,
                            rS);
    }

    // 4. masked residual norm, summed by block 0 in a fixed order
    const long long* lvd = level(d, L - 1);
    const long long n = word(lvd, V_N);
    const Ell A = ell(lvd, V_ACOLS);
    const double* mask = addr<const double>(d, H_MASK);
    for (long long i = w.id; i < n; i += w.count) {
        const double z = ell_row(A, i, x, w.lane);
        if (w.lane == 0) {
            const double ri = (__ldg(f + i) - z) * __ldg(mask + i);
            r[i] = ri * ri;
        }
    }
    grid.sync();
    if (blockIdx.x == 0) {
        double acc = 0.0;
        for (long long i = threadIdx.x; i < n; i += blockDim.x)
            acc += __ldcg(r + i);
        part[threadIdx.x] = acc;
        __syncthreads();
        for (int h = kThreads / 2; h > 0; h >>= 1) {
            if (threadIdx.x < h) part[threadIdx.x] += part[threadIdx.x + h];
            __syncthreads();
        }
        if (threadIdx.x == 0) res2[0] = part[0];
    }
}

}  // namespace

// Blocks of the cooperative grid on `device`: as many as can be resident
// at once, at most kBlocksPerSM per SM.  Returns a CUDA error code.
PYIGA_EXPORT int pyiga_vcycle_grid(int device, int* blocks) {
    int coop = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                           device);
    if (e != cudaSuccess) return (int)e;
    if (!coop) return (int)cudaErrorNotSupported;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vcycle_kernel,
                                                      kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    *blocks = sms * (per_sm < kBlocksPerSM ? per_sm : kBlocksPerSM);
    return 0;
}

PYIGA_EXPORT int pyiga_vcycle_f64(const long long* desc, double* x,
                                  const double* f, double* work, double* res2,
                                  int blocks, void* stream) {
    void* args[] = {(void*)&desc, (void*)&x, (void*)&f, (void*)&work,
                    (void*)&res2};
    cudaError_t e = cudaLaunchCooperativeKernel(
        (const void*)vcycle_kernel, dim3(blocks), dim3(kThreads), args, 0,
        (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
