// K6: the local-multigrid solve loop, whole V-cycles in one launch, for
// Hopper (sm_90a), float64.
//
// Replaces pyiga_tpu/ops/mg_pallas.py `make_solve` -> `vcycle_call`
// (pallas_call at :493), kernel body `_vcycle_kernel` (:250), host pack
// `build` (:72), and the `lax.while_loop` around it (:503-531).  The TPU
// kernel carries every vector as a two-float f32 pair with Dekker products
// and compensated trees, streams transposed zero-padded (128, 256) matrix
// tiles by DMA, and selects and scatters through one-hot matrices, all
// because the v5e has no f64 and favours dense tiles; it is gated by a VMEM
// budget.  Here the arithmetic is native f64, the sparse matrices are
// padded ELL, the one-hot matrices are exact index gathers and scatters,
// and there is no size gate.
//
// One launch runs cycles from the iterate x until the convergence test of
// ops/mg.py (res = sqrt(res2), stop once res / res0 < tol or after maxiter
// cycles; IEEE sqrt and division, so a nan keeps cycling) ends the loop,
// and writes the cycle count, the last res and every cycle's res2.  One
// cycle, with the operands described by the int64 descriptor `d`
// (ops/cuda_mg.py VCycleOperands._build_desc):
//   1. descend, lv = L-1 .. 1: `steps` x the pre-smoothing directions of
//        rS = b_lv[S] - A_lv[S, :] x_lv ;  x_lv[S] += T_dir rS
//      then r = b_lv - A_lv x_lv and b_{lv-1} = P^T r, x_{lv-1} = 0;
//   2. coarse solve: x_0[ind0] = Cinv b_0[ind0];
//   3. ascend, lv = 1 .. L-1: x_lv += P x_{lv-1}, then the post-smoothing;
//   4. res2 = ||(f - A x) * mask||^2.
// The finest level's x is updated in place; b_{L-1} is f.
//
// Bound: the dense triangular inverses T (m x m per level and sweep
// direction) and the coarse inverse dominate the bytes.  Each T is
// triangular, so each of its rows is read only over its nonzero extent
// [lo, hi), widened to 32-byte sectors (the host computes the extents;
// a dead row's is empty): 22 MB a pass instead of 44 at m = 2356 (the
// (48, 3) bench hierarchy), 1.5 instead of 2.9 at m = 604 (24, 3).  A
// cycle is a chain of dependent steps (the 'gs' smoother, 2 steps, 3
// levels), each ending at a grid barrier of ~1.1 us; at (24, 3) the
// steps' latency and the barriers, not the bytes, set the time.
//
// Design (one cooperative launch, one block of 512 threads an SM):
// * A dense pass stages its vector (rS, or b_0[ind0]) once per block in
//   shared memory, then row groups of kG warps stream the rows of T in
//   slabs of 16-byte loads, 8 a lane in flight.  The rows are taken
//   longest first (the host sorts them by extent), round by round in snake
//   order over the groups, so that every group gets about the same number
//   of entries.  Across rows the pass is pipelined: a row's descriptor,
//   first slab and old x entry are in flight while the previous row is
//   reduced (the first row's while the vector is staged).  A group sums its
//   warps' shares in a fixed order behind a named barrier.
// * Sparse rows (the ELL matrices A, A[S, :], P, P^T) take as few lanes
//   each as leave every lane at most 4 entries, several rows a warp, and
//   fewer where one round of the grid's warps would not cover the rows.
// * The restriction to a level that smooths writes that level's first rS
//   as well (its iterate is zero there, so rS = b[S] exactly), and the
//   residual that ends a cycle writes the next cycle's first rS on the
//   finest level (the same x): the steps that would compute them are
//   skipped, so a cycle after the first has 22 barriers at (24, 3)
//   instead of 24.
// * Every reduction has a fixed order (on a given card: the lanes of a
//   sparse row follow the grid's size) and there are no atomics: a launch
//   is deterministic, and the solver's iteration counts do not change
//   from run to run.  res2 is summed by every block in the same order, so
//   every block takes the same branch of the convergence test without
//   another barrier (one is added where the next cycle would write r
//   before its first barrier: no pre-smoothing).  Vectors written inside
//   the launch are read through L2 (__ldcg), never the non-coherent path.
// * With a trace buffer, block 0 records %globaltimer at the start and
//   after every barrier (the phases of the first cycles).

#include "common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 8;          // 16-byte loads in flight a lane
constexpr int kG = 4;               // warps in the row group of a dense pass
constexpr int kSumLanes = 256;      // the fixed partial sums of res2

// descriptor layout: a header, then kLv words per level; a dense operand
// is 4 words (values, row stride, row descriptors, unused)
constexpr int kHdr = 16;
constexpr int kLv = 40;
enum Header { H_L = 0, H_STEPS, H_NPRE, H_NPOST, H_M0, H_IND0, H_MASK, H_RS,
              H_R, H_VEC, H_CINV };
enum Level { V_N = 0, V_ACOLS, V_AVALS, V_AW, V_M, V_S, V_ASCOLS, V_ASVALS,
             V_ASW, V_PCOLS, V_PVALS, V_PW, V_PTCOLS, V_PTVALS, V_PTW, V_X,
             V_RHS, V_SPOS, V_PRE = 20, V_POST = 28 };

struct Ell {
    const int* cols;
    const double* vals;
    int w;
};

struct Dense {
    const double* vals;     // (m, ld), rows zero-padded to ld (a multiple of 4)
    long long ld;
    const int4* rows;       // (row, lo, hi, x index) in the order taken
};

// Where a thread stands, and its block's shared memory.
struct Ctx {
    int lane, warp;             // in the block
    long long gwarp, nwarps;    // warp in the grid, warps in the grid
    int group, wig, gl;         // row group in the block, warp in it, lane
    long long ggroup, ngroups;  // row group in the grid, groups in the grid
    double* sv;                 // the staged vector (H_VEC doubles)
    double* red;                // kSumLanes / 32 partial sums
    double* part;               // [group][warp in group][parity]
};

__device__ __forceinline__ long long globaltimer() {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// The grid barrier, counting itself into the trace.
struct Barrier {
    cg::grid_group g;
    long long* trace;       // null, or cap entries
    int cap, n;
    __device__ void sync() {
        g.sync();
        ++n;
        if (trace && n < cap && blockIdx.x == 0 && threadIdx.x == 0)
            trace[n] = globaltimer();
    }
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

__device__ __forceinline__ Dense dense(const long long* p) {
    return Dense{addr<const double>(p, 0), word(p, 1),
                 addr<const int4>(p, 2)};
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

__device__ __forceinline__ void group_sync(int group) {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + group), "r"(kG * 32)
                 : "memory");
}

// For every row i < n of the ELL matrix M: fn(i, (M x)_i), called by the
// first lane of the row's lanes.  A row takes the fewest lanes (a power of
// two, 4 to 32) that leave each at most 4 entries, so that its loads go
// out in one batch, and fewer while the grid's warps would need more than
// one round of rows; the lanes stride the row and a butterfly sums them.
// Every lane of a warp runs the same trips.
template <class Fn>
__device__ __forceinline__ void ell_rows(const Ctx& c, const Ell& M,
                                         long long n, const double* x,
                                         Fn fn) {
    int lanes = 4;
    while (lanes < 32 && 4 * lanes < M.w) lanes *= 2;
    while (lanes > 4 && n > c.nwarps * (32 / lanes)) lanes /= 2;
    const int rows = 32 / lanes;
    const int sl = c.lane & (lanes - 1);
    for (long long base = c.gwarp * rows; base < n; base += c.nwarps * rows) {
        const long long i = base + c.lane / lanes;
        double acc = 0.0;
        if (i < n) {
            const int* col = M.cols + i * M.w;
            const double* val = M.vals + i * M.w;
#pragma unroll 4
            for (int k = sl; k < M.w; k += lanes)
                acc += __ldg(val + k) * __ldcg(x + __ldg(col + k));
        }
        for (int o = lanes / 2; o > 0; o >>= 1)
            acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (i < n && sl == 0) fn(i, acc);
    }
}

// A 128-lane slab of 16-byte entries of a row from k (double2 units, e
// the end): the kUnroll loads of a lane are issued together.
__device__ __forceinline__ void load_slab(const double2* t, int k, int e,
                                          double2 (&tv)[kUnroll]) {
    constexpr int GL = kG * 32;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
        tv[u] = k + u * GL < e ? __ldg(t + k + u * GL) : make_double2(0, 0);
}

__device__ __forceinline__ void fma_slab(const double2* v, int k, int e,
                                         const double2 (&tv)[kUnroll],
                                         double (&acc)[kUnroll]) {
    constexpr int GL = kG * 32;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
        if (k + u * GL < e) {
            const double2 vv = v[k + u * GL];
            acc[u] = fma(tv[u].x, vv.x, acc[u]);
            acc[u] = fma(tv[u].y, vv.y, acc[u]);
        }
    }
}

// x[row.dst] (+)= (M src[gather])_row for every row of M.  The vector is
// staged in shared memory (zero beyond m); the rows go to the row groups
// longest first in snake order, pipelined (see the header).
__device__ void dense_pass(const Ctx& c, const Dense& M, int m,
                           const double* src, const int* gather, double* x,
                           bool add) {
    constexpr int GL = kG * 32;
    const double2* v = reinterpret_cast<const double2*>(c.sv);
    const bool leader = c.wig == 0 && c.lane == 0;
    const int4 none = make_int4(-1, 0, 0, 0);
    auto row_at = [&](long long r) {
        const long long p = r * c.ngroups
            + ((r & 1) ? c.ngroups - 1 - c.ggroup : c.ggroup);
        return p < m ? __ldg(M.rows + p) : none;
    };
    auto slab0 = [&](const int4& row, double2 (&tv)[kUnroll]) {
        load_slab(
            reinterpret_cast<const double2*>(M.vals + (long long)row.x * M.ld),
            row.y / 2 + c.gl, row.x < 0 ? 0 : row.z / 2, tv);
    };
    int4 cur = row_at(0), nxt = row_at(1);
    double2 tv[kUnroll];
    slab0(cur, tv);
    double xo = add && leader && cur.x >= 0 ? __ldcg(x + cur.w) : 0.0;
    for (long long k = threadIdx.x; k < M.ld; k += kThreads)
        c.sv[k] = k < m ? __ldcg(src + (gather ? (long long)__ldg(gather + k)
                                                : k))
                        : 0.0;
    __syncthreads();
    double* slots = c.part + c.group * kG * 2;
    for (long long r = 0; cur.x >= 0; ++r) {
        const double2* t =
            reinterpret_cast<const double2*>(M.vals + (long long)cur.x * M.ld);
        const int e = cur.z / 2;
        double acc[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) acc[u] = 0.0;
        int k = cur.y / 2 + c.gl;
        fma_slab(v, k, e, tv, acc);
        for (k += kUnroll * GL; k < e; k += kUnroll * GL) {
            load_slab(t, k, e, tv);
            fma_slab(v, k, e, tv, acc);
        }
        // the next row's descriptor, first slab and x entry go out now
        const int4 after = row_at(r + 2);
        slab0(nxt, tv);
        const double xn =
            add && leader && nxt.x >= 0 ? __ldcg(x + nxt.w) : 0.0;
        double s = acc[0];
#pragma unroll
        for (int u = 1; u < kUnroll; ++u) s += acc[u];
        s = warp_sum(s);
        // two slot sets by row parity: a warp writes a set again only
        // after the group barrier of the row between
        if (c.lane == 0) slots[2 * c.wig + (r & 1)] = s;
        group_sync(c.group);
        if (leader) {
            double dx = slots[r & 1];
#pragma unroll
            for (int w = 1; w < kG; ++w) dx += slots[2 * w + (r & 1)];
            x[cur.w] = add ? xo + dx : dx;
        }
        cur = nxt;
        nxt = after;
        xo = xn;
    }
}

// One Gauss-Seidel sweep over the level's smoothing set S in its algebraic
// form x[S] += T (b[S] - A[S, :] x); with `have_rS` the residual is
// already in rS.
__device__ void smooth_pass(Barrier& bar, const Ctx& c, const long long* lvd,
                            const Dense& T, double* x, const double* b,
                            double* rS, bool have_rS) {
    const int m = (int)word(lvd, V_M);
    if (!have_rS) {
        const int* S = addr<const int>(lvd, V_S);
        ell_rows(c, ell(lvd, V_ASCOLS), m, x, [&](long long i, double z) {
            rS[i] = __ldcg(b + __ldg(S + i)) - z;
        });
        bar.sync();
    }
    dense_pass(c, T, m, rS, nullptr, x, true);
    bar.sync();
}

// One V-cycle; ends with r[i] = ((f - A x) * mask)_i^2 written and a
// barrier.  After the first cycle the finest level's first rS comes from
// the previous cycle's residual (the same x).
__device__ void cycle(Barrier& bar, const Ctx& c, const long long* d,
                      double* x, const double* f, double* work, bool first) {
    const int L = (int)word(d, H_L);
    const int steps = (int)word(d, H_STEPS);
    const int npre = (int)word(d, H_NPRE);
    const int npost = (int)word(d, H_NPOST);
    double* rS = work + word(d, H_RS);
    double* r = work + word(d, H_R);
    // the restriction, or the previous cycle's residual on the finest
    // level, writes the first rS of a level that pre-smooths
    const bool fuse = steps > 0 && npre > 0;

    // 1. descend
    for (int lv = L - 1; lv >= 1; --lv) {
        const long long* lvd = level(d, lv);
        double* xl = level_x(d, lv, L, x, work);
        const double* bl = level_b(d, lv, L, f, work);
        for (int s = 0; s < steps; ++s)
            for (int k = 0; k < npre; ++k)
                smooth_pass(bar, c, lvd, dense(lvd + V_PRE + 4 * k), xl, bl,
                            rS, fuse && (lv < L - 1 || !first) && s == 0
                                    && k == 0);
        ell_rows(c, ell(lvd, V_ACOLS), word(lvd, V_N), xl,
                 [&](long long i, double z) { r[i] = __ldcg(bl + i) - z; });
        bar.sync();
        const long long* cvd = level(d, lv - 1);
        double* xc = level_x(d, lv - 1, L, x, work);
        double* bc = work + word(cvd, V_RHS);
        const int* spos = lv - 1 >= 1 && fuse ? addr<const int>(cvd, V_SPOS)
                                              : nullptr;
        ell_rows(c, ell(lvd, V_PTCOLS), word(cvd, V_N), r,
                 [&](long long j, double z) {
                     bc[j] = z;
                     xc[j] = 0.0;
                     if (spos) {
                         const int p = __ldg(spos + j);
                         if (p >= 0) rS[p] = z;
                     }
                 });
        bar.sync();
    }

    // 2. coarse solve on the coarsest smoothing set
    {
        double* x0 = level_x(d, 0, L, x, work);
        const double* b0 = level_b(d, 0, L, f, work);
        if (L == 1) {
            const long long n0 = word(level(d, 0), V_N);
            for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
                 i < n0; i += (long long)gridDim.x * kThreads)
                x0[i] = 0.0;
            bar.sync();
        }
        dense_pass(c, dense(d + H_CINV), (int)word(d, H_M0), b0,
                   addr<const int>(d, H_IND0), x0, false);
        bar.sync();
    }

    // 3. ascend
    for (int lv = 1; lv < L; ++lv) {
        const long long* lvd = level(d, lv);
        double* xl = level_x(d, lv, L, x, work);
        const double* bl = level_b(d, lv, L, f, work);
        ell_rows(c, ell(lvd, V_PCOLS), word(lvd, V_N),
                 level_x(d, lv - 1, L, x, work),
                 [&](long long i, double z) { xl[i] = __ldcg(xl + i) + z; });
        bar.sync();
        for (int s = 0; s < steps; ++s)
            for (int k = 0; k < npost; ++k)
                smooth_pass(bar, c, lvd, dense(lvd + V_POST + 4 * k), xl, bl,
                            rS, false);
    }

    // 4. the squared entries of the masked residual, and the next cycle's
    // first rS
    const long long* lvd = level(d, L - 1);
    const double* mask = addr<const double>(d, H_MASK);
    const int* spos = L > 1 && fuse ? addr<const int>(lvd, V_SPOS) : nullptr;
    ell_rows(c, ell(lvd, V_ACOLS), word(lvd, V_N), x,
             [&](long long i, double z) {
                 const double fi = __ldg(f + i);
                 const double ri = (fi - z) * __ldg(mask + i);
                 r[i] = ri * ri;
                 if (spos) {
                     const int p = __ldg(spos + i);
                     if (p >= 0) rS[p] = fi - z;
                 }
             });
    bar.sync();
}

// sum_i v[i] in one fixed order (kSumLanes strided partial sums, a
// butterfly in each of their warps, the warps' sums in order), the same
// in every block; every thread gets it.
__device__ double fixed_sum(const Ctx& c, const double* v, long long n) {
    if (threadIdx.x < kSumLanes) {
        double acc = 0.0;
        for (long long i = threadIdx.x; i < n; i += kSumLanes)
            acc += __ldcg(v + i);
        acc = warp_sum(acc);
        if (c.lane == 0) c.red[c.warp] = acc;
    }
    __syncthreads();
    double s = c.red[0];
#pragma unroll
    for (int w = 1; w < kSumLanes / 32; ++w) s += c.red[w];
    __syncthreads();
    return s;
}

__global__ void __launch_bounds__(kThreads, 1)
vcycle_kernel(const long long* __restrict__ d, double* x,
              const double* __restrict__ f, double* work, double* hist,
              double* info, double res0, double tol, int maxiter,
              long long* trace, int trace_cap) {
    extern __shared__ double smem[];
    constexpr int kWarps = kThreads / 32;
    Barrier bar{cg::this_grid(), trace, trace_cap, 0};
    if (trace && trace_cap > 0 && blockIdx.x == 0 && threadIdx.x == 0)
        trace[0] = globaltimer();
    Ctx c;
    c.lane = threadIdx.x & 31;
    c.warp = threadIdx.x >> 5;
    c.gwarp = (long long)blockIdx.x * kWarps + c.warp;
    c.nwarps = (long long)gridDim.x * kWarps;
    c.group = c.warp / kG;
    c.wig = c.warp % kG;
    c.gl = c.wig * 32 + c.lane;
    c.ggroup = (long long)blockIdx.x * (kWarps / kG) + c.group;
    c.ngroups = (long long)gridDim.x * (kWarps / kG);
    c.sv = smem;
    c.red = smem + word(d, H_VEC);
    c.part = c.red + kSumLanes / 32;

    const int L = (int)word(d, H_L);
    const long long n = word(level(d, L - 1), V_N);
    const double* r = work + word(d, H_R);
    // A cycle's first write to r follows a barrier when the finest level
    // pre-smooths (or is the only level); otherwise a block could overwrite
    // r while another still sums it, and the blocks would disagree on res2.
    const bool r_guarded =
        L == 1 || (word(d, H_STEPS) > 0 && word(d, H_NPRE) > 0);
    double res = res0;
    int it = 0;
    while (!(res / res0 < tol) && it < maxiter) {
        cycle(bar, c, d, x, f, work, it == 0);
        const double res2 = fixed_sum(c, r, n);
        if (!r_guarded) bar.sync();
        if (blockIdx.x == 0 && threadIdx.x == 0) hist[it] = res2;
        res = sqrt(res2);
        ++it;
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        info[0] = (double)it;
        info[1] = res;
    }
}

cudaError_t allow_smem(long long smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(vcycle_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
}

}  // namespace

// Shared memory a launch needs for a staged vector of `vec` doubles.
PYIGA_EXPORT long long pyiga_vcycle_smem(long long vec) {
    return 8 * (vec + kSumLanes / 32 + 2 * (kThreads / 32));
}

// Blocks of the cooperative grid on `device` with `smem` bytes of shared
// memory a block: one block an SM.  Returns a CUDA error code.
PYIGA_EXPORT int pyiga_vcycle_blocks(int device, long long smem,
                                     int* blocks) {
    int coop = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                           device);
    if (e != cudaSuccess) return (int)e;
    if (!coop) return (int)cudaErrorNotSupported;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return (int)e;
    if ((e = allow_smem(smem)) != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vcycle_kernel,
                                                      kThreads, (size_t)smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    *blocks = sms;
    return 0;
}

PYIGA_EXPORT int pyiga_vcycle_f64(const long long* desc, double* x,
                                  const double* f, double* work,
                                  double* hist, double* info, double res0,
                                  double tol, int maxiter, long long* trace,
                                  int trace_cap, int blocks, long long smem,
                                  void* stream) {
    void* args[] = {(void*)&desc,  (void*)&x,    (void*)&f,
                    (void*)&work,  (void*)&hist, (void*)&info,
                    (void*)&res0,  (void*)&tol,  (void*)&maxiter,
                    (void*)&trace, (void*)&trace_cap};
    cudaError_t e = allow_smem(smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaLaunchCooperativeKernel((const void*)vcycle_kernel, dim3(blocks),
                                    dim3(kThreads), args, (size_t)smem,
                                    (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
