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
//
// The wavefront smoothing mode (the descriptor's H_MODE word) replaces
// the dense T passes above tri_block_cutoff, where T would be O(m^2) bytes
// and its host inverse O(m^3): block 0 runs all `steps` x passes of a
// level's smoothing in `wavefront_smooth` below while the other blocks
// wait at the next grid barrier; residuals, transfers, the coarse solve
// and the convergence test stay grid-wide.  One barrier a smoothing
// half per level, so a cycle at (96, 3) has 12 barriers.
//
// The wavefront Gauss-Seidel sweep, also launched alone as
// `wavefront_gs_kernel` (one launch per DeviceIndexedGS.apply), has no
// Pallas counterpart: the JAX package runs it as an XLA loop
// (pyiga_tpu/ops/mg.py `_smooth` :55, pyiga_tpu/ops/relax.py `_smooth_fn`
// :111), one gather and one scatter per level.  A sweep over the set S is
// a chain of ~500 dependent levels of <= 25 rows of <= 97 entries (the
// (96, 3) hierarchy), so latency, not bytes, bounds it: a grid barrier
// or a launch per level would cost more than the level's work.
// Design: one block runs every level of every pass, the entries of x
// that A[S, :] touches in shared memory under a local numbering (S
// first), loaded once and written back once per call (or, where they do
// not fit, in a global scratch vector).  Only a row's few *fresh* entries
// (columns its pass wrote in the kWfFresh levels before, ~4 of ~49 at
// (96, 3)) wait on the chain of levels; the host pack (ops/cuda_mg.py
// _wave_pack) splits them from the *stale* rest, which includes the
// columns written at the row's level or later (their old value is the
// one to read, so no second barrier is needed for a write after read).
// The block's warps have three roles, handing levels over by mbarriers
// in shared memory, with no block barrier between levels:
// * a loader thread starts each level's bulk copies (TMA: the stale
//   entries, lane-major, and the chain's operands) into rings of slots
//   as soon as a slot is free;
// * two groups of 4 producer warps, taking the levels in turn, sum each
//   row's stale entries (a fixed lane split and order, no atomics) once
//   the chain has finished the level kWfFresh + 1 before, and leave one
//   partial a row;
// * the chain warp, a lane a row, adds the fresh entries to the partial
//   by an FMA chain, their x shuffled from the lanes that wrote them (a
//   lane keeps what it wrote in the last kWfFresh levels in registers),
//   forms the quotient from the reciprocal (one Markstein correction,
//   equal to the division), writes x, __syncwarp, arrives.
// Built with PYIGA_WF_TRACE, the roles record a traced level's clocks:
// scripts/torch_wavefront_probe.py --micro times the parts in place.  The
// chain warp bounds a level (~800 cycles at (96, 3) on an H100): its wait
// for the next level, the shared loads of its operands, the shuffles, the
// FMA chain and quotient, the store and the arrive, one after another.

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
              H_R, H_VEC, H_CINV, H_MODE = 14 };
enum Level { V_N = 0, V_ACOLS, V_AVALS, V_AW, V_M, V_S, V_ASCOLS, V_ASVALS,
             V_ASW, V_PCOLS, V_PVALS, V_PW, V_PTCOLS, V_PTVALS, V_PTW, V_X,
             V_RHS, V_SPOS, V_WAVE, V_PRE = 20, V_POST = 28 };
// the wavefront operands (ops/cuda_mg.py WavefrontSweeps): a header of
// kWfHdr words (local size, local-to-global map, rows written back, the
// stale bytes / 12 of a slot, the partials and the chain-block bytes of a
// chain slot, the global local x or 0, the shared bytes, the levels
// traced and the trace buffer or 0), then kWfGroup words for each of the
// two groups of passes (levels, level table, rows, their global indices,
// the places of their b, the chain blocks)
constexpr int kWfHdr = 10;
constexpr int kWfGroup = 6;
// A level's stale entries go to a ring of kWfStages shared-memory slots
// (ops/cuda_mg.py WF_STAGES), its chain operands to a ring of kWfChain
// (WF_CHAIN); an entry is fresh if its pass writes its column in the
// kWfFresh levels before its row's (WF_FRESH).  The loader starts level h
// once the producers have summed level h - kWfStages, who had waited for
// the chain to finish level h - kWfStages - kWfFresh - 1: so kWfChain
// slots never overwrite one the chain still reads.  kWfGroups groups of
// kWfLanes producer threads take the levels in turn (WF_LANES).  The
// chain warp holds up to kWfFreshRegs fresh columns of a row in
// registers.
constexpr int kWfStages = 4;
constexpr int kWfFresh = 2;
constexpr int kWfChain = kWfStages + kWfFresh + 1;
constexpr int kWfGroups = 2;
constexpr int kWfLanes = 128;
constexpr int kWfProducers = kWfGroups * kWfLanes;
constexpr int kWfFreshRegs = 4;
constexpr int kWfTrace = 16;        // clocks a traced level

// Built with PYIGA_WF_TRACE defined (scripts/torch_wavefront_probe.py
// does), one thread of each role records clock64 at the steps of a level
// into the operands' trace buffer (WavefrontSweeps.set_trace); otherwise
// these expand to nothing.
#ifdef PYIGA_WF_TRACE
#define WF_TRACE_AT(who, g, base)                                           \
    long long* tr_ =                                                        \
        (who) && (g) < m.tcap ? m.trace + kWfTrace * (g) + (base) : nullptr; \
    if (tr_) tr_[0] = clock64()
#define WF_CLOCK(i)                                                         \
    if (tr_) tr_[i] = clock64()
#else
#define WF_TRACE_AT(who, g, base)
#define WF_CLOCK(i)
#endif

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

namespace wf {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

// mbarriers in shared memory: an arrive releases what the thread (and,
// after a __syncwarp, its warp) wrote; a wait on the parity of a phase
// acquires it
__device__ __forceinline__ void mb_init(unsigned long long* b,
                                        unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                     smem_u32(b)),
                 "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mb_inval(unsigned long long* b) {
    asm volatile("mbarrier.inval.shared::cta.b64 [%0];" ::"r"(smem_u32(b))
                 : "memory");
}

__device__ __forceinline__ void mb_arrive(unsigned long long* b) {
    asm volatile(
        "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}" ::"r"(
            smem_u32(b))
        : "memory");
}

__device__ __forceinline__ bool mb_test(unsigned a, unsigned parity) {
    unsigned ok;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(ok)
        : "r"(a), "r"(parity)
        : "memory");
    return ok != 0;
}

// A test that does not block: has the phase of this parity completed?
__device__ __forceinline__ bool mb_done(unsigned a, unsigned parity) {
    unsigned ok;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(ok)
        : "r"(a), "r"(parity)
        : "memory");
    return ok != 0;
}

// A wait longer than two seconds is a lost arrive: trap (the launch
// fails) rather than hang the card.
__device__ __forceinline__ void mb_wait(unsigned long long* b,
                                        unsigned parity) {
    const unsigned a = smem_u32(b);
    if (mb_test(a, parity)) return;
    const long long t0 = globaltimer();
    while (!mb_test(a, parity))
        if (globaltimer() - t0 > 2000000000LL) __trap();
}

// The chain's quotient num / d from the reciprocal r = RN(1 / d): q =
// num r, then one correction by the exact residual num - q d (Markstein).
__device__ __forceinline__ double quotient(double num, double d, double r) {
    const double q = num * r;
    return fma(fma(-q, d, num), r, q);
}

// A group of passes (ops/cuda_mg.py _group_blocks): its levels' table
// (4 words a level: the stale block's and the chain block's addresses,
// k + Ws 2^32, L + T 2^8 + F 2^16 + l 2^32 with l the level
// in its pass), and where each of its rows' b goes in the chain blocks.
struct Group {
    int nlev;
    const longlong2* table;     // 2 a level
    int nrows;
    const int* gid;             // a row's global index
    const int* boff;            // its b's place in cblk (doubles)
    double* cblk;
};

__device__ __forceinline__ Group group_at(const long long* w, int g) {
    const long long* p = w + kWfHdr + kWfGroup * g;
    return Group{(int)word(p, 0),       addr<const longlong2>(p, 1),
                 (int)word(p, 2),       addr<const int>(p, 3),
                 addr<const int>(p, 4), addr<double>(p, 5)};
}

// a level's sizes, from its table row or its chain slot's header
struct Level {
    int k, Ws, L, T, F, l;
};

__device__ __forceinline__ Level level_of(longlong2 row) {
    const unsigned long long a = row.x, b = row.y;
    return Level{(int)(a & 0xffffffffu), (int)(a >> 32), (int)(b & 0xff),
                 (int)((b >> 8) & 0xff), (int)((b >> 16) & 0xffff),
                 (int)(b >> 32)};
}

// The shared memory of a call: a ring of kWfStages stale slots (12 E
// bytes: a level's k Ws values, then their columns), a ring of kWfChain
// chain slots, kWfChain "ready" and "done" and kWfStages "full"
// mbarriers and, unless the operands give a global scratch vector, the
// local x.  A chain slot: the level's header (int4 (k, Ws, L, T), int4
// (F, l, 0, 0)), R stale partials, then its chain block (b, 1 / d, d:
// Rp doubles each, Rp local indices, F Rp fresh values, F Rp codes of
// where their x is (ops/cuda_mg.py _wave_pack fsrc); Rp = k rounded up to
// 4).
struct Smem {
    char* stale;
    int E;
    char* chain;
    int R, cbytes;
    unsigned long long* ready;
    unsigned long long* done;
    unsigned long long* full;
    double* xs;
    long long* trace;       // null, or kWfTrace clocks for tcap levels
    int tcap;
};

__device__ __forceinline__ Smem smem_of(const long long* w, char* base) {
    Smem m;
    m.E = (int)word(w, 3);
    m.R = (int)word(w, 4);
    m.cbytes = 32 + 8 * m.R + (int)word(w, 5);
    m.stale = base;
    m.chain = base + kWfStages * 12 * m.E;
    m.ready = reinterpret_cast<unsigned long long*>(m.chain
                                                    + kWfChain * m.cbytes);
    m.done = m.ready + kWfChain;
    m.full = m.done + kWfChain;
    double* scratch = addr<double>(w, 6);
    m.xs = scratch ? scratch : reinterpret_cast<double*>(m.full + kWfStages);
    m.tcap = (int)word(w, 8);
    m.trace = addr<long long>(w, 9);
    return m;
}

__device__ __forceinline__ char* chain_slot(const Smem& m, int g) {
    return m.chain + (g % kWfChain) * m.cbytes;
}

__device__ __forceinline__ Level header(const char* c) {
    const int4 a = reinterpret_cast<const int4*>(c)[0];
    const int4 b = reinterpret_cast<const int4*>(c)[1];
    return Level{a.x, a.y, a.z, a.w, b.x, b.y};
}

// the views of a chain slot's block for a level of Rp rows, F fresh
struct ChainBlock {
    const double *b, *r, *d;
    const int* dst;
    const double* fval;
    const int* fsrc;
};

__device__ __forceinline__ ChainBlock chain_block(const Smem& m,
                                                  const char* c, int Rp,
                                                  int F) {
    ChainBlock v;
    v.b = reinterpret_cast<const double*>(c + 32 + 8 * m.R);
    v.r = v.b + Rp;
    v.d = v.r + Rp;
    v.dst = reinterpret_cast<const int*>(v.d + Rp);
    v.fval = reinterpret_cast<const double*>(v.dst + Rp);
    v.fsrc = reinterpret_cast<const int*>(v.fval + F * Rp);
    return v;
}

// `bytes` (a multiple of 16, maybe 0) from global `src` to shared `dst` by
// the bulk-copy engine (TMA), completing on the mbarrier `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes,
                                          unsigned long long* bar) {
    if (bytes > 0)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
            "l"(src), "r"(bytes), "r"(smem_u32(bar))
            : "memory");
}

// One arrival on `bar` that also expects `bytes` of bulk copies
__device__ __forceinline__ void mb_expect(unsigned long long* bar,
                                          unsigned bytes) {
    asm volatile(
        "{\n.reg .b64 st;\n"
        "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}" ::"r"(
            smem_u32(bar)),
        "r"(bytes)
        : "memory");
}

// The loader (one thread): per level h, once the producers have summed
// level h - kWfStages (so its stale slot is free, and the chain has
// finished level h - kWfChain, whose chain slot level h reuses), write
// the level's header into chain slot h % kWfChain and start the two bulk
// copies of its stale block and chain block, completing on
// full[h % kWfStages].  Table rows are read two levels ahead.
__device__ void load_levels(const Group& gr, int G, const Smem& m) {
    const int n = gr.nlev;
    int i2 = 2 % n;                     // the table index of level h + 2
    longlong2 a0 = __ldg(gr.table), b0 = __ldg(gr.table + 1);
    longlong2 a1 = __ldg(gr.table + 2 * (1 % n));
    longlong2 b1 = __ldg(gr.table + 2 * (1 % n) + 1);
    for (int h = 0; h < G; ++h) {
        const longlong2 a2 = __ldg(gr.table + 2 * i2);
        const longlong2 b2 = __ldg(gr.table + 2 * i2 + 1);
        i2 = i2 + 1 == n ? 0 : i2 + 1;
        if (h >= kWfStages) {
            const int f = h - kWfStages;
            mb_wait(m.ready + f % kWfChain, (f / kWfChain) & 1);
        }
        const Level v = level_of(b0);
        char* c = chain_slot(m, h);
        reinterpret_cast<int4*>(c)[0] = make_int4(v.k, v.Ws, v.L, v.T);
        reinterpret_cast<int4*>(c)[1] = make_int4(v.F, v.l, 0, 0);
        const int sbytes = 12 * v.k * v.Ws;
        const int cb = (28 + 12 * v.F) * ((v.k + 3) & ~3);
        unsigned long long* full = m.full + h % kWfStages;
        mb_expect(full, sbytes + cb);
        bulk_copy(m.stale + (h % kWfStages) * 12 * m.E,
                  reinterpret_cast<const void*>(a0.x), sbytes, full);
        bulk_copy(c + 32 + 8 * m.R, reinterpret_cast<const void*>(a0.y), cb,
                  full);
        a0 = a1;
        b0 = b1;
        a1 = a2;
        b1 = b2;
    }
}

// Producer thread pu of a group: the stale partial of every row of level
// g (k rows, lane split L, T; its k Ws stale values and columns in stale
// slot g % kWfStages): L lanes a row, lane u = p L + j summing quads
// t L + j of row p with an accumulator per entry of the quad, the four
// summed pairwise, the lanes by a butterfly; lane 0 of the row writes it
// to the chain slot.  The block is lane-major (ops/cuda_mg.py
// stale_positions): quad t of lane u is values (2t U + u, (2t + 1) U + u)
// and columns t U + u in 16-byte units, U = k L, so a warp's loads are
// contiguous.
__device__ __forceinline__ void stale_sums(const Smem& m, int g, int pu,
                                           const Level& v) {
    const int L = v.L, T = v.T, lg = __ffs(L) - 1, U = v.k * L;
    const char* slot = m.stale + (g % kWfStages) * 12 * m.E;
    const double2* V = reinterpret_cast<const double2*>(slot);
    const int4* C = reinterpret_cast<const int4*>(slot + 8 * v.k * v.Ws);
    double* part = reinterpret_cast<double*>(chain_slot(m, g) + 32);
    const double* xs = m.xs;
    for (int u0 = 0; u0 < U; u0 += kWfLanes) {
        const int u = u0 + pu;
        double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
        if (u < U) {
            for (int t = 0; t < T; ++t) {
                const double2 v01 = V[2 * t * U + u];
                const double2 v23 = V[(2 * t + 1) * U + u];
                const int4 q = C[t * U + u];
                a0 = fma(v01.x, xs[q.x], a0);
                a1 = fma(v01.y, xs[q.y], a1);
                a2 = fma(v23.x, xs[q.z], a2);
                a3 = fma(v23.y, xs[q.w], a3);
            }
        }
        double s = (a0 + a1) + (a2 + a3);
        for (int o = L >> 1; o > 0; o >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, o);
        if (u < U && (u & (L - 1)) == 0) part[u >> lg] = s;
    }
}

// The producer warps (threads 32 .. 32 + kWfProducers - 1), each on its
// own, group q taking the levels g = q mod kWfGroups: wait for the
// level's copies (full), then until the chain has finished level
// g - kWfFresh - 1 (and the previous pass: l levels back), sum the
// level's stale entries and arrive on ready[g].
__device__ void produce(int G, const Smem& m) {
    const int q = (threadIdx.x - 32) / kWfLanes;
    const int pu = (threadIdx.x - 32) % kWfLanes;
    for (int g = q; g < G; g += kWfGroups) {
        WF_TRACE_AT(pu == 0, g, 8);
        mb_wait(m.full + g % kWfStages, (g / kWfStages) & 1);
        const Level v = header(chain_slot(m, g));
        WF_CLOCK(1);
        const int h = g - 1 - min(kWfFresh, v.l);
        if (h >= 0) mb_wait(m.done + h % kWfChain, (h / kWfChain) & 1);
        WF_CLOCK(2);
        stale_sums(m, g, pu, v);
        WF_CLOCK(3);
        __syncwarp();
        if ((threadIdx.x & 31) == 0) mb_arrive(m.ready + g % kWfChain);
        WF_CLOCK(4);
    }
}

// A row's operands in the chain warp's registers: the stale partial, b,
// 1 / d, d, the local index, and kWfFreshRegs fresh values (zero past the
// level's F) and where to find their x (ops/cuda_mg.py _wave_pack fsrc;
// a pad reads lane 0's last value)
struct ChainRow {
    double part, b, r, d;
    int dst;
    double fv[kWfFreshRegs];
    int fs[kWfFreshRegs];
};

__device__ __forceinline__ void chain_row(const Smem& m, const char* c,
                                          const Level& v, int p,
                                          ChainRow& o) {
    if (p >= v.k) return;
    const int Rp = (v.k + 3) & ~3;
    const ChainBlock cb = chain_block(m, c, Rp, v.F);
    o.part = reinterpret_cast<const double*>(c + 32)[p];
    o.b = cb.b[p];
    o.r = cb.r[p];
    o.d = cb.d[p];
    o.dst = cb.dst[p];
#pragma unroll
    for (int i = 0; i < kWfFreshRegs; ++i) {
        o.fv[i] = i < v.F ? cb.fval[i * Rp + p] : 0.0;
        o.fs[i] = i < v.F ? cb.fsrc[i * Rp + p] : -1;
    }
}

// The x a fresh entry reads where code ~(32 (a - 1) + q) < 0: what lane q
// wrote a levels back (xh[a - 1], by a shuffle, so every lane of the warp
// runs this).  A code >= 0 is a column of the local x, read by the caller.
__device__ __forceinline__ double fresh_x(int code,
                                         const double (&xh)[kWfFresh]) {
    const int q = ~code & 31, a = ~code >> 5;
    double v = 0.0;
#pragma unroll
    for (int j = 0; j < kWfFresh; ++j) {
        const double t = __shfl_sync(0xffffffffu, xh[j], q);
        v = a == j ? t : v;
    }
    return v;
}

// The sum and quotient of row p of a level (its operands in o, F fresh):
// the stale partial, then the fresh entries by an FMA chain (a pad adds
// an exact zero), then (b - s) / d from the reciprocal.  Every lane runs
// it; every fresh x is fetched before the chain starts, from the local x
// only where some lane of the warp needs it.
__device__ __forceinline__ double row_value(const ChainRow& o, int F,
                                            const double (&xh)[kWfFresh],
                                            const double* xs, bool live,
                                            const ChainBlock& cb, int Rp,
                                            int p) {
    double xv[kWfFreshRegs];
    bool shared = false;
#pragma unroll
    for (int i = 0; i < kWfFreshRegs; ++i) {
        xv[i] = fresh_x(o.fs[i], xh);
        shared = shared || o.fs[i] >= 0;
    }
    if (__any_sync(0xffffffffu, shared && live)) {
#pragma unroll
        for (int i = 0; i < kWfFreshRegs; ++i)
            if (live && o.fs[i] >= 0) xv[i] = xs[o.fs[i]];
    }
    double s = o.part;
#pragma unroll
    for (int i = 0; i < kWfFreshRegs; ++i) s = fma(o.fv[i], xv[i], s);
    for (int i = kWfFreshRegs; i < F; ++i) {
        const int code = live ? cb.fsrc[i * Rp + p] : -1;
        const double v = fresh_x(code, xh);
        s = fma(live ? cb.fval[i * Rp + p] : 0.0, code >= 0 ? xs[code] : v,
                s);
    }
    return quotient(o.b - s, o.d, o.r);
}

// The chain warp (threads 0 .. 31): per level g, lane p takes row p (and
// p + 32, ... where a level has more, from the slot): the fresh x from the
// lanes' registers (each lane keeps the x it wrote in the last kWfFresh
// levels), the FMA chain onto the stale partial and the quotient, the
// store, __syncwarp; lane 0 arrives on done[g]; then the warp waits for
// level g + 1's producers and reads its operands.
__device__ void chain(int G, const Smem& m) {
    const int lane = threadIdx.x;
    double* xs = m.xs;
    double xh[kWfFresh];
#pragma unroll
    for (int j = 0; j < kWfFresh; ++j) xh[j] = 0.0;
    ChainRow cur = {};
    mb_wait(m.ready, 0);
    Level cv = header(m.chain);
    chain_row(m, m.chain, cv, lane, cur);
    for (int g = 0; g < G; ++g) {
        WF_TRACE_AT(lane == 0, g, 0);
        const char* c = chain_slot(m, g);
        const int Rp = (cv.k + 3) & ~3;
        const ChainBlock cb = chain_block(m, c, Rp, cv.F);
        const bool live = lane < cv.k;
        const double xn = row_value(cur, cv.F, xh, xs, live, cb, Rp, lane);
        if (live) xs[cur.dst] = xn;
        WF_CLOCK(1);
        // rows 32 .. of a level of more than 32 (their x is read from the
        // local x by the levels after)
        for (int p0 = 32; p0 < cv.k; p0 += 32) {
            const int p = p0 + lane;
            ChainRow o = {};
            chain_row(m, c, cv, p, o);
            const double v = row_value(o, cv.F, xh, xs, p < cv.k, cb, Rp, p);
            if (p < cv.k) xs[o.dst] = v;
        }
#pragma unroll
        for (int j = kWfFresh - 1; j > 0; --j) xh[j] = xh[j - 1];
        xh[0] = xn;
        __syncwarp();
        if (lane == 0) mb_arrive(m.done + g % kWfChain);
        WF_CLOCK(2);
        const int h = g + 1;
        if (h < G) {
            const unsigned a = smem_u32(m.ready + h % kWfChain);
            if (!mb_done(a, (h / kWfChain) & 1))
                mb_wait(m.ready + h % kWfChain, (h / kWfChain) & 1);
            WF_CLOCK(3);
            const char* cn = chain_slot(m, h);
            cv = header(cn);
            chain_row(m, cn, cv, lane, cur);
        }
        WF_CLOCK(4);
    }
}

// `iterations` x the passes of group `group` of the wavefront operands `w`
// for A x = b, by one block (shared memory from `base`): b goes to the
// chain blocks, x's touched entries to the local x, and the set's entries
// of the local x back to x.
__device__ __noinline__ void wavefront_smooth(const long long* w, int group,
                                              int iterations, double* x,
                                              const double* b, char* base) {
    const Smem m = smem_of(w, base);
    const Group gr = group_at(w, group);
    const int nloc = (int)word(w, 0);
    const int* l2g = addr<const int>(w, 1);
    const int nset = (int)word(w, 2);
    const int G = gr.nlev * iterations;
    for (int r = threadIdx.x; r < gr.nrows; r += blockDim.x)
        gr.cblk[__ldg(gr.boff + r)] = __ldcg(b + __ldg(gr.gid + r));
    for (int j = threadIdx.x; j < nloc; j += blockDim.x)
        m.xs[j] = __ldcg(x + __ldg(l2g + j));
    if (threadIdx.x == 0) {
        for (int s = 0; s < kWfChain; ++s) {
            mb_init(m.ready + s, kWfLanes / 32);
            mb_init(m.done + s, 1);
        }
        for (int s = 0; s < kWfStages; ++s) mb_init(m.full + s, 1);
    }
    // b's copies in the chain blocks, and earlier generic writes to this
    // shared memory, before the bulk copies (another proxy) that follow
    asm volatile("fence.proxy.async;" ::: "memory");
    __syncthreads();
    if (G > 0) {
        if (threadIdx.x < 32)
            chain(G, m);
        else if (threadIdx.x < 32 + kWfProducers)
            produce(G, m);
        else if (threadIdx.x == 32 + kWfProducers)
            load_levels(gr, G, m);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int s = 0; s < kWfChain; ++s) {
            mb_inval(m.ready + s);
            mb_inval(m.done + s);
        }
        for (int s = 0; s < kWfStages; ++s) mb_inval(m.full + s);
    }
    for (int j = threadIdx.x; j < nset; j += blockDim.x)
        x[__ldg(l2g + j)] = m.xs[j];
}

}  // namespace wf

// A level's smoothing half in the wavefront mode, by block 0: the passes
// of group `group` (0 pre, 1 post), `steps` times, in the block's shared
// memory.
__device__ void wave_level(const Ctx& c, const long long* lvd, int group,
                           int steps, double* x, const double* b) {
    wf::wavefront_smooth(addr<const long long>(lvd, V_WAVE), group, steps,
                         x, b, reinterpret_cast<char*>(c.sv));
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
    const bool wave = word(d, H_MODE) != 0;
    // the restriction, or the previous cycle's residual on the finest
    // level, writes the first rS of a level that pre-smooths
    const bool fuse = !wave && steps > 0 && npre > 0;

    // 1. descend
    for (int lv = L - 1; lv >= 1; --lv) {
        const long long* lvd = level(d, lv);
        double* xl = level_x(d, lv, L, x, work);
        const double* bl = level_b(d, lv, L, f, work);
        if (wave) {
            if (steps > 0 && npre > 0) {
                if (blockIdx.x == 0)
                    wave_level(c, lvd, 0, steps, xl, bl);
                bar.sync();
            }
        } else {
            for (int s = 0; s < steps; ++s)
                for (int k = 0; k < npre; ++k)
                    smooth_pass(bar, c, lvd, dense(lvd + V_PRE + 4 * k), xl,
                                bl, rS,
                                fuse && (lv < L - 1 || !first) && s == 0
                                    && k == 0);
        }
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
        if (wave) {
            if (steps > 0 && npost > 0) {
                if (blockIdx.x == 0)
                    wave_level(c, lvd, 1, steps, xl, bl);
                bar.sync();
            }
        } else {
            for (int s = 0; s < steps; ++s)
                for (int k = 0; k < npost; ++k)
                    smooth_pass(bar, c, lvd, dense(lvd + V_POST + 4 * k), xl,
                                bl, rS, false);
        }
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

// The wavefront sweeps alone: one block, `iterations` x the passes first
// .. first+count-1 (see the header).
__global__ void __launch_bounds__(kThreads, 1)
wavefront_gs_kernel(const long long* __restrict__ w, int group,
                    int iterations, double* x, const double* b) {
    extern __shared__ double smem[];
    wf::wavefront_smooth(w, group, iterations, x, b,
                         reinterpret_cast<char*>(smem));
}

__global__ void quotient_kernel(const double* __restrict__ num,
                                const double* __restrict__ d,
                                const double* __restrict__ r, double* out,
                                long long n) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < n; i += (long long)gridDim.x * blockDim.x)
        out[i] = wf::quotient(num[i], d[i], r[i]);
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

// The wavefront kernel's compile-time layout, for the host pack to check:
// (kWfStages, kWfFresh, kWfChain, kWfHdr, kWfGroup, kWfLanes).
PYIGA_EXPORT int pyiga_wavefront_layout(int i) {
    const int v[] = {kWfStages, kWfFresh, kWfChain, kWfHdr, kWfGroup,
                     kWfLanes};
    return i >= 0 && i < 6 ? v[i] : -1;
}

// out[i] = the chain warp's quotient of num[i] by d[i] from r[i] = 1 / d[i]
// (wf::quotient), for checking it against the division.
PYIGA_EXPORT int pyiga_wavefront_quotient_f64(const double* num,
                                              const double* d,
                                              const double* r, double* out,
                                              long long n, void* stream) {
    if (n <= 0) return 0;
    quotient_kernel<<<pyiga_grid_1d(n, 256), 256, 0, (cudaStream_t)stream>>>(
        num, d, r, out, n);
    return (int)cudaGetLastError();
}

PYIGA_EXPORT int pyiga_wavefront_gs_f64(const long long* w, int group,
                                        int iterations, double* x,
                                        const double* b, long long smem,
                                        void* stream) {
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            wavefront_gs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    wavefront_gs_kernel<<<1, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
        w, group, iterations, x, b);
    return (int)cudaGetLastError();
}
