// K7 glmm_intercept: the whole random-intercept GLMM fit of one (sim, grid)
// cell, the cell's rows spread over its threads, its cluster sums taken in
// row order from shared memory by its first warp.
//
// Replaces: mcpower_tpu/engine/glmmfit.py::_intercept_glmm_grid_stats
// (:909-1264) with its PIRLS (make_pirls, :947-1013), the Laplace and AGQ
// deviances (agq_deviance :1030, agq_deviance_hybrid :1053), the two-phase
// warm-carried Brent search (dev_at / dev_at32 :1119-1186, through
// mixedfit._brent_minimize), the tau^2 = 0 probe (:1188-1193), the final fit
// and its Schur covariance (:1195-1205), the FD Hessian covariance
// (_fd_hessian_cov :65 and dev_beta :1207-1237) and the flags and outcome
// mean (:1238-1246), which XLA fuses into one program per design. Per cell,
// on the rows below its grid point:
//   1. a cold f64 evaluation at log tau^2 = -14 + 0.382 * 21 from the start
//      beta0 and u = 0 (12 PIRLS iterations), its mode cast to f32;
//   2. 14 Brent steps over log tau^2 in [-14, 7]: 6 evaluations of f32 PIRLS
//      at 12 iterations, 8 at 5, each from the last evaluation's (beta, u);
//      each evaluation's deviance in f64 from the f32 mode (Laplace; AGQ: an
//      f64 centre node plus f32 node deltas);
//   3. from that carry cast to f64: the f64 evaluation at the optimum (full
//      AGQ), then from its mode the probe at log tau^2 = -14, the boundary
//      pin, the final 12 f64 iterations at tau^2_hat (1e-12 when pinned),
//      cov = (X'WX - sum c s s' + 1e-10 I)^-1 or 2 H^-1 of the FD Hessian,
//      and converged = finite beta, chol_ok, the unridged rank probe and a
//      finite deviance.
//
// What bounds it on the H100: the latency of one cell's dependent chain,
// and how many cells the card holds at once. A cell runs about 160 PIRLS
// iterations (48 in f64) and ~20 deviance passes; per row each pass takes
// the linear predictor, a transcendental and two IEEE divisions (each a
// software sequence with a slow-path branch under --fmad=false), per cell a
// p x p Cholesky solve and a Brent step. PR 10's design (one warp a cell, a
// lane a cluster walking its cluster's 10-20 rows through that chain,
// per-cluster state in device memory, 229 registers at p <= 4, so 8 cells
// an SM) spent 68% of a cell's cycles in those row walks, 14% in the p x p
// solves, 9% in scratch passes and 5% in warp sums (chip_k7_profile.py,
// PERF.md section 6), and a launch cost one cell's latency (~1.7 ms) per
// wave: 4-5% of its operation bound.
//
// What the design does about it:
// - rows across threads: a cell has one to four warps (the launcher's
//   choice). Each pass is a row phase, in which every thread of the cell
//   takes rows r = t, t + threads, ... (its cluster kept by a running
//   quotient, no division a row) and writes the row's values (w and w z,
//   or the deviance terms, or one log-likelihood per (row, node)) to the
//   cell's row buffer, then a cluster phase in the cell's first warp: lane
//   l takes clusters l, l + 32, ... and adds each cluster's rows in row
//   order from the buffer, in two walks (W, s, t and X'Wz, then X'WX, with
//   the products (x_i w) x_j formed as PR 10's row walk formed them), folds
//   the cluster into its lane partials, and the lanes combine four terms
//   at a time in an xor butterfly that gives every lane the bits of
//   smallchol.lane_sum's pair tree. The transcendentals and divisions of a
//   pass run in parallel over rows; only the additions stay in row order;
// - shared memory holds the cell: its sim's fit columns and y, staged once
//   in f32 by 4-byte cp.async copies (the G cells of a sim in one block
//   share the stage), the row buffer, the per-cluster state (u, its saved
//   and new values, W, t, c, s, the AGQ node values), the lane partials
//   (term-major, so lane l's column is conflict-free; under AGQ in the row
//   buffer's idle columns) and the lane totals;
// - once a cell: the first warp runs the factor, the solve, the u update
//   and the Brent step (its state in shared memory, so no register carries
//   it across a pass); beta reaches the other warps through shared memory;
//   two barriers a pass (named barriers, one a cell, so the cells of a
//   block run apart);
// - p-exact instantiations for p = 1..4 (the main path's p is 2 or 3):
//   every test i < p is then decided at compile time, and the cluster
//   walks, the combine and the solve are straight-line code with no
//   identity padding. Run-time guards split them into blocks whose f64
//   latencies ran in series: the p-exact build measured 1.4-2.0x faster
//   at the timed shapes. Wider fits take the p <= 8 and p <= 16 buckets;
// - the launcher (geometry()) picks warps a cell and cells a block for the
//   fewest waves on the card, then the most warps a cell, from the
//   kernel's residency at each candidate; mcp_glmm_intercept_geometry
//   reports the choice. A cell whose own layout exceeds CELL_STAGED_MAX of
//   shared memory (1,024 clusters, say) takes the streamed path of the same
//   code: rows read from device memory and the row buffer, cluster state
//   and partials in a scratch the caller sizes by that entry point;
// - every row sum is a per-cluster sum in row order, then the lane sum over
//   clusters; the plain version (engine/glmmfit.py) sums in that order and
//   performs the same operations in the same order, the transcendentals are
//   libdevice's and the file is built with --fmad=false, so the two agree
//   bit for bit: work moved between threads, no sum was reordered;
// - the link, nagq and the Hessian are run-time values, uniform in a cell;
// - a PIRLS run stops at a step that is not finite: the reference keeps
//   (beta, u) then, so every later step repeats it and the state is final.

#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"
#include "glmm_link.cuh"
#include "smallchol.cuh"

#ifdef MCP_K7_CLOCKS
// Cycle breakdown (chip_k7_profile.py): thread 0 of each cell adds
// clock64() deltas by region into mcp_k7_clk[cell * 8 + region].
__device__ unsigned long long mcp_k7_clk[MCP_K7_CLOCKS * 8];
#define CLK_T0(v) long long v = clock64()
#define CLK_ADD(c, k, v)                                                                    \
    do {                                                                                    \
        if ((c).t == 0 && (c).cell < MCP_K7_CLOCKS)                                         \
            atomicAdd(&mcp_k7_clk[(c).cell * 8 + (k)], (unsigned long long)(clock64() - (v))); \
    } while (0)
#else
#define CLK_T0(v)
#define CLK_ADD(c, k, v)
#endif

namespace {

using mcp::clamp_hi;
using mcp::clamp_lo;
using mcp::dev_term;
using mcp::LINK_POISSON;
using mcp::m_exp;
using mcp::m_log;
using mcp::mu_var_dmu;
using mcp::MU_EPS;
using mcp::Rows;
using mcp::rows_of;
using mcp::tri;

constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = 256;  // threads a block
// Blocks of MAX_THREADS an SM holds at least, in the p-exact buckets: a
// budget of 128 registers (no spills at p <= 3). 80 registers (3 blocks)
// measured slower at every timed shape, spills and all.
constexpr int MIN_BLOCKS_EXACT = 2;
constexpr int MAX_CELLS = 15;     // cells a block: named barriers 1..15
constexpr size_t SMEM_MAX = 227 * 1024;         // shared memory a block may ask for
constexpr size_t CELL_STAGED_MAX = 100 * 1024;  // a cell above this is streamed
constexpr int MAX_P = 16;
constexpr int MAX_AGQ = 25;
constexpr int N_PIRLS = 12;
constexpr int N_PIRLS_WARM = 5;
constexpr int BRENT_FULL = 6;
constexpr int BRENT_ITERS = 14;
constexpr double LOG_LO = -14.0;
constexpr double LOG_HI = 7.0;
constexpr double BOUNDARY_LOG = -12.0;
constexpr double CGOLD = 0.3819660112501051;
constexpr double BRENT_TOL = 1e-9;
constexpr double EPS_RANK = 1e-6;
constexpr double LOG_2PI = 1.8378770664093453;
constexpr double SQRT2 = 1.4142135623730951;
constexpr double H_STEP = 1e-4;
constexpr int N_U_NEWTON = 20;
// Per-cluster state, slot-major (slot k of cluster j at clus[k * m + j]):
// u, the step's new u, a saved u, W, t, c, the AGQ scale, the profiled
// deviance's u, the hybrid deviance's centre log-likelihood; then s (p
// slots) and, under AGQ, the node values (nagq slots).
enum { C_U = 0, C_UNEW, C_USAVE, C_W, C_T, C_C, C_SS, C_UQ, C_LL, C_S };
// The cell's small area (shared memory), in doubles: beta, the saved beta,
// then the scalars below, then the lane totals of a combine (Geo::nterm),
// then the Hessian's profiled deviances.
enum {
    M_FLAG = 2 * MAX_P, M_BX, M_BW, M_BV, M_BFX, M_BFW, M_BFV, M_BA, M_BB, M_BD, M_BE,
    M_DEVINT, M_TAU2, M_BOUND, M_FINITE, M_CHOL, M_RANK, M_SUMS
};

struct Args {
    const float* X;
    const float* y;
    int sims, max_n, P, G, pf;
    int fit[MAX_P];
    const int* grid;
    int rr, period, m, link;
    const double* beta0;
    int nagq, k0, hessian;
    double gx[MAX_AGQ], glw[MAX_AGQ];
    float gdw[MAX_AGQ];
    unsigned char* scratch;  // streamed path: cells * Geo::cell_bytes
    double *beta, *cov, *tau2, *ybar;
    uint8_t* flags;
};

// Launch geometry (geometry()). Block b serves sims [b / nchunk * spb, +
// spb) and of each the grid points chunk + nchunk * i, i < gc, chunk = b %
// nchunk; threads [tpc * k, tpc * (k + 1)) are the block's cell k = (sim
// ls, point i) with k = ls * gc + i.
struct Geo {
    int tpc;      // threads a cell, a multiple of 32
    int gc, nchunk, spb, cpb;
    int staged;   // 1: rows and the cell's buffers in shared memory
    int rcap;     // rows of a row buffer and of a staged column (max_n)
    int rw;       // doubles a row in the row buffer
    int cs;       // doubles a cluster
    int pl;       // lanes with partials, min(m, 32)
    int nterm;    // partial terms
    size_t stage_bytes;               // a sim's staged columns
    size_t off_clus, off_part, cell_bytes;  // a cell's buffers (shared or scratch)
    size_t small_bytes;               // a cell's small area (shared)
    size_t off_cells, off_small;      // in the block's shared memory
    size_t smem;
    long long blocks;
    int cells_per_sm, waves;
};

// One cell: where its rows, buffers and small area are, and its thread.
struct Cell {
    const float* xb;  // the sim's rows: x_k of row r at xb[r * xs + (staged ? k * rcap : fit[k])]
    const float* yb;  // y of row r at yb[r]
    int xs, n, t, warp, lane, bar;
    double* rows;  // row buffer, rw columns of rcap doubles
    double* clus;  // cluster state, cs slots of m doubles
    double* part;  // lane partials, term k of lane l at part[k * pl + l] (in T)
    double* sm;    // small area
    long long cell;
};

__device__ __forceinline__ float m_max(float x, float y) { return fmaxf(x, y); }
__device__ __forceinline__ double m_max(double x, double y) { return fmax(x, y); }

// glmmfit.py::_loglik_rows in T.
template <typename T>
__device__ __forceinline__ T loglik(int link, T y, T eta) {
    if (link == LINK_POISSON) {
        const T e = clamp_hi(clamp_lo(eta, T(-30)), T(30));
        return y * e - m_exp(e);
    }
    T mu, var, dmu;
    mu_var_dmu<T>(link, eta, mu, var, dmu);
    return (y > T(0.5)) ? m_log(mu) : m_log(T(1) - mu);
}

// The cell's barrier: its warp, or its named barrier.
__device__ __forceinline__ void cell_sync(const Geo& g, const Cell& c) {
    CLK_T0(t0);
    if (g.tpc == WARP)
        __syncwarp();
    else
        asm volatile("bar.sync %0, %1;" ::"r"(c.bar), "r"(g.tpc) : "memory");
    CLK_ADD(c, 6, t0);
}

// f(r, j) for the cell's thread's rows r = t, t + threads, ... below n,
// j the cluster of row r (r % m round robin, r / period blocked), kept by a
// running quotient and remainder rather than a division a row.
template <typename F>
__device__ __forceinline__ void for_rows(const Args& a, const Geo& g, const Cell& c, F&& f) {
    const int per = a.rr ? a.m : a.period;
    const int dq = g.tpc / per, dr = g.tpc % per;
    int q = c.t / per, rem = c.t % per;
    for (int r = c.t; r < c.n; r += g.tpc) {
        f(r, a.rr ? rem : q);
        q += dq;
        rem += dr;
        if (rem >= per) {
            rem -= per;
            ++q;
        }
    }
}

// The cell's p: PB itself in the p-exact buckets (p <= 4), so that every
// test i < p below is decided at compile time there; a run-time value in
// the p <= 8 and p <= 16 buckets.
template <int PB>
__device__ __forceinline__ int npf(const Args& a) {
    return PB <= 4 ? PB : a.pf;
}

template <int PB, typename T>
__device__ __forceinline__ void load_row(const Args& a, const Geo& g, const Cell& c, int r, T* x,
                                         T& y) {
    const float* row = c.xb + (long long)r * c.xs;
#pragma unroll
    for (int k = 0; k < PB; ++k)
        x[k] = (k < npf<PB>(a)) ? (T)row[g.staged ? k * g.rcap : a.fit[k]] : T(0);
    y = (T)c.yb[r];
}

template <int PB, typename T>
__device__ __forceinline__ T row_dot(const Args& a, const T* x, const T* b) {
    T eta = T(0);
#pragma unroll
    for (int k = 0; k < PB; ++k)
        if (k < npf<PB>(a)) eta = eta + x[k] * b[k];
    return eta;
}

// Column q of the row buffer in T (a float column is half a double's).
template <typename T>
__device__ __forceinline__ T* col(const Geo& g, const Cell& c, int q) {
    return reinterpret_cast<T*>(c.rows) + (long long)q * g.rcap;
}

__device__ __forceinline__ double* slot(const Args& a, const Cell& c, int k) {
    return c.clus + (long long)k * a.m;
}

template <typename T>
__device__ __forceinline__ T* part(const Geo& g, const Cell& c, int k) {
    return reinterpret_cast<T*>(c.part) + k * g.pl;
}

// The lane sums of N values at once (their shuffles interleaved), each in
// smallchol.lane_sum's pair tree: level OFF adds lane l's value and lane l
// ^ OFF's, so every lane ends with the bits of the tree.
template <int N, typename T>
__device__ __forceinline__ void warp_sums(T* v) {
#pragma unroll
    for (int off = WARP / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int i = 0; i < N; ++i) v[i] = v[i] + __shfl_xor_sync(FULL, v[i], off);
    }
}

// The warp sums of partial terms [0, nt) (lanes without clusters hold 0)
// into sums[0, nt) in the small area, four terms at a time (eight measured
// slower); every lane may read sums[] on return.
template <typename T>
__device__ __forceinline__ void lane_totals(const Geo& g, const Cell& c, int nt, T* sums) {
    for (int k0 = 0; k0 < nt; k0 += 4) {
        T v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            v[i] = (k0 + i < nt && c.lane < g.pl) ? part<T>(g, c, k0 + i)[c.lane] : T(0);
        warp_sums<4, T>(v);
        if (c.lane == 0) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
                if (k0 + i < nt) sums[k0 + i] = v[i];
        }
    }
    __syncwarp();
}

// Zero this lane's partials of terms [0, nt).
template <typename T>
__device__ __forceinline__ void zero_parts(const Geo& g, const Cell& c, int nt) {
    if (c.lane < g.pl)
        for (int k = 0; k < nt; ++k) part<T>(g, c, k)[c.lane] = T(0);
}

template <typename T>
__device__ __forceinline__ void add_part(const Geo& g, const Cell& c, int k, T v) {
    T* q = part<T>(g, c, k) + c.lane;
    *q = *q + v;
}

template <int PB, typename T>
__device__ __forceinline__ void load_beta(const Args& a, const Cell& c, T* b) {
#pragma unroll
    for (int i = 0; i < PB; ++i) b[i] = (i < npf<PB>(a)) ? (T)c.sm[i] : T(0);
}

__device__ __forceinline__ int& flag(const Cell& c) {
    return *reinterpret_cast<int*>(c.sm + M_FLAG);
}

// Rows p..PB-1 of a packed PB x PB matrix set to the identity's, so that
// one factor and solve of width PB serve any p <= PB: the leading p x p
// factor, and a solve's first p values, keep the bits of a p x p run.
template <int PB, typename T>
__device__ __forceinline__ void pad_identity(const Args& a, T* L) {
#pragma unroll
    for (int i = 0; i < PB; ++i) {
#pragma unroll
        for (int j = 0; j <= i; ++j)
            if (i >= npf<PB>(a)) L[tri(i, j)] = (i == j) ? T(1) : T(0);
    }
}

// The factor and solve of a step's packed system L x = rhs: at the cell's
// own p in the p-exact buckets; elsewhere L padded with identity rows to
// PB (the leading p x p factor, and a solve's first p values, keep the bits
// of a p x p run).
template <int PB, typename T>
__device__ __forceinline__ void factor_solve(const Args& a, T* L, const T* rhs, T* x) {
    if constexpr (PB > 4) pad_identity<PB, T>(a, L);
    mcp::chol_packed<PB>(L);
    mcp::cho_solve_packed<PB>(L, rhs, x);
}

// ---- a PIRLS step ----------------------------------------------------------

// Row phase: each row's w and w z at (beta, u) in columns 0 and 1.
template <int PB, typename T>
__device__ __forceinline__ void step_rows(const Args& a, const Geo& g, const Cell& c,
                                          const T* beta) {
    CLK_T0(t0);
    T* wc = col<T>(g, c, 0);
    T* wzc = col<T>(g, c, 1);
    const double* u = slot(a, c, C_U);
    for_rows(a, g, c, [&](int r, int j) {
        T x[PB], yv;
        load_row<PB, T>(a, g, c, r, x, yv);
        const T eta = row_dot<PB, T>(a, x, beta) + (T)u[j];
        T mu, var, dmu;
        mu_var_dmu<T>(a.link, eta, mu, var, dmu);
        const T w = dmu * dmu / clamp_lo(var, T(MU_EPS));
        const T z = eta + (yv - mu) / dmu;
        wc[r] = w;
        wzc[r] = w * z;
    });
    CLK_ADD(c, 1, t0);
}

// Cluster phase (first warp): the cluster sums, the Schur system, its
// solve and the u update; on a finite step the new beta and u replace the
// old. Sets the cell's flag to whether the step was finite.
template <int PB, typename T>
__device__ __forceinline__ void step_clusters(const Args& a, const Geo& g, const Cell& c, T inv,
                                              T ridge) {
    constexpr int NT = PB * (PB + 1) / 2;
    const int p = npf<PB>(a), nt = p * (p + 1) / 2;
    const int oA = 0, oSS = nt, oB = 2 * nt, oSt = 2 * nt + p;
    CLK_T0(t0);
    zero_parts<T>(g, c, 2 * nt + 2 * p);
    const T* wc = col<T>(g, c, 0);
    const T* wzc = col<T>(g, c, 1);
    for (int j = c.lane; j < a.m; j += WARP) {
        const Rows rw = rows_of(a, c.n, j);
        // first walk: W, s, t and X'Wz; second: X'WX (each sum in row
        // order, fewer values live at once)
        T W = T(0), t = T(0), s[PB], bj[PB];
#pragma unroll
        for (int i = 0; i < PB; ++i) s[i] = bj[i] = T(0);
        for (int k = 0, r = rw.first; k < rw.count; ++k, r += rw.step) {
            T x[PB], yv;
            load_row<PB, T>(a, g, c, r, x, yv);
            const T w = wc[r], wz = wzc[r];
            W = W + w;
#pragma unroll
            for (int i = 0; i < PB; ++i)
                if (i < p) s[i] = s[i] + w * x[i];
            t = t + wz;
#pragma unroll
            for (int i = 0; i < PB; ++i)
                if (i < p) bj[i] = bj[i] + x[i] * wz;
        }
        const T cj = (rw.count > 0) ? T(1) / (W + inv) : T(0);
        slot(a, c, C_W)[j] = (double)W;
        slot(a, c, C_T)[j] = (double)t;
        slot(a, c, C_C)[j] = (double)cj;
#pragma unroll
        for (int i = 0; i < PB; ++i) {
            if (i >= p) continue;
            slot(a, c, C_S + i)[j] = (double)s[i];
            const T cs = cj * s[i];
#pragma unroll
            for (int jj = 0; jj <= i; ++jj) add_part<T>(g, c, oSS + tri(i, jj), cs * s[jj]);
            add_part<T>(g, c, oB + i, bj[i]);
            add_part<T>(g, c, oSt + i, cs * t);
        }
        T Aj[NT];
#pragma unroll
        for (int i = 0; i < NT; ++i) Aj[i] = T(0);
        for (int k = 0, r = rw.first; k < rw.count; ++k, r += rw.step) {
            T x[PB], yv;
            load_row<PB, T>(a, g, c, r, x, yv);
            const T w = wc[r];
#pragma unroll
            for (int i = 0; i < PB; ++i) {
                const T xw = x[i] * w;
#pragma unroll
                for (int jj = 0; jj <= i; ++jj)
                    if (i < p) Aj[tri(i, jj)] = Aj[tri(i, jj)] + xw * x[jj];
            }
        }
#pragma unroll
        for (int i = 0; i < NT; ++i)
            if (i < nt) add_part<T>(g, c, oA + i, Aj[i]);
    }
    CLK_ADD(c, 7, t0);
    CLK_T0(t1);
    T* sums = reinterpret_cast<T*>(c.sm + M_SUMS);
    lane_totals<T>(g, c, 2 * nt + 2 * p, sums);
    T L[NT], rhs[PB], bn[PB];
#pragma unroll
    for (int i = 0; i < PB; ++i) {
        if (i >= p) continue;
#pragma unroll
        for (int jj = 0; jj <= i; ++jj) {
            const T v = sums[oA + tri(i, jj)] - sums[oSS + tri(i, jj)];
            L[tri(i, jj)] = (i == jj) ? v + ridge : v;
        }
        rhs[i] = sums[oB + i] - sums[oSt + i];
    }
#pragma unroll
    for (int i = 0; i < PB; ++i)
        if (i >= p) rhs[i] = T(0);
    CLK_ADD(c, 2, t1);
    CLK_T0(t2);
    factor_solve<PB, T>(a, L, rhs, bn);
    bool ok = true;
#pragma unroll
    for (int i = 0; i < PB; ++i)
        if (i < p) ok = ok && isfinite(bn[i]);
    CLK_ADD(c, 3, t2);
    CLK_T0(t3);
    bool lane_ok = true;
    for (int j = c.lane; j < a.m; j += WARP) {
        T sb = T(0);
#pragma unroll
        for (int i = 0; i < PB; ++i)
            if (i < p) sb = sb + (T)slot(a, c, C_S + i)[j] * bn[i];
        const T un = (T)slot(a, c, C_C)[j] * ((T)slot(a, c, C_T)[j] - sb);
        slot(a, c, C_UNEW)[j] = (double)un;
        lane_ok = lane_ok && isfinite(un);
    }
    const bool all_ok = __all_sync(FULL, ok && lane_ok);
    if (all_ok) {
        for (int j = c.lane; j < a.m; j += WARP) slot(a, c, C_U)[j] = slot(a, c, C_UNEW)[j];
#pragma unroll
        for (int i = 0; i < PB; ++i)
            if (i < p && i == c.lane) c.sm[i] = (double)bn[i];
    }
    if (c.lane == 0) flag(c) = all_ok ? 1 : 0;
    __syncwarp();
    CLK_ADD(c, 4, t3);
}

// ---- the f64 deviance tail ------------------------------------------------

// Row phase at (beta, u): each row's f64 weight and deviance term.
template <int PB>
__device__ __forceinline__ void tail_rows(const Args& a, const Geo& g, const Cell& c,
                                          const double* beta) {
    CLK_T0(t0);
    double* wc = col<double>(g, c, 0);
    double* dc = col<double>(g, c, 1);
    const double* u = slot(a, c, C_U);
    for_rows(a, g, c, [&](int r, int j) {
        double x[PB], yv;
        load_row<PB, double>(a, g, c, r, x, yv);
        const double eta = row_dot<PB, double>(a, x, beta) + u[j];
        double mu, var, dmu;
        mu_var_dmu<double>(a.link, eta, mu, var, dmu);
        wc[r] = dmu * dmu / clamp_lo(var, MU_EPS);
        dc[r] = dev_term(a.link, yv, mu);
    });
    CLK_ADD(c, 1, t0);
}

// Cluster phase (first warp): W_j into its slot, and the Laplace deviance
// (the sums of the deviance terms, of u^2 and of log1p(tau2 W_j) over
// active clusters).
__device__ __forceinline__ double tail_clusters(const Args& a, const Geo& g, const Cell& c,
                                                double tau2, double inv64) {
    CLK_T0(t0);
    const double* wc = col<double>(g, c, 0);
    const double* dc = col<double>(g, c, 1);
    double dt = 0.0, u2 = 0.0, l1p = 0.0;
    for (int j = c.lane; j < a.m; j += WARP) {
        const double uj = slot(a, c, C_U)[j];
        const Rows rw = rows_of(a, c.n, j);
        double W = 0.0, d = 0.0;
        for (int k = 0, r = rw.first; k < rw.count; ++k, r += rw.step) {
            W = W + wc[r];
            d = d + dc[r];
        }
        slot(a, c, C_W)[j] = W;
        const bool act = rw.count > 0;
        dt = dt + d;
        u2 = u2 + (act ? uj * uj : 0.0);
        l1p = l1p + (act ? log1p(tau2 * W) : 0.0);
    }
    CLK_ADD(c, 7, t0);
    CLK_T0(t1);
    double v[3] = {dt, u2, l1p};
    warp_sums<3, double>(v);
    const double dev_cond = 2.0 * v[0];
    const double dev = (dev_cond + v[1] * inv64) + v[2];
    CLK_ADD(c, 2, t1);
    return dev;
}

// PIRLS in T from (beta, u) (the small area and slot C_U) for iters steps,
// then, where asked, the f64 Laplace deviance at the mode (make_pirls'
// pirls); the deviance is the first warp's.
template <int PB, typename T>
__device__ __forceinline__ double pirls(const Args& a, const Geo& g, const Cell& c, double tau2,
                                        int iters, bool with_tail) {
    const double inv64 = 1.0 / fmax(tau2, 1e-12);
    const T inv = (T)inv64;
    const T ridge = (sizeof(T) == 8) ? T(1e-10) : T(1e-6);
    for (int it = 0; it < iters; ++it) {
        T beta[PB];
        load_beta<PB, T>(a, c, beta);
        step_rows<PB, T>(a, g, c, beta);
        cell_sync(g, c);
        if (c.warp == 0) step_clusters<PB, T>(a, g, c, inv, ridge);
        cell_sync(g, c);
        if (!flag(c)) break;  // kept: a fixed point
    }
    if (!with_tail) return 0.0;
    double b64[PB];
    load_beta<PB, double>(a, c, b64);
    tail_rows<PB>(a, g, c, b64);
    cell_sync(g, c);
    double dev = 0.0;
    if (c.warp == 0) dev = tail_clusters(a, g, c, tau2, inv64);
    cell_sync(g, c);
    return dev;
}

// ---- the AGQ deviances ----------------------------------------------------

// First warp: each cluster's node scale sqrt(2) / sqrt(W_j + 1 / tau2).
__device__ __forceinline__ void agq_scales(const Args& a, const Cell& c, double inv) {
    for (int j = c.lane; j < a.m; j += WARP)
        slot(a, c, C_SS)[j] = SQRT2 * (1.0 / sqrt(slot(a, c, C_W)[j] + inv));
}

// log sum exp of v(0..n): the max, then the exponentials added in order.
template <typename T, typename F>
__device__ __forceinline__ T node_logsumexp(int n, F&& v) {
    T mx = v(0);
    for (int k = 1; k < n; ++k) mx = m_max(mx, v(k));
    T acc = T(0);
    for (int k = 0; k < n; ++k) acc = acc + m_exp(v(k) - mx);
    return m_log(acc) + mx;
}

// The full f64 AGQ deviance at the mode (agq_deviance); W_j in its slot.
// Nodes in rounds of g.rw: a row phase writes each (row, node)'s
// log-likelihood, the first warp adds them by cluster in row order.
template <int PB>
__device__ __forceinline__ double agq_deviance(const Args& a, const Geo& g, const Cell& c,
                                               double tau2) {
    const double inv = 1.0 / fmax(tau2, 1e-12);
    const double logt = log(fmax(tau2, 1e-12));
    const int p = npf<PB>(a);
    double beta[PB];
    load_beta<PB, double>(a, c, beta);
    if (c.warp == 0) agq_scales(a, c, inv);
    cell_sync(g, c);
    for (int q0 = 0; q0 < a.nagq; q0 += g.rw) {
        const int nq = min(g.rw, a.nagq - q0);
        CLK_T0(t0);
        for (int qi = 0; qi < nq; ++qi) {
            const double gxq = a.gx[q0 + qi];
            double* lc = col<double>(g, c, qi);
            for_rows(a, g, c, [&](int r, int j) {
                double x[PB], yv;
                load_row<PB, double>(a, g, c, r, x, yv);
                const double uk = slot(a, c, C_U)[j] + slot(a, c, C_SS)[j] * gxq;
                lc[r] = loglik<double>(a.link, yv, row_dot<PB, double>(a, x, beta) + uk);
            });
        }
        CLK_ADD(c, 1, t0);
        cell_sync(g, c);
        if (c.warp == 0) {
            CLK_T0(t1);
            for (int j = c.lane; j < a.m; j += WARP) {
                const Rows rw = rows_of(a, c.n, j);
                const double uj = slot(a, c, C_U)[j], ss = slot(a, c, C_SS)[j];
                for (int qi = 0; qi < nq; ++qi) {
                    const int q = q0 + qi;
                    const double* lc = col<double>(g, c, qi);
                    double ll = 0.0;
                    for (int k = 0, r = rw.first; k < rw.count; ++k, r += rw.step) ll = ll + lc[r];
                    const double uk = uj + ss * a.gx[q];
                    const double prior = (-0.5 * (uk * uk)) * inv - 0.5 * (logt + LOG_2PI);
                    slot(a, c, C_S + p + q)[j] = ((a.glw[q] + a.gx[q] * a.gx[q]) + ll) + prior;
                }
            }
            CLK_ADD(c, 7, t1);
        }
        cell_sync(g, c);
    }
    double dev = 0.0;
    if (c.warp == 0) {
        double acc = 0.0;
        for (int j = c.lane; j < a.m; j += WARP) {
            const Rows rw = rows_of(a, c.n, j);
            const double ss = slot(a, c, C_SS)[j];
            const double li =
                node_logsumexp<double>(a.nagq, [&](int q) { return slot(a, c, C_S + p + q)[j]; }) +
                log(ss);
            acc = acc + ((rw.count > 0) ? li : 0.0);
        }
        warp_sums<1, double>(&acc);
        dev = -2.0 * acc;
    }
    cell_sync(g, c);
    return dev;
}

// The search's AGQ deviance: f64 centre node, f32 node deltas
// (agq_deviance_hybrid); beta and u the f64 casts of the f32 mode. A first
// row phase writes each row's f64 centre log-likelihood (column 0) and its
// f32 predictor and log-likelihood (float columns 2 and 3); then nodes in
// rounds of 2 rw - 4 float columns.
template <int PB>
__device__ __forceinline__ double agq_deviance_hybrid(const Args& a, const Geo& g, const Cell& c,
                                                      double tau2) {
    const double inv = 1.0 / fmax(tau2, 1e-12);
    const double logt = log(fmax(tau2, 1e-12));
    const float inv32 = (float)inv;
    const int p = npf<PB>(a), k0 = a.k0, nr = 2 * g.rw - 4;
    double beta[PB];
    load_beta<PB, double>(a, c, beta);
    if (c.warp == 0) agq_scales(a, c, inv);
    {
        CLK_T0(t0);
        double* llc = col<double>(g, c, 0);
        float* e32c = col<float>(g, c, 2);
        float* l0c = col<float>(g, c, 3);
        for_rows(a, g, c, [&](int r, int j) {
            double x[PB], yv;
            load_row<PB, double>(a, g, c, r, x, yv);
            const double eta_c = row_dot<PB, double>(a, x, beta) + slot(a, c, C_U)[j];
            llc[r] = loglik<double>(a.link, yv, eta_c);
            const float e32 = (float)eta_c;
            e32c[r] = e32;
            l0c[r] = loglik<float>(a.link, (float)yv, e32);
        });
        CLK_ADD(c, 1, t0);
    }
    cell_sync(g, c);
    for (int q0 = 0; q0 < a.nagq; q0 += nr) {
        const int nq = min(nr, a.nagq - q0);
        CLK_T0(t0);
        const float* e32c = col<float>(g, c, 2);
        const float* l0c = col<float>(g, c, 3);
        for (int qi = 0; qi < nq; ++qi) {
            const float gxq = (float)a.gx[q0 + qi];
            float* dc = col<float>(g, c, 4 + qi);
            for_rows(a, g, c, [&](int r, int j) {
                const float shift = (float)slot(a, c, C_SS)[j] * gxq;
                dc[r] = loglik<float>(a.link, c.yb[r], e32c[r] + shift) - l0c[r];
            });
        }
        CLK_ADD(c, 1, t0);
        cell_sync(g, c);
        if (c.warp == 0) {
            CLK_T0(t1);
            const double* llc = col<double>(g, c, 0);
            for (int j = c.lane; j < a.m; j += WARP) {
                const Rows rw = rows_of(a, c.n, j);
                if (q0 == 0) {
                    double llc_j = 0.0;
                    for (int k = 0, r = rw.first; k < rw.count; ++k, r += rw.step)
                        llc_j = llc_j + llc[r];
                    slot(a, c, C_LL)[j] = llc_j;
                }
                for (int qi = 0; qi < nq; ++qi) {
                    const float* dc = col<float>(g, c, 4 + qi);
                    float dll = 0.0f;
                    for (int k = 0, r = rw.first; k < rw.count; ++k, r += rw.step)
                        dll = dll + dc[r];
                    slot(a, c, C_S + p + q0 + qi)[j] = (double)dll;
                }
            }
            CLK_ADD(c, 7, t1);
        }
        cell_sync(g, c);
    }
    double dev = 0.0;
    if (c.warp == 0) {
        double acc = 0.0, llc = 0.0;
        for (int j = c.lane; j < a.m; j += WARP) {
            const Rows rw = rows_of(a, c.n, j);
            const double ss = slot(a, c, C_SS)[j];
            const double uj = slot(a, c, C_U)[j];
            const double prior_c = (-0.5 * (uj * uj)) * inv - 0.5 * (logt + LOG_2PI);
            const double s0 = ((a.glw[k0] + a.gx[k0] * a.gx[k0]) + prior_c) + log(ss);
            const float ss32 = (float)ss, u32 = (float)uj;
            const auto delta = [&](int q) {
                const float uk = u32 + ss32 * (float)a.gx[q];
                const float dprior = (-0.5f * (uk * uk - u32 * u32)) * inv32;
                return (a.gdw[q] + (float)slot(a, c, C_S + p + q)[j]) + dprior;
            };
            const double lse = (double)node_logsumexp<float>(a.nagq, delta);
            llc = llc + slot(a, c, C_LL)[j];
            acc = acc + ((rw.count > 0) ? s0 + lse : 0.0);
        }
        double v[2] = {acc, llc};
        warp_sums<2, double>(v);
        dev = -2.0 * (v[0] + v[1]);
    }
    cell_sync(g, c);
    return dev;
}

// ---- the FD Hessian -------------------------------------------------------

// The beta-profiled Laplace deviance at bq (dev_beta): each cluster's u
// re-optimised from the mode's u by N_U_NEWTON Newton passes, each a row
// phase (y - mu and the weight) and the first warp's cluster step.
template <int PB>
__device__ __forceinline__ double dev_beta(const Args& a, const Geo& g, const Cell& c,
                                           const double* bq, double tc) {
    const double inv = 1.0 / tc;
    double* c0 = col<double>(g, c, 0);
    double* c1 = col<double>(g, c, 1);
    if (c.warp == 0)
        for (int j = c.lane; j < a.m; j += WARP) slot(a, c, C_UQ)[j] = slot(a, c, C_U)[j];
    cell_sync(g, c);
    for (int pass = 0; pass <= N_U_NEWTON; ++pass) {
        const bool last = pass == N_U_NEWTON;
        CLK_T0(t0);
        for_rows(a, g, c, [&](int r, int j) {
            double x[PB], yv;
            load_row<PB, double>(a, g, c, r, x, yv);
            double mu, var, dmu;
            mu_var_dmu<double>(a.link, row_dot<PB, double>(a, x, bq) + slot(a, c, C_UQ)[j], mu,
                               var, dmu);
            const double w = dmu * dmu / clamp_lo(var, MU_EPS);
            c0[r] = last ? w : yv - mu;
            c1[r] = last ? dev_term(a.link, yv, mu) : w;
        });
        CLK_ADD(c, 1, t0);
        cell_sync(g, c);
        if (c.warp == 0 && !last) {
            CLK_T0(t1);
            for (int j = c.lane; j < a.m; j += WARP) {
                const Rows rw = rows_of(a, c.n, j);
                double rs = 0.0, ws = 0.0;
                for (int k = 0, r = rw.first; k < rw.count; ++k, r += rw.step) {
                    rs = rs + c0[r];
                    ws = ws + c1[r];
                }
                const double uq = slot(a, c, C_UQ)[j];
                const double gr = rs - uq / tc;
                const double h = ws + inv;
                slot(a, c, C_UQ)[j] = (rw.count > 0) ? uq + gr / h : 0.0;
            }
            CLK_ADD(c, 7, t1);
        }
        if (!last) cell_sync(g, c);
    }
    double val = 0.0;
    if (c.warp == 0) {
        double dt = 0.0, u2 = 0.0, l1p = 0.0;
        for (int j = c.lane; j < a.m; j += WARP) {
            const Rows rw = rows_of(a, c.n, j);
            const bool act = rw.count > 0;
            double W = 0.0, d = 0.0;
            for (int k = 0, r = rw.first; k < rw.count; ++k, r += rw.step) {
                W = W + c0[r];
                d = d + c1[r];
            }
            const double uq = slot(a, c, C_UQ)[j];
            dt = dt + d;
            u2 = u2 + (act ? uq * uq : 0.0);
            l1p = l1p + (act ? log1p(tc * W) : 0.0);
        }
        double v[3] = {dt, u2, l1p};
        warp_sums<3, double>(v);
        val = (2.0 * v[0] + v[1] / tc) + v[2];
    }
    cell_sync(g, c);
    return val;
}

// Offset v of the central stencil (hessian_offsets): o[k] in {-1, 0, 1}.
__device__ __forceinline__ void stencil(int v, int p, int& i, int& j, double& si, double& sj) {
    i = j = -1;
    si = sj = 0.0;
    if (v == 0) return;
    if (v <= 2 * p) {
        i = (v - 1) / 2;
        si = ((v - 1) % 2) ? -1.0 : 1.0;
        return;
    }
    int k = (v - 1 - 2 * p) / 4;
    const int r = (v - 1 - 2 * p) % 4;
    for (i = 0; i < p; ++i) {
        if (k < p - 1 - i) break;
        k -= p - 1 - i;
    }
    j = i + 1 + k;
    si = (r < 2) ? 1.0 : -1.0;
    sj = (r % 2 == 0) ? 1.0 : -1.0;
}

// 2 H^-1 of the FD Hessian into cov (p x p, device memory), unless not
// finite. Every thread of the cell takes part; the first warp keeps the
// profiled deviances in the small area and assembles H.
template <int PB>
__device__ __forceinline__ void fd_hessian_cov(const Args& a, const Geo& g, const Cell& c,
                                               double tc, double* cov) {
    constexpr int NT = PB * (PB + 1) / 2;
    const int p = npf<PB>(a);
    const int nv = 1 + 2 * p + 2 * p * (p - 1);
    double* vals = c.sm + M_SUMS + g.nterm;
    for (int v = 0; v < nv; ++v) {
        int i, j;
        double si, sj;
        stencil(v, p, i, j, si, sj);
        double bq[PB];
#pragma unroll
        for (int k = 0; k < PB; ++k) {
            const double o = (k == i) ? si : ((k == j) ? sj : 0.0);
            bq[k] = c.sm[MAX_P + k] + H_STEP * o;
        }
        const double val = dev_beta<PB>(a, g, c, bq, tc);
        if (c.warp == 0 && c.lane == 0) vals[v] = val;
    }
    if (c.warp != 0) return;
    __syncwarp();
    double Hm[NT];
#pragma unroll
    for (int i = 0; i < NT; ++i) Hm[i] = 0.0;
    double f0 = 0.0, vp = 0.0, quad[4];
    const double hh = H_STEP * H_STEP, hh4 = 4.0 * H_STEP * H_STEP;
    for (int v = 0; v < nv; ++v) {
        int i, j;
        double si, sj;
        stencil(v, p, i, j, si, sj);
        const double val = vals[v];
        if (v == 0) {
            f0 = val;
        } else if (v <= 2 * p) {
            if ((v - 1) % 2 == 0) {
                vp = val;
            } else {
#pragma unroll
                for (int k = 0; k < PB; ++k)
                    if (k == i) Hm[tri(k, k)] = ((vp - 2.0 * f0) + val) / hh;
            }
        } else {
            const int r = (v - 1 - 2 * p) % 4;
            quad[r] = val;
            if (r == 3) {
                const double hij = (((quad[0] - quad[1]) - quad[2]) + quad[3]) / hh4;
#pragma unroll
                for (int k = 0; k < PB; ++k) {
#pragma unroll
                    for (int l = 0; l < k; ++l)
                        if (k == j && l == i) Hm[tri(k, l)] = hij;
                }
            }
        }
    }
#pragma unroll
    for (int k = 0; k < PB; ++k)
        if (k < p) Hm[tri(k, k)] = Hm[tri(k, k)] + 1e-10;
    pad_identity<PB, double>(a, Hm);
    mcp::chol_packed<PB>(Hm);
    // 2 (H H')^-1 a column at a time: all its entries finite first, then
    // the columns again into cov
    bool finite = true;
    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
        for (int l = 0; l < PB; ++l) {
            if (l >= p) continue;
            double e[PB], coll[PB];
#pragma unroll
            for (int i = 0; i < PB; ++i) e[i] = (i == l) ? 1.0 : 0.0;
            mcp::cho_solve_packed<PB>(Hm, e, coll);
#pragma unroll
            for (int k = 0; k < PB; ++k) {
                if (k >= p) continue;
                if (pass == 0)
                    finite = finite && isfinite(2.0 * coll[k]);
                else if (c.lane == 0)
                    cov[k * p + l] = 2.0 * coll[k];
            }
        }
        if (!finite) return;
    }
}

// ---- the search and the final fit -----------------------------------------

// An f64 evaluation at tau2: iters PIRLS steps, then, unless it is the
// final fit (deviance false), the Laplace or the full AGQ deviance.
template <int PB>
__device__ __forceinline__ double dev_at(const Args& a, const Geo& g, const Cell& c, double tau2,
                                         int iters, bool deviance) {
    const double lap = pirls<PB, double>(a, g, c, tau2, iters, deviance);
    return (deviance && a.nagq > 1) ? agq_deviance<PB>(a, g, c, tau2) : lap;
}

// A search evaluation: f32 PIRLS, then the f64 Laplace or the hybrid AGQ
// deviance.
template <int PB>
__device__ __forceinline__ double dev_at32(const Args& a, const Geo& g, const Cell& c, double tau2,
                                           int iters) {
    const double lap = pirls<PB, float>(a, g, c, tau2, iters, true);
    return a.nagq > 1 ? agq_deviance_hybrid<PB>(a, g, c, tau2) : lap;
}

// The Brent step's trial point (mixedfit._brent_minimize), from the state
// in the small area (first warp).
__device__ __forceinline__ double brent_try(const Cell& c) {
    const double* s = c.sm;
    const double x = s[M_BX], w = s[M_BW], v = s[M_BV], fx = s[M_BFX], fw = s[M_BFW],
                 fv = s[M_BFV], ax = s[M_BA], bx = s[M_BB], d = s[M_BD], e = s[M_BE];
    const double xm = 0.5 * (ax + bx);
    const double tol1 = BRENT_TOL * fabs(x) + 1e-13;
    const double tol2 = 2.0 * tol1;
    const double r = (x - w) * (fx - fv);
    double q = (x - v) * (fx - fw);
    double pp = (x - v) * q - (x - w) * r;
    q = 2.0 * (q - r);
    pp = (q > 0.0) ? -pp : pp;
    q = fabs(q);
    const double e_gold = (x >= xm) ? ax - x : bx - x;
    const double d_gold = CGOLD * e_gold;
    const bool para_ok = (fabs(e) > tol1) && (q > 0.0) && (fabs(pp) < fabs(0.5 * q * e)) &&
                         (pp > q * (ax - x)) && (pp < q * (bx - x));
    double d_para = pp / ((q == 0.0) ? 1.0 : q);
    const double u_try = x + d_para;
    if ((u_try - ax < tol2) || (bx - u_try < tol2)) d_para = (xm >= x) ? tol1 : -tol1;
    const double e2 = para_ok ? d : e_gold;
    const double d2 = para_ok ? d_para : d_gold;
    const double u = x + ((fabs(d2) >= tol1) ? d2 : ((d2 >= 0.0) ? tol1 : -tol1));
    __syncwarp();
    if (c.lane == 0) {
        c.sm[M_BD] = d2;
        c.sm[M_BE] = e2;
    }
    __syncwarp();
    return u;
}

// The Brent step's update at the trial point u with value fu (first warp).
__device__ __forceinline__ void brent_take(const Cell& c, double u, double fu) {
    const double* s = c.sm;
    const double x = s[M_BX], w = s[M_BW], v = s[M_BV], fx = s[M_BFX], fw = s[M_BFW],
                 fv = s[M_BFV], ax = s[M_BA], bx = s[M_BB];
    const bool better = fu <= fx;
    const double a2 = better ? ((u >= x) ? x : ax) : ((u < x) ? u : ax);
    const double bb2 = better ? ((u >= x) ? bx : x) : ((u < x) ? bx : u);
    const bool demote_w = !better && ((fu <= fw) || (w == x));
    const bool demote_v = !better && !demote_w && ((fu <= fv) || (v == x) || (v == w));
    const bool keep_w = better || demote_w;
    const double v2 = keep_w ? w : (demote_v ? u : v);
    const double fv2 = keep_w ? fw : (demote_v ? fu : fv);
    const double w2 = better ? x : (demote_w ? u : w);
    const double fw2 = better ? fx : (demote_w ? fu : fw);
    __syncwarp();
    if (c.lane == 0) {
        c.sm[M_BX] = better ? u : x;
        c.sm[M_BFX] = better ? fu : fx;
        c.sm[M_BV] = v2;
        c.sm[M_BFV] = fv2;
        c.sm[M_BW] = w2;
        c.sm[M_BFW] = fw2;
        c.sm[M_BA] = a2;
        c.sm[M_BB] = bb2;
    }
    __syncwarp();
}

// The final f64 fit's Schur complement at the mode (first warp, after the
// row phase wrote each row's weight to column 0): flags, the rx covariance
// into cov, ysum; returns nothing, leaves finite / chol_ok / rank_ok in the
// small area.
template <int PB>
__device__ __forceinline__ double final_clusters(const Args& a, const Geo& g, const Cell& c,
                                                 double tc, double* cov) {
    constexpr int NT = PB * (PB + 1) / 2;
    const int p = npf<PB>(a), nt = p * (p + 1) / 2;
    const int oA = 0, oSS = nt, oY = 2 * nt;
    const double inv = 1.0 / tc;
    zero_parts<double>(g, c, 2 * nt + 1);
    const double* wc = col<double>(g, c, 0);
    for (int j = c.lane; j < a.m; j += WARP) {
        const Rows rw = rows_of(a, c.n, j);
        // first walk: W, s and the outcome sum; second: X'WX
        double W = 0.0, s[PB], yj = 0.0;
#pragma unroll
        for (int i = 0; i < PB; ++i) s[i] = 0.0;
        for (int k = 0, r = rw.first; k < rw.count; ++k, r += rw.step) {
            double xr[PB], yv;
            load_row<PB, double>(a, g, c, r, xr, yv);
            const double wr = wc[r];
            W = W + wr;
#pragma unroll
            for (int i = 0; i < PB; ++i)
                if (i < p) s[i] = s[i] + wr * xr[i];
            yj = yj + yv;
        }
        const double cj = (rw.count > 0) ? 1.0 / (W + inv) : 0.0;
        add_part<double>(g, c, oY, yj);
#pragma unroll
        for (int i = 0; i < PB; ++i) {
            if (i >= p) continue;
            const double cs = cj * s[i];
#pragma unroll
            for (int jj = 0; jj <= i; ++jj) add_part<double>(g, c, oSS + tri(i, jj), cs * s[jj]);
        }
        double Aj[NT];
#pragma unroll
        for (int i = 0; i < NT; ++i) Aj[i] = 0.0;
        for (int k = 0, r = rw.first; k < rw.count; ++k, r += rw.step) {
            double xr[PB], yv;
            load_row<PB, double>(a, g, c, r, xr, yv);
            const double wr = wc[r];
#pragma unroll
            for (int i = 0; i < PB; ++i) {
                const double xw = xr[i] * wr;
#pragma unroll
                for (int jj = 0; jj <= i; ++jj)
                    if (i < p) Aj[tri(i, jj)] = Aj[tri(i, jj)] + xw * xr[jj];
            }
        }
#pragma unroll
        for (int i = 0; i < NT; ++i)
            if (i < nt) add_part<double>(g, c, oA + i, Aj[i]);
    }
    double* sums = c.sm + M_SUMS;
    lane_totals<double>(g, c, 2 * nt + 1, sums);
    double L[NT];
#pragma unroll
    for (int i = 0; i < PB; ++i) {
        if (i >= p) continue;
#pragma unroll
        for (int jj = 0; jj <= i; ++jj) {
            const double vv = sums[oA + tri(i, jj)] - sums[oSS + tri(i, jj)];
            L[tri(i, jj)] = (i == jj) ? vv + 1e-10 : vv;
        }
    }
    bool rank_ok = true;
    {  // the unridged rank probe: the factor of L less the ridge
        double R[NT];
#pragma unroll
        for (int i = 0; i < PB; ++i) {
#pragma unroll
            for (int jj = 0; jj <= i; ++jj)
                if (i < p) R[tri(i, jj)] = L[tri(i, jj)] - ((i == jj) ? 1e-10 : 0.0);
        }
        pad_identity<PB, double>(a, R);
        mcp::chol_packed<PB>(R);
        double lo = R[0], hi = R[0];
#pragma unroll
        for (int k = 0; k < PB; ++k) {
            if (k >= p) continue;
            const double dr = R[tri(k, k)];
            rank_ok = rank_ok && isfinite(dr) && (dr > 0.0);
            lo = fmin(lo, dr);
            hi = fmax(hi, dr);
        }
        rank_ok = rank_ok && (lo >= EPS_RANK * hi);
    }
    pad_identity<PB, double>(a, L);
    mcp::chol_packed<PB>(L);
    const double ysum = sums[oY];

    bool finite = true, chol_ok = true;
#pragma unroll
    for (int k = 0; k < PB; ++k) {
        if (k >= p) continue;
        finite = finite && isfinite(c.sm[k]);
        const double dl = L[tri(k, k)];
        chol_ok = chol_ok && isfinite(dl) && (dl > 0.0);
    }
    __syncwarp();
    // the covariance (L L')^-1, a column at a time
#pragma unroll
    for (int k = 0; k < PB; ++k) {
        if (k >= p) continue;
        double e[PB], colk[PB];
#pragma unroll
        for (int i = 0; i < PB; ++i) e[i] = (i == k) ? 1.0 : 0.0;
        mcp::cho_solve_packed<PB>(L, e, colk);
        if (c.lane == 0) {
#pragma unroll
            for (int i = 0; i < PB; ++i)
                if (i < p) cov[i * p + k] = colk[i];
        }
    }
    if (c.lane == 0) {
        c.sm[M_FINITE] = finite ? 1.0 : 0.0;
        c.sm[M_CHOL] = chol_ok ? 1.0 : 0.0;
        c.sm[M_RANK] = rank_ok ? 1.0 : 0.0;
    }
    __syncwarp();
    return ysum;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int PB>
__global__ void __launch_bounds__(MAX_THREADS, (PB <= 4) ? MIN_BLOCKS_EXACT : 1)
    glmm_intercept_kernel(const Args a, const Geo g) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int p = npf<PB>(a);
    const int k_in = threadIdx.x / g.tpc;
    const int ls = k_in / g.gc, gi = k_in % g.gc;
    const long long sim = (long long)(blockIdx.x / g.nchunk) * g.spb + ls;
    const int chunk = blockIdx.x % g.nchunk;
    const int gg = chunk + g.nchunk * gi;
    float* stage = reinterpret_cast<float*>(smem) + (size_t)ls * (g.stage_bytes / sizeof(float));

    // The cells of a sim stage it once, up to their largest grid point.
    if (g.staged) {
        if (sim < a.sims) {
            int rows = 0;
            for (int i = 0; i < g.gc; ++i) {
                const int gq = chunk + g.nchunk * i;
                if (gq < a.G) rows = max(rows, a.grid[gq]);
            }
            const float* Xs = a.X + sim * a.max_n * (long long)a.P;
            const float* ys = a.y + sim * a.max_n;
            const int tid = gi * g.tpc + threadIdx.x % g.tpc, nth = g.gc * g.tpc;
            for (int k = 0; k <= p; ++k) {
                const float* src = k < p ? Xs + a.fit[k] : ys;
                const long long stride = k < p ? a.P : 1;
                for (int r = tid; r < rows; r += nth)
                    cp_async4(stage + (size_t)k * g.rcap + r, src + r * stride);
            }
        }
        cp_async_wait_all();
        __syncthreads();  // g is uniform: every thread of the block is here
    }
    if (sim >= a.sims || gg >= a.G) return;  // whole cells leave together

    Cell c;
    c.cell = sim * a.G + gg;
    c.n = a.grid[gg];
    c.t = threadIdx.x % g.tpc;
    c.warp = c.t / WARP;
    c.lane = c.t % WARP;
    c.bar = 1 + k_in;
    unsigned char* big = g.staged ? smem + g.off_cells + (size_t)k_in * g.cell_bytes
                                  : a.scratch + c.cell * (long long)g.cell_bytes;
    c.rows = reinterpret_cast<double*>(big);
    c.clus = reinterpret_cast<double*>(big + g.off_clus);
    c.part = reinterpret_cast<double*>(big + g.off_part);
    c.sm = reinterpret_cast<double*>(smem + g.off_small + (size_t)k_in * g.small_bytes);
    if (g.staged) {
        c.xb = stage;
        c.xs = 1;
        c.yb = stage + (size_t)p * g.rcap;
    } else {
        c.xb = a.X + sim * a.max_n * (long long)a.P;
        c.xs = a.P;
        c.yb = a.y + sim * a.max_n;
    }
    CLK_T0(t_all);

    // The evaluations in turn, each call site once (so each is compiled
    // once): EV_COLD, the cold f64 one from beta0 and u = 0, whose mode is
    // cast to f32; the 14 Brent steps over log tau^2
    // (mixedfit._brent_minimize), the f32 carry threaded through them, the
    // search held by the first warp; EV_INT, the f64 one at the optimum
    // from the carry; EV_ZERO, the probe at LOG_LO from its mode; EV_FINAL,
    // the final fit at tau2_hat (1e-12 when pinned) from the EV_INT mode.
    constexpr int EV_COLD = 0, EV_INT = BRENT_ITERS + 1, EV_ZERO = EV_INT + 1;
    constexpr int EV_FINAL = EV_ZERO + 1;
    const double x0 = LOG_LO + CGOLD * (LOG_HI - LOG_LO);
    double tc = 0.0;
#pragma unroll 1
    for (int ev = EV_COLD; ev <= EV_FINAL; ++ev) {
        const bool search = ev > EV_COLD && ev < EV_INT;
        double lt = 0.0;  // the first warp's
        if (c.warp == 0) {
            if (ev == EV_COLD) {
                if (c.lane < p) c.sm[c.lane] = a.beta0[c.lane];
                for (int j = c.lane; j < a.m; j += WARP) slot(a, c, C_U)[j] = 0.0;
                lt = x0;
            } else if (search) {
                CLK_T0(tb);
                lt = brent_try(c);
                CLK_ADD(c, 5, tb);
            } else {
                lt = ev == EV_INT ? c.sm[M_BX] : LOG_LO;
            }
        }
        cell_sync(g, c);
        if (ev == EV_FINAL) tc = fmax(c.sm[M_TAU2], 1e-12);
        const double tau2 = ev == EV_FINAL ? tc : exp(lt);
        const double d =
            search ? dev_at32<PB>(a, g, c, tau2, ev <= BRENT_FULL ? N_PIRLS : N_PIRLS_WARM)
                   : dev_at<PB>(a, g, c, tau2, N_PIRLS, ev != EV_FINAL);
        if (c.warp != 0) continue;
        if (ev == EV_COLD) {
            if (c.lane < p) c.sm[c.lane] = (double)(float)c.sm[c.lane];
            for (int j = c.lane; j < a.m; j += WARP)
                slot(a, c, C_U)[j] = (double)(float)slot(a, c, C_U)[j];
            __syncwarp();
            if (c.lane == 0) {
                c.sm[M_BX] = c.sm[M_BW] = c.sm[M_BV] = x0;
                c.sm[M_BFX] = c.sm[M_BFW] = c.sm[M_BFV] = d;
                c.sm[M_BA] = LOG_LO;
                c.sm[M_BB] = LOG_HI;
                c.sm[M_BD] = c.sm[M_BE] = 0.0;
            }
        } else if (search) {
            CLK_T0(tb);
            brent_take(c, lt, d);
            CLK_ADD(c, 5, tb);
        } else if (ev == EV_INT) {
            if (c.lane < p) c.sm[MAX_P + c.lane] = c.sm[c.lane];
            for (int j = c.lane; j < a.m; j += WARP) slot(a, c, C_USAVE)[j] = slot(a, c, C_U)[j];
            if (c.lane == 0) c.sm[M_DEVINT] = d;
        } else if (ev == EV_ZERO) {
            const double xo = c.sm[M_BX];
            const bool boundary = (d <= c.sm[M_DEVINT] + 1e-10) || (xo < BOUNDARY_LOG);
            const double tau2_hat = boundary ? 0.0 : exp(xo);
            __syncwarp();
            if (c.lane < p) c.sm[c.lane] = c.sm[MAX_P + c.lane];
            for (int j = c.lane; j < a.m; j += WARP) slot(a, c, C_U)[j] = slot(a, c, C_USAVE)[j];
            if (c.lane == 0) {
                c.sm[M_TAU2] = tau2_hat;
                c.sm[M_BOUND] = boundary ? 1.0 : 0.0;
            }
        }
        __syncwarp();
    }

    // the Schur complement at the mode
    {
        double bc[PB];
        load_beta<PB, double>(a, c, bc);
        CLK_T0(t0);
        double* wc = col<double>(g, c, 0);
        const double* u = slot(a, c, C_U);
        for_rows(a, g, c, [&](int r, int j) {
            double xr[PB], yv;
            load_row<PB, double>(a, g, c, r, xr, yv);
            double mu, var, dmu;
            mu_var_dmu<double>(a.link, row_dot<PB, double>(a, xr, bc) + u[j], mu, var, dmu);
            wc[r] = dmu * dmu / clamp_lo(var, MU_EPS);
        });
        CLK_ADD(c, 1, t0);
    }
    cell_sync(g, c);
    double* cov = a.cov + c.cell * p * p;
    double ysum = 0.0;
    if (c.warp == 0) {
        if (c.lane < p) c.sm[MAX_P + c.lane] = c.sm[c.lane];  // beta for the Hessian
        ysum = final_clusters<PB>(a, g, c, tc, cov);
    }
    cell_sync(g, c);
    if (a.hessian) fd_hessian_cov<PB>(a, g, c, tc, cov);

    if (c.warp == 0 && c.lane == 0) {
        for (int k = 0; k < p; ++k) a.beta[c.cell * p + k] = c.sm[k];
        a.tau2[c.cell] = c.sm[M_TAU2];
        a.ybar[c.cell] = ysum / (double)c.n;
        const bool converged = c.sm[M_FINITE] != 0.0 && c.sm[M_CHOL] != 0.0 &&
                               c.sm[M_RANK] != 0.0 && isfinite(c.sm[M_DEVINT]);
        a.flags[c.cell] = (uint8_t)((converged ? 1 : 0) | (c.sm[M_BOUND] != 0.0 ? 2 : 0));
    }
    CLK_ADD(c, 0, t_all);
}

size_t align16(size_t b) { return (b + 15) / 16 * 16; }

// The inputs a geometry depends on.
struct Shape {
    int sims, max_n, pf, G, m, nagq, hessian;
    bool operator<(const Shape& o) const {
        return std::tie(sims, max_n, pf, G, m, nagq, hessian) <
               std::tie(o.sims, o.max_n, o.pf, o.G, o.m, o.nagq, o.hessian);
    }
};

// Allow this instantiation all the dynamic shared memory a block may take.
template <int PB>
int allow_smem() {
    static int err = (int)cudaFuncSetAttribute(
        glmm_intercept_kernel<PB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
    return err;
}

// Warps a cell, cells a block and the staged or streamed layout for a
// launch: among one to four warps a cell and the block shapes below
// (G = 1: 1, 2, 4 or 8 sims a block; else a sim's grid in chunks of up to
// MAX_CELLS interleaved points), the fewest waves on the card by the
// kernel's residency (cudaOccupancyMaxActiveBlocksPerMultiprocessor), then
// the most warps a cell, then the fewest cells a block. A cell is streamed
// when its own staged layout exceeds CELL_STAGED_MAX. Cached by shape.
template <int PB>
int geometry(const Shape& s, Geo& out) {
    static std::mutex mu;
    static std::map<Shape, Geo> cache;
    std::lock_guard<std::mutex> lock(mu);
    const auto hit = cache.find(s);
    if (hit != cache.end()) {
        out = hit->second;
        return 0;
    }
    int err = allow_smem<PB>();
    if (err != 0) return err;
    int dev = 0, sms = 0;
    if ((err = (int)cudaGetDevice(&dev)) != 0) return err;
    if ((err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != 0)
        return err;
    const int p = s.pf, nt = p * (p + 1) / 2;
    Geo g{};
    g.rcap = s.max_n;
    g.rw = s.nagq > 1 ? 4 : 2;
    g.cs = C_S + p + (s.nagq > 1 ? s.nagq : 0);
    g.pl = s.m < WARP ? s.m : WARP;
    g.nterm = 2 * nt + 2 * p + 1;
    g.stage_bytes = align16((size_t)(p + 1) * g.rcap * sizeof(float));
    g.off_clus = align16((size_t)g.rw * g.rcap * sizeof(double));
    const size_t clus_bytes = align16((size_t)g.cs * s.m * sizeof(double));
    const size_t part_bytes = align16((size_t)g.nterm * g.pl * sizeof(double));
    // Under AGQ the row buffer's columns 2 and 3 are idle whenever the lane
    // partials are in use (a PIRLS step and the final pass hold their rows
    // in columns 0 and 1), so the partials live there when they fit: an
    // AGQ arm's cell then takes 13 KB, not 16, and its 2,000 cells one wave.
    const bool part_in_rows = g.rw == 4 && part_bytes <= 2 * g.rcap * sizeof(double);
    g.off_part = part_in_rows ? 2 * g.rcap * sizeof(double) : g.off_clus + clus_bytes;
    g.cell_bytes = g.off_clus + clus_bytes + (part_in_rows ? 0 : part_bytes);
    const int nv = s.hessian ? 1 + 2 * p + 2 * p * (p - 1) : 0;
    g.small_bytes = align16((size_t)(M_SUMS + g.nterm + nv) * sizeof(double));
    g.staged = g.stage_bytes + g.cell_bytes + g.small_bytes <= CELL_STAGED_MAX;
    bool found = false;
    Geo best{};
    for (int wpc = 4; wpc >= 1; wpc /= 2) {
        const int tpc = WARP * wpc;
        int shapes[MAX_CELLS][3];  // (spb, gc, nchunk): at most MAX_CELLS distinct gc
        int ns = 0;
        if (s.G == 1) {
            for (int spb = 1; spb <= 8; spb *= 2) {
                shapes[ns][0] = spb;
                shapes[ns][1] = shapes[ns][2] = 1;
                ++ns;
            }
        } else {
            int last_gc = 0;
            for (int nchunk = (s.G + MAX_CELLS - 1) / MAX_CELLS; nchunk <= s.G; ++nchunk) {
                const int gc = (s.G + nchunk - 1) / nchunk;
                if (gc == last_gc) continue;
                last_gc = gc;
                shapes[ns][0] = 1;
                shapes[ns][1] = gc;
                shapes[ns][2] = nchunk;
                ++ns;
            }
        }
        for (int k = 0; k < ns; ++k) {
            Geo h = g;
            h.tpc = tpc;
            h.spb = shapes[k][0];
            h.gc = shapes[k][1];
            h.nchunk = shapes[k][2];
            h.cpb = h.spb * h.gc;
            if (h.cpb > MAX_CELLS || h.cpb * tpc > MAX_THREADS) continue;
            if (h.spb > 1 && h.spb > s.sims) continue;
            h.off_cells = h.staged ? (size_t)h.spb * h.stage_bytes : 0;
            h.off_small = h.off_cells + (h.staged ? (size_t)h.cpb * h.cell_bytes : 0);
            h.smem = h.off_small + (size_t)h.cpb * h.small_bytes;
            if (h.smem > SMEM_MAX) continue;
            int nb = 0;
            err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &nb, glmm_intercept_kernel<PB>, h.cpb * tpc, h.smem);
            if (err != 0) return err;
            if (nb <= 0) continue;
            h.blocks = ((long long)s.sims + h.spb - 1) / h.spb * h.nchunk;
            const long long slots = (long long)nb * sms;
            h.waves = (int)((h.blocks + slots - 1) / slots);
            h.cells_per_sm = nb * h.cpb;
            const bool better = !found || h.waves < best.waves ||
                                (h.waves == best.waves && h.tpc > best.tpc) ||
                                (h.waves == best.waves && h.tpc == best.tpc && h.cpb < best.cpb);
            if (better) best = h, found = true;
        }
    }
    if (!found) return (int)cudaErrorInvalidConfiguration;
    cache[s] = best;
    out = best;
    return 0;
}

template <int PB>
int launch(const Args& a, const Shape& s, cudaStream_t stream) {
    Geo g;
    const int err = geometry<PB>(s, g);
    if (err != 0) return err;
    if (!g.staged && a.scratch == nullptr) return (int)cudaErrorInvalidValue;
    if (g.blocks <= 0 || g.blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    glmm_intercept_kernel<PB><<<(unsigned)g.blocks, g.cpb * g.tpc, g.smem, stream>>>(a, g);
    return (int)cudaGetLastError();
}

template <int PB>
int report(const Shape& s, int* out, long long* scratch) {
    Geo g;
    const int err = geometry<PB>(s, g);
    if (err != 0) return err;
    out[0] = g.cells_per_sm;
    out[1] = g.cpb * g.tpc;
    out[2] = (int)g.smem;
    out[3] = g.staged;
    out[4] = g.tpc / WARP;
    out[5] = g.cpb;
    out[6] = g.waves;
    out[7] = (int)g.blocks;
    *scratch = g.staged ? 0 : (long long)s.sims * s.G * (long long)g.cell_bytes;
    return 0;
}

bool shape_ok(int sims, int max_n, int pf, int G, int m, int nagq) {
    return sims > 0 && max_n > 0 && pf > 0 && pf <= MAX_P && G > 0 && m > 0 && nagq >= 1 &&
           nagq <= MAX_AGQ;
}

}  // namespace

// fit: pf column indices of X (host); grid: G row counts in 1..max_n
// (device); rr 1 for round-robin clusters (cluster of row r: r % m), 0 for
// blocks of `period` rows; link 0 logit, 1 probit, 2 Poisson; beta0 (pf,)
// f64 on the device; nagq 1 (Laplace) or the node count, gx / glw / gdw its
// nodes, log weights and f32 search offsets (host, nagq values), k0 the
// centre node; hessian 1 for the FD covariance; scratch: the bytes
// mcp_glmm_intercept_geometry names for this shape (device; null where
// that is 0, the staged path). flags bit 0 converged, bit 1 boundary.
// Returns a cudaError_t.
extern "C" int mcp_glmm_intercept(const void* X, const void* y, int sims, int max_n, int P,
                                  const int* fit, int pf, const void* grid, int G, int rr,
                                  int period, int m, int link, const void* beta0, int nagq,
                                  const double* gx, const double* glw, const float* gdw, int k0,
                                  int hessian, void* scratch, void* beta, void* cov, void* tau2,
                                  void* ybar, void* flags, void* stream) {
    if (!shape_ok(sims, max_n, pf, G, m, nagq) || P <= 0 || period <= 0 || link < 0 ||
        link > LINK_POISSON || k0 < 0 || k0 >= nagq)
        return (int)cudaErrorInvalidValue;
    Args a;
    a.X = (const float*)X;
    a.y = (const float*)y;
    a.sims = sims;
    a.max_n = max_n;
    a.P = P;
    a.G = G;
    a.pf = pf;
    for (int i = 0; i < MAX_P; ++i) a.fit[i] = 0;
    for (int i = 0; i < pf; ++i) {
        if (fit[i] < 0 || fit[i] >= P) return (int)cudaErrorInvalidValue;
        a.fit[i] = fit[i];
    }
    a.grid = (const int*)grid;
    a.rr = rr;
    a.period = period;
    a.m = m;
    a.link = link;
    a.beta0 = (const double*)beta0;
    a.nagq = nagq;
    a.k0 = k0;
    a.hessian = hessian;
    for (int i = 0; i < MAX_AGQ; ++i) {
        a.gx[i] = i < nagq ? gx[i] : 0.0;
        a.glw[i] = i < nagq ? glw[i] : 0.0;
        a.gdw[i] = i < nagq ? gdw[i] : 0.0f;
    }
    a.scratch = (unsigned char*)scratch;
    a.beta = (double*)beta;
    a.cov = (double*)cov;
    a.tau2 = (double*)tau2;
    a.ybar = (double*)ybar;
    a.flags = (uint8_t*)flags;
    const Shape s{sims, max_n, pf, G, m, nagq, hessian ? 1 : 0};
    switch (pf) {
        case 1: return launch<1>(a, s, (cudaStream_t)stream);
        case 2: return launch<2>(a, s, (cudaStream_t)stream);
        case 3: return launch<3>(a, s, (cudaStream_t)stream);
        case 4: return launch<4>(a, s, (cudaStream_t)stream);
        default: break;
    }
    if (pf <= 8) return launch<8>(a, s, (cudaStream_t)stream);
    return launch<16>(a, s, (cudaStream_t)stream);
}

// The geometry mcp_glmm_intercept takes for a shape: out[0] cells resident
// per SM, out[1] threads a block, out[2] dynamic shared memory a block
// (bytes), out[3] 1 staged / 0 streamed, out[4] warps a cell, out[5] cells
// a block, out[6] waves on the card, out[7] blocks; *scratch the bytes of
// device scratch the launch needs (0 when staged). Returns a cudaError_t.
extern "C" int mcp_glmm_intercept_geometry(int sims, int max_n, int pf, int G, int m, int nagq,
                                           int hessian, int* out, long long* scratch) {
    if (!shape_ok(sims, max_n, pf, G, m, nagq)) return (int)cudaErrorInvalidValue;
    const Shape s{sims, max_n, pf, G, m, nagq, hessian ? 1 : 0};
    switch (pf) {
        case 1: return report<1>(s, out, scratch);
        case 2: return report<2>(s, out, scratch);
        case 3: return report<3>(s, out, scratch);
        case 4: return report<4>(s, out, scratch);
        default: break;
    }
    if (pf <= 8) return report<8>(s, out, scratch);
    return report<16>(s, out, scratch);
}

#ifdef MCP_K7_CLOCKS
extern "C" int mcp_k7_clocks(void* dst, int zero) {
    if (zero) {
        void* q = nullptr;
        const int err = (int)cudaGetSymbolAddress(&q, mcp_k7_clk);
        return err ? err : (int)cudaMemset(q, 0, sizeof(mcp_k7_clk));
    }
    return (int)cudaMemcpyFromSymbol(dst, mcp_k7_clk, sizeof(mcp_k7_clk));
}
#endif
