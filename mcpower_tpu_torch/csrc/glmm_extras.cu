// K12 glmm_extras: the whole GLMM fit with extra groupings (crossed or
// nested) of one (sim, grid) cell, the four Nelder-Mead candidates of an
// iteration on the cell's four warps.
//
// Replaces: mcpower_tpu/engine/glmmfit.py::_extras_glmm_grid_stats
// (:155-553) with its structured PIRLS (_pirls_q1_arrs :216-298 over
// mixedfit.py's _cap_factor_q1 :641, _cap_solve_cols_q1 :669 and
// _cap_logdet_q1 :682), its dense PIRLS (pirls :300-361, pirls_loop32
// :372-408, over smallchol.py's blocked chol_vec family :149-305), the f32
// ranking deviance (dev32_at :409-428), the warm-carried shrink-free
// Nelder-Mead (mcpower_tpu/engine/optim.py::nelder_mead_carry :113, called
// at :466-478), the f64 fit and its covariance (:479-485), the FD Hessian
// (:486-517 with _fd_hessian_cov :65), the pins and the flags (:518-537),
// which XLA fuses into one program per design. Per cell, on the rows below
// its grid point, with the joint Z of the groupings (the primary first; M =
// sum of levels x components, grouping g's column = off_g + level q_g + r)
// and Lam = blockdiag(I_m (x) Lg) of theta (each grouping's vech chol, d <=
// 10):
//   1. the d + 1 initial vertices (theta0, theta0 + 0.2 e_i, clipped at
//      `lower`), each from (beta0, v = 0) by 8 f32 PIRLS steps and the f32
//      Laplace deviance (a non-finite one ranks as 1e30); the first
//      minimum's mode is the carry;
//   2. 30 Nelder-Mead iterations for d <= 3, else 45 (12 at 8 PIRLS steps,
//      the rest at 3): the four candidates each from the carried (beta, v),
//      the accepted one's mode the next carry;
//   3. the f64 fit at the optimum, cold from (beta0, 0) by 12 steps, its
//      Laplace deviance and Schur matrix; cov = (X'WX - acc + 1e-10 I)^-1 by
//      the width rule, or under the Hessian 2 H^-1 of central differences of
//      the v-profiled deviance (20 v-only f64 passes a stencil point, always
//      through the dense capacitance, as the reference's);
//   4. converged = finite beta, a factor of positive pivots, the unridged
//      rank probe and a finite deviance; a pin per component where its
//      Cholesky diagonal is below 1e-3; tau^2 = Lam1[0][0]^2; the outcome
//      mean over the rows.
// One PIRLS pass at (theta, beta, v): per row u = Lam v of each grouping's
// level, eta = X beta + sum z u, the link's mu, var, dmu, w = dmu^2 /
// max(var, 1e-10), zw = eta + (y - mu) / dmu; the sums Z'WZ (a level's
// block, and the blocks between groupings), wZ'zw and wZ'X, X'WX and X'Wz;
// the capacitance of Z'WZ (joint_cap.cuh: structured when every grouping is
// intercept-only, dense otherwise) and its solve of [wZ'zw | wZ'X], the p x
// p Schur system (X'WX - acc) + ridge (1e-6 in f32, 1e-10 in f64) by the
// width rule for beta, then v = sol_b - sol_A beta; a step whose beta or v
// is not finite keeps the old state.
//
// Bit identity with the plain version (engine/glmmfit.py::glmm_extras_plain,
// its _JointCells and _extras_pass, with mixedfit.joint_capacitance,
// optim.nelder_mead_carry and smallchol): every operation is the plain
// version's, in its order. The row sums follow one order: an entry owned by
// a level (its rows of Z'WZ, wZ'zw, wZ'X; Z'WZ's entries between groupings g
// < h are owned by g's level) adds that level's rows in ascending row order
// to a zero, from the per-launch row lists the wrapper builds on the host; a
// sum over all rows (X'WX, X'Wz, the deviance, the outcome's) adds each
// primary level's rows in row order, then the primary levels in K7's lanes
// (lane l adds levels l, l + 32, ... in turn, then an xor butterfly with the
// bits of smallchol.lane_sum's pair tree). The factors follow smallchol's
// width rule; the simplex is nelder_mead.cuh's. The transcendentals are
// libdevice's and the file is built with --fmad=false.
//
// What bounds it on the H100: the dependency chain of one cell, (d + 1) 8 +
// 12 x 4 x 8 + (iters - 12) x 4 x 3 f32 passes and their tails in rounds that
// wait on each other, each pass a row walk and a capacitance factor of O(n)
// dependent steps (n = Me structured, M dense). chip_smoke.k12_bound counts
// the operations.
//
// The design (redesigned for Hopper after the first version's cycle counts
// by region, chip_k12_profile.py: the row walks and the capacitance held
// 85-90% of a cell's cycles, each a chain of read-modify-writes through
// device memory):
// - one block of four warps a cell; in the search warp g evaluates
//   candidate g and in the initial simplex vertex 4 r + g; warp 0 runs the
//   f64 fit and the last stage, and the Hessian's stencil points go round
//   the four warps;
// - the cell's rows are staged once, before the search, in the order of
//   the primary grouping's level lists (primary position t): the fit and
//   slope columns of X and y (f32, as read), each extras grouping's level of
//   the row, each extras grouping's list as primary positions, and every
//   level's first and end position below the cell's n. A pass reads rows
//   from there and keeps w, zw and X beta at their primary positions;
// - a pass: first the row quantities (eta, the link, w and zw, and the
//   deviance term or X beta) of every row below n, two rows a lane at a
//   time over all 32 lanes (rows are independent), kept at their primary
//   positions; then lane l takes primary levels l, l + 32, ... and walks each
//   level's rows, four read before they are added: the entries the level
//   owns alone (its block of Z'WZ, its rows of the right-hand sides) and the
//   lane's share of the whole-row sums are summed in registers and stored
//   once; entries scattered by the row's level in another grouping are added
//   in place. Then lane l takes extras levels l, l + 32, ... the same way;
//   then the blocks between groupings are mirrored and the whole-row sums
//   combined; then the capacitance (joint_cap.cuh: an entry of S or C a
//   lane, dependent sums reading four terms ahead). Every entry receives the
//   same additions in the same order as in a walk that adds each into
//   memory;
// - each warp's f32 work area (theta, beta, v, Z'WZ, the right-hand sides,
//   the kept row quantities, X'WX and the capacitance's work area; the p x p
//   matrices at their order p) lives in dynamic shared memory where the
//   four areas fit beside the staged rows and the card holds as many cells
//   an SM that way as with them in device scratch, else in scratch (the
//   launcher's place() picks, mcp_glmm_extras_geometry reports; both forms
//   run the same arithmetic). The f64 fit of warp 0 takes the shared areas'
//   bytes once the search is over; the Hessian's four f64 areas, and a stage that
//   does not fit in shared memory, are in device scratch sized by
//   mcp_glmm_extras_scratch_bytes. The carried v and the fit's v sit with
//   the simplex in static shared memory;
// - thread 0 keeps the simplex in shared memory and runs the sort, the
//   candidates and the selection between rounds;
// - one pass function a type, p bucket (p <= 4 or <= 16: the register sums'
//   sizes), form of the capacitance (structured or dense) and kernel
//   variant (registers held to three cells an SM, or not), not inlined, by a
//   run-time kind (a step, a v-only step, the deviance, the fit's mode).

#include "common.cuh"
#include "glmm_link.cuh"
#include "joint_cap.cuh"
#include "nelder_mead.cuh"

namespace {

using mcp::clamp_lo;
using mcp::dev_term;
using mcp::mu_var_dmu;
using mcp::MU_EPS;
using mcp::jcap::capacitance;
using mcp::jcap::cho_solve_auto;
using mcp::jcap::chol_auto;
using mcp::jcap::lam_of;
using mcp::jcap::Layout;
using mcp::jcap::layout_of;
using mcp::jcap::MAX_D;
using mcp::jcap::MAX_G;
using mcp::jcap::MAX_M;
using mcp::jcap::MAX_P;
using mcp::jcap::vech;
using mcp::jcap::VEC_FROM;
using mcp::jcap::WARP;

constexpr int WARPS = 4;  // a cell's warps: the four candidates
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_QG = 4;  // components of one grouping (d <= 10)
constexpr int MAX_V = 1 + 2 * MAX_P + 2 * MAX_P * (MAX_P - 1);  // Hessian stencil points
constexpr int N_PIRLS = 12;
constexpr int N_PIRLS_SLOPE = 8;
constexpr int N_PIRLS_SLOPE_WARM = 3;
constexpr int NM_FULL = 12;
constexpr int N_V_PIRLS = 20;
constexpr double NM_STEP = 0.2;
constexpr double EPS_RANK = 1e-6;
constexpr double H_STEP = 1e-4;
constexpr double SENTINEL = 1e30;
constexpr double EXTRAS_PIN = 1e-3;
constexpr int MAX_SMEM_BYTES = 227 * 1024;  // a block's shared memory on the H100
constexpr int CHUNK = 4;  // rows a level walk reads before it adds them, in order
// the stage's columns beyond p and its ints a row, at most: the slope
// columns (MAX_G groupings of MAX_QG - 1), y, per extras grouping its level
// and its list, the primary level and the inverse of the primary list
constexpr int STAGE_MAX_EXTRA = MAX_G * (MAX_QG - 1) + 1 + 2 * (MAX_G - 1) + 2;
enum { K_STEP = 0, K_VSTEP = 1, K_TAIL = 2, K_MODE = 3 };
enum { FORM_AUTO = 0, FORM_SHARED = 1, FORM_SCRATCH = 2, FORM_CAP_SHARED = 3 };

struct Args {
    const float* X;
    const float* y;
    int sims, max_n, P, G, p, link, hessian;
    int fit[MAX_P];
    // the plan (joint_cap.cuh's names), the extras' level offsets (lev0) and
    // each grouping's row lists (its level offsets at loff[g] in lvl_off)
    int M, ng, m1, Me, d, nq, structured, nm_iters, mlev;
    int levels[MAX_G], comps[MAX_G], coff[MAX_G + 1], toff[MAX_G], loff[MAX_G], lev0[MAX_G + 1];
    int zc[MAX_G][MAX_QG];  // the X column of component k >= 1 of grouping g
    int zs[MAX_G][MAX_QG];  // its column in the stage
    int rw, yc;             // the stage's floats a row, y's column
    const int* ids;         // (ng, max_n): each row's level per grouping
    const int* lvl_off;     // per grouping its levels' offsets into lvl_rows (m_g + 1)
    const int* lvl_rows;    // (ng, max_n): each grouping's rows by level, ascending
    const int* grid;
    const double* beta0;
    double theta0[MAX_D], lower[MAX_D];
    const double* theta_in;  // (cells, d): fit here, no search; or null
    double* scratch;
    long long cell_doubles;
    int stage_shared, area_shared;  // where the stage and the f32 areas live
    int cap_shared;                 // the areas in scratch but their capacitance parts
    int stage_bytes;                // the stage's bytes, a multiple of 16
    double *beta, *cov, *tau2, *ybar, *theta;
    uint8_t *flags, *pinned;
};

// The cell's shared state: the simplex, the column table, the carry and the
// f64 fit's results.
struct Shared {
    double verts[MAX_D + 1][MAX_D];
    double fvals[MAX_D + 1];
    double cand[WARPS][MAX_D];
    double fc[WARPS];
    double theta[MAX_D];
    double best;  // the initial simplex's least value so far
    int ord[MAX_D + 1];
    int src;  // the warp whose mode becomes the carry, or -1
    int cbase[MAX_M];
    unsigned char cgrp[MAX_M], crr[MAX_M];
    float carry_beta[MAX_P];
    float carry_v[MAX_M];
    double fin_beta[MAX_P];
    double fin_v[MAX_M];
    double axx[MAX_P * MAX_P];
    double lap, ysum;
    double hv[MAX_V];
};

// A warp's area, in elements of T (f32 in the search, f64 after it): Z'WZ
// (structured: diag G_PP (m1), G_PE (m1 x Me), G_EE (Me x Me); dense, and
// for the Hessian: M x M), the right-hand sides (M x (p + 1)), u (then the
// new v), v, theta, beta, the kept row quantities w, zw and X beta (a
// v-only step) or the deviance term (a deviance) (max_n each, by primary
// position), X'WX (p x p), X'Wz, the last stage's four p x p matrices and
// the capacitance's work area.
struct WLay {
    size_t g, raw, u, v, th, bt, wbuf, zwbuf, xbbuf, xwx, xwz, fin, cap, total;
};

__host__ __device__ inline WLay wlay_of(int M, int m1, int Me, int p, int max_n, int structured,
                                        int hessian) {
    WLay w;
    size_t gs = structured ? (size_t)m1 + (size_t)m1 * Me + (size_t)Me * Me : (size_t)M * M;
    if (hessian && (size_t)M * M > gs) gs = (size_t)M * M;
    size_t cs = layout_of(structured, M, m1, Me, p, p).total();
    if (hessian) {  // the stencil's dense passes
        const size_t vs = layout_of(0, M, m1, Me, p, p).total();
        if (vs > cs) cs = vs;
    }
    w.g = 0;
    w.raw = gs;
    w.u = w.raw + (size_t)M * (p + 1);
    w.v = w.u + M;
    w.th = w.v + M;
    w.bt = w.th + MAX_D;
    w.wbuf = w.bt + MAX_P;
    w.zwbuf = w.wbuf + max_n;
    w.xbbuf = w.zwbuf + max_n;
    w.xwx = w.xbbuf + max_n;
    w.xwz = w.xwx + (size_t)p * p;
    w.fin = w.xwz + MAX_P;
    w.cap = w.fin + 4 * (size_t)p * p;
    w.total = w.cap + cs;
    return w;
}

// Ints a stage takes at most for a plan of M columns (the scratch's share
// where it cannot sit in shared memory).
__host__ __device__ inline long long stage_ints_bound(int M, int p, int max_n) {
    return (long long)max_n * (p + STAGE_MAX_EXTRA) + 2LL * M;
}

// Shared memory a block may hold beside its static state.
inline long long dyn_budget() { return (long long)MAX_SMEM_BYTES - (long long)sizeof(Shared); }

// Doubles of scratch a cell takes: the four warps' f64 areas (the f32 areas
// inside them where they are not in shared memory), then the stage where even
// its bound does not fit in shared memory.
__host__ __device__ inline long long cell_doubles_of(const WLay& w, int M, int p, int max_n,
                                                     long long budget) {
    const long long st = stage_ints_bound(M, p, max_n);
    return (long long)WARPS * (long long)w.total + ((st * 4 + 15) / 16 * 16 > budget ? (st + 1) / 2 : 0);
}

// The staged rows of a cell (see the design note), by primary position t.
struct Stage {
    const float* xs;  // (max_n, rw): the fit columns, the slope columns, y
    const int* idp;   // (ng - 1, max_n): extras grouping g's level of the row at t
    const int* epos;  // (ng - 1, max_n): extras grouping g's row list as primary positions
    const int* inv;   // (max_n,): each row's primary position (rows below n: those of the cell)
    const int* lvp;   // (max_n,): the primary level of the row at t
    const int* lo;    // per level (the primary's, then the extras' in order): its first position
    const int* le;    // and its end below n
    int n;            // the cell's rows
};

// Ints of a stage: xs, idp, epos, inv, lvp, lo and le.
__host__ __device__ inline long long stage_ints(const Args& a) {
    const long long levels = (long long)a.levels[0] + a.mlev;
    return (long long)a.max_n * (a.rw + 2 * (a.ng - 1) + 2) + 2 * levels;
}

__device__ inline Stage stage_at(const Args& a, int* base, int n) {
    Stage s;
    const long long mx = a.max_n, levels = (long long)a.levels[0] + a.mlev;
    s.xs = reinterpret_cast<const float*>(base);
    s.idp = base + mx * a.rw;
    s.epos = s.idp + mx * (a.ng - 1);
    s.inv = s.epos + mx * (a.ng - 1);
    s.lvp = s.inv + mx;
    s.lo = s.lvp + mx;
    s.le = s.lo + levels;
    s.n = n;
    return s;
}

// Stage the cell's rows (all threads of the block; ends at a barrier).
__device__ void build_stage(const Args& a, int* base, long long sim, int n) {
    const int t0 = threadIdx.x, nt = blockDim.x;
    const long long mx = a.max_n;
    const int levels = a.levels[0] + a.mlev;
    float* xs = reinterpret_cast<float*>(base);
    int* idp = base + mx * a.rw;
    int* epos = idp + mx * (a.ng - 1);
    int* inv = epos + mx * (a.ng - 1);
    int* lvp = inv + mx;
    int* lo = lvp + mx;
    int* le = lo + levels;
    for (int t = t0; t < a.max_n; t += nt) inv[a.lvl_rows[t]] = t;
    for (int li = t0; li < levels; li += nt) {  // each level's rows below n: a lower bound
        int g = 0, lv = li;
        if (li >= a.levels[0]) {
            g = 1;
            while (g + 1 < a.ng && li - a.levels[0] >= a.lev0[g + 1]) ++g;
            lv = li - a.levels[0] - a.lev0[g];
        }
        const int* rows = a.lvl_rows + (long long)g * mx;
        int b = a.lvl_off[a.loff[g] + lv], e = a.lvl_off[a.loff[g] + lv + 1];
        lo[li] = b;
        while (b < e) {
            const int mid = (b + e) / 2;
            if (rows[mid] < n) b = mid + 1;
            else e = mid;
        }
        le[li] = b;
    }
    __syncthreads();
    const float* Xs = a.X + sim * mx * a.P;
    const float* ys = a.y + sim * mx;
    for (int t = t0; t < a.max_n; t += nt) {
        const int rr = a.lvl_rows[t];
        if (rr >= n) continue;
        const float* row = Xs + (long long)rr * a.P;
        float* dst = xs + (long long)t * a.rw;
        for (int k = 0; k < a.p; ++k) dst[k] = row[a.fit[k]];
        for (int g = 0; g < a.ng; ++g)
            for (int k = 1; k < a.comps[g]; ++k) dst[a.zs[g][k]] = row[a.zc[g][k]];
        dst[a.yc] = ys[rr];
        lvp[t] = a.ids[rr];
        for (int h = 1; h < a.ng; ++h) idp[(h - 1) * mx + t] = a.ids[h * mx + rr];
    }
    for (long long e = t0; e < (a.ng - 1) * mx; e += nt)
        epos[e] = inv[a.lvl_rows[mx + e]];
    __syncthreads();
}

__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
    for (int dist = WARP / 2; dist >= 1; dist >>= 1) v = v + __shfl_xor_sync(FULL, v, dist);
    return v;
}

// Z'WZ and the right-hand sides as joint_cap.cuh reads them.
template <typename T>
struct GSrc {
    const T* G;
    const T* rw;
    int M, m1, Me, r;
    bool structured;
    __device__ T z(int i, int j) const {
        if (!structured) return G[(size_t)i * M + j];
        if (i < m1) return j < m1 ? G[i] : G[m1 + (size_t)i * Me + (j - m1)];
        return G[m1 + (size_t)m1 * Me + (size_t)(i - m1) * Me + (j - m1)];
    }
    __device__ T raw(int row, int c) const { return rw[(size_t)row * r + c]; }
};

// The row quantities of a pass for the link LINK: per row below n (the lanes
// take them two at a time, independent of each other) eta = X beta + sum z
// u, the link's mu, var and dmu, w = dmu^2 / max(var, 1e-10) and zw = eta +
// (y - mu) / dmu, kept at the row's primary position, with X beta for a
// v-only step or the deviance term for a deviance in `aux`.
template <typename T, int PB, bool ST, int LINK>
__device__ __forceinline__ void row_quantities(const Args& a, const Stage& sg, int lane, int kind,
                                               const T* u, const T* bt, T* wb, T* zwb, T* aux) {
    const bool vstep = kind == K_VSTEP, want_dev = kind == K_TAIL || kind == K_MODE;
    const int p = a.p, ng = a.ng, rw = a.rw, yc = a.yc;
    const long long mx = a.max_n;
    for (int k0 = lane; k0 < sg.n; k0 += 2 * WARP) {
        const bool two = k0 + WARP < sg.n;
        int t[2];
        t[0] = sg.inv[k0];
        t[1] = two ? sg.inv[k0 + WARP] : t[0];
        T xb[2], yv[2], zu[2] = {T(0), T(0)};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const float* row = sg.xs + (long long)t[h] * rw;
            T acc = T(0);
#pragma unroll
            for (int k = 0; k < PB; ++k)
                if (k < p) acc = acc + (T)row[k] * bt[k];
            xb[h] = acc;
            yv[h] = (T)row[yc];
        }
        for (int g = 0; g < ng; ++g) {
            const int qg = ST ? 1 : a.comps[g];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int lvg = g == 0 ? sg.lvp[t[h]] : sg.idp[(g - 1) * mx + t[h]];
                const int base = a.coff[g] + lvg * qg;
                for (int k = 0; k < qg; ++k) {
                    T tz = u[base + k];
                    if (k) tz = (T)sg.xs[(long long)t[h] * rw + a.zs[g][k]] * tz;
                    zu[h] = (g == 0 && k == 0) ? tz : zu[h] + tz;
                }
            }
        }
        T wt[2], zw[2], ax[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const T eta = xb[h] + zu[h];
            T mu, var, dmu;
            mu_var_dmu<T>(LINK, eta, mu, var, dmu);
            wt[h] = dmu * dmu / clamp_lo(var, T(MU_EPS));
            zw[h] = eta + (yv[h] - mu) / dmu;
            ax[h] = vstep ? xb[h] : (want_dev ? dev_term<T>(LINK, yv[h], mu) : T(0));
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            if (h == 0 || two) {
                wb[t[h]] = wt[h];
                zwb[t[h]] = zw[h];
                aux[t[h]] = ax[h];
            }
        }
    }
}

// One pass of the warp over its cell's rows (glmmfit._extras_pass) in the
// warp's area `w` (theta, beta and v there), for p <= PB, in the structured
// (ST) or the dense form, compiled apart for each kernel variant (MINB);
// the capacitance's work area at `cw` (null: the area's own). K_STEP and K_VSTEP update beta and v in place (or
// keep them, where the step is not finite); K_TAIL returns the Laplace
// deviance; K_MODE returns it and writes the ridged Schur matrix to axx (p x
// p).
template <typename T, int PB, bool ST, int MINB>
__device__ __noinline__ T extras_pass(const Args& a, const Shared& S, const Stage sg, int lane,
                                      int kind, T* w, T* cw, double* axx) {
    constexpr int NT = PB * (PB + 1) / 2;
    constexpr int QB = ST ? 1 : MAX_QG;  // components of a grouping, at most
    constexpr int QT = QB * (QB + 1) / 2;
    const WLay wl = wlay_of(a.M, a.m1, a.Me, a.p, a.max_n, a.structured, a.hessian);
    const int M = a.M, p = a.p, ng = a.ng, m1 = a.m1, Me = a.Me, rw = a.rw;
    const long long mx = a.max_n;
    const bool step = kind == K_STEP, vstep = kind == K_VSTEP, mode = kind == K_MODE;
    const bool want_a = step || mode, want_dev = kind == K_TAIL || mode;
    const int r = vstep ? 1 : p + 1;
    const int nt = p * (p + 1) / 2;
    T* G = w + wl.g;
    T* Gpe = G + m1;
    T* Gee = G + m1 + (size_t)m1 * Me;
    T* raw = w + wl.raw;
    T* u = w + wl.u;
    T* v = w + wl.v;
    const T* th = w + wl.th;
    T* beta = w + wl.bt;
    T* wb = w + wl.wbuf;
    T* zwb = w + wl.zwbuf;
    T* xbb = w + wl.xbbuf;
    T* xwx = w + wl.xwx;
    T* xwz = w + wl.xwz;
    K12_T0(clk_p);

    // u = Lam v: column (g, level, i) sums v(g, level, k) Lg[i][k] from k = 0
    for (int col = lane; col < M; col += WARP) {
        const int g = S.cgrp[col], i = S.crr[col], base = S.cbase[col];
        T acc = v[base] * lam_of(a, th, g, i, 0);
        for (int k = 1; k <= i; ++k) acc = acc + v[base + k] * lam_of(a, th, g, i, k);
        u[col] = acc;
    }
    __syncwarp();
    T bt[PB];
#pragma unroll
    for (int k = 0; k < PB; ++k) bt[k] = k < p ? beta[k] : T(0);

    // the row quantities of every row below n, over all lanes (rows are
    // independent of each other)
    if (a.link == mcp::LINK_LOGIT)
        row_quantities<T, PB, ST, mcp::LINK_LOGIT>(a, sg, lane, kind, u, bt, wb, zwb, xbb);
    else if (a.link == mcp::LINK_PROBIT)
        row_quantities<T, PB, ST, mcp::LINK_PROBIT>(a, sg, lane, kind, u, bt, wb, zwb, xbb);
    else
        row_quantities<T, PB, ST, mcp::LINK_POISSON>(a, sg, lane, kind, u, bt, wb, zwb, xbb);
    __syncwarp();

    // the primary levels: the levels' entries and this lane's share of the
    // whole-row sums, each level's rows in order, four rows read at a time
    T pxx[NT], pxz[PB], pdev = T(0);
#pragma unroll
    for (int i = 0; i < NT; ++i) pxx[i] = T(0);
#pragma unroll
    for (int i = 0; i < PB; ++i) pxz[i] = T(0);
    const int q0 = ST ? 1 : a.comps[0];
    for (int lv = lane; lv < a.levels[0]; lv += WARP) {
        const int c0 = a.coff[0] + lv * q0;
        if (ST) {
            for (int e = 0; e < Me; ++e) Gpe[(size_t)lv * Me + e] = T(0);
        } else {
            for (int k = 0; k < q0; ++k)
                for (int j = 0; j < M; ++j) G[(size_t)(c0 + k) * M + j] = T(0);
        }
        T gacc[QT], racc[QB], rx[QB][PB], lxx[NT], lxz[PB], ldev = T(0);
#pragma unroll
        for (int i = 0; i < QT; ++i) gacc[i] = T(0);
#pragma unroll
        for (int k = 0; k < QB; ++k) {
            racc[k] = T(0);
#pragma unroll
            for (int c = 0; c < PB; ++c) rx[k][c] = T(0);
        }
#pragma unroll
        for (int i = 0; i < NT; ++i) lxx[i] = T(0);
#pragma unroll
        for (int i = 0; i < PB; ++i) lxz[i] = T(0);
        const int t1 = sg.le[lv];
        for (int tb = sg.lo[lv]; tb < t1; tb += CHUNK) {
            T wq[CHUNK], zq[CHUNK], aq[CHUNK], xq[CHUNK][PB], z0q[CHUNK][QB];
#pragma unroll
            for (int h = 0; h < CHUNK; ++h) {
                const int t = min(tb + h, t1 - 1);
                const float* row = sg.xs + (long long)t * rw;
                wq[h] = wb[t];
                zq[h] = zwb[t];
                aq[h] = xbb[t];
#pragma unroll
                for (int k = 0; k < PB; ++k) xq[h][k] = k < p ? (T)row[k] : T(0);
                z0q[h][0] = T(1);
#pragma unroll
                for (int k = 1; k < QB; ++k) z0q[h][k] = k < q0 ? (T)row[a.zs[0][k]] : T(0);
            }
#pragma unroll
            for (int h = 0; h < CHUNK; ++h) {
                if (tb + h >= t1) break;
                const int t = tb + h;
                const T wt = wq[h], zw = zq[h];
                T wz[QB];
                wz[0] = wt;
#pragma unroll
                for (int k = 1; k < QB; ++k) wz[k] = z0q[h][k] * wt;
                if (ST) {
                    gacc[0] = gacc[0] + wt;
                    for (int g = 1; g < ng; ++g) {
                        const size_t e = (size_t)lv * Me + (a.coff[g] - m1) + sg.idp[(g - 1) * mx + t];
                        Gpe[e] = Gpe[e] + wt;
                    }
                } else {
#pragma unroll
                    for (int k = 0; k < QB; ++k)
#pragma unroll
                        for (int l = 0; l <= k; ++l)
                            if (k < q0)
                                gacc[tri(k, l)] = gacc[tri(k, l)] + (l == 0 ? wz[k] : wz[k] * z0q[h][l]);
                    for (int g = 1; g < ng; ++g) {
                        const int bh = a.coff[g] + sg.idp[(g - 1) * mx + t] * a.comps[g];
                        for (int l = 0; l < a.comps[g]; ++l) {
                            const T zl = l == 0 ? T(1) : (T)sg.xs[(long long)t * rw + a.zs[g][l]];
#pragma unroll
                            for (int k = 0; k < QB; ++k) {
                                if (k < q0) {
                                    const size_t e = (size_t)(c0 + k) * M + bh + l;
                                    G[e] = G[e] + (l == 0 ? wz[k] : wz[k] * zl);
                                }
                            }
                        }
                    }
                }
                if (step || vstep) {
                    const T rz = step ? zw : zw - aq[h];
#pragma unroll
                    for (int k = 0; k < QB; ++k)
                        if (k < q0) racc[k] = racc[k] + wz[k] * rz;
                }
                if (want_a) {
#pragma unroll
                    for (int k = 0; k < QB; ++k)
#pragma unroll
                        for (int c = 0; c < PB; ++c)
                            if (k < q0 && c < p) rx[k][c] = rx[k][c] + wz[k] * xq[h][c];
#pragma unroll
                    for (int i = 0; i < PB; ++i) {
                        if (i < p) {
                            const T xw = xq[h][i] * wt;
#pragma unroll
                            for (int j = 0; j <= i; ++j)
                                lxx[tri(i, j)] = lxx[tri(i, j)] + xw * xq[h][j];
                        }
                    }
                }
                if (step) {
                    const T wzw = wt * zw;
#pragma unroll
                    for (int k = 0; k < PB; ++k)
                        if (k < p) lxz[k] = lxz[k] + xq[h][k] * wzw;
                }
                if (want_dev) ldev = ldev + aq[h];
            }
        }
        // the entries the level owns, stored once (the dense block mirrored)
        if (ST) {
            G[lv] = gacc[0];
        } else {
#pragma unroll
            for (int k = 0; k < QB; ++k)
#pragma unroll
                for (int l = 0; l <= k; ++l)
                    if (k < q0) {
                        G[(size_t)(c0 + k) * M + c0 + l] = gacc[tri(k, l)];
                        if (l < k) G[(size_t)(c0 + l) * M + c0 + k] = gacc[tri(k, l)];
                    }
        }
#pragma unroll
        for (int k = 0; k < QB; ++k) {
            if (k < q0) {
                raw[(size_t)(c0 + k) * r] = racc[k];
#pragma unroll
                for (int c = 0; c < PB; ++c)
                    if (c + 1 < r) raw[(size_t)(c0 + k) * r + 1 + c] = rx[k][c];
            }
        }
        if (want_a) {
#pragma unroll
            for (int i = 0; i < NT; ++i)
                if (i < nt) pxx[i] = pxx[i] + lxx[i];
        }
        if (step) {
#pragma unroll
            for (int i = 0; i < PB; ++i)
                if (i < p) pxz[i] = pxz[i] + lxz[i];
        }
        if (want_dev) pdev = pdev + ldev;
    }
    __syncwarp();
    K12_ADD32(1, clk_p);
    K12_T0(clk_e);

    // the extras levels, from the kept row quantities, four rows read at a time
    for (int e = lane; e < a.mlev; e += WARP) {
        int g = 1;
        while (g + 1 < ng && e >= a.lev0[g + 1]) ++g;
        const int lv = e - a.lev0[g], qg = ST ? 1 : a.comps[g], cg = a.coff[g] + lv * qg;
        if (ST) {
            for (int j = a.coff[g] - m1; j < Me; ++j) Gee[(size_t)(cg - m1) * Me + j] = T(0);
        } else {
            for (int k = 0; k < qg; ++k)
                for (int j = a.coff[g]; j < M; ++j) G[(size_t)(cg + k) * M + j] = T(0);
        }
        T gacc[QT], racc[QB], rx[QB][PB];
#pragma unroll
        for (int i = 0; i < QT; ++i) gacc[i] = T(0);
#pragma unroll
        for (int k = 0; k < QB; ++k) {
            racc[k] = T(0);
#pragma unroll
            for (int c = 0; c < PB; ++c) rx[k][c] = T(0);
        }
        const int* ep = sg.epos + (g - 1) * mx;
        const int li = a.levels[0] + e;
        const int t1 = sg.le[li];
        for (int tb = sg.lo[li]; tb < t1; tb += CHUNK) {
            int tq[CHUNK];
            T wq[CHUNK], zq[CHUNK], aq[CHUNK], xq[CHUNK][PB], zgq[CHUNK][QB];
#pragma unroll
            for (int h = 0; h < CHUNK; ++h) tq[h] = ep[min(tb + h, t1 - 1)];
#pragma unroll
            for (int h = 0; h < CHUNK; ++h) {
                const float* row = sg.xs + (long long)tq[h] * rw;
                wq[h] = wb[tq[h]];
                zq[h] = zwb[tq[h]];
                aq[h] = xbb[tq[h]];
#pragma unroll
                for (int k = 0; k < PB; ++k) xq[h][k] = k < p ? (T)row[k] : T(0);
                zgq[h][0] = T(1);
#pragma unroll
                for (int k = 1; k < QB; ++k) zgq[h][k] = k < qg ? (T)row[a.zs[g][k]] : T(0);
            }
#pragma unroll
            for (int h = 0; h < CHUNK; ++h) {
                if (tb + h >= t1) break;
                const int t = tq[h];
                const T wt = wq[h], zw = zq[h];
                T wz[QB];
                wz[0] = wt;
#pragma unroll
                for (int k = 1; k < QB; ++k) wz[k] = zgq[h][k] * wt;
                if (ST) {
                    gacc[0] = gacc[0] + wt;
                    for (int hh = g + 1; hh < ng; ++hh) {
                        const size_t eh = (size_t)(cg - m1) * Me + (a.coff[hh] - m1) +
                                          sg.idp[(hh - 1) * mx + t];
                        Gee[eh] = Gee[eh] + wt;
                    }
                } else {
#pragma unroll
                    for (int k = 0; k < QB; ++k)
#pragma unroll
                        for (int l = 0; l <= k; ++l)
                            if (k < qg)
                                gacc[tri(k, l)] = gacc[tri(k, l)] + (l == 0 ? wz[k] : wz[k] * zgq[h][l]);
                    for (int hh = g + 1; hh < ng; ++hh) {
                        const int bh = a.coff[hh] + sg.idp[(hh - 1) * mx + t] * a.comps[hh];
                        for (int l = 0; l < a.comps[hh]; ++l) {
                            const T zl = l == 0 ? T(1) : (T)sg.xs[(long long)t * rw + a.zs[hh][l]];
#pragma unroll
                            for (int k = 0; k < QB; ++k) {
                                if (k < qg) {
                                    const size_t el = (size_t)(cg + k) * M + bh + l;
                                    G[el] = G[el] + (l == 0 ? wz[k] : wz[k] * zl);
                                }
                            }
                        }
                    }
                }
                if (step || vstep) {
                    const T rz = step ? zw : zw - aq[h];
#pragma unroll
                    for (int k = 0; k < QB; ++k)
                        if (k < qg) racc[k] = racc[k] + wz[k] * rz;
                }
                if (want_a) {
#pragma unroll
                    for (int k = 0; k < QB; ++k)
#pragma unroll
                        for (int c = 0; c < PB; ++c)
                            if (k < qg && c < p) rx[k][c] = rx[k][c] + wz[k] * xq[h][c];
                }
            }
        }
        if (ST) {
            Gee[(size_t)(cg - m1) * Me + cg - m1] = gacc[0];
        } else {
#pragma unroll
            for (int k = 0; k < QB; ++k)
#pragma unroll
                for (int l = 0; l <= k; ++l)
                    if (k < qg) {
                        G[(size_t)(cg + k) * M + cg + l] = gacc[tri(k, l)];
                        if (l < k) G[(size_t)(cg + l) * M + cg + k] = gacc[tri(k, l)];
                    }
        }
#pragma unroll
        for (int k = 0; k < QB; ++k) {
            if (k < qg) {
                raw[(size_t)(cg + k) * r] = racc[k];
#pragma unroll
                for (int c = 0; c < PB; ++c)
                    if (c + 1 < r) raw[(size_t)(cg + k) * r + 1 + c] = rx[k][c];
            }
        }
    }
    __syncwarp();
    K12_ADD32(2, clk_e);
    K12_T0(clk_m);

    // the blocks between groupings, mirrored: a row a lane, its columns in
    // earlier groupings
    if (ST) {
        for (int e = lane; e < Me; e += WARP) {
            const int lim = a.coff[S.cgrp[m1 + e]] - m1;
            for (int j = 0; j < lim; ++j) Gee[(size_t)e * Me + j] = Gee[(size_t)j * Me + e];
        }
    } else {
        for (int row = lane; row < M; row += WARP) {
            const int lim = a.coff[S.cgrp[row]];
            for (int j = 0; j < lim; ++j) G[(size_t)row * M + j] = G[(size_t)j * M + row];
        }
    }
    // the whole-row sums over the lanes
#pragma unroll
    for (int i = 0; i < PB; ++i) {
        if (i < p) {
#pragma unroll
            for (int j = 0; j <= i; ++j) {
                const T s = want_a ? warp_sum(pxx[tri(i, j)]) : T(0);
                if (lane == 0) xwx[i * p + j] = xwx[j * p + i] = s;
            }
            const T s = step ? warp_sum(pxz[i]) : T(0);
            if (lane == 0) xwz[i] = s;
        }
    }
    const T dev = want_dev ? warp_sum(pdev) : T(0);
    __syncwarp();
    K12_ADD32(3, clk_m);

    // the capacitance of Z'WZ and its solve of the right-hand sides
    const Layout lay = layout_of(ST ? 1 : 0, M, m1, Me, vstep ? 0 : p, p);
    if (cw == nullptr) cw = w + wl.cap;
    const GSrc<T> src{G, raw, M, m1, Me, r, ST};
    const T logdet = capacitance(a, S, th, src, cw, lay, ST, kind != K_TAIL, lane);
    K12_T0(clk_s);
    if (want_dev) {
        const T vv = mcp::jcap::fold_add(v[0] * v[0], M - 1, [&](int i) { return v[1 + i] * v[1 + i]; });
        const T lap = (T(2) * dev + vv) + logdet;
        if (mode) {  // the f64 fit's Schur matrix
            const T* acc = cw + lay.acc();
            if (lane == 0) {
                for (int i = 0; i < p; ++i)
                    for (int j = 0; j < p; ++j) {
                        const T s = xwx[i * p + j] - acc[(1 + i) * r + 1 + j];
                        axx[i * p + j] = (double)(i == j ? s + T(1e-10) : s);
                    }
            }
            __syncwarp();
        }
        K12_ADD32(6, clk_s);
        return lap;
    }
    if (vstep) {  // v = C^-1 Lam' r
        const T* sol = cw + lay.rhs();
        bool fin = true;
        for (int row = lane; row < M; row += WARP) fin = fin && isfinite(sol[row]);
        const bool ok = __all_sync(FULL, fin);
        __syncwarp();
        if (ok)
            for (int row = lane; row < M; row += WARP) v[row] = sol[row];
        __syncwarp();
        K12_ADD32(6, clk_s);
        return T(0);
    }
    // the Schur system, beta and v
    const T* acc = cw + lay.acc();
    T* P = cw + lay.pmat();
    T* vec = cw + lay.vecs();
    const T ridge = T(sizeof(T) == 4 ? 1e-6 : 1e-10);
    for (int e = lane; e < p * p; e += WARP) {
        const int i = e / p, j = e % p;
        const T s = xwx[e] - acc[(1 + i) * r + 1 + j];
        P[e] = i == j ? s + ridge : s;
    }
    for (int i = lane; i < p; i += WARP) vec[MAX_P + i] = xwz[i] - acc[(1 + i) * r];
    __syncwarp();
    const bool pb = p >= VEC_FROM;
    chol_auto(P, p, pb, lane);
    cho_solve_auto(P, vec + MAX_P, p, 1, pb, lane);
    const T* bn = vec + MAX_P;
    bool ok = true;
    for (int i = 0; i < p; ++i) ok = ok && isfinite(bn[i]);
    const T* solk = cw + lay.kept();
    const T* solr = cw + lay.rhs();
    bool fin = true;
    for (int row = lane; row < M; row += WARP) {
        const T* s = !ST ? solr + (size_t)row * r
                         : (row < m1 ? solk + (size_t)row * r : solr + (size_t)(row - m1) * r);
        T acc2 = s[1] * bn[0];
        for (int c = 1; c < p; ++c) acc2 = acc2 + s[1 + c] * bn[c];
        const T vn = s[0] - acc2;
        u[row] = vn;
        fin = fin && isfinite(vn);
    }
    ok = __all_sync(FULL, fin) && ok;
    __syncwarp();
    if (ok) {
        for (int row = lane; row < M; row += WARP) v[row] = u[row];
        if (lane == 0)
            for (int i = 0; i < p; ++i) beta[i] = bn[i];
    }
    __syncwarp();
    K12_ADD32(6, clk_s);
    return T(0);
}

// `steps` passes of step_kind, then one of last_kind; its result.
template <typename T, int PB, int MINB>
__device__ __forceinline__ T chain(const Args& a, const Shared& S, const Stage sg, int lane,
                                   int steps, int step_kind, int last_kind, bool structured, T* w,
                                   T* cw, double* axx) {
    T out = T(0);
    for (int s = 0; s <= steps; ++s) {
        const int kind = s < steps ? step_kind : last_kind;
        out = structured ? extras_pass<T, PB, true, MINB>(a, S, sg, lane, kind, w, cw, axx)
                         : extras_pass<T, PB, false, MINB>(a, S, sg, lane, kind, w, cw, axx);
    }
    return out;
}

// The offset of Hessian stencil point e in coordinate i (hessian_offsets).
__device__ __forceinline__ double stencil(int e, int i, int p) {
    if (e == 0) return 0.0;
    if (e <= 2 * p) {
        const int k = (e - 1) / 2;
        return (k != i) ? 0.0 : ((e - 1) % 2 == 0 ? H_STEP : -H_STEP);
    }
    int k = (e - 1 - 2 * p) / 4, which = (e - 1 - 2 * p) % 4;
    int ii = 0, jj = 1;
    for (int t = 0; t < k; ++t) {
        if (++jj == p) {
            ++ii;
            jj = ii + 1;
        }
    }
    const double si = (which < 2) ? 1.0 : -1.0, sj = (which % 2 == 0) ? 1.0 : -1.0;
    return (i == ii) ? si * H_STEP : ((i == jj) ? sj * H_STEP : 0.0);
}

// A warp's start: theta (as T), beta and v.
template <typename T>
__device__ __forceinline__ void load_state(const WLay& wl, T* w, const double* th, int d,
                                           const T* beta_src, const double* beta_d, int p,
                                           const T* v_src, int M, int lane) {
    for (int k = lane; k < d; k += WARP) w[wl.th + k] = (T)th[k];
    for (int k = lane; k < p; k += WARP) w[wl.bt + k] = beta_src ? beta_src[k] : (T)beta_d[k];
    for (int i = lane; i < M; i += WARP) w[wl.v + i] = v_src ? v_src[i] : T(0);
    __syncwarp();
}

// The kernel's variants: PB the p bucket (4 or 16) and MINB the cells an SM
// its registers are held to: 3 (168 registers a thread; the f32 passes fit,
// the f64 ones of the fit's end spill) for launches whose work areas fit
// three cells an SM in shared memory, else 1 (as many as the passes take).
template <int PB, int MINB>
__global__ void __launch_bounds__(WARP * WARPS, MINB)
    glmm_extras_kernel(const __grid_constant__ Args a) {
    extern __shared__ __align__(16) unsigned char k12_dyn[];
    __shared__ Shared S;
    const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP, t = threadIdx.x;
    K12_T0(clk_all);
    const long long cell = blockIdx.x;
    const long long sim = cell / a.G;
    const int n = a.grid[cell % a.G];
    const int M = a.M, p = a.p, D = a.d;
    const bool st = a.structured != 0;
    const WLay wl = wlay_of(M, a.m1, a.Me, p, a.max_n, a.structured, a.hessian);
    double* base = a.scratch + cell * a.cell_doubles;  // the four f64 areas, then a stage
    int* stage = a.stage_shared ? reinterpret_cast<int*>(k12_dyn)
                                : reinterpret_cast<int*>(base + (long long)WARPS * wl.total);
    float* areas = reinterpret_cast<float*>(k12_dyn + (a.stage_shared ? a.stage_bytes : 0));
    // warp g's f32 area; warp 0's f64 fit area; warp g's Hessian area
    auto area32 = [&](int g) -> float* {
        return a.area_shared ? areas + (long long)g * wl.total
                             : reinterpret_cast<float*>(base + (long long)g * wl.total);
    };
    float* w32 = area32(warp);
    // the capacitance's f32 work area, where it is in shared memory apart
    float* cap32 = a.cap_shared ? areas + (long long)warp * (wl.total - wl.cap) : nullptr;
    double* wfit = a.area_shared ? reinterpret_cast<double*>(areas) : base;
    double* whes = base + (long long)warp * wl.total;

    build_stage(a, stage, sim, n);
    const Stage sg = stage_at(a, stage, n);
    for (int col = t; col < M; col += WARP * WARPS) {  // the column table
        int g = 0;
        while (g + 1 < a.ng && col >= a.coff[g + 1]) ++g;
        const int q = a.comps[g];
        S.cgrp[col] = (unsigned char)g;
        S.crr[col] = (unsigned char)((col - a.coff[g]) % q);
        S.cbase[col] = a.coff[g] + ((col - a.coff[g]) / q) * q;
    }
    if (t == 0) {
        for (int i = 0; i <= D; ++i) {
            for (int k = 0; k < D; ++k) {
                const double x = a.theta0[k] + ((i > 0 && k == i - 1) ? NM_STEP : 0.0);
                S.verts[i][k] = (x < a.lower[k]) ? a.lower[k] : x;
            }
            S.ord[i] = i;
        }
        S.best = INFINITY;
    }
    __syncthreads();

    if (a.theta_in) {  // fit at a given theta
        if (t < D) S.theta[t] = a.theta_in[cell * D + t];
        __syncthreads();
    } else {
        // the initial simplex, four vertices a round, each from (beta0, 0)
        const int init_rounds = (D + 1 + WARPS - 1) / WARPS;
        for (int round = 0; round < init_rounds; ++round) {
            const int vtx = round * WARPS + warp;
            if (vtx <= D) {
                load_state<float>(wl, w32, S.verts[vtx], D, nullptr, a.beta0, p, nullptr, M, lane);
                const float lap = chain<float, PB, MINB>(a, S, sg, lane, N_PIRLS_SLOPE, K_STEP, K_TAIL,
                                                   st, w32, cap32, nullptr);
                if (lane == 0) S.fc[warp] = isfinite(lap) ? (double)lap : SENTINEL;
            }
            K12_T0(clk_b0);
            __syncthreads();
            K12_ADD(8, clk_b0);
            if (t == 0) {  // the first minimum's mode seeds the carry
                S.src = -1;
                for (int g = 0; g < WARPS; ++g) {
                    const int vv = round * WARPS + g;
                    if (vv <= D) {
                        S.fvals[vv] = S.fc[g];
                        if (S.fc[g] < S.best) {
                            S.best = S.fc[g];
                            S.src = g;
                        }
                    }
                }
            }
            __syncthreads();
            if (S.src >= 0) {
                const float* sw = area32(S.src);
                for (int i = t; i < M; i += WARP * WARPS) S.carry_v[i] = sw[wl.v + i];
                if (t < p) S.carry_beta[t] = sw[wl.bt + t];
            }
            __syncthreads();
        }
        // the search: four candidates from the carry, the accepted one's mode carried
        for (int it = 0; it < a.nm_iters; ++it) {
            const int budget = it < NM_FULL ? N_PIRLS_SLOPE : N_PIRLS_SLOPE_WARM;
            K12_T0(clk_n0);
            if (t == 0) mcp::nm_candidates(a.lower, S, D);
            K12_ADD(7, clk_n0);
            K12_T0(clk_b1);
            __syncthreads();
            K12_ADD(8, clk_b1);
            load_state<float>(wl, w32, S.cand[warp], D, S.carry_beta, nullptr, p, S.carry_v, M,
                              lane);
            const float lap = chain<float, PB, MINB>(a, S, sg, lane, budget, K_STEP, K_TAIL, st, w32,
                                                     cap32, nullptr);
            if (lane == 0) S.fc[warp] = isfinite(lap) ? (double)lap : SENTINEL;
            K12_T0(clk_b2);
            __syncthreads();
            K12_ADD(8, clk_b2);
            K12_T0(clk_n1);
            if (t == 0) S.src = mcp::nm_select_and_replace(S, D);
            K12_ADD(7, clk_n1);
            K12_T0(clk_b3);
            __syncthreads();
            K12_ADD(8, clk_b3);
            {
                const float* sw = area32(S.src);
                for (int i = t; i < M; i += WARP * WARPS) S.carry_v[i] = sw[wl.v + i];
                if (t < p) S.carry_beta[t] = sw[wl.bt + t];
            }
            __syncthreads();
        }
        if (t == 0) {  // the first position holding the least value
            int best = S.ord[0];
            for (int i = 1; i <= D; ++i)
                if (S.fvals[S.ord[i]] < S.fvals[best]) best = S.ord[i];
            for (int k = 0; k < D; ++k) S.theta[k] = S.verts[best][k];
        }
        __syncthreads();
    }

    // the cold f64 fit at the optimum (warp 0); the outcome's row sum
    K12_T0(clk_d);
    if (warp == 0) {
        load_state<double>(wl, wfit, S.theta, D, nullptr, a.beta0, p, nullptr, M, lane);
        const double lap = chain<double, PB, MINB>(a, S, sg, lane, N_PIRLS, K_STEP, K_MODE, st, wfit, nullptr,
                                             S.axx);
        for (int i = lane; i < M; i += WARP) S.fin_v[i] = wfit[wl.v + i];
        double ysum = 0.0;
        for (int lv = lane; lv < a.levels[0]; lv += WARP) {
            double acc = 0.0;
            const int t1 = sg.le[lv];
            for (int tt = sg.lo[lv]; tt < t1; ++tt)
                acc = acc + (double)sg.xs[(long long)tt * a.rw + a.yc];
            ysum = ysum + acc;
        }
        ysum = warp_sum(ysum);
        if (lane == 0) {
            S.lap = lap;
            S.ysum = ysum;
            for (int k = 0; k < p; ++k) S.fin_beta[k] = wfit[wl.bt + k];
        }
    }
    K12_ADD(9, clk_d);
    __syncthreads();

    // the Hessian's stencil: v-only passes through the dense capacitance
    const int nv = a.hessian ? 1 + 2 * p + 2 * p * (p - 1) : 0;
    K12_T0(clk_h);
    for (int e = warp; e < nv; e += WARPS) {
        __syncwarp();
        for (int k = lane; k < D; k += WARP) whes[wl.th + k] = S.theta[k];
        for (int k = lane; k < p; k += WARP) whes[wl.bt + k] = S.fin_beta[k] + stencil(e, k, p);
        for (int i = lane; i < M; i += WARP) whes[wl.v + i] = S.fin_v[i];
        __syncwarp();
        const double hv = chain<double, PB, MINB>(a, S, sg, lane, N_V_PIRLS, K_VSTEP, K_TAIL, false,
                                            whes, nullptr, nullptr);
        if (lane == 0) S.hv[e] = hv;
    }
    K12_ADD(10, clk_h);
    __syncthreads();
    K12_ADD(0, clk_all);
    if (warp != 0) return;

    // the last stage on warp 0: the factor, the rank probe, the covariance
    double* L = wfit + wl.fin;
    double* R = L + p * p;
    double* INV = R + p * p;
    double* H = INV + p * p;
    for (int e = lane; e < p * p; e += WARP) {
        const int i = e / p, j = e % p;
        L[e] = S.axx[e];
        R[e] = i == j ? S.axx[e] - 1e-10 : S.axx[e];
        INV[e] = i == j ? 1.0 : 0.0;
    }
    __syncwarp();
    const bool pb = p >= VEC_FROM;
    chol_auto(L, p, pb, lane);
    chol_auto(R, p, pb, lane);
    cho_solve_auto(L, INV, p, p, pb, lane);
    double* cov = a.cov + cell * p * p;
    for (int e = lane; e < p * p; e += WARP) cov[e] = INV[e];
    __syncwarp();
    if (a.hessian) {  // glmmfit._stencil_cov: 2 H^-1 by the scalar factor
        if (lane == 0) {
            const double f0 = S.hv[0];
            for (int i = 0; i < p; ++i)
                H[i * p + i] = ((S.hv[1 + 2 * i] - 2.0 * f0) + S.hv[2 + 2 * i]) / (H_STEP * H_STEP);
            int k = 0;
            const int b = 1 + 2 * p;
            for (int i = 0; i < p; ++i) {
                for (int j = i + 1; j < p; ++j) {
                    const double* hv = S.hv + b + 4 * k;
                    const double hij =
                        (((hv[0] - hv[1]) - hv[2]) + hv[3]) / (4.0 * H_STEP * H_STEP) + 0.0;
                    H[i * p + j] = hij;
                    H[j * p + i] = hij;
                    ++k;
                }
            }
            for (int i = 0; i < p; ++i) H[i * p + i] = H[i * p + i] + 1e-10;
        }
        for (int e = lane; e < p * p; e += WARP) INV[e] = (e / p == e % p) ? 1.0 : 0.0;
        __syncwarp();
        chol_auto(H, p, false, lane);
        cho_solve_auto(H, INV, p, p, false, lane);
        bool fin = true;
        for (int e = lane; e < p * p; e += WARP) fin = fin && isfinite(2.0 * INV[e]);
        const bool ok = __all_sync(FULL, fin);
        if (ok)
            for (int e = lane; e < p * p; e += WARP) cov[e] = 2.0 * INV[e];
        __syncwarp();
    }
    if (lane != 0) return;
    bool chol_ok = true, rank_ok = true, beta_ok = true;
    double lo = R[0], hi = R[0];
    for (int i = 0; i < p; ++i) {
        const double dl = L[i * p + i], dr = R[i * p + i];
        chol_ok = chol_ok && isfinite(dl) && (dl > 0.0);
        rank_ok = rank_ok && isfinite(dr) && (dr > 0.0);
        lo = fmin(lo, dr);
        hi = fmax(hi, dr);
        beta_ok = beta_ok && isfinite(S.fin_beta[i]);
    }
    rank_ok = rank_ok && (lo >= EPS_RANK * hi);
    const bool converged = beta_ok && chol_ok && rank_ok && isfinite(S.lap);
    bool any_pin = false;
    int k = 0;
    for (int g = 0; g < a.ng; ++g) {
        const int q = a.comps[g];
        for (int j = 0; j < q; ++j) {
            const bool pin = S.theta[a.toff[g] + vech(j, j, q)] < EXTRAS_PIN;
            a.pinned[cell * a.nq + k++] = (uint8_t)pin;
            any_pin = any_pin || pin;
        }
    }
    a.flags[cell] = (uint8_t)((converged ? 1 : 0) | (any_pin ? 2 : 0));
    a.tau2[cell] = S.theta[0] * S.theta[0];
    a.ybar[cell] = S.ysum / (double)n;
    for (int i = 0; i < p; ++i) a.beta[cell * p + i] = S.fin_beta[i];
    for (int i = 0; i < D; ++i) a.theta[cell * D + i] = S.theta[i];
}

// The launch's forced form (FORM_AUTO unless mcp_glmm_extras_set_form says
// otherwise: a measurement knob).
int g_form = FORM_AUTO;

// The plan of a launch from the C arguments (pointers may be null for a
// geometry query); a cudaError_t.
int make_args(Args& a, const void* X, const void* y, int sims, int max_n, int P, const int* fit,
              int pf, int ng, const int* levels, const int* comps, const int* zcols, int G, int link,
              int hessian, int force_dense) {
    if (sims <= 0 || G <= 0 || pf < 1 || pf > MAX_P || max_n <= 0 || P <= 0 || link < 0 ||
        link > 2 || ng < 2 || ng > MAX_G)
        return (int)cudaErrorInvalidValue;
    a.X = (const float*)X;
    a.y = (const float*)y;
    a.sims = sims;
    a.max_n = max_n;
    a.P = P;
    a.G = G;
    a.p = pf;
    a.link = link;
    a.hessian = hessian;
    for (int k = 0; k < MAX_P; ++k) a.fit[k] = k < pf ? fit[k] : 0;
    int col = 0, d = 0, nq = 0, zoff = 0, loff = 0, lev = 0, scol = pf;
    bool all_q1 = true;
    for (int g = 0; g < ng; ++g) {
        if (levels[g] <= 0 || comps[g] <= 0 || comps[g] > MAX_QG) return (int)cudaErrorInvalidValue;
        a.levels[g] = levels[g];
        a.comps[g] = comps[g];
        a.coff[g] = col;
        a.toff[g] = d;
        a.loff[g] = loff;
        a.lev0[g] = lev;
        for (int k = 0; k < MAX_QG; ++k) {
            const bool slope = k >= 1 && k < comps[g];
            a.zc[g][k] = slope ? zcols[zoff + k - 1] : 0;
            a.zs[g][k] = slope ? scol++ : 0;
        }
        zoff += comps[g] - 1;
        col += levels[g] * comps[g];
        d += comps[g] * (comps[g] + 1) / 2;
        nq += comps[g];
        loff += levels[g] + 1;
        if (g >= 1) lev += levels[g];
        all_q1 = all_q1 && comps[g] == 1;
    }
    a.coff[ng] = col;
    a.lev0[ng] = lev;
    a.lev0[0] = 0;
    if (col > MAX_M || d > MAX_D) return (int)cudaErrorInvalidValue;
    a.M = col;
    a.ng = ng;
    a.m1 = levels[0] * comps[0];
    a.Me = col - a.m1;
    a.d = d;
    a.nq = nq;
    a.mlev = lev;
    a.structured = (all_q1 && !force_dense) ? 1 : 0;
    a.nm_iters = d <= 3 ? 30 : 45;
    a.yc = scol;
    a.rw = scol + 1;
    // the stage in shared memory where it fits (place() decides the areas)
    const long long budget = dyn_budget();
    const WLay wl = wlay_of(a.M, a.m1, a.Me, pf, max_n, a.structured, hessian);
    const long long stage = (stage_ints(a) * 4 + 15) / 16 * 16;
    a.stage_shared = stage <= budget ? 1 : 0;
    a.stage_bytes = a.stage_shared ? (int)stage : 0;
    a.area_shared = 0;
    a.cap_shared = 0;
    a.cell_doubles = cell_doubles_of(wl, a.M, pf, max_n, budget);
    return 0;
}

inline size_t dyn_bytes(const Args& a) {
    const WLay wl = wlay_of(a.M, a.m1, a.Me, a.p, a.max_n, a.structured, a.hessian);
    const size_t per_warp = a.area_shared ? wl.total : (a.cap_shared ? wl.total - wl.cap : 0);
    return (size_t)a.stage_bytes + (size_t)WARPS * per_warp * sizeof(float);
}

// Resident cells an SM of the form `a` describes; leaves the kernel's
// shared-memory attribute set for it.
template <int PB, int MINB>
int occupancy(const Args& a, int* per_sm) {
    const size_t smem = dyn_bytes(a);
    auto kernel = glmm_extras_kernel<PB, MINB>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, WARP * WARPS, smem);
}

// Where the four f32 areas live and which variant runs. The areas in shared
// memory with the 168-register variant where that holds three cells an SM
// (p <= 4); else the unbounded variant, in the form that holds the most cells
// an SM, the earlier on a tie: the areas in shared memory, their
// capacitance parts alone in shared memory (the factor's and the solves'
// chains of loads after stores stay on chip), all in device scratch. The
// latency of a cell's chains falls with each step; the cells in flight must
// not. g_form forces a form. Sets a.area_shared, a.cap_shared, *minb (the
// variant) and the attribute; per_sm the resident cells an SM.
template <int PB>
int place(Args& a, int* minb, int* per_sm) {
    const WLay wl = wlay_of(a.M, a.m1, a.Me, a.p, a.max_n, a.structured, a.hessian);
    const long long f4 = (long long)WARPS * (long long)sizeof(float);
    const bool fits = a.stage_shared && a.stage_bytes + f4 * (long long)wl.total <= dyn_budget();
    const bool fits_cap =
        a.stage_shared && a.stage_bytes + f4 * (long long)(wl.total - wl.cap) <= dyn_budget();
    int err;
    if constexpr (PB <= 4) {
        if (fits && (g_form == FORM_AUTO || g_form == FORM_SHARED)) {
            a.area_shared = 1;
            a.cap_shared = 0;
            if ((err = occupancy<PB, 3>(a, per_sm))) return err;
            *minb = 3;
            if (*per_sm >= 3) return 0;
        }
    }
    *minb = 1;
    // the forms in order of preference, each allowed by g_form and the budget
    const int forms[3][2] = {{1, 0}, {0, 1}, {0, 0}};  // (area_shared, cap_shared)
    const bool ok[3] = {fits && (g_form == FORM_AUTO || g_form == FORM_SHARED),
                        fits_cap && (g_form == FORM_AUTO || g_form == FORM_CAP_SHARED),
                        g_form == FORM_AUTO || g_form == FORM_SCRATCH ||
                            (g_form == FORM_SHARED && !fits) || (g_form == FORM_CAP_SHARED && !fits_cap)};
    int best = -1, best_cells = -1;
    for (int f = 0; f < 3; ++f) {
        if (!ok[f]) continue;
        a.area_shared = forms[f][0];
        a.cap_shared = forms[f][1];
        int cells = 0;
        if ((err = occupancy<PB, 1>(a, &cells))) return err;
        if (cells > best_cells) {
            best = f;
            best_cells = cells;
        }
    }
    a.area_shared = forms[best][0];
    a.cap_shared = forms[best][1];
    return occupancy<PB, 1>(a, per_sm);
}

}  // namespace

// Bytes of device scratch a launch of `cells` cells takes.
extern "C" long long mcp_glmm_extras_scratch_bytes(long long cells, int M, int m1, int Me, int p,
                                                   int max_n, int structured, int hessian) {
    const WLay wl = wlay_of(M, m1, Me, p, max_n, structured, hessian);
    return cells * cell_doubles_of(wl, M, p, max_n, dyn_budget()) * (long long)sizeof(double);
}

// The form a launch takes, from mcp_glmm_extras's plan arguments: out[0] 1
// where the f32 work areas are in shared memory (else device scratch), out[1]
// 1 where the staged rows are, out[2] the dynamic and out[3] the static
// shared bytes a block, out[4] resident blocks (cells) an SM, out[5] the p
// bucket, out[6] the cells an SM the variant's registers are held to, out[7]
// 1 where the areas are in scratch but their capacitance parts in shared
// memory. Returns a cudaError_t.
extern "C" int mcp_glmm_extras_geometry(int sims, int max_n, int P, const int* fit, int pf, int ng,
                                        const int* levels, const int* comps, const int* zcols,
                                        int G, int link, int hessian, int force_dense, int* out) {
    Args a;
    int err = make_args(a, nullptr, nullptr, sims, max_n, P, fit, pf, ng, levels, comps, zcols, G,
                        link, hessian, force_dense);
    if (err) return err;
    int per_sm = 0, minb = 1;
    err = pf <= 4 ? place<4>(a, &minb, &per_sm) : place<MAX_P>(a, &minb, &per_sm);
    if (err) return err;
    out[0] = a.area_shared;
    out[1] = a.stage_shared;
    out[2] = (int)dyn_bytes(a);
    out[3] = (int)sizeof(Shared);
    out[4] = per_sm;
    out[5] = pf <= 4 ? 4 : MAX_P;
    out[6] = minb;
    out[7] = a.cap_shared;
    return 0;
}

// Where later launches put the f32 work areas: 0 as the launcher picks
// (place), 1 shared memory where they fit, 2 device scratch, 3 scratch with
// the capacitance parts in shared memory where they fit (to time one form
// against another; all give the same bits).
extern "C" void mcp_glmm_extras_set_form(int form) { g_form = form; }

// X (sims, max_n, P), y (sims, max_n) f32 on the device; fit (pf,) in host
// memory; per grouping (the primary first, ng of them) its levels and
// components and the X columns of its slopes (zcols, comps[g] - 1 each,
// concatenated) in host memory; ids (ng, max_n), lvl_off (sum (m_g + 1))
// and lvl_rows (ng, max_n) int32 on the device (each grouping's level of
// each row, its levels' offsets into its row list, its rows by level,
// ascending); grid (G,) int32 on the device, cell c at (sim c / G, point c %
// G); beta0 (pf,) f64 on the device; theta0, lower (d,) in host memory;
// force_dense takes the dense capacitance for an all-intercept plan too;
// theta_in (cells, d) f64, where not null, replaces the search by a fit
// there; scratch of mcp_glmm_extras_scratch_bytes. Writes beta (cells, pf),
// cov (cells, pf, pf), tau2, ybar (cells,) f64, flags (cells,) (bit 0
// converged, bit 1 boundary), pinned (cells, sum q_g) uint8 and theta
// (cells, d) f64. Returns a cudaError_t.
extern "C" int mcp_glmm_extras(const void* X, const void* y, int sims, int max_n, int P,
                               const int* fit, int pf, int ng, const int* levels, const int* comps,
                               const int* zcols, const void* ids, const void* lvl_off,
                               const void* lvl_rows, const void* grid, int G, int link,
                               const void* beta0, const double* theta0, const double* lower,
                               int hessian, int force_dense, const void* theta_in, void* scratch,
                               void* beta, void* cov, void* tau2, void* ybar, void* flags,
                               void* pinned, void* theta, void* stream) {
    Args a;
    int err = make_args(a, X, y, sims, max_n, P, fit, pf, ng, levels, comps, zcols, G, link,
                        hessian, force_dense);
    if (err) return err;
    a.ids = (const int*)ids;
    a.lvl_off = (const int*)lvl_off;
    a.lvl_rows = (const int*)lvl_rows;
    a.grid = (const int*)grid;
    a.beta0 = (const double*)beta0;
    for (int k = 0; k < MAX_D; ++k) {
        a.theta0[k] = k < a.d ? theta0[k] : 0.0;
        a.lower[k] = k < a.d ? lower[k] : 0.0;
    }
    a.theta_in = (const double*)theta_in;
    a.scratch = (double*)scratch;
    a.beta = (double*)beta;
    a.cov = (double*)cov;
    a.tau2 = (double*)tau2;
    a.ybar = (double*)ybar;
    a.theta = (double*)theta;
    a.flags = (uint8_t*)flags;
    a.pinned = (uint8_t*)pinned;
    const long long cells = (long long)sims * G;
    if (cells > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
    int per_sm = 0, minb = 1;
    const dim3 blocks((unsigned)cells), threads(WARP * WARPS);
    cudaStream_t st = (cudaStream_t)stream;
    if (pf <= 4) {
        if ((err = place<4>(a, &minb, &per_sm))) return err;
        if (minb == 3)
            glmm_extras_kernel<4, 3><<<blocks, threads, dyn_bytes(a), st>>>(a);
        else
            glmm_extras_kernel<4, 1><<<blocks, threads, dyn_bytes(a), st>>>(a);
    } else {
        if ((err = place<MAX_P>(a, &minb, &per_sm))) return err;
        glmm_extras_kernel<MAX_P, 1><<<blocks, threads, dyn_bytes(a), st>>>(a);
    }
    return (int)cudaGetLastError();
}

#ifdef MCP_K12_CLOCKS
extern "C" int mcp_k12_clocks(void* dst, int zero) {
    if (zero) {
        void* p = nullptr;
        int err = (int)cudaGetSymbolAddress(&p, mcp_k12_clk);
        return err ? err : (int)cudaMemset(p, 0, sizeof(mcp_k12_clk));
    }
    return (int)cudaMemcpyFromSymbol(dst, mcp_k12_clk, sizeof(mcp_k12_clk));
}
#endif
