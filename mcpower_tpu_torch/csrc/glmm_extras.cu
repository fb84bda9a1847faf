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
// The design, a first version (simple and right):
// - one block of four warps a cell; in the search warp g evaluates
//   candidate g and in the initial simplex vertex 4 r + g; warp 0 runs the
//   f64 fit and the last stage, and the Hessian's stencil points go round
//   the four warps;
// - a pass: lane l takes primary levels l, l + 32, ... and walks each
//   level's rows, computing the row quantities, keeping w, zw and X beta per
//   row, and summing its levels' entries and its share of the whole-row
//   sums; then lane l takes extras levels l, l + 32, ... and walks their
//   rows from the kept row quantities; then the blocks between groupings are
//   mirrored and the whole-row sums combined; then the capacitance;
// - each warp's state (theta, beta, v, Z'WZ, the right-hand sides, the kept
//   row quantities and the capacitance's work area) lives in a device scratch
//   sized by mcp_glmm_extras_scratch_bytes, f32 in the search and f64 after
//   it in the same bytes; the carried v and the fit's v beside it; rows are
//   read from device memory;
// - thread 0 keeps the simplex in shared memory and runs the sort, the
//   candidates and the selection between rounds;
// - one pass function a type, not inlined, by a run-time kind (a step, a
//   v-only step, the deviance, the fit's mode) and form; one instantiation,
//   run-time sizes.

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
constexpr int MAX_NT = MAX_P * (MAX_P + 1) / 2;
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
enum { K_STEP = 0, K_VSTEP = 1, K_TAIL = 2, K_MODE = 3 };

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
    const int* ids;         // (ng, max_n): each row's level per grouping
    const int* lvl_off;     // per grouping its levels' offsets into lvl_rows (m_g + 1)
    const int* lvl_rows;    // (ng, max_n): each grouping's rows by level, ascending
    const int* grid;
    const double* beta0;
    double theta0[MAX_D], lower[MAX_D];
    const double* theta_in;  // (cells, d): fit here, no search; or null
    double* scratch;
    long long cell_doubles;
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
    double fin_beta[MAX_P];
    double axx[MAX_P * MAX_P];
    double lap, ysum;
    double hv[MAX_V];
};

// A warp's area, in elements of T (f32 in the search, f64 after it, in the
// same bytes): Z'WZ (structured: diag G_PP (m1), G_PE (m1 x Me), G_EE (Me x
// Me); dense, and for the Hessian: M x M), the right-hand sides (M x (p +
// 1)), u (then the new v), v, theta, beta, the kept row quantities w, zw
// and X beta (max_n each), X'WX, X'Wz, the last stage's four p x p
// matrices and the capacitance's work area.
struct WLay {
    size_t g, raw, u, v, th, bt, wbuf, zwbuf, xbbuf, xwx, xwz, fin, cap, total;
};

__host__ __device__ inline WLay wlay_of(int M, int m1, int Me, int p, int max_n, int structured,
                                        int hessian) {
    WLay w;
    size_t gs = structured ? (size_t)m1 + (size_t)m1 * Me + (size_t)Me * Me : (size_t)M * M;
    if (hessian && (size_t)M * M > gs) gs = (size_t)M * M;
    size_t cs = layout_of(structured, M, m1, Me, p).total();
    if (hessian) {  // the stencil's dense passes
        const size_t vs = layout_of(0, M, m1, Me, p).total();
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
    w.xwz = w.xwx + MAX_P * MAX_P;
    w.fin = w.xwz + MAX_P;
    w.cap = w.fin + 4 * MAX_P * MAX_P;
    w.total = w.cap + cs;
    return w;
}

// Doubles of scratch a cell takes: the four warps' areas, the carried v
// (f32) and the fit's v (f64).
__host__ __device__ inline long long cell_doubles(const WLay& w, int M) {
    return (long long)WARPS * (long long)w.total + 2LL * M;
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

// One pass of the warp over its cell's rows (glmmfit._extras_pass) in the
// warp's area `w` (theta, beta and v there). K_STEP and K_VSTEP update beta
// and v in place (or keep them, where the step is not finite); K_TAIL
// returns the Laplace deviance; K_MODE returns it and writes the ridged
// Schur matrix to axx (p x p).
template <typename T>
__device__ __noinline__ T extras_pass(const Args& a, const Shared& S, long long sim, int n,
                                      int lane, int kind, bool structured, T* w, double* axx) {
    const WLay wl = wlay_of(a.M, a.m1, a.Me, a.p, a.max_n, a.structured, a.hessian);
    const int M = a.M, p = a.p, ng = a.ng, m1 = a.m1, Me = a.Me;
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
    const float* Xs = a.X + sim * (long long)a.max_n * a.P;
    const float* ys = a.y + sim * (long long)a.max_n;

    // u = Lam v: column (g, level, i) sums v(g, level, k) Lg[i][k] from k = 0
    for (int col = lane; col < M; col += WARP) {
        const int g = S.cgrp[col], i = S.crr[col], base = S.cbase[col];
        T acc = v[base] * lam_of(a, th, g, i, 0);
        for (int k = 1; k <= i; ++k) acc = acc + v[base + k] * lam_of(a, th, g, i, k);
        u[col] = acc;
    }
    __syncwarp();

    // the primary levels: the row quantities, the levels' entries and this
    // lane's share of the whole-row sums
    T pxx[MAX_NT], pxz[MAX_P], pdev = T(0);
    for (int i = 0; i < nt; ++i) pxx[i] = T(0);
    for (int i = 0; i < p; ++i) pxz[i] = T(0);
    const int q0 = a.comps[0];
    for (int lv = lane; lv < a.levels[0]; lv += WARP) {
        const int c0 = a.coff[0] + lv * q0;
        if (structured) {
            G[lv] = T(0);
            for (int e = 0; e < Me; ++e) Gpe[(size_t)lv * Me + e] = T(0);
        } else {
            for (int k = 0; k < q0; ++k)
                for (int j = 0; j < M; ++j) G[(size_t)(c0 + k) * M + j] = T(0);
        }
        for (int k = 0; k < q0; ++k)
            for (int c = 0; c < r; ++c) raw[(size_t)(c0 + k) * r + c] = T(0);
        T lxx[MAX_NT], lxz[MAX_P], ldev = T(0);
        for (int i = 0; i < nt; ++i) lxx[i] = T(0);
        for (int i = 0; i < p; ++i) lxz[i] = T(0);
        const int t1 = a.lvl_off[a.loff[0] + lv + 1];
        for (int t = a.lvl_off[a.loff[0] + lv]; t < t1; ++t) {
            const int rr = a.lvl_rows[t];
            if (rr >= n) break;
            const float* row = Xs + (long long)rr * a.P;
            T x[MAX_P];
            for (int k = 0; k < p; ++k) x[k] = (T)row[a.fit[k]];
            const T yv = (T)ys[rr];
            T xb = T(0);
            for (int k = 0; k < p; ++k) xb = xb + x[k] * beta[k];
            T zu = T(0);
            for (int g = 0; g < ng; ++g) {
                const int lvg = g == 0 ? lv : a.ids[(size_t)g * a.max_n + rr];
                const int base = a.coff[g] + lvg * a.comps[g];
                for (int k = 0; k < a.comps[g]; ++k) {
                    T tz = u[base + k];
                    if (k) tz = (T)row[a.zc[g][k]] * tz;
                    zu = (g == 0 && k == 0) ? tz : zu + tz;
                }
            }
            const T eta = xb + zu;
            T mu, var, dmu;
            mu_var_dmu<T>(a.link, eta, mu, var, dmu);
            const T wt = dmu * dmu / clamp_lo(var, T(MU_EPS));
            const T zw = eta + (yv - mu) / dmu;
            wb[rr] = wt;
            zwb[rr] = zw;
            xbb[rr] = xb;
            T z0[MAX_QG], wz[MAX_QG];
            z0[0] = T(1);
            wz[0] = wt;
            for (int k = 1; k < q0; ++k) {
                z0[k] = (T)row[a.zc[0][k]];
                wz[k] = z0[k] * wt;
            }
            if (structured) {
                G[lv] = G[lv] + wt;
                for (int h = 1; h < ng; ++h) {
                    const size_t e = (size_t)lv * Me + (a.coff[h] - m1) + a.ids[(size_t)h * a.max_n + rr];
                    Gpe[e] = Gpe[e] + wt;
                }
            } else {
                for (int k = 0; k < q0; ++k)
                    for (int l = 0; l <= k; ++l) {
                        const size_t e = (size_t)(c0 + k) * M + c0 + l;
                        G[e] = G[e] + (l == 0 ? wz[k] : wz[k] * z0[l]);
                    }
                for (int h = 1; h < ng; ++h) {
                    const int bh = a.coff[h] + a.ids[(size_t)h * a.max_n + rr] * a.comps[h];
                    for (int l = 0; l < a.comps[h]; ++l) {
                        const T zl = l == 0 ? T(1) : (T)row[a.zc[h][l]];
                        for (int k = 0; k < q0; ++k) {
                            const size_t e = (size_t)(c0 + k) * M + bh + l;
                            G[e] = G[e] + (l == 0 ? wz[k] : wz[k] * zl);
                        }
                    }
                }
            }
            if (step || vstep) {
                const T rz = step ? zw : zw - xb;
                for (int k = 0; k < q0; ++k) {
                    const size_t e = (size_t)(c0 + k) * r;
                    raw[e] = raw[e] + wz[k] * rz;
                }
            }
            if (want_a) {
                for (int k = 0; k < q0; ++k)
                    for (int c = 0; c < p; ++c) {
                        const size_t e = (size_t)(c0 + k) * r + 1 + c;
                        raw[e] = raw[e] + wz[k] * x[c];
                    }
                for (int i = 0; i < p; ++i) {
                    const T xw = x[i] * wt;
                    for (int j = 0; j <= i; ++j) lxx[tri(i, j)] = lxx[tri(i, j)] + xw * x[j];
                }
            }
            if (step) {
                const T wzw = wt * zw;
                for (int k = 0; k < p; ++k) lxz[k] = lxz[k] + x[k] * wzw;
            }
            if (want_dev) ldev = ldev + dev_term<T>(a.link, yv, mu);
        }
        if (!structured)  // the level's block, mirrored
            for (int k = 0; k < q0; ++k)
                for (int l = 0; l < k; ++l)
                    G[(size_t)(c0 + l) * M + c0 + k] = G[(size_t)(c0 + k) * M + c0 + l];
        if (want_a)
            for (int i = 0; i < nt; ++i) pxx[i] = pxx[i] + lxx[i];
        if (step)
            for (int i = 0; i < p; ++i) pxz[i] = pxz[i] + lxz[i];
        if (want_dev) pdev = pdev + ldev;
    }
    __syncwarp();

    // the extras levels, from the kept row quantities
    for (int e = lane; e < a.mlev; e += WARP) {
        int g = 1;
        while (g + 1 < ng && e >= a.lev0[g + 1]) ++g;
        const int lv = e - a.lev0[g], qg = a.comps[g], cg = a.coff[g] + lv * qg;
        if (structured) {
            for (int j = a.coff[g] - m1; j < Me; ++j) Gee[(size_t)(cg - m1) * Me + j] = T(0);
        } else {
            for (int k = 0; k < qg; ++k)
                for (int j = a.coff[g]; j < M; ++j) G[(size_t)(cg + k) * M + j] = T(0);
        }
        for (int k = 0; k < qg; ++k)
            for (int c = 0; c < r; ++c) raw[(size_t)(cg + k) * r + c] = T(0);
        const int t1 = a.lvl_off[a.loff[g] + lv + 1];
        for (int t = a.lvl_off[a.loff[g] + lv]; t < t1; ++t) {
            const int rr = a.lvl_rows[(size_t)g * a.max_n + t];
            if (rr >= n) break;
            const float* row = Xs + (long long)rr * a.P;
            const T wt = wb[rr], zw = zwb[rr];
            T zg[MAX_QG], wz[MAX_QG];
            zg[0] = T(1);
            wz[0] = wt;
            for (int k = 1; k < qg; ++k) {
                zg[k] = (T)row[a.zc[g][k]];
                wz[k] = zg[k] * wt;
            }
            if (structured) {
                const size_t ei = (size_t)(cg - m1) * Me;
                Gee[ei + cg - m1] = Gee[ei + cg - m1] + wt;
                for (int h = g + 1; h < ng; ++h) {
                    const size_t eh = ei + (a.coff[h] - m1) + a.ids[(size_t)h * a.max_n + rr];
                    Gee[eh] = Gee[eh] + wt;
                }
            } else {
                for (int k = 0; k < qg; ++k)
                    for (int l = 0; l <= k; ++l) {
                        const size_t el = (size_t)(cg + k) * M + cg + l;
                        G[el] = G[el] + (l == 0 ? wz[k] : wz[k] * zg[l]);
                    }
                for (int h = g + 1; h < ng; ++h) {
                    const int bh = a.coff[h] + a.ids[(size_t)h * a.max_n + rr] * a.comps[h];
                    for (int l = 0; l < a.comps[h]; ++l) {
                        const T zl = l == 0 ? T(1) : (T)row[a.zc[h][l]];
                        for (int k = 0; k < qg; ++k) {
                            const size_t el = (size_t)(cg + k) * M + bh + l;
                            G[el] = G[el] + (l == 0 ? wz[k] : wz[k] * zl);
                        }
                    }
                }
            }
            if (step || vstep) {
                const T rz = step ? zw : zw - xbb[rr];
                for (int k = 0; k < qg; ++k) {
                    const size_t el = (size_t)(cg + k) * r;
                    raw[el] = raw[el] + wz[k] * rz;
                }
            }
            if (want_a) {
                for (int k = 0; k < qg; ++k)
                    for (int c = 0; c < p; ++c) {
                        const size_t el = (size_t)(cg + k) * r + 1 + c;
                        raw[el] = raw[el] + wz[k] * (T)row[a.fit[c]];
                    }
            }
        }
        if (!structured)
            for (int k = 0; k < qg; ++k)
                for (int l = 0; l < k; ++l)
                    G[(size_t)(cg + l) * M + cg + k] = G[(size_t)(cg + k) * M + cg + l];
    }
    __syncwarp();

    // the blocks between groupings, mirrored: a row a lane, its columns in
    // earlier groupings
    if (structured) {
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
    for (int i = 0; i < p; ++i) {
        for (int j = 0; j <= i; ++j) {
            const T s = want_a ? warp_sum(pxx[tri(i, j)]) : T(0);
            if (lane == 0) xwx[i * p + j] = xwx[j * p + i] = s;
        }
        const T s = step ? warp_sum(pxz[i]) : T(0);
        if (lane == 0) xwz[i] = s;
    }
    const T dev = want_dev ? warp_sum(pdev) : T(0);
    __syncwarp();

    // the capacitance of Z'WZ and its solve of the right-hand sides
    const Layout lay = layout_of(structured ? 1 : 0, M, m1, Me, vstep ? 0 : p);
    T* cw = w + wl.cap;
    const GSrc<T> src{G, raw, M, m1, Me, r, structured};
    const T logdet = capacitance(a, S, th, src, cw, lay, structured, kind != K_TAIL, lane);
    if (want_dev) {
        T vv = v[0] * v[0];
        for (int i = 1; i < M; ++i) vv = vv + v[i] * v[i];
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
        const T* s = !structured ? solr + (size_t)row * r
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
    return T(0);
}

// `steps` passes of step_kind, then one of last_kind; its result.
template <typename T>
__device__ __forceinline__ T chain(const Args& a, const Shared& S, long long sim, int n, int lane,
                                   int steps, int step_kind, int last_kind, bool structured, T* w,
                                   double* axx) {
    T out = T(0);
    for (int s = 0; s <= steps; ++s)
        out = extras_pass<T>(a, S, sim, n, lane, s < steps ? step_kind : last_kind, structured, w,
                             axx);
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

__global__ void __launch_bounds__(WARP * WARPS) glmm_extras_kernel(const Args a) {
    __shared__ Shared S;
    const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP, t = threadIdx.x;
    const long long cell = blockIdx.x;
    const long long sim = cell / a.G;
    const int n = a.grid[cell % a.G];
    const int M = a.M, p = a.p, D = a.d;
    const bool st = a.structured != 0;
    const WLay wl = wlay_of(M, a.m1, a.Me, p, a.max_n, a.structured, a.hessian);
    double* base = a.scratch + cell * a.cell_doubles;
    double* wd = base + (long long)warp * wl.total;
    float* w32 = reinterpret_cast<float*>(wd);
    float* carry_v = reinterpret_cast<float*>(base + (long long)WARPS * wl.total);
    double* fin_v = base + (long long)WARPS * wl.total + M;

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
                const float lap = chain<float>(a, S, sim, n, lane, N_PIRLS_SLOPE, K_STEP, K_TAIL, st,
                                               w32, nullptr);
                if (lane == 0) S.fc[warp] = isfinite(lap) ? (double)lap : SENTINEL;
            }
            __syncthreads();
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
                const float* sw = reinterpret_cast<const float*>(base + (long long)S.src * wl.total);
                for (int i = t; i < M; i += WARP * WARPS) carry_v[i] = sw[wl.v + i];
                if (t < p) S.carry_beta[t] = sw[wl.bt + t];
            }
            __syncthreads();
        }
        // the search: four candidates from the carry, the accepted one's mode carried
        for (int it = 0; it < a.nm_iters; ++it) {
            const int budget = it < NM_FULL ? N_PIRLS_SLOPE : N_PIRLS_SLOPE_WARM;
            if (t == 0) mcp::nm_candidates(a.lower, S, D);
            __syncthreads();
            load_state<float>(wl, w32, S.cand[warp], D, S.carry_beta, nullptr, p, carry_v, M, lane);
            const float lap = chain<float>(a, S, sim, n, lane, budget, K_STEP, K_TAIL, st, w32,
                                           nullptr);
            if (lane == 0) S.fc[warp] = isfinite(lap) ? (double)lap : SENTINEL;
            __syncthreads();
            if (t == 0) S.src = mcp::nm_select_and_replace(S, D);
            __syncthreads();
            {
                const float* sw = reinterpret_cast<const float*>(base + (long long)S.src * wl.total);
                for (int i = t; i < M; i += WARP * WARPS) carry_v[i] = sw[wl.v + i];
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
    if (warp == 0) {
        load_state<double>(wl, wd, S.theta, D, nullptr, a.beta0, p, nullptr, M, lane);
        const double lap = chain<double>(a, S, sim, n, lane, N_PIRLS, K_STEP, K_MODE, st, wd,
                                         S.axx);
        for (int i = lane; i < M; i += WARP) fin_v[i] = wd[wl.v + i];
        double ysum = 0.0;
        const float* yrow = a.y + sim * (long long)a.max_n;
        for (int lv = lane; lv < a.levels[0]; lv += WARP) {
            double acc = 0.0;
            const int t1 = a.lvl_off[a.loff[0] + lv + 1];
            for (int tt = a.lvl_off[a.loff[0] + lv]; tt < t1; ++tt) {
                const int rr = a.lvl_rows[tt];
                if (rr >= n) break;
                acc = acc + (double)yrow[rr];
            }
            ysum = ysum + acc;
        }
        ysum = warp_sum(ysum);
        if (lane == 0) {
            S.lap = lap;
            S.ysum = ysum;
            for (int k = 0; k < p; ++k) S.fin_beta[k] = wd[wl.bt + k];
        }
    }
    __syncthreads();

    // the Hessian's stencil: v-only passes through the dense capacitance
    const int nv = a.hessian ? 1 + 2 * p + 2 * p * (p - 1) : 0;
    for (int e = warp; e < nv; e += WARPS) {
        __syncwarp();
        for (int k = lane; k < D; k += WARP) wd[wl.th + k] = S.theta[k];
        for (int k = lane; k < p; k += WARP) wd[wl.bt + k] = S.fin_beta[k] + stencil(e, k, p);
        for (int i = lane; i < M; i += WARP) wd[wl.v + i] = fin_v[i];
        __syncwarp();
        const double hv = chain<double>(a, S, sim, n, lane, N_V_PIRLS, K_VSTEP, K_TAIL, false, wd,
                                        nullptr);
        if (lane == 0) S.hv[e] = hv;
    }
    __syncthreads();
    if (warp != 0) return;

    // the last stage on warp 0: the factor, the rank probe, the covariance
    double* L = wd + wl.fin;
    double* R = L + MAX_P * MAX_P;
    double* INV = R + MAX_P * MAX_P;
    double* H = INV + MAX_P * MAX_P;
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

}  // namespace

// Bytes of device scratch a launch of `cells` cells takes.
extern "C" long long mcp_glmm_extras_scratch_bytes(long long cells, int M, int m1, int Me, int p,
                                                   int max_n, int structured, int hessian) {
    const WLay wl = wlay_of(M, m1, Me, p, max_n, structured, hessian);
    return cells * cell_doubles(wl, M) * (long long)sizeof(double);
}

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
    if (sims <= 0 || G <= 0 || pf < 1 || pf > MAX_P || max_n <= 0 || P <= 0 || link < 0 ||
        link > 2 || ng < 2 || ng > MAX_G)
        return (int)cudaErrorInvalidValue;
    Args a;
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
    int col = 0, d = 0, nq = 0, zoff = 0, loff = 0, lev = 0;
    bool all_q1 = true;
    for (int g = 0; g < ng; ++g) {
        if (levels[g] <= 0 || comps[g] <= 0 || comps[g] > MAX_QG) return (int)cudaErrorInvalidValue;
        a.levels[g] = levels[g];
        a.comps[g] = comps[g];
        a.coff[g] = col;
        a.toff[g] = d;
        a.loff[g] = loff;
        a.lev0[g] = lev;
        for (int k = 0; k < MAX_QG; ++k) a.zc[g][k] = (k >= 1 && k < comps[g]) ? zcols[zoff + k - 1] : 0;
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
    a.ids = (const int*)ids;
    a.lvl_off = (const int*)lvl_off;
    a.lvl_rows = (const int*)lvl_rows;
    a.grid = (const int*)grid;
    a.beta0 = (const double*)beta0;
    for (int k = 0; k < MAX_D; ++k) {
        a.theta0[k] = k < d ? theta0[k] : 0.0;
        a.lower[k] = k < d ? lower[k] : 0.0;
    }
    a.theta_in = (const double*)theta_in;
    a.scratch = (double*)scratch;
    a.cell_doubles = cell_doubles(wlay_of(a.M, a.m1, a.Me, pf, max_n, a.structured, hessian), a.M);
    a.beta = (double*)beta;
    a.cov = (double*)cov;
    a.tau2 = (double*)tau2;
    a.ybar = (double*)ybar;
    a.theta = (double*)theta;
    a.flags = (uint8_t*)flags;
    a.pinned = (uint8_t*)pinned;
    const long long cells = (long long)sims * G;
    if (cells > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
    glmm_extras_kernel<<<(unsigned)cells, WARP * WARPS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
