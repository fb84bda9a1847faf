// K10 glmm_slope: the whole random-slope GLMM fit of one (sim, grid) cell,
// the four Nelder-Mead candidates of an iteration on the cell's four warps.
//
// Replaces: mcpower_tpu/engine/glmmfit.py::_slope_glmm_grid_stats (:556-906)
// with its PIRLS (make_pirls :643-745), the Laplace deviance tail (dev_tail
// :753-781), the warm-carried shrink-free Nelder-Mead
// (mcpower_tpu/engine/optim.py::nelder_mead_carry :113-211, called at
// :801-811), the final f64 fit and its covariance (:812-815), the FD Hessian
// covariance (:816-860 with _fd_hessian_cov :65), the pin probes (:863-881)
// and the flags (:882-891), which XLA fuses into one program per design.
// Per cell, on the rows below its grid point, with Z = [1, x_slopes] (q
// columns) and Lam = vech_to_lower(theta), theta of d = q (q + 1) / 2:
//   1. the d + 1 initial vertices (theta0, theta0 + 0.2 e_i, clipped at
//      `lower`), each from (beta0, v = 0) by 8 f32 PIRLS steps and the f32
//      Laplace deviance (a non-finite one ranks as 1e30); the first minimum's
//      mode is the carry;
//   2. 45 Nelder-Mead iterations (12 at 8 PIRLS steps, 33 at 3): the four
//      candidates each from the carried (beta, v), the accepted one's mode
//      the next carry;
//   3. the f64 fit at the optimum, cold from (beta0, 0) by 12 steps, its
//      Laplace deviance and Schur matrix; cov = (X'WX - sum A~' C^-1 A~ +
//      1e-10 I)^-1, or under the Hessian 2 H^-1 of central differences of
//      the v-profiled deviance (20 v-only f64 passes a stencil point);
//   4. each component's probe: theta with its Cholesky column zeroed, 3 f64
//      steps from the fit's mode, the deviance; pinned = probe <= lap +
//      1e-10 (a pin changes nothing in the fit); converged = finite beta, a
//      Cholesky of positive pivots, the unridged rank probe and a finite
//      deviance; tau^2 = Lam[0][0]^2; the outcome mean over the rows.
// One PIRLS step at Lam: per row u = Lam v of its cluster, eta = X beta +
// Z u, the link's mu, var, dmu, w = dmu^2 / max(var, 1e-10) and zw = eta +
// (y - mu) / dmu; per cluster G = sum (Z_r w) Z_c, A = sum (Z_r w) x, b =
// sum (Z_r w) zw, C = I + Lam' G Lam (q x q) and its Cholesky, the solves of
// A~ = Lam' A and b~ = Lam' b; the p x p Schur system (X'WX - sum A~' C^-1
// A~) + ridge for beta (ridge 1e-6 in f32, 1e-10 in f64), then v = C^-1 b~ -
// C^-1 A~ beta; a step whose beta or v is not finite keeps the old state.
//
// Bit identity with the plain version (engine/glmmfit.py::glmm_slope_plain
// with optim.nelder_mead_carry): every operation is the plain version's, in
// its order. Each cluster's rows are summed in row order (rows at or past
// the grid point add exact zeros there and are skipped here); the sums over
// clusters follow K7's lanes (lane l adds clusters l, l + 32, ... to a zero
// in turn, then an xor butterfly that gives every lane the bits of
// smallchol.lane_sum's pair tree); each per-cluster term sums over the q
// components from the first; the small factors are smallchol's order (the
// factor multiplies by the reciprocal pivot, the solves divide); the
// simplex is K9's (a stable insertion sort, the centroid as the d best
// vertices added in sorted order times the f64 reciprocal of d, the clip as
// x < lo ? lo : x). The transcendentals are libdevice's and the file is
// built with --fmad=false.
//
// What bounds it on the H100: the dependency chain of one cell. A cell runs
// (d + 1) 8 + 12 * 4 * 8 + 33 * 4 * 3 = 812 f32 PIRLS row passes and 184
// f32 deviance tails (q = 2), in 45 + 1 rounds that wait on each other (the
// simplex decides the next candidates), then ~3q + 14 f64 passes; per row
// and pass an exp (or erf), two IEEE divisions and ~2 (q + p)^2 operations.
// chip_smoke.k10_bound counts them.
//
// The design (redesigned for Hopper after the first version's cycle counts
// by region, chip_k10_profile.py: at 194-255 registers two cells an SM
// shared each scheduler's instruction slots, and the warp sums and the
// Schur step's v update from device scratch held 40% of a cell's cycles):
// - one block of four warps a cell; in the search warp g evaluates
//   candidate g (the four are independent) and in the initial simplex
//   vertex 4 r + g; in the f64 phase warp 0 runs the fit, warps j < q the
//   probes, and the Hessian's stencil points go round the four warps;
// - within a warp, lane l takes clusters l, l + 32, ... and walks each
//   cluster's rows in row order through the whole row chain, so a cluster's
//   sums need no buffer; the per-cluster factors follow on the same lane.
//   (A row phase over all 32 lanes into a row buffer, then the clusters'
//   sums from it, was measured slower: the kernel is bound by instruction
//   throughput, each row's exp or erf, IEEE divisions and unfused
//   multiply-adds, and the buffer's stores and reloads cost more
//   instruction slots than the walk's idle lanes; chip_k10_profile.py,
//   PERF.md §6);
// - the p-exact instantiations (p <= 4) hold 128 registers a thread, four
//   cells an SM (the first version's 194-255 held two); the f32 and the f64
//   passes are pass functions of their own;
// - the cell's rows below its grid point are staged once in shared memory
//   (the fit and slope columns and y, f32 as read, column-major; cp.async),
//   and each warp's f32 state (v, the solves C^-1 b~ and C^-1 A~) and the
//   carried v live there too; where they do not fit (thousands of clusters
//   or rows) the same pass reads the rows from device memory and keeps the
//   state in device scratch (the streamed form). The f64 passes' state and
//   the fit's v are in device scratch;
// - the sums over clusters of a pass go through one butterfly whose levels
//   take every sum at once;
// - thread 0 keeps the simplex in shared memory and runs the sort, the
//   candidates and the selection between rounds;
// - q (2, 3, 4) is a template constant, p too where it pays (2, 3, 4); wider
//   fits take the p <= 8 and p <= 16 instantiations (15 kernels in all). A
//   sim's grid cells are blocks of their own: a cell reads its stage once
//   for ~1,000 passes, so sharing it across the grid saves nothing, and 11
//   cells of four warps would pass the 32 warps a block may hold.

#include <cuda_pipeline.h>

#include "common.cuh"
#include "glmm_link.cuh"
#include "nelder_mead.cuh"
#include "smallchol.cuh"

// K10's cycle counts by region: chip_k10_profile.py builds this file with
// -DMCP_K10_CLOCKS=cells, and lane 0 of each warp of the first `cells` cells
// adds clock64() deltas into row blockIdx.x of mcp_k10_clk (slots:
// chip_k10_profile.REGIONS).
#ifdef MCP_K10_CLOCKS
__device__ unsigned long long mcp_k10_clk[MCP_K10_CLOCKS * 12];
#define K10_T0(v) long long v = clock64()
#define K10_ADD(k, v) do { if (threadIdx.x % 32 == 0 && blockIdx.x < MCP_K10_CLOCKS) \
    atomicAdd(&mcp_k10_clk[(long long)blockIdx.x * 12 + (k)], \
              (unsigned long long)(clock64() - (v))); } while (0)
#define K10_ADD32(k, v) do { if (sizeof(T) == 4) K10_ADD(k, v); } while (0)
#else
#define K10_T0(v)
#define K10_ADD(k, v)
#define K10_ADD32(k, v)
#endif

namespace {

using mcp::cho_solve_packed_rt;
using mcp::chol_packed_rt;
using mcp::clamp_lo;
using mcp::dev_term;
using mcp::m_log;
using mcp::mu_var_dmu;
using mcp::MU_EPS;
using mcp::Rows;
using mcp::rows_of;
using mcp::tri;

constexpr int WARP = 32;
constexpr int WARPS = 4;  // a cell's warps: the four candidates
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_Q = 4;
constexpr int MAX_D = 10;
constexpr int MAX_P = 16;
constexpr int MAX_V = 1 + 2 * MAX_P + 2 * MAX_P * (MAX_P - 1);  // Hessian stencil points
constexpr int N_PIRLS = 12;
constexpr int N_PIRLS_SLOPE = 8;
constexpr int N_PIRLS_SLOPE_WARM = 3;
constexpr int NM_ITERS = 45;
constexpr int NM_FULL = 12;
constexpr int N_V_PIRLS = 20;
constexpr double NM_STEP = 0.2;
constexpr double EPS_RANK = 1e-6;
constexpr double PIN_MARGIN = 1e-10;
constexpr double H_STEP = 1e-4;
constexpr double SENTINEL = 1e30;
constexpr int MAX_SMEM_BYTES = 227 * 1024;  // a block's shared memory on the H100
enum { K_STEP = 0, K_VSTEP = 1, K_TAIL = 2, K_MODE = 3 };
enum { FORM_AUTO = 0, FORM_SHARED = 1, FORM_STREAMED = 2 };

struct Args {
    const float* X;
    const float* y;
    int sims, max_n, P, G, pf, q;
    int fit[MAX_P];
    int zc[MAX_Q];  // zc[k], k >= 1: the X column of Z's column k
    const int* grid;
    int rr, period, m, link, hessian;
    const double* beta0;
    double theta0[MAX_D], lower[MAX_D];
    double* scratch;
    int form;           // FORM_SHARED or FORM_STREAMED
    int sld;            // the stage's rows a column (max_n, rounded up to 4)
    int stage_floats;   // the stage's floats (0 in the streamed form)
    int area_floats;    // a warp's f32 area in shared memory (0 in the streamed form)
    double *beta, *cov, *tau2, *ybar, *theta;
    uint8_t *flags, *pinned;
};

// The cell's shared state.
struct Shared {
    double verts[MAX_D + 1][MAX_D];
    double fvals[MAX_D + 1];
    double cand[WARPS][MAX_D];
    double fc[WARPS];
    double theta[MAX_D];
    double best;  // the initial simplex's least value so far
    int ord[MAX_D + 1];
    int src;      // the warp whose mode becomes the carry, or -1
    float lam32[WARPS][MAX_Q * MAX_Q], beta32[WARPS][MAX_P], carry_beta[MAX_P];
    double lam64[WARPS][MAX_Q * MAX_Q], beta64[WARPS][MAX_P], fin_beta[MAX_P];
    double axx[MAX_P * (MAX_P + 1) / 2];
    double lap, ysum;
    double probe[MAX_Q];
    double hv[MAX_V];
};

// Doubles of scratch a cell takes: per warp v (q m) and the solves (q (p +
// 1) m), then the carried v and the f64 fit's v. The f64 passes' state (and
// the streamed form's f32 state, in the same words) lives there.
__host__ __device__ inline long long cell_doubles(int m, int q, int p) {
    return (long long)WARPS * q * m * (p + 2) + 2LL * q * m;
}

// A warp's f32 area in the shared form: v (q m) and the solves (q (p + 1) m).
__host__ __device__ inline int area_floats(int m, int q, int p) { return q * m * (p + 2); }

// The cell's p: PB itself in the p-exact buckets (p <= 4), a run-time value
// in the p <= 8 and p <= 16 buckets.
template <int PB>
__device__ __forceinline__ int npf(const Args& a) {
    return PB <= 4 ? PB : a.pf;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
    for (int dist = WARP / 2; dist >= 1; dist >>= 1) v = v + __shfl_xor_sync(FULL, v, dist);
    return v;
}

// warp_sum of the first K entries of v, the butterfly's levels taking them
// all at once (each entry's own bits unchanged).
template <int K, int N, typename T>
__device__ __forceinline__ void warp_sums(T (&v)[N]) {
#pragma unroll
    for (int dist = WARP / 2; dist >= 1; dist >>= 1) {
        T o[K];
#pragma unroll
        for (int k = 0; k < K; ++k) o[k] = __shfl_xor_sync(FULL, v[k], dist);
#pragma unroll
        for (int k = 0; k < K; ++k) v[k] = v[k] + o[k];
    }
}

// A cell's rows: the stage in shared memory (column-major, sld rows a
// column: the fit columns, the slope columns, y), or X and y in device
// memory.
struct Src {
    const float* base;  // column c's row r at base[c + r * rs]
    const float* yb;    // y's row r at yb[r]
    int rs, staged;
    __device__ __forceinline__ float y(int r) const { return yb[r]; }
};

// A pass's column offsets into its source: the fit columns, then Z's
// columns 1..q-1 (the stage's column-major offsets, or X's columns).
template <int PB, int Q>
struct Cols {
    int x[PB], z[Q];
    __device__ __forceinline__ Cols(const Args& a, const Src& src, int p) {
#pragma unroll
        for (int k = 0; k < PB; ++k) x[k] = k < p ? (src.staged ? k * a.sld : a.fit[k]) : 0;
        z[0] = 0;
#pragma unroll
        for (int k = 1; k < Q; ++k) z[k] = src.staged ? (a.pf + k - 1) * a.sld : a.zc[k];
    }
};

// One row's quantities at beta and its cluster's u: w and the pass's second
// quantity (zw for a step, zw - X beta for a v-only step, the deviance term
// for a tail or the fit's mode), as the plain version forms them.
template <int Q, int PB, typename T>
__device__ __forceinline__ void row_quant(const Args& a, const Src& src, const Cols<PB, Q>& cols,
                                          int r, int p, int kind, const T (&beta)[PB],
                                          const T (&u)[Q], T& w, T& s2) {
    const float* row = src.base + r * src.rs;
    T x[PB], z[Q];
#pragma unroll
    for (int k = 0; k < PB; ++k) x[k] = (k < p) ? (T)row[cols.x[k]] : T(0);
    z[0] = T(1);
#pragma unroll
    for (int k = 1; k < Q; ++k) z[k] = (T)row[cols.z[k]];
    const T yv = (T)src.y(r);
    T xb = T(0);
#pragma unroll
    for (int k = 0; k < PB; ++k)
        if (k < p) xb = xb + x[k] * beta[k];
    T zu = u[0];
#pragma unroll
    for (int k = 1; k < Q; ++k) zu = zu + z[k] * u[k];
    const T eta = xb + zu;
    T mu, var, dmu;
    mu_var_dmu<T>(a.link, eta, mu, var, dmu);
    w = dmu * dmu / clamp_lo(var, T(MU_EPS));
    if (kind == K_STEP || kind == K_VSTEP) {
        const T zw = eta + (yv - mu) / dmu;
        s2 = kind == K_STEP ? zw : zw - xb;
    } else {
        s2 = dev_term<T>(a.link, yv, mu);
    }
}

// One pass of the warp over its cell's rows (glmmfit._slope_pass) at lam (Q
// x Q row-major, shared), beta (shared) and the modes v (slot k of cluster
// c at v[k * m + c]); sol the warp's solves (C^-1 b~ in slots 0..Q-1, C^-1
// A~ column a in slots Q + a Q + r); lane l walks clusters l, l + 32, ...,
// each cluster's rows through the whole chain in row order. K_STEP and
// K_VSTEP update beta and v in place (or keep them, where the step is not
// finite); K_TAIL returns the Laplace deviance; K_MODE returns it and writes
// the ridged Schur matrix to axx (packed).
template <int Q, int PB, typename T>
__device__ __noinline__ T slope_pass(const Args& a, const Src& src, int n, int lane, int kind,
                                     const T* lamS, T* betaS, T* v, T* sol, double* axx) {
    constexpr int NG = Q * (Q + 1) / 2;
    constexpr int NT = PB * (PB + 1) / 2;
    const int m = a.m, p = npf<PB>(a);
    const bool step = kind == K_STEP, vstep = kind == K_VSTEP;
    const bool want_a = step || kind == K_MODE, want_b = step || vstep;
    const bool want_dev = kind == K_TAIL || kind == K_MODE;
    T lam[Q][Q];
#pragma unroll
    for (int i = 0; i < Q; ++i)
#pragma unroll
        for (int j = 0; j < Q; ++j) lam[i][j] = lamS[i * Q + j];
    T beta[PB];
#pragma unroll
    for (int k = 0; k < PB; ++k) beta[k] = (k < p) ? betaS[k] : T(0);
    const Cols<PB, Q> cols(a, src, p);

    T pxx[NT], psxx[NT], pxz[PB], psxy[PB];
#pragma unroll
    for (int i = 0; i < NT; ++i) pxx[i] = psxx[i] = T(0);
#pragma unroll
    for (int i = 0; i < PB; ++i) pxz[i] = psxy[i] = T(0);
    T pdev = T(0), pvv = T(0), pld = T(0);
    bool fin = true;

    for (int cl = lane; cl < m; cl += WARP) {
        K10_T0(clk_rw);
        T vc[Q], u[Q];
#pragma unroll
        for (int k = 0; k < Q; ++k) vc[k] = v[k * m + cl];
#pragma unroll
        for (int i = 0; i < Q; ++i) {
            T acc = vc[0] * lam[i][0];
#pragma unroll
            for (int k = 1; k <= i; ++k) acc = acc + vc[k] * lam[i][k];
            u[i] = acc;
        }
        T sg[NG], sa[Q][PB], sx[NT], sb[Q], sxz[PB], sdev = T(0);
#pragma unroll
        for (int i = 0; i < NG; ++i) sg[i] = T(0);
#pragma unroll
        for (int r = 0; r < Q; ++r) {
            sb[r] = T(0);
#pragma unroll
            for (int k = 0; k < PB; ++k) sa[r][k] = T(0);
        }
#pragma unroll
        for (int i = 0; i < NT; ++i) sx[i] = T(0);
#pragma unroll
        for (int i = 0; i < PB; ++i) sxz[i] = T(0);

        const Rows rw = rows_of(a, n, cl);
        int r = rw.first;
        for (int it = 0; it < rw.count; ++it, r += rw.step) {
            const float* row = src.base + r * src.rs;
            T x[PB], z[Q];
            if (want_a || step) {
#pragma unroll
                for (int k = 0; k < PB; ++k) x[k] = (k < p) ? (T)row[cols.x[k]] : T(0);
            }
            z[0] = T(1);
#pragma unroll
            for (int k = 1; k < Q; ++k) z[k] = (T)row[cols.z[k]];
            T w, s2;
            row_quant<Q, PB, T>(a, src, cols, r, p, kind, beta, u, w, s2);
            T wz[Q];
            wz[0] = w;
#pragma unroll
            for (int k = 1; k < Q; ++k) wz[k] = z[k] * w;
#pragma unroll
            for (int rr = 0; rr < Q; ++rr)
#pragma unroll
                for (int cc = 0; cc <= rr; ++cc) sg[tri(rr, cc)] = sg[tri(rr, cc)] + wz[rr] * z[cc];
            if (want_a) {
#pragma unroll
                for (int rr = 0; rr < Q; ++rr)
#pragma unroll
                    for (int k = 0; k < PB; ++k)
                        if (k < p) sa[rr][k] = sa[rr][k] + wz[rr] * x[k];
#pragma unroll
                for (int i = 0; i < PB; ++i) {
                    if (i < p) {
                        const T xw = x[i] * w;
#pragma unroll
                        for (int j = 0; j <= i; ++j) sx[tri(i, j)] = sx[tri(i, j)] + xw * x[j];
                    }
                }
            }
            if (want_b) {
#pragma unroll
                for (int rr = 0; rr < Q; ++rr) sb[rr] = sb[rr] + wz[rr] * s2;
                if (step) {
                    const T wzw = w * s2;
#pragma unroll
                    for (int k = 0; k < PB; ++k)
                        if (k < p) sxz[k] = sxz[k] + x[k] * wzw;
                }
            }
            if (want_dev) sdev = sdev + s2;
        }
        K10_ADD32(1, clk_rw);
        K10_T0(clk_c);

        // C = I + (Lam' G) Lam and its Cholesky
        T Gc[Q][Q];
#pragma unroll
        for (int rr = 0; rr < Q; ++rr)
#pragma unroll
            for (int cc = 0; cc <= rr; ++cc) Gc[rr][cc] = Gc[cc][rr] = sg[tri(rr, cc)];
        T LtG[Q][Q];
#pragma unroll
        for (int j = 0; j < Q; ++j) {
#pragma unroll
            for (int cc = 0; cc < Q; ++cc) {
                T acc = lam[j][j] * Gc[j][cc];
#pragma unroll
                for (int rr = j + 1; rr < Q; ++rr) acc = acc + lam[rr][j] * Gc[rr][cc];
                LtG[j][cc] = acc;
            }
        }
        T C[Q * Q], Lc[Q * Q];
#pragma unroll
        for (int j = 0; j < Q; ++j) {
#pragma unroll
            for (int k = 0; k < Q; ++k) {
                if (k <= j) {
                    T acc = LtG[j][k] * lam[k][k];
#pragma unroll
                    for (int rr = k + 1; rr < Q; ++rr) acc = acc + LtG[j][rr] * lam[rr][k];
                    C[j * Q + k] = (k == j) ? T(1) + acc : acc;
                } else {
                    C[j * Q + k] = T(0);
                }
            }
        }
        mcp::chol<Q, T>(C, Lc);
        if (want_dev) {
            T vv = vc[0] * vc[0];
#pragma unroll
            for (int k = 1; k < Q; ++k) vv = vv + vc[k] * vc[k];
            T ls = m_log(Lc[0]);
#pragma unroll
            for (int k = 1; k < Q; ++k) ls = ls + m_log(Lc[k * Q + k]);
            pdev = pdev + sdev;
            pvv = pvv + vv;
            pld = pld + T(2) * ls;
        }
        T solb[Q];
        if (want_b) {  // b~ = Lam' b and its solve
            T bt[Q];
#pragma unroll
            for (int rr = 0; rr < Q; ++rr) {
                T acc = lam[rr][rr] * sb[rr];
#pragma unroll
                for (int t = rr + 1; t < Q; ++t) acc = acc + lam[t][rr] * sb[t];
                bt[rr] = acc;
            }
            mcp::cho_solve<Q>(Lc, bt, solb);
#pragma unroll
            for (int k = 0; k < Q; ++k) {
                sol[k * m + cl] = solb[k];
                if (vstep) fin = fin && isfinite(solb[k]);
            }
        }
        if (want_a) {  // A~ = Lam' A column by column, its solve, the terms
            T solA[PB][Q];
#pragma unroll
            for (int aa = 0; aa < PB; ++aa) {
                if (aa < p) {
                    T At[Q];
#pragma unroll
                    for (int rr = 0; rr < Q; ++rr) {
                        T acc = lam[rr][rr] * sa[rr][aa];
#pragma unroll
                        for (int t = rr + 1; t < Q; ++t) acc = acc + lam[t][rr] * sa[t][aa];
                        At[rr] = acc;
                    }
                    mcp::cho_solve<Q>(Lc, At, solA[aa]);
#pragma unroll
                    for (int bb = 0; bb <= aa; ++bb) {
                        T acc = At[0] * solA[bb][0];
#pragma unroll
                        for (int rr = 1; rr < Q; ++rr) acc = acc + At[rr] * solA[bb][rr];
                        psxx[tri(aa, bb)] = psxx[tri(aa, bb)] + acc;
                    }
                    if (step) {
                        T xy = At[0] * solb[0];
#pragma unroll
                        for (int rr = 1; rr < Q; ++rr) xy = xy + At[rr] * solb[rr];
                        psxy[aa] = psxy[aa] + xy;
#pragma unroll
                        for (int rr = 0; rr < Q; ++rr) sol[(Q + aa * Q + rr) * m + cl] = solA[aa][rr];
                    }
                }
            }
#pragma unroll
            for (int i = 0; i < NT; ++i) pxx[i] = pxx[i] + sx[i];
            if (step) {
#pragma unroll
                for (int i = 0; i < PB; ++i) pxz[i] = pxz[i] + sxz[i];
            }
        }
        K10_ADD32(2, clk_c);
    }

    if (vstep) {
        const bool ok = __all_sync(FULL, fin);
        __syncwarp();
        if (ok) {
            for (int i = lane; i < Q * m; i += WARP) v[i] = sol[i];
        }
        __syncwarp();
        return T(0);
    }
    K10_T0(clk_w);
    T lap = T(0);
    if (want_dev && !want_a) {  // a tail: the deviance's three sums
        T d3[3] = {pdev, pvv, pld};
        warp_sums<3>(d3);
        K10_ADD32(3, clk_w);
        return (T(2) * d3[0] + d3[1]) + d3[2];
    }
    // the Schur system's sums (and, for the fit's mode, the deviance's)
    T L[NT], axy[PB];
    const T ridge = T(step && sizeof(T) == 4 ? 1e-6 : 1e-10);
    if constexpr (PB <= 4) {  // every sum through one butterfly
        // a step's X'WX, its Schur terms, X'Wz and theirs; the fit's mode
        // the first two and the deviance's three
        constexpr int o = 2 * NT;
        T sums[o + 2 * PB > o + 3 ? o + 2 * PB : o + 3];
#pragma unroll
        for (int i = 0; i < NT; ++i) {
            sums[i] = pxx[i];
            sums[NT + i] = psxx[i];
        }
        if (step) {
#pragma unroll
            for (int i = 0; i < PB; ++i) {
                sums[o + i] = pxz[i];
                sums[o + PB + i] = psxy[i];
            }
            warp_sums<o + 2 * PB>(sums);
        } else {
            sums[o] = pdev;
            sums[o + 1] = pvv;
            sums[o + 2] = pld;
            warp_sums<o + 3>(sums);
            lap = (T(2) * sums[o] + sums[o + 1]) + sums[o + 2];
        }
#pragma unroll
        for (int i = 0; i < PB; ++i) {
            if (i < p) {
#pragma unroll
                for (int j = 0; j <= i; ++j) {
                    const T sv = sums[tri(i, j)] - sums[NT + tri(i, j)];
                    L[tri(i, j)] = (i == j) ? sv + ridge : sv;
                }
                if (step) axy[i] = sums[o + i] - sums[o + PB + i];
            }
        }
    } else {  // a sum at a time (the wide buckets' registers)
        if (want_dev) lap = (T(2) * warp_sum(pdev) + warp_sum(pvv)) + warp_sum(pld);
#pragma unroll
        for (int i = 0; i < PB; ++i) {
            if (i < p) {
#pragma unroll
                for (int j = 0; j <= i; ++j) {
                    const T sv = warp_sum(pxx[tri(i, j)]) - warp_sum(psxx[tri(i, j)]);
                    L[tri(i, j)] = (i == j) ? sv + ridge : sv;
                }
                if (step) axy[i] = warp_sum(pxz[i]) - warp_sum(psxy[i]);
            }
        }
    }
    K10_ADD32(3, clk_w);
    K10_T0(clk_s);
    if (!step) {  // K_MODE: the f64 fit's Schur matrix
        if (lane == 0) {
#pragma unroll
            for (int i = 0; i < NT; ++i)
                if (i < p * (p + 1) / 2) axx[i] = (double)L[i];
        }
        __syncwarp();
        return lap;
    }
    T bn[PB];
    chol_packed_rt<PB>(L, p);
    cho_solve_packed_rt<PB>(L, axy, bn, p);
    bool ok = true;
#pragma unroll
    for (int i = 0; i < PB; ++i)
        if (i < p) ok = ok && isfinite(bn[i]);
    for (int cl = lane; cl < m; cl += WARP) {
#pragma unroll
        for (int rr = 0; rr < Q; ++rr) {
            T acc = sol[(Q + rr) * m + cl] * bn[0];
#pragma unroll
            for (int aa = 1; aa < PB; ++aa)
                if (aa < p) acc = acc + sol[(Q + aa * Q + rr) * m + cl] * bn[aa];
            const T vn = sol[rr * m + cl] - acc;
            sol[rr * m + cl] = vn;
            fin = fin && isfinite(vn);
        }
    }
    ok = __all_sync(FULL, fin) && ok;
    __syncwarp();
    if (ok) {
        for (int i = lane; i < Q * m; i += WARP) v[i] = sol[i];
        if (lane == 0) {
#pragma unroll
            for (int i = 0; i < PB; ++i)
                if (i < p) betaS[i] = bn[i];
        }
    }
    __syncwarp();
    K10_ADD32(4, clk_s);
    return T(0);
}

// `steps` passes of step_kind, then one of last_kind; its result.
template <int Q, int PB, typename T>
__device__ __forceinline__ T chain(const Args& a, const Src& src, int n, int lane, int steps,
                                   int step_kind, int last_kind, const T* lamS, T* betaS, T* v,
                                   T* sol, double* axx) {
    T out = T(0);
    for (int s = 0; s <= steps; ++s)
        out = slope_pass<Q, PB, T>(a, src, n, lane, s < steps ? step_kind : last_kind, lamS,
                                   betaS, v, sol, axx);
    return out;
}

// Lam = vech_to_lower(th * column mask) as T, row-major Q x Q; `zero_col`
// the Cholesky column zeroed, or -1.
template <int Q, typename T>
__device__ __forceinline__ void lower_of(const double* th, int zero_col, T* lam) {
    int k = 0;
    for (int j = 0; j < Q; ++j) {
        for (int i = 0; i < Q; ++i) {
            if (i >= j) {
                double x = th[k++];
                if (zero_col >= 0) x = x * ((j == zero_col) ? 0.0 : 1.0);
                lam[i * Q + j] = (T)x;
            } else {
                lam[i * Q + j] = T(0);
            }
        }
    }
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

// The kernel's variants: PB the p bucket and MINB the cells an SM its
// registers are held to (4 in the p-exact buckets: 128 a thread).
template <int Q, int PB, int MINB>
__global__ void __launch_bounds__(WARP * WARPS, MINB)
    glmm_slope_kernel(const __grid_constant__ Args a) {
    constexpr int D = Q * (Q + 1) / 2;
    extern __shared__ __align__(16) unsigned char k10_dyn[];
    __shared__ Shared S;
    const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP, t = threadIdx.x;
    K10_T0(clk_all);
    const long long cell = blockIdx.x;
    const long long sim = cell / a.G;
    const int n = a.grid[cell % a.G];
    const int m = a.m, p = a.pf;
    const bool shared = a.form == FORM_SHARED;
    double* base = a.scratch + cell * cell_doubles(m, Q, p);
    const long long wstride = (long long)Q * m * (p + 2);
    double* wb = base + warp * wstride;
    double* v64 = wb;
    double* sol64 = wb + Q * m;
    double* fin_v = base + WARPS * wstride + Q * m;
    float* stage = reinterpret_cast<float*>(k10_dyn);
    float* areas = stage + a.stage_floats;
    // warp g's f32 v and solves; the carried v
    auto v32_of = [&](int g) -> float* {
        return shared ? areas + (long long)g * a.area_floats
                      : reinterpret_cast<float*>(base + g * wstride);
    };
    float* v32 = v32_of(warp);
    float* sol32 = v32 + Q * m;
    float* carry_v = shared ? areas + WARPS * a.area_floats
                            : reinterpret_cast<float*>(base + WARPS * wstride);

    const float* Xs = a.X + sim * a.max_n * a.P;
    const float* ys = a.y + sim * a.max_n;
    Src src = shared ? Src{stage, stage + (p + Q - 1) * a.sld, 1, 1} : Src{Xs, ys, a.P, 0};
    if (shared) {  // the cell's rows below n, column-major, by cp.async
        const int ncol = p + Q;
        for (int e = t; e < ncol * n; e += WARP * WARPS) {
            const int c = e / n, r = e - c * n;
            const float* g = c < p ? Xs + (long long)r * a.P + a.fit[c]
                                   : (c < p + Q - 1 ? Xs + (long long)r * a.P + a.zc[c - p + 1]
                                                    : ys + r);
            __pipeline_memcpy_async(stage + c * a.sld + r, g, sizeof(float));
        }
        __pipeline_commit();
        __pipeline_wait_prior(0);
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

    // the initial simplex, four vertices a round, each from (beta0, 0)
    const int init_rounds = (D + 1 + WARPS - 1) / WARPS;
    for (int round = 0; round < init_rounds; ++round) {
        const int vtx = round * WARPS + warp;
        if (vtx <= D) {
            if (lane == 0) {
                lower_of<Q, float>(S.verts[vtx], -1, S.lam32[warp]);
                for (int k = 0; k < p; ++k) S.beta32[warp][k] = (float)a.beta0[k];
            }
            for (int i = lane; i < Q * m; i += WARP) v32[i] = 0.0f;
            __syncwarp();
            const float lap = chain<Q, PB, float>(a, src, n, lane, N_PIRLS_SLOPE, K_STEP, K_TAIL,
                                                  S.lam32[warp], S.beta32[warp], v32, sol32,
                                                  nullptr);
            if (lane == 0) S.fc[warp] = isfinite(lap) ? (double)lap : SENTINEL;
        }
        K10_T0(clk_b0);
        __syncthreads();
        K10_ADD(6, clk_b0);
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
            const float* sv = v32_of(S.src);
            for (int i = t; i < Q * m; i += WARP * WARPS) carry_v[i] = sv[i];
            if (t < p) S.carry_beta[t] = S.beta32[S.src][t];
        }
        __syncthreads();
    }

    // the search: four candidates from the carry, the accepted one's mode carried
    for (int it = 0; it < NM_ITERS; ++it) {
        const int budget = it < NM_FULL ? N_PIRLS_SLOPE : N_PIRLS_SLOPE_WARM;
        K10_T0(clk_n0);
        if (t == 0) mcp::nm_candidates(a.lower, S, D);
        K10_ADD(5, clk_n0);
        K10_T0(clk_b1);
        __syncthreads();
        K10_ADD(6, clk_b1);
        if (lane == 0) {
            lower_of<Q, float>(S.cand[warp], -1, S.lam32[warp]);
            for (int k = 0; k < p; ++k) S.beta32[warp][k] = S.carry_beta[k];
        }
        for (int i = lane; i < Q * m; i += WARP) v32[i] = carry_v[i];
        __syncwarp();
        const float lap = chain<Q, PB, float>(a, src, n, lane, budget, K_STEP, K_TAIL,
                                              S.lam32[warp], S.beta32[warp], v32, sol32, nullptr);
        if (lane == 0) S.fc[warp] = isfinite(lap) ? (double)lap : SENTINEL;
        K10_T0(clk_b2);
        __syncthreads();
        K10_ADD(6, clk_b2);
        K10_T0(clk_n1);
        if (t == 0) S.src = mcp::nm_select_and_replace(S, D);
        K10_ADD(5, clk_n1);
        K10_T0(clk_b3);
        __syncthreads();
        K10_ADD(6, clk_b3);
        {
            const float* sv = v32_of(S.src);
            for (int i = t; i < Q * m; i += WARP * WARPS) carry_v[i] = sv[i];
            if (t < p) S.carry_beta[t] = S.beta32[S.src][t];
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

    // the cold f64 fit at the optimum (warp 0); the outcome's row sum
    K10_T0(clk_d);
    if (warp == 0) {
        if (lane == 0) {
            lower_of<Q, double>(S.theta, -1, S.lam64[0]);
            for (int k = 0; k < p; ++k) S.beta64[0][k] = a.beta0[k];
        }
        for (int i = lane; i < Q * m; i += WARP) v64[i] = 0.0;
        __syncwarp();
        const double lap = chain<Q, PB, double>(a, src, n, lane, N_PIRLS, K_STEP, K_MODE,
                                                S.lam64[0], S.beta64[0], v64, sol64, S.axx);
        for (int i = lane; i < Q * m; i += WARP) fin_v[i] = v64[i];
        double ysum = 0.0;
        for (int cl = lane; cl < m; cl += WARP) {
            const Rows rw = rows_of(a, n, cl);
            double acc = 0.0;
            int r = rw.first;
            for (int i = 0; i < rw.count; ++i, r += rw.step) acc = acc + (double)src.y(r);
            ysum = ysum + acc;
        }
        ysum = warp_sum(ysum);
        if (lane == 0) {
            S.lap = lap;
            S.ysum = ysum;
            for (int k = 0; k < p; ++k) S.fin_beta[k] = S.beta64[0][k];
        }
    }
    __syncthreads();

    // the pin probes (warp j: component j), then the Hessian's stencil
    if (warp < Q) {
        if (lane == 0) {
            lower_of<Q, double>(S.theta, warp, S.lam64[warp]);
            for (int k = 0; k < p; ++k) S.beta64[warp][k] = S.fin_beta[k];
        }
        for (int i = lane; i < Q * m; i += WARP) v64[i] = fin_v[i];
        __syncwarp();
        const double pr = chain<Q, PB, double>(a, src, n, lane, N_PIRLS_SLOPE_WARM, K_STEP,
                                               K_TAIL, S.lam64[warp], S.beta64[warp], v64, sol64,
                                               nullptr);
        if (lane == 0) S.probe[warp] = pr;
    }
    K10_ADD(7, clk_d);
    const int nv = a.hessian ? 1 + 2 * p + 2 * p * (p - 1) : 0;
    K10_T0(clk_h);
    for (int e = warp; e < nv; e += WARPS) {
        __syncwarp();
        if (lane == 0) {
            lower_of<Q, double>(S.theta, -1, S.lam64[warp]);
            for (int k = 0; k < p; ++k) S.beta64[warp][k] = S.fin_beta[k] + stencil(e, k, p);
        }
        for (int i = lane; i < Q * m; i += WARP) v64[i] = fin_v[i];
        __syncwarp();
        const double hv = chain<Q, PB, double>(a, src, n, lane, N_V_PIRLS, K_VSTEP, K_TAIL,
                                               S.lam64[warp], S.beta64[warp], v64, sol64,
                                               nullptr);
        if (lane == 0) S.hv[e] = hv;
    }
    K10_ADD(8, clk_h);
    __syncthreads();
    K10_ADD(0, clk_all);

    if (t != 0) return;
    constexpr int NT = PB * (PB + 1) / 2;
    double L[NT], R[NT];
#pragma unroll
    for (int i = 0; i < NT; ++i) L[i] = R[i] = 0.0;
    for (int i = 0; i < p; ++i) {
        for (int j = 0; j <= i; ++j) {
            L[tri(i, j)] = S.axx[tri(i, j)];
            R[tri(i, j)] = (i == j) ? S.axx[tri(i, j)] - 1e-10 : S.axx[tri(i, j)];
        }
    }
    chol_packed_rt<PB>(L, p);
    chol_packed_rt<PB>(R, p);
    bool chol_ok = true, rank_ok = true, beta_ok = true;
    double lo = R[0], hi = R[0];
    for (int i = 0; i < p; ++i) {
        const double dl = L[tri(i, i)], dr = R[tri(i, i)];
        chol_ok = chol_ok && isfinite(dl) && (dl > 0.0);
        rank_ok = rank_ok && isfinite(dr) && (dr > 0.0);
        lo = fmin(lo, dr);
        hi = fmax(hi, dr);
        beta_ok = beta_ok && isfinite(S.fin_beta[i]);
    }
    rank_ok = rank_ok && (lo >= EPS_RANK * hi);
    double* cov = a.cov + cell * p * p;
    for (int j = 0; j < p; ++j) {
        double e[PB], col[PB];
#pragma unroll
        for (int i = 0; i < PB; ++i) e[i] = (i == j) ? 1.0 : 0.0;
        cho_solve_packed_rt<PB>(L, e, col, p);
        for (int i = 0; i < p; ++i) cov[i * p + j] = col[i];
    }
    if (a.hessian) {  // glmmfit._stencil_cov
        const double f0 = S.hv[0];
        double H[NT];
        for (int i = 0; i < p; ++i)
            H[tri(i, i)] = ((S.hv[1 + 2 * i] - 2.0 * f0) + S.hv[2 + 2 * i]) / (H_STEP * H_STEP);
        int k = 0;
        const int b = 1 + 2 * p;
        for (int i = 0; i < p; ++i) {
            for (int j = i + 1; j < p; ++j) {
                const double* hv = S.hv + b + 4 * k;
                H[tri(j, i)] = (((hv[0] - hv[1]) - hv[2]) + hv[3]) / (4.0 * H_STEP * H_STEP) + 0.0;
                ++k;
            }
        }
        for (int i = 0; i < p; ++i) H[tri(i, i)] = H[tri(i, i)] + 1e-10;
        chol_packed_rt<PB>(H, p);
        double ch[PB * PB];
        bool ok = true;
        for (int j = 0; j < p; ++j) {
            double e[PB], col[PB];
#pragma unroll
            for (int i = 0; i < PB; ++i) e[i] = (i == j) ? 1.0 : 0.0;
            cho_solve_packed_rt<PB>(H, e, col, p);
            for (int i = 0; i < p; ++i) {
                ch[i * p + j] = 2.0 * col[i];
                ok = ok && isfinite(ch[i * p + j]);
            }
        }
        if (ok)
            for (int i = 0; i < p * p; ++i) cov[i] = ch[i];
    }
    const bool converged = beta_ok && chol_ok && rank_ok && isfinite(S.lap);
    bool any_pin = false;
    for (int j = 0; j < Q; ++j) {
        const bool pj = S.probe[j] <= S.lap + PIN_MARGIN;
        a.pinned[cell * Q + j] = (uint8_t)pj;
        any_pin = any_pin || pj;
    }
    a.flags[cell] = (uint8_t)((converged ? 1 : 0) | (any_pin ? 2 : 0));
    a.tau2[cell] = S.theta[0] * S.theta[0];
    a.ybar[cell] = S.ysum / (double)n;
    for (int k = 0; k < p; ++k) a.beta[cell * p + k] = S.fin_beta[k];
    for (int k = 0; k < D; ++k) a.theta[cell * D + k] = S.theta[k];
}

// The launch's forced form (FORM_AUTO unless mcp_glmm_slope_set_form says
// otherwise: a measurement knob).
int g_form = FORM_AUTO;

// Dynamic shared memory of a launch (bytes): the stage, the four warps'
// areas and the carried v in the shared form; none streamed.
inline size_t dyn_bytes(const Args& a) {
    return a.form != FORM_STREAMED
               ? sizeof(float) * ((size_t)a.stage_floats + (size_t)WARPS * a.area_floats +
                                  (size_t)a.q * a.m)
               : 0;
}

// The form of a launch: the rows and the f32 state in shared memory where
// they fit (and g_form allows), else streamed. Sets a.form, a.sld,
// a.stage_floats and a.area_floats.
void place(Args& a) {
    a.sld = (a.max_n + 3) / 4 * 4;
    a.form = FORM_SHARED;
    a.stage_floats = (a.pf + a.q) * a.sld;
    a.area_floats = area_floats(a.m, a.q, a.pf);
    if (g_form == FORM_STREAMED ||
        dyn_bytes(a) + sizeof(Shared) > (size_t)MAX_SMEM_BYTES) {
        a.form = FORM_STREAMED;
        a.stage_floats = 0;
        a.area_floats = 0;
    }
}

template <int Q, int PB>
constexpr int minb_of() {
    return PB <= 4 ? 4 : 1;
}

// The kernel of (q, p) and its residency: cells an SM, registers and local
// (spill and stack) bytes a thread. Sets its shared-memory attribute.
template <int Q, int PB>
int kernel_info(const Args& a, int* per_sm, int* regs, int* local) {
    auto kernel = glmm_slope_kernel<Q, PB, minb_of<Q, PB>()>;
    const size_t smem = dyn_bytes(a);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes fa;
    if ((err = cudaFuncGetAttributes(&fa, kernel)) != cudaSuccess) return (int)err;
    *regs = fa.numRegs;
    *local = (int)fa.localSizeBytes;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, WARP * WARPS, smem);
}

template <int Q, int PB>
int launch(const Args& a, cudaStream_t stream) {
    const long long cells = (long long)a.sims * a.G;
    if (cells > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
    auto kernel = glmm_slope_kernel<Q, PB, minb_of<Q, PB>()>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn_bytes(a));
    if (err != cudaSuccess) return (int)err;
    glmm_slope_kernel<Q, PB, minb_of<Q, PB>()>
        <<<(unsigned)cells, WARP * WARPS, dyn_bytes(a), stream>>>(a);
    return (int)cudaGetLastError();
}

// (q, p) to its kernel: FN<Q, PB>(args...).
#define K10_DISPATCH(q, pf, FN, ...)                                           \
    switch (q) {                                                               \
        case 2: K10_DISPATCH_P(2, pf, FN, __VA_ARGS__)                         \
        case 3: K10_DISPATCH_P(3, pf, FN, __VA_ARGS__)                         \
        default: K10_DISPATCH_P(4, pf, FN, __VA_ARGS__)                        \
    }
#define K10_DISPATCH_P(Q, pf, FN, ...)                                         \
    if ((pf) == 2) return FN<Q, 2>(__VA_ARGS__);                               \
    if ((pf) == 3) return FN<Q, 3>(__VA_ARGS__);                               \
    if ((pf) == 4) return FN<Q, 4>(__VA_ARGS__);                               \
    if ((pf) <= 8) return FN<Q, 8>(__VA_ARGS__);                               \
    return FN<Q, 16>(__VA_ARGS__);

int launch_any(const Args& a, cudaStream_t stream) { K10_DISPATCH(a.q, a.pf, launch, a, stream) }

int info_any(const Args& a, int* per_sm, int* regs, int* local) {
    K10_DISPATCH(a.q, a.pf, kernel_info, a, per_sm, regs, local)
}

}  // namespace

// Bytes of device scratch a launch of `cells` cells takes.
extern "C" long long mcp_glmm_slope_scratch_bytes(long long cells, int m, int q, int p) {
    return cells * cell_doubles(m, q, p) * (long long)sizeof(double);
}

// Where later launches put the rows and the f32 state: 0 as the launcher
// picks (shared memory where they fit), 2 the streamed form (to check and
// time it against the shared one; both give the same bits).
extern "C" void mcp_glmm_slope_set_form(int form) { g_form = form; }

// The form a launch takes (mcp_glmm_slope's shape arguments): out[0] 1 the
// shared form (rows and f32 state in shared memory), 2 streamed; out[1]
// the dynamic and out[2] the static shared bytes a block; out[3] resident
// cells an SM; out[4] the launch's waves; out[5] registers and out[6] local
// (spill and stack) bytes a thread of its kernel; out[7] the p bucket; out[8]
// the cells an SM its registers are held to. Returns a cudaError_t.
extern "C" int mcp_glmm_slope_geometry(int sims, int max_n, int pf, int q, int G, int m,
                                       int* out) {
    if (sims <= 0 || G <= 0 || m <= 0 || q < 2 || q > MAX_Q || pf < 1 || pf > MAX_P ||
        max_n <= 0)
        return (int)cudaErrorInvalidValue;
    Args a;
    a.sims = sims;
    a.max_n = max_n;
    a.pf = pf;
    a.q = q;
    a.G = G;
    a.m = m;
    place(a);
    int per_sm = 0, regs = 0, local = 0, dev = 0, sms = 0, err;
    if ((err = info_any(a, &per_sm, &regs, &local))) return err;
    if ((err = (int)cudaGetDevice(&dev)) ||
        (err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))
        return err;
    const long long cells = (long long)sims * G, slots = (long long)(per_sm > 0 ? per_sm : 1) * sms;
    out[0] = a.form;
    out[1] = (int)dyn_bytes(a);
    out[2] = (int)sizeof(Shared);
    out[3] = per_sm;
    out[4] = (int)((cells + slots - 1) / slots);
    out[5] = regs;
    out[6] = local;
    out[7] = pf <= 4 ? pf : (pf <= 8 ? 8 : MAX_P);
    out[8] = pf <= 4 ? 4 : 1;
    return 0;
}

// X (sims, max_n, P), y (sims, max_n) f32 on the device; fit (pf,) and
// zcols (q - 1,) in host memory; grid (G,) int32 on the device, cell c at
// (sim c / G, point c % G); beta0 (pf,) f64 on the device; theta0, lower
// (d,) in host memory; scratch of mcp_glmm_slope_scratch_bytes. Writes beta
// (cells, pf), cov (cells, pf, pf), tau2, ybar (cells,) f64, flags (cells,)
// (bit 0 converged, bit 1 boundary), pinned (cells, q) uint8 and theta
// (cells, d) f64. Returns a cudaError_t.
extern "C" int mcp_glmm_slope(const void* X, const void* y, int sims, int max_n, int P,
                              const int* fit, int pf, const int* zcols, int q, const void* grid,
                              int G, int rr, int period, int m, int link, const void* beta0,
                              const double* theta0, const double* lower, int hessian,
                              void* scratch, void* beta, void* cov, void* tau2, void* ybar,
                              void* flags, void* pinned, void* theta, void* stream) {
    if (sims <= 0 || G <= 0 || m <= 0 || q < 2 || q > MAX_Q || pf < 1 || pf > MAX_P ||
        max_n <= 0 || P <= 0 || link < 0 || link > 2)
        return (int)cudaErrorInvalidValue;
    Args a;
    a.X = (const float*)X;
    a.y = (const float*)y;
    a.sims = sims;
    a.max_n = max_n;
    a.P = P;
    a.G = G;
    a.pf = pf;
    a.q = q;
    for (int k = 0; k < MAX_P; ++k) a.fit[k] = k < pf ? fit[k] : 0;
    a.zc[0] = 0;
    for (int k = 1; k < MAX_Q; ++k) a.zc[k] = k < q ? zcols[k - 1] : 0;
    a.grid = (const int*)grid;
    a.rr = rr;
    a.period = period;
    a.m = m;
    a.link = link;
    a.hessian = hessian;
    a.beta0 = (const double*)beta0;
    const int d = q * (q + 1) / 2;
    for (int k = 0; k < MAX_D; ++k) {
        a.theta0[k] = k < d ? theta0[k] : 0.0;
        a.lower[k] = k < d ? lower[k] : 0.0;
    }
    a.scratch = (double*)scratch;
    a.beta = (double*)beta;
    a.cov = (double*)cov;
    a.tau2 = (double*)tau2;
    a.ybar = (double*)ybar;
    a.theta = (double*)theta;
    a.flags = (uint8_t*)flags;
    a.pinned = (uint8_t*)pinned;
    place(a);
    return launch_any(a, (cudaStream_t)stream);
}

#ifdef MCP_K10_CLOCKS
extern "C" int mcp_k10_clocks(void* dst, int zero) {
    if (zero) {
        void* p = nullptr;
        int err = (int)cudaGetSymbolAddress(&p, mcp_k10_clk);
        return err ? err : (int)cudaMemset(p, 0, sizeof(mcp_k10_clk));
    }
    return (int)cudaMemcpyFromSymbol(dst, mcp_k10_clk, sizeof(mcp_k10_clk));
}
#endif
