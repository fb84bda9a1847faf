// K11 joint_reml: the whole joint-Z REML fit of one (sim, grid) cell of an
// LMM with extra groupings (crossed or nested).
//
// Replaces: mcpower_tpu/engine/mixedfit.py::_joint_grid_stats.per_grid
// (:719-817) with _reml_quantities_joint (:588), _reml_quantities_joint_q1
// (:686) and its structured capacitance (_cap_factor_q1 :641,
// _cap_solve_cols_q1 :669, _cap_logdet_q1 :682), _lam_all (:556),
// mcpower_tpu/engine/smallchol.py's blocked chol_vec family (:149-305) and
// optim.nelder_mead (:61), which XLA fuses into one program per design. Per
// cell, from K2's joint statistics ztz (M, M), ztx (M, p), zty (M) and X'X,
// X'y, y'y (f64), with M = sum_g m_g q_g over the groupings (the primary
// first):
//   1. a shrink-free Nelder-Mead over theta (each grouping's vech chol of its
//      relative covariance, d <= 10) from the truth start, 140 iterations of
//      four candidates, on the f32 profiled REML deviance over f32 casts of
//      the statistics (a non-finite deviance ranks as f32(1e30));
//   2. the f64 refit at the optimum: beta, cov = sigma^2 (X'V^-1X)^-1,
//      tau^2 = Lam1[0][0]^2 sigma^2, a pin per component where its Cholesky
//      diagonal is below 1e-4, converged = finite deviance and beta,
//      sigma^2 > 0 and the pivot-ratio rank test.
// One deviance evaluation takes one of two forms:
// - structured (every grouping intercept-only, Lam = diag): a = 1 + l1^2
//   diag(G_PP) over the m1 primary levels, Cpe = (l1 G_PE) dE, the Me x Me
//   Schur complement S = (I + (dE dE') G_EE) - Cpe' (Cpe / a), its factor,
//   the p + 1 column solves t = re - Cpe' (rp / a), xe = S^-1 t, xp = rp / a
//   - (Cpe xe) / a, log|C| = sum log a + log|S|;
// - dense: C = I + Lam' ztz Lam with Lam = blockdiag(I_m (x) Lg), each entry
//   formed from its grouping blocks (never a dense Lam product), its blocked
//   factor and the blocked solve of [Lam' zty | Lam' ztx].
// Then X'V^-1X = X'X - At' sol (and X'V^-1y, y'V^-1y), its p x p factor,
// beta, rss and dev = (log|C| + log|X'V^-1X|) + (n - p) log(rss).
//
// The capacitance (both forms, its factor and solves) is joint_cap.cuh's,
// which K12 shares. Bit identity with the plain version
// (mixedfit.joint_reml_plain, with mixedfit.joint_capacitance,
// optim.nelder_mead and smallchol): every operation is the plain version's,
// in its order. Sums over primary levels, extras levels and capacitance rows
// run in ascending order from a zero; the factors follow smallchol's width
// rule (the scalar order below 13, the blocked order from 13; the dense C is
// always blocked): the scalar factor multiplies by the reciprocal pivot, the
// blocked one divides, the solves divide. The Nelder-Mead steps are
// nelder_mead.cuh's (K9's and K10's). Built with --fmad=false and libdevice's
// log and sqrt.
//
// What bounds it on H100: the dependency chain of one cell. A cell runs
// d + 1 + 4 x 140 f32 evaluations and 1 f64 evaluation; each evaluation is a
// chain of O(n) dependent factor and solve steps (n = Me structured, M
// dense), each step a few operations a lane.
//
// The design (redesigned for Hopper after the first version's cycle counts
// by region, chip_k11_profile.py; the first version ran the 565 evaluations
// on one warp in series):
// - one block of four warps a cell (two or one where four work areas do
//   not fit, or fit fewer cells an SM to no gain): warp g evaluates
//   candidate g of each Nelder-Mead iteration and vertices g, g + 4, ... of
//   the initial simplex, so a cell's chain is ceil((d + 1) / 4) + 140
//   rounds; thread 0 keeps the simplex in shared memory and runs the
//   selection and the next candidates between two barriers;
// - each warp has its f32 work area in dynamic shared memory (the n x n
//   capacitance or Schur complement packed by rows, its lower triangle
//   alone; its right-hand sides and solves; the p x p matrices at their
//   order p; a structured evaluation's a, Cpe, Cpe / a, rp, rp / a and re),
//   so that four cells fit an SM at every timed shape. Lanes take the
//   entries of the panel and trailing updates, the rows of a factor column
//   and the (row, column) pairs of the solves, with __syncwarp between
//   dependent steps; the factor and the forward solves two columns (rows) a
//   step, S in 2 x 2 blocks of entries a lane (joint_cap.cuh);
// - the f32 twin of the statistics, cast once by the block's threads and
//   read by its four warps: the structured form's only the entries it
//   reads (diag(G_PP), G_PE, G_EE's lower triangle, [zty | ztx]), the dense
//   form's ztz and [zty | ztx] whole; where staging it would hold fewer
//   cells an SM, each evaluation casts from device memory (through L2);
// - warp 0 runs the f64 refit once the search is over, its work area in
//   the four f32 areas' bytes; the statistics from device memory. No device
//   scratch;
// - the launcher picks the warps a cell and the twin's place for the
//   fewest candidate rounds over the launch's waves (mcp_joint_reml_geometry
//   reports it); registers are held to 128 a thread, four cells an SM.

#include "common.cuh"
#include "joint_cap.cuh"
#include "nelder_mead.cuh"

namespace {

using mcp::jcap::capacitance;
using mcp::jcap::cho_solve_auto;
using mcp::jcap::chol_auto;
using mcp::jcap::Layout;
using mcp::jcap::layout_of;
using mcp::jcap::logdet_ordered;
using mcp::jcap::MAX_D;
using mcp::jcap::MAX_G;
using mcp::jcap::MAX_M;
using mcp::jcap::MAX_P;
using mcp::jcap::tri_row;
using mcp::jcap::vech;
using mcp::jcap::VEC_FROM;
using mcp::jcap::WARP;

constexpr int WARPS = 4;   // the most warps a cell: the four candidates
constexpr int MIN_CELLS = 4;  // cells an SM the registers are held to (128 a thread)
constexpr int MAX_Q = 16;  // components over all groupings
constexpr float SENTINEL32 = 1e30f;
constexpr double JOINT_PIN = 1e-4;
constexpr int MAX_SMEM_BYTES = 227 * 1024;

struct Args {
    const double *ztz, *ztx, *zty, *xtx, *xty, *yty, *ns;
    int B, Gn, M, p, ng, d, nq, iters, structured, m1, Me;
    int staged;          // the f32 twin in shared memory (else casts from device memory)
    int tw_ee, tw_raw;   // the twin's G_EE and [zty | ztx] offsets (floats)
    int levels[MAX_G], comps[MAX_G], coff[MAX_G + 1], toff[MAX_G];
    double init_step, eps_rank;
    double theta0[MAX_D], lower[MAX_D];
    const double* theta_in;  // (B, d): fit here, no search; or null
    double *beta, *cov, *tau2, *theta_out;
    uint8_t *flags, *pinned;
};

struct Simplex {
    double verts[MAX_D + 1][MAX_D];
    double fvals[MAX_D + 1];
    double cand[WARPS][MAX_D];
    double fc[WARPS];
    double theta[MAX_D];
    int ord[MAX_D + 1];
    // each column of the joint Z: its grouping, its component and its
    // level's first column (filled once a cell)
    int cbase[MAX_M];
    unsigned char cgrp[MAX_M], crr[MAX_M];
};

// The f32 twin's floats: structured, diag(G_PP) (m1), G_PE (m1 x Me), G_EE's
// lower triangle (Me (Me + 1) / 2) and [zty | ztx] (M x (p + 1)); dense, ztz
// (M x M) and [zty | ztx].
__host__ __device__ inline int twin_floats(int structured, int M, int m1, int Me, int p) {
    return (structured ? m1 + m1 * Me + Me * (Me + 1) / 2 : M * M) + M * (p + 1);
}

// A cell's f32 work areas: one a warp, the factor packed by rows (its lower
// triangle alone), the p x p matrices at order p.
__host__ __device__ inline Layout area_of(const Args& a) {
    return layout_of(a.structured, a.M, a.m1, a.Me, a.p, a.p, 1);
}

// ---------------------------------------------------------------------------
// One deviance evaluation at theta (shared memory, d doubles), in T.
// ---------------------------------------------------------------------------

// A statistic as T: the staged f32 twin's entry i, else a cast of the f64
// value g64[j].
template <typename T>
__device__ __forceinline__ T ld(const float* twin, int i, const double* g64, long long j);
template <>
__device__ __forceinline__ float ld<float>(const float* twin, int i, const double* g64,
                                           long long j) {
    return twin ? twin[i] : (float)g64[j];
}
template <>
__device__ __forceinline__ double ld<double>(const float*, int, const double* g64, long long j) {
    return g64[j];
}

template <typename T>
struct Cell {
    const Args& a;
    const double *Z, *ZX, *ZY;
    const float* twin;  // the f32 twin, or null

    // ztz[i][j]; the structured form reads diag(G_PP), G_PE and G_EE's lower
    // triangle alone
    __device__ T z(int i, int j) const {
        int k = i * a.M + j;
        if (a.structured) {
            const int m1 = a.m1;
            if (i < m1) k = (j < m1) ? i : m1 + i * a.Me + (j - m1);
            else k = a.tw_ee + (i - m1) * (i - m1 + 1) / 2 + (j - m1);
        }
        return ld<T>(twin, k, Z, (long long)i * a.M + j);
    }
    __device__ T raw(int row, int c) const {  // [zty | ztx] (M, p + 1)
        const int k = a.tw_raw + row * (a.p + 1) + c;
        return c == 0 ? ld<T>(twin, k, ZY, row)
                      : ld<T>(twin, k, ZX, (long long)row * a.p + (c - 1));
    }
};

template <typename T>
__device__ __noinline__ T evaluate(const Args& a, long long cell, const double* thd, T* sm,
                                   const Layout& lay, const float* twin, const Simplex& S,
                                   int lane, T& sigma2) {
    const int M = a.M, p = a.p, r = lay.r;
    T* acc = sm + lay.acc();
    T* P = sm + lay.pmat();
    T* vec = sm + lay.vecs();  // a_xy (p), then beta (p), then theta (d)
    T* th = vec + 2 * MAX_P;
    for (int k = lane; k < a.d; k += WARP) th[k] = (T)thd[k];
    __syncwarp();
    const Cell<T> c{a, a.ztz + cell * (long long)M * M, a.ztx + cell * (long long)M * p,
                    a.zty + cell * (long long)M, twin};
    const T logdet_v = capacitance<true>(a, S, th, c, sm, lay, a.structured != 0, true, lane);
    K12_T0(clk_t);
    // X'V^-1X, X'V^-1y, y'V^-1y, the p x p factor, beta, rss, the deviance
    const double* xtx = a.xtx + cell * p * p;
    for (int e = lane; e < p * p; e += WARP)
        P[e] = (T)xtx[e] - acc[(1 + e / p) * r + 1 + e % p];
    for (int i = lane; i < p; i += WARP) {
        const T axy = (T)a.xty[cell * p + i] - acc[(1 + i) * r];
        vec[i] = axy;
        vec[MAX_P + i] = axy;
    }
    const T ayy = (T)a.yty[cell] - acc[0];
    __syncwarp();
    const bool pb = p >= VEC_FROM;
    chol_auto(P, p, pb, lane);
    cho_solve_auto(P, vec + MAX_P, p, 1, pb, lane);
    T bxy = vec[MAX_P] * vec[0];
    for (int i = 1; i < p; ++i) bxy = bxy + vec[MAX_P + i] * vec[i];
    const T rss = ayy - bxy;
    const T df = (T)a.ns[cell % a.Gn] - (T)p;
    sigma2 = rss / df;
    const T dev = (logdet_v + logdet_ordered(P, p)) + df * log(rss);
    __syncwarp();
    K12_ADD32(2, clk_t);
    return dev;
}

// The twin of the cell's statistics, cast once by the block's threads.
__device__ void stage_twin(const Args& a, long long cell, float* twin, int t, int nt) {
    const int M = a.M, m1 = a.m1, Me = a.Me, r = a.p + 1;
    const double* Z = a.ztz + cell * (long long)M * M;
    if (a.structured) {
        for (int e = t; e < m1; e += nt) twin[e] = (float)Z[e * M + e];
        for (int e = t; e < m1 * Me; e += nt) twin[m1 + e] = (float)Z[(e / Me) * M + m1 + e % Me];
        for (int e = t; e < Me * (Me + 1) / 2; e += nt) {
            const int e1 = tri_row(e), e2 = e - e1 * (e1 + 1) / 2;
            twin[a.tw_ee + e] = (float)Z[(m1 + e1) * M + m1 + e2];
        }
    } else {
        for (int e = t; e < M * M; e += nt) twin[e] = (float)Z[e];
    }
    for (int e = t; e < M * r; e += nt) {
        const int row = e / r, cc = e % r;
        twin[a.tw_raw + e] = (float)(cc == 0 ? a.zty[cell * M + row]
                                             : a.ztx[(cell * M + row) * a.p + cc - 1]);
    }
}

__global__ void __launch_bounds__(WARP * WARPS, MIN_CELLS)
    joint_reml_kernel(const __grid_constant__ Args a) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ Simplex S;
    const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP, t = threadIdx.x;
    const int nw = blockDim.x / WARP;  // the cell's warps: 4, 2 or 1
    const long long cell = blockIdx.x;
    const int D = a.d;
    K12_T0(clk_all);
    const Layout lay = area_of(a);
    float* w32 = reinterpret_cast<float*>(smem) + (size_t)warp * lay.total();
    float* twin = a.staged ? reinterpret_cast<float*>(smem) + (size_t)nw * lay.total() : nullptr;
    K12_T0(clk_tw);
    if (twin) stage_twin(a, cell, twin, t, blockDim.x);
    for (int col = t; col < a.M; col += blockDim.x) {  // the column table
        int g = 0;
        while (g + 1 < a.ng && col >= a.coff[g + 1]) ++g;
        const int q = a.comps[g];
        S.cgrp[col] = (unsigned char)g;
        S.crr[col] = (unsigned char)((col - a.coff[g]) % q);
        S.cbase[col] = a.coff[g] + ((col - a.coff[g]) / q) * q;
    }
    if (a.theta_in) {  // fit at a given theta
        if (t < D) S.theta[t] = a.theta_in[cell * D + t];
    } else if (t == 0) {
        for (int i = 0; i <= D; ++i) {
            for (int k = 0; k < D; ++k) {
                const double x = a.theta0[k] + ((i > 0 && k == i - 1) ? a.init_step : 0.0);
                S.verts[i][k] = (x < a.lower[k]) ? a.lower[k] : x;
            }
            S.ord[i] = i;
        }
    }
    __syncthreads();
    K12_ADD(3, clk_tw);
    if (!a.theta_in) {
        float s32;
        for (int v = warp; v <= D; v += nw) {  // the initial simplex, a vertex a warp
            const float dv = evaluate<float>(a, cell, S.verts[v], w32, lay, twin, S, lane, s32);
            if (lane == 0) S.fvals[v] = isfinite(dv) ? (double)dv : (double)SENTINEL32;
        }
        K12_T0(clk_b0);
        __syncthreads();
        K12_ADD(7, clk_b0);
        K12_T0(clk_n0);
        if (t == 0 && a.iters > 0) mcp::nm_candidates(a.lower, S, D);
        __syncthreads();
        K12_ADD(6, clk_n0);
        for (int it = 0; it < a.iters; ++it) {
            for (int k = warp; k < 4; k += nw) {  // the four candidates, a warp each
                const float dv = evaluate<float>(a, cell, S.cand[k], w32, lay, twin, S, lane, s32);
                if (lane == 0) S.fc[k] = isfinite(dv) ? (double)dv : (double)SENTINEL32;
            }
            K12_T0(clk_b1);
            __syncthreads();
            K12_ADD(7, clk_b1);
            K12_T0(clk_n1);
            if (t == 0) {  // the selection, then the next iteration's candidates
                mcp::nm_select_and_replace(S, D);
                if (it + 1 < a.iters) mcp::nm_candidates(a.lower, S, D);
            }
            __syncthreads();
            K12_ADD(6, clk_n1);
        }
        if (t == 0) {  // the first position holding the least value
            int best = S.ord[0];
            for (int i = 1; i <= D; ++i)
                if (S.fvals[S.ord[i]] < S.fvals[best]) best = S.ord[i];
            for (int k = 0; k < D; ++k) S.theta[k] = S.verts[best][k];
        }
        __syncthreads();
    }
    if (warp != 0) {
        K12_ADD(0, clk_all);
        return;
    }
    // the f64 refit at the optimum, in the f32 areas' bytes
    K12_T0(clk_r);
    double* w64 = reinterpret_cast<double*>(smem);
    double sigma2;
    const double dev = evaluate<double>(a, cell, S.theta, w64, lay, nullptr, S, lane, sigma2);
    const int p = a.p;
    double* P = w64 + lay.pmat();
    double* inv = w64 + lay.pinv();
    const double* beta = w64 + lay.vecs() + MAX_P;
    for (int e = lane; e < p * p; e += WARP) inv[e] = (e / p == e % p) ? 1.0 : 0.0;
    __syncwarp();
    cho_solve_auto(P, inv, p, p, p >= VEC_FROM, lane);
    for (int e = lane; e < p * p; e += WARP) a.cov[cell * p * p + e] = sigma2 * inv[e];
    for (int i = lane; i < p; i += WARP) a.beta[cell * p + i] = beta[i];
    if (lane == 0) {
        bool ok = isfinite(dev) && (sigma2 > 0.0);
        double lo = P[0], hi = P[0];
        for (int i = 0; i < p; ++i) {
            ok = ok && isfinite(beta[i]);
            const double dg = P[i * p + i];
            ok = ok && isfinite(dg) && (dg > 0.0);
            lo = fmin(lo, dg);
            hi = fmax(hi, dg);
        }
        ok = ok && (lo >= a.eps_rank * hi);
        bool any_pin = false;
        int k = 0;
        for (int g = 0; g < a.ng; ++g) {
            const int q = a.comps[g];
            for (int j = 0; j < q; ++j) {
                const bool pin = S.theta[a.toff[g] + vech(j, j, q)] < JOINT_PIN;
                a.pinned[cell * a.nq + k++] = (uint8_t)pin;
                any_pin = any_pin || pin;
            }
        }
        a.flags[cell] = (uint8_t)((ok ? 1 : 0) | (any_pin ? 2 : 0));
        const double l00 = S.theta[0];
        a.tau2[cell] = (l00 * l00) * sigma2;
        if (a.theta_out)
            for (int k = 0; k < D; ++k) a.theta_out[cell * D + k] = S.theta[k];
    }
    K12_ADD(8, clk_r);
    K12_ADD(0, clk_all);
}

// Dynamic shared memory of a block of `warps` warps (bytes): their f32
// areas and, where staged, the twin. The f64 refit's area (the same layout
// in doubles) fits in the areas of two warps; one warp's block is sized for
// it.
size_t dyn_bytes(const Args& a, int warps, bool staged) {
    const size_t area = area_of(a).total();
    return sizeof(float) * ((size_t)(warps < 2 ? 2 : warps) * area +
                            (staged ? (size_t)twin_floats(a.structured, a.M, a.m1, a.Me, a.p)
                                    : 0));
}

// The plan of a launch from the C arguments; a cudaError_t.
int make_args(Args& a, int B, int M, int p, int ng, const int* levels, const int* comps,
              int force_dense) {
    if (B <= 0 || M <= 0 || M > MAX_M || p < 1 || p > MAX_P || ng < 2 || ng > MAX_G)
        return (int)cudaErrorInvalidValue;
    a.B = B;
    a.M = M;
    a.p = p;
    a.ng = ng;
    int col = 0, d = 0, nq = 0;
    bool all_q1 = true;
    for (int g = 0; g < ng; ++g) {
        if (levels[g] <= 0 || comps[g] <= 0) return (int)cudaErrorInvalidValue;
        a.levels[g] = levels[g];
        a.comps[g] = comps[g];
        a.coff[g] = col;
        a.toff[g] = d;
        col += levels[g] * comps[g];
        d += comps[g] * (comps[g] + 1) / 2;
        nq += comps[g];
        all_q1 = all_q1 && comps[g] == 1;
    }
    a.coff[ng] = col;
    if (col != M || d > MAX_D || nq > MAX_Q) return (int)cudaErrorInvalidValue;
    a.d = d;
    a.nq = nq;
    a.structured = (all_q1 && !force_dense) ? 1 : 0;
    a.m1 = levels[0];
    a.Me = M - levels[0];
    a.tw_ee = a.m1 + a.m1 * a.Me;
    a.tw_raw = a.structured ? a.tw_ee + a.Me * (a.Me + 1) / 2 : M * M;
    a.staged = 0;
    return 0;
}

// Where the launch puts the twin and how many warps a cell takes: of the
// forms that fit (4, 2 or 1 warps; the twin staged or not), the one with
// the fewest candidate rounds over the launch's waves (4 / warps rounds an
// iteration), the more warps and then the staged twin on a tie. Sets
// a.staged and the kernel's shared-memory attribute; *warps, *per_sm (cells
// resident an SM) and *waves.
int place(Args& a, int* warps, int* per_sm, int* waves) {
    int dev = 0, sms = 0, err;
    if ((err = (int)cudaGetDevice(&dev)) || (err = (int)cudaDeviceGetAttribute(
                                                 &sms, cudaDevAttrMultiProcessorCount, dev)))
        return err;
    long long best = -1;
    int bw = 0, bs = 0, bc = 0, bv = 0;
    for (int w = WARPS; w >= 1; w /= 2) {
        for (int staged = 1; staged >= 0; --staged) {
            const size_t smem = dyn_bytes(a, w, staged != 0);
            if (smem > (size_t)MAX_SMEM_BYTES) continue;
            if ((err = (int)cudaFuncSetAttribute(joint_reml_kernel,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem)))
                return err;
            int cells = 0;
            if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &cells, joint_reml_kernel, WARP * w, smem)))
                return err;
            if (cells <= 0) continue;
            const long long wv = ((long long)a.B + (long long)cells * sms - 1) / ((long long)cells * sms);
            const long long rounds = wv * (WARPS / w);
            if (best < 0 || rounds < best) {
                best = rounds;
                bw = w;
                bs = staged;
                bc = cells;
                bv = (int)wv;
            }
        }
    }
    if (best < 0) return (int)cudaErrorInvalidValue;
    a.staged = bs;
    *warps = bw;
    *per_sm = bc;
    *waves = bv;
    return (int)cudaFuncSetAttribute(joint_reml_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)dyn_bytes(a, bw, bs != 0));
}

}  // namespace

// The form a launch of `B` cells takes (mcp_joint_reml's plan arguments):
// out[0] 1 structured (else dense), out[1] warps a cell, out[2] 1 where the
// f32 twin is staged in shared memory, out[3] the dynamic and out[4] the
// static shared bytes a block, out[5] resident cells an SM, out[6] the
// launch's waves, out[7] the twin's bytes, out[8] the kernel's registers and
// out[9] its local (spill and stack) bytes a thread. Returns a cudaError_t.
extern "C" int mcp_joint_reml_geometry(int B, int M, int p, int ng, const int* levels,
                                       const int* comps, int force_dense, int* out) {
    Args a;
    int err = make_args(a, B, M, p, ng, levels, comps, force_dense);
    if (err) return err;
    int warps = 0, per_sm = 0, waves = 0;
    if ((err = place(a, &warps, &per_sm, &waves))) return err;
    out[0] = a.structured;
    out[1] = warps;
    out[2] = a.staged;
    out[3] = (int)dyn_bytes(a, warps, a.staged != 0);
    out[4] = (int)sizeof(Simplex);
    out[5] = per_sm;
    out[6] = waves;
    out[7] = (int)(sizeof(float) * twin_floats(a.structured, a.M, a.m1, a.Me, a.p));
    cudaFuncAttributes fa;
    if ((err = (int)cudaFuncGetAttributes(&fa, joint_reml_kernel))) return err;
    out[8] = fa.numRegs;
    out[9] = (int)fa.localSizeBytes;
    return 0;
}

// ztz (B, M, M), ztx (B, M, p), zty (B, M), xtx (B, p, p), xty (B, p), yty
// (B,) f64 on the device; ns (Gn,) the grid's row counts, cell c at
// ns[c % Gn]; levels and comps: m_g and q_g per grouping (the primary
// first); theta0 and lower (d,) in host memory. force_dense takes the dense
// capacitance for an all-intercept plan too; theta_in (B, d), where not
// null, replaces the search by a fit at the given theta. Writes beta (B, p),
// cov (B, p, p), tau2 (B,), flags (B,) (bit 0 converged, bit 1 boundary),
// pinned (B, sum q_g) and, where not null, theta_out (B, d). Returns a
// cudaError_t.
extern "C" int mcp_joint_reml(const void* ztz, const void* ztx, const void* zty, const void* xtx,
                              const void* xty, const void* yty, const void* ns, int B, int Gn,
                              int M, int p, int ng, const int* levels, const int* comps,
                              const double* theta0, const double* lower, int iters,
                              double init_step, double eps_rank, int force_dense,
                              const void* theta_in, void* beta, void* cov, void* tau2,
                              void* flags, void* pinned, void* theta_out, void* stream) {
    if (Gn <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
    Args a;
    int err = make_args(a, B, M, p, ng, levels, comps, force_dense);
    if (err) return err;
    a.ztz = (const double*)ztz;
    a.ztx = (const double*)ztx;
    a.zty = (const double*)zty;
    a.xtx = (const double*)xtx;
    a.xty = (const double*)xty;
    a.yty = (const double*)yty;
    a.ns = (const double*)ns;
    a.Gn = Gn;
    a.iters = iters;
    a.init_step = init_step;
    a.eps_rank = eps_rank;
    for (int k = 0; k < MAX_D; ++k) {
        a.theta0[k] = k < a.d ? theta0[k] : 0.0;
        a.lower[k] = k < a.d ? lower[k] : 0.0;
    }
    a.theta_in = (const double*)theta_in;
    a.beta = (double*)beta;
    a.cov = (double*)cov;
    a.tau2 = (double*)tau2;
    a.theta_out = (double*)theta_out;
    a.flags = (uint8_t*)flags;
    a.pinned = (uint8_t*)pinned;
    int warps = 0, per_sm = 0, waves = 0;
    if ((err = place(a, &warps, &per_sm, &waves))) return err;
    joint_reml_kernel<<<B, WARP * warps, dyn_bytes(a, warps, a.staged != 0), (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

#ifdef MCP_K11_CLOCKS
extern "C" int mcp_k11_clocks(void* dst, int zero) {
    if (zero) {
        void* p = nullptr;
        int err = (int)cudaGetSymbolAddress(&p, mcp_k12_clk);
        return err ? err : (int)cudaMemset(p, 0, sizeof(mcp_k12_clk));
    }
    return (int)cudaMemcpyFromSymbol(dst, mcp_k12_clk, sizeof(mcp_k12_clk));
}
#endif
