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
// d + 1 + 4 x 140 f32 evaluations one after another and 1 f64 evaluation;
// each evaluation is a chain of O(n) dependent factor and solve steps (n =
// Me structured, M dense), each step a few operations a lane.
//
// The design, a first version: one warp a cell (a block of one warp), the
// candidates evaluated in turn. The n x n capacitance (or Schur complement)
// and the right-hand sides live in a work area: f32 in shared memory for the
// search, f64 in a device scratch (which the launcher allocates on the
// stream) for the refit, once a cell. Lanes take the entries of the panel
// and trailing updates, the rows of a factor column and the (row, column)
// pairs of the solves, with __syncwarp between dependent steps. The f32 twin
// of the cell's ztz and [zty | ztx] is cast once into shared memory before
// the search where it fits beside the work area (M^2 + M (p + 1) floats;
// else each f32 evaluation casts from device memory); a structured
// evaluation first forms a, Cpe, Cpe / a, rp, rp / a and re in the work
// area, which the Schur complement and the solves then read. The f64 refit
// reads the f64 statistics from device memory. Lane 0 runs the simplex
// between evaluations.

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
using mcp::jcap::vech;
using mcp::jcap::VEC_FROM;
using mcp::jcap::WARP;

constexpr int MAX_Q = 16;  // components over all groupings
constexpr float SENTINEL32 = 1e30f;
constexpr double JOINT_PIN = 1e-4;
constexpr int MAX_SMEM_BYTES = 227 * 1024;

struct Args {
    const double *ztz, *ztx, *zty, *xtx, *xty, *yty, *ns;
    int B, Gn, M, p, ng, d, nq, iters, structured, m1, Me, staged;
    int levels[MAX_G], comps[MAX_G], coff[MAX_G + 1], toff[MAX_G];
    double init_step, eps_rank;
    double theta0[MAX_D], lower[MAX_D];
    const double* theta_in;  // (B, d): fit here, no search; or null
    double *beta, *cov, *tau2, *theta_out;
    double* scratch;  // the f64 refit's work area, lay.total() doubles a cell
    uint8_t *flags, *pinned;
};

struct Simplex {
    double verts[MAX_D + 1][MAX_D];
    double fvals[MAX_D + 1];
    double cand[4][MAX_D];
    double fc[4];
    double theta[MAX_D];
    int ord[MAX_D + 1];
    // each column of the joint Z: its grouping, its component and its
    // level's first column (filled once a cell)
    int cbase[MAX_M];
    unsigned char cgrp[MAX_M], crr[MAX_M];
};

// The f32 twin of a cell's statistics, staged once before the search when
// it fits beside the work area: ztz (M, M), then [zty | ztx] (M, p + 1).
__host__ __device__ inline size_t twin_floats(int M, int p) {
    return (size_t)M * M + (size_t)M * (p + 1);
}

// ---------------------------------------------------------------------------
// One deviance evaluation at theta (shared memory, d doubles), in T.
// ---------------------------------------------------------------------------

// A statistic as T: from the staged f32 twin, else a cast of the f64 value.
template <typename T>
__device__ __forceinline__ T ld(const float* twin, long long i, const double* g64, long long j);
template <>
__device__ __forceinline__ float ld<float>(const float* twin, long long i, const double* g64,
                                           long long j) {
    return twin ? twin[i] : (float)g64[j];
}
template <>
__device__ __forceinline__ double ld<double>(const float*, long long, const double* g64,
                                             long long j) {
    return g64[j];
}

template <typename T>
struct Cell {
    const Args& a;
    long long cell;
    const double *Z, *ZX, *ZY;
    const float* twin;  // the f32 twin, or null

    __device__ T z(int i, int j) const {
        const long long k = (long long)i * a.M + j;
        return ld<T>(twin, k, Z, k);
    }
    __device__ T raw(int row, int c) const {  // [zty | ztx] (M, p + 1)
        const long long k = (long long)a.M * a.M + (long long)row * (a.p + 1) + c;
        return c == 0 ? ld<T>(twin, k, ZY, row)
                      : ld<T>(twin, k, ZX, (long long)row * a.p + (c - 1));
    }
};

template <typename T>
__device__ T evaluate(const Args& a, long long cell, const double* thd, T* sm, const Layout& lay,
                      const float* twin, const Simplex& S, int lane, T& sigma2) {
    const int M = a.M, p = a.p, r = lay.r;
    T* acc = sm + lay.acc();
    T* P = sm + lay.pmat();
    T* vec = sm + lay.vecs();  // a_xy (p), then beta (p), then theta (d)
    T* th = vec + 2 * MAX_P;
    for (int k = lane; k < a.d; k += WARP) th[k] = (T)thd[k];
    __syncwarp();
    const Cell<T> c{a, cell, a.ztz + cell * (long long)M * M, a.ztx + cell * (long long)M * p,
                    a.zty + cell * (long long)M, twin};
    const T logdet_v = capacitance(a, S, th, c, sm, lay, a.structured != 0, true, lane);
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
    return dev;
}

__global__ void __launch_bounds__(WARP) joint_reml_kernel(const Args a) {
    extern __shared__ __align__(16) unsigned char smem[];
    Simplex& S = *reinterpret_cast<Simplex*>(smem);
    unsigned char* work = smem + ((sizeof(Simplex) + 15) & ~(size_t)15);
    const int lane = threadIdx.x;
    const long long cell = blockIdx.x;
    const int D = a.d;
    const Layout lay = layout_of(a.structured, a.M, a.m1, a.Me, a.p);
    float* w32 = reinterpret_cast<float*>(work);
    float* twin = nullptr;
    if (a.staged) {  // the f32 twin of ztz and [zty | ztx], cast once
        twin = reinterpret_cast<float*>(work + sizeof(float) * lay.total());
        const int M = a.M, r = a.p + 1;
        const double* Z = a.ztz + cell * (long long)M * M;
        for (int e = lane; e < M * M; e += WARP) twin[e] = (float)Z[e];
        for (int e = lane; e < M * r; e += WARP) {
            const int row = e / r, cc = e % r;
            twin[M * M + e] = (float)(cc == 0 ? a.zty[cell * M + row]
                                              : a.ztx[(cell * M + row) * a.p + cc - 1]);
        }
    }
    for (int col = lane; col < a.M; col += WARP) {  // the column table
        int g = 0;
        while (g + 1 < a.ng && col >= a.coff[g + 1]) ++g;
        const int q = a.comps[g];
        S.cgrp[col] = (unsigned char)g;
        S.crr[col] = (unsigned char)((col - a.coff[g]) % q);
        S.cbase[col] = a.coff[g] + ((col - a.coff[g]) / q) * q;
    }
    if (a.theta_in) {  // fit at a given theta
        if (lane == 0)
            for (int k = 0; k < D; ++k) S.theta[k] = a.theta_in[cell * D + k];
        __syncwarp();
    } else {
        if (lane == 0) {
            for (int i = 0; i <= D; ++i) {
                for (int k = 0; k < D; ++k) {
                    const double x = a.theta0[k] + ((i > 0 && k == i - 1) ? a.init_step : 0.0);
                    S.verts[i][k] = (x < a.lower[k]) ? a.lower[k] : x;
                }
                S.ord[i] = i;
            }
        }
        __syncwarp();
        float s32;
        for (int v = 0; v <= D; ++v) {
            const float dv = evaluate<float>(a, cell, S.verts[v], w32, lay, twin, S, lane, s32);
            if (lane == 0) S.fvals[v] = isfinite(dv) ? (double)dv : (double)SENTINEL32;
            __syncwarp();
        }
        for (int it = 0; it < a.iters; ++it) {
            if (lane == 0) mcp::nm_candidates(a.lower, S, D);
            __syncwarp();
            for (int k = 0; k < 4; ++k) {
                const float dv = evaluate<float>(a, cell, S.cand[k], w32, lay, twin, S, lane, s32);
                if (lane == 0) S.fc[k] = isfinite(dv) ? (double)dv : (double)SENTINEL32;
                __syncwarp();
            }
            if (lane == 0) mcp::nm_select_and_replace(S, D);
            __syncwarp();
        }
        if (lane == 0) {  // the first position holding the least value
            int best = S.ord[0];
            for (int i = 1; i <= D; ++i)
                if (S.fvals[S.ord[i]] < S.fvals[best]) best = S.ord[i];
            for (int k = 0; k < D; ++k) S.theta[k] = S.verts[best][k];
        }
        __syncwarp();
    }
    // the f64 refit at the optimum
    double* w64 = a.scratch + cell * (long long)lay.total();
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
}

// Shared memory of a cell: the simplex, the f32 work area and, where
// staged, the twin.
size_t smem_bytes(const Args& a, bool staged) {
    const Layout lay = layout_of(a.structured, a.M, a.m1, a.Me, a.p);
    return ((sizeof(Simplex) + 15) & ~(size_t)15) + sizeof(float) * lay.total() +
           (staged ? sizeof(float) * twin_floats(a.M, a.p) : 0);
}

}  // namespace

// Shared memory one cell takes without its f32 twin (bytes), or -1 past
// K11's limits.
extern "C" long long mcp_joint_reml_smem(int M, int m1, int structured, int p) {
    if (M <= 0 || M > MAX_M || p < 1 || p > MAX_P || m1 <= 0 || m1 > M) return -1;
    Args a;
    a.M = M;
    a.m1 = m1;
    a.Me = M - m1;
    a.structured = structured;
    a.p = p;
    return (long long)smem_bytes(a, false);
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
    if (B <= 0 || Gn <= 0 || M <= 0 || M > MAX_M || p < 1 || p > MAX_P || ng < 2 ||
        ng > MAX_G || iters < 0)
        return (int)cudaErrorInvalidValue;
    Args a;
    a.ztz = (const double*)ztz;
    a.ztx = (const double*)ztx;
    a.zty = (const double*)zty;
    a.xtx = (const double*)xtx;
    a.xty = (const double*)xty;
    a.yty = (const double*)yty;
    a.ns = (const double*)ns;
    a.B = B;
    a.Gn = Gn;
    a.M = M;
    a.p = p;
    a.ng = ng;
    a.iters = iters;
    a.init_step = init_step;
    a.eps_rank = eps_rank;
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
    for (int k = 0; k < MAX_D; ++k) {
        a.theta0[k] = k < d ? theta0[k] : 0.0;
        a.lower[k] = k < d ? lower[k] : 0.0;
    }
    a.theta_in = (const double*)theta_in;
    a.beta = (double*)beta;
    a.cov = (double*)cov;
    a.tau2 = (double*)tau2;
    a.theta_out = (double*)theta_out;
    a.flags = (uint8_t*)flags;
    a.pinned = (uint8_t*)pinned;
    a.staged = smem_bytes(a, true) <= (size_t)MAX_SMEM_BYTES ? 1 : 0;
    const size_t smem = smem_bytes(a, a.staged);
    if (smem > (size_t)MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(joint_reml_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const Layout lay = layout_of(a.structured, a.M, a.m1, a.Me, a.p);
    const cudaStream_t st = (cudaStream_t)stream;
    if ((err = cudaMallocAsync((void**)&a.scratch, sizeof(double) * lay.total() * (size_t)B, st)) !=
        cudaSuccess)
        return (int)err;
    joint_reml_kernel<<<B, WARP, smem, st>>>(a);
    err = cudaGetLastError();
    const cudaError_t freed = cudaFreeAsync(a.scratch, st);
    return (int)(err != cudaSuccess ? err : freed);
}
