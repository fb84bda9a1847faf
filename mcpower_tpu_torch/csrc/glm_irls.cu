// K6 glm_irls: batched two-phase IRLS for unclustered GLMs (logit, probit,
// Poisson-log), one warp per (sim, grid) cell.
//
// Replaces: mcpower_tpu/engine/glmfit.py::_irls (:82) as glm_grid_stats
// (:193) calls it per grid point, with the data-intercept start, the null
// deviance and the realized outcome mean of the same function. For each
// cell, on the rows below its grid point: 30 IRLS steps with f32 state
// (N_IRLS_ITERS), then 4 f64 Newton steps (N_IRLS_POLISH); ridges 1e-10 I +
// diag(pin) in f64 and that plus 1e-6 I in f32; the clip at BETA_CAP; a cell
// freezes on done | ~ok; then in f64 the unridged information X'WX, the
// covariance (X'WX + ridge)^-1, the deviance, the pivot-ratio rank probe on
// X'WX + diag(pin), converged = done & finite & ~at_cap & rank_ok, and the
// intercept-only deviance and mean of y.
//
// What bounds it on H100: f32 and f64 instructions, not bytes. A cell reads
// its sim's rows (N x P f32, 4.8 KB at the GLM arm's N = 300, p = 4) once
// from device memory and again from L1/L2 at every step; each step costs per
// row the linear predictor, a transcendental or two (exp, erf) and p (p + 3)
// / 2 multiply-adds, and per cell a p x p Cholesky solve. The chip_smoke
// bound counts the steps the cells actually run.
//
// What the design does about it:
// - one warp per cell, four warps a block in cell order, so the G cells of
//   a sim sit in neighbouring warps and share its rows through L1/L2; the
//   grid is a device array (any G), the fit columns a by-value table;
// - each lane takes every 32nd row of the cell and accumulates the lower
//   triangle of X'WX and X'Wz in the phase's type in registers; the lanes
//   combine by a fixed __shfl_xor butterfly (16, 8, 4, 2, 1), so every lane
//   holds the same sums, in the same order on every run, and solves the
//   p x p system itself (smallchol.cuh, templated on the scalar type) with
//   no shared memory or barrier;
// - a cell leaves a phase at the step after which its state no longer
//   changes: once done holds, the reference freezes beta and done for the
//   remaining steps; once a step is not finite (~ok) with done false, beta
//   is kept and the next step recomputes the same non-finite step, so the
//   state is a fixed point as well. Leaving the loop there gives the
//   reference's result; a typical cell runs about 5 f32 and 2 f64 steps of
//   the 34.
//
// The plain version (engine/glmfit.py::glm_irls_plain) sums rows in this
// kernel's lane order and performs the same operations in the same order;
// the file is built with --fmad=false so that no multiply-add is
// contracted. The link is a runtime argument, uniform across a launch, so
// the instantiations stay at p = 1..16.

#include "common.cuh"
#include "smallchol.cuh"

#define MCP_MAX_P 16

namespace {

constexpr int WARP = 32;
constexpr int WARPS_PER_BLOCK = 4;
constexpr int N_IRLS_ITERS = 30;
constexpr int N_IRLS_POLISH = 4;
constexpr double BETA_CAP = 30.0;
constexpr double CONV_TOL = 1e-8;
constexpr double CONV_TOL_F32 = 1e-5;
constexpr double MU_EPS = 1e-10;
constexpr double EPS_RANK = 1e-6;  // pivot-ratio rank rule (smallchol.py's)
constexpr double INV_SQRT2 = 0.7071067811865476;
constexpr double INV_SQRT_2PI = 0.3989422804014327;
enum { LINK_LOGIT = 0, LINK_PROBIT = 1, LINK_POISSON = 2 };

struct Args {
    const float* X;
    const float* y;
    int sims, max_n, P, G, link;
    const int* grid;        // (G,) device
    const double* beta0;    // (sims * G, pf)
    const double* colmask;  // (G, pf)
    double *beta, *cov, *dev, *dev0, *ybar;
    uint8_t* converged;
    int* iters;  // (sims * G, 2) or null
};

struct Cols {
    int fit[MCP_MAX_P];
};

__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_exp(double x) { return exp(x); }
__device__ __forceinline__ float m_erf(float x) { return erff(x); }
__device__ __forceinline__ double m_erf(double x) { return erf(x); }

// torch.clamp's one-sided bounds: a NaN stays NaN.
template <typename T>
__device__ __forceinline__ T clamp_lo(T x, T lo) { return x < lo ? lo : x; }
template <typename T>
__device__ __forceinline__ T clamp_hi(T x, T hi) { return x > hi ? hi : x; }

// Mean, variance and d mu / d eta in T (glmfit.py::_mu_var_dmu).
template <typename T>
__device__ __forceinline__ void mu_var_dmu(int link, T eta, T& mu, T& var, T& dmu) {
    const T eps = T(MU_EPS), top = T(1.0 - MU_EPS);
    if (link == LINK_PROBIT) {
        mu = clamp_hi(clamp_lo(T(0.5) * (T(1) + m_erf(eta * T(INV_SQRT2))), eps), top);
        var = mu * (T(1) - mu);
        dmu = clamp_lo(m_exp(T(-0.5) * eta * eta) * T(INV_SQRT_2PI), eps);
    } else if (link == LINK_LOGIT) {
        mu = clamp_hi(clamp_lo(T(1) / (T(1) + m_exp(-eta)), eps), top);
        var = mu * (T(1) - mu);
        dmu = var;
    } else {
        mu = clamp_lo(m_exp(clamp_hi(clamp_lo(eta, T(-30)), T(30))), eps);
        var = mu;
        dmu = mu;
    }
}

// Per-row deviance term (glmfit.py::_deviance_terms).
__device__ __forceinline__ double deviance_term(int link, double y, double mu) {
    if (link != LINK_POISSON) {
        const double t1 = (y > 0.5) ? -log(mu) : 0.0;
        const double t2 = (y < 0.5) ? -log(1.0 - mu) : 0.0;
        return t1 + t2;
    }
    const double ylogy = (y > 0.0) ? y * log(clamp_lo(y, MU_EPS)) : 0.0;
    return ylogy - y * log(mu) - (y - mu);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
    for (int off = WARP / 2; off > 0; off >>= 1) v = v + __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = WARP / 2; off > 0; off >>= 1) v = v + __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// Row r's fit columns in T, pinned columns zeroed (X * colmask in f64, then
// the phase's type, as the reference forms its f32 copy).
template <int PF, typename T>
__device__ __forceinline__ void load_row(const float* Xs, int P, const Cols& cols,
                                         const double* cm, int r, T* x) {
#pragma unroll
    for (int k = 0; k < PF; ++k) x[k] = (T)((double)Xs[r * P + cols.fit[k]] * cm[k]);
}

template <int PF, typename T>
__device__ __forceinline__ T row_eta(const T* x, const T* beta) {
    T eta = T(0);
#pragma unroll
    for (int k = 0; k < PF; ++k) eta = eta + x[k] * beta[k];
    return eta;
}

// The lane-strided, butterfly-reduced lower triangle of X'WX (row-major,
// PF x PF) and, with WITH_Z, X'Wz, at beta.
template <int PF, typename T, bool WITH_Z>
__device__ __forceinline__ void normal_eqs(const Args& a, const Cols& cols, const float* Xs,
                                           const float* ys, const double* cm, int n, int lane,
                                           const T* beta, T* A, T* b) {
#pragma unroll
    for (int i = 0; i < PF; ++i) {
#pragma unroll
        for (int j = 0; j <= i; ++j) A[i * PF + j] = T(0);
        b[i] = T(0);
    }
    for (int r = lane; r < n; r += WARP) {
        T x[PF];
        load_row<PF, T>(Xs, a.P, cols, cm, r, x);
        const T eta = row_eta<PF, T>(x, beta);
        T mu, var, dmu;
        mu_var_dmu<T>(a.link, eta, mu, var, dmu);
        const T w = dmu * dmu / clamp_lo(var, T(MU_EPS));
        T wz = T(0);
        if (WITH_Z) {
            const T z = eta + ((T)ys[r] - mu) / dmu;
            wz = w * z;
        }
#pragma unroll
        for (int i = 0; i < PF; ++i) {
            const T xw = x[i] * w;
#pragma unroll
            for (int j = 0; j <= i; ++j) A[i * PF + j] = A[i * PF + j] + xw * x[j];
            if (WITH_Z) b[i] = b[i] + x[i] * wz;
        }
    }
#pragma unroll
    for (int i = 0; i < PF; ++i) {
#pragma unroll
        for (int j = 0; j <= i; ++j) A[i * PF + j] = warp_sum(A[i * PF + j]);
        if (WITH_Z) b[i] = warp_sum(b[i]);
    }
}

// One phase: up to n_iter steps from beta (updated in place). Returns the
// steps run; `done` as the reference's carry leaves it.
template <int PF, typename T>
__device__ __forceinline__ int irls_phase(const Args& a, const Cols& cols, const float* Xs,
                                          const float* ys, const double* cm, const T* ridge,
                                          int n, int lane, int n_iter, T tol, T* beta,
                                          bool& done) {
    done = false;
    int steps = 0;
    for (int it = 0; it < n_iter; ++it) {
        ++steps;
        T A[PF * PF], b[PF], L[PF * PF], bn[PF];
        normal_eqs<PF, T, true>(a, cols, Xs, ys, cm, n, lane, beta, A, b);
#pragma unroll
        for (int i = 0; i < PF; ++i) A[i * PF + i] = A[i * PF + i] + ridge[i];
        mcp::chol<PF>(A, L);
        mcp::cho_solve<PF>(L, b, bn);
        bool ok = true;
        T step = T(0);
#pragma unroll
        for (int k = 0; k < PF; ++k) {
            bn[k] = clamp_hi(clamp_lo(bn[k], T(-BETA_CAP)), T(BETA_CAP));
            ok = ok && isfinite(bn[k]);
            step = fmax(step, fabs(bn[k] - beta[k]));
        }
        if (!ok) break;  // beta kept; the next step would repeat this one
#pragma unroll
        for (int k = 0; k < PF; ++k) beta[k] = bn[k];
        if (step < tol) {
            done = true;  // beta and done are frozen from here on
            break;
        }
    }
    return steps;
}

template <int PF>
__global__ void __launch_bounds__(WARP * WARPS_PER_BLOCK)
    glm_irls_kernel(const Args a, const Cols cols) {
    const int lane = threadIdx.x % WARP;
    const long long cell = (long long)blockIdx.x * WARPS_PER_BLOCK + threadIdx.x / WARP;
    if (cell >= (long long)a.sims * a.G) return;
    const long long sim = cell / a.G;
    const int g = (int)(cell % a.G);
    const int n = a.grid[g];
    const float* Xs = a.X + sim * a.max_n * (long long)a.P;
    const float* ys = a.y + sim * a.max_n;

    double cm[PF], ridge64[PF], pin[PF];
    float ridge32[PF], b32[PF];
#pragma unroll
    for (int k = 0; k < PF; ++k) {
        cm[k] = a.colmask[g * PF + k];
        pin[k] = 1.0 - cm[k];
        ridge64[k] = 1e-10 + pin[k];
        ridge32[k] = (float)ridge64[k] + (float)1e-6;
        b32[k] = (float)a.beta0[cell * PF + k];
    }

    bool done;
    const int it32 = irls_phase<PF, float>(a, cols, Xs, ys, cm, ridge32, n, lane, N_IRLS_ITERS,
                                           (float)CONV_TOL_F32, b32, done);
    double beta[PF];
#pragma unroll
    for (int k = 0; k < PF; ++k) beta[k] = (double)b32[k];
    const int it64 = irls_phase<PF, double>(a, cols, Xs, ys, cm, ridge64, n, lane, N_IRLS_POLISH,
                                            CONV_TOL, beta, done);

    // The final fit quantities, the outcome mean and both deviances.
    double ysum = 0.0;
    for (int r = lane; r < n; r += WARP) ysum = ysum + (double)ys[r];
    ysum = warp_sum(ysum);
    const double ybar = ysum / (double)n;
    double mu0 = clamp_lo(ybar, MU_EPS);
    if (a.link != LINK_POISSON) mu0 = clamp_hi(mu0, 1.0 - MU_EPS);
    double A[PF * PF], unused[PF];
    normal_eqs<PF, double, false>(a, cols, Xs, ys, cm, n, lane, beta, A, unused);
    double dev = 0.0, dev0 = 0.0;
    for (int r = lane; r < n; r += WARP) {
        double x[PF];
        load_row<PF, double>(Xs, a.P, cols, cm, r, x);
        double mu, var, dmu;
        mu_var_dmu<double>(a.link, row_eta<PF, double>(x, beta), mu, var, dmu);
        const double yr = (double)ys[r];
        dev = dev + deviance_term(a.link, yr, mu);
        dev0 = dev0 + deviance_term(a.link, yr, mu0);
    }
    dev = 2.0 * warp_sum(dev);
    dev0 = 2.0 * warp_sum(dev0);

    double M[PF * PF], L[PF * PF];
#pragma unroll
    for (int i = 0; i < PF; ++i) {
#pragma unroll
        for (int j = 0; j <= i; ++j) M[i * PF + j] = A[i * PF + j] + ((i == j) ? ridge64[i] : 0.0);
    }
    mcp::chol<PF>(M, L);
#pragma unroll
    for (int j = 0; j < PF; ++j)
        if (j % WARP == lane) mcp::cho_inverse_column_scaled<PF>(L, j, 1.0, a.cov + cell * PF * PF);
#pragma unroll
    for (int i = 0; i < PF; ++i) {
#pragma unroll
        for (int j = 0; j <= i; ++j) M[i * PF + j] = A[i * PF + j] + ((i == j) ? pin[i] : 0.0);
    }
    mcp::chol<PF>(M, L);
    bool finite = true, at_cap = false, rank_ok = true;
    double lo = L[0], hi = L[0];
#pragma unroll
    for (int k = 0; k < PF; ++k) {
        finite = finite && isfinite(beta[k]);
        at_cap = at_cap || (fabs(beta[k]) >= BETA_CAP - 1e-6);
        const double d = L[k * PF + k];
        rank_ok = rank_ok && isfinite(d);
        lo = fmin(lo, d);
        hi = fmax(hi, d);
    }
    rank_ok = rank_ok && (lo >= EPS_RANK * hi);
    if (lane < PF) a.beta[cell * PF + lane] = beta[lane];
    if (lane == 0) {
        a.converged[cell] = (uint8_t)(done && finite && !at_cap && rank_ok);
        a.dev[cell] = dev;
        a.dev0[cell] = dev0;
        a.ybar[cell] = ybar;
        if (a.iters != nullptr) {
            a.iters[2 * cell] = it32;
            a.iters[2 * cell + 1] = it64;
        }
    }
}

template <int PF>
int launch(const Args& a, const Cols& cols, cudaStream_t stream) {
    const long long cells = (long long)a.sims * a.G;
    const unsigned blocks = mcp_blocks(cells, WARPS_PER_BLOCK);
    if (blocks == 0) return (int)cudaErrorInvalidValue;
    glm_irls_kernel<PF><<<blocks, WARP * WARPS_PER_BLOCK, 0, stream>>>(a, cols);
    return (int)cudaGetLastError();
}

}  // namespace

// fit: pf column indices of X (host memory); grid: G row counts in
// 1..max_n (device memory); beta0 (sims, G, pf) and colmask (G, pf) f64 on
// the device; link 0 logit, 1 probit, 2 Poisson. iters may be null.
// Returns a cudaError_t.
extern "C" int mcp_glm_irls(const void* X, const void* y, int sims, int max_n, int P,
                            const int* fit, int pf, const void* grid, int G, const void* beta0,
                            const void* colmask, int link, void* beta, void* cov,
                            void* converged, void* dev, void* dev0, void* ybar, void* iters,
                            void* stream) {
    if (sims <= 0 || max_n <= 0 || P <= 0 || pf <= 0 || pf > MCP_MAX_P || G <= 0 || link < 0 ||
        link > LINK_POISSON)
        return (int)cudaErrorInvalidValue;
    Cols cols;
    for (int i = 0; i < pf; ++i) {
        if (fit[i] < 0 || fit[i] >= P) return (int)cudaErrorInvalidValue;
        cols.fit[i] = fit[i];
    }
    Args a;
    a.X = (const float*)X;
    a.y = (const float*)y;
    a.sims = sims;
    a.max_n = max_n;
    a.P = P;
    a.G = G;
    a.link = link;
    a.grid = (const int*)grid;
    a.beta0 = (const double*)beta0;
    a.colmask = (const double*)colmask;
    a.beta = (double*)beta;
    a.cov = (double*)cov;
    a.dev = (double*)dev;
    a.dev0 = (double*)dev0;
    a.ybar = (double*)ybar;
    a.converged = (uint8_t*)converged;
    a.iters = (int*)iters;
    MCP_DISPATCH_P(pf, launch, a, cols, (cudaStream_t)stream)
}
