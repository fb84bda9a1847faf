// K7 glmm_intercept: the whole random-intercept GLMM fit of one (sim, grid)
// cell, one warp per cell, a lane per cluster.
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
// What bounds it on the H100: the latency of one cell's dependent chain.
// A cell runs about 160 PIRLS iterations (48 in f64) and ~20 deviance
// passes, each a walk over its rows (per row the linear predictor, a
// transcendental, IEEE divisions and p (p + 3) / 2 + 2p multiply-adds),
// then a warp reduction and a p x p Cholesky solve that every lane repeats;
// AGQ adds nagq passes per deviance. The bytes are small (a sim's rows are
// read from device memory once and then from L1), and the operations per
// byte are in the thousands, so operations bound it on paper; in practice
// the iterations of a cell cannot overlap and the card hides their latency
// only with other cells' warps.
//
// What the design does about it:
// - one warp per cell and a lane per cluster (lane l takes clusters l, l +
//   32, ...), so the per-cluster sums W_j, s_j, t_j and the u update are
//   lane-local; only X'WX, X'Wz, sum c s s', sum c s t and the deviance
//   terms cross lanes, by an xor butterfly that gives every lane the bits
//   of smallchol.lane_sum's pair tree, so every lane then runs the same
//   solve and the same Brent step, without divergence;
// - every row sum is first a per-cluster sum in row order, then the lane
//   sum over clusters; the plain version (engine/glmmfit.py) sums in that
//   order and performs the same operations in the same order, and the file
//   is built with --fmad=false, so the two agree bit for bit;
// - per-cluster state (u, its saved copy and the step's new value, W, t, c
//   and s) lives in a per-cell scratch in device memory, lane-private and
//   L1-resident, so any m up to MAX_CLUSTERS is taken;
// - the width is a template bucket (p <= 4, 8, 16: three instantiations),
//   the link, nagq and the Hessian are run-time values: a warp-uniform
//   branch each, so that the build stays short;
// - a PIRLS run stops at a step that is not finite: the reference keeps
//   (beta, u) then, so every later step repeats it and the state is final.

#include "common.cuh"
#include "smallchol.cuh"

namespace {

using mcp::tri;

constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS_PER_BLOCK = 4;
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
constexpr double MU_EPS = 1e-10;
constexpr double EPS_RANK = 1e-6;
constexpr double LOG_2PI = 1.8378770664093453;
constexpr double SQRT2 = 1.4142135623730951;
constexpr double INV_SQRT2 = 0.7071067811865476;
constexpr double INV_SQRT_2PI = 0.3989422804014327;
constexpr double H_STEP = 1e-4;
constexpr int N_U_NEWTON = 20;
enum { LINK_LOGIT = 0, LINK_PROBIT = 1, LINK_POISSON = 2 };
// Per-cluster scratch slots; s (p values) follows.
enum { S_U = 0, S_W, S_T, S_C, S_UNEW, S_USAVE, S_S };

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
    double* scratch;  // (cells, m, pf + S_S)
    double *beta, *cov, *tau2, *ybar;
    uint8_t* flags;
};

// One cell: its sim's rows, its row count, its lane and its scratch.
struct Cell {
    const float* X;
    const float* y;
    int n, lane, sl;
    double* ws;
};

__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_exp(double x) { return exp(x); }
__device__ __forceinline__ float m_log(float x) { return logf(x); }
__device__ __forceinline__ double m_log(double x) { return log(x); }
__device__ __forceinline__ float m_erf(float x) { return erff(x); }
__device__ __forceinline__ double m_erf(double x) { return erf(x); }

// torch.clamp's one-sided bounds: a NaN stays NaN.
template <typename T>
__device__ __forceinline__ T clamp_lo(T x, T lo) { return x < lo ? lo : x; }
template <typename T>
__device__ __forceinline__ T clamp_hi(T x, T hi) { return x > hi ? hi : x; }

// glmfit.py::_mu_var_dmu in T.
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

// glmfit.py::_deviance_terms (one log per binomial row, as K6).
__device__ __forceinline__ double dev_term(int link, double y, double mu) {
    if (link != LINK_POISSON) {
        const bool pos = y > 0.5, neg = y < 0.5;
        const double t = (pos || neg) ? -log(pos ? mu : 1.0 - mu) : 0.0;
        return t + 0.0;
    }
    const double ylogy = (y > 0.0) ? y * log(clamp_lo(y, MU_EPS)) : 0.0;
    return ylogy - y * log(mu) - (y - mu);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
    for (int off = WARP / 2; off > 0; off >>= 1) v = v + __shfl_xor_sync(FULL, v, off);
    return v;
}

// The rows of cluster j below n: first, stride and count.
struct Rows {
    int first, step, count;
};

__device__ __forceinline__ Rows rows_of(const Args& a, int n, int j) {
    Rows r;
    if (a.rr) {
        r.first = j;
        r.step = a.m;
        r.count = n > j ? (n - j + a.m - 1) / a.m : 0;
    } else {
        r.first = j * a.period;
        r.step = 1;
        const int left = n - r.first;
        r.count = left <= 0 ? 0 : (left < a.period ? left : a.period);
    }
    return r;
}

template <int PB, typename T>
__device__ __forceinline__ void load_row(const Args& a, const Cell& c, int r, T* x, T& y) {
    const float* row = c.X + (long long)r * a.P;
#pragma unroll
    for (int k = 0; k < PB; ++k) x[k] = (k < a.pf) ? (T)__ldg(row + a.fit[k]) : T(0);
    y = (T)__ldg(c.y + r);
}

template <int PB, typename T>
__device__ __forceinline__ T row_dot(const Args& a, const T* x, const T* b) {
    T eta = T(0);
#pragma unroll
    for (int k = 0; k < PB; ++k)
        if (k < a.pf) eta = eta + x[k] * b[k];
    return eta;
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
            if (i >= a.pf) L[tri(i, j)] = (i == j) ? T(1) : T(0);
    }
}

// One PIRLS step in T at (beta, u = scratch S_U) and 1 / tau^2 = inv: the
// new beta in bn and the new u in S_UNEW; returns whether both are finite.
template <int PB, typename T>
__device__ bool pirls_step(const Args& a, const Cell& c, const T* beta, T inv, T ridge, T* bn) {
    constexpr int NT = PB * (PB + 1) / 2;
    const int p = a.pf;
    T A[NT], b[PB], SS[NT], St[PB];
#pragma unroll
    for (int i = 0; i < NT; ++i) A[i] = SS[i] = T(0);
#pragma unroll
    for (int i = 0; i < PB; ++i) b[i] = St[i] = T(0);
    for (int j = c.lane; j < a.m; j += WARP) {
        double* cl = c.ws + (long long)j * c.sl;
        const T uj = (T)cl[S_U];
        const Rows rw = rows_of(a, c.n, j);
        T W = T(0), t = T(0), s[PB], Aj[NT], bj[PB];
#pragma unroll
        for (int i = 0; i < NT; ++i) Aj[i] = T(0);
#pragma unroll
        for (int i = 0; i < PB; ++i) s[i] = bj[i] = T(0);
        for (int k = 0, r = rw.first; k < rw.count; ++k, r += rw.step) {
            T x[PB], yv;
            load_row<PB, T>(a, c, r, x, yv);
            const T eta = row_dot<PB, T>(a, x, beta) + uj;
            T mu, var, dmu;
            mu_var_dmu<T>(a.link, eta, mu, var, dmu);
            const T w = dmu * dmu / clamp_lo(var, T(MU_EPS));
            const T z = eta + (yv - mu) / dmu;
            const T wz = w * z;
            W = W + w;
#pragma unroll
            for (int i = 0; i < PB; ++i)
                if (i < p) s[i] = s[i] + w * x[i];
            t = t + wz;
#pragma unroll
            for (int i = 0; i < PB; ++i) {
                const T xw = x[i] * w;
#pragma unroll
                for (int jj = 0; jj <= i; ++jj)
                    if (i < p) Aj[tri(i, jj)] = Aj[tri(i, jj)] + xw * x[jj];
            }
#pragma unroll
            for (int i = 0; i < PB; ++i)
                if (i < p) bj[i] = bj[i] + x[i] * wz;
        }
        const T cj = (rw.count > 0) ? T(1) / (W + inv) : T(0);
        cl[S_W] = (double)W;
        cl[S_T] = (double)t;
        cl[S_C] = (double)cj;
#pragma unroll
        for (int i = 0; i < PB; ++i)
            if (i < p) cl[S_S + i] = (double)s[i];
#pragma unroll
        for (int i = 0; i < PB; ++i) {
            if (i >= p) continue;
            const T cs = cj * s[i];
#pragma unroll
            for (int jj = 0; jj <= i; ++jj) {
                A[tri(i, jj)] = A[tri(i, jj)] + Aj[tri(i, jj)];
                SS[tri(i, jj)] = SS[tri(i, jj)] + cs * s[jj];
            }
            b[i] = b[i] + bj[i];
            St[i] = St[i] + cs * t;
        }
    }
    T L[NT], rhs[PB];
#pragma unroll
    for (int i = 0; i < PB; ++i) {
        if (i >= p) continue;
#pragma unroll
        for (int jj = 0; jj <= i; ++jj) {
            const T v = warp_sum(A[tri(i, jj)]) - warp_sum(SS[tri(i, jj)]);
            L[tri(i, jj)] = (i == jj) ? v + ridge : v;
        }
        rhs[i] = warp_sum(b[i]) - warp_sum(St[i]);
    }
#pragma unroll
    for (int i = 0; i < PB; ++i)
        if (i >= p) rhs[i] = T(0);
    pad_identity<PB, T>(a, L);
    mcp::chol_packed<PB>(L);
    mcp::cho_solve_packed<PB>(L, rhs, bn);
    bool ok = true;
#pragma unroll
    for (int i = 0; i < PB; ++i)
        if (i < p) ok = ok && isfinite(bn[i]);
    bool lane_ok = true;
    for (int j = c.lane; j < a.m; j += WARP) {
        double* cl = c.ws + (long long)j * c.sl;
        T sb = T(0);
#pragma unroll
        for (int i = 0; i < PB; ++i)
            if (i < p) sb = sb + (T)cl[S_S + i] * bn[i];
        const T un = (T)cl[S_C] * ((T)cl[S_T] - sb);
        cl[S_UNEW] = (double)un;
        lane_ok = lane_ok && isfinite(un);
    }
    return __all_sync(FULL, ok && lane_ok);
}

// Per-lane sums over its clusters of the f64 tail at (beta, u): W_j into
// S_W, and returns the lane's sums of the deviance terms, of u^2 and of
// log1p(tau2 W_j) over active clusters.
template <int PB>
__device__ void tail(const Args& a, const Cell& c, const double* beta, double tau2, double& dt,
                     double& u2, double& l1p) {
    dt = u2 = l1p = 0.0;
    for (int j = c.lane; j < a.m; j += WARP) {
        double* cl = c.ws + (long long)j * c.sl;
        const double uj = cl[S_U];
        const Rows rw = rows_of(a, c.n, j);
        double W = 0.0, d = 0.0;
        for (int k = 0, r = rw.first; k < rw.count; ++k, r += rw.step) {
            double x[PB], yv;
            load_row<PB, double>(a, c, r, x, yv);
            const double eta = row_dot<PB, double>(a, x, beta) + uj;
            double mu, var, dmu;
            mu_var_dmu<double>(a.link, eta, mu, var, dmu);
            W = W + dmu * dmu / clamp_lo(var, MU_EPS);
            d = d + dev_term(a.link, yv, mu);
        }
        cl[S_W] = W;
        const bool act = rw.count > 0;
        dt = dt + d;
        u2 = u2 + (act ? uj * uj : 0.0);
        l1p = l1p + (act ? log1p(tau2 * W) : 0.0);
    }
}

// PIRLS in T from (beta, u) for iters steps, then the f64 Laplace deviance
// at the mode (make_pirls' pirls).
template <int PB, typename T>
__device__ double pirls(const Args& a, const Cell& c, double tau2, T* beta, int iters) {
    const double inv64 = 1.0 / fmax(tau2, 1e-12);
    const T inv = (T)inv64;
    const T ridge = (sizeof(T) == 8) ? T(1e-10) : T(1e-6);
    for (int it = 0; it < iters; ++it) {
        T bn[PB];
        if (!pirls_step<PB, T>(a, c, beta, inv, ridge, bn)) break;  // kept: a fixed point
#pragma unroll
        for (int i = 0; i < PB; ++i)
            if (i < a.pf) beta[i] = bn[i];
        for (int j = c.lane; j < a.m; j += WARP) {
            double* cl = c.ws + (long long)j * c.sl;
            cl[S_U] = cl[S_UNEW];
        }
    }
    double b64[PB];
#pragma unroll
    for (int i = 0; i < PB; ++i) b64[i] = (double)beta[i];
    double dt, u2, l1p;
    tail<PB>(a, c, b64, tau2, dt, u2, l1p);
    const double dev_cond = 2.0 * warp_sum(dt);
    return (dev_cond + warp_sum(u2) * inv64) + warp_sum(l1p);
}

__device__ __forceinline__ double node_logsumexp(const double* v, int n) {
    double mx = v[0];
    for (int k = 1; k < n; ++k) mx = fmax(mx, v[k]);
    double acc = 0.0;
    for (int k = 0; k < n; ++k) acc = acc + exp(v[k] - mx);
    return log(acc) + mx;
}

__device__ __forceinline__ float node_logsumexp(const float* v, int n) {
    float mx = v[0];
    for (int k = 1; k < n; ++k) mx = fmaxf(mx, v[k]);
    float acc = 0.0f;
    for (int k = 0; k < n; ++k) acc = acc + expf(v[k] - mx);
    return logf(acc) + mx;
}

// The full f64 AGQ deviance at the mode (agq_deviance); W_j in S_W.
template <int PB>
__device__ double agq_deviance(const Args& a, const Cell& c, double tau2, const double* beta) {
    const double inv = 1.0 / fmax(tau2, 1e-12);
    const double logt = log(fmax(tau2, 1e-12));
    double acc = 0.0;
    for (int j = c.lane; j < a.m; j += WARP) {
        const double* cl = c.ws + (long long)j * c.sl;
        const Rows rw = rows_of(a, c.n, j);
        const double ss = SQRT2 * (1.0 / sqrt(cl[S_W] + inv));
        const double uj = cl[S_U];
        double v[MAX_AGQ];
        for (int q = 0; q < a.nagq; ++q) {
            const double uk = uj + ss * a.gx[q];
            double ll = 0.0;
            for (int k = 0, r = rw.first; k < rw.count; ++k, r += rw.step) {
                double x[PB], yv;
                load_row<PB, double>(a, c, r, x, yv);
                ll = ll + loglik<double>(a.link, yv, row_dot<PB, double>(a, x, beta) + uk);
            }
            const double prior = (-0.5 * (uk * uk)) * inv - 0.5 * (logt + LOG_2PI);
            v[q] = ((a.glw[q] + a.gx[q] * a.gx[q]) + ll) + prior;
        }
        const double li = node_logsumexp(v, a.nagq) + log(ss);
        acc = acc + ((rw.count > 0) ? li : 0.0);
    }
    return -2.0 * warp_sum(acc);
}

// The search's AGQ deviance: f64 centre node, f32 node deltas
// (agq_deviance_hybrid); beta and u the f64 casts of the f32 mode.
template <int PB>
__device__ double agq_deviance_hybrid(const Args& a, const Cell& c, double tau2,
                                      const double* beta) {
    const double inv = 1.0 / fmax(tau2, 1e-12);
    const double logt = log(fmax(tau2, 1e-12));
    const float inv32 = (float)inv;
    const int k0 = a.k0;
    double acc = 0.0, llc = 0.0;
    for (int j = c.lane; j < a.m; j += WARP) {
        const double* cl = c.ws + (long long)j * c.sl;
        const Rows rw = rows_of(a, c.n, j);
        const double ss = SQRT2 * (1.0 / sqrt(cl[S_W] + inv));
        const double uj = cl[S_U];
        const double prior_c = (-0.5 * (uj * uj)) * inv - 0.5 * (logt + LOG_2PI);
        const double s0 = ((a.glw[k0] + a.gx[k0] * a.gx[k0]) + prior_c) + log(ss);
        const float ss32 = (float)ss;
        float dll[MAX_AGQ];
        for (int q = 0; q < a.nagq; ++q) dll[q] = 0.0f;
        double llc_j = 0.0;
        for (int k = 0, r = rw.first; k < rw.count; ++k, r += rw.step) {
            double x[PB], yv;
            load_row<PB, double>(a, c, r, x, yv);
            const double eta_c = row_dot<PB, double>(a, x, beta) + uj;
            llc_j = llc_j + loglik<double>(a.link, yv, eta_c);
            const float e32 = (float)eta_c, y32 = (float)yv;
            const float l0 = loglik<float>(a.link, y32, e32);
            for (int q = 0; q < a.nagq; ++q) {
                const float shift = ss32 * (float)a.gx[q];
                dll[q] = dll[q] + (loglik<float>(a.link, y32, e32 + shift) - l0);
            }
        }
        llc = llc + llc_j;
        const float u32 = (float)uj;
        float delta[MAX_AGQ];
        for (int q = 0; q < a.nagq; ++q) {
            const float uk = u32 + ss32 * (float)a.gx[q];
            const float dprior = (-0.5f * (uk * uk - u32 * u32)) * inv32;
            delta[q] = (a.gdw[q] + dll[q]) + dprior;
        }
        const double lse = (double)node_logsumexp(delta, a.nagq);
        acc = acc + ((rw.count > 0) ? s0 + lse : 0.0);
    }
    return -2.0 * (warp_sum(acc) + warp_sum(llc));
}

// The beta-profiled Laplace deviance at beta_q (dev_beta): each cluster's
// u re-optimised from the mode's u by N_U_NEWTON Newton passes (a
// cluster's passes need only its own rows, so a lane runs them in turn).
template <int PB>
__device__ double dev_beta(const Args& a, const Cell& c, const double* bq, double tc) {
    const double inv = 1.0 / tc;
    double dt = 0.0, u2 = 0.0, l1p = 0.0;
    for (int j = c.lane; j < a.m; j += WARP) {
        const double* cl = c.ws + (long long)j * c.sl;
        const Rows rw = rows_of(a, c.n, j);
        const bool act = rw.count > 0;
        double uq = cl[S_U];
        for (int pass = 0; pass < N_U_NEWTON; ++pass) {
            double rs = 0.0, ws = 0.0;
            for (int k = 0, r = rw.first; k < rw.count; ++k, r += rw.step) {
                double x[PB], yv;
                load_row<PB, double>(a, c, r, x, yv);
                double mu, var, dmu;
                mu_var_dmu<double>(a.link, row_dot<PB, double>(a, x, bq) + uq, mu, var, dmu);
                rs = rs + (yv - mu);
                ws = ws + dmu * dmu / clamp_lo(var, MU_EPS);
            }
            const double g = rs - uq / tc;
            const double h = ws + inv;
            uq = act ? uq + g / h : 0.0;
        }
        double W = 0.0, d = 0.0;
        for (int k = 0, r = rw.first; k < rw.count; ++k, r += rw.step) {
            double x[PB], yv;
            load_row<PB, double>(a, c, r, x, yv);
            double mu, var, dmu;
            mu_var_dmu<double>(a.link, row_dot<PB, double>(a, x, bq) + uq, mu, var, dmu);
            W = W + dmu * dmu / clamp_lo(var, MU_EPS);
            d = d + dev_term(a.link, yv, mu);
        }
        dt = dt + d;
        u2 = u2 + (act ? uq * uq : 0.0);
        l1p = l1p + (act ? log1p(tc * W) : 0.0);
    }
    return (2.0 * warp_sum(dt) + warp_sum(u2) / tc) + warp_sum(l1p);
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

// 2 H^-1 of the FD Hessian into cov (PB x PB layout), unless not finite.
template <int PB>
__device__ void fd_hessian_cov(const Args& a, const Cell& c, const double* beta, double tc,
                               double* cov) {
    constexpr int NT = PB * (PB + 1) / 2;
    const int p = a.pf;
    const int nv = 1 + 2 * p + 2 * p * (p - 1);
    double Hm[NT];
#pragma unroll
    for (int i = 0; i < NT; ++i) Hm[i] = 0.0;
    double f0 = 0.0, vp = 0.0, quad[4];
    const double hh = H_STEP * H_STEP, hh4 = 4.0 * H_STEP * H_STEP;
    for (int v = 0; v < nv; ++v) {
        int i, j;
        double si, sj;
        stencil(v, p, i, j, si, sj);
        double bq[PB];
#pragma unroll
        for (int k = 0; k < PB; ++k) {
            const double o = (k == i) ? si : ((k == j) ? sj : 0.0);
            bq[k] = beta[k] + H_STEP * o;
        }
        const double val = dev_beta<PB>(a, c, bq, tc);
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
    double inv[PB * PB];
#pragma unroll
    for (int k = 0; k < PB; ++k) mcp::cho_inverse_column_packed<PB>(Hm, k, inv);
    bool finite = true;
#pragma unroll
    for (int k = 0; k < PB; ++k) {
#pragma unroll
        for (int l = 0; l < PB; ++l)
            if (k < p && l < p) finite = finite && isfinite(2.0 * inv[k * PB + l]);
    }
    if (!finite) return;
#pragma unroll
    for (int k = 0; k < PB; ++k) {
#pragma unroll
        for (int l = 0; l < PB; ++l)
            if (k < p && l < p) cov[k * PB + l] = 2.0 * inv[k * PB + l];
    }
}

template <int PB>
__device__ __forceinline__ double dev_at(const Args& a, const Cell& c, double lt, double* beta,
                                         int iters) {
    const double tau2 = exp(lt);
    const double lap = pirls<PB, double>(a, c, tau2, beta, iters);
    return a.nagq > 1 ? agq_deviance<PB>(a, c, tau2, beta) : lap;
}

template <int PB>
__device__ __forceinline__ double dev_at32(const Args& a, const Cell& c, double lt, float* beta,
                                           int iters) {
    const double tau2 = exp(lt);
    const double lap = pirls<PB, float>(a, c, tau2, beta, iters);
    if (a.nagq <= 1) return lap;
    double b64[PB];
#pragma unroll
    for (int i = 0; i < PB; ++i) b64[i] = (double)beta[i];
    return agq_deviance_hybrid<PB>(a, c, tau2, b64);
}

__device__ __forceinline__ void copy_slot(const Args& a, const Cell& c, int to, int from) {
    for (int j = c.lane; j < a.m; j += WARP) {
        double* cl = c.ws + (long long)j * c.sl;
        cl[to] = cl[from];
    }
}

template <int PB>
__global__ void __launch_bounds__(WARP * WARPS_PER_BLOCK)
    glmm_intercept_kernel(const Args a) {
    constexpr int NT = PB * (PB + 1) / 2;
    const long long cell = (long long)blockIdx.x * WARPS_PER_BLOCK + threadIdx.x / WARP;
    if (cell >= (long long)a.sims * a.G) return;  // whole warps leave together
    const long long sim = cell / a.G;
    const int p = a.pf;
    Cell c;
    c.X = a.X + sim * a.max_n * (long long)a.P;
    c.y = a.y + sim * a.max_n;
    c.n = a.grid[cell % a.G];
    c.lane = threadIdx.x % WARP;
    c.sl = p + S_S;
    c.ws = a.scratch + cell * a.m * (long long)c.sl;

    // 1. the cold f64 evaluation from beta0, u = 0; its mode cast to f32
    double b64[PB];
#pragma unroll
    for (int i = 0; i < PB; ++i) b64[i] = (i < p) ? a.beta0[i] : 0.0;
    for (int j = c.lane; j < a.m; j += WARP) c.ws[(long long)j * c.sl + S_U] = 0.0;
    double ax = LOG_LO, bx = LOG_HI;
    const double x0 = ax + CGOLD * (bx - ax);
    double fx = dev_at<PB>(a, c, x0, b64, N_PIRLS);
    float b32[PB];
#pragma unroll
    for (int i = 0; i < PB; ++i) b32[i] = (float)b64[i];
    for (int j = c.lane; j < a.m; j += WARP) {
        double* cl = c.ws + (long long)j * c.sl;
        cl[S_U] = (double)(float)cl[S_U];
    }

    // 2. Brent over log tau^2 (mixedfit._brent_minimize), the f32 carry
    // threaded through every evaluation
    double x = x0, w = x0, v = x0, fw = fx, fv = fx, d = 0.0, e = 0.0;
#pragma unroll 1
    for (int it = 0; it < BRENT_ITERS; ++it) {
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
        const double fu = dev_at32<PB>(a, c, u, b32, it < BRENT_FULL ? N_PIRLS : N_PIRLS_WARM);
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
        x = better ? u : x;
        fx = better ? fu : fx;
        v = v2;
        fv = fv2;
        w = w2;
        fw = fw2;
        ax = a2;
        bx = bb2;
        d = d2;
        e = e2;
    }

    // 3. the f64 evaluation at the optimum from the carry, the probe from
    // its mode, the pin, the final fit
#pragma unroll
    for (int i = 0; i < PB; ++i) b64[i] = (double)b32[i];
    const double dev_int = dev_at<PB>(a, c, x, b64, N_PIRLS);
    double bc[PB];
#pragma unroll
    for (int i = 0; i < PB; ++i) bc[i] = b64[i];
    copy_slot(a, c, S_USAVE, S_U);
    const double dev_zero = dev_at<PB>(a, c, LOG_LO, b64, N_PIRLS);
    const bool boundary = (dev_zero <= dev_int + 1e-10) || (x < BOUNDARY_LOG);
    const double tau2_hat = boundary ? 0.0 : exp(x);
    const double tc = fmax(tau2_hat, 1e-12);
    copy_slot(a, c, S_U, S_USAVE);
    pirls<PB, double>(a, c, tc, bc, N_PIRLS);

    // the Schur complement at the mode (W_j in S_W from the tail)
    const double inv = 1.0 / tc;
    double A[NT], SS[NT];
#pragma unroll
    for (int i = 0; i < NT; ++i) A[i] = SS[i] = 0.0;
    double ysum = 0.0;
    for (int j = c.lane; j < a.m; j += WARP) {
        const double* cl = c.ws + (long long)j * c.sl;
        const Rows rw = rows_of(a, c.n, j);
        const double uj = cl[S_U];
        double W = 0.0, s[PB], Aj[NT], yj = 0.0;
#pragma unroll
        for (int i = 0; i < NT; ++i) Aj[i] = 0.0;
#pragma unroll
        for (int i = 0; i < PB; ++i) s[i] = 0.0;
        for (int k = 0, r = rw.first; k < rw.count; ++k, r += rw.step) {
            double xr[PB], yv;
            load_row<PB, double>(a, c, r, xr, yv);
            double mu, var, dmu;
            mu_var_dmu<double>(a.link, row_dot<PB, double>(a, xr, bc) + uj, mu, var, dmu);
            const double wr = dmu * dmu / clamp_lo(var, MU_EPS);
            W = W + wr;
#pragma unroll
            for (int i = 0; i < PB; ++i)
                if (i < p) s[i] = s[i] + wr * xr[i];
#pragma unroll
            for (int i = 0; i < PB; ++i) {
                const double xw = xr[i] * wr;
#pragma unroll
                for (int jj = 0; jj <= i; ++jj)
                    if (i < p) Aj[tri(i, jj)] = Aj[tri(i, jj)] + xw * xr[jj];
            }
            yj = yj + yv;
        }
        const double cj = (rw.count > 0) ? 1.0 / (W + inv) : 0.0;
        ysum = ysum + yj;
#pragma unroll
        for (int i = 0; i < PB; ++i) {
            if (i >= p) continue;
            const double cs = cj * s[i];
#pragma unroll
            for (int jj = 0; jj <= i; ++jj) {
                A[tri(i, jj)] = A[tri(i, jj)] + Aj[tri(i, jj)];
                SS[tri(i, jj)] = SS[tri(i, jj)] + cs * s[jj];
            }
        }
    }
    double L[NT], R[NT];
#pragma unroll
    for (int i = 0; i < PB; ++i) {
        if (i >= p) continue;
#pragma unroll
        for (int jj = 0; jj <= i; ++jj) {
            const double vv = warp_sum(A[tri(i, jj)]) - warp_sum(SS[tri(i, jj)]);
            L[tri(i, jj)] = (i == jj) ? vv + 1e-10 : vv;
            R[tri(i, jj)] = L[tri(i, jj)] - ((i == jj) ? 1e-10 : 0.0);
        }
    }
    pad_identity<PB, double>(a, L);
    pad_identity<PB, double>(a, R);
    mcp::chol_packed<PB>(L);
    mcp::chol_packed<PB>(R);
    ysum = warp_sum(ysum);

    double cv[PB * PB];  // the covariance, PB x PB layout
#pragma unroll
    for (int k = 0; k < PB; ++k) mcp::cho_inverse_column_packed<PB>(L, k, cv);
    if (a.hessian) fd_hessian_cov<PB>(a, c, bc, tc, cv);

    bool finite = true, chol_ok = true, rank_ok = true;
    double lo = R[0], hi = R[0];
#pragma unroll
    for (int k = 0; k < PB; ++k) {
        if (k >= p) continue;
        finite = finite && isfinite(bc[k]);
        const double dl = L[tri(k, k)];
        chol_ok = chol_ok && isfinite(dl) && (dl > 0.0);
        const double dr = R[tri(k, k)];
        rank_ok = rank_ok && isfinite(dr) && (dr > 0.0);
        lo = fmin(lo, dr);
        hi = fmax(hi, dr);
    }
    rank_ok = rank_ok && (lo >= EPS_RANK * hi);
    if (c.lane == 0) {
#pragma unroll
        for (int k = 0; k < PB; ++k) {
            if (k >= p) continue;
            a.beta[cell * p + k] = bc[k];
#pragma unroll
            for (int l = 0; l < PB; ++l)
                if (l < p) a.cov[(cell * p + k) * p + l] = cv[k * PB + l];
        }
        a.tau2[cell] = tau2_hat;
        a.ybar[cell] = ysum / (double)c.n;
        const bool converged = finite && chol_ok && rank_ok && isfinite(dev_int);
        a.flags[cell] = (uint8_t)((converged ? 1 : 0) | (boundary ? 2 : 0));
    }
}

template <int PB>
int launch(const Args& a, cudaStream_t stream) {
    const unsigned blocks = mcp_blocks((long long)a.sims * a.G * WARP, WARP * WARPS_PER_BLOCK);
    if (blocks == 0) return (int)cudaErrorInvalidConfiguration;
    glmm_intercept_kernel<PB><<<blocks, WARP * WARPS_PER_BLOCK, 0, stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

// fit: pf column indices of X (host); grid: G row counts in 1..max_n
// (device); rr 1 for round-robin clusters (cluster of row r: r % m), 0 for
// blocks of `period` rows; link 0 logit, 1 probit, 2 Poisson; beta0 (pf,)
// f64 on the device; nagq 1 (Laplace) or the node count, gx / glw / gdw its
// nodes, log weights and f32 search offsets (host, nagq values), k0 the
// centre node; hessian 1 for the FD covariance; scratch (sims * G, m, pf +
// 6) f64. flags bit 0 converged, bit 1 boundary. Returns a cudaError_t.
extern "C" int mcp_glmm_intercept(const void* X, const void* y, int sims, int max_n, int P,
                                  const int* fit, int pf, const void* grid, int G, int rr,
                                  int period, int m, int link, const void* beta0, int nagq,
                                  const double* gx, const double* glw, const float* gdw, int k0,
                                  int hessian, void* scratch, void* beta, void* cov, void* tau2,
                                  void* ybar, void* flags, void* stream) {
    if (sims <= 0 || max_n <= 0 || P <= 0 || pf <= 0 || pf > MAX_P || G <= 0 || m <= 0 ||
        period <= 0 || link < 0 || link > LINK_POISSON || nagq < 1 || nagq > MAX_AGQ ||
        k0 < 0 || k0 >= nagq)
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
    a.scratch = (double*)scratch;
    a.beta = (double*)beta;
    a.cov = (double*)cov;
    a.tau2 = (double*)tau2;
    a.ybar = (double*)ybar;
    a.flags = (uint8_t*)flags;
    if (pf <= 4) return launch<4>(a, (cudaStream_t)stream);
    if (pf <= 8) return launch<8>(a, (cudaStream_t)stream);
    return launch<16>(a, (cudaStream_t)stream);
}
