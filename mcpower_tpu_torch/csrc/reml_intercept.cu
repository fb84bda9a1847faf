// K4 reml_intercept: the whole random-intercept REML fit of one (sim, grid)
// cell, in f64.
//
// Replaces: mcpower_tpu/engine/mixedfit.py::mixed_grid_stats.per_grid
// (:846-883) with _reml_quantities (:109) and _brent_minimize (:166), which
// XLA fuses into one program per design. Per cell:
//   1. 20 safeguarded Brent steps in log gamma over [-14, 7] (tol 1e-9,
//      golden fallback into the larger arm) on the Woodbury-reduced profile
//      deviance dev(gamma) = sum_j log1p(gamma n_j) + log|X'V0^-1 X|
//      + (n - p) log(rss), V0 = I + gamma Z Z';
//   2. the gamma = 0 probe (log gamma = -14): the low pin when
//      dev_zero <= dev_interior + 1e-10 or log gamma_hat < -12, the high pin
//      when not low and log gamma_hat > 6.5;
//   3. the final fit at gamma_hat (0 when pinned low): beta, cov =
//      sigma^2 (X'V0^-1 X)^-1, tau^2 = gamma_hat sigma^2, and converged =
//      finite deviance and beta, sigma^2 > 0, chol_rank_ok.
//
// What bounds it on H100: the sequential dependency chain of one cell.
// 22 deviance evaluations each walk the m cluster statistics (m (p^2 + p +
// 2) f64 multiply-adds) and factor a p x p matrix; at the main path's
// 10,000 cells of m = 20, p = 3 that is ~0.1 GFLOP of f64 in all, far below
// the card's f64 peak, and only 10,000 threads are in flight on 132 SMs.
// The kernel is latency- and occupancy-bound, not bandwidth-bound: each
// cell reads (p + 2) m + p^2 + p + 1 doubles from K2's output (~1 KB) and
// re-reads them from L1 on every evaluation.
//
// What the design does about it: one thread per cell keeps the whole search
// (bracket, three best points, step lengths) in registers with no
// synchronisation or shared memory; p is a template constant so the p x p
// algebra unrolls with static indices (smallchol.cuh); the cluster loop
// streams n_j, s_j, t_j through L1. Built with --fmad=false so the
// deviance follows the plain version's operation order and the pins, which
// hinge on 1e-10 deviance gaps, agree with it.

#include "common.cuh"
#include "smallchol.cuh"

namespace {

constexpr double LOG_GAMMA_LO = -14.0;
constexpr double LOG_GAMMA_HI = 7.0;
constexpr double BOUNDARY_LOG_GAMMA = -12.0;
constexpr double BOUNDARY_LOG_GAMMA_HI = 6.5;
constexpr int BRENT_ITERS = 20;
constexpr double CGOLD = 0.3819660112501051;
constexpr double BRENT_TOL = 1e-9;

template <int P>
struct Cell {
    const double* nj;  // (m,)
    const double* s;   // (m, P)
    const double* t;   // (m,)
    int m;
    double xtx[P * P];
    double xty[P];
    double yty;
    double n;
};

// Profile-REML pieces at gamma; fills L, beta, sigma2 and returns the
// deviance. Same operations, in the same order, as the plain
// mixedfit._reml_quantities: the cluster sums are formed first and then
// subtracted from X'X, X'y, y'y.
template <int P>
__device__ double reml_quantities(double gamma, const Cell<P>& c, double* L, double* beta,
                                  double& sigma2) {
    double W[P * P], V[P];
#pragma unroll
    for (int i = 0; i < P * P; ++i) W[i] = 0.0;
#pragma unroll
    for (int i = 0; i < P; ++i) V[i] = 0.0;
    double Y = 0.0, logdet_v = 0.0;
    for (int j = 0; j < c.m; ++j) {
        const double nj = c.nj[j];
        const double cj = gamma / (1.0 + gamma * nj);
        const double tj = c.t[j];
        double sj[P];
#pragma unroll
        for (int a = 0; a < P; ++a) sj[a] = c.s[j * P + a];
#pragma unroll
        for (int a = 0; a < P; ++a) {
            const double cs = cj * sj[a];
#pragma unroll
            for (int b = 0; b <= a; ++b) W[a * P + b] = W[a * P + b] + cs * sj[b];
            V[a] = V[a] + cs * tj;
        }
        Y = Y + (cj * tj) * tj;
        logdet_v = logdet_v + log1p(gamma * nj);
    }
    double A[P * P], axy[P];
#pragma unroll
    for (int a = 0; a < P; ++a) {
#pragma unroll
        for (int b = 0; b < P; ++b) A[a * P + b] = (b <= a) ? c.xtx[a * P + b] - W[a * P + b] : 0.0;
        axy[a] = c.xty[a] - V[a];
    }
    const double ayy = c.yty - Y;
    mcp::chol<P>(A, L);
    mcp::cho_solve<P>(L, axy, beta);
    double bx = 0.0;
#pragma unroll
    for (int a = 0; a < P; ++a) bx = bx + beta[a] * axy[a];
    const double rss = ayy - bx;
    const double df = c.n - (double)P;
    sigma2 = rss / df;
    return logdet_v + mcp::logdet_from_chol<P>(L) + df * log(rss);
}

template <int P>
__device__ __forceinline__ double dev_at(double log_gamma, const Cell<P>& c) {
    double L[P * P], beta[P], sigma2;
    return reml_quantities<P>(exp(log_gamma), c, L, beta, sigma2);
}

// The reference's lane-select Brent, one lane: every candidate is computed
// and then selected, so the step sequence matches the plain version's.
template <int P>
__device__ double brent_log_gamma(const Cell<P>& c) {
    double a = LOG_GAMMA_LO, b = LOG_GAMMA_HI;
    const double x0 = a + CGOLD * (b - a);
    double x = x0, w = x0, v = x0;
    double fx = dev_at<P>(x0, c), fw = fx, fv = fx;
    double d = 0.0, e = 0.0;
#pragma unroll 1
    for (int it = 0; it < BRENT_ITERS; ++it) {
        const double xm = 0.5 * (a + b);
        const double tol1 = BRENT_TOL * fabs(x) + 1e-13;
        const double tol2 = 2.0 * tol1;
        const double r = (x - w) * (fx - fv);
        double q = (x - v) * (fx - fw);
        double p = (x - v) * q - (x - w) * r;
        q = 2.0 * (q - r);
        p = (q > 0.0) ? -p : p;
        q = fabs(q);
        const double e_gold = (x >= xm) ? a - x : b - x;
        const double d_gold = CGOLD * e_gold;
        const bool para_ok = (fabs(e) > tol1) && (q > 0.0) && (fabs(p) < fabs(0.5 * q * e)) &&
                             (p > q * (a - x)) && (p < q * (b - x));
        double d_para = p / ((q == 0.0) ? 1.0 : q);
        const double u_try = x + d_para;
        if ((u_try - a < tol2) || (b - u_try < tol2)) d_para = (xm >= x) ? tol1 : -tol1;
        const double e2 = para_ok ? d : e_gold;
        const double d2 = para_ok ? d_para : d_gold;
        const double u = x + ((fabs(d2) >= tol1) ? d2 : ((d2 >= 0.0) ? tol1 : -tol1));
        const double fu = dev_at<P>(u, c);
        const bool better = fu <= fx;
        const double a2 = better ? ((u >= x) ? x : a) : ((u < x) ? u : a);
        const double b2 = better ? ((u >= x) ? b : x) : ((u < x) ? b : u);
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
        a = a2;
        b = b2;
        d = d2;
        e = e2;
    }
    return x;
}

template <int P>
__global__ void reml_intercept_kernel(const double* __restrict__ nj, const double* __restrict__ s,
                                      const double* __restrict__ t,
                                      const double* __restrict__ xtx,
                                      const double* __restrict__ xty,
                                      const double* __restrict__ yty,
                                      const double* __restrict__ ns, int B, int G, int m,
                                      double eps_rank, double* __restrict__ beta_out,
                                      double* __restrict__ cov_out,
                                      double* __restrict__ tau2_out,
                                      uint8_t* __restrict__ flags_out) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    Cell<P> c;
    c.nj = nj + (long long)b * m;
    c.s = s + (long long)b * m * P;
    c.t = t + (long long)b * m;
    c.m = m;
#pragma unroll
    for (int i = 0; i < P * P; ++i) c.xtx[i] = xtx[(long long)b * P * P + i];
#pragma unroll
    for (int i = 0; i < P; ++i) c.xty[i] = xty[(long long)b * P + i];
    c.yty = yty[b];
    c.n = ns[b % G];

    const double lg_hat = brent_log_gamma<P>(c);
    const double dev_interior = dev_at<P>(lg_hat, c);
    const double dev_zero = dev_at<P>(LOG_GAMMA_LO, c);
    const bool boundary = (dev_zero <= dev_interior + 1e-10) || (lg_hat < BOUNDARY_LOG_GAMMA);
    const bool boundary_hi = !boundary && (lg_hat > BOUNDARY_LOG_GAMMA_HI);
    const double gamma_hat = boundary ? 0.0 : exp(lg_hat);

    double L[P * P], beta[P], sigma2;
    const double dev = reml_quantities<P>(gamma_hat, c, L, beta, sigma2);
    bool beta_ok = true;
#pragma unroll
    for (int i = 0; i < P; ++i) {
        beta_out[(long long)b * P + i] = beta[i];
        beta_ok = beta_ok && isfinite(beta[i]);
    }
    mcp::cho_inverse_scaled<P>(L, sigma2, cov_out + (long long)b * P * P);
    tau2_out[b] = gamma_hat * sigma2;
    const bool converged =
        isfinite(dev) && beta_ok && (sigma2 > 0.0) && mcp::chol_rank_ok<P>(L, eps_rank);
    flags_out[b] = (uint8_t)((converged ? 1 : 0) | (boundary ? 2 : 0) | (boundary_hi ? 4 : 0));
}

template <int P>
int launch(const double* nj, const double* s, const double* t, const double* xtx,
           const double* xty, const double* yty, const double* ns, int B, int G, int m,
           double eps_rank, double* beta, double* cov, double* tau2, uint8_t* flags,
           cudaStream_t stream) {
    const int threads = 128;
    const unsigned blocks = mcp_blocks(B, threads);
    if (blocks == 0) return (int)cudaErrorInvalidConfiguration;
    reml_intercept_kernel<P><<<blocks, threads, 0, stream>>>(nj, s, t, xtx, xty, yty, ns, B, G,
                                                             m, eps_rank, beta, cov, tau2, flags);
    return (int)cudaGetLastError();
}

}  // namespace

// B cells laid out (sims, G): cell b has n = ns[b % G] and its own m
// cluster statistics. flags bit 0 converged, bit 1 low pin, bit 2 high pin.
// Returns a cudaError_t.
extern "C" int mcp_reml_intercept(const void* nj, const void* s, const void* t, const void* xtx,
                                  const void* xty, const void* yty, const void* ns, int B, int G,
                                  int m, int p, double eps_rank, void* beta, void* cov,
                                  void* tau2, void* flags, void* stream) {
    if (B <= 0 || G <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
    MCP_DISPATCH_P(p, launch, (const double*)nj, (const double*)s, (const double*)t,
                   (const double*)xtx, (const double*)xty, (const double*)yty,
                   (const double*)ns, B, G, m, eps_rank, (double*)beta, (double*)cov,
                   (double*)tau2, (uint8_t*)flags, (cudaStream_t)stream)
}
