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
// What bounds it on H100: the dependency chain of one cell. Each of the 24
// deviance evaluations walks the m cluster statistics (one f64 division,
// one log1p and p^2 / 2 + 2p + 2 multiply-adds per cluster) and then
// factors a p x p matrix, solves with it and takes p + 1 logs, each step
// waiting on the last. At the main path's 10,000 cells of m = 20, p = 3 the
// f64 work is ~0.19 G instructions (~11 us at the card's f64 rate, counted
// as chip_smoke.py counts it) against ~3 us for the ~10 MB it reads and
// writes, so operations bound it on paper; in practice a cell's 24
// evaluations cannot overlap, and the lanes of a group each repeat the
// p x p work. One thread per cell gave only 10,000 threads, 79 blocks of
// 128 on 132 SMs, 4 warps on each busy SM.
//
// What the design does about it:
// - A group of L lanes per cell (L a power of two chosen by the launcher
//   from m and p, lanes_for; 4 at m = 20), so the main path puts ~1,250
//   warps on all SMs and each lane walks a quarter of the clusters. L stays
//   small (at most MAX_LANES) because every lane of the group repeats the
//   cell's serial p x p work.
// - Each lane loads its clusters j = lane, lane + L, ... (up to
//   clusters_per_lane<P>() of them, 4 for p <= 4) into registers once and
//   keeps them for all 24 evaluations; clusters beyond that are read from
//   memory on each evaluation, so any m >= 1 is taken.
// - The division and log1p of a cluster depend on gamma and n_j alone; a
//   lane recomputes them only when n_j changes from its previous cluster,
//   so a balanced layout pays one of each per lane and evaluation. The
//   values are the same bits as recomputing them.
// - Per evaluation each lane forms its partial W, V, Y and sum log1p(gamma
//   n_j), and the group adds them with an xor butterfly of __shfl_xor_sync.
//   Addition is commutative, so every lane then holds bit-identical sums and
//   runs the same p x p Cholesky and the same lane-select Brent steps: no
//   divergence inside the group. The lanes share out the writes of beta and
//   cov; lane 0 writes tau^2 and the flags.
// - p is a template constant so the p x p algebra unrolls with static
//   indices (smallchol.cuh). Built with --fmad=false: each cluster term
//   follows the plain version's operation order, only the order of the sum
//   over clusters differs (a tree, not a sequence), so the pins, which hinge
//   on 1e-10 deviance gaps, agree with it.

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

constexpr int MAX_LANES = 4;

// Registers held per lane for its own clusters; wider fits hold fewer.
template <int P>
__host__ __device__ constexpr int clusters_per_lane() {
    return P <= 4 ? 4 : (P <= 6 ? 2 : 1);
}

// Lanes per cell: the smallest power of two whose lanes hold all m clusters
// in registers, at most MAX_LANES; past that the kernel reads the remaining
// clusters from memory.
template <int P>
int lanes_for(int m) {
    const int need = (m + clusters_per_lane<P>() - 1) / clusters_per_lane<P>();
    int lanes = 1;
    while (lanes < need && lanes < MAX_LANES) lanes *= 2;
    return lanes;
}

template <int P>
struct Cell {
    static constexpr int CPL = clusters_per_lane<P>();
    // this lane's clusters j = lane + q L, q < CPL, in registers (count
    // `own`); clusters from L * CPL on are read from memory
    double nj[CPL], t[CPL], s[CPL][P];
    int own;
    const double* nj_g;  // (m,)
    const double* s_g;   // (m, P)
    const double* t_g;   // (m,)
    int m, lane, L;
    unsigned mask;  // the group's lanes
    double xtx[P * P];
    double xty[P];
    double yty;
    double n;
};

// The per-cluster factors c_j = gamma / (1 + gamma n_j) and log1p(gamma n_j)
// depend on n_j alone: a lane keeps the last pair and recomputes only when
// n_j changes, which in a balanced layout (every n_j equal) is once per
// evaluation. The values are the same bits either way.
struct ClusterFactors {
    double nj = -1.0;  // no row count is negative
    double cj = 0.0, l1p = 0.0;
    __device__ __forceinline__ void at(double gamma, double n) {
        if (n != nj) {
            nj = n;
            cj = gamma / (1.0 + gamma * n);
            l1p = log1p(gamma * n);
        }
    }
};

// One cluster's terms, in the plain version's operation order.
template <int P>
__device__ __forceinline__ void cluster_terms(double gamma, double nj, const double* sj,
                                              double tj, ClusterFactors& f, double* W, double* V,
                                              double& Y, double& logdet_v) {
    f.at(gamma, nj);
    const double cj = f.cj;
#pragma unroll
    for (int a = 0; a < P; ++a) {
        const double cs = cj * sj[a];
#pragma unroll
        for (int b = 0; b <= a; ++b) W[a * P + b] = W[a * P + b] + cs * sj[b];
        V[a] = V[a] + cs * tj;
    }
    Y = Y + (cj * tj) * tj;
    logdet_v = logdet_v + f.l1p;
}

// Profile-REML pieces at gamma; fills L, beta, sigma2 and returns the
// deviance, the same on every lane of the group. Same operations, in the
// same order, as the plain mixedfit._reml_quantities except for the order
// of the sum over clusters: the cluster sums are formed first (per lane,
// then over the group) and then subtracted from X'X, X'y, y'y.
template <int P>
__device__ double reml_quantities(double gamma, const Cell<P>& c, double* L, double* beta,
                                  double& sigma2) {
    double W[P * P], V[P];
#pragma unroll
    for (int i = 0; i < P * P; ++i) W[i] = 0.0;
#pragma unroll
    for (int i = 0; i < P; ++i) V[i] = 0.0;
    double Y = 0.0, logdet_v = 0.0;
    ClusterFactors f;
#pragma unroll
    for (int q = 0; q < Cell<P>::CPL; ++q)
        if (q < c.own) cluster_terms<P>(gamma, c.nj[q], c.s[q], c.t[q], f, W, V, Y, logdet_v);
    for (int j = c.lane + Cell<P>::CPL * c.L; j < c.m; j += c.L) {
        double sj[P];
#pragma unroll
        for (int a = 0; a < P; ++a) sj[a] = c.s_g[j * P + a];
        cluster_terms<P>(gamma, c.nj_g[j], sj, c.t_g[j], f, W, V, Y, logdet_v);
    }
    for (int off = c.L >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int a = 0; a < P; ++a) {
#pragma unroll
            for (int b = 0; b <= a; ++b)
                W[a * P + b] = W[a * P + b] + __shfl_xor_sync(c.mask, W[a * P + b], off);
            V[a] = V[a] + __shfl_xor_sync(c.mask, V[a], off);
        }
        Y = Y + __shfl_xor_sync(c.mask, Y, off);
        logdet_v = logdet_v + __shfl_xor_sync(c.mask, logdet_v, off);
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

// The reference's lane-select Brent, run alike by every lane of the group:
// every candidate is computed and then selected, so the step sequence
// matches the plain version's.
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
                                      const double* __restrict__ ns, int B, int G, int m, int L,
                                      double eps_rank, double* __restrict__ beta_out,
                                      double* __restrict__ cov_out,
                                      double* __restrict__ tau2_out,
                                      uint8_t* __restrict__ flags_out) {
    const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long b = gid / L;
    if (b >= B) return;  // whole groups leave together
    Cell<P> c;
    c.lane = (int)(gid % L);
    const int warp_lane = threadIdx.x & 31;
    c.mask = (L == 32) ? 0xffffffffu : (((1u << L) - 1u) << (warp_lane & ~(L - 1)));
    c.L = L;
    c.m = m;
    c.nj_g = nj + b * m;
    c.s_g = s + b * m * P;
    c.t_g = t + b * m;
    c.own = 0;
#pragma unroll
    for (int q = 0; q < Cell<P>::CPL; ++q) {
        const int j = c.lane + q * L;
        const bool have = j < m;
        c.own += have ? 1 : 0;
        c.nj[q] = have ? c.nj_g[j] : 0.0;
        c.t[q] = have ? c.t_g[j] : 0.0;
#pragma unroll
        for (int a = 0; a < P; ++a) c.s[q][a] = have ? c.s_g[j * P + a] : 0.0;
    }
#pragma unroll
    for (int i = 0; i < P * P; ++i) c.xtx[i] = xtx[b * P * P + i];
#pragma unroll
    for (int i = 0; i < P; ++i) c.xty[i] = xty[b * P + i];
    c.yty = yty[b];
    c.n = ns[b % G];

    const double lg_hat = brent_log_gamma<P>(c);
    const double dev_interior = dev_at<P>(lg_hat, c);
    const double dev_zero = dev_at<P>(LOG_GAMMA_LO, c);
    const bool boundary = (dev_zero <= dev_interior + 1e-10) || (lg_hat < BOUNDARY_LOG_GAMMA);
    const bool boundary_hi = !boundary && (lg_hat > BOUNDARY_LOG_GAMMA_HI);
    const double gamma_hat = boundary ? 0.0 : exp(lg_hat);

    double Lc[P * P], beta[P], sigma2;
    const double dev = reml_quantities<P>(gamma_hat, c, Lc, beta, sigma2);
    bool beta_ok = true;
#pragma unroll
    for (int i = 0; i < P; ++i) {
        if (i % L == c.lane) beta_out[b * P + i] = beta[i];
        beta_ok = beta_ok && isfinite(beta[i]);
    }
#pragma unroll
    for (int j = 0; j < P; ++j)
        if (j % L == c.lane) mcp::cho_inverse_column_scaled<P>(Lc, j, sigma2, cov_out + b * P * P);
    if (c.lane == 0) {
        tau2_out[b] = gamma_hat * sigma2;
        const bool converged =
            isfinite(dev) && beta_ok && (sigma2 > 0.0) && mcp::chol_rank_ok<P>(Lc, eps_rank);
        flags_out[b] =
            (uint8_t)((converged ? 1 : 0) | (boundary ? 2 : 0) | (boundary_hi ? 4 : 0));
    }
}

template <int P>
int launch(const double* nj, const double* s, const double* t, const double* xtx,
           const double* xty, const double* yty, const double* ns, int B, int G, int m,
           double eps_rank, double* beta, double* cov, double* tau2, uint8_t* flags,
           cudaStream_t stream) {
    const int L = lanes_for<P>(m);
    const int threads = 128;
    const unsigned blocks = mcp_blocks((long long)B * L, threads);
    if (blocks == 0) return (int)cudaErrorInvalidConfiguration;
    reml_intercept_kernel<P><<<blocks, threads, 0, stream>>>(
        nj, s, t, xtx, xty, yty, ns, B, G, m, L, eps_rank, beta, cov, tau2, flags);
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
