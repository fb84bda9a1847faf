// K3 ols_solve: the per-cell OLS solve from prefix sufficient statistics.
//
// Replaces: the batched small Cholesky of mcpower_tpu/engine/smallchol.py
// (chol, cho_solve, cho_inverse, :34-349) as mcpower_tpu/engine/olsfit.py
// ::ols_grid_stats uses it (:102-129): per (sim, grid) cell, beta =
// (X'X)^-1 X'y, rss = y'y - beta'X'y, sigma^2 = rss / max(n - p, 1), the
// Wald covariance sigma^2 (X'X)^-1, the overall F ((tss - rss) / max(p - 1,
// 1)) / sigma^2 with tss = y'y - (sum y)^2 / n, and the convergence flag
// (finite positive sigma^2 and pivots, pivot ratio >= eps_rank).
//
// What bounds it on H100: f64 arithmetic and latency. A cell is ~p^3/2
// dependent f64 operations (factor, p + 1 solves) on ~p^2 inputs; at the
// main path's 10,000 x 8 cells of p = 7 that is a few MFLOP, far below the
// card's 67 TFLOP/s f64 peak, so the run is bounded by the dependent chain
// of one thread and by having only ~80k threads in flight.
//
// What the design does about it: one thread per cell with p a template
// constant (p <= 16), so the whole factorization unrolls into registers
// with static indices and no shared memory or synchronisation; 128-thread
// blocks keep many cells in flight per SM. A warp-per-cell layout is the
// obvious next step if this kernel ever shows in the arm's time.

#include "common.cuh"
#include "smallchol.cuh"

template <int P>
__global__ void ols_solve_kernel(const double* __restrict__ xtx, const double* __restrict__ xty,
                                 const double* __restrict__ yty, const double* __restrict__ ysum,
                                 const double* __restrict__ ns, int B, int G, double eps_rank,
                                 double* __restrict__ beta, double* __restrict__ cov,
                                 double* __restrict__ overall, uint8_t* __restrict__ conv) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    double A[P * P], L[P * P], v[P], x[P];
#pragma unroll
    for (int i = 0; i < P * P; ++i) A[i] = xtx[(long long)b * P * P + i];
#pragma unroll
    for (int i = 0; i < P; ++i) v[i] = xty[(long long)b * P + i];
    mcp::chol<P>(A, L);
    mcp::cho_solve<P>(L, v, x);

    double bx = 0.0;
#pragma unroll
    for (int i = 0; i < P; ++i) bx = bx + x[i] * v[i];
    const double yy = yty[b];
    const double rss = yy - bx;
    const double n = ns[b % G];
    const double p_eff = (double)P;
    const double sigma2 = rss / fmax(n - p_eff, 1.0);
    const double ys = ysum[b];
    const double tss = yy - ys * ys / n;
    overall[b] = ((tss - rss) / fmax(p_eff - 1.0, 1.0)) / sigma2;

#pragma unroll
    for (int i = 0; i < P; ++i) beta[(long long)b * P + i] = x[i];
    mcp::cho_inverse_scaled<P>(L, sigma2, cov + (long long)b * P * P);
    conv[b] = (uint8_t)(isfinite(sigma2) && (sigma2 > 0.0) && mcp::chol_rank_ok<P>(L, eps_rank));
}

template <int P>
static int launch(const double* xtx, const double* xty, const double* yty, const double* ysum,
                  const double* ns, int B, int G, double eps_rank, double* beta, double* cov,
                  double* overall, uint8_t* conv, cudaStream_t stream) {
    const int threads = 128;
    const unsigned blocks = mcp_blocks(B, threads);
    if (blocks == 0) return (int)cudaErrorInvalidConfiguration;
    ols_solve_kernel<P><<<blocks, threads, 0, stream>>>(xtx, xty, yty, ysum, ns, B, G, eps_rank,
                                                        beta, cov, overall, conv);
    return (int)cudaGetLastError();
}

// B cells laid out (sims, G): cell b has n = ns[b % G]. Returns a cudaError_t.
extern "C" int mcp_ols_solve(const void* xtx, const void* xty, const void* yty, const void* ysum,
                             const void* ns, int B, int G, int p, double eps_rank, void* beta,
                             void* cov, void* overall, void* conv, void* stream) {
    if (B <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
    MCP_DISPATCH_P(p, launch, (const double*)xtx, (const double*)xty, (const double*)yty,
                   (const double*)ysum, (const double*)ns, B, G, eps_rank, (double*)beta,
                   (double*)cov, (double*)overall, (uint8_t*)conv, (cudaStream_t)stream)
}
