// K3 ols_solve: the per-cell OLS solve from prefix sufficient statistics.
//
// Replaces: the batched small Cholesky of mcpower_tpu/engine/smallchol.py
// (chol, cho_solve, cho_inverse, :34-349) as mcpower_tpu/engine/olsfit.py
// ::ols_grid_stats uses it (:102-129): per (sim, grid) cell, beta =
// (X'X)^-1 X'y, rss = y'y - beta'X'y, sigma^2 = rss / max(n - p_eff, 1),
// the Wald covariance sigma^2 (X'X)^-1, the overall F ((tss - rss) /
// max(p_eff - 1, 1)) / sigma^2 with tss = y'y - (sum y)^2 / n, and the
// convergence flag (finite positive sigma^2 and pivots, pivot ratio >=
// eps_rank). p_eff is the cell's fitted column count: p, or, for the
// reduced fit of a sparse-factor exclusion (olsfit.py:91-97), the columns
// its mask keeps; the masked columns reach the kernel as zero rows and
// columns of X'X with a unit diagonal, whose unit pivots take part in the
// pivot-ratio test as the reference's do.
//
// What bounds it on H100: the bytes. A cell reads p^2 + p + 2 doubles (one
// more with a p_eff) and writes p^2 + p + 1 (73.7 MB at the curve's 80,000
// cells of p = 7, 0.022 ms at 3.35 TB/s), against a few hundred f64
// operations. What holds it above that is latency: each lane waits on a
// chain of square roots and divisions (PERF.md: faster with more resident
// warps). One thread per cell would be far from that: its A and L arrays
// (2 p^2 doubles) would fill its registers, each warp load and store would
// touch 32 lines p^2 doubles apart, and the factor and its p + 1 solves (2p
// IEEE divisions each) would run one after another.
//
// What the design does about it:
// - a group of lanes per cell, the next power of two at or above p + 1 (8
//   at p = 7, 4 at p = 2; group_lanes below), so a warp holds 32 / lanes
//   consecutive cells;
// - the warp stages its cells' X'X and X'y in shared memory with coalesced
//   16-byte loads, and writes the covariance and beta back from shared
//   memory with coalesced 16-byte stores; overall and the flag are written
//   once per cell;
// - the factor is row-parallel: for column j, lane i owns row i and
//   computes L[i][j] with the k = 0..j-1 order of smallchol.cuh::chol; row
//   j's entries and the pivot travel by shuffle. The pivots, and with them
//   the flags, are the plain version's;
// - the solves run side by side: lane j < p solves column j of the inverse
//   and lane p solves beta, p + 1 independent chains where one thread ran
//   them in sequence. L is read from shared memory, where each lane wrote
//   its row;
// - each solve step divides by its pivot through the pivot's correctly
//   rounded reciprocal (the factor's 1 / L[j][j]) and two Markstein
//   corrections (div_by_pivot): the IEEE quotient in five dependent
//   operations, where an IEEE division rebuilds the reciprocal each time.
// Every value keeps the plain version's operations, order and rounding
// (the file is built with --fmad=false; each quotient is the correctly
// rounded one the plain version's division gives): only the sum beta'X'y
// is taken in another order than torch's sum. The routines of
// smallchol.cuh stay as K4 uses them.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int OLS_THREADS = 128;
constexpr int OLS_WARPS = OLS_THREADS / 32;

// Lanes per cell: the next power of two at or above p + 1.
__host__ __device__ constexpr int group_lanes(int p) {
    return p + 1 <= 2 ? 2 : p + 1 <= 4 ? 4 : p + 1 <= 8 ? 8 : p + 1 <= 16 ? 16 : 32;
}

__host__ __device__ constexpr int round_even(int n) { return (n + 1) & ~1; }

// n doubles between global and shared memory by the 32 lanes of a warp:
// 16 bytes a lane where the global address allows it. The shared buffers
// are 16-byte aligned.
__device__ __forceinline__ void warp_load(double* __restrict__ s, const double* __restrict__ g,
                                          int n, int lane) {
    if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
        const double2* g2 = reinterpret_cast<const double2*>(g);
        double2* s2 = reinterpret_cast<double2*>(s);
        for (int i = lane; i < n / 2; i += 32) s2[i] = __ldg(g2 + i);
        if ((n & 1) && lane == 0) s[n - 1] = __ldg(g + n - 1);
    } else {
        for (int i = lane; i < n; i += 32) s[i] = __ldg(g + i);
    }
}

__device__ __forceinline__ void warp_store(double* __restrict__ g, const double* __restrict__ s,
                                           int n, int lane) {
    if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
        double2* g2 = reinterpret_cast<double2*>(g);
        const double2* s2 = reinterpret_cast<const double2*>(s);
        for (int i = lane; i < n / 2; i += 32) g2[i] = s2[i];
        if ((n & 1) && lane == 0) g[n - 1] = s[n - 1];
    } else {
        for (int i = lane; i < n; i += 32) g[i] = s[i];
    }
}

// s / d, correctly rounded, from y = 1 / d correctly rounded (the factor's
// inv_d): q = s y, then two Markstein corrections q + (s - d q) y, each
// residual exact by fma. The second starts within an ulp of s / d, so it
// rounds to the IEEE quotient (Markstein's theorem; no over- or underflow
// at the solves' magnitudes). Five dependent operations where an IEEE
// division, which rebuilds the reciprocal each time, takes about twenty.
__device__ __forceinline__ double div_by_pivot(double s, double d, double y) {
    double q = s * y;
    q = fma(fma(-d, q, s), y, q);
    return fma(fma(-d, q, s), y, q);
}

template <int P, int LANES>
__global__ void __launch_bounds__(OLS_THREADS)
    ols_solve_kernel(const double* __restrict__ xtx, const double* __restrict__ xty,
                     const double* __restrict__ yty, const double* __restrict__ ysum,
                     const double* __restrict__ ns, const double* __restrict__ peff, int B,
                     int G, double eps_rank, double* __restrict__ beta, double* __restrict__ cov,
                     double* __restrict__ overall, uint8_t* __restrict__ conv) {
    constexpr int CPW = 32 / LANES;  // cells per warp
    constexpr int PP = P * P;
    constexpr int MAT = round_even(CPW * PP);
    constexpr int VEC = round_even(CPW * P);
    // Per warp: X'X in, then the covariance out; L; X'y in, then beta out.
    __shared__ __align__(16) double s_mat[OLS_WARPS][MAT];
    __shared__ __align__(16) double s_chol[OLS_WARPS][MAT];
    __shared__ __align__(16) double s_vec[OLS_WARPS][VEC];
    __shared__ double s_rinv[OLS_WARPS][CPW * P];

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long first = ((long long)blockIdx.x * OLS_WARPS + warp) * CPW;
    if (first >= B) return;  // warp-uniform
    const int cell0 = (int)first;
    const int ncell = min(CPW, B - cell0);
    const int g = lane / LANES;  // this lane's cell in the warp
    const int r = lane % LANES;  // its lane in the cell's group
    const int src0 = g * LANES;  // the group's lane 0
    double* A = s_mat[warp];
    double* Lm = s_chol[warp];
    double* V = s_vec[warp];
    double* Rm = s_rinv[warp];  // each pivot's reciprocal, inv_d of the factor

    warp_load(A, xtx + (size_t)cell0 * PP, ncell * PP, lane);
    warp_load(V, xty + (size_t)cell0 * P, ncell * P, lane);
    __syncwarp();

    // Factor: lane r < P holds row r of A and of L. Lanes past p, and the
    // groups of a partial warp's missing cells, compute on rows they never
    // store (row min(r, P - 1), or stale shared memory).
    const int row = r < P ? r : P - 1;
    double a[P], l[P], rinv = 0.0;
#pragma unroll
    for (int k = 0; k < P; ++k) a[k] = A[g * PP + row * P + k];
#pragma unroll
    for (int j = 0; j < P; ++j) {
        double s = a[j];
#pragma unroll
        for (int k = 0; k < j; ++k) s = s - l[k] * __shfl_sync(0xFFFFFFFFu, l[k], src0 + j);
        // Lane j's s is d of smallchol.cuh::chol; every lane takes the root of
        // that one value (a root of another lane's s, often negative, would
        // send those lanes down sqrt's slow path).
        const double piv = sqrt(__shfl_sync(0xFFFFFFFFu, s, src0 + j));
        const double inv_d = 1.0 / piv;
        l[j] = r == j ? piv : (r > j ? s * inv_d : 0.0);
        rinv = r == j ? inv_d : rinv;
    }
    if (r < P) {
#pragma unroll
        for (int k = 0; k < P; ++k) Lm[g * PP + r * P + k] = l[k];
        Rm[g * P + r] = rinv;
    }
    __syncwarp();

    // Solves: lane r < P against e_r (column r of the inverse), lane P
    // against X'y (beta); the order of smallchol.cuh::cho_solve.
    const double* L = Lm + g * PP;
    const double* R = Rm + g * P;
    double y[P], x[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
        double s = r == P ? V[g * P + i] : (i == r ? 1.0 : 0.0);
#pragma unroll
        for (int k = 0; k < i; ++k) s = s - L[i * P + k] * y[k];
        y[i] = div_by_pivot(s, L[i * P + i], R[i]);
    }
#pragma unroll
    for (int i = P - 1; i >= 0; --i) {
        double s = y[i];
#pragma unroll
        for (int k = i + 1; k < P; ++k) s = s - L[k * P + i] * x[k];
        x[i] = div_by_pivot(s, L[i * P + i], R[i]);
    }

    // Lane P: rss, sigma^2, overall F, the flag; beta into the staging.
    const int cell = cell0 + g;
    double sigma2 = 0.0;
    if (r == P && g < ncell) {
        double bx = 0.0;
#pragma unroll
        for (int i = 0; i < P; ++i) bx = bx + x[i] * V[g * P + i];
        const double yy = yty[cell];
        const double rss = yy - bx;
        const double n = ns[cell % G];
        const double p_eff = peff != nullptr ? peff[cell] : (double)P;
        sigma2 = rss / fmax(n - p_eff, 1.0);
        const double ys = ysum[cell];
        const double tss = yy - ys * ys / n;
        overall[cell] = ((tss - rss) / fmax(p_eff - 1.0, 1.0)) / sigma2;
        bool ok = true;
        double lo = L[0], hi = L[0];
#pragma unroll
        for (int i = 0; i < P; ++i) {
            const double d = L[i * P + i];
            ok = ok && isfinite(d) && (d > 0.0);
            lo = fmin(lo, d);
            hi = fmax(hi, d);
        }
        conv[cell] = (uint8_t)(isfinite(sigma2) && (sigma2 > 0.0) && ok && (lo >= eps_rank * hi));
#pragma unroll
        for (int i = 0; i < P; ++i) V[g * P + i] = x[i];
    }
    sigma2 = __shfl_sync(0xFFFFFFFFu, sigma2, src0 + P);
    // Lane r < P: column r of the covariance, over X'X's staging (read
    // into registers before the factor).
    if (r < P) {
#pragma unroll
        for (int i = 0; i < P; ++i) A[g * PP + i * P + r] = sigma2 * x[i];
    }
    __syncwarp();
    warp_store(cov + (size_t)cell0 * PP, A, ncell * PP, lane);
    warp_store(beta + (size_t)cell0 * P, V, ncell * P, lane);
}

template <int P>
static int launch(const double* xtx, const double* xty, const double* yty, const double* ysum,
                  const double* ns, const double* peff, int B, int G, double eps_rank,
                  double* beta, double* cov, double* overall, uint8_t* conv,
                  cudaStream_t stream) {
    constexpr int LANES = group_lanes(P);
    const long long cells_per_block = (long long)OLS_WARPS * (32 / LANES);
    const unsigned blocks = mcp_blocks((B + cells_per_block - 1) / cells_per_block, 1);
    if (blocks == 0) return (int)cudaErrorInvalidConfiguration;
    ols_solve_kernel<P, LANES><<<blocks, OLS_THREADS, 0, stream>>>(
        xtx, xty, yty, ysum, ns, peff, B, G, eps_rank, beta, cov, overall, conv);
    return (int)cudaGetLastError();
}

}  // namespace

// B cells laid out (sims, G): cell b has n = ns[b % G] and fits peff[b]
// columns (p in every cell when peff is null). Returns a cudaError_t.
extern "C" int mcp_ols_solve(const void* xtx, const void* xty, const void* yty, const void* ysum,
                             const void* ns, const void* peff, int B, int G, int p,
                             double eps_rank, void* beta, void* cov, void* overall, void* conv,
                             void* stream) {
    if (B <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
    MCP_DISPATCH_P(p, launch, (const double*)xtx, (const double*)xty, (const double*)yty,
                   (const double*)ysum, (const double*)ns, (const double*)peff, B, G, eps_rank,
                   (double*)beta, (double*)cov, (double*)overall, (uint8_t*)conv,
                   (cudaStream_t)stream)
}
