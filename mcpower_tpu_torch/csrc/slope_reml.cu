// K9 slope_reml: the whole random-slope REML fit of one (sim, grid) cell.
//
// Replaces: mcpower_tpu/engine/mixedfit.py::_slope_grid_stats.per_grid
// (:385-459) with _vech_to_lower (:298), _reml_quantities_q (:309) and
// mcpower_tpu/engine/optim.py::nelder_mead (:61) / _select_candidate (:44),
// which XLA fuses into one program per design. Per cell, from K2's
// slope-mode statistics G = sum z z' (m, q, q), A = sum z x' (m, q, p),
// b = sum z y (m, q) and X'X, X'y, y'y (f64):
//   1. the f32 twins of the statistics (a cast of the f64 prefix sums);
//   2. a shrink-free Nelder-Mead over theta = vech chol(D / sigma^2)
//      (d = q (q + 1) / 2 <= 10) from the truth start: the d + 1 initial
//      vertices, then `iters` (140) iterations of four candidates each, on
//      the f32 profiled REML deviance (a non-finite one ranks as f32(1e30));
//   3. the f64 deviance at the optimum and with each component's Cholesky
//      column zeroed: a component whose removal costs at most 1e-10 is
//      pinned, and stays zeroed;
//   4. the final f64 fit: beta, cov = sigma^2 (X'V^-1X)^-1, tau^2 =
//      Gamma[0][0] sigma^2, converged = finite deviance and beta,
//      sigma^2 > 0 and the pivot-ratio rank test; boundary = any pin.
// One deviance evaluation: per cluster C = I + Lam' G Lam (q x q) and its
// Cholesky, A~ = Lam' A, b~ = Lam' b and their solves, the terms
// A~' C^-1 A~, A~' C^-1 b~, b~' C^-1 b~ and log|C|; the sums over clusters;
// then the p x p Cholesky of X'V^-1X = X'X - sum, beta, rss and
// dev = (log|V| + log|X'V^-1X|) + (n - p) log(rss).
//
// Bit identity with the plain version (mixedfit.slope_reml_plain, with
// optim.nelder_mead): every operation is the plain version's, in its order.
// Each cluster term is a sum over the q components from the first; the sums
// over clusters follow SLOPE_LANES = 8 lanes (lane l adds clusters l, l + 8,
// ... to a zero in turn; then a pair tree at distances 4, 2, 1, here an xor
// butterfly of warp shuffles, exact because addition commutes); the small
// factors are smallchol's order (the factor multiplies by the reciprocal
// pivot, the solves divide). The Nelder-Mead keeps its vertices in f64 in
// the plain version's order: a stable insertion sort of the d + 1 values
// (ties keep their order), the centroid as the d best vertices added in
// sorted order times the f64 reciprocal of d, candidates clipped at `lower`, the first
// minimum at the end. The search follows the rounding of its comparisons, so
// a kernel that agreed only to 1e-7 could end at another vertex and flip a
// pin; built with --fmad=false, it agrees in every bit.
//
// What bounds it on H100: the dependency chain of one cell. A cell runs
// ceil((d + 1) / 4) + 140 rounds of f32 evaluations and 2 or 3 rounds of f64
// ones, each waiting on the last (the simplex decides the next candidates);
// per evaluation m (q^3 + q^2 p + q p^2 / 2) f32 multiply-adds and the
// p x p factor. At README flow 2's launch (1,250 cells, m = 30, q = 2,
// p = 2) the operations are ~0.1 G f32 (chip_smoke.k9_bound counts them),
// a few us at the card's f32 rate, against ~0.1 ms of one cell's chain.
//
// What the design does about it:
// - One warp a cell, four warps a block. The warp's four 8-lane groups each
//   evaluate one candidate (the four Nelder-Mead candidates of an
//   iteration are independent), the lanes of a group walking its clusters
//   l, l + 8, ...; every lane of the group then holds the sums and repeats
//   the p x p factor (no divergence inside the group).
// - Lane 0 keeps the simplex in shared memory (vertices, values, the sorted
//   order) and runs the sort, the candidates and the selection between
//   rounds; the groups read their candidate from shared memory.
// - The cell's f32 twins of G, A and b sit in shared memory when they fit
//   (m (q^2 + q p + q) floats, at most STAGE_BYTES a warp), cast once from
//   the f64 statistics; otherwise every f32 evaluation casts them from
//   device memory (L1/L2), so any m is taken. The f64 evaluations read the
//   f64 statistics from device memory.
// - q is a template constant (2, 3, 4) and p too where it pays (2, 3, 4);
//   wider fits take the p <= 8 and p <= 16 instantiations with run-time
//   guards. Matrices of p x p are packed lower triangles.

#include "common.cuh"
#include "nelder_mead.cuh"
#include "smallchol.cuh"

namespace {

using mcp::chol_packed_rt;
using mcp::cho_solve_packed_rt;

constexpr int WARP = 32;
constexpr int GROUP = 8;  // lanes on one candidate (SLOPE_LANES)
constexpr int GROUPS = WARP / GROUP;
constexpr int WARPS_PER_BLOCK = 4;
constexpr int MAX_D = 10;
constexpr int STAGE_BYTES = 16 * 1024;  // f32 twins of one cell, at most
constexpr double PIN_MARGIN = 1e-10;
constexpr float SENTINEL32 = 1e30f;  // a failed f32 evaluation's rank, widened
constexpr double SENTINEL64 = 1e30;  // a failed f64 evaluation's

struct Args {
    const double *G, *A, *b, *xtx, *xty, *yty, *ns;
    int B, Gn, m, p, iters, staged;
    double init_step, eps_rank;
    double theta0[MAX_D], lower[MAX_D];
    double *beta, *cov, *tau2;
    uint8_t *flags, *pinned;
};

// One warp's Nelder-Mead state and candidates, in shared memory.
struct Simplex {
    double verts[MAX_D + 1][MAX_D];
    double fvals[MAX_D + 1];
    double cand[GROUPS][MAX_D];
    double fc[GROUPS];
    double theta[MAX_D];  // the search's optimum
    int ord[MAX_D + 1];   // vertex at each sorted position
    int pinned[4];
};

__host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }

template <int Q>
__host__ __device__ constexpr int twin_floats(int m, int p) {
    return m * (Q * Q + Q * p + Q);
}

// A statistic as T: the f32 twin (staged, or cast from device memory) or the
// f64 value.
template <typename T>
__device__ __forceinline__ T ld(const float* s32, const double* g64, long long i);
template <>
__device__ __forceinline__ float ld<float>(const float* s32, const double* g64, long long i) {
    return s32 ? s32[i] : (float)g64[i];
}
template <>
__device__ __forceinline__ double ld<double>(const float*, const double* g64, long long i) {
    return g64[i];
}

// Every statistic of one evaluation, summed over a lane's clusters.
template <int PM, typename T>
struct Sums {
    static constexpr int NT = PM * (PM + 1) / 2;
    T xx[NT], xy[PM], yy, ld;
};

// The profiled REML deviance at the group's candidate `th` (shared memory,
// d entries), in T; fills the packed Cholesky of X'V^-1X, beta and sigma^2.
// One call site per T: the f32 search and the f64 probes and final fit.
template <int Q, int PM, typename T>
__device__ __forceinline__ T deviance(const Args& a, long long cell, const float* twin,
                                      const double* th, int sl, T* L, T* beta, T& sigma2) {
    const int m = a.m, p = a.p;
    T lam[Q][Q];
    {
        int k = 0;
#pragma unroll
        for (int j = 0; j < Q; ++j) {
#pragma unroll
            for (int i = 0; i < Q; ++i) {
                if (i >= j) lam[i][j] = (T)th[k++];
                else lam[i][j] = T(0);
            }
        }
    }
    Sums<PM, T> s;
#pragma unroll
    for (int i = 0; i < Sums<PM, T>::NT; ++i) s.xx[i] = T(0);
#pragma unroll
    for (int i = 0; i < PM; ++i) s.xy[i] = T(0);
    s.yy = T(0);
    s.ld = T(0);

    const float* tG = twin;
    const float* tA = twin ? twin + (long long)m * Q * Q : nullptr;
    const float* tb = twin ? tA + (long long)m * Q * p : nullptr;
    const double* gG = a.G + cell * m * Q * Q;
    const double* gA = a.A + cell * m * Q * p;
    const double* gb = a.b + cell * m * Q;
    for (int c = sl; c < m; c += GROUP) {
        T Gc[Q][Q];
#pragma unroll
        for (int r = 0; r < Q; ++r)
#pragma unroll
            for (int cc = 0; cc < Q; ++cc)
                Gc[r][cc] = ld<T>(tG, gG, (long long)c * Q * Q + r * Q + cc);
        // Lam' G, then C = I + (Lam' G) Lam (lower triangle)
        T LtG[Q][Q];
#pragma unroll
        for (int j = 0; j < Q; ++j) {
#pragma unroll
            for (int cc = 0; cc < Q; ++cc) {
                T acc = lam[j][j] * Gc[j][cc];
#pragma unroll
                for (int r = j + 1; r < Q; ++r) acc = acc + lam[r][j] * Gc[r][cc];
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
                    for (int r = k + 1; r < Q; ++r) acc = acc + LtG[j][r] * lam[r][k];
                    C[j * Q + k] = (k == j) ? T(1) + acc : acc;
                } else {
                    C[j * Q + k] = T(0);
                }
            }
        }
        mcp::chol<Q, T>(C, Lc);
        // b~ = Lam' b and its solve
        T bc[Q], bt[Q], solb[Q];
#pragma unroll
        for (int r = 0; r < Q; ++r) bc[r] = ld<T>(tb, gb, (long long)c * Q + r);
#pragma unroll
        for (int r = 0; r < Q; ++r) {
            T acc = lam[r][r] * bc[r];
#pragma unroll
            for (int t = r + 1; t < Q; ++t) acc = acc + lam[t][r] * bc[t];
            bt[r] = acc;
        }
        mcp::cho_solve<Q>(Lc, bt, solb);
        {
            T yy = bt[0] * solb[0];
#pragma unroll
            for (int r = 1; r < Q; ++r) yy = yy + bt[r] * solb[r];
            s.yy = s.yy + yy;
            T lsum = log(Lc[0]);
#pragma unroll
            for (int r = 1; r < Q; ++r) lsum = lsum + log(Lc[r * Q + r]);
            s.ld = s.ld + T(2) * lsum;
        }
        // A~ = Lam' A column by column: its solve, then row a of the terms
        T solA[PM][Q];
#pragma unroll
        for (int aa = 0; aa < PM; ++aa) {
            if (aa < p) {
                T Ac[Q], At[Q];
#pragma unroll
                for (int r = 0; r < Q; ++r)
                    Ac[r] = ld<T>(tA, gA, (long long)c * Q * p + (long long)r * p + aa);
#pragma unroll
                for (int r = 0; r < Q; ++r) {
                    T acc = lam[r][r] * Ac[r];
#pragma unroll
                    for (int t = r + 1; t < Q; ++t) acc = acc + lam[t][r] * Ac[t];
                    At[r] = acc;
                }
                mcp::cho_solve<Q>(Lc, At, solA[aa]);
#pragma unroll
                for (int bb = 0; bb <= aa; ++bb) {
                    T acc = At[0] * solA[bb][0];
#pragma unroll
                    for (int r = 1; r < Q; ++r) acc = acc + At[r] * solA[bb][r];
                    s.xx[tri(aa, bb)] = s.xx[tri(aa, bb)] + acc;
                }
                T xy = At[0] * solb[0];
#pragma unroll
                for (int r = 1; r < Q; ++r) xy = xy + At[r] * solb[r];
                s.xy[aa] = s.xy[aa] + xy;
            }
        }
    }
    // the group's lanes combine: distances 4, 2, 1
#pragma unroll
    for (int dist = GROUP / 2; dist >= 1; dist >>= 1) {
#pragma unroll
        for (int i = 0; i < Sums<PM, T>::NT; ++i)
            s.xx[i] = s.xx[i] + __shfl_xor_sync(0xffffffffu, s.xx[i], dist);
#pragma unroll
        for (int i = 0; i < PM; ++i) s.xy[i] = s.xy[i] + __shfl_xor_sync(0xffffffffu, s.xy[i], dist);
        s.yy = s.yy + __shfl_xor_sync(0xffffffffu, s.yy, dist);
        s.ld = s.ld + __shfl_xor_sync(0xffffffffu, s.ld, dist);
    }
    // X'V^-1X, its factor, beta, rss and the deviance
    const double* xtx = a.xtx + cell * p * p;
    const double* xty = a.xty + cell * p;
    T axy[PM];
#pragma unroll
    for (int i = 0; i < PM; ++i) {
        if (i < p) {
#pragma unroll
            for (int j = 0; j <= i; ++j) L[tri(i, j)] = (T)xtx[i * p + j] - s.xx[tri(i, j)];
            axy[i] = (T)xty[i] - s.xy[i];
        }
    }
    const T ayy = (T)a.yty[cell] - s.yy;
    chol_packed_rt<PM>(L, p);
    cho_solve_packed_rt<PM>(L, axy, beta, p);
    T bxy = beta[0] * axy[0];
#pragma unroll
    for (int i = 1; i < PM; ++i)
        if (i < p) bxy = bxy + beta[i] * axy[i];
    const T rss = ayy - bxy;
    const T df = (T)a.ns[cell % a.Gn] - (T)p;
    sigma2 = rss / df;
    T ldx = log(L[0]);
#pragma unroll
    for (int i = 1; i < PM; ++i)
        if (i < p) ldx = ldx + log(L[tri(i, i)]);
    ldx = T(2) * ldx;
    return (s.ld + ldx) + df * log(rss);
}

template <int Q, int PM>
__global__ void __launch_bounds__(WARP * WARPS_PER_BLOCK)
    slope_reml_kernel(const Args a) {
    constexpr int D = Q * (Q + 1) / 2;
    constexpr int NT = PM * (PM + 1) / 2;
    extern __shared__ __align__(16) unsigned char smem[];
    const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
    const int g = lane / GROUP, sl = lane % GROUP;
    const long long cell = (long long)blockIdx.x * WARPS_PER_BLOCK + warp;
    if (cell >= a.B) return;  // a whole warp leaves together
    const int m = a.m, p = a.p;
    const int tf = a.staged ? twin_floats<Q>(m, p) : 0;
    const size_t warp_bytes = sizeof(Simplex) + (size_t)((tf + 3) & ~3) * sizeof(float);
    Simplex& S = *reinterpret_cast<Simplex*>(smem + warp * warp_bytes);
    float* twin = a.staged ? reinterpret_cast<float*>(smem + warp * warp_bytes + sizeof(Simplex))
                           : nullptr;
    if (twin) {  // G, A, b of the cell as f32, in that order
        const long long gq = (long long)m * Q * Q, aq = (long long)m * Q * p;
        for (int i = lane; i < tf; i += WARP) {
            double v;
            if (i < gq) v = a.G[cell * gq + i];
            else if (i < gq + aq) v = a.A[cell * aq + (i - gq)];
            else v = a.b[cell * m * Q + (i - gq - aq)];
            twin[i] = (float)v;
        }
    }
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

    float L32[NT], beta32[PM], s32;
    const int init_rounds = (D + 1 + GROUPS - 1) / GROUPS;
    for (int round = 0; round < init_rounds + a.iters; ++round) {
        if (lane == 0) {
            if (round < init_rounds) {
                for (int gg = 0; gg < GROUPS; ++gg) {
                    const int v = min(round * GROUPS + gg, D);
                    for (int k = 0; k < D; ++k) S.cand[gg][k] = S.verts[v][k];
                }
            } else {
                mcp::nm_candidates(a.lower, S, D);
            }
        }
        __syncwarp();
        const float dv = deviance<Q, PM, float>(a, cell, twin, S.cand[g], sl, L32, beta32, s32);
        const double f = isfinite(dv) ? (double)dv : (double)SENTINEL32;
        __syncwarp();
        if (sl == 0) S.fc[g] = f;
        __syncwarp();
        if (lane == 0) {
            if (round < init_rounds) {
                for (int gg = 0; gg < GROUPS; ++gg) {
                    const int v = round * GROUPS + gg;
                    if (v <= D) S.fvals[v] = S.fc[gg];
                }
            } else {
                mcp::nm_select_and_replace(S, D);
            }
        }
        __syncwarp();
    }
    if (lane == 0) {  // the first position holding the least value
        int best = S.ord[0];
        for (int i = 1; i <= D; ++i)
            if (S.fvals[S.ord[i]] < S.fvals[best]) best = S.ord[i];
        for (int k = 0; k < D; ++k) S.theta[k] = S.verts[best][k];
    }
    __syncwarp();

    // f64: the optimum and the q zero-column probes (slot 0 the optimum,
    // slot 1 + j component j's probe), then the final fit
    double L64[NT], beta64[PM], sigma2 = 0.0, dev_hat = 0.0, dev = 0.0;
    const int probe_rounds = (Q + 1 + GROUPS - 1) / GROUPS;
    for (int round = 0; round <= probe_rounds; ++round) {
        if (lane == 0) {
            for (int gg = 0; gg < GROUPS; ++gg) {
                const int slot = round * GROUPS + gg;
                for (int k = 0; k < D; ++k) {
                    double x = S.theta[k];
                    if (round == probe_rounds) {  // theta_fin: pinned columns zeroed
                        double keep = 1.0;
                        int o = 0;
                        for (int j = 0; j < Q; ++j) {
                            const bool in_col = k >= o && k < o + (Q - j);
                            keep = keep * ((S.pinned[j] && in_col) ? 0.0 : 1.0);
                            o += Q - j;
                        }
                        x = x * keep;
                    } else if (slot >= 1 && slot <= Q) {  // column slot - 1 zeroed
                        int o = 0;
                        for (int j = 0; j < slot - 1; ++j) o += Q - j;
                        x = x * ((k >= o && k < o + (Q - (slot - 1))) ? 0.0 : 1.0);
                    }
                    S.cand[gg][k] = x;
                }
            }
        }
        __syncwarp();
        dev = deviance<Q, PM, double>(a, cell, nullptr, S.cand[g], sl, L64, beta64, sigma2);
        __syncwarp();
        if (round < probe_rounds) {
            const double f = isfinite(dev) ? dev : SENTINEL64;
            if (sl == 0) S.fc[g] = f;
            __syncwarp();
            if (lane == 0) {
                for (int gg = 0; gg < GROUPS; ++gg) {
                    const int slot = round * GROUPS + gg;
                    if (slot == 0) dev_hat = S.fc[gg];
                    else if (slot <= Q) S.pinned[slot - 1] = S.fc[gg] <= dev_hat + PIN_MARGIN;
                }
            }
            __syncwarp();
        }
    }
    if (lane == 0) {
        bool ok = isfinite(dev) && (sigma2 > 0.0);
        double lo = L64[0], hi = L64[0];
#pragma unroll
        for (int i = 0; i < PM; ++i) {
            if (i < p) {
                ok = ok && isfinite(beta64[i]);
                const double dg = L64[tri(i, i)];
                ok = ok && isfinite(dg) && (dg > 0.0);
                lo = fmin(lo, dg);
                hi = fmax(hi, dg);
            }
        }
        ok = ok && (lo >= a.eps_rank * hi);
        bool any_pin = false;
        for (int j = 0; j < Q; ++j) {
            a.pinned[cell * Q + j] = (uint8_t)(S.pinned[j] != 0);
            any_pin = any_pin || S.pinned[j];
        }
        a.flags[cell] = (uint8_t)((ok ? 1 : 0) | (any_pin ? 2 : 0));
        const double l00 = S.cand[0][0];
        a.tau2[cell] = (l00 * l00) * sigma2;
#pragma unroll
        for (int i = 0; i < PM; ++i)
            if (i < p) a.beta[cell * p + i] = beta64[i];
        // cov = sigma^2 (X'V^-1X)^-1, column by column
#pragma unroll
        for (int j = 0; j < PM; ++j) {
            if (j < p) {
                double e[PM], col[PM];
#pragma unroll
                for (int i = 0; i < PM; ++i) e[i] = (i == j) ? 1.0 : 0.0;
                cho_solve_packed_rt<PM>(L64, e, col, p);
#pragma unroll
                for (int i = 0; i < PM; ++i)
                    if (i < p) a.cov[cell * p * p + i * p + j] = sigma2 * col[i];
            }
        }
    }
}

template <int Q, int PM>
size_t warp_bytes(int m, int p, bool staged) {
    const int tf = staged ? twin_floats<Q>(m, p) : 0;
    return sizeof(Simplex) + (size_t)((tf + 3) & ~3) * sizeof(float);
}

template <int Q>
bool staged_for(int m, int p) {
    return (size_t)twin_floats<Q>(m, p) * sizeof(float) <= (size_t)STAGE_BYTES;
}

template <int Q, int PM>
int launch(Args a, cudaStream_t stream) {
    a.staged = staged_for<Q>(a.m, a.p) ? 1 : 0;
    const size_t smem = WARPS_PER_BLOCK * warp_bytes<Q, PM>(a.m, a.p, a.staged);
    auto kernel = slope_reml_kernel<Q, PM>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = mcp_blocks(a.B, WARPS_PER_BLOCK);
    if (blocks == 0) return (int)cudaErrorInvalidConfiguration;
    kernel<<<blocks, WARP * WARPS_PER_BLOCK, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

template <int Q>
int launch_q(const Args& a, cudaStream_t stream) {
    if (a.p <= 2) return launch<Q, 2>(a, stream);
    if (a.p == 3) return launch<Q, 3>(a, stream);
    if (a.p == 4) return launch<Q, 4>(a, stream);
    if (a.p <= 8) return launch<Q, 8>(a, stream);
    return launch<Q, 16>(a, stream);
}

}  // namespace

// Whether a cell of m clusters at q, p keeps its f32 twins in shared memory
// (1) or casts them from device memory on every evaluation (0); -1 for a q
// outside 2..4.
extern "C" int mcp_slope_reml_staged(int m, int q, int p) {
    switch (q) {
        case 2: return staged_for<2>(m, p) ? 1 : 0;
        case 3: return staged_for<3>(m, p) ? 1 : 0;
        case 4: return staged_for<4>(m, p) ? 1 : 0;
        default: return -1;
    }
}

// G (B, m, q, q), A (B, m, q, p), b (B, m, q), xtx (B, p, p), xty (B, p),
// yty (B,) f64 on the device; ns (Gn,) the grid's row counts, cell c at
// ns[c % Gn]; theta0 and lower (d,) in host memory. Writes beta (B, p), cov
// (B, p, p), tau2 (B,), flags (B,) (bit 0 converged, bit 1 boundary) and
// pinned (B, q). Returns a cudaError_t.
extern "C" int mcp_slope_reml(const void* G, const void* A, const void* b, const void* xtx,
                              const void* xty, const void* yty, const void* ns, int B, int Gn,
                              int m, int q, int p, const double* theta0, const double* lower,
                              int iters, double init_step, double eps_rank, void* beta, void* cov,
                              void* tau2, void* flags, void* pinned, void* stream) {
    if (B <= 0 || Gn <= 0 || m <= 0 || q < 2 || q > 4 || p < 1 || p > 16 || iters < 0)
        return (int)cudaErrorInvalidValue;
    Args a;
    a.G = (const double*)G;
    a.A = (const double*)A;
    a.b = (const double*)b;
    a.xtx = (const double*)xtx;
    a.xty = (const double*)xty;
    a.yty = (const double*)yty;
    a.ns = (const double*)ns;
    a.B = B;
    a.Gn = Gn;
    a.m = m;
    a.p = p;
    a.iters = iters;
    a.staged = 0;
    a.init_step = init_step;
    a.eps_rank = eps_rank;
    const int d = q * (q + 1) / 2;
    for (int k = 0; k < MAX_D; ++k) {
        a.theta0[k] = k < d ? theta0[k] : 0.0;
        a.lower[k] = k < d ? lower[k] : 0.0;
    }
    a.beta = (double*)beta;
    a.cov = (double*)cov;
    a.tau2 = (double*)tau2;
    a.flags = (uint8_t*)flags;
    a.pinned = (uint8_t*)pinned;
    switch (q) {
        case 2: return launch_q<2>(a, (cudaStream_t)stream);
        case 3: return launch_q<3>(a, (cudaStream_t)stream);
        default: return launch_q<4>(a, (cudaStream_t)stream);
    }
}
