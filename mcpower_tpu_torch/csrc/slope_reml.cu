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
//      vertices, then `iters` (140) iterations, on the f32 profiled REML
//      deviance (a non-finite one ranks as f32(1e30));
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
// over clusters follow SLOPE_LANES = 8 accumulators (accumulator l adds
// clusters l, l + 8, ... to a zero in turn; then a pair tree at distances
// 4, 2, 1, here an xor butterfly of warp shuffles, exact because addition
// commutes); the small factors are smallchol's order (the factor multiplies
// by the reciprocal pivot, the solves divide). The Nelder-Mead keeps its
// vertices in f64 in the plain version's order: a stable insertion sort of
// the d + 1 values (ties keep their order), the centroid as the d best
// vertices added in sorted order times the f64 reciprocal of d, candidates
// clipped at `lower`, the first minimum at the end. The search follows the
// rounding of its comparisons, so a kernel that agreed only to 1e-7 could
// end at another vertex and flip a pin; built with --fmad=false, it agrees
// in every bit.
//
// What bounds it on H100: the dependency chain of one cell where the launch
// is small (a flow's 1,250 cells: under ten warps an SM), the issue of its
// f32 work where the card is full. A cell runs d + 1 evaluations, then 140
// iterations, each waiting on the last (the simplex decides the next
// candidates); per evaluation m (q^3 + q^2 p + q p^2 / 2) f32 multiply-adds,
// about 2q(p + 1) + q divisions and q logs a cluster, and the p x p factor
// (chip_smoke.k9_bound counts them from the evaluations the cells needed,
// which the kernel counts). chip_k9_profile.py splits a cell's cycles by
// region: the first version spent ~60% of them in the cluster walk.
//
// What the design does about it: three forms of one kernel template
// (Shape<F>: lanes an evaluation, evaluations at once a cell), the launcher
// picking one by how many cells the card holds at once (set_form forces
// one the bucket has; all give the same bits):
// - packed (FORM_PACKED), for launches beyond one wave of pair, at p <= 4
//   (the arm, a sample-size launch): 8 lanes a cell,
//   four cells a warp, the lanes walking clusters l, l + 8, ... as the plain
//   version's accumulators. Lazy: a round evaluates one point a cell, the
//   reflection first and then only the candidate the selection reads
//   (nm_need), so an iteration costs one or two evaluations, not four.
// - pair (FORM_PAIR), for launches that fit one wave of it, at p <= 4 (a
//   flow's 1,250 cells): two warps a
//   cell, the four candidates of an iteration at once on 16 lanes each
//   (one round an iteration); lane l takes clusters l, l + 16, ... and each
//   round of 16 clusters folds into lanes 0-7's accumulators in the plain
//   order (lane l adds its own term, then lane l + 8's, by a shuffle).
// - quad (FORM_QUAD), the only form of the p <= 8 and p <= 16 buckets (the
//   slowest to build; no launch on the path is that wide): a warp a cell,
//   the four candidates at once on its four 8-lane groups.
// Every form: the sort on the cell's first thread, the centroid and the
// candidates one coordinate a lane; the simplex and the tail's constants
// (X'X, X'y, y'y, n - p, cast once) in shared memory, with the cell's f32
// twins of G, A and b where they fit (m (q^2 + q p + q) floats, at most
// STAGE_BYTES a cell), cast once from the f64 statistics; otherwise every
// f32 evaluation casts them from device memory (L1/L2), so any m is taken.
// The f32 solves divide without the IEEE division's branch (div_by, the
// same quotient), so a cluster's p + 1 solves interleave; where div_by's
// range does not hold the cluster is recomputed with the division itself.
// The f64 evaluations read the f64 statistics from device memory. q is a
// template constant (2, 3, 4) and p too where it pays (2, 3, 4); wider fits
// take the p <= 8 and p <= 16 instantiations with run-time guards. Matrices
// of p x p are packed lower triangles.

#include "common.cuh"
#include "nelder_mead.cuh"
#include "smallchol.cuh"

// Built with -DMCP_K9_CLOCKS=N (chip_k9_profile.py): the first thread of
// each of the first N cells adds clock64() deltas by region.
#ifdef MCP_K9_CLOCKS
__device__ unsigned long long mcp_k9_clk[MCP_K9_CLOCKS * 12];
#define K9_T0(v) long long v = clock64()
#define K9_ADD(k, v)                                                                   \
    do {                                                                               \
        if (lead && cell < MCP_K9_CLOCKS)                                              \
            atomicAdd(&mcp_k9_clk[cell * 12 + (k)], (unsigned long long)(clock64() - (v))); \
    } while (0)
#define K9_ADD32(k, v) \
    do {               \
        if (sizeof(T) == 4) K9_ADD(k, v); \
    } while (0)
// Counts of a lane's f32 clusters (slots 8-10: evaluated, recomputed by the
// IEEE path, with a zero numerator), added once an evaluation.
#define K9_COUNT_DECL int k9_n[3] = {0, 0, 0}
#define K9_COUNT(...)                 \
    do {                              \
        const int k9_b = (__VA_ARGS__); \
        ++k9_n[0];                    \
        k9_n[1] += k9_b & 1;          \
        k9_n[2] += (k9_b >> 1) & 1;   \
    } while (0)
#define K9_COUNT_ADD()                                                                  \
    do {                                                                                \
        if (sizeof(T) == 4 && cell < MCP_K9_CLOCKS)                                     \
            for (int k = 0; k < 3; ++k)                                                 \
                if (k9_n[k])                                                            \
                    atomicAdd(&mcp_k9_clk[cell * 12 + 8 + k], (unsigned long long)k9_n[k]); \
    } while (0)
#else
#define K9_T0(v)
#define K9_ADD(k, v)
#define K9_ADD32(k, v)
#define K9_COUNT_DECL
#define K9_COUNT(...) (void)(__VA_ARGS__)
#define K9_COUNT_ADD()
#endif

namespace {

using mcp::chol_packed_rt;
using mcp::cho_solve_packed_rt;

constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SLOPE_LANES = 8;  // the plain version's cluster accumulators
constexpr int MAX_D = 10;
constexpr int STAGE_BYTES = 16 * 1024;  // f32 twins of one cell, at most
constexpr double PIN_MARGIN = 1e-10;
constexpr float SENTINEL32 = 1e30f;  // a failed f32 evaluation's rank, widened
constexpr double SENTINEL64 = 1e30;  // a failed f64 evaluation's

enum Form { FORM_AUTO = 0, FORM_PACKED = 1, FORM_PAIR = 2, FORM_QUAD = 3 };
// Lanes an evaluation, evaluations at once a cell, threads a block.
template <int F>
struct Shape;
template <>
struct Shape<FORM_PACKED> {
    static constexpr int LANES = 8, GROUPS = 1, THREADS = 64;
};
template <>
struct Shape<FORM_QUAD> {
    static constexpr int LANES = 8, GROUPS = 4, THREADS = 128;
};
template <>
struct Shape<FORM_PAIR> {
    static constexpr int LANES = 16, GROUPS = 4, THREADS = 128;
};


int g_form = FORM_AUTO;  // mcp_slope_reml_set_form

struct Args {
    const double *G, *A, *b, *xtx, *xty, *yty, *ns;
    int B, Gn, m, p, iters, staged;
    double init_step, eps_rank;
    double theta0[MAX_D], lower[MAX_D];
    double *beta, *cov, *tau2;
    uint8_t *flags, *pinned;
    int* evals;  // the f32 evaluations each cell's search needed, or null
};

// The lazy search's states: evaluating vertex `next`, the reflection, the
// candidate `need`; done.
enum State { ST_VERT = 0, ST_REFL = 1, ST_SECOND = 2, ST_DONE = 3 };

// One cell's Nelder-Mead state and candidates, in shared memory.
template <int D>
struct Simplex {
    double verts[D + 1][D];
    double fvals[D + 1];
    double cand[4][D];
    double fc[4];
    double theta[D];  // the search's optimum
    int ord[D + 1];   // vertex at each sorted position
    int pinned[4];
    int state, next, iter, need, fresh, evals;
};

__host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }

template <int Q>
__host__ __device__ constexpr int twin_floats(int m, int p) {
    return m * (Q * Q + Q * p + Q);
}

__host__ __device__ constexpr size_t round16(size_t n) { return (n + 15) & ~(size_t)15; }

// The cell's constants of the deviance's tail, as T: X'X's lower triangle
// (packed), X'y, y'y and n - p.
template <int PM>
__host__ __device__ constexpr int tail_len() {
    return PM * (PM + 1) / 2 + PM + 2;
}

// Shared bytes of one cell: its simplex, its tail constants in f64 and f32,
// then its twins where staged.
template <int Q, int PM>
__host__ __device__ size_t tail64_at() {
    return round16(sizeof(Simplex<Q * (Q + 1) / 2>));
}
template <int Q, int PM>
__host__ __device__ size_t tail32_at() {
    return tail64_at<Q, PM>() + round16(tail_len<PM>() * sizeof(double));
}
template <int Q, int PM>
__host__ __device__ size_t twin_at() {
    return tail32_at<Q, PM>() + round16(tail_len<PM>() * sizeof(float));
}
template <int Q, int PM>
__host__ __device__ size_t cell_bytes(int m, int p, bool staged) {
    return twin_at<Q, PM>() +
           (staged ? round16((size_t)twin_floats<Q>(m, p) * sizeof(float)) : 0);
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

// Every statistic of one evaluation: one cluster's terms, or their sums.
template <int PM, typename T>
struct Sums {
    static constexpr int NT = PM * (PM + 1) / 2;
    T xx[NT], xy[PM], yy, ld;

    __device__ __forceinline__ void zero() {
#pragma unroll
        for (int i = 0; i < NT; ++i) xx[i] = T(0);
#pragma unroll
        for (int i = 0; i < PM; ++i) xy[i] = T(0);
        yy = T(0);
        ld = T(0);
    }
    __device__ __forceinline__ void add(const Sums& t) {
#pragma unroll
        for (int i = 0; i < NT; ++i) xx[i] = xx[i] + t.xx[i];
#pragma unroll
        for (int i = 0; i < PM; ++i) xy[i] = xy[i] + t.xy[i];
        yy = yy + t.yy;
        ld = ld + t.ld;
    }
    // this += the values of lane (own + delta), or of lane (own ^ delta)
    __device__ __forceinline__ void add_down(const Sums& t, int delta) {
#pragma unroll
        for (int i = 0; i < NT; ++i) xx[i] = xx[i] + __shfl_down_sync(FULL, t.xx[i], delta);
#pragma unroll
        for (int i = 0; i < PM; ++i) xy[i] = xy[i] + __shfl_down_sync(FULL, t.xy[i], delta);
        yy = yy + __shfl_down_sync(FULL, t.yy, delta);
        ld = ld + __shfl_down_sync(FULL, t.ld, delta);
    }
    __device__ __forceinline__ void add_xor(int dist) {
#pragma unroll
        for (int i = 0; i < NT; ++i) xx[i] = xx[i] + __shfl_xor_sync(FULL, xx[i], dist);
#pragma unroll
        for (int i = 0; i < PM; ++i) xy[i] = xy[i] + __shfl_xor_sync(FULL, xy[i], dist);
        yy = yy + __shfl_xor_sync(FULL, yy, dist);
        ld = ld + __shfl_xor_sync(FULL, ld, dist);
    }
};

// Whether an f32 lies in [2^-40, 2^41) in magnitude (not zero, subnormal,
// inf or nan): where div_by's operands lie for its quotient to be exact.
__device__ __forceinline__ bool mid_range(float x) {
    return ((__float_as_uint(x) >> 23) & 0xffu) - 87u <= 80u;
}

// a / b rounded to nearest, from r = RN(1 / b), as the IEEE division gives
// it, without its branch to a slow path: q = a r, corrected twice by the
// remainder a - b q (an fma); the first correction brings q within an ulp,
// where the remainder is exact and Markstein's theorem makes the second
// correction's rounding that of a / b. Holds where a and b are mid_range
// (the quotient, remainders and products then stay normal); a zero a takes
// a r, the zero of a / b's sign (b > 0; the corrections would give +0).
// Bit 0 of `bad` is set where a is neither (b is checked once, as a pivot);
// the clock build sets bit 1 where a is zero.
__device__ __forceinline__ float div_by(float a, float b, float r, int& bad) {
    const bool zero = a == 0.0f;
    bad |= !zero && !mid_range(a);
#ifdef MCP_K9_CLOCKS
    bad |= zero ? 2 : 0;
#endif
    const float q0 = __fmul_rn(a, r);
    const float q1 = __fmaf_rn(r, __fmaf_rn(-b, q0, a), q0);
    const float q2 = __fmaf_rn(r, __fmaf_rn(-b, q1, a), q1);
    return zero ? q0 : q2;
}

// smallchol's chol and cho_solve in f32 with the divisions of the solves by
// div_by, the pivots' reciprocals kept from the factor (its own division,
// 1 / L_jj); the same operations in the same order otherwise. Bit 0 of `bad`
// is set where a pivot or a nonzero numerator is not mid_range: the caller
// then takes the IEEE path.
template <int Q>
__device__ __forceinline__ void chol_r(const float* A, float* L, float* r, int& bad) {
#pragma unroll
    for (int j = 0; j < Q; ++j) {
        float d = A[j * Q + j];
#pragma unroll
        for (int k = 0; k < j; ++k) d = d - L[j * Q + k] * L[j * Q + k];
        L[j * Q + j] = sqrtf(d);
        r[j] = 1.0f / L[j * Q + j];
        bad |= !mid_range(L[j * Q + j]);
#pragma unroll
        for (int i = j + 1; i < Q; ++i) {
            float s = A[i * Q + j];
#pragma unroll
            for (int k = 0; k < j; ++k) s = s - L[i * Q + k] * L[j * Q + k];
            L[i * Q + j] = s * r[j];
        }
#pragma unroll
        for (int i = 0; i < j; ++i) L[i * Q + j] = 0.0f;
    }
}

template <int Q>
__device__ __forceinline__ void cho_solve_r(const float* L, const float* r, const float* b,
                                            float* x, int& bad) {
    float y[Q];
#pragma unroll
    for (int i = 0; i < Q; ++i) {
        float s = b[i];
#pragma unroll
        for (int k = 0; k < i; ++k) s = s - L[i * Q + k] * y[k];
        y[i] = div_by(s, L[i * Q + i], r[i], bad);
    }
#pragma unroll
    for (int i = Q - 1; i >= 0; --i) {
        float s = y[i];
#pragma unroll
        for (int k = i + 1; k < Q; ++k) s = s - L[k * Q + i] * x[k];
        x[i] = div_by(s, L[i * Q + i], r[i], bad);
    }
}

// The cluster's factor and solves: the IEEE divisions (FAST false, and
// always in f64), or div_by's (FAST, f32 only), which set bit 0 of `bad`
// where they may differ.
template <int Q, bool FAST, typename T>
__device__ __forceinline__ void factor(const T* C, T* L, T* r, int& bad) {
    if constexpr (FAST) chol_r<Q>(C, L, r, bad);
    else mcp::chol<Q, T>(C, L);
}
template <int Q, bool FAST, typename T>
__device__ __forceinline__ void solve(const T* L, const T* r, const T* b, T* x, int& bad) {
    if constexpr (FAST) cho_solve_r<Q>(L, r, b, x, bad);
    else mcp::cho_solve<Q>(L, b, x);
}

// Cluster c's terms at Lam: A~' C^-1 A~ (lower triangle), A~' C^-1 b~,
// b~' C^-1 b~ and log|C|, each a sum over the q components from the first.
// FAST (f32): the solves' divisions by div_by; returns `bad`, bit 0 set where
// one of them may differ from the IEEE division's (the caller recomputes the
// cluster with FAST false, which always returns 0).
template <int Q, int PM, bool FAST, typename T>
__device__ __forceinline__ int cluster_terms(const T (&lam)[Q][Q], const float* tG,
                                              const float* tA, const float* tb, const double* gG,
                                              const double* gA, const double* gb, int c, int p,
                                              Sums<PM, T>& t) {
    int bad = 0;
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
    T C[Q * Q], Lc[Q * Q], rc[Q];
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
    factor<Q, FAST>(C, Lc, rc, bad);
    // b~ = Lam' b and its solve
    T bc[Q], bt[Q], solb[Q];
#pragma unroll
    for (int r = 0; r < Q; ++r) bc[r] = ld<T>(tb, gb, (long long)c * Q + r);
#pragma unroll
    for (int r = 0; r < Q; ++r) {
        T acc = lam[r][r] * bc[r];
#pragma unroll
        for (int s = r + 1; s < Q; ++s) acc = acc + lam[s][r] * bc[s];
        bt[r] = acc;
    }
    solve<Q, FAST>(Lc, rc, bt, solb, bad);
    {
        T yy = bt[0] * solb[0];
#pragma unroll
        for (int r = 1; r < Q; ++r) yy = yy + bt[r] * solb[r];
        t.yy = yy;
        T lsum = log(Lc[0]);
#pragma unroll
        for (int r = 1; r < Q; ++r) lsum = lsum + log(Lc[r * Q + r]);
        t.ld = T(2) * lsum;
    }
    // A~ = Lam' A column by column: its solve, then row aa of the terms
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
                for (int s = r + 1; s < Q; ++s) acc = acc + lam[s][r] * Ac[s];
                At[r] = acc;
            }
            solve<Q, FAST>(Lc, rc, At, solA[aa], bad);
#pragma unroll
            for (int bb = 0; bb <= aa; ++bb) {
                T acc = At[0] * solA[bb][0];
#pragma unroll
                for (int r = 1; r < Q; ++r) acc = acc + At[r] * solA[bb][r];
                t.xx[tri(aa, bb)] = acc;
            }
            T xy = At[0] * solb[0];
#pragma unroll
            for (int r = 1; r < Q; ++r) xy = xy + At[r] * solb[r];
            t.xy[aa] = xy;
        } else {
#pragma unroll
            for (int bb = 0; bb <= aa; ++bb) t.xx[tri(aa, bb)] = T(0);
            t.xy[aa] = T(0);
        }
    }
    return bad;
}

// cluster_terms, the fast f32 path first where it applies; returns the fast
// path's `bad` (bit 0: the cluster was recomputed), 0 in f64.
template <int Q, int PM, typename T>
__device__ __forceinline__ int terms_of(const T (&lam)[Q][Q], const float* tG, const float* tA,
                                        const float* tb, const double* gG, const double* gA,
                                        const double* gb, int c, int p, Sums<PM, T>& t) {
    int bad = 0;
    if constexpr (sizeof(T) == 4) {
        bad = cluster_terms<Q, PM, true, T>(lam, tG, tA, tb, gG, gA, gb, c, p, t);
        if (!(bad & 1)) return bad;
    }
    cluster_terms<Q, PM, false, T>(lam, tG, tA, tb, gG, gA, gb, c, p, t);
    return bad;
}

// The profiled REML deviance at `th` (shared memory, d entries), in T, on
// LANES lanes (sl the lane's index among them); fills the packed Cholesky of
// X'V^-1X, beta and sigma^2. With LANES = 16 only lanes 0-7 hold the sums,
// so only lane 0's results are the deviance's (the others compute on
// partial sums and are not read). One call site per T in each kernel.
template <int Q, int PM, int LANES, typename T>
__device__ __forceinline__ T deviance(const Args& a, long long cell, const float* twin,
                                      const T* tail, const double* th, int sl, bool lead, T* L,
                                      T* beta, T& sigma2) {
    (void)lead;
    constexpr int NT = PM * (PM + 1) / 2;
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
    s.zero();
    const float* tG = twin;
    const float* tA = twin ? twin + (long long)m * Q * Q : nullptr;
    const float* tb = twin ? tA + (long long)m * Q * p : nullptr;
    const double* gG = a.G + cell * m * Q * Q;
    const double* gA = a.A + cell * m * Q * p;
    const double* gb = a.b + cell * m * Q;
    K9_COUNT_DECL;
    if constexpr (LANES == SLOPE_LANES) {
        K9_T0(clk_w);
        for (int c = sl; c < m; c += LANES) {
            Sums<PM, T> t;
            K9_COUNT(terms_of<Q, PM, T>(lam, tG, tA, tb, gG, gA, gb, c, p, t));
            s.add(t);
        }
        K9_ADD32(1, clk_w);
    } else {
        // each round of LANES clusters folds into lanes 0-7: lane l adds
        // clusters c0 + l, c0 + l + 8, ... in turn (a cluster past m adds
        // zeros, which leave a sum as it is: it started at +0 and so is
        // never -0)
        for (int c0 = 0; c0 < m; c0 += LANES) {
            K9_T0(clk_w);
            Sums<PM, T> t;
            if (c0 + sl < m)
                K9_COUNT(terms_of<Q, PM, T>(lam, tG, tA, tb, gG, gA, gb, c0 + sl, p, t));
            else
                t.zero();
            K9_ADD32(1, clk_w);
            K9_T0(clk_f);
            s.add(t);
#pragma unroll
            for (int j = SLOPE_LANES; j < LANES; j += SLOPE_LANES) s.add_down(t, j);
            K9_ADD32(2, clk_f);
        }
    }
    K9_COUNT_ADD();
    // the accumulators combine: distances 4, 2, 1
    K9_T0(clk_s);
#pragma unroll
    for (int dist = SLOPE_LANES / 2; dist >= 1; dist >>= 1) s.add_xor(dist);
    K9_ADD32(2, clk_s);
    // X'V^-1X, its factor, beta, rss and the deviance
    K9_T0(clk_x);
    T axy[PM];
#pragma unroll
    for (int i = 0; i < PM; ++i) {
        if (i < p) {
#pragma unroll
            for (int j = 0; j <= i; ++j) L[tri(i, j)] = tail[tri(i, j)] - s.xx[tri(i, j)];
            axy[i] = tail[NT + i] - s.xy[i];
        }
    }
    const T ayy = tail[NT + PM] - s.yy;
    const T df = tail[NT + PM + 1];
    chol_packed_rt<PM>(L, p);
    cho_solve_packed_rt<PM>(L, axy, beta, p);
    T bxy = beta[0] * axy[0];
#pragma unroll
    for (int i = 1; i < PM; ++i)
        if (i < p) bxy = bxy + beta[i] * axy[i];
    const T rss = ayy - bxy;
    sigma2 = rss / df;
    T ldx = log(L[0]);
#pragma unroll
    for (int i = 1; i < PM; ++i)
        if (i < p) ldx = ldx + log(L[tri(i, i)]);
    ldx = T(2) * ldx;
    const T dev = (s.ld + ldx) + df * log(rss);
    K9_ADD32(3, clk_x);
    return dev;
}

// The cell's barrier: its warp, or its block where it spans two warps.
template <int F>
__device__ __forceinline__ void cell_sync() {
    if constexpr (Shape<F>::LANES * Shape<F>::GROUPS > WARP) __syncthreads();
    else __syncwarp();
}

// The lazy search's step on the value f of the point just evaluated (the
// cell's first thread): record it, then the selection where the iteration
// is complete, then the next iteration's sort (the candidates follow, one
// coordinate a lane) or the optimum.
template <int D>
__device__ __forceinline__ void lazy_step(Simplex<D>& S, double f, int iters) {
    ++S.evals;
    if (S.state == ST_VERT) {
        S.fvals[S.next] = f;
        if (++S.next <= D) return;
    } else if (S.state == ST_REFL) {
        S.fc[0] = f;
        S.need = mcp::nm_need(S, D);
        if (S.need) {
            S.state = ST_SECOND;
            return;
        }
        mcp::nm_replace(S, D, 0);
        ++S.iter;
    } else {
        S.fc[S.need] = f;
        mcp::nm_replace(S, D, mcp::nm_pick(S, S.need));
        ++S.iter;
    }
    if (S.iter < iters) {
        mcp::nm_sort(S, D);
        S.fresh = 1;
        S.state = ST_REFL;
        return;
    }
    int best = S.ord[0];  // the first position holding the least value
    for (int i = 1; i <= D; ++i)
        if (S.fvals[S.ord[i]] < S.fvals[best]) best = S.ord[i];
    for (int k = 0; k < D; ++k) S.theta[k] = S.verts[best][k];
    S.state = ST_DONE;
}

// Blocks an SM the compiler keeps registers for, at p <= 4: 102 registers a
// thread (twenty warps an SM) for the pair form (a flow's 1,250-cell launch
// in one wave) and the packed form at p = 3, 4; 128 (sixteen warps) for the
// packed form at p = 2 (faster there than at 102 on README flow 2's
// sample-size launch). The wider buckets (quad) take what they need.
template <int PM, int F>
__host__ __device__ constexpr int min_blocks() {
    return PM > 4 ? 1 : ((F == FORM_PAIR || PM > 2) ? 640 : 512) / Shape<F>::THREADS;
}

template <int Q, int PM, int F>
__global__ void __launch_bounds__(Shape<F>::THREADS, (min_blocks<PM, F>()))
    slope_reml_kernel(const Args a) {
    constexpr int D = Q * (Q + 1) / 2;
    constexpr int NT = PM * (PM + 1) / 2;
    constexpr int LANES = Shape<F>::LANES, GROUPS = Shape<F>::GROUPS;
    constexpr int CELL_THREADS = LANES * GROUPS;
    constexpr int CELLS = Shape<F>::THREADS / CELL_THREADS;  // a block
    extern __shared__ __align__(16) unsigned char smem[];
    const int t = threadIdx.x;
    const int slot = t / CELL_THREADS, ct = t % CELL_THREADS;
    const int g = ct / LANES, sl = ct % LANES;
    const long long first = (long long)blockIdx.x * CELLS;
    // A warp whose cells are all past the end leaves (a block, where a cell
    // spans warps); a cell past the end beside one that is not runs on the
    // last cell's statistics and writes nothing, so that its lanes still
    // take part in the shuffles and barriers.
    const long long warp_first =
        first + (CELL_THREADS > WARP ? 0
                                     : (CELL_THREADS == WARP ? slot
                                                             : (t / WARP) * (WARP / CELL_THREADS)));
    if (warp_first >= a.B) return;
    const bool real = first + slot < a.B;
    const long long cell = real ? first + slot : (long long)a.B - 1;
    const bool lead = ct == 0;
    K9_T0(clk_all);
    const int m = a.m, p = a.p;
    const int tf = a.staged ? twin_floats<Q>(m, p) : 0;
    unsigned char* base = smem + slot * cell_bytes<Q, PM>(m, p, a.staged != 0);
    Simplex<D>& S = *reinterpret_cast<Simplex<D>*>(base);
    double* tail64 = reinterpret_cast<double*>(base + tail64_at<Q, PM>());
    float* tail32 = reinterpret_cast<float*>(base + tail32_at<Q, PM>());
    float* twin = a.staged ? reinterpret_cast<float*>(base + twin_at<Q, PM>()) : nullptr;
    K9_T0(clk_tw);
    // the tail's constants, cast once: X'X (lower, packed), X'y, y'y, n - p
    for (int i = ct; i < p; i += CELL_THREADS) {
        for (int j = 0; j <= i; ++j) {
            const double v = a.xtx[cell * p * p + i * p + j];
            tail64[tri(i, j)] = v;
            tail32[tri(i, j)] = (float)v;
        }
        const double v = a.xty[cell * p + i];
        tail64[NT + i] = v;
        tail32[NT + i] = (float)v;
    }
    if (lead) {
        const double n = a.ns[cell % a.Gn];
        tail64[NT + PM] = a.yty[cell];
        tail32[NT + PM] = (float)a.yty[cell];
        tail64[NT + PM + 1] = n - (double)p;
        tail32[NT + PM + 1] = (float)n - (float)p;
    }
    if (twin) {  // G, A, b of the cell as f32, in that order
        const long long gq = (long long)m * Q * Q, aq = (long long)m * Q * p;
        for (int i = ct; i < tf; i += CELL_THREADS) {
            double v;
            if (i < gq) v = a.G[cell * gq + i];
            else if (i < gq + aq) v = a.A[cell * aq + (i - gq)];
            else v = a.b[cell * m * Q + (i - gq - aq)];
            twin[i] = (float)v;
        }
    }
    if (lead) {
        for (int i = 0; i <= D; ++i) {
            for (int k = 0; k < D; ++k) {
                const double x = a.theta0[k] + ((i > 0 && k == i - 1) ? a.init_step : 0.0);
                S.verts[i][k] = (x < a.lower[k]) ? a.lower[k] : x;
            }
            S.ord[i] = i;
        }
        S.state = ST_VERT;
        S.next = S.iter = S.need = S.fresh = 0;
        S.evals = GROUPS == 1 ? 0 : D + 1;  // the lazy step counts the vertices itself
    }
    cell_sync<F>();
    K9_ADD(7, clk_tw);

    float L32[NT], beta32[PM], s32;
    if constexpr (GROUPS == 1) {
        // lazy: each round evaluates one point a cell, until every cell of
        // the warp is done (a done cell evaluates its optimum, unread)
        for (;;) {
            const int st = S.state;
            if (!__any_sync(FULL, st != ST_DONE)) break;
            const double* x = st == ST_VERT   ? S.verts[S.next]
                              : st == ST_DONE ? S.theta
                                              : S.cand[st == ST_REFL ? 0 : S.need];
            const float dv = deviance<Q, PM, LANES, float>(a, cell, twin, tail32, x, sl, lead,
                                                           L32, beta32, s32);
            const double f = isfinite(dv) ? (double)dv : (double)SENTINEL32;
            K9_T0(clk_b0);
            __syncwarp();
            K9_ADD(5, clk_b0);
            K9_T0(clk_n0);
            if (lead && st != ST_DONE) lazy_step<D>(S, f, a.iters);
            K9_ADD(4, clk_n0);
            K9_T0(clk_b1);
            __syncwarp();
            K9_ADD(5, clk_b1);
            K9_T0(clk_n1);
            if (S.fresh)
                for (int k = sl; k < D; k += LANES) mcp::nm_candidate_at(a.lower, S, D, k);
            K9_ADD(4, clk_n1);
            K9_T0(clk_b2);
            __syncwarp();
            K9_ADD(5, clk_b2);
            if (lead) S.fresh = 0;
        }
    } else {
        // eager: the four candidates of an iteration at once, one a group
        const int init_rounds = (D + 1 + GROUPS - 1) / GROUPS;
        for (int round = 0; round < init_rounds + a.iters; ++round) {
            K9_T0(clk_n0);
            if (round >= init_rounds) {
                if (lead) mcp::nm_sort(S, D);
                cell_sync<F>();
                if (g == 0)
                    for (int k = sl; k < D; k += LANES) mcp::nm_candidate_at(a.lower, S, D, k);
            }
            K9_ADD(4, clk_n0);
            K9_T0(clk_b0);
            cell_sync<F>();
            K9_ADD(5, clk_b0);
            const int v = round * GROUPS + g;
            const double* x = round < init_rounds ? S.verts[v < D ? v : D] : S.cand[g];
            const float dv = deviance<Q, PM, LANES, float>(a, cell, twin, tail32, x, sl, lead,
                                                           L32, beta32, s32);
            const double f = isfinite(dv) ? (double)dv : (double)SENTINEL32;
            if (sl == 0) {
                if (round >= init_rounds) S.fc[g] = f;
                else if (v <= D) S.fvals[v] = f;
            }
            K9_T0(clk_b1);
            cell_sync<F>();
            K9_ADD(5, clk_b1);
            K9_T0(clk_n1);
            if (lead && round >= init_rounds) {
                S.evals += mcp::nm_need(S, D) ? 2 : 1;
                mcp::nm_select_and_replace(S, D);
            }
            K9_ADD(4, clk_n1);
        }
        if (lead) {  // the first position holding the least value
            int best = S.ord[0];
            for (int i = 1; i <= D; ++i)
                if (S.fvals[S.ord[i]] < S.fvals[best]) best = S.ord[i];
            for (int k = 0; k < D; ++k) S.theta[k] = S.verts[best][k];
        }
        cell_sync<F>();
    }

    // f64: the optimum and the q zero-column probes (slot 0 the optimum,
    // slot 1 + j component j's probe, a group each), then the final fit
    K9_T0(clk_d);
    double L64[NT], beta64[PM], sigma2 = 0.0, dev_hat = 0.0, dev = 0.0;
    const int probe_rounds = (Q + 1 + GROUPS - 1) / GROUPS;
    for (int round = 0; round <= probe_rounds; ++round) {
        if (lead) {
            for (int gg = 0; gg < GROUPS; ++gg) {
                const int pslot = round * GROUPS + gg;
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
                    } else if (pslot >= 1 && pslot <= Q) {  // column pslot - 1 zeroed
                        int o = 0;
                        for (int j = 0; j < pslot - 1; ++j) o += Q - j;
                        x = x * ((k >= o && k < o + (Q - (pslot - 1))) ? 0.0 : 1.0);
                    }
                    S.cand[gg][k] = x;
                }
            }
        }
        cell_sync<F>();
        dev = deviance<Q, PM, LANES, double>(a, cell, nullptr, tail64, S.cand[g], sl, lead, L64,
                                             beta64, sigma2);
        cell_sync<F>();
        if (round < probe_rounds) {
            const double f = isfinite(dev) ? dev : SENTINEL64;
            if (sl == 0) S.fc[g] = f;
            cell_sync<F>();
            if (lead) {
                for (int gg = 0; gg < GROUPS; ++gg) {
                    const int pslot = round * GROUPS + gg;
                    if (pslot == 0) dev_hat = S.fc[gg];
                    else if (pslot <= Q) S.pinned[pslot - 1] = S.fc[gg] <= dev_hat + PIN_MARGIN;
                }
            }
            cell_sync<F>();
        }
    }
    if (lead && real) {
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
        if (a.evals) a.evals[cell] = S.evals;
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
    K9_ADD(6, clk_d);
    K9_ADD(0, clk_all);
}

template <int Q>
bool staged_for(int m, int p) {
    return (size_t)twin_floats<Q>(m, p) * sizeof(float) <= (size_t)STAGE_BYTES;
}

// What a launch of form F takes: dynamic shared bytes a block, cells a
// block, resident blocks an SM, registers and local bytes a thread.
struct Info {
    size_t smem;
    int cells, per_sm, regs, local;
};

// Info of slope_reml_kernel<Q, PM, F> at the launch's shared bytes. They
// depend on the kernel, those bytes and the device only, so the runtime is
// asked once for each such key a kernel meets in turn (the last kept), not
// every launch.
template <int Q, int PM, int F>
int info(const Args& a, Info* out) {
    static Info memo = {~(size_t)0, 0, 0, 0, 0};
    static int memo_dev = -1;
    const int cells = Shape<F>::THREADS / (Shape<F>::LANES * Shape<F>::GROUPS);
    const size_t smem = cells * cell_bytes<Q, PM>(a.m, a.p, a.staged != 0);
    int dev = 0;
    cudaError_t err0 = cudaGetDevice(&dev);
    if (err0 != cudaSuccess) return (int)err0;
    if (memo.smem != smem || memo_dev != dev) {
        auto kernel = slope_reml_kernel<Q, PM, F>;
        Info in = {smem, cells, 0, 0, 0};
        cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        cudaFuncAttributes fa;
        if ((err = cudaFuncGetAttributes(&fa, kernel)) != cudaSuccess) return (int)err;
        in.regs = fa.numRegs;
        in.local = (int)fa.localSizeBytes;
        if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&in.per_sm, kernel,
                                                                 Shape<F>::THREADS, smem)))
            return (int)err;
        memo = in;
        memo_dev = dev;
    }
    *out = memo;
    return 0;
}

// The card's SMs, asked once a device.
int sm_count(int* sms) {
    static int memo[16] = {0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= 16)
        return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (!memo[dev] && (err = cudaDeviceGetAttribute(&memo[dev], cudaDevAttrMultiProcessorCount,
                                                    dev)) != cudaSuccess)
        return (int)err;
    *sms = memo[dev];
    return 0;
}

// The form a launch takes: at p <= 4 pair where the launch fits one wave of
// it, else packed (set_form forces either); the p <= 8 and p <= 16 buckets
// have the quad form only (a forced form they lack is not taken).
template <int Q, int PM>
int pick_form(const Args& a, int* form, Info* chosen) {
    int err;
    if constexpr (PM > 4) {  // the else keeps their packed and pair kernels unbuilt
        *form = FORM_QUAD;
        if ((err = info<Q, PM, FORM_QUAD>(a, chosen))) return err;
    } else {
        int f = g_form;
        if (f != FORM_PACKED && f != FORM_PAIR) {
            Info pair;
            int sms = 0;
            if ((err = sm_count(&sms)) || (err = info<Q, PM, FORM_PAIR>(a, &pair))) return err;
            f = a.B <= (long long)pair.per_sm * pair.cells * sms ? FORM_PAIR : FORM_PACKED;
        }
        *form = f;
        err = f == FORM_PAIR ? info<Q, PM, FORM_PAIR>(a, chosen)
                             : info<Q, PM, FORM_PACKED>(a, chosen);
        if (err) return err;
    }
    return chosen->per_sm > 0 ? 0 : (int)cudaErrorInvalidConfiguration;
}

template <int Q, int PM>
int launch(Args a, cudaStream_t stream) {
    a.staged = staged_for<Q>(a.m, a.p) ? 1 : 0;
    int form = 0, err;
    Info in;
    if ((err = pick_form<Q, PM>(a, &form, &in))) return err;
    const unsigned blocks = mcp_blocks(a.B, in.cells);
    if (blocks == 0) return (int)cudaErrorInvalidConfiguration;
    if constexpr (PM > 4) {
        slope_reml_kernel<Q, PM, FORM_QUAD>
            <<<blocks, Shape<FORM_QUAD>::THREADS, in.smem, stream>>>(a);
    } else if (form == FORM_PACKED) {
        slope_reml_kernel<Q, PM, FORM_PACKED>
            <<<blocks, Shape<FORM_PACKED>::THREADS, in.smem, stream>>>(a);
    } else {
        slope_reml_kernel<Q, PM, FORM_PAIR>
            <<<blocks, Shape<FORM_PAIR>::THREADS, in.smem, stream>>>(a);
    }
    return (int)cudaGetLastError();
}

template <int Q, int PM>
int geometry(Args a, int* out) {
    a.staged = staged_for<Q>(a.m, a.p) ? 1 : 0;
    int form = 0, sms = 0, err;
    Info in;
    if ((err = pick_form<Q, PM>(a, &form, &in)) || (err = sm_count(&sms))) return err;
    const long long slots = (long long)in.per_sm * in.cells * sms;
    out[0] = form;
    out[1] = (int)in.smem;
    out[2] = in.per_sm * in.cells;
    out[3] = (int)((a.B + slots - 1) / slots);
    out[4] = in.regs;
    out[5] = in.local;
    out[6] = a.staged;
    out[7] = in.cells;
    return 0;
}

// (q, p) to its instantiation: FN<Q, PM>(args...).
#define K9_DISPATCH(q, p, FN, ...)                \
    switch (q) {                                  \
        case 2: K9_DISPATCH_P(2, p, FN, __VA_ARGS__) \
        case 3: K9_DISPATCH_P(3, p, FN, __VA_ARGS__) \
        default: K9_DISPATCH_P(4, p, FN, __VA_ARGS__) \
    }
#define K9_DISPATCH_P(Q, p, FN, ...)                  \
    if ((p) <= 2) return FN<Q, 2>(__VA_ARGS__);       \
    if ((p) == 3) return FN<Q, 3>(__VA_ARGS__);       \
    if ((p) == 4) return FN<Q, 4>(__VA_ARGS__);       \
    if ((p) <= 8) return FN<Q, 8>(__VA_ARGS__);       \
    return FN<Q, 16>(__VA_ARGS__);

int launch_any(const Args& a, int q, cudaStream_t stream) { K9_DISPATCH(q, a.p, launch, a, stream) }

int geometry_any(const Args& a, int q, int* out) { K9_DISPATCH(q, a.p, geometry, a, out) }

int fill_args(Args& a, const void* G, const void* A, const void* b, const void* xtx,
              const void* xty, const void* yty, const void* ns, int B, int Gn, int m, int q, int p,
              const double* theta0, const double* lower, int iters, double init_step,
              double eps_rank) {
    if (B <= 0 || Gn <= 0 || m <= 0 || q < 2 || q > 4 || p < 1 || p > 16 || iters < 0)
        return (int)cudaErrorInvalidValue;
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
        a.theta0[k] = (theta0 && k < d) ? theta0[k] : 0.0;
        a.lower[k] = (lower && k < d) ? lower[k] : 0.0;
    }
    a.beta = a.cov = a.tau2 = nullptr;
    a.flags = a.pinned = nullptr;
    a.evals = nullptr;
    return 0;
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

// The form later launches take: 0 as the launcher picks, 1 packed, 2 pair,
// 3 quad, where the launch's p bucket has it (packed and pair at p <= 4,
// quad beyond; else the launcher's pick), to check and time each; all give
// the same bits.
extern "C" void mcp_slope_reml_set_form(int form) {
    g_form = (form >= FORM_AUTO && form <= FORM_QUAD) ? form : FORM_AUTO;
}

// The form a launch of B cells of m clusters at q, p takes: out[0] the form
// (1 packed, 2 pair, 3 quad), out[1] the dynamic shared bytes a block,
// out[2] resident cells an SM, out[3] the launch's waves, out[4] registers
// and out[5] local (spill and stack) bytes a thread of its kernel, out[6]
// staged, out[7] cells a block. Returns a cudaError_t.
extern "C" int mcp_slope_reml_geometry(int B, int m, int q, int p, int* out) {
    Args a;
    const int err = fill_args(a, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, B,
                              1, m, q, p, nullptr, nullptr, 0, 0.0, 0.0);
    return err ? err : geometry_any(a, q, out);
}

// mcp_slope_reml, also writing each cell's count of the f32 evaluations its
// search needed (the reflection and at most one more candidate an
// iteration) to evals (B,) int32 where not null.
extern "C" int mcp_slope_reml_counted(const void* G, const void* A, const void* b,
                                      const void* xtx, const void* xty, const void* yty,
                                      const void* ns, int B, int Gn, int m, int q, int p,
                                      const double* theta0, const double* lower, int iters,
                                      double init_step, double eps_rank, void* beta, void* cov,
                                      void* tau2, void* flags, void* pinned, void* evals,
                                      void* stream) {
    Args a;
    const int err = fill_args(a, G, A, b, xtx, xty, yty, ns, B, Gn, m, q, p, theta0, lower, iters,
                              init_step, eps_rank);
    if (err) return err;
    a.beta = (double*)beta;
    a.cov = (double*)cov;
    a.tau2 = (double*)tau2;
    a.flags = (uint8_t*)flags;
    a.pinned = (uint8_t*)pinned;
    a.evals = (int*)evals;
    return launch_any(a, q, (cudaStream_t)stream);
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
    return mcp_slope_reml_counted(G, A, b, xtx, xty, yty, ns, B, Gn, m, q, p, theta0, lower,
                                  iters, init_step, eps_rank, beta, cov, tau2, flags, pinned,
                                  nullptr, stream);
}

namespace {

// div_by and the IEEE division of each pair (mcp_k9_div_check).
__global__ void div_check_kernel(const float* a, const float* b, float* got, float* want,
                                 unsigned char* bad, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float r = 1.0f / b[i];
    int flag = 0;
    got[i] = div_by(a[i], b[i], r, flag);
    want[i] = __fdiv_rn(a[i], b[i]);
    bad[i] = (unsigned char)((flag & 1) | (mid_range(b[i]) ? 0 : 1));
}

}  // namespace

// div_by against the IEEE division on the card: for n pairs (a, b) (f32,
// b > 0, on the device) writes got = div_by(a, b, 1 / b), want = a / b
// rounded to nearest, and bad (uint8) 1 where div_by's range does not hold
// (a nonzero a or b not mid_range: K9 then takes the IEEE division).
extern "C" int mcp_k9_div_check(const void* a, const void* b, void* got, void* want, void* bad,
                                int n, void* stream) {
    if (n <= 0) return 0;
    div_check_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        (const float*)a, (const float*)b, (float*)got, (float*)want, (unsigned char*)bad, n);
    return (int)cudaGetLastError();
}

#ifdef MCP_K9_CLOCKS
extern "C" int mcp_k9_clocks(void* dst, int zero) {
    if (zero) {
        void* ptr = nullptr;
        int err = (int)cudaGetSymbolAddress(&ptr, mcp_k9_clk);
        return err ? err : (int)cudaMemset(ptr, 0, sizeof(mcp_k9_clk));
    }
    return (int)cudaMemcpyFromSymbol(dst, mcp_k9_clk, sizeof(mcp_k9_clk));
}
#endif
