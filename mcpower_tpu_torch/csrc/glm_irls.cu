// K6 glm_irls: batched two-phase IRLS for unclustered GLMs (logit, probit,
// Poisson-log), one warp per (sim, grid) cell, the rows of each sim staged
// once in shared memory.
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
// intercept-only deviance and mean of y. Each cell has its own 0/1 column
// mask (a sparse-factor exclusion's reduced fit, glmfit.py:246-256), and a
// launch may fit only the cells of an `active` mask: the separation
// fallback's second launch (glmfit.py:258-278) refits the cells whose first
// fit did not converge, with their own masks and cold starts.
//
// What bounds it on the H100: the latency of dependent chains, not bytes
// and not the f64 rate. A sim's rows (N x (p + 1) f32, 6 KB at the GLM
// arm's N = 300, p = 4) are read from device memory once; each step then
// costs per row the linear predictor, a transcendental (exp, erf), three
// IEEE divisions and p (p + 3) / 2 multiply-adds, and per cell a p x p
// Cholesky solve with square roots and divisions. Each division and the f64
// exp end in a rarely taken branch to a slow path, so a row's chain cannot
// overlap the next row's; a warp runs its rows and its solves in turn and
// the SM hides that latency only with other warps (24-32 resident at p <=
// 4, 7-8 above, by registers). The chip_smoke bound counts the steps the
// cells actually run.
//
// What the design does about it:
// - a block holds whole sims: the G cells of one or more sims (one warp a
//   cell, up to MAX_WARPS), or, for G > MAX_WARPS, an interleaved share of
//   one sim's grid points, so the blocks of a sim carry equal rows. The gc
//   warps of a sim stage it once, up to the largest grid point among their
//   cells (a warp that holds its sim alone waits for its own copies only):
//   the fit columns and y, column by column in f32 (row stride rcap
//   + 1), by 4-byte cp.async copies that gather the fit columns out of X
//   and transpose them in flight, so any P, any fit and any slab size or
//   alignment take the same path. Lanes then read rows r = lane + 32 t from
//   shared memory without bank conflicts. Rows past the staged capacity
//   (only when a sim's rows exceed the block's shared-memory budget) are
//   read from device memory in a second loop, in the same order. The
//   launcher (geometry()) chooses sims per block, chunks and capacity;
// - the f32 phase runs in f32 only: each cell's 0/1 column mask is
//   applied by an f32 multiply when a row is read (exact: it equals the
//   reference's f32 copy of x * mask formed in f64); the f64 phase and the
//   final pass convert the masked f32 values;
// - the link is a template parameter, so a row's body holds one link's
//   code and no branch on it; rows are taken one at a time (two rows in
//   flight measured slower: their divisions' branches keep them apart and
//   the registers cost residency);
// - each lane takes every 32nd row and keeps the packed lower triangle of
//   X'WX and X'Wz in registers; the lanes combine them by a
//   recursive-halving reduce-scatter (each level a lane keeps half of its
//   sums and receives its partner's copy of that half), in the pair tree
//   of smallchol.lane_sum, so every sum has the bits of the plain
//   version's; the owner lanes write the sums to the warp's shared-memory
//   slot, from which every lane reads the system and factors it in place
//   (smallchol.cuh's *_packed functions);
// - the final f64 pass is one walk over the rows: X'WX, the deviance and
//   the null deviance, one link evaluation and (binomial) one log per row,
//   with log(mu0) and log(1 - mu0) taken once per cell;
// - a cell leaves a phase at the step after which its state no longer
//   changes: once done holds, the reference freezes beta and done for the
//   remaining steps; once a step is not finite (~ok) with done false, beta
//   is kept and the next step recomputes the same non-finite step, so the
//   state is a fixed point as well. A typical cell runs about 4 f32 and 2
//   f64 steps of the 34.
//
// The plain version (engine/glmfit.py::glm_irls_plain) sums rows in this
// kernel's lane order and tree and performs the same operations in the same
// order; the file is built with --fmad=false so that no multiply-add is
// contracted. Instantiations: p = 1..16 times the three links.

#include "common.cuh"
#include "smallchol.cuh"

#define MCP_MAX_P 16

namespace {

using mcp::tri;

constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_WARPS = 8;                 // cells (warps) per block
constexpr size_t SMEM_BUDGET = 100 * 1024;   // dynamic shared memory a block asks for at most
constexpr size_t SMEM_DEFAULT = 48 * 1024;   // above this only after cudaFuncSetAttribute
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
    const double* colmask;  // (sims * G, pf)
    const uint8_t* active;  // (sims * G), or null: every cell
    double *beta, *cov, *dev, *dev0, *ybar;
    uint8_t* converged;
    int* iters;  // (sims * G, 2) or null
};

struct Cols {
    int fit[MCP_MAX_P];
};

// Launch geometry (geometry()). Block b serves sims [b / nchunk * spb, +
// spb) and of each the grid points chunk + nchunk * i, i < gc, chunk = b %
// nchunk; warp w is the cell (w / gc, w % gc).
struct Geo {
    int nchunk, gc, spb;
    int rcap;         // rows of a sim staged in shared memory, a multiple of 32
    int rs;           // stride of a staged column, rcap + 1 floats
    int threads;
    size_t sums_off;  // byte offset of the warps' sum slots
    size_t smem;      // dynamic shared memory of a block
    long long blocks;
};

// Per-cell sums: the packed lower triangle of X'WX (NT), then X'Wz (a step)
// or the deviance and null deviance (the final pass).
template <int PF>
struct Sizes {
    static constexpr int NT = PF * (PF + 1) / 2;
    static constexpr int STEP = NT + PF;
    static constexpr int FINAL = NT + 2;
    static constexpr int SLOT = STEP > FINAL ? STEP : FINAL;  // doubles per warp
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

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
template <int LINK, typename T>
__device__ __forceinline__ void mu_var_dmu(T eta, T& mu, T& var, T& dmu) {
    const T eps = T(MU_EPS), top = T(1.0 - MU_EPS);
    if constexpr (LINK == LINK_PROBIT) {
        mu = clamp_hi(clamp_lo(T(0.5) * (T(1) + m_erf(eta * T(INV_SQRT2))), eps), top);
        var = mu * (T(1) - mu);
        dmu = clamp_lo(m_exp(T(-0.5) * eta * eta) * T(INV_SQRT_2PI), eps);
    } else if constexpr (LINK == LINK_LOGIT) {
        mu = clamp_hi(clamp_lo(T(1) / (T(1) + m_exp(-eta)), eps), top);
        var = mu * (T(1) - mu);
        dmu = var;
    } else {
        mu = clamp_lo(m_exp(clamp_hi(clamp_lo(eta, T(-30)), T(30))), eps);
        var = mu;
        dmu = mu;
    }
}

// The intercept-only model of a cell: mu0 and its logs, taken once.
struct Null {
    double mu0, l1, l0, lmu0;
};

// Row terms of the deviance at mu and of the null deviance
// (glmfit.py::_deviance_terms). Binomial: t1 + t2 of the reference, of
// which at most one is not 0.0, is that one plus 0.0 (IEEE addition
// commutes), so a row takes one log.
template <int LINK>
__device__ __forceinline__ void deviance_terms(double y, double mu, const Null& nl, double& dt,
                                               double& dt0) {
    if constexpr (LINK != LINK_POISSON) {
        const bool pos = y > 0.5, neg = y < 0.5;
        const double t = (pos || neg) ? -log(pos ? mu : 1.0 - mu) : 0.0;
        dt = t + 0.0;
        dt0 = (pos ? nl.l1 : (neg ? nl.l0 : 0.0)) + 0.0;
    } else {
        const double ylogy = (y > 0.0) ? y * log(clamp_lo(y, MU_EPS)) : 0.0;
        dt = ylogy - y * log(mu) - (y - mu);
        dt0 = ylogy - y * nl.lmu0 - (y - nl.mu0);
    }
}

// The lane sum of V values per lane, every value in smallchol.lane_sum's
// pair tree: level OFF (16, 8, 4, 2, 1) adds lane l's partial to lane l ^
// OFF's, as lane_sum adds acc[i] and acc[i + OFF]. Each level a lane keeps
// half of its N slots (the lower lane the first ceil(N / 2), the upper the
// rest and, for odd N, a dummy) and receives its partner's copy of them; a
// level with one slot left adds both copies (a butterfly step). Lanes that
// differ only in bits below OFF have made the same choices, so each lane's
// slots stay a contiguous run of the values from `base` on, of which the
// first `real` are values and the rest dummies.
__host__ __device__ constexpr int rs_next(int n) { return n == 1 ? 1 : (n + 1) / 2; }
__host__ __device__ constexpr int rs_slots(int n, int off) {
    return off == 0 ? n : rs_slots(rs_next(n), off / 2);
}

template <int N, int OFF, typename T>
__device__ __forceinline__ void rs_levels(T* a, int lane, int& base, int& real) {
    if constexpr (N == 1) {
        a[0] = a[0] + __shfl_xor_sync(FULL, a[0], OFF);
    } else {
        constexpr int H = (N + 1) / 2;
        const bool upper = (lane & OFF) != 0;
#pragma unroll
        for (int k = 0; k < H; ++k) {
            const T lo = a[k];
            const T hi = (k + H < N) ? a[k + H] : T(0);
            const T keep = upper ? hi : lo;
            a[k] = keep + __shfl_xor_sync(FULL, upper ? lo : hi, OFF);
        }
        if (upper) {
            base += H;
            real = real > H ? real - H : 0;
        } else {
            real = real < H ? real : H;
        }
    }
    if constexpr (OFF > 1) rs_levels<rs_next(N), OFF / 2>(a, lane, base, real);
}

// Reduce a[0..V) over the warp and write sum v to out[v] (shared memory);
// every lane may read out[] on return.
template <int V, typename T>
__device__ __forceinline__ void lane_sums(T* a, int lane, T* out) {
    __syncwarp();  // the previous reads of out[] are done
    int base = 0, real = V;
    rs_levels<V, WARP / 2>(a, lane, base, real);
    constexpr int NF = rs_slots(V, WARP / 2);
#pragma unroll
    for (int s = 0; s < NF; ++s)
        if (s < real) out[base + s] = a[s];
    __syncwarp();
}

// A cell's view of its sim's rows.
template <int PF>
struct Cell {
    const float* slab;  // staged: column k at slab[k * rs + r], y at slab[PF * rs + r]
    const float* Xg;    // the sim's rows in device memory, for rows >= rcap
    const float* yg;
    int rs, rcap, P, n;
    float cm[PF];       // the cell's 0/1 column mask
};

// f(x, y) for this lane's rows r = lane + 32 t < n in turn: x the fit
// columns, masked (x * m in f32 equals the f32 value of x * m formed in f64
// for m in {0, 1}), and y. Staged rows first, then any rows past the staged
// capacity from device memory, in the same order.
template <int PF, typename F>
__device__ __forceinline__ void for_rows(const Cell<PF>& c, const Cols& cols, int lane, F&& f) {
    const int staged = c.n < c.rcap ? c.n : c.rcap;
    int r = lane;
    for (; r < staged; r += WARP) {
        float x[PF];
#pragma unroll
        for (int k = 0; k < PF; ++k) x[k] = c.slab[k * c.rs + r] * c.cm[k];
        f(x, c.slab[PF * c.rs + r]);
    }
    for (; r < c.n; r += WARP) {
        float x[PF];
#pragma unroll
        for (int k = 0; k < PF; ++k)
            x[k] = __ldg(c.Xg + (long long)r * c.P + cols.fit[k]) * c.cm[k];
        f(x, __ldg(c.yg + r));
    }
}

template <int PF, typename T>
__device__ __forceinline__ T row_eta(const T* x, const T* beta) {
    T eta = T(0);
#pragma unroll
    for (int k = 0; k < PF; ++k) eta = eta + x[k] * beta[k];
    return eta;
}

// A step's row: x in T, its weight w and w z.
template <int PF, int LINK, typename T>
__device__ __forceinline__ void step_row(const float* xf, float yf, const T* beta, T* x, T& w,
                                         T& wz) {
#pragma unroll
    for (int k = 0; k < PF; ++k) x[k] = (T)xf[k];
    const T eta = row_eta<PF, T>(x, beta);
    T mu, var, dmu;
    mu_var_dmu<LINK, T>(eta, mu, var, dmu);
    w = dmu * dmu / clamp_lo(var, T(MU_EPS));
    const T z = eta + ((T)yf - mu) / dmu;
    wz = w * z;
}

template <int PF, typename T>
__device__ __forceinline__ void add_xwx(const T* x, T w, T* acc) {
#pragma unroll
    for (int i = 0; i < PF; ++i) {
        const T xw = x[i] * w;
#pragma unroll
        for (int j = 0; j <= i; ++j) acc[tri(i, j)] = acc[tri(i, j)] + xw * x[j];
    }
}

template <int PF, typename T>
__device__ __forceinline__ void add_step_row(const T* x, T w, T wz, T* acc) {
    add_xwx<PF, T>(x, w, acc);
#pragma unroll
    for (int i = 0; i < PF; ++i) acc[Sizes<PF>::NT + i] = acc[Sizes<PF>::NT + i] + x[i] * wz;
}

// This lane's share of a step's X'WX and X'Wz at beta.
template <int PF, int LINK, typename T>
__device__ __forceinline__ void step_sums(const Cell<PF>& c, const Cols& cols, int lane,
                                          const T* beta, T* acc) {
#pragma unroll
    for (int i = 0; i < Sizes<PF>::STEP; ++i) acc[i] = T(0);
    for_rows<PF>(c, cols, lane, [&](const float* xf, float yf) {
        T x[PF], w, wz;
        step_row<PF, LINK, T>(xf, yf, beta, x, w, wz);
        add_step_row<PF, T>(x, w, wz, acc);
    });
}

// A final-pass row: x in f64, w, and the two deviance terms.
template <int PF, int LINK>
__device__ __forceinline__ void final_row(const float* xf, float yf, const double* beta,
                                          const Null& nl, double* x, double& w, double& dt,
                                          double& dt0) {
#pragma unroll
    for (int k = 0; k < PF; ++k) x[k] = (double)xf[k];
    double mu, var, dmu;
    mu_var_dmu<LINK, double>(row_eta<PF, double>(x, beta), mu, var, dmu);
    w = dmu * dmu / clamp_lo(var, MU_EPS);
    deviance_terms<LINK>((double)yf, mu, nl, dt, dt0);
}

template <int PF>
__device__ __forceinline__ void add_final_row(const double* x, double w, double dt, double dt0,
                                              double* acc) {
    add_xwx<PF, double>(x, w, acc);
    acc[Sizes<PF>::NT] = acc[Sizes<PF>::NT] + dt;
    acc[Sizes<PF>::NT + 1] = acc[Sizes<PF>::NT + 1] + dt0;
}

// The ridge of a column with mask cm: 1e-10 + pin in f64, that plus 1e-6
// in f32, pin = 1 - cm.
__device__ __forceinline__ double pin_of(float cm) { return 1.0 - (double)cm; }
__device__ __forceinline__ void ridge_of(float cm, double& r) { r = 1e-10 + pin_of(cm); }
__device__ __forceinline__ void ridge_of(float cm, float& r) {
    r = (float)(1e-10 + pin_of(cm)) + (float)1e-6;
}

// One phase: up to n_iter steps from beta (updated in place). Returns the
// steps run; `done` as the reference's carry leaves it.
template <int PF, int LINK, typename T>
__device__ __forceinline__ int irls_phase(const Cell<PF>& c, const Cols& cols, int lane, T* sums,
                                          int n_iter, T tol, T* beta, bool& done) {
    constexpr int NT = Sizes<PF>::NT;
    done = false;
    int steps = 0;
    for (int it = 0; it < n_iter; ++it) {
        ++steps;
        {
            T acc[Sizes<PF>::STEP];
            step_sums<PF, LINK, T>(c, cols, lane, beta, acc);
            lane_sums<Sizes<PF>::STEP, T>(acc, lane, sums);
        }
        T L[NT], bn[PF];
#pragma unroll
        for (int i = 0; i < PF; ++i) {
#pragma unroll
            for (int j = 0; j < i; ++j) L[tri(i, j)] = sums[tri(i, j)];
            T ridge;
            ridge_of(c.cm[i], ridge);
            L[tri(i, i)] = sums[tri(i, i)] + ridge;
        }
        mcp::chol_packed<PF>(L);
        mcp::cho_solve_packed<PF>(L, sums + NT, bn);
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

// Up to p = 4 the kernel fits in 80 registers with few spills, so three
// blocks of MAX_WARPS warps stay resident; wider fits keep their registers.
template <int PF, int LINK>
__global__ void __launch_bounds__(WARP * MAX_WARPS, (PF <= 4) ? 3 : 1)
    glm_irls_kernel(const Args a, const Cols cols, const Geo geo) {
    using S = Sizes<PF>;
    constexpr int NT = S::NT;
    extern __shared__ __align__(16) unsigned char smem[];
    float* stage = reinterpret_cast<float*>(smem);
    const int slab = (PF + 1) * geo.rs;
    const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
    const long long sim0 = (long long)(blockIdx.x / geo.nchunk) * geo.spb;
    const int chunk = blockIdx.x % geo.nchunk;

    // The gc warps of a sim stage it once, up to their active cells'
    // largest grid point (a sim with none is not staged). A warp that holds
    // its sim alone (gc = 1) waits for its own copies only; warps that share
    // sims wait together.
    const int ls = warp / geo.gc, gi = warp % geo.gc;
    const long long sim = sim0 + ls;
    if (sim < a.sims) {
        int rows = 0;
        for (int i = 0; i < geo.gc; ++i) {
            const int gg = chunk + geo.nchunk * i;
            if (gg < a.G && (a.active == nullptr || a.active[sim * a.G + gg]))
                rows = max(rows, min(a.grid[gg], geo.rcap));
        }
        const float* Xs = a.X + sim * a.max_n * (long long)a.P;
        const float* ys = a.y + sim * a.max_n;
        float* dst = stage + ls * slab;
#pragma unroll
        for (int k = 0; k <= PF; ++k) {
            const float* src = k < PF ? Xs + cols.fit[k] : ys;
            const int stride = k < PF ? a.P : 1;
            for (int r = gi * WARP + lane; r < rows; r += geo.gc * WARP)
                cp_async4(dst + k * geo.rs + r, src + (long long)r * stride);
        }
    }
    cp_async_wait_all();
    if (geo.gc == 1)
        __syncwarp();
    else
        __syncthreads();  // geo is uniform: every thread of the block is here

    const int g = chunk + geo.nchunk * gi;
    if (sim >= a.sims || g >= a.G) return;
    const long long cell = sim * a.G + g;
    if (a.active != nullptr && !a.active[cell]) return;  // its outputs stay as they are

    Cell<PF> c;
    c.slab = stage + ls * slab;
    c.Xg = a.X + sim * a.max_n * (long long)a.P;
    c.yg = a.y + sim * a.max_n;
    c.rs = geo.rs;
    c.rcap = geo.rcap;
    c.P = a.P;
    c.n = a.grid[g];
    float b32[PF];
#pragma unroll
    for (int k = 0; k < PF; ++k) {
        c.cm[k] = (float)a.colmask[cell * PF + k];
        b32[k] = (float)a.beta0[cell * PF + k];
    }
    double* sums = reinterpret_cast<double*>(smem + geo.sums_off) + warp * S::SLOT;

    // The outcome mean, before the fit.
    double ysum = 0.0;
    for_rows<PF>(c, cols, lane, [&](const float*, float yf) { ysum = ysum + (double)yf; });
    lane_sums<1, double>(&ysum, lane, sums);
    const double ybar = sums[0] / (double)c.n;

    bool done;
    const int it32 = irls_phase<PF, LINK, float>(c, cols, lane, reinterpret_cast<float*>(sums),
                                                 N_IRLS_ITERS, (float)CONV_TOL_F32, b32, done);
    double beta[PF];
#pragma unroll
    for (int k = 0; k < PF; ++k) beta[k] = (double)b32[k];
    const int it64 = irls_phase<PF, LINK, double>(c, cols, lane, sums, N_IRLS_POLISH, CONV_TOL,
                                                  beta, done);

    // The final pass: unridged X'WX, the deviance and the null deviance.
    Null nl;
    nl.mu0 = clamp_lo(ybar, MU_EPS);
    if constexpr (LINK != LINK_POISSON) {
        nl.mu0 = clamp_hi(nl.mu0, 1.0 - MU_EPS);
        nl.l1 = -log(nl.mu0);
        nl.l0 = -log(1.0 - nl.mu0);
    } else {
        nl.lmu0 = log(nl.mu0);
    }

    {
        double acc[S::FINAL];
#pragma unroll
        for (int i = 0; i < S::FINAL; ++i) acc[i] = 0.0;
        for_rows<PF>(c, cols, lane, [&](const float* xf, float yf) {
            double x[PF], w, dt, dt0;
            final_row<PF, LINK>(xf, yf, beta, nl, x, w, dt, dt0);
            add_final_row<PF>(x, w, dt, dt0, acc);
        });
        lane_sums<S::FINAL, double>(acc, lane, sums);
    }
    const double dev = 2.0 * sums[NT], dev0 = 2.0 * sums[NT + 1];

    double L[NT];
#pragma unroll
    for (int i = 0; i < PF; ++i) {
#pragma unroll
        for (int j = 0; j <= i; ++j) {
            double ridge = 0.0;
            if (i == j) ridge_of(c.cm[i], ridge);
            L[tri(i, j)] = sums[tri(i, j)] + ridge;
        }
    }
    mcp::chol_packed<PF>(L);
#pragma unroll
    for (int j = 0; j < PF; ++j)
        if (j % WARP == lane) mcp::cho_inverse_column_packed<PF>(L, j, a.cov + cell * PF * PF);
#pragma unroll
    for (int i = 0; i < PF; ++i) {
#pragma unroll
        for (int j = 0; j <= i; ++j)
            L[tri(i, j)] = sums[tri(i, j)] + ((i == j) ? pin_of(c.cm[i]) : 0.0);
    }
    mcp::chol_packed<PF>(L);
    bool finite = true, at_cap = false, rank_ok = true;
    double lo = L[0], hi = L[0];
#pragma unroll
    for (int k = 0; k < PF; ++k) {
        finite = finite && isfinite(beta[k]);
        at_cap = at_cap || (fabs(beta[k]) >= BETA_CAP - 1e-6);
        const double d = L[tri(k, k)];
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

size_t align16(size_t b) { return (b + 15) / 16 * 16; }

// Sims per block, grid chunks and staged rows for a launch: at most
// MAX_WARPS cells a block, whole sims where G allows, and the staged slabs
// plus the warps' sum slots within SMEM_BUDGET (fewer sims a block first,
// then fewer staged rows).
template <int PF>
Geo geometry(int sims, int max_n, int G) {
    Geo g;
    g.nchunk = (G + MAX_WARPS - 1) / MAX_WARPS;
    g.gc = (G + g.nchunk - 1) / g.nchunk;
    g.spb = g.nchunk == 1 ? (MAX_WARPS / G < sims ? MAX_WARPS / G : sims) : 1;
    if (g.spb < 1) g.spb = 1;
    const auto bytes = [&](int spb, int rcap, size_t* sums_off) {
        const size_t off = align16((size_t)spb * (PF + 1) * (rcap + 1) * sizeof(float));
        if (sums_off) *sums_off = off;
        return off + (size_t)spb * g.gc * Sizes<PF>::SLOT * sizeof(double);
    };
    const int rows = (max_n + WARP - 1) / WARP * WARP;
    while (g.spb > 1 && bytes(g.spb, rows, nullptr) > SMEM_BUDGET) --g.spb;
    g.rcap = rows;
    while (g.rcap > 0 && bytes(g.spb, g.rcap, nullptr) > SMEM_BUDGET) g.rcap -= WARP;
    g.rs = g.rcap + 1;
    g.smem = bytes(g.spb, g.rcap, &g.sums_off);
    g.threads = WARP * g.spb * g.gc;
    g.blocks = (long long)((sims + g.spb - 1) / g.spb) * g.nchunk;
    return g;
}

// Allow this instantiation the dynamic shared memory of `geo` (once per
// size above the default).
template <int PF, int LINK>
int allow_smem(const Geo& geo) {
    static size_t allowed = SMEM_DEFAULT;
    if (geo.smem <= allowed) return 0;
    const int err = (int)cudaFuncSetAttribute(
        glm_irls_kernel<PF, LINK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geo.smem);
    if (err == 0) allowed = geo.smem;
    return err;
}

template <int PF, int LINK>
int launch_link(const Args& a, const Cols& cols, cudaStream_t stream) {
    const Geo geo = geometry<PF>(a.sims, a.max_n, a.G);
    if (geo.blocks <= 0 || geo.blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    const int err = allow_smem<PF, LINK>(geo);
    if (err != 0) return err;
    glm_irls_kernel<PF, LINK>
        <<<(unsigned)geo.blocks, geo.threads, geo.smem, stream>>>(a, cols, geo);
    return (int)cudaGetLastError();
}

// The link is a template parameter, so that a row's body holds one link.
template <int PF>
int launch(const Args& a, const Cols& cols, cudaStream_t stream) {
    switch (a.link) {
        case LINK_LOGIT: return launch_link<PF, LINK_LOGIT>(a, cols, stream);
        case LINK_PROBIT: return launch_link<PF, LINK_PROBIT>(a, cols, stream);
        default: return launch_link<PF, LINK_POISSON>(a, cols, stream);
    }
}

// Residency of the logit instantiation.
template <int PF>
int occupancy(int sims, int max_n, int G, int* out) {
    const Geo geo = geometry<PF>(sims, max_n, G);
    int err = allow_smem<PF, LINK_LOGIT>(geo);
    if (err != 0) return err;
    int blocks = 0;
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, glm_irls_kernel<PF, LINK_LOGIT>, geo.threads, geo.smem);
    out[0] = blocks;
    out[1] = geo.threads;
    out[2] = (int)geo.smem;
    out[3] = geo.spb;
    out[4] = geo.rcap;
    return err;
}

}  // namespace

// fit: pf column indices of X (host memory); grid: G row counts in
// 1..max_n (device memory); beta0 (sims, G, pf) and colmask (sims, G, pf)
// f64 on the device, colmask 0/1; active (sims, G) uint8 on the device, or
// null for every cell (a cell outside it writes no output); link 0 logit, 1
// probit, 2 Poisson. iters may be null. Returns a cudaError_t.
extern "C" int mcp_glm_irls(const void* X, const void* y, int sims, int max_n, int P,
                            const int* fit, int pf, const void* grid, int G, const void* beta0,
                            const void* colmask, const void* active, int link, void* beta,
                            void* cov, void* converged, void* dev, void* dev0, void* ybar,
                            void* iters, void* stream) {
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
    a.active = (const uint8_t*)active;
    a.beta = (double*)beta;
    a.cov = (double*)cov;
    a.dev = (double*)dev;
    a.dev0 = (double*)dev0;
    a.ybar = (double*)ybar;
    a.converged = (uint8_t*)converged;
    a.iters = (int*)iters;
    MCP_DISPATCH_P(pf, launch, a, cols, (cudaStream_t)stream)
}

// The launch geometry mcp_glm_irls takes for (pf, sims, max_n, G) and the
// residency of its logit kernel: out[0] resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] threads a block,
// out[2] dynamic shared memory a block (bytes), out[3] sims a block, out[4]
// rows of a sim staged. Returns a cudaError_t.
extern "C" int mcp_glm_irls_occupancy(int pf, int sims, int max_n, int G, int* out) {
    if (sims <= 0 || max_n <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
    MCP_DISPATCH_P(pf, occupancy, sims, max_n, G, out)
}
