// The joint-Z capacitance of extra groupings for one warp: kernels K11
// (joint_reml.cu, the LMM's REML fit) and K12 (glmm_extras.cu, the GLMM's
// Laplace fit) include this file. Device twins of
// engine/mixedfit.py::joint_capacitance and engine/smallchol.py's scalar and
// blocked factors and solves (chol / cho_solve below VEC_FROM, chol_vec /
// cho_solve_mat_vec from it), in their operations and order.
//
// The capacitance C = I + Lam' Z'Z Lam (Z'WZ for the GLMM) of theta takes one
// of two forms:
// - structured (every grouping intercept-only, Lam = diag): a = 1 + l1^2
//   diag(G_PP) over the m1 primary levels, Cpe = (l1 G_PE) dE, the Me x Me
//   Schur complement S = (I + (dE dE') G_EE) - Cpe' (Cpe / a), its factor,
//   the r column solves t = re - Cpe' (rp / a), xe = S^-1 t, xp = rp / a -
//   (Cpe xe) / a, log|C| = sum log a + log|S|;
// - dense: C = I + Lam' Z'Z Lam with Lam = blockdiag(I_m (x) Lg), each entry
//   formed from its grouping blocks (never a dense Lam product), its blocked
//   factor and the blocked solve of Lam' rhs.
// The statistics come from a source `c` with c.z(i, j) (Z'Z, M x M; the
// structured form reads diag(G_PP), G_PE and G_EE's lower triangle) and
// c.raw(row, col) (the right-hand sides, M x r). The plan `a` has M, ng, m1,
// Me and per grouping comps (q_g), coff (its first column) and toff (its
// first theta entry); the column table `S` has each column's grouping cgrp,
// component crr and level base cbase. Lanes take the entries of the panel and
// trailing updates, the rows of a factor column, the entries of Cpe, C and
// the (row, column) pairs of the solves, 2 x 2 blocks of S's entries, with
// __syncwarp between dependent steps; a chain of dependent sums reads four
// terms ahead (fold_add). The factors and the forward solves take two
// columns (rows) a step. The factor lives in rows ld apart (K12) or packed
// by rows, its lower triangle alone (K11, capacitance<true>). Every entry
// receives the plain version's operations in its order, whatever lane or
// step forms it (tests/test_torch_fit_orders.py restates these schedules).
#pragma once

#include <math.h>

#include <type_traits>

// K11's cycle counts by region: chip_k11_profile.py builds joint_reml.cu with
// -DMCP_K11_CLOCKS=cells, which takes K12's hooks and array below, with the
// forming of C or S apart in slot 1 (slots: chip_k11_profile.REGIONS).
#if defined(MCP_K11_CLOCKS) && !defined(MCP_K12_CLOCKS)
#define MCP_K12_CLOCKS MCP_K11_CLOCKS
#define K11_FORMED(v) K12_ADD32(1, v)
#else
#define K11_FORMED(v)
#endif

// K12's cycle counts by region: chip_k12_profile.py builds glmm_extras.cu with
// -DMCP_K12_CLOCKS=cells, and lane 0 of each warp of the first `cells` cells adds
// clock64() deltas into row blockIdx.x of mcp_k12_clk (slots: chip_k12_profile.REGIONS).
#ifdef MCP_K12_CLOCKS
__device__ unsigned long long mcp_k12_clk[MCP_K12_CLOCKS * 12];
#define K12_T0(v) long long v = clock64()
#define K12_RE(v) v = clock64()
#define K12_ADD(k, v) do { if (threadIdx.x % 32 == 0 && blockIdx.x < MCP_K12_CLOCKS) \
    atomicAdd(&mcp_k12_clk[(long long)blockIdx.x * 12 + (k)], \
              (unsigned long long)(clock64() - (v))); } while (0)
#define K12_ADD32(k, v) do { if (sizeof(T) == 4) K12_ADD(k, v); } while (0)
#else
#define K12_T0(v)
#define K12_RE(v)
#define K12_ADD(k, v)
#define K12_ADD32(k, v)
#endif

namespace mcp {
namespace jcap {

constexpr int WARP = 32;
constexpr int MAX_D = 10;
constexpr int MAX_G = 4;
constexpr int MAX_P = 16;
constexpr int MAX_M = 128;
constexpr int BLOCK = 8;      // smallchol.CHOL_BLOCK
constexpr int VEC_FROM = 13;  // smallchol.VEC_FROM_P

// Layout of a capacitance work area, in elements of T (f32 for a search,
// f64 for a refit): the factor, the right-hand sides and their solves, acc,
// a p x p matrix and its inverse, vectors. Structured cells also hold the
// terms of an evaluation that the factor and the solves read many times: a,
// Cpe, Cpe / a, dE, rp, rp / a and re (m1 = rows of the primary block, e =
// extras levels). Every cell ends with the logs of log|C|, taken in
// parallel and added in order.
struct Layout {
    int n, r, keep, m1, e;  // factor size, right-hand sides (p + 1), rows kept
    int pm;                 // the p x p matrices' order (MAX_P, or p where the area is tight)
    int pk;                 // 1 where the factor is packed by rows (its lower triangle alone)
    __host__ __device__ int ld() const { return n | 1; }  // the factor's row stride, odd
    __host__ __device__ size_t mat() const { return 0; }
    __host__ __device__ size_t rhs() const {
        return pk ? (size_t)n * (n + 1) / 2 : (size_t)n * ld();
    }
    __host__ __device__ size_t kept() const { return rhs() + (size_t)n * r; }
    __host__ __device__ size_t acc() const { return kept() + (size_t)keep * r; }
    __host__ __device__ size_t pmat() const { return acc() + (size_t)r * r; }
    __host__ __device__ size_t pinv() const { return pmat() + (size_t)pm * pm; }
    __host__ __device__ size_t vecs() const { return pinv() + (size_t)pm * pm; }
    __host__ __device__ size_t av() const { return vecs() + 2 * MAX_P + MAX_D; }
    __host__ __device__ size_t de() const { return av() + m1; }
    __host__ __device__ size_t cpe() const { return de() + e; }
    __host__ __device__ size_t cpa() const { return cpe() + (size_t)m1 * e; }
    __host__ __device__ size_t rp() const { return cpa() + (size_t)m1 * e; }
    __host__ __device__ size_t rpa() const { return rp() + (size_t)m1 * r; }
    __host__ __device__ size_t re() const { return rpa() + (size_t)m1 * r; }
    __host__ __device__ size_t logs() const { return re() + (size_t)e * r; }
    __host__ __device__ size_t total() const { return logs() + (size_t)keep + n; }
};

__host__ __device__ inline Layout layout_of(int structured, int M, int m1, int Me, int p,
                                            int pm = MAX_P, int pk = 0) {
    Layout l;
    l.pm = pm;
    l.pk = pk;
    l.n = structured ? Me : M;
    l.r = p + 1;
    l.keep = structured ? m1 : M;
    l.m1 = structured ? m1 : 0;
    l.e = structured ? Me : 0;
    return l;
}

__device__ __forceinline__ int vech(int i, int j, int q) { return j * q - j * (j - 1) / 2 + (i - j); }

// s + term(0) + term(1) + ... + term(n - 1), added in that order (s - ... for
// fold_sub): four terms are read before they are added, so the loads of a
// dependent chain in shared memory overlap; the sums are the loop's own.
template <typename T, class F>
__device__ __forceinline__ T fold_add(T s, int n, F term) {
    int k = 0;
    for (; k + 4 <= n; k += 4) {
        const T t0 = term(k), t1 = term(k + 1), t2 = term(k + 2), t3 = term(k + 3);
        s = s + t0;
        s = s + t1;
        s = s + t2;
        s = s + t3;
    }
    for (; k < n; ++k) s = s + term(k);
    return s;
}

template <typename T, class F>
__device__ __forceinline__ T fold_sub(T s, int n, F term) {
    int k = 0;
    for (; k + 4 <= n; k += 4) {
        const T t0 = term(k), t1 = term(k + 1), t2 = term(k + 2), t3 = term(k + 3);
        s = s - t0;
        s = s - t1;
        s = s - t2;
        s = s - t3;
    }
    for (; k < n; ++k) s = s - term(k);
    return s;
}

// Row i of the lower triangle's entry e (e = i (i + 1) / 2 + j, j <= i).
__device__ __forceinline__ int tri_row(int e) {
    int i = (int)((sqrtf(8.0f * (float)e + 1.0f) - 1.0f) * 0.5f);
    while (i * (i + 1) / 2 > e) --i;
    while ((i + 1) * (i + 2) / 2 <= e) ++i;
    return i;
}

// A lane's walk over the lower triangle's entries e, e + step, ... as (row
// i, column j): one square root at the start, none an entry.
struct TriWalk {
    int i, j;
    __device__ __forceinline__ explicit TriWalk(int e) : i(tri_row(e)) { j = e - i * (i + 1) / 2; }
    __device__ __forceinline__ void advance(int step) {
        j += step;
        while (j > i) {
            j -= i + 1;
            ++i;
        }
    }
};

// Where entry (i, j), j <= i, of an n x n matrix lives: row-major with rows ld
// apart (Strided), or packed by rows, the lower triangle alone (Packed).
struct Strided {
    int ld;
    __device__ __forceinline__ int operator()(int i, int j) const { return i * ld + j; }
};
struct Packed {
    __device__ __forceinline__ int operator()(int i, int j) const { return ((i * (i + 1)) >> 1) + j; }
};

// ---------------------------------------------------------------------------
// Warp-wide factor and solves on an n x n matrix whose lower entries `ix`
// places (rows ld apart, n where not given and odd in K12's capacitance, so
// the entries of a column fall in distinct shared-memory banks; or packed by
// rows), in place (smallchol's chol / solve_lower / solve_upper_t below
// VEC_FROM, chol_vec / _forward_vec / _backward_vec from it).
// ---------------------------------------------------------------------------

// Both factors take two columns a step where two are left (in the blocked
// factor, in its panel): every lane first reads the step's two pivots'
// entries and forms the second pivot itself, then each row's two entries,
// then the rest of the trailing (or panel) triangle takes both rank-1
// updates, the first column's before the second's. Each entry receives the
// operations of the one-column order, in that order; three __syncwarp a
// step instead of six.
template <typename T, class IX>
__device__ void chol_scalar(T* A, int n, IX ix, int lane) {
    int j = 0;
    for (; j + 1 < n; j += 2) {
        const int k = j + 1;
        const T piv = sqrt(A[ix(j, j)]);
        const T inv = T(1) / piv;
        const T lkj = A[ix(k, j)] * inv;
        const T piv1 = sqrt(A[ix(k, k)] - lkj * lkj);
        const T inv1 = T(1) / piv1;
        __syncwarp();
        if (lane == 0) {
            A[ix(j, j)] = piv;
            A[ix(k, k)] = piv1;
        }
        for (int i = k + lane; i < n; i += WARP) {
            const T lij = A[ix(i, j)] * inv;
            A[ix(i, j)] = lij;
            if (i > k) A[ix(i, k)] = (A[ix(i, k)] - lij * lkj) * inv1;
        }
        __syncwarp();
        for (int i = k + 1 + lane; i < n; i += WARP) {  // the trailing lower triangle
            const T lij = A[ix(i, j)], lik = A[ix(i, k)];
            for (int c = k + 1; c <= i; ++c)
                A[ix(i, c)] = (A[ix(i, c)] - lij * A[ix(c, j)]) - lik * A[ix(c, k)];
        }
        __syncwarp();
    }
    if (j < n) {  // the last column
        const T piv = sqrt(A[ix(j, j)]);
        __syncwarp();
        if (lane == 0) A[ix(j, j)] = piv;
        __syncwarp();
    }
}

template <typename T, class IX>
__device__ void chol_blocked(T* A, int n, IX ix, int lane) {
    for (int j0 = 0; j0 < n; j0 += BLOCK) {
        const int j1 = min(j0 + BLOCK, n);
        // the panel: S = A - (its contraction with the columns before it);
        // lanes take its 8 columns by 4 rows a pass
        const int j = j0 + (lane & (BLOCK - 1));
        if (j0 > 0 && j < j1) {
            for (int i = j0 + lane / BLOCK; i < n; i += WARP / BLOCK) {
                if (j <= i) {
                    const T acc = fold_add(T(0), j0, [&](int k) { return A[ix(i, k)] * A[ix(j, k)]; });
                    A[ix(i, j)] = A[ix(i, j)] - acc;
                }
            }
        }
        __syncwarp();
        int g = j0;
        for (; g + 1 < j1; g += 2) {
            const int h = g + 1;
            const T piv = sqrt(A[ix(g, g)]);
            const T lhg = A[ix(h, g)] / piv;
            const T piv1 = sqrt(A[ix(h, h)] - lhg * lhg);
            __syncwarp();
            for (int i = g + lane; i < n; i += WARP) {
                const T lig = A[ix(i, g)] / piv;
                A[ix(i, g)] = lig;
                if (i >= h) A[ix(i, h)] = (A[ix(i, h)] - lig * lhg) / piv1;
            }
            __syncwarp();
            for (int i = h + 1 + lane; i < n; i += WARP) {  // the rank-1 tails in the panel
                const T lig = A[ix(i, g)], lih = A[ix(i, h)];
                for (int c = h + 1; c < j1 && c <= i; ++c)
                    A[ix(i, c)] = (A[ix(i, c)] - lig * A[ix(c, g)]) - lih * A[ix(c, h)];
            }
            __syncwarp();
        }
        if (g < j1) {  // the panel's last column
            const T piv = sqrt(A[ix(g, g)]);
            __syncwarp();
            for (int i = g + lane; i < n; i += WARP) A[ix(i, g)] = A[ix(i, g)] / piv;
            __syncwarp();
        }
    }
}

template <typename T, class IX>
__device__ void chol_auto(T* A, int n, bool blocked, int lane, IX ix) {
    if (blocked) chol_blocked(A, n, ix, lane);
    else chol_scalar(A, n, ix, lane);
}

template <typename T>
__device__ void chol_auto(T* A, int n, bool blocked, int lane) {
    chol_auto(A, n, blocked, lane, Strided{n});
}

// Solve (L L') X = B in place, B (n, r) row-major. The forward solves take
// two rows a step where two are left (in the blocked solve, in its block):
// lane c forms both rows' column c, then the later rows take both updates,
// the first row's before the second's.
template <typename T, class IX>
__device__ void cho_solve_auto(const T* L, T* B, int n, int r, bool blocked, int lane, IX ix) {
    if (!blocked) {
        int i = 0;
        for (; i + 1 < n; i += 2) {  // forward, right-looking
            const int k1 = i + 1;
            for (int c = lane; c < r; c += WARP) {
                const T x = B[i * r + c] / L[ix(i, i)];
                B[i * r + c] = x;
                B[k1 * r + c] = (B[k1 * r + c] - L[ix(k1, i)] * x) / L[ix(k1, k1)];
            }
            __syncwarp();
            for (int k = k1 + 1 + lane; k < n; k += WARP) {
                const T lki = L[ix(k, i)], lkk = L[ix(k, k1)];
                for (int c = 0; c < r; ++c)
                    B[k * r + c] = (B[k * r + c] - lki * B[i * r + c]) - lkk * B[k1 * r + c];
            }
            __syncwarp();
        }
        if (i < n) {
            for (int c = lane; c < r; c += WARP) B[i * r + c] = B[i * r + c] / L[ix(i, i)];
            __syncwarp();
        }
        for (int i = n - 1; i >= 0; --i) {  // backward, the later rows ascending
            for (int c = lane; c < r; c += WARP) {
                const T s = fold_sub(B[i * r + c], n - i - 1, [&](int k) {
                    return L[ix(i + 1 + k, i)] * B[(i + 1 + k) * r + c];
                });
                B[i * r + c] = s / L[ix(i, i)];
            }
            __syncwarp();
        }
        return;
    }
    for (int j0 = 0; j0 < n; j0 += BLOCK) {  // forward
        const int j1 = min(j0 + BLOCK, n);
        for (int e = lane; e < (j1 - j0) * r; e += WARP) {
            const int i = j0 + e / r, c = e % r;
            const T acc = fold_add(T(0), j0, [&](int k) { return L[ix(i, k)] * B[k * r + c]; });
            B[i * r + c] = B[i * r + c] - acc;
        }
        __syncwarp();
        int g = j0;
        for (; g + 1 < j1; g += 2) {
            const int h = g + 1;
            for (int c = lane; c < r; c += WARP) {
                const T x = B[g * r + c] / L[ix(g, g)];
                B[g * r + c] = x;
                B[h * r + c] = (B[h * r + c] - L[ix(h, g)] * x) / L[ix(h, h)];
            }
            __syncwarp();
            for (int k = h + 1 + lane; k < j1; k += WARP) {
                const T lkg = L[ix(k, g)], lkh = L[ix(k, h)];
                for (int c = 0; c < r; ++c)
                    B[k * r + c] = (B[k * r + c] - lkg * B[g * r + c]) - lkh * B[h * r + c];
            }
            __syncwarp();
        }
        if (g < j1) {
            for (int c = lane; c < r; c += WARP) B[g * r + c] = B[g * r + c] / L[ix(g, g)];
            __syncwarp();
        }
    }
    const int last = ((n - 1) / BLOCK) * BLOCK;
    for (int j0 = last; j0 >= 0; j0 -= BLOCK) {  // backward
        const int j1 = min(j0 + BLOCK, n);
        for (int e = lane; e < (j1 - j0) * r; e += WARP) {
            const int i = j0 + e / r, c = e % r;
            const T acc = fold_add(T(0), n - j1, [&](int k) {
                return L[ix(j1 + k, i)] * B[(j1 + k) * r + c];
            });
            B[i * r + c] = B[i * r + c] - acc;
        }
        __syncwarp();
        for (int g = j1 - 1; g >= j0; --g) {
            for (int c = lane; c < r; c += WARP) {
                T s = B[g * r + c];
                for (int k = g + 1; k < j1; ++k) s = s - L[ix(k, g)] * B[k * r + c];
                B[g * r + c] = s / L[ix(g, g)];
            }
            __syncwarp();
        }
    }
}

template <typename T>
__device__ void cho_solve_auto(const T* L, T* B, int n, int r, bool blocked, int lane) {
    cho_solve_auto(L, B, n, r, blocked, lane, Strided{n});
}

// 2 sum log diag(L), the logs added in ascending order.
template <typename T>
__device__ __forceinline__ T logdet_ordered(const T* L, int n) {
    T acc = log(L[0]);
    for (int i = 1; i < n; ++i) acc = acc + log(L[i * n + i]);
    return T(2) * acc;
}

// ---------------------------------------------------------------------------
// The capacitance at theta `th` (d entries, as T)
// ---------------------------------------------------------------------------

// structured: an extras level's scale (its grouping's theta entry)
template <typename T, class A>
__device__ __forceinline__ T dE_of(const A& a, const T* th, int e) {
    int g = 1;
    while (g + 1 < a.ng && a.m1 + e >= a.coff[g + 1]) ++g;
    return th[a.toff[g]];
}

// dense: Lg[i][j] of grouping g
template <typename T, class A>
__device__ __forceinline__ T lam_of(const A& a, const T* th, int g, int i, int j) {
    return th[a.toff[g] + vech(i, j, a.comps[g])];
}

// dense: (Lam' v)[row] for v(row') = v of column row' (the columns of the
// row's level), summed over r' >= r from r' = r
template <typename T, class A, class CT, class F>
__device__ __forceinline__ T lam_rows(const A& a, const CT& S, const T* th, int row, F v) {
    const int g = S.cgrp[row], r = S.crr[row], base = S.cbase[row];
    T acc = lam_of(a, th, g, r, r) * v(base + r);
    for (int rr = r + 1; rr < a.comps[g]; ++rr) acc = acc + lam_of(a, th, g, rr, r) * v(base + rr);
    return acc;
}

// The capacitance of the work area `sm` (laid out by `lay`: n = Me
// structured, M dense; r right-hand sides) in the form `structured`; returns
// log|C|. With `solve`, also the right-hand sides Lam' raw (`kept` dense, rp
// and re structured), their solves (dense: `rhs`; structured: xp in `kept`,
// xe in `rhs`) and acc = rhs' sol (r x r); without, only the factor.
template <bool PK = false, typename T, class A, class CT, class Src>
__device__ T capacitance(const A& a, const CT& S, const T* th, const Src& c, T* sm,
                         const Layout& lay, bool structured, bool solve, int lane) {
    const int M = a.M, r = lay.r, n = lay.n;
    // the factor's entries: packed by rows where the area says so (PK), else
    // rows ld apart
    using IX = typename std::conditional<PK, Packed, Strided>::type;
    IX ix;
    if constexpr (!PK) ix.ld = lay.ld();
    T* mat = sm + lay.mat();
    T* rhs = sm + lay.rhs();
    T* kept = sm + lay.kept();
    T* acc = sm + lay.acc();
    K12_T0(clk_f);
    K12_T0(clk_v);
    K12_T0(clk_l);
    T logdet_v;
    if (structured) {
        const int m1 = a.m1, Me = a.Me;
        T* av = sm + lay.av();
        T* dE = sm + lay.de();
        T* cpe = sm + lay.cpe();
        T* cpa = sm + lay.cpa();
        T* rp = sm + lay.rp();
        T* rpa = sm + lay.rpa();
        T* re = sm + lay.re();
        const T l1 = th[0];
        for (int j = lane; j < m1; j += WARP) av[j] = T(1) + (l1 * l1) * c.z(j, j);
        for (int e = lane; e < Me; e += WARP) dE[e] = dE_of(a, th, e);
        __syncwarp();
        // Cpe = (l1 G_PE) dE and Cpe / a, an entry a lane; rp, rp / a
        {
            int j = lane / Me, ee = lane - (lane / Me) * Me;
            for (int e = lane; e < m1 * Me; e += WARP) {
                const T v = (l1 * c.z(j, m1 + ee)) * dE[ee];
                cpe[e] = v;
                cpa[e] = v / av[j];
                ee += WARP;
                while (ee >= Me) {
                    ee -= Me;
                    ++j;
                }
            }
        }
        for (int e = lane; e < (solve ? m1 * r : 0); e += WARP) {
            const int j = e / r, cc = e % r;
            const T v = l1 * c.raw(j, cc);
            rp[e] = v;
            rpa[e] = v / av[j];
        }
        for (int ee = lane; ee < (solve ? Me : 0); ee += WARP)
            for (int cc = 0; cc < r; ++cc) re[ee * r + cc] = dE[ee] * c.raw(m1 + ee, cc);
        __syncwarp();
        // S, lower triangle, a 2 x 2 block of entries a lane: each entry's
        // sum over the primary levels in ascending order from a zero
        const int hb = (Me + 1) / 2;
        TriWalk ws(lane);
        for (int b = lane; b < hb * (hb + 1) / 2; b += WARP, ws.advance(WARP)) {
            const int e1 = 2 * ws.i, e2 = 2 * ws.j;
            const int f1 = min(e1 + 1, Me - 1), f2 = min(e2 + 1, Me - 1);
            T s00 = T(0), s01 = T(0), s10 = T(0), s11 = T(0);
            for (int j = 0; j < m1; ++j) {
                const T p0 = cpe[j * Me + e1], p1 = cpe[j * Me + f1];
                const T q0 = cpa[j * Me + e2], q1 = cpa[j * Me + f2];
                s00 = s00 + p0 * q0;
                s01 = s01 + p0 * q1;
                s10 = s10 + p1 * q0;
                s11 = s11 + p1 * q1;
            }
            auto put = [&](int i1, int i2, T sv) {
                const T cee = T(i1 == i2 ? 1 : 0) + (dE[i1] * dE[i2]) * c.z(m1 + i1, m1 + i2);
                mat[ix(i1, i2)] = cee - sv;
            };
            put(e1, e2, s00);
            if (e2 + 1 <= e1 && e2 + 1 < Me) put(e1, e2 + 1, s01);
            if (e1 + 1 < Me) {
                put(e1 + 1, e2, s10);
                if (e2 + 1 < Me) put(e1 + 1, e2 + 1, s11);
            }
        }
        for (int e = lane; e < (solve ? Me * r : 0); e += WARP) {  // t = re - Cpe' (rp / a)
            const int ee = e / r, cc = e % r;
            const T s = fold_add(T(0), m1, [&](int j) { return cpe[j * Me + ee] * rpa[j * r + cc]; });
            rhs[e] = re[e] - s;
        }
        __syncwarp();
        K11_FORMED(clk_f);
        K12_T0(clk_c);
        chol_auto(mat, n, n >= VEC_FROM, lane, ix);
        K12_ADD32(11, clk_c);
        K12_ADD32(4, clk_f);
        K12_RE(clk_v);
        if (solve) {
            cho_solve_auto(mat, rhs, n, r, n >= VEC_FROM, lane, ix);
            for (int e = lane; e < m1 * r; e += WARP) {  // xp = rp / a - (Cpe xe) / a
                const int j = e / r, cc = e % r;
                const T s = fold_add(T(0), Me, [&](int ee) { return cpe[j * Me + ee] * rhs[ee * r + cc]; });
                kept[e] = rpa[e] - s / av[j];
            }
            __syncwarp();
            for (int e = lane; e < r * r; e += WARP) {  // [rp; re]' [xp; xe]
                const int i = e / r, jj = e % r;
                const T s = fold_add(T(0), m1, [&](int row) { return rp[row * r + i] * kept[row * r + jj]; });
                acc[e] = fold_add(s, Me, [&](int ee) { return re[ee * r + i] * rhs[ee * r + jj]; });
            }
        }
        K12_ADD32(5, clk_v);
        K12_RE(clk_l);
        T* logs = sm + lay.logs();  // log a, then the factor's log pivots
        for (int j = lane; j < m1 + n; j += WARP)
            logs[j] = log(j < m1 ? av[j] : mat[ix(j - m1, j - m1)]);
        __syncwarp();
        const T la = fold_add(logs[0], m1 - 1, [&](int j) { return logs[1 + j]; });
        const T lf = fold_add(logs[m1], n - 1, [&](int i) { return logs[m1 + 1 + i]; });
        logdet_v = la + T(2) * lf;
    } else {
        TriWalk wc(lane);
        for (int e = lane; e < M * (M + 1) / 2; e += WARP, wc.advance(WARP)) {  // C = I + Lam' ztz Lam, lower, an entry a lane
            const int ia = wc.i, ib = wc.j;
            const int h = S.cgrp[ib], s2 = S.crr[ib], base = S.cbase[ib];
            T cv = T(0);
            for (int ss = s2; ss < a.comps[h]; ++ss) {
                const T w = lam_rows(a, S, th, ia, [&](int row) { return c.z(row, base + ss); });
                const T u = lam_of(a, th, h, ss, s2) * w;
                cv = (ss == s2) ? u : cv + u;
            }
            mat[ix(ia, ib)] = T(ia == ib ? 1 : 0) + cv;
        }
        for (int e = lane; e < (solve ? M * r : 0); e += WARP) {  // Lam' [zty | ztx]
            const int ia = e / r, cc = e % r;
            const T v = lam_rows(a, S, th, ia, [&](int rr) { return c.raw(rr, cc); });
            kept[e] = v;
            rhs[e] = v;
        }
        __syncwarp();
        K11_FORMED(clk_f);
        K12_T0(clk_c);
        chol_blocked(mat, n, ix, lane);
        K12_ADD32(11, clk_c);
        K12_ADD32(4, clk_f);
        K12_RE(clk_v);
        if (solve) {
            cho_solve_auto(mat, rhs, n, r, true, lane, ix);
            for (int e = lane; e < r * r; e += WARP) {
                const int i = e / r, jj = e % r;
                acc[e] = fold_add(T(0), M, [&](int row) { return kept[row * r + i] * rhs[row * r + jj]; });
            }
        }
        K12_ADD32(5, clk_v);
        K12_RE(clk_l);
        T* logs = sm + lay.logs();  // the factor's log pivots
        for (int i = lane; i < n; i += WARP) logs[i] = log(mat[ix(i, i)]);
        __syncwarp();
        const T lf = fold_add(logs[0], n - 1, [&](int i) { return logs[1 + i]; });
        logdet_v = T(2) * lf;
    }
    __syncwarp();
    K12_ADD32(4, clk_l);
    return logdet_v;
}

}  // namespace jcap
}  // namespace mcp
