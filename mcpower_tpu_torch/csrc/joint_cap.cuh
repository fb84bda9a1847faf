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
// trailing updates, the rows of a factor column and the (row, column) pairs of
// the solves, with __syncwarp between dependent steps.
#pragma once

#include <math.h>

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
    __host__ __device__ size_t mat() const { return 0; }
    __host__ __device__ size_t rhs() const { return (size_t)n * n; }
    __host__ __device__ size_t kept() const { return rhs() + (size_t)n * r; }
    __host__ __device__ size_t acc() const { return kept() + (size_t)keep * r; }
    __host__ __device__ size_t pmat() const { return acc() + (size_t)r * r; }
    __host__ __device__ size_t pinv() const { return pmat() + (size_t)MAX_P * MAX_P; }
    __host__ __device__ size_t vecs() const { return pinv() + (size_t)MAX_P * MAX_P; }
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

__host__ __device__ inline Layout layout_of(int structured, int M, int m1, int Me, int p) {
    Layout l;
    l.n = structured ? Me : M;
    l.r = p + 1;
    l.keep = structured ? m1 : M;
    l.m1 = structured ? m1 : 0;
    l.e = structured ? Me : 0;
    return l;
}

__device__ __forceinline__ int vech(int i, int j, int q) { return j * q - j * (j - 1) / 2 + (i - j); }

// ---------------------------------------------------------------------------
// Warp-wide factor and solves on an n x n row-major matrix in shared memory
// (smallchol's chol / solve_lower / solve_upper_t below VEC_FROM, chol_vec /
// _forward_vec / _backward_vec from it), in place.
// ---------------------------------------------------------------------------

template <typename T>
__device__ void chol_scalar(T* A, int n, int lane) {
    for (int j = 0; j < n; ++j) {
        const T piv = sqrt(A[j * n + j]);
        const T inv = T(1) / piv;
        __syncwarp();
        if (lane == 0) A[j * n + j] = piv;
        for (int i = j + 1 + lane; i < n; i += WARP) A[i * n + j] = A[i * n + j] * inv;
        __syncwarp();
        for (int i = j + 1 + lane; i < n; i += WARP) {  // the trailing lower triangle
            const T lij = A[i * n + j];
            for (int c = j + 1; c <= i; ++c) A[i * n + c] = A[i * n + c] - lij * A[c * n + j];
        }
        __syncwarp();
    }
}

template <typename T>
__device__ void chol_blocked(T* A, int n, int lane) {
    for (int j0 = 0; j0 < n; j0 += BLOCK) {
        const int j1 = min(j0 + BLOCK, n), bw = j1 - j0;
        // the panel: S = A - (its contraction with the columns before it);
        // lanes take its 8 columns by 4 rows a pass
        const int j = j0 + (lane & (BLOCK - 1));
        if (j0 > 0 && j < j1) {
            for (int i = j0 + lane / BLOCK; i < n; i += WARP / BLOCK) {
                if (j <= i) {
                    T acc = T(0);
                    for (int k = 0; k < j0; ++k) acc = acc + A[i * n + k] * A[j * n + k];
                    A[i * n + j] = A[i * n + j] - acc;
                }
            }
        }
        __syncwarp();
        for (int g = j0; g < j1; ++g) {
            const T piv = sqrt(A[g * n + g]);
            __syncwarp();
            for (int i = g + lane; i < n; i += WARP) A[i * n + g] = A[i * n + g] / piv;
            __syncwarp();
            for (int i = g + 1 + lane; i < n; i += WARP) {  // the rank-1 tail in the panel
                const T lig = A[i * n + g];
                for (int c = g + 1; c < j1 && c <= i; ++c)
                    A[i * n + c] = A[i * n + c] - lig * A[c * n + g];
            }
            __syncwarp();
        }
    }
}

template <typename T>
__device__ void chol_auto(T* A, int n, bool blocked, int lane) {
    if (blocked) chol_blocked(A, n, lane);
    else chol_scalar(A, n, lane);
}

// Solve (L L') X = B in place, B (n, r) row-major.
template <typename T>
__device__ void cho_solve_auto(const T* L, T* B, int n, int r, bool blocked, int lane) {
    if (!blocked) {
        for (int i = 0; i < n; ++i) {  // forward, right-looking
            for (int c = lane; c < r; c += WARP) B[i * r + c] = B[i * r + c] / L[i * n + i];
            __syncwarp();
            for (int k = i + 1 + lane; k < n; k += WARP) {
                const T lki = L[k * n + i];
                for (int c = 0; c < r; ++c) B[k * r + c] = B[k * r + c] - lki * B[i * r + c];
            }
            __syncwarp();
        }
        for (int i = n - 1; i >= 0; --i) {  // backward, the later rows ascending
            for (int c = lane; c < r; c += WARP) {
                T s = B[i * r + c];
                for (int k = i + 1; k < n; ++k) s = s - L[k * n + i] * B[k * r + c];
                B[i * r + c] = s / L[i * n + i];
            }
            __syncwarp();
        }
        return;
    }
    for (int j0 = 0; j0 < n; j0 += BLOCK) {  // forward
        const int j1 = min(j0 + BLOCK, n);
        for (int e = lane; e < (j1 - j0) * r; e += WARP) {
            const int i = j0 + e / r, c = e % r;
            T acc = T(0);
            for (int k = 0; k < j0; ++k) acc = acc + L[i * n + k] * B[k * r + c];
            B[i * r + c] = B[i * r + c] - acc;
        }
        __syncwarp();
        for (int g = j0; g < j1; ++g) {
            for (int c = lane; c < r; c += WARP) B[g * r + c] = B[g * r + c] / L[g * n + g];
            __syncwarp();
            for (int k = g + 1 + lane; k < j1; k += WARP) {
                const T lkg = L[k * n + g];
                for (int c = 0; c < r; ++c) B[k * r + c] = B[k * r + c] - lkg * B[g * r + c];
            }
            __syncwarp();
        }
    }
    const int last = ((n - 1) / BLOCK) * BLOCK;
    for (int j0 = last; j0 >= 0; j0 -= BLOCK) {  // backward
        const int j1 = min(j0 + BLOCK, n);
        for (int e = lane; e < (j1 - j0) * r; e += WARP) {
            const int i = j0 + e / r, c = e % r;
            T acc = T(0);
            for (int k = j1; k < n; ++k) acc = acc + L[k * n + i] * B[k * r + c];
            B[i * r + c] = B[i * r + c] - acc;
        }
        __syncwarp();
        for (int g = j1 - 1; g >= j0; --g) {
            for (int c = lane; c < r; c += WARP) {
                T s = B[g * r + c];
                for (int k = g + 1; k < j1; ++k) s = s - L[k * n + g] * B[k * r + c];
                B[g * r + c] = s / L[g * n + g];
            }
            __syncwarp();
        }
    }
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
template <typename T, class A, class CT, class Src>
__device__ T capacitance(const A& a, const CT& S, const T* th, const Src& c, T* sm,
                         const Layout& lay, bool structured, bool solve, int lane) {
    const int M = a.M, r = lay.r, n = lay.n;
    T* mat = sm + lay.mat();
    T* rhs = sm + lay.rhs();
    T* kept = sm + lay.kept();
    T* acc = sm + lay.acc();
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
        for (int j = lane; j < m1; j += WARP) {  // Cpe = (l1 G_PE) dE, Cpe / a; rp, rp / a
            for (int ee = 0; ee < Me; ++ee) {
                const T v = (l1 * c.z(j, m1 + ee)) * dE[ee];
                cpe[j * Me + ee] = v;
                cpa[j * Me + ee] = v / av[j];
            }
            for (int cc = 0; cc < (solve ? r : 0); ++cc) {
                const T v = l1 * c.raw(j, cc);
                rp[j * r + cc] = v;
                rpa[j * r + cc] = v / av[j];
            }
        }
        for (int ee = lane; ee < (solve ? Me : 0); ee += WARP)
            for (int cc = 0; cc < r; ++cc) re[ee * r + cc] = dE[ee] * c.raw(m1 + ee, cc);
        __syncwarp();
        for (int e1 = lane; e1 < Me; e1 += WARP) {  // S, lower triangle, a row a lane
            for (int e2 = 0; e2 <= e1; ++e2) {
                T s = T(0);
                for (int j = 0; j < m1; ++j) s = s + cpe[j * Me + e1] * cpa[j * Me + e2];
                const T cee = T(e1 == e2 ? 1 : 0) + (dE[e1] * dE[e2]) * c.z(m1 + e1, m1 + e2);
                mat[e1 * n + e2] = cee - s;
            }
        }
        for (int e = lane; e < (solve ? Me * r : 0); e += WARP) {  // t = re - Cpe' (rp / a)
            const int ee = e / r, cc = e % r;
            T s = T(0);
            for (int j = 0; j < m1; ++j) s = s + cpe[j * Me + ee] * rpa[j * r + cc];
            rhs[e] = re[e] - s;
        }
        __syncwarp();
        chol_auto(mat, n, n >= VEC_FROM, lane);
        if (solve) {
            cho_solve_auto(mat, rhs, n, r, n >= VEC_FROM, lane);
            for (int e = lane; e < m1 * r; e += WARP) {  // xp = rp / a - (Cpe xe) / a
                const int j = e / r, cc = e % r;
                T s = T(0);
                for (int ee = 0; ee < Me; ++ee) s = s + cpe[j * Me + ee] * rhs[ee * r + cc];
                kept[e] = rpa[e] - s / av[j];
            }
            __syncwarp();
            for (int e = lane; e < r * r; e += WARP) {  // [rp; re]' [xp; xe]
                const int i = e / r, jj = e % r;
                T s = T(0);
                for (int row = 0; row < m1; ++row) s = s + rp[row * r + i] * kept[row * r + jj];
                for (int ee = 0; ee < Me; ++ee) s = s + re[ee * r + i] * rhs[ee * r + jj];
                acc[e] = s;
            }
        }
        T* logs = sm + lay.logs();  // log a, then the factor's log pivots
        for (int j = lane; j < m1 + n; j += WARP)
            logs[j] = log(j < m1 ? av[j] : mat[(j - m1) * n + (j - m1)]);
        __syncwarp();
        T la = logs[0];
        for (int j = 1; j < m1; ++j) la = la + logs[j];
        T ld = logs[m1];
        for (int i = 1; i < n; ++i) ld = ld + logs[m1 + i];
        logdet_v = la + T(2) * ld;
    } else {
        for (int ia = lane; ia < M; ia += WARP) {  // C = I + Lam' ztz Lam, lower, a row a lane
            for (int ib = 0; ib <= ia; ++ib) {
                const int h = S.cgrp[ib], s2 = S.crr[ib], base = S.cbase[ib];
                T cv = T(0);
                for (int ss = s2; ss < a.comps[h]; ++ss) {
                    const T w = lam_rows(a, S, th, ia, [&](int row) { return c.z(row, base + ss); });
                    const T u = lam_of(a, th, h, ss, s2) * w;
                    cv = (ss == s2) ? u : cv + u;
                }
                mat[ia * n + ib] = T(ia == ib ? 1 : 0) + cv;
            }
            for (int cc = 0; cc < (solve ? r : 0); ++cc) {  // Lam' [zty | ztx]
                const T v = lam_rows(a, S, th, ia, [&](int rr) { return c.raw(rr, cc); });
                kept[ia * r + cc] = v;
                rhs[ia * r + cc] = v;
            }
        }
        __syncwarp();
        chol_blocked(mat, n, lane);
        if (solve) {
            cho_solve_auto(mat, rhs, n, r, true, lane);
            for (int e = lane; e < r * r; e += WARP) {
                const int i = e / r, jj = e % r;
                T s = T(0);
                for (int row = 0; row < M; ++row) s = s + kept[row * r + i] * rhs[row * r + jj];
                acc[e] = s;
            }
        }
        T* logs = sm + lay.logs();  // the factor's log pivots
        for (int i = lane; i < n; i += WARP) logs[i] = log(mat[i * n + i]);
        __syncwarp();
        T ld = logs[0];
        for (int i = 1; i < n; ++i) ld = ld + logs[i];
        logdet_v = T(2) * ld;
    }
    __syncwarp();
    return logdet_v;
}

}  // namespace jcap
}  // namespace mcp
