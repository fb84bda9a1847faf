// Small dense Cholesky algebra for one thread, p a template constant, in the
// scalar type T of the arguments (f64, or f32 for the GLM's f32 phase).
//
// Device twins of mcpower_tpu_torch/engine/smallchol.py (itself the plain
// form of the reference's scalar unroll, mcpower_tpu/engine/smallchol.py
// :34-349): the same operations in the same order. The factor multiplies
// by the reciprocal pivot; the solves divide by it. Matrices are row-major
// P x P arrays in the calling thread's registers (or local memory once P is
// large); with P a template constant every loop below unrolls and every
// index is static.
//
// Kernels K3 (ols_solve.cu), K4 (reml_intercept.cu), K6 (glm_irls.cu), K7,
// K9 and K10 include this file. K6 keeps only the lower triangle, packed row by row
// (entry (i, j), j <= i, at tri(i, j)), and factors it in place: the
// *_packed functions below, with the same operations in the same order as
// chol, cho_solve and cho_inverse_column_scaled.
#pragma once

#include <math.h>

namespace mcp {

// Lower Cholesky of the lower triangle of A. A zero or negative pivot gives
// inf/nan; callers detect failure through finiteness and rank checks.
template <int P, typename T>
__device__ __forceinline__ void chol(const T* A, T* L) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
        T d = A[j * P + j];
#pragma unroll
        for (int k = 0; k < j; ++k) d = d - L[j * P + k] * L[j * P + k];
        L[j * P + j] = sqrt(d);
        const T inv_d = T(1) / L[j * P + j];
#pragma unroll
        for (int i = j + 1; i < P; ++i) {
            T s = A[i * P + j];
#pragma unroll
            for (int k = 0; k < j; ++k) s = s - L[i * P + k] * L[j * P + k];
            L[i * P + j] = s * inv_d;
        }
#pragma unroll
        for (int i = 0; i < j; ++i) L[i * P + j] = T(0);
    }
}

// Solve L y = b.
template <int P, typename T>
__device__ __forceinline__ void solve_lower(const T* L, const T* b, T* y) {
#pragma unroll
    for (int i = 0; i < P; ++i) {
        T s = b[i];
#pragma unroll
        for (int k = 0; k < i; ++k) s = s - L[i * P + k] * y[k];
        y[i] = s / L[i * P + i];
    }
}

// Solve L^T x = y.
template <int P, typename T>
__device__ __forceinline__ void solve_upper_t(const T* L, const T* y, T* x) {
#pragma unroll
    for (int i = P - 1; i >= 0; --i) {
        T s = y[i];
#pragma unroll
        for (int k = i + 1; k < P; ++k) s = s - L[k * P + i] * x[k];
        x[i] = s / L[i * P + i];
    }
}

// Solve (L L^T) x = b.
template <int P, typename T>
__device__ __forceinline__ void cho_solve(const T* L, const T* b, T* x) {
    T y[P];
    solve_lower<P>(L, b, y);
    solve_upper_t<P>(L, y, x);
}

// Column j of inv = (L L^T)^-1, the solve against e_j; writes
// out[i * P + j] = scale * inv[i][j].
template <int P, typename T>
__device__ __forceinline__ void cho_inverse_column_scaled(const T* L, int j, T scale, T* out) {
    T e[P];
#pragma unroll
    for (int i = 0; i < P; ++i) e[i] = (i == j) ? T(1) : T(0);
    T col[P];
    cho_solve<P>(L, e, col);
#pragma unroll
    for (int i = 0; i < P; ++i) out[i * P + j] = scale * col[i];
}

// Every column of the scaled inverse.
template <int P, typename T>
__device__ __forceinline__ void cho_inverse_scaled(const T* L, T scale, T* out) {
#pragma unroll
    for (int j = 0; j < P; ++j) cho_inverse_column_scaled<P>(L, j, scale, out);
}

// log|A| = 2 sum log diag(L).
template <int P>
__device__ __forceinline__ double logdet_from_chol(const double* L) {
    double s = 0.0;
#pragma unroll
    for (int i = 0; i < P; ++i) s = s + log(L[i * P + i]);
    return 2.0 * s;
}

// Finite positive pivots and min(diag) >= eps_rank * max(diag).
template <int P>
__device__ __forceinline__ bool chol_rank_ok(const double* L, double eps_rank) {
    bool ok = true;
    double lo = L[0], hi = L[0];
#pragma unroll
    for (int i = 0; i < P; ++i) {
        const double d = L[i * P + i];
        ok = ok && isfinite(d) && (d > 0.0);
        lo = fmin(lo, d);
        hi = fmax(hi, d);
    }
    return ok && (lo >= eps_rank * hi);
}

// Index of entry (i, j), j <= i, of a packed lower triangle.
__host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// chol in place on a packed lower triangle: entry (i, j) is read once, then
// overwritten by L[i][j].
template <int P, typename T>
__device__ __forceinline__ void chol_packed(T* a) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
        T d = a[tri(j, j)];
#pragma unroll
        for (int k = 0; k < j; ++k) d = d - a[tri(j, k)] * a[tri(j, k)];
        a[tri(j, j)] = sqrt(d);
        const T inv_d = T(1) / a[tri(j, j)];
#pragma unroll
        for (int i = j + 1; i < P; ++i) {
            T s = a[tri(i, j)];
#pragma unroll
            for (int k = 0; k < j; ++k) s = s - a[tri(i, k)] * a[tri(j, k)];
            a[tri(i, j)] = s * inv_d;
        }
    }
}

// cho_solve with a packed factor.
template <int P, typename T>
__device__ __forceinline__ void cho_solve_packed(const T* L, const T* b, T* x) {
    T y[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
        T s = b[i];
#pragma unroll
        for (int k = 0; k < i; ++k) s = s - L[tri(i, k)] * y[k];
        y[i] = s / L[tri(i, i)];
    }
#pragma unroll
    for (int i = P - 1; i >= 0; --i) {
        T s = y[i];
#pragma unroll
        for (int k = i + 1; k < P; ++k) s = s - L[tri(k, i)] * x[k];
        x[i] = s / L[tri(i, i)];
    }
}

// Column j of (L L^T)^-1 from a packed factor: out[i * P + j] = inv[i][j].
template <int P, typename T>
__device__ __forceinline__ void cho_inverse_column_packed(const T* L, int j, T* out) {
    T e[P], col[P];
#pragma unroll
    for (int i = 0; i < P; ++i) e[i] = (i == j) ? T(1) : T(0);
    cho_solve_packed<P>(L, e, col);
#pragma unroll
    for (int i = 0; i < P; ++i) out[i * P + j] = col[i];
}

// chol_packed and cho_solve_packed for a run-time p <= PM (the p <= 8 and
// p <= 16 buckets of K9 and K10): the same operations in the same order,
// each step guarded by i < p.
template <int PM, typename T>
__device__ __forceinline__ void chol_packed_rt(T* a, int p) {
#pragma unroll
    for (int j = 0; j < PM; ++j) {
        if (j < p) {
            T d = a[tri(j, j)];
#pragma unroll
            for (int k = 0; k < j; ++k) d = d - a[tri(j, k)] * a[tri(j, k)];
            a[tri(j, j)] = sqrt(d);
            const T inv_d = T(1) / a[tri(j, j)];
#pragma unroll
            for (int i = j + 1; i < PM; ++i) {
                if (i < p) {
                    T s = a[tri(i, j)];
#pragma unroll
                    for (int k = 0; k < j; ++k) s = s - a[tri(i, k)] * a[tri(j, k)];
                    a[tri(i, j)] = s * inv_d;
                }
            }
        }
    }
}

template <int PM, typename T>
__device__ __forceinline__ void cho_solve_packed_rt(const T* L, const T* b, T* x, int p) {
    T y[PM];
#pragma unroll
    for (int i = 0; i < PM; ++i) {
        if (i < p) {
            T s = b[i];
#pragma unroll
            for (int k = 0; k < i; ++k) s = s - L[tri(i, k)] * y[k];
            y[i] = s / L[tri(i, i)];
        }
    }
#pragma unroll
    for (int i = PM - 1; i >= 0; --i) {
        if (i < p) {
            T s = y[i];
#pragma unroll
            for (int k = i + 1; k < PM; ++k)
                if (k < p) s = s - L[tri(k, i)] * x[k];
            x[i] = s / L[tri(i, i)];
        }
    }
}

}  // namespace mcp
