// Small dense Cholesky algebra for one thread, f64, p a template constant.
//
// Device twins of mcpower_tpu_torch/engine/smallchol.py (itself the plain
// form of the reference's scalar unroll, mcpower_tpu/engine/smallchol.py
// :34-349): the same operations in the same order. The factor multiplies
// by the reciprocal pivot; the solves divide by it. Matrices are row-major
// P x P arrays in the calling thread's registers (or local memory once P is
// large); with P a template constant every loop below unrolls and every
// index is static.
//
// Kernels K3 (ols_solve.cu) and K4 (reml_intercept.cu) include this file.
#pragma once

#include <math.h>

namespace mcp {

// Lower Cholesky of the lower triangle of A. A zero or negative pivot gives
// inf/nan; callers detect failure through finiteness and rank checks.
template <int P>
__device__ __forceinline__ void chol(const double* A, double* L) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
        double d = A[j * P + j];
#pragma unroll
        for (int k = 0; k < j; ++k) d = d - L[j * P + k] * L[j * P + k];
        L[j * P + j] = sqrt(d);
        const double inv_d = 1.0 / L[j * P + j];
#pragma unroll
        for (int i = j + 1; i < P; ++i) {
            double s = A[i * P + j];
#pragma unroll
            for (int k = 0; k < j; ++k) s = s - L[i * P + k] * L[j * P + k];
            L[i * P + j] = s * inv_d;
        }
#pragma unroll
        for (int i = 0; i < j; ++i) L[i * P + j] = 0.0;
    }
}

// Solve L y = b.
template <int P>
__device__ __forceinline__ void solve_lower(const double* L, const double* b, double* y) {
#pragma unroll
    for (int i = 0; i < P; ++i) {
        double s = b[i];
#pragma unroll
        for (int k = 0; k < i; ++k) s = s - L[i * P + k] * y[k];
        y[i] = s / L[i * P + i];
    }
}

// Solve L^T x = y.
template <int P>
__device__ __forceinline__ void solve_upper_t(const double* L, const double* y, double* x) {
#pragma unroll
    for (int i = P - 1; i >= 0; --i) {
        double s = y[i];
#pragma unroll
        for (int k = i + 1; k < P; ++k) s = s - L[k * P + i] * x[k];
        x[i] = s / L[i * P + i];
    }
}

// Solve (L L^T) x = b.
template <int P>
__device__ __forceinline__ void cho_solve(const double* L, const double* b, double* x) {
    double y[P];
    solve_lower<P>(L, b, y);
    solve_upper_t<P>(L, y, x);
}

// Column j of inv = (L L^T)^-1, the solve against e_j; writes
// out[i * P + j] = scale * inv[i][j].
template <int P>
__device__ __forceinline__ void cho_inverse_column_scaled(const double* L, int j, double scale,
                                                          double* out) {
    double e[P];
#pragma unroll
    for (int i = 0; i < P; ++i) e[i] = (i == j) ? 1.0 : 0.0;
    double col[P];
    cho_solve<P>(L, e, col);
#pragma unroll
    for (int i = 0; i < P; ++i) out[i * P + j] = scale * col[i];
}

// Every column of the scaled inverse.
template <int P>
__device__ __forceinline__ void cho_inverse_scaled(const double* L, double scale, double* out) {
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

}  // namespace mcp
