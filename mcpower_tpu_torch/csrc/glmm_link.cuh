// The link functions, deviance terms and cluster row ranges of the GLMM
// fits: kernels K7 (glmm_intercept.cu) and K10 (glmm_slope.cu) include
// this file. Device twins of engine/glmfit.py::_mu_var_dmu and
// _deviance_terms, in the plain versions' operations and order, in the
// scalar type T of the arguments (f32 for the searches, f64 elsewhere).
#pragma once

#include <math.h>

namespace mcp {

constexpr double MU_EPS = 1e-10;
constexpr double INV_SQRT2 = 0.7071067811865476;
constexpr double INV_SQRT_2PI = 0.3989422804014327;
enum { LINK_LOGIT = 0, LINK_PROBIT = 1, LINK_POISSON = 2 };

__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_exp(double x) { return exp(x); }
__device__ __forceinline__ float m_log(float x) { return logf(x); }
__device__ __forceinline__ double m_log(double x) { return log(x); }
__device__ __forceinline__ float m_erf(float x) { return erff(x); }
__device__ __forceinline__ double m_erf(double x) { return erf(x); }

// torch.clamp's one-sided bounds: a NaN stays NaN.
template <typename T>
__device__ __forceinline__ T clamp_lo(T x, T lo) { return x < lo ? lo : x; }
template <typename T>
__device__ __forceinline__ T clamp_hi(T x, T hi) { return x > hi ? hi : x; }

// glmfit.py::_mu_var_dmu in T.
template <typename T>
__device__ __forceinline__ void mu_var_dmu(int link, T eta, T& mu, T& var, T& dmu) {
    const T eps = T(MU_EPS), top = T(1.0 - MU_EPS);
    if (link == LINK_PROBIT) {
        mu = clamp_hi(clamp_lo(T(0.5) * (T(1) + m_erf(eta * T(INV_SQRT2))), eps), top);
        var = mu * (T(1) - mu);
        dmu = clamp_lo(m_exp(T(-0.5) * eta * eta) * T(INV_SQRT_2PI), eps);
    } else if (link == LINK_LOGIT) {
        mu = clamp_hi(clamp_lo(T(1) / (T(1) + m_exp(-eta)), eps), top);
        var = mu * (T(1) - mu);
        dmu = var;
    } else {
        mu = clamp_lo(m_exp(clamp_hi(clamp_lo(eta, T(-30)), T(30))), eps);
        var = mu;
        dmu = mu;
    }
}

// glmfit.py::_deviance_terms in T (one log per binomial row, as K6).
template <typename T>
__device__ __forceinline__ T dev_term(int link, T y, T mu) {
    if (link != LINK_POISSON) {
        const bool pos = y > T(0.5), neg = y < T(0.5);
        const T t = (pos || neg) ? -m_log(pos ? mu : T(1) - mu) : T(0);
        return t + T(0);
    }
    const T ylogy = (y > T(0)) ? y * m_log(clamp_lo(y, T(MU_EPS))) : T(0);
    return ylogy - y * m_log(mu) - (y - mu);
}

// The rows of cluster j below n: first, stride and count, for a launch's
// layout `a` (a.rr round robin, a.m clusters, a.period the cluster size of
// the blocked layout).
struct Rows {
    int first, step, count;
};

template <class A>
__device__ __forceinline__ Rows rows_of(const A& a, int n, int j) {
    Rows r;
    if (a.rr) {
        r.first = j;
        r.step = a.m;
        r.count = n > j ? (n - j + a.m - 1) / a.m : 0;
    } else {
        r.first = j * a.period;
        r.step = 1;
        const int left = n - r.first;
        r.count = left <= 0 ? 0 : (left < a.period ? left : a.period);
    }
    return r;
}

}  // namespace mcp
