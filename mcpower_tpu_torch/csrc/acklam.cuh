// The one-tail f32 Acklam inverse normal CDF, shared by K1 (philox_fill.cu)
// and K8 (poisson_quantile.cu).
//
// Operation for operation mcpower_tpu/engine/rng.py::norm_ppf(p, float32)
// and mcpower_tpu_torch/engine/rng.py::norm_ppf_f32, split into its clamp,
// its two arms and the test between them: every constant is an f32 rounded
// from the reference's double ((float)double, as JAX rounds a weakly typed
// Python float), division and sqrt are IEEE, and a file that includes this
// header is built with --fmad=false so that no multiply-add is contracted.
#pragma once

#include <math.h>

namespace mcp {

constexpr float P_LOW = (float)0.02425;
constexpr float P_HIGH = (float)(1.0 - 0.02425);

__device__ __forceinline__ float ppf_clamp(float p) {
    return fminf(fmaxf(p, (float)1e-38), (float)(1.0 - 6e-8));
}

__device__ __forceinline__ bool ppf_in_tail(float pc) { return (pc < P_LOW) || (pc > P_HIGH); }

__device__ __forceinline__ float ppf_central(float pc) {
    const float A0 = (float)-3.969683028665376e01, A1 = (float)2.209460984245205e02,
                A2 = (float)-2.759285104469687e02, A3 = (float)1.383577518672690e02,
                A4 = (float)-3.066479806614716e01, A5 = (float)2.506628277459239e00;
    const float B0 = (float)-5.447609879822406e01, B1 = (float)1.615858368580409e02,
                B2 = (float)-1.556989798598866e02, B3 = (float)6.680131188771972e01,
                B4 = (float)-1.328068155288572e01;
    const float qq = pc - 0.5f;
    const float r = qq * qq;
    const float num_c = ((((A0 * r + A1) * r + A2) * r + A3) * r + A4) * r + A5;
    const float den_c = (((B0 * r + B1) * r + B2) * r + B3) * r + B4;
    return qq * num_c / (den_c * r + 1.0f);
}

__device__ __forceinline__ float ppf_tail(float pc) {
    const float C0 = (float)-7.784894002430293e-03, C1 = (float)-3.223964580411365e-01,
                C2 = (float)-2.400758277161838e00, C3 = (float)-2.549732539343734e00,
                C4 = (float)4.374664141464968e00, C5 = (float)2.938163982698783e00;
    const float D0 = (float)7.784695709041462e-03, D1 = (float)3.224671290700398e-01,
                D2 = (float)2.445134137142996e00, D3 = (float)3.754408661907416e00;
    const bool lower = pc < 0.5f;
    const float q = lower ? pc : 1.0f - pc;
    const float s = sqrtf(-2.0f * logf(q));
    const float num_t = ((((C0 * s + C1) * s + C2) * s + C3) * s + C4) * s + C5;
    const float den_t = (((D0 * s + D1) * s + D2) * s + D3) * s + 1.0f;
    const float t = num_t / den_t;
    return lower ? t : -t;
}

// The whole ppf of one value: the clamp, then the arm the value falls in.
__device__ __forceinline__ float ppf(float p) {
    const float pc = ppf_clamp(p);
    return ppf_in_tail(pc) ? ppf_tail(pc) : ppf_central(pc);
}

}  // namespace mcp
