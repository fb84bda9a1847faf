// K8 poisson_quantile: the count outcome's Poisson inverse CDF, one thread
// per row.
//
// Replaces: mcpower_tpu/engine/datagen.py::_poisson_quantile (:217) with its
// caller's clamp and rate (:654-665). For each row, from the open uniform u
// of the RESID words and the linear predictor eta (both f32): u clamped at
// 1 - 6e-8, lam = exp(eta); for lam <= 20 the f64 cumulative-PMF walk
// (p_0 = exp(-lam), p_k = p_{k-1} lam / k, y counts the steps whose CDF is
// still below u), at most 200 steps; above 20 the normal approximation
// floor(lam + z sqrt(lam) + 0.5), floored at 0, with z the f32 Acklam ppf of
// u (acklam.cuh, K1's); y = 0 where lam == 0 (eta below about -104).
//
// What bounds it on H100: neither bytes (12 a row) nor operations at the
// flow's rates (lam about 2-12, so about 2-12 f64 steps of a multiply, an
// IEEE division and an add): the walk is a chain of dependent f64 divisions
// whose length differs from lane to lane, so a warp runs as many steps as
// its longest lane. chip_smoke's bound counts the steps this run's rows
// need.
//
// What the design does about it: one thread per row over a grid-stride
// loop, each thread leaving its walk on its own once its CDF reaches u. The
// reference's batch-wide loop never changes a lane after that point (the
// CDF only grows), so the per-lane exit gives its result; the normal arm
// computes the ppf only for the rows that take it.
//
// Built with --fmad=false, as K1: the ppf and the approximation are the
// plain version's operations in its order.

#include "acklam.cuh"
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr float U_TOP = (float)(1.0 - 6e-8);
constexpr float WALK_MAX_LAM = 20.0f;
constexpr int WALK_STEPS = 200;

__global__ void __launch_bounds__(THREADS)
    poisson_quantile_kernel(const float* __restrict__ u, const float* __restrict__ eta,
                            long long n, float* __restrict__ y) {
    for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
         i += (long long)gridDim.x * THREADS) {
        const float uc = u[i] > U_TOP ? U_TOP : u[i];
        const float lam = expf(eta[i]);
        float out;
        if (lam <= WALK_MAX_LAM) {
            const double u64 = (double)uc, lam64 = (double)lam;
            double p = exp(-lam64);
            double cdf = p;
            float steps = 0.0f;
            for (int k = 0; k < WALK_STEPS && cdf < u64; ++k) {
                p = p * lam64 / (double)(k + 1);
                steps = steps + 1.0f;
                cdf = cdf + p;
            }
            out = steps;
        } else {
            const float z = mcp::ppf(uc);
            const float v = floorf(lam + z * sqrtf(lam) + 0.5f);
            out = v < 0.0f ? 0.0f : v;
        }
        y[i] = lam > 0.0f ? out : 0.0f;
    }
}

}  // namespace

// u, eta, y: n f32 values on the device. Returns a cudaError_t.
extern "C" int mcp_poisson_quantile(const void* u, const void* eta, long long n, void* y,
                                    void* stream) {
    if (n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    int dev = 0, sms = 0;
    cudaError_t err;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return (int)err;
    long long blocks = (n + THREADS - 1) / THREADS;
    const long long most = (long long)sms * 16;  // a grid-stride loop beyond this
    if (blocks > most) blocks = most;
    poisson_quantile_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)u, (const float*)eta, n, (float*)y);
    return (int)cudaGetLastError();
}
