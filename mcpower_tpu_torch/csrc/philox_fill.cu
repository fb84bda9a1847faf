// K1 philox_fill: counter-addressed Philox4x32-10 stream fill with the f32
// Acklam inverse normal CDF.
//
// Replaces: benchmarks/pallas_datagen.py::make_pallas_fill (the repo's one
// Pallas kernel, pl.pallas_call at :198), which computes
// mcpower_tpu/engine/rng.py::normal_fill bit for bit, and the sim-key
// derivation of mcpower_tpu/engine/batch.py::run_one_sim (:79-86).
//
// What it computes: for each sim s, stream (class, column, rows) and 4-row
// block b, the per-sim key k = philox((sim_id, 0, CLASS_SIMKEY, 0),
// (seed_lo, seed_hi))[:2], then the four words of philox((b, column, class,
// 0xA5A5A5A5), k) for rows 4b..4b+3, written as raw words, open uniforms
// (w + 0.5) * 2^-32, or normals. Output (n_sims, n_streams, max_rows), rows
// past a stream's own length are 0.
//
// What bounds it on H100: integer throughput. A normal costs a quarter of a
// 10-round cipher (two 32x32 multiplies a round) plus one log and sqrt on
// the tail lanes; the output is 4 bytes a value, far below the 3.35 TB/s
// the card can write. One thread per (sim, stream, block) gives ~2M threads
// at the main path's 10,000 sims x 4 streams x 50 blocks, enough to fill
// the 132 SMs.
//
// What the design does about it: native uint32 lanes and __umulhi (the
// Pallas kernel had to run on i32 with a 16-bit-split mulhi), the four
// words of a block written by one thread to neighbouring addresses, and the
// sim key recomputed per thread (one more cipher call, cheaper than a
// second pass through memory in this first version).
//
// Bit identity with the reference: the file is built with --fmad=false so
// no multiply-add is contracted; every constant is an f32 rounded from the
// reference's double ((float)double, as JAX rounds a weakly typed Python
// float); u32 -> f32 is __uint2float_rn (round to nearest even, as XLA's
// convert); division and sqrt are IEEE (nvcc's -prec-div/-prec-sqrt
// defaults). Only logf may differ from XLA:CPU's log by an ULP.

#include "common.cuh"

#define MCP_MAX_STREAMS 32

struct StreamTable {
    int cls[MCP_MAX_STREAMS];
    uint32_t col[MCP_MAX_STREAMS];
    int rows[MCP_MAX_STREAMS];
};

__device__ __forceinline__ void philox4x32_10(uint32_t& c0, uint32_t& c1, uint32_t& c2,
                                              uint32_t& c3, uint32_t k0, uint32_t k1) {
#pragma unroll
    for (int r = 0; r < 10; ++r) {
        if (r > 0) {
            k0 += 0x9E3779B9u;
            k1 += 0xBB67AE85u;
        }
        const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
        const uint32_t lo0 = 0xD2511F53u * c0;
        const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
        const uint32_t lo1 = 0xCD9E8D57u * c2;
        const uint32_t n0 = hi1 ^ c1 ^ k0;
        const uint32_t n2 = hi0 ^ c3 ^ k1;
        c0 = n0;
        c1 = lo1;
        c2 = n2;
        c3 = lo0;
    }
}

__device__ __forceinline__ float open_uniform(uint32_t w) {
    return (__uint2float_rn(w) + 0.5f) * (float)(1.0 / 4294967296.0);
}

// One-tail Acklam ppf in f32, operation for operation as
// mcpower_tpu/engine/rng.py::norm_ppf(p, float32).
__device__ __forceinline__ float acklam_ppf(float p) {
    const float A0 = (float)-3.969683028665376e01, A1 = (float)2.209460984245205e02,
                A2 = (float)-2.759285104469687e02, A3 = (float)1.383577518672690e02,
                A4 = (float)-3.066479806614716e01, A5 = (float)2.506628277459239e00;
    const float B0 = (float)-5.447609879822406e01, B1 = (float)1.615858368580409e02,
                B2 = (float)-1.556989798598866e02, B3 = (float)6.680131188771972e01,
                B4 = (float)-1.328068155288572e01;
    const float C0 = (float)-7.784894002430293e-03, C1 = (float)-3.223964580411365e-01,
                C2 = (float)-2.400758277161838e00, C3 = (float)-2.549732539343734e00,
                C4 = (float)4.374664141464968e00, C5 = (float)2.938163982698783e00;
    const float D0 = (float)7.784695709041462e-03, D1 = (float)3.224671290700398e-01,
                D2 = (float)2.445134137142996e00, D3 = (float)3.754408661907416e00;
    const float P_LOW = (float)0.02425;
    const float P_HIGH = (float)(1.0 - 0.02425);

    const float pc = fminf(fmaxf(p, (float)1e-38), (float)(1.0 - 6e-8));
    const bool lower = pc < 0.5f;
    const float q = lower ? pc : 1.0f - pc;
    const float s = sqrtf(-2.0f * logf(q));
    const float num_t = ((((C0 * s + C1) * s + C2) * s + C3) * s + C4) * s + C5;
    const float den_t = (((D0 * s + D1) * s + D2) * s + D3) * s + 1.0f;
    const float t = num_t / den_t;
    const float tail = lower ? t : -t;
    const float qq = pc - 0.5f;
    const float r = qq * qq;
    const float num_c = ((((A0 * r + A1) * r + A2) * r + A3) * r + A4) * r + A5;
    const float den_c = (((B0 * r + B1) * r + B2) * r + B3) * r + B4;
    const float mid = qq * num_c / (den_c * r + 1.0f);
    const bool in_tail = (pc < P_LOW) || (pc > P_HIGH);
    return in_tail ? tail : mid;
}

__global__ void philox_fill_kernel(uint32_t* __restrict__ out, const int64_t* __restrict__ sim_ids,
                                   int n_sims, uint32_t seed_lo, uint32_t seed_hi,
                                   StreamTable tab, int n_streams, int max_rows, int mode) {
    const int nblk = (max_rows + 3) >> 2;
    const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    const long long total = (long long)n_sims * n_streams * nblk;
    if (tid >= total) return;
    const int blk = (int)(tid % nblk);
    const long long rest = tid / nblk;
    const int st = (int)(rest % n_streams);
    const int sim = (int)(rest / n_streams);

    // Per-sim key: counter (sim_id, 0, CLASS_SIMKEY, 0) under the base seed.
    uint32_t k0 = (uint32_t)(sim_ids[sim] & 0xFFFFFFFFLL), k1 = 0u, k2 = 7u, k3 = 0u;
    philox4x32_10(k0, k1, k2, k3, seed_lo, seed_hi);

    uint32_t w[4] = {(uint32_t)blk, tab.col[st], (uint32_t)tab.cls[st], 0xA5A5A5A5u};
    philox4x32_10(w[0], w[1], w[2], w[3], k0, k1);

    const int rows = tab.rows[st];
    uint32_t* dst = out + ((long long)sim * n_streams + st) * max_rows;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int row = 4 * blk + j;
        if (row < max_rows) {
            uint32_t v = 0u;
            if (row < rows) {
                if (mode == 0) {
                    v = w[j];
                } else {
                    const float u = open_uniform(w[j]);
                    v = __float_as_uint(mode == 1 ? u : acklam_ppf(u));
                }
            }
            dst[row] = v;
        }
    }
}

// table: n_streams triples (class, column as uint32 bits, rows), host memory.
// mode: 0 raw words, 1 open uniforms, 2 normals. Returns a cudaError_t.
extern "C" int mcp_philox_fill(void* out, const void* sim_ids, int n_sims, uint32_t seed_lo,
                               uint32_t seed_hi, const int* table, int n_streams, int max_rows,
                               int mode, void* stream) {
    if (n_streams <= 0 || n_streams > MCP_MAX_STREAMS || max_rows <= 0 || n_sims <= 0 ||
        mode < 0 || mode > 2)
        return (int)cudaErrorInvalidValue;
    StreamTable tab;
    for (int i = 0; i < n_streams; ++i) {
        tab.cls[i] = table[3 * i];
        tab.col[i] = (uint32_t)table[3 * i + 1];
        tab.rows[i] = table[3 * i + 2];
        if (tab.rows[i] <= 0 || tab.rows[i] > max_rows) return (int)cudaErrorInvalidValue;
    }
    const long long total = (long long)n_sims * n_streams * ((max_rows + 3) >> 2);
    const int threads = 256;
    const unsigned blocks = mcp_blocks(total, threads);
    if (blocks == 0) return (int)cudaErrorInvalidConfiguration;
    philox_fill_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (uint32_t*)out, (const int64_t*)sim_ids, n_sims, seed_lo, seed_hi, tab, n_streams,
        max_rows, mode);
    return (int)cudaGetLastError();
}
