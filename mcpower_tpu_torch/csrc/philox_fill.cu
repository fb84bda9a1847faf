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
// What bounds it on H100: instruction issue. The output is 4 bytes a value,
// far below what the card can write; a value costs a quarter of a 10-round
// cipher (two 32x32 -> 64 multiplies a round) and the Acklam rational, whose
// tail arm adds a log, a sqrt and a second IEEE division. Timed by mode at
// the LMM plan (PERF.md), the words and their stores take about 40% of the
// normals' time and the ppf the rest.
//
// What the design does about it (each item removes instructions a thread
// would otherwise issue):
// - one key per sim: a block covers a tile of sims, and one thread per sim
//   derives the key into shared memory before the block's data ciphers (a
//   key per thread would double the cipher work);
// - no 64-bit division: the host splits the launch into tiles of whole sims
//   (grid x) and, for very long streams, parts of a tile (grid y), and a
//   thread's 32-bit (sim, stream, block) position is advanced by a
//   mixed-radix step the host precomputes (FillGeom), so the only divisions
//   are two 32-bit ones when a thread starts;
// - no cipher for padding: a 4-row block at or past ceil(rows / 4) is
//   written as zeros (the LMM plan's 20-row cluster stream pads 45 of its 50
//   blocks);
// - one 16-byte store per 4-row block when max_rows % 4 == 0 (the main
//   path's 200 and 500); other row counts take a scalar-store instantiation.
//   The block's threads walk the tile's flat index, so a warp's stores are
//   512 contiguous bytes whatever the streams' lengths;
// - the central arm of the ppf for every value and the tail arm only for the
//   values past P_LOW / P_HIGH (about 4.85%): a thread loops over its tail
//   values, so a warp runs the tail as often as its worst lane needs it (on
//   average about 1.4 times for 4 x 32 values) instead of four times.
//
// Bit identity with the reference: the file is built with --fmad=false so
// no multiply-add is contracted; every constant is an f32 rounded from the
// reference's double ((float)double, as JAX rounds a weakly typed Python
// float); u32 -> f32 is __uint2float_rn (round to nearest even, as XLA's
// convert); division and sqrt are IEEE (nvcc's -prec-div/-prec-sqrt
// defaults). Each value's operations and their order are the plain
// version's; only which arm is evaluated changed. Only logf may differ from
// XLA:CPU's log by an ULP.

#include <algorithm>

#include "acklam.cuh"
#include "common.cuh"

#define MCP_MAX_STREAMS 32

namespace {

constexpr int FILL_THREADS = 256;
// Items (4-row blocks) a block covers: 4 per thread. Small blocks keep the
// last wave short at the main path's 1-2 M items.
constexpr int FILL_ITEMS = 4 * FILL_THREADS;
constexpr uint32_t TAG = 0xA5A5A5A5u;
constexpr uint32_t CLASS_SIMKEY = 7u;

struct StreamInfo {
    uint32_t cls;
    uint32_t col;
    int rows;
    int nreal;  // ceil(rows / 4): blocks that hold a real row
};

// Launch geometry, fixed by the host. A tile is `tile_sims` whole sims, an
// item one 4-row block; an item's flat index inside its tile is
// (sim_in_tile * n_streams + stream) * nblk + block.
struct FillGeom {
    StreamInfo st[MCP_MAX_STREAMS];
    int n_sims, n_streams, max_rows, nblk;
    int tile_sims;  // sims per tile (grid x); grid y splits a tile into FILL_ITEMS parts
    // FILL_THREADS = step_b + nblk * (step_s + n_streams * step_sim): one
    // stride of the block's threads in (sim, stream, block) digits.
    int step_b, step_s, step_sim;
    uint32_t seed_lo, seed_hi;
};

__device__ __forceinline__ void philox4x32_10(uint32_t& c0, uint32_t& c1, uint32_t& c2,
                                              uint32_t& c3, uint32_t k0, uint32_t k1) {
#pragma unroll
    for (int r = 0; r < 10; ++r) {
        if (r > 0) {
            k0 += 0x9E3779B9u;
            k1 += 0xBB67AE85u;
        }
        const uint64_t p0 = (uint64_t)0xD2511F53u * c0;  // one wide multiply: hi and lo
        const uint64_t p1 = (uint64_t)0xCD9E8D57u * c2;
        const uint32_t n0 = (uint32_t)(p1 >> 32) ^ c1 ^ k0;
        const uint32_t n2 = (uint32_t)(p0 >> 32) ^ c3 ^ k1;
        c0 = n0;
        c1 = (uint32_t)p1;
        c2 = n2;
        c3 = (uint32_t)p0;
    }
}

__device__ __forceinline__ float open_uniform(uint32_t w) {
    return (__uint2float_rn(w) + 0.5f) * (float)(1.0 / 4294967296.0);
}

using mcp::ppf_central;
using mcp::ppf_clamp;
using mcp::ppf_in_tail;
using mcp::ppf_tail;

// The four output words of one 4-row block whose first row is `row0`;
// rows at or past `rows` are 0.
template <int MODE>
__device__ __forceinline__ void block_values(const uint32_t w[4], int row0, int rows,
                                             uint32_t v[4]) {
    if constexpr (MODE == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = w[i];
    } else if constexpr (MODE == 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = __float_as_uint(open_uniform(w[i]));
    } else {
        float pc[4], z[4];
        unsigned tail = 0u;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            pc[i] = ppf_clamp(open_uniform(w[i]));
            z[i] = ppf_central(pc[i]);
            tail |= ppf_in_tail(pc[i]) ? (1u << i) : 0u;
        }
        // Tail values one at a time; selects keep pc and z in registers.
        while (tail) {
            const int i = __ffs(tail) - 1;
            tail &= tail - 1u;
            const float p = i == 0 ? pc[0] : i == 1 ? pc[1] : i == 2 ? pc[2] : pc[3];
            const float t = ppf_tail(p);
            z[0] = i == 0 ? t : z[0];
            z[1] = i == 1 ? t : z[1];
            z[2] = i == 2 ? t : z[2];
            z[3] = i == 3 ? t : z[3];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = __float_as_uint(z[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = (row0 + i < rows) ? v[i] : 0u;
}

// Grid (tiles, parts of a tile). VEC: max_rows % 4 == 0, one uint4 store
// per item; otherwise up to four scalar stores.
template <int MODE, bool VEC>
__global__ void __launch_bounds__(FILL_THREADS)
    philox_fill_kernel(uint32_t* __restrict__ out, const int64_t* __restrict__ sim_ids,
                       const FillGeom geo) {
    __shared__ uint32_t key0[FILL_THREADS], key1[FILL_THREADS];
    __shared__ StreamInfo tab[MCP_MAX_STREAMS];

    const int ns = geo.n_streams, nblk = geo.nblk;
    const int per_sim = ns * nblk;
    const int sim0 = blockIdx.x * geo.tile_sims;
    const int tile = min(geo.tile_sims, geo.n_sims - sim0);
    const int lo = blockIdx.y * FILL_ITEMS;
    const int hi = min(lo + FILL_ITEMS, tile * per_sim);
    if (lo >= hi) return;  // block-uniform
    const int key_lo = (unsigned)lo / per_sim;  // first sim of the tile this block touches
    const int n_keys = (unsigned)(hi - 1) / per_sim - key_lo + 1;
    const int t = threadIdx.x;
    if (t < n_keys) {
        uint32_t k0 = (uint32_t)(sim_ids[sim0 + key_lo + t] & 0xFFFFFFFFLL), k1 = 0u,
                 k2 = CLASS_SIMKEY, k3 = 0u;
        philox4x32_10(k0, k1, k2, k3, geo.seed_lo, geo.seed_hi);
        key0[t] = k0;
        key1[t] = k1;
    }
    if (t < ns) tab[t] = geo.st[t];
    __syncthreads();

    int j = lo + t;
    const unsigned q = (unsigned)j / (unsigned)nblk;
    int b = (int)((unsigned)j - q * (unsigned)nblk);
    int s = (int)(q % (unsigned)ns);
    int sl = (int)(q / (unsigned)ns) - key_lo;  // sim, counted from the first keyed one
    const size_t tile_base = (size_t)sim0 * per_sim;            // in items
    const size_t tile_rows = (size_t)sim0 * ns * geo.max_rows;  // in words
    for (; j < hi; j += FILL_THREADS) {
        const StreamInfo si = tab[s];
        uint32_t v[4] = {0u, 0u, 0u, 0u};
        if (b < si.nreal) {
            uint32_t w[4] = {(uint32_t)b, si.col, si.cls, TAG};
            philox4x32_10(w[0], w[1], w[2], w[3], key0[sl], key1[sl]);
            block_values<MODE>(w, 4 * b, si.rows, v);
        }
        if constexpr (VEC) {
            reinterpret_cast<uint4*>(out)[tile_base + j] = make_uint4(v[0], v[1], v[2], v[3]);
        } else {
            const int row0 = 4 * b;
            uint32_t* dst =
                out + tile_rows + (size_t)(((sl + key_lo) * ns + s) * geo.max_rows + row0);
#pragma unroll
            for (int i = 0; i < 4; ++i)
                if (row0 + i < geo.max_rows) dst[i] = v[i];
        }
        // Advance (sl, s, b) by one stride of the block's threads.
        b += geo.step_b;
        const int cb = b >= nblk;
        b -= cb ? nblk : 0;
        s += geo.step_s + cb;
        const int cs = s >= ns;
        s -= cs ? ns : 0;
        sl += geo.step_sim + cs;
    }
}

template <int MODE>
cudaError_t launch_mode(uint32_t* out, const int64_t* sim_ids, const FillGeom& geo, dim3 grid,
                        cudaStream_t stream) {
    if (geo.max_rows % 4 == 0)
        philox_fill_kernel<MODE, true><<<grid, FILL_THREADS, 0, stream>>>(out, sim_ids, geo);
    else
        philox_fill_kernel<MODE, false><<<grid, FILL_THREADS, 0, stream>>>(out, sim_ids, geo);
    return cudaGetLastError();
}

}  // namespace

// table: n_streams triples (class, column as uint32 bits, rows), host memory.
// mode: 0 raw words, 1 open uniforms, 2 normals. Returns a cudaError_t.
extern "C" int mcp_philox_fill(void* out, const void* sim_ids, int n_sims, uint32_t seed_lo,
                               uint32_t seed_hi, const int* table, int n_streams, int max_rows,
                               int mode, void* stream) {
    if (n_streams <= 0 || n_streams > MCP_MAX_STREAMS || max_rows <= 0 || n_sims <= 0 ||
        mode < 0 || mode > 2)
        return (int)cudaErrorInvalidValue;
    FillGeom geo;
    for (int i = 0; i < n_streams; ++i) {
        const int rows = table[3 * i + 2];
        if (rows <= 0 || rows > max_rows) return (int)cudaErrorInvalidValue;
        geo.st[i] = StreamInfo{(uint32_t)table[3 * i], (uint32_t)table[3 * i + 1], rows,
                               (rows + 3) / 4};
    }
    geo.n_sims = n_sims;
    geo.n_streams = n_streams;
    geo.max_rows = max_rows;
    geo.nblk = (max_rows + 3) / 4;
    const long long per_sim = (long long)n_streams * geo.nblk;
    // A tile's flat index, and a sim's rows, stay in 32 bits.
    if (per_sim * 4 > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    // Whole sims per tile, about FILL_ITEMS items, at most one key per thread.
    geo.tile_sims = (int)std::max(1LL, std::min((long long)FILL_THREADS, FILL_ITEMS / per_sim));
    const long long tile_items = geo.tile_sims * per_sim;
    const long long parts = (tile_items + FILL_ITEMS - 1) / FILL_ITEMS;
    const long long tiles = (n_sims + geo.tile_sims - 1) / geo.tile_sims;
    if (parts > 65535) return (int)cudaErrorInvalidConfiguration;
    geo.step_b = FILL_THREADS % geo.nblk;
    const int q = FILL_THREADS / geo.nblk;
    geo.step_s = q % n_streams;
    geo.step_sim = q / n_streams;
    geo.seed_lo = seed_lo;
    geo.seed_hi = seed_hi;
    const dim3 grid((unsigned)tiles, (unsigned)parts);
    uint32_t* o = (uint32_t*)out;
    const int64_t* ids = (const int64_t*)sim_ids;
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err = mode == 0   ? launch_mode<0>(o, ids, geo, grid, st)
                      : mode == 1 ? launch_mode<1>(o, ids, geo, grid, st)
                                  : launch_mode<2>(o, ids, geo, grid, st);
    return (int)err;
}
