// K2 grid_suffstats: prefix sufficient statistics over the sample-size grid,
// with the per-cluster sums of the random-intercept fit and, in its slope
// mode, the per-cluster Z moments of the random-slope fit.
//
// Replaces: mcpower_tpu/engine/olsfit.py::grid_suffstats (:41),
// mcpower_tpu/engine/mixedfit.py::_cluster_suffstats (:72),
// mixedfit.py::_slope_cluster_suffstats (:263) and the static
// layout segment sums of mcpower_tpu/engine/clusterops.py (:50-87). For one
// sim, from the f32 design X (max_n, P) restricted to the fit columns and
// the f32 outcome y, in f64: per grid segment [n_{g-1}, n_g) the sums X'X,
// X'y, y'y, sum y, and with a cluster layout the per-cluster row counts n_j,
// column sums s_j and outcome sums t_j (in the slope mode also, for the
// random-effect design z = [1, X[:, zc]], G = sum z z', A = sum z x' and
// b = sum z y per cluster); then the cumulative sum over the
// grid (statistic at g = statistic at g-1 + segment g, as the reference's
// cumsum of per-segment sums).
//
// What bounds it on H100: device memory. Each sim's X and y are read once
// (3.2 KB for the LMM's N = 200, P = 3; 16 KB for the 7-column, N = 500
// curve design) and the statistics written once; at the curve shape that is
// ~197 MB against ~0.19 G f64 multiply-adds, so bytes bound it (~59 us at
// 3.35 TB/s against ~11 us of f64 work). The f64 tensor cores (DMMA) would
// only speed up the part that is not the limit, so the design does not use
// them.
//
// What the design does about it:
// - One warp per block, persistent over groups of four sims (grid = SMs x
//   resident blocks); eight lanes work on each sim of a group. The warp
//   stages its group's X and y rows in shared memory with cp.async (16-byte
//   copies where the layout is 16-byte aligned) into a two-stage ring, so
//   the next group's copy is in flight while this group is summed. Designs
//   too tall for one stage are staged in row chunks, whose length the
//   launcher picks to end on grid points where it can (chunk_rows_for).
// - Work is split over rows, not statistics: each lane takes every 8th row
//   of a grid segment, converts its row to f64 once and accumulates all the
//   statistics its warp owns in registers (for p <= 7 all 37 or fewer; for
//   wider fits the statistics split into groups of at most 40, one warp per
//   group, each staging the sims itself and reading them from L2).
// - Per segment the eight lanes' partial sums combine by a reduce-scatter
//   butterfly of warp shuffles (each level halves what a lane holds), so the
//   combine costs about one shuffle per statistic, shared by the four sims
//   of the warp, in a fixed order: no atomics, the same result on every run.
//   The lane that ends up owning a statistic carries its cumulative sum over
//   the grid.
// - Cluster sums come from the staged rows, one lane per cluster: in the
//   round-robin layout row r belongs to cluster r % m, in the blocked
//   layout to r / cs; a cluster's rows in a segment are a stride or a range,
//   never a gather. Row counts n_j are exact integer counts. The slope mode
//   is its own instantiation (SL), so the sums it adds to a lane (3 + 6 +
//   3 p + 3 at q = 4) cost the other modes no registers.
// - The slope mode's clusters carry about 15 dependent f64 sums a row, so a
//   launch of few sims (a flow's 1,250: 313 groups of four, under three
//   warps an SM) is bound by one lane's walk over its clusters. Where the
//   groups of four are fewer than the resident warps, the slope mode runs
//   one sim a warp (SPW = 1): lanes 0-7 keep the prefix sums as before and
//   all 32 lanes take a cluster each. A cluster's sums stay one lane's walk
//   over its rows in ascending order from the previous piece's sums, so the
//   outputs keep their bits.

#include "common.cuh"

#define MCP_MAX_P 16
#define MCP_MAX_QS 3  // slope columns of the slope mode (q <= 4)

namespace {

constexpr int WARP = 32;
constexpr int SIM_LANES = 8;  // lanes on one sim
constexpr int SIM_LEVELS = 3;  // log2(SIM_LANES)
constexpr int SIMS_PER_WARP = WARP / SIM_LANES;
constexpr int MAX_STATS_PER_WARP = 40;
constexpr int MAX_SMEM_BYTES = 227 * 1024;
// Each sim's share of a stage holds at most this many bytes of X and y rows:
// small stages keep many warps resident.
constexpr int STAGE_BYTES_PER_SIM = 4 * 1024;

struct Layout {
    int fit[MCP_MAX_P];
};

struct Args {
    const float* X;
    const float* y;
    const int* grid;  // (G,) ascending row counts, device memory
    int sims, max_n, P, G, m, round_robin, period, chunk_rows, vec16;
    double *xtx, *xty, *yty, *ysum, *nj, *s, *t;
};

// The slope mode's columns and outputs, a parameter of their own so that
// the other modes' Args and Layout stay as they were.
struct Slopes {
    int qs;  // slope columns; 0 outside the slope mode
    int zc[MCP_MAX_QS];  // their columns of X
    double *G, *A, *b;  // G (m, q, q), A (m, q, pf), b (m, q)
};

__host__ __device__ constexpr int n_global(int pf) { return pf * (pf + 1) / 2 + pf + 2; }

// Warps (statistic groups) per sim group: the fewest, a power of two, that
// keep each warp's share at or below MAX_STATS_PER_WARP.
__host__ __device__ constexpr int n_groups(int pf) {
    int g = 1;
    while ((n_global(pf) + g - 1) / g > MAX_STATS_PER_WARP) g *= 2;
    return g;
}

__host__ __device__ constexpr int per_group(int pf) {
    return (n_global(pf) + n_groups(pf) - 1) / n_groups(pf);
}

// What one lane holds after `levels` halvings of c values.
__host__ __device__ constexpr int halved(int c, int levels) {
    return levels == 0 ? c : halved((c + 1) / 2, levels - 1);
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Shared-memory floats of one sim's X rows and y in a stage.
__host__ __device__ constexpr int x_floats(int rows, int P) { return round4(rows * P); }
__host__ __device__ constexpr int stage_floats(int rows, int P, int spw = SIMS_PER_WARP) {
    return spw * (x_floats(rows, P) + round4(rows));
}

__host__ __device__ constexpr int sim_stage_bytes(int rows, int P) {
    return (int)sizeof(float) * (x_floats(rows, P) + round4(rows));
}

// Rows of X and y staged at a time: all max_n when one sim's rows fit
// STAGE_BYTES_PER_SIM, else a multiple of 4 (so every chunk stays 16-byte
// aligned) between half and all of what fits, chosen to cut the grid
// segments into the fewest pieces (each piece costs one warp reduction),
// the larger on a tie. `grid` is the host copy; a cursor walks it beside
// the chunk boundaries, so a candidate costs O(G + max_n / rows).
int chunk_rows_for(int max_n, int P, const int* grid, int G) {
    if (sim_stage_bytes(max_n, P) <= STAGE_BYTES_PER_SIM) return max_n;
    int most = STAGE_BYTES_PER_SIM / ((int)sizeof(float) * (P + 1)) / 4 * 4;
    while (most > 4 && sim_stage_bytes(most, P) > STAGE_BYTES_PER_SIM) most -= 4;
    most = most > 4 ? most : 4;
    int best = 0, best_pieces = 0;
    for (int rows = (most / 2 / 4 * 4 > 4 ? most / 2 / 4 * 4 : 4); rows <= most; rows += 4) {
        int pieces = 0, g = 0;
        for (int r = rows; r < max_n; r += rows) {
            while (g < G && grid[g] < r) ++g;
            pieces += (g < G && grid[g] == r) ? 0 : 1;
        }
        if (best == 0 || pieces <= best_pieces) {
            best = rows;
            best_pieces = pieces;
        }
    }
    return best;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_wait_prior() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Copy n floats, all lanes of the warp together.
__device__ __forceinline__ void warp_copy(float* dst, const float* src, int n, bool vec16,
                                          int lane) {
    int done = 0;
    if (vec16) {
        const int n4 = n >> 2;
        for (int i = lane; i < n4; i += WARP) cp_async16(dst + 4 * i, src + 4 * i);
        done = n4 << 2;
    }
    for (int i = done + lane; i < n; i += WARP) cp_async4(dst + i, src + i);
}

// Stage rows [r0, r0 + chunk_rows) of the SPW sims of group `group`: slot
// k's X rows at k * x_floats, then every slot's y.
template <int SPW>
__device__ __forceinline__ void stage_chunk(const Args& a, float* stage, long long group, int r0,
                                            int lane) {
    const int rows = min(a.chunk_rows, a.max_n - r0);
    const int xf = x_floats(a.chunk_rows, a.P);
    for (int k = 0; k < SPW; ++k) {
        const long long sim = group * SPW + k;
        if (sim >= a.sims) break;
        warp_copy(stage + k * xf, a.X + (sim * a.max_n + r0) * (long long)a.P, rows * a.P,
                  a.vec16, lane);
        warp_copy(stage + SPW * xf + k * round4(a.chunk_rows),
                  a.y + sim * a.max_n + r0, rows, a.vec16, lane);
    }
}

// Reduce-scatter of C values over each sim's SIM_LANES lanes: at level l a
// lane exchanges half of what it holds with the lane (SIM_LANES / 2) >> l
// away and keeps the sum of the other half. Afterwards a[0 .. own_size) hold
// the sim's sums of the values starting at own_base (see own_range).
template <int N, int C, int LEVEL>
__device__ __forceinline__ void reduce_scatter(double (&a)[N], int sl) {
    if constexpr (LEVEL < SIM_LEVELS) {
        constexpr int H = (C + 1) / 2;
        const bool up = (sl >> (SIM_LEVELS - 1 - LEVEL)) & 1;
#pragma unroll
        for (int i = 0; i < H; ++i) {
            const double lo = a[i];
            const double hi = (i + H < C) ? a[(i + H < C) ? i + H : i] : 0.0;
            const double send = up ? lo : hi;
            const double keep = up ? hi : lo;
            a[i] = keep + __shfl_xor_sync(0xffffffffu, send, (SIM_LANES / 2) >> LEVEL);
        }
        reduce_scatter<N, H, LEVEL + 1>(a, sl);
    }
}

// The values lane `sl` of a sim holds after reduce_scatter of c values:
// indices [base, base + size). A half may reach past its block (2h > c);
// those slots hold zeros and belong to no one.
__device__ __forceinline__ void own_range(int c, int sl, int& base, int& size) {
    base = 0;
    size = c;
    for (int l = 0; l < SIM_LEVELS; ++l) {
        const int h = (c + 1) / 2;
        if ((sl >> (SIM_LEVELS - 1 - l)) & 1) {
            base += h;
            size = max(size - h, 0);
        } else {
            size = min(size, h);
        }
        c = h;
    }
}

// Where global statistic `id` of a cell goes, packed in one int: bits 0-2
// the output (0 none, 1 X'X, 2 X'y, 3 y'y, 4 sum y), bits 3-10 and 11-18 its
// offsets in the cell (X'X is written on both sides of the diagonal).
// Statistics run: cross products (i, j), i <= j, row by row; then X'y; then
// y'y; then sum y. A lane works these out once per task, so finishing a
// segment is only stores.
template <int PF>
__device__ __forceinline__ int target_of(int id) {
    constexpr int n_pair = PF * (PF + 1) / 2;
    if (id < n_pair) {
        int i = 0, rem = id;
        while (rem >= PF - i) {
            rem -= PF - i;
            ++i;
        }
        const int j = i + rem;
        return 1 | ((i * PF + j) << 3) | ((j * PF + i) << 11);
    }
    if (id < n_pair + PF) return 2 | ((id - n_pair) << 3) | ((id - n_pair) << 11);
    return id == n_pair + PF ? 3 : 4;
}

template <int PF>
__device__ __forceinline__ void store(const Args& a, int target, long long cell, double v) {
    const int o1 = (target >> 3) & 0xFF, o2 = (target >> 11) & 0xFF;
    switch (target & 7) {
        case 1:
            a.xtx[cell * PF * PF + o1] = v;
            if (o2 != o1) a.xtx[cell * PF * PF + o2] = v;
            break;
        case 2: a.xty[cell * PF + o1] = v; break;
        case 3: a.yty[cell] = v; break;
        case 4: a.ysum[cell] = v; break;
        default: break;
    }
}

// Cluster sums of rows [r, e) (inside the staged chunk starting at r0) for
// grid cell `cell`, lane `cl` of the CLL lanes on the sim taking clusters
// cl, cl + CLL, ...;
// `first` marks the segment's first piece, which starts from the previous
// grid point's sums (or zero at g = 0).
//
// In the slope mode (SL) the same walk also sums, with z_k = X[row, zc[k]],
// z_k, z_k z_l (l >= k), z_k x and z_k y, and writes the cluster's G, A, b
// (G[0][0] = n_j, A[0] = s_j, b[0] = t_j; G symmetric).
template <int PF, bool SL, int CLL>
__device__ __forceinline__ void cluster_piece(const Args& a, const Layout& lay, const Slopes& z,
                                              const float* Xs,
                                              const float* ys, int r0, int r, int e,
                                              long long cell, bool first, bool has_prev,
                                              int cl) {
    constexpr int QS = SL ? MCP_MAX_QS : 1;
    for (int c = cl; c < a.m; c += CLL) {
        int lo, hi, step;
        if (a.round_robin) {
            lo = r + ((c - r % a.period) % a.period + a.period) % a.period;
            hi = e;
            step = a.period;
        } else {
            lo = max(r, c * a.period);
            hi = min(e, (c + 1) * a.period);
            step = 1;
        }
        double sx[PF], st = 0.0;
        double zs[QS], zy[QS], zz[QS][QS], zx[QS][PF];
#pragma unroll
        for (int k = 0; k < PF; ++k) sx[k] = 0.0;
        if constexpr (SL) {
#pragma unroll
            for (int k = 0; k < QS; ++k) {
                zs[k] = zy[k] = 0.0;
#pragma unroll
                for (int l = 0; l < QS; ++l) zz[k][l] = 0.0;
#pragma unroll
                for (int j = 0; j < PF; ++j) zx[k][j] = 0.0;
            }
        }
        int count = 0;
        for (int row = lo; row < hi; row += step) {
            const float* xr = Xs + (row - r0) * a.P;
#pragma unroll
            for (int k = 0; k < PF; ++k) sx[k] += (double)xr[lay.fit[k]];
            st += (double)ys[row - r0];
            if constexpr (SL) {
                const double yv = (double)ys[row - r0];
#pragma unroll
                for (int k = 0; k < QS; ++k) {
                    if (k < z.qs) {
                        const double zk = (double)xr[z.zc[k]];
                        zs[k] += zk;
                        zy[k] += zk * yv;
#pragma unroll
                        for (int l = k; l < QS; ++l)
                            if (l < z.qs) zz[k][l] += zk * (double)xr[z.zc[l]];
#pragma unroll
                        for (int j = 0; j < PF; ++j) zx[k][j] += zk * (double)xr[lay.fit[j]];
                    }
                }
            }
            ++count;
        }
        const long long o = cell * a.m + c;
        const long long base = first ? (has_prev ? o - a.m : -1) : o;
        a.nj[o] = (base >= 0 ? a.nj[base] : 0.0) + (double)count;
        a.t[o] = (base >= 0 ? a.t[base] : 0.0) + st;
#pragma unroll
        for (int k = 0; k < PF; ++k) a.s[o * PF + k] = (base >= 0 ? a.s[base * PF + k] : 0.0) + sx[k];
        if constexpr (SL) {
            const int q = z.qs + 1;
            double* G = z.G + o * q * q;
            double* A = z.A + o * q * PF;
            double* b = z.b + o * q;
            const double* Gb = base >= 0 ? z.G + base * q * q : nullptr;
            const double* Ab = base >= 0 ? z.A + base * q * PF : nullptr;
            const double* bb = base >= 0 ? z.b + base * q : nullptr;
            G[0] = (Gb ? Gb[0] : 0.0) + (double)count;
            b[0] = (bb ? bb[0] : 0.0) + st;
#pragma unroll
            for (int j = 0; j < PF; ++j) A[j] = (Ab ? Ab[j] : 0.0) + sx[j];
#pragma unroll
            for (int k = 0; k < QS; ++k) {
                if (k < z.qs) {
                    const int r = 1 + k;
                    const double g0 = (Gb ? Gb[r] : 0.0) + zs[k];
                    G[r] = g0;
                    G[r * q] = g0;
#pragma unroll
                    for (int l = k; l < QS; ++l) {
                        if (l < z.qs) {
                            const double v = (Gb ? Gb[r * q + 1 + l] : 0.0) + zz[k][l];
                            G[r * q + 1 + l] = v;
                            G[(1 + l) * q + r] = v;
                        }
                    }
#pragma unroll
                    for (int j = 0; j < PF; ++j) A[r * PF + j] = (Ab ? Ab[r * PF + j] : 0.0) + zx[k][j];
                    b[r] = (bb ? bb[r] : 0.0) + zy[k];
                }
            }
        }
    }
}

// SPW sims a warp: SIMS_PER_WARP, or (the slope mode's wide form, for
// launches of fewer sim groups than resident warps) one sim, its rows on
// lanes 0-7 as before and its clusters on all 32 lanes (CLL).
template <int PF, bool SL, int SPW = SIMS_PER_WARP>
__global__ void __launch_bounds__(WARP) grid_suffstats_kernel(const Args a, const Layout lay,
                                                               const Slopes z) {
    constexpr int NG = n_groups(PF);
    constexpr int K = per_group(PF);
    constexpr int NGLOB = n_global(PF);
    constexpr int OWN = halved(K, SIM_LEVELS);
    constexpr int CLL = SPW == 1 ? WARP : SIM_LANES;
    extern __shared__ __align__(16) float smem[];
    const int lane = threadIdx.x;
    const int slot = lane / SIM_LANES;  // this lane's sim within the group
    const int sl = lane % SIM_LANES;
    const int sslot = SPW == 1 ? 0 : slot;  // the staged sim this lane reads
    const int cl = SPW == 1 ? lane : sl;    // this lane among the sim's cluster lanes
    const int xf = x_floats(a.chunk_rows, a.P);
    const int sf = stage_floats(a.chunk_rows, a.P, SPW);
    // The grid, staged once behind the two stages; the row cursor below
    // walks it (gi), so G has no bound but shared memory.
    int* grid = reinterpret_cast<int*>(smem + 2 * sf);
    for (int i = lane; i < a.G; i += WARP) grid[i] = a.grid[i];
    __syncwarp();
    const int n_chunks = (a.max_n + a.chunk_rows - 1) / a.chunk_rows;
    const long long n_tasks =
        (((long long)a.sims + SPW - 1) / SPW) * NG;
    int base, own_size;
    own_range(K, sl, base, own_size);

    int buf = 0;
    long long task = blockIdx.x;
    if (task < n_tasks) stage_chunk<SPW>(a, smem, task / NG, 0, lane);
    cp_commit();
    for (; task < n_tasks; task += gridDim.x) {
        const long long sim = (task / NG) * SPW + sslot;
        // the last group may be short; with one sim a warp only lanes 0-7
        // hold its rows, all 32 its clusters (both tests fold at compile
        // time, so the four-sim form compiles as if SPW were not there)
        const bool valid = (SPW == SIMS_PER_WARP || slot < SPW) && sim < a.sims;
        const int g = (NG == 1) ? 0 : (int)(task % NG);
        const bool clusters = (SPW == SIMS_PER_WARP ? valid : sim < a.sims) && a.m > 0 && g == 0;
        double cum[OWN], seg[OWN];
        int target[OWN];
#pragma unroll
        for (int q = 0; q < OWN; ++q) {
            cum[q] = seg[q] = 0.0;
            const int id = g * K + base + q;
            target[q] = (valid && q < own_size && id < NGLOB) ? target_of<PF>(id) : 0;
        }

        int gi = 0;  // current grid segment [seg_lo, grid[gi])
        int seg_lo = 0;
        // A segment is finished: add it to the running sums and write the
        // cell; an empty segment repeats the previous grid point.
        auto finish = [&](bool empty) {
            const long long cell = sim * a.G + gi;
#pragma unroll
            for (int q = 0; q < OWN; ++q) {
                cum[q] += seg[q];
                seg[q] = 0.0;
                store<PF>(a, target[q], cell, cum[q]);
            }
            if (clusters && empty)
                cluster_piece<PF, SL, CLL>(a, lay, z, nullptr, nullptr, 0, 0, 0, cell, true,
                                           gi > 0, cl);
            seg_lo = grid[gi];
            ++gi;
        };
        while (gi < a.G && grid[gi] == 0) finish(true);

        for (int k = 0; k < n_chunks; ++k) {
            // prefetch the warp's next chunk (this group's, or its next group's)
            long long next_task = task;
            int next_k = k + 1;
            if (next_k == n_chunks) {
                next_task = task + gridDim.x;
                next_k = 0;
            }
            if (next_task < n_tasks)
                stage_chunk<SPW>(a, smem + (buf ^ 1) * sf, next_task / NG, next_k * a.chunk_rows,
                                 lane);
            cp_commit();
            cp_wait_prior();
            __syncwarp();

            const float* Xs = smem + buf * sf + sslot * xf;
            const float* ys = smem + buf * sf + SPW * xf + sslot * round4(a.chunk_rows);
            const int r0 = k * a.chunk_rows;
            const int r1 = min(a.max_n, r0 + a.chunk_rows);
            int r = r0;
            while (r < r1 && gi < a.G) {
                const int n = grid[gi];
                const int e = min(n, r1);
                double acc[K];
#pragma unroll
                for (int i = 0; i < K; ++i) acc[i] = 0.0;
                for (int row = r + sl; valid && row < e; row += SIM_LANES) {
                    const float* xr = Xs + (row - r0) * a.P;
                    double v[PF + 1];
#pragma unroll
                    for (int i = 0; i < PF; ++i) v[i] = (double)xr[lay.fit[i]];
                    v[PF] = (double)ys[row - r0];
                    int sid = 0;  // static after unrolling
#pragma unroll
                    for (int i = 0; i < PF; ++i) {
#pragma unroll
                        for (int j = i; j < PF; ++j) {
                            if (sid / K == g) acc[sid % K] += v[i] * v[j];
                            ++sid;
                        }
                    }
#pragma unroll
                    for (int i = 0; i < PF; ++i) {
                        if (sid / K == g) acc[sid % K] += v[i] * v[PF];
                        ++sid;
                    }
                    if (sid / K == g) acc[sid % K] += v[PF] * v[PF];
                    ++sid;
                    if (sid / K == g) acc[sid % K] += v[PF];
                }
                reduce_scatter<K, K, 0>(acc, sl);
#pragma unroll
                for (int q = 0; q < OWN; ++q) seg[q] += acc[q];
                if (clusters)
                    cluster_piece<PF, SL, CLL>(a, lay, z, Xs, ys, r0, r, e, sim * a.G + gi,
                                               r == seg_lo, gi > 0, cl);
                r = e;
                if (r == n) {
                    finish(false);
                    while (gi < a.G && grid[gi] == seg_lo) finish(true);
                }
            }
            __syncwarp();  // every lane is done with this stage before it is refilled
            buf ^= 1;
        }
    }
}

// Shared bytes a block and resident blocks an SM of
// grid_suffstats_kernel<PF, SL, SPW> (its shared-memory attribute set), and
// the SMs. The runtime is asked once for each (shared bytes, device) the
// kernel meets in turn (the last kept), not every launch.
template <int PF, bool SL, int SPW>
int residency(const Args& a, size_t* smem, int* per_sm, int* sms) {
    static size_t memo_smem = ~(size_t)0;
    static int memo_dev = -1, memo_per_sm = 0, memo_sms = 0;
    *smem = 2 * sizeof(float) * (size_t)stage_floats(a.chunk_rows, a.P, SPW) +
            sizeof(int) * (size_t)a.G;
    if (*smem > (size_t)MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (memo_smem != *smem || memo_dev != dev) {
        auto kernel = grid_suffstats_kernel<PF, SL, SPW>;
        int n_sms = 0, n_per_sm = 0;
        if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)*smem)) != cudaSuccess ||
            (err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev)) !=
                cudaSuccess ||
            (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n_per_sm, kernel, WARP,
                                                                 *smem)) != cudaSuccess)
            return (int)err;
        memo_smem = *smem;
        memo_dev = dev;
        memo_per_sm = n_per_sm;
        memo_sms = n_sms;
    }
    *per_sm = memo_per_sm;
    *sms = memo_sms;
    return *per_sm > 0 ? 0 : (int)cudaErrorInvalidConfiguration;
}

template <int PF, bool SL, int SPW>
int launch_spw(const Args& a, const Layout& lay, const Slopes& z, size_t smem, int per_sm,
               int sms, cudaStream_t stream) {
    const long long tasks = (((long long)a.sims + SPW - 1) / SPW) * n_groups(PF);
    const long long resident = (long long)sms * per_sm;
    const unsigned blocks = (unsigned)(tasks < resident ? tasks : resident);
    grid_suffstats_kernel<PF, SL, SPW><<<blocks, WARP, smem, stream>>>(a, lay, z);
    return (int)cudaGetLastError();
}

// The slope mode takes one sim a warp where the launch has fewer sim groups
// than resident warps (the same sums, the same bits); the other modes four.
template <int PF, bool SL>
int launch_mode(const Args& a, const Layout& lay, const Slopes& z, cudaStream_t stream) {
    size_t smem = 0;
    int per_sm = 0, sms = 0, err;
    if ((err = residency<PF, SL, SIMS_PER_WARP>(a, &smem, &per_sm, &sms))) return err;
    const long long tasks =
        (((long long)a.sims + SIMS_PER_WARP - 1) / SIMS_PER_WARP) * n_groups(PF);
    if constexpr (SL) {
        if (tasks < (long long)sms * per_sm) {
            if ((err = residency<PF, SL, 1>(a, &smem, &per_sm, &sms))) return err;
            return launch_spw<PF, SL, 1>(a, lay, z, smem, per_sm, sms, stream);
        }
    }
    return launch_spw<PF, SL, SIMS_PER_WARP>(a, lay, z, smem, per_sm, sms, stream);
}

template <int PF>
int launch(const Args& a, const Layout& lay, const Slopes& z, cudaStream_t stream) {
    return z.qs > 0 ? launch_mode<PF, true>(a, lay, z, stream)
                    : launch_mode<PF, false>(a, lay, z, stream);
}

}  // namespace

// fit: pf column indices of X (host memory); grid: G ascending row counts
// (last == max_n), in host memory for the checks and the chunk choice and
// in device memory (grid_dev, the same values) for the kernel. m = 0
// computes no cluster statistics (nj, s, t may then be null). qs > 0 (the
// slope mode, with m > 0) also writes G, A and b of the q = qs + 1 columns
// [1, X[:, zc]] (zc: qs column indices of X, host memory). Returns a
// cudaError_t.
extern "C" int mcp_grid_suffstats(const void* X, const void* y, int sims, int max_n, int P,
                                  const int* fit, int pf, const int* grid, const void* grid_dev,
                                  int G, int m, int round_robin, int period, void* xtx, void* xty,
                                  void* yty, void* ysum, void* nj, void* s, void* t,
                                  const int* zc, int qs, void* zG, void* zA, void* zb,
                                  void* stream) {
    if (sims <= 0 || max_n <= 0 || P <= 0 || pf <= 0 || pf > MCP_MAX_P || G <= 0 ||
        grid_dev == nullptr || m < 0 || period <= 0 ||
        (m > 0 && (nj == nullptr || s == nullptr || t == nullptr)) || qs < 0 ||
        qs > MCP_MAX_QS ||
        (qs > 0 && (m == 0 || zc == nullptr || zG == nullptr || zA == nullptr || zb == nullptr)))
        return (int)cudaErrorInvalidValue;
    Layout lay;
    for (int i = 0; i < pf; ++i) {
        if (fit[i] < 0 || fit[i] >= P) return (int)cudaErrorInvalidValue;
        lay.fit[i] = fit[i];
    }
    Slopes z;
    z.qs = qs;
    for (int k = 0; k < MCP_MAX_QS; ++k) {
        if (k < qs && (zc[k] < 0 || zc[k] >= P)) return (int)cudaErrorInvalidValue;
        z.zc[k] = k < qs ? zc[k] : 0;
    }
    z.G = (double*)zG;
    z.A = (double*)zA;
    z.b = (double*)zb;
    for (int g = 0; g < G; ++g)
        if (grid[g] < (g ? grid[g - 1] : 0) || grid[g] > max_n) return (int)cudaErrorInvalidValue;
    if (grid[G - 1] != max_n) return (int)cudaErrorInvalidValue;
    Args a;
    a.X = (const float*)X;
    a.y = (const float*)y;
    a.grid = (const int*)grid_dev;
    a.sims = sims;
    a.max_n = max_n;
    a.P = P;
    a.G = G;
    a.m = m;
    a.round_robin = round_robin;
    a.period = period;
    a.chunk_rows = chunk_rows_for(max_n, P, grid, G);
    a.vec16 = ((uintptr_t)X % 16 == 0) && ((uintptr_t)y % 16 == 0) && (max_n * P) % 4 == 0 &&
              max_n % 4 == 0;
    a.xtx = (double*)xtx;
    a.xty = (double*)xty;
    a.yty = (double*)yty;
    a.ysum = (double*)ysum;
    a.nj = (double*)nj;
    a.s = (double*)s;
    a.t = (double*)t;
    MCP_DISPATCH_P(pf, launch, a, lay, z, (cudaStream_t)stream)
}

// ---------------------------------------------------------------------------
// The joint mode: the joint-Z statistics of extra groupings.
//
// Replaces: mcpower_tpu/engine/mixedfit.py::_joint_suffstats (:570) with
// _build_joint_z (:511). The joint Z has M = sum_g m_g q_g columns: grouping
// g (the primary first) owns columns off_g + level * q_g + r, where a row at
// level l_g(i) holds 1 (r = 0) or X[i, slope column r - 1]. Per grid prefix,
// in f64: ztz = Z'Z (M, M), ztx = Z'X_fit (M, p), zty = Z'y (M); xtx, xty,
// yty come from the launch of the main entry beside this one.
//
// No dense Z: each row touches Q = sum_g q_g columns, so it adds Q^2 entries
// to ztz, Q p to ztx and Q to zty. An entry's additions come from one
// stream (the pair of components it joins: (a, b) for ztz, (a, k) for ztx,
// a for zty) and from the rows at one level of component a (its column
// fixes that level), so an entry's sum is the rows of that level in
// ascending order, segment by grid segment. Counts (products of ones) are
// exact; the X sums agree with the plain version (scatter_add over the
// rows) to rounding.
//
// What bounds it on the H100: device memory in principle (each sim's X and
// y read once, M^2 + M p + M doubles written a grid point), but the sums
// are dependent chains: an entry takes its rows one after another.
//
// What the design does about it:
// - A block is persistent over sims and holds one sim's ztz, ztx and zty in
//   shared memory. Rows come in windows (the whole design where it fits, so
//   almost always one): a window's level ids are staged, and each grouping's
//   rows sorted by level, once a block where there is one window (for each
//   window of each sim otherwise), stably (a counting sort: a
//   count per level, a scan, then a warp a grouping places 32 rows at a time
//   by __match_any_sync ranks), into per-level row lists.
// - A sim's window of X and y is staged with coalesced copies; the block's
//   threads take work items (column ia of Z, partner), the partner a
//   component b (ztz), a fit column k (ztx) or y (zty), and walk the rows of
//   ia's level in the list, in ascending order: M (Q + p + 1) short chains
//   in place of Q^2 + Q p + Q chains over every row. Threads of one column
//   read the same rows (broadcasts).
// - An entry whose column is fixed by the item (ztx, zty, and ztz where b is
//   in a's grouping, so at a's level) is summed in a register from the
//   prefix before the segment and stored once; ztz entries of another
//   grouping's level are added in shared memory. Either way each entry
//   receives the same additions in the same order as a walk over every row.
// - After each grid segment the block writes its running sums out.
// ---------------------------------------------------------------------------

namespace {

constexpr int JOINT_MAX_GROUPS = 4;
constexpr int JOINT_MAX_Q = 16;  // components over all groupings
constexpr int JOINT_MAX_M = 128;
constexpr int JOINT_THREADS = 128;
constexpr unsigned JOINT_FULL = 0xffffffffu;

struct JointArgs {
    const float* X;
    const float* y;
    const int* grid;  // (G,) device
    const int* ids;   // (groups, max_n) device
    int sims, max_n, P, G, pf, M, Q, groups, levels_all;
    int window;  // rows staged a window
    int fit[MCP_MAX_P];
    // per component a: its grouping's column offset, q_g, r, the X column of
    // its value (-1: the intercept's 1) and its grouping
    int off[JOINT_MAX_Q], qg[JOINT_MAX_Q], r[JOINT_MAX_Q], xcol[JOINT_MAX_Q], grp[JOINT_MAX_Q];
    // per grouping: its levels, its first level among all groupings' and its
    // first component
    int m[JOINT_MAX_GROUPS], lev0[JOINT_MAX_GROUPS], comp0[JOINT_MAX_GROUPS];
    double *ztz, *ztx, *zty;
};

// Shared memory of the joint kernel, in bytes from its start.
struct JointSmem {
    size_t zz, xs, ids, rows, lstart, cur, end, total;
};

__host__ __device__ inline JointSmem joint_smem_of(int M, int pf, int P, int groups,
                                                   int levels_all, int window) {
    JointSmem s;
    s.zz = 0;
    s.xs = s.zz + sizeof(double) * ((size_t)M * M + (size_t)M * pf + M);
    s.ids = s.xs + sizeof(float) * (size_t)window * (P + 1);
    s.rows = s.ids + sizeof(int) * (size_t)groups * window;
    s.lstart = s.rows + sizeof(int) * (size_t)groups * window;
    s.cur = s.lstart + sizeof(int) * (size_t)(levels_all + groups);
    s.end = s.cur + sizeof(int) * (size_t)levels_all;
    s.total = s.end + sizeof(int) * (size_t)levels_all;
    return s;
}

// The window's level ids and each grouping's rows by level, stably sorted:
// lstart[lev0[g] + g + L] is level L's first position in grouping g's list.
__device__ void joint_sort_window(const JointArgs& a, int w0, int wn, int* ids_s, int* rows_s,
                                  int* lstart, int* fill) {
    const int t = threadIdx.x, nt = blockDim.x;
    for (int e = t; e < a.groups * wn; e += nt) {
        const int g = e / wn, i = e % wn;
        ids_s[g * a.window + i] = a.ids[(long long)g * a.max_n + w0 + i];
    }
    for (int e = t; e < a.levels_all; e += nt) fill[e] = 0;
    __syncthreads();
    for (int e = t; e < a.groups * wn; e += nt) {
        const int g = e / wn, i = e % wn;
        atomicAdd(&fill[a.lev0[g] + ids_s[g * a.window + i]], 1);
    }
    __syncthreads();
    if (t < a.groups) {  // exclusive scan of the counts, a grouping a thread
        int acc = 0;
        for (int L = 0; L < a.m[t]; ++L) {
            const int c = fill[a.lev0[t] + L];
            lstart[a.lev0[t] + t + L] = acc;
            fill[a.lev0[t] + L] = acc;
            acc += c;
        }
        lstart[a.lev0[t] + t + a.m[t]] = acc;
    }
    __syncthreads();
    const int warp = t / 32, lane = t % 32;
    const unsigned below = (1u << lane) - 1u;
    for (int g = warp; g < a.groups; g += nt / 32) {  // place 32 rows at a time, ranks in order
        for (int base = 0; base < wn; base += 32) {
            const int i = base + lane;
            const int lv = i < wn ? ids_s[g * a.window + i] : -1;
            const unsigned same = __match_any_sync(JOINT_FULL, lv);
            int pos = 0;
            if (lv >= 0) pos = fill[a.lev0[g] + lv] + __popc(same & below);
            __syncwarp();
            if (lv >= 0) {
                rows_s[g * a.window + pos] = i;
                if (lane == 31 - __clz(same)) fill[a.lev0[g] + lv] = pos + 1;
            }
            __syncwarp();
        }
    }
    __syncthreads();
}

__global__ void __launch_bounds__(JOINT_THREADS) grid_suffstats_joint_kernel(const JointArgs a) {
    extern __shared__ __align__(16) unsigned char joint_raw[];
    const int M = a.M, Q = a.Q, p = a.pf, P = a.P, W = a.Q + a.pf + 1;
    const JointSmem sl = joint_smem_of(M, p, P, a.groups, a.levels_all, a.window);
    double* zz = reinterpret_cast<double*>(joint_raw + sl.zz);
    double* zx = zz + (size_t)M * M;
    double* zy = zx + (size_t)M * p;
    float* xs = reinterpret_cast<float*>(joint_raw + sl.xs);  // window x (P + 1): X, then y
    int* ids_s = reinterpret_cast<int*>(joint_raw + sl.ids);
    int* rows_s = reinterpret_cast<int*>(joint_raw + sl.rows);
    int* lstart = reinterpret_cast<int*>(joint_raw + sl.lstart);
    int* cur = reinterpret_cast<int*>(joint_raw + sl.cur);
    int* end = reinterpret_cast<int*>(joint_raw + sl.end);
    const int t = threadIdx.x, nt = blockDim.x;
    const int total = M * M + M * p + M, items = M * W;
    int staged = -1;  // the window whose ids and lists are in shared memory
    for (long long sim = blockIdx.x; sim < a.sims; sim += gridDim.x) {
        const float* Xs = a.X + sim * a.max_n * P;
        const float* ys = a.y + sim * a.max_n;
        for (int e = t; e < total; e += nt) zz[e] = 0.0;
        int win = -1, w0 = 0, wn = 0, prev = 0;
        for (int g = 0; g < a.G; ++g) {
            const int n = a.grid[g];
            while (prev < n) {
                const int k = prev / a.window;
                if (k != win) {  // stage window k: its lists (once where one window), X and y
                    __syncthreads();
                    win = k;
                    w0 = k * a.window;
                    wn = min(a.window, a.max_n - w0);
                    if (staged != k) {
                        joint_sort_window(a, w0, wn, ids_s, rows_s, lstart, cur);
                        staged = k;
                    }
                    const float* xw = Xs + (long long)w0 * P;
                    for (int e = t; e < wn * P; e += nt) xs[(e / P) * (P + 1) + e % P] = xw[e];
                    for (int i = t; i < wn; i += nt) xs[i * (P + 1) + P] = ys[w0 + i];
                    for (int gg = 0; gg < a.groups; ++gg)
                        for (int L = t; L < a.m[gg]; L += nt)
                            cur[a.lev0[gg] + L] = lstart[a.lev0[gg] + gg + L];
                    __syncthreads();
                }
                const int b = min(n, w0 + wn) - w0;  // rows [prev, w0 + b) of this window
                for (int gg = 0; gg < a.groups; ++gg) {
                    for (int L = t; L < a.m[gg]; L += nt) {
                        const int lim = lstart[a.lev0[gg] + gg + L + 1];
                        int e = cur[a.lev0[gg] + L];
                        while (e < lim && rows_s[gg * a.window + e] < b) ++e;
                        end[a.lev0[gg] + L] = e;
                    }
                }
                __syncthreads();
                for (int it = t; it < items; it += nt) {
                    const int ia = it / W, part = it % W;
                    int ga = 0;
                    while (ga + 1 < a.groups && ia >= a.off[a.comp0[ga + 1]]) ++ga;
                    const int rel = ia - a.off[a.comp0[ga]], qa = a.qg[a.comp0[ga]];
                    const int L = rel / qa, ca = a.comp0[ga] + rel % qa;
                    const int xa = a.xcol[ca];
                    const int* lst = rows_s + ga * a.window;
                    const int e0 = cur[a.lev0[ga] + L], e1 = end[a.lev0[ga] + L];
                    if (part < Q) {  // ztz, partner component cb
                        const int cb = part, xb = a.xcol[cb];
                        if (a.grp[cb] == ga) {  // b at a's level: one entry
                            double* dst = zz + (size_t)ia * M + a.off[cb] + L * a.qg[cb] + a.r[cb];
                            double acc = *dst;
                            for (int e = e0; e < e1; ++e) {
                                const float* row = xs + lst[e] * (P + 1);
                                const double va = xa < 0 ? 1.0 : (double)row[xa];
                                const double vb = xb < 0 ? 1.0 : (double)row[xb];
                                acc += va * vb;
                            }
                            *dst = acc;
                        } else {  // b's level varies with the row
                            const int* idb = ids_s + a.grp[cb] * a.window;
                            double* zrow = zz + (size_t)ia * M + a.off[cb] + a.r[cb];
                            const int qb = a.qg[cb];
                            for (int e = e0; e < e1; ++e) {
                                const int i = lst[e];
                                const float* row = xs + i * (P + 1);
                                const double va = xa < 0 ? 1.0 : (double)row[xa];
                                const double vb = xb < 0 ? 1.0 : (double)row[xb];
                                zrow[idb[i] * qb] += va * vb;
                            }
                        }
                    } else {  // ztx column k, or zty
                        const int k = part - Q;
                        const int xc = k < p ? a.fit[k] : P;
                        double* dst = k < p ? zx + (size_t)ia * p + k : zy + ia;
                        double acc = *dst;
                        for (int e = e0; e < e1; ++e) {
                            const float* row = xs + lst[e] * (P + 1);
                            const double va = xa < 0 ? 1.0 : (double)row[xa];
                            acc += va * (double)row[xc];
                        }
                        *dst = acc;
                    }
                }
                __syncthreads();
                for (int gg = 0; gg < a.groups; ++gg)
                    for (int L = t; L < a.m[gg]; L += nt) cur[a.lev0[gg] + L] = end[a.lev0[gg] + L];
                prev = w0 + b;
            }
            __syncthreads();
            const long long cell = sim * a.G + g;
            for (int e = t; e < M * M; e += nt) a.ztz[cell * M * M + e] = zz[e];
            for (int e = t; e < M * p; e += nt) a.ztx[cell * M * p + e] = zx[e];
            for (int e = t; e < M; e += nt) a.zty[cell * M + e] = zy[e];
        }
        __syncthreads();
    }
}

}  // namespace

// The joint mode. fit: pf column indices of X; grid: G ascending row counts
// (host, for the checks) and grid_dev (device, the same); ids: (groups,
// max_n) int32 level ids in device memory, the primary first; levels and
// comps: m_g and q_g per grouping; zc: the X columns of the slopes, grouping
// by grouping (q_g - 1 each). Writes ztz (sims, G, M, M), ztx (sims, G, M,
// pf) and zty (sims, G, M), M = sum m_g q_g. Returns a cudaError_t.
extern "C" int mcp_grid_suffstats_joint(const void* X, const void* y, int sims, int max_n, int P,
                                        const int* fit, int pf, const int* grid,
                                        const void* grid_dev, int G, const void* ids, int groups,
                                        const int* levels, const int* comps, const int* zc,
                                        void* ztz, void* ztx, void* zty, void* stream) {
    if (sims <= 0 || max_n <= 0 || P <= 0 || pf <= 0 || pf > MCP_MAX_P || G <= 0 ||
        groups <= 0 || groups > JOINT_MAX_GROUPS || grid_dev == nullptr || ids == nullptr)
        return (int)cudaErrorInvalidValue;
    JointArgs a;
    a.X = (const float*)X;
    a.y = (const float*)y;
    a.grid = (const int*)grid_dev;
    a.ids = (const int*)ids;
    a.sims = sims;
    a.max_n = max_n;
    a.P = P;
    a.G = G;
    a.pf = pf;
    a.groups = groups;
    for (int i = 0; i < pf; ++i) {
        if (fit[i] < 0 || fit[i] >= P) return (int)cudaErrorInvalidValue;
        a.fit[i] = fit[i];
    }
    for (int g = 0; g < G; ++g)
        if (grid[g] < (g ? grid[g - 1] : 0) || grid[g] > max_n) return (int)cudaErrorInvalidValue;
    if (grid[G - 1] != max_n) return (int)cudaErrorInvalidValue;
    int M = 0, Q = 0, zi = 0, lev = 0;
    for (int g = 0; g < groups; ++g) {
        if (levels[g] <= 0 || comps[g] <= 0 || Q + comps[g] > JOINT_MAX_Q)
            return (int)cudaErrorInvalidValue;
        a.m[g] = levels[g];
        a.lev0[g] = lev;
        a.comp0[g] = Q;
        lev += levels[g];
        for (int r = 0; r < comps[g]; ++r) {
            a.off[Q] = M;
            a.qg[Q] = comps[g];
            a.r[Q] = r;
            a.grp[Q] = g;
            if (r == 0) {
                a.xcol[Q] = -1;
            } else {
                if (zc[zi] < 0 || zc[zi] >= P) return (int)cudaErrorInvalidValue;
                a.xcol[Q] = zc[zi++];
            }
            ++Q;
        }
        M += levels[g] * comps[g];
    }
    if (M > JOINT_MAX_M) return (int)cudaErrorInvalidValue;
    a.M = M;
    a.Q = Q;
    a.levels_all = lev;
    a.ztz = (double*)ztz;
    a.ztx = (double*)ztx;
    a.zty = (double*)zty;
    // the whole design as one window where it fits, else the widest window
    // that does (at least one warp of rows)
    const size_t fixed = joint_smem_of(M, pf, P, groups, lev, 0).total;
    const size_t per_row = sizeof(float) * (size_t)(P + 1) + 2 * sizeof(int) * (size_t)groups;
    if (fixed + 32 * per_row > (size_t)MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
    const long long fit_rows = (long long)(((size_t)MAX_SMEM_BYTES - fixed) / per_row);
    a.window = (int)(fit_rows < max_n ? fit_rows : max_n);
    const size_t smem = joint_smem_of(M, pf, P, groups, lev, a.window).total;
    cudaError_t err = cudaFuncSetAttribute(grid_suffstats_joint_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, grid_suffstats_joint_kernel,
                                                             JOINT_THREADS, smem)) != cudaSuccess)
        return (int)err;
    if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
    const long long resident = (long long)sms * per_sm;
    const unsigned blocks = (unsigned)(sims < resident ? sims : resident);
    grid_suffstats_joint_kernel<<<blocks, JOINT_THREADS, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
