// K2 grid_suffstats: prefix sufficient statistics over the sample-size grid,
// with the per-cluster sums of the random-intercept fit.
//
// Replaces: mcpower_tpu/engine/olsfit.py::grid_suffstats (:41),
// mcpower_tpu/engine/mixedfit.py::_cluster_suffstats (:72) and the static
// layout segment sums of mcpower_tpu/engine/clusterops.py (:50-87). For one
// sim, from the f32 design X (max_n, P) restricted to the fit columns and
// the f32 outcome y, in f64: per grid segment [n_{g-1}, n_g) the sums X'X,
// X'y, y'y, sum y, and with a cluster layout the per-cluster row counts n_j,
// column sums s_j and outcome sums t_j; then the cumulative sum over the
// grid (statistic at g = statistic at g-1 + segment g, as the reference's
// cumsum of per-segment sums).
//
// What bounds it on H100: memory reads and f64 adds. Each sim's design is
// read once from device memory (2.4 KB at the main path's N = 200, p = 3;
// 14 KB for the 7-column, N = 500 curve design), and each statistic is a
// sequential f64 sum over rows, so the kernel moves ~30 MB at 10,000 sims
// and is bounded by the latency of those sums rather than by the 3.35 TB/s
// of device memory.
//
// What the design does about it: one block per sim, one thread per output
// statistic (pf(pf+1)/2 cross products, pf X'y entries, y'y, sum y, and
// m (pf + 2) cluster sums), each walking only the rows it needs; the sim's
// rows are re-read from L1 by the block's threads, so device memory sees
// each byte once. The grid cumsum happens in the thread that owns the
// statistic, so no second pass or atomics are needed. The cluster layout is
// static iota math (round-robin id = row % m, blocked id = row / cs), so a
// cluster's rows are a stride or a range, never a gather.

#include "common.cuh"

#define MCP_MAX_P 16
#define MCP_MAX_GRID 64

struct Layout {
    int fit[MCP_MAX_P];
    int grid[MCP_MAX_GRID];
};

__global__ void grid_suffstats_kernel(const float* __restrict__ X, const float* __restrict__ y,
                                      int max_n, int P, Layout lay, int pf, int G, int m,
                                      int round_robin, int period, double* __restrict__ xtx,
                                      double* __restrict__ xty, double* __restrict__ yty,
                                      double* __restrict__ ysum, double* __restrict__ nj,
                                      double* __restrict__ s, double* __restrict__ t) {
    const int sim = blockIdx.x;
    const float* Xs = X + (long long)sim * max_n * P;
    const float* ys = y + (long long)sim * max_n;
    const int n_pair = pf * (pf + 1) / 2;
    const int n_global = n_pair + pf + 2;
    const int n_items = n_global + m * (pf + 2);

    for (int item = threadIdx.x; item < n_items; item += blockDim.x) {
        double cum = 0.0;
        int prev = 0;
        if (item < n_pair) {
            // cross product (i, j), i <= j, pairs enumerated row by row
            int i = 0, rem = item;
            while (rem >= pf - i) {
                rem -= pf - i;
                ++i;
            }
            const int j = i + rem;
            const int ci = lay.fit[i], cj = lay.fit[j];
            for (int g = 0; g < G; ++g) {
                const int n = lay.grid[g];
                double seg = 0.0;
                for (int r = prev; r < n; ++r)
                    seg += (double)Xs[(long long)r * P + ci] * (double)Xs[(long long)r * P + cj];
                cum += seg;
                double* o = xtx + ((long long)sim * G + g) * pf * pf;
                o[i * pf + j] = cum;
                o[j * pf + i] = cum;
                prev = n;
            }
        } else if (item < n_pair + pf) {
            const int k = item - n_pair;
            const int ck = lay.fit[k];
            for (int g = 0; g < G; ++g) {
                const int n = lay.grid[g];
                double seg = 0.0;
                for (int r = prev; r < n; ++r)
                    seg += (double)Xs[(long long)r * P + ck] * (double)ys[r];
                cum += seg;
                xty[((long long)sim * G + g) * pf + k] = cum;
                prev = n;
            }
        } else if (item < n_global) {
            const bool square = item == n_pair + pf;
            for (int g = 0; g < G; ++g) {
                const int n = lay.grid[g];
                double seg = 0.0;
                for (int r = prev; r < n; ++r) {
                    const double v = (double)ys[r];
                    seg += square ? v * v : v;
                }
                cum += seg;
                (square ? yty : ysum)[(long long)sim * G + g] = cum;
                prev = n;
            }
        } else {
            // cluster statistic: c = cluster, k < pf column sum, k == pf
            // outcome sum, k == pf + 1 row count
            const int ci = item - n_global;
            const int c = ci / (pf + 2);
            const int k = ci % (pf + 2);
            for (int g = 0; g < G; ++g) {
                const int n = lay.grid[g];
                int r0, r1, step;
                if (round_robin) {
                    r0 = prev + ((c - prev % period) % period + period) % period;
                    r1 = n;
                    step = period;
                } else {
                    r0 = max(prev, c * period);
                    r1 = min(n, (c + 1) * period);
                    step = 1;
                }
                double seg = 0.0;
                for (int r = r0; r < r1; r += step) {
                    if (k < pf)
                        seg += (double)Xs[(long long)r * P + lay.fit[k]];
                    else if (k == pf)
                        seg += (double)ys[r];
                    else
                        seg += 1.0;
                }
                cum += seg;
                const long long cell = (long long)sim * G + g;
                if (k < pf)
                    s[(cell * m + c) * pf + k] = cum;
                else if (k == pf)
                    t[cell * m + c] = cum;
                else
                    nj[cell * m + c] = cum;
                prev = n;
            }
        }
    }
}

// fit: pf column indices of X; grid: G ascending row counts (last == max_n),
// both host memory. m = 0 computes no cluster statistics (nj, s, t may then
// be null). Returns a cudaError_t.
extern "C" int mcp_grid_suffstats(const void* X, const void* y, int sims, int max_n, int P,
                                  const int* fit, int pf, const int* grid, int G, int m,
                                  int round_robin, int period, void* xtx, void* xty, void* yty,
                                  void* ysum, void* nj, void* s, void* t, void* stream) {
    if (sims <= 0 || pf <= 0 || pf > MCP_MAX_P || G <= 0 || G > MCP_MAX_GRID || m < 0 ||
        period <= 0 || (m > 0 && (nj == nullptr || s == nullptr || t == nullptr)))
        return (int)cudaErrorInvalidValue;
    Layout lay;
    for (int i = 0; i < pf; ++i) {
        if (fit[i] < 0 || fit[i] >= P) return (int)cudaErrorInvalidValue;
        lay.fit[i] = fit[i];
    }
    for (int g = 0; g < G; ++g) {
        if (grid[g] < (g ? grid[g - 1] : 0) || grid[g] > max_n) return (int)cudaErrorInvalidValue;
        lay.grid[g] = grid[g];
    }
    grid_suffstats_kernel<<<sims, 128, 0, (cudaStream_t)stream>>>(
        (const float*)X, (const float*)y, max_n, P, lay, pf, G, m, round_robin, period,
        (double*)xtx, (double*)xty, (double*)yty, (double*)ysum, (double*)nj, (double*)s,
        (double*)t);
    return (int)cudaGetLastError();
}
