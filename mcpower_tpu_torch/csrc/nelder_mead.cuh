// The steps of the shrink-free Nelder-Mead between its rounds, for one
// cell's simplex in shared memory, run by one thread: kernels K9-K12
// (slope_reml.cu, glmm_slope.cu, joint_reml.cu, glmm_extras.cu) include
// this file. The plain
// version is engine/optim.py (_candidates, _replace, select_candidate), in
// the same f64 operations and order: a stable insertion sort of the d + 1
// values (ties keep their order), the centroid as the d best vertices added
// in sorted order times the f64 reciprocal of d, each candidate clipped as
// x < lo ? lo : x. S holds verts[d + 1][], fvals[d + 1], ord[d + 1] (the
// vertex at each sorted position), cand[4][] and their values fc[4].
//
// K9 takes the steps one part at a time (nm_sort, nm_candidate_at, nm_need,
// nm_pick, nm_replace): the sort on one thread, the candidates one
// coordinate a thread, and the selection's candidates evaluated only where
// it reads them.
#pragma once

namespace mcp {

// The stable insertion sort of the d + 1 values, from the previous order.
template <class S>
__device__ __forceinline__ void nm_sort(S& s, int d) {
    for (int i = 1; i <= d; ++i) {
        const int v = s.ord[i];
        const double f = s.fvals[v];
        int j = i - 1;
        while (j >= 0 && s.fvals[s.ord[j]] > f) {
            s.ord[j + 1] = s.ord[j];
            --j;
        }
        s.ord[j + 1] = v;
    }
}

// Coordinate k of the four candidates from the sorted simplex.
template <class S>
__device__ __forceinline__ void nm_candidate_at(const double* lower, S& s, int d, int k) {
    const double inv_d = 1.0 / (double)d;
    double acc = s.verts[s.ord[0]][k];
    for (int i = 1; i < d; ++i) acc = acc + s.verts[s.ord[i]][k];
    const double c = acc * inv_d;
    const double w = s.verts[s.ord[d]][k];
    const double lo = lower[k];
    double xr = c + 1.0 * (c - w);
    xr = (xr < lo) ? lo : xr;
    double xe = c + 2.0 * (xr - c);
    double xo = c + 0.5 * (xr - c);
    double xi = c - 0.5 * (c - w);
    s.cand[0][k] = xr;
    s.cand[1][k] = (xe < lo) ? lo : xe;
    s.cand[2][k] = (xo < lo) ? lo : xo;
    s.cand[3][k] = (xi < lo) ? lo : xi;
}

// The one candidate besides the reflection (its value fc[0]) that
// nm_select_and_replace reads: 1 the expansion (fr < f_best), 2 the outside
// contraction (second <= fr < f_worst), 3 the inside contraction (fr >=
// f_worst); 0 none (f_best <= fr < second, where the reflection is taken).
template <class S>
__device__ __forceinline__ int nm_need(const S& s, int d) {
    const double fr = s.fc[0];
    if (fr < s.fvals[s.ord[0]]) return 1;
    if (fr < s.fvals[s.ord[d - 1]]) return 0;
    if (fr < s.fvals[s.ord[d]]) return 2;
    return 3;
}

// nm_select_and_replace's index once fc[need] is known: in each case of
// nm_need its precedence leaves one comparison.
template <class S>
__device__ __forceinline__ int nm_pick(const S& s, int need) {
    switch (need) {
        case 1: return (s.fc[1] < s.fc[0]) ? 1 : 0;
        case 2: return (s.fc[2] <= s.fc[0]) ? 2 : 0;
        case 3: return 3;
        default: return 0;
    }
}

// The worst vertex replaced by candidate idx.
template <class S>
__device__ __forceinline__ void nm_replace(S& s, int d, int idx) {
    const int w = s.ord[d];
    for (int k = 0; k < d; ++k) s.verts[w][k] = s.cand[idx][k];
    s.fvals[w] = s.fc[idx];
}

// optim.select_candidate, then the worst vertex replaced; the index taken.
template <class S>
__device__ __forceinline__ int nm_select_and_replace(S& s, int d) {
    const double f_best = s.fvals[s.ord[0]], second = s.fvals[s.ord[d - 1]];
    const double f_worst = s.fvals[s.ord[d]];
    const double fr = s.fc[0], fe = s.fc[1], fo = s.fc[2];
    const bool use_expand = (fr < f_best) && (fe < fr);
    const bool use_reflect = ((fr < second) && !use_expand) || ((fr < f_best) && !(fe < fr));
    const bool use_cout = !use_expand && !use_reflect && (fr < f_worst) && (fo <= fr);
    const bool use_rfall = !use_expand && !use_reflect && (fr < f_worst) && !use_cout;
    const int idx = use_expand ? 1 : ((use_reflect || use_rfall) ? 0 : (use_cout ? 2 : 3));
    nm_replace(s, d, idx);
    return idx;
}

// The four candidates (reflection, expansion, outside and inside
// contraction) of an iteration from the sorted simplex.
template <class S>
__device__ __forceinline__ void nm_candidates(const double* lower, S& s, int d) {
    nm_sort(s, d);
    for (int k = 0; k < d; ++k) nm_candidate_at(lower, s, d, k);
}

}  // namespace mcp
