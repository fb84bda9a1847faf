// The steps of the shrink-free Nelder-Mead between its rounds, for one
// cell's simplex in shared memory, run by one thread: kernels K9
// (slope_reml.cu) and K10 (glmm_slope.cu) include this file. The plain
// version is engine/optim.py (_candidates, _replace, select_candidate), in
// the same f64 operations and order: a stable insertion sort of the d + 1
// values (ties keep their order), the centroid as the d best vertices added
// in sorted order times the f64 reciprocal of d, each candidate clipped as
// x < lo ? lo : x. S holds verts[d + 1][], fvals[d + 1], ord[d + 1] (the
// vertex at each sorted position), cand[4][] and their values fc[4].
#pragma once

namespace mcp {

// The four candidates (reflection, expansion, outside and inside
// contraction) of an iteration from the sorted simplex.
template <class S>
__device__ __forceinline__ void nm_candidates(const double* lower, S& s, int d) {
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
    const double inv_d = 1.0 / (double)d;
    for (int k = 0; k < d; ++k) {
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
    const int w = s.ord[d];
    for (int k = 0; k < d; ++k) s.verts[w][k] = s.cand[idx][k];
    s.fvals[w] = s.fc[idx];
    return idx;
}

}  // namespace mcp
