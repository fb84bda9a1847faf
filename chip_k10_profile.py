#!/usr/bin/env python3
"""Launch times and cycle breakdown of kernel K10 (the random-slope GLMM
fit) on one card.

    python3 chip_k10_profile.py [LABEL=CSRC ...]

Each ``LABEL=CSRC`` names a ``csrc`` directory (default: this tree's, as
``this``); the parent commit's, say, after ``git archive <commit>
mcpower_tpu_torch/csrc | tar -x -C _parent`` (``_parent/`` is gitignored).
At the glmm_slopes arm's cells (``chip_smoke.K10_CHECKS``' 512 sims), a
launch of the slope-GLMM flow (1,250 sims, N 480) and a launch of its
sample-size flow (1,250 sims x 11 grid points, N 240..720), rows from the
port's plain generator on the card:

1. the launch time of each build, in turns, and whether every output has
   the first build's bits (``chip_k11_profile.times_in_turns``);
2. the cycle breakdown: the source built again with ``-DMCP_K10_CLOCKS=N``
   (a source without those hooks, K10's first version's, gets them at the
   anchors of ``FIRST_VERSION_PROBES``); one launch, and the mean
   warp-cycles a cell by region (the sums over a cell's four warps): in the
   f32 passes, the row walk, the per-cluster C, its factor and solves, the
   warp sums and the p x p Schur step; thread 0's simplex steps, the waits
   at the search's barriers, the f64 fit with its pin probes, and the
   Hessian's passes.

Where a build has ``mcp_glmm_slope_geometry`` (the redesigned launcher), its
form, resident cells an SM and waves are printed too. Prints the card's name
and power limit first, and writes the numbers to
``chiprun_out/k10_profile.json``. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import sys

from chip_k11_profile import (REPO, build_pairs, card_line, clock_means, print_clocks,
                              same_bits, times_in_turns)

REGIONS = ["total", "row walk", "per-cluster C, factor and solves", "warp sums",
           "p x p Schur step", "simplex steps", "waits at barriers", "f64 fit and probes",
           "Hessian", "-", "-", "-"]
PART_OF = {}
CASES = {"glmm_slopes": None, "glmm_slopes_flow_launch": "model_glmm_slopes_power",
         "sample_size_flow_launch": "model_glmm_slopes_sample_size"}

CLOCK_HEAD = r'''
#ifdef MCP_K10_CLOCKS
__device__ unsigned long long mcp_k10_clk[MCP_K10_CLOCKS * 12];
#define K10_T0(v) long long v = clock64()
#define K10_ADD(k, v) do { if (threadIdx.x % 32 == 0 && blockIdx.x < MCP_K10_CLOCKS) \
    atomicAdd(&mcp_k10_clk[(long long)blockIdx.x * 12 + (k)], \
              (unsigned long long)(clock64() - (v))); } while (0)
#define K10_ADD32(k, v) do { if (sizeof(T) == 4) K10_ADD(k, v); } while (0)
#else
#define K10_T0(v)
#define K10_ADD(k, v)
#define K10_ADD32(k, v)
#endif
'''
FIRST_VERSION_TAIL = r'''
#ifdef MCP_K10_CLOCKS
extern "C" int mcp_k10_clocks(void* dst, int zero) {
    if (zero) {
        void* p = nullptr;
        int err = (int)cudaGetSymbolAddress(&p, mcp_k10_clk);
        return err ? err : (int)cudaMemset(p, 0, sizeof(mcp_k10_clk));
    }
    return (int)cudaMemcpyFromSymbol(dst, mcp_k10_clk, sizeof(mcp_k10_clk));
}
#endif
'''
_F = "glmm_slope.cu"
FIRST_VERSION_PROBES = [
    (_F, '#include "smallchol.cuh"\n', '#include "smallchol.cuh"\n' + CLOCK_HEAD),
    (_F, "        const Rows rw = rows_of(a, n, cl);\n        int r = rw.first;\n        for (int it",
     "        K10_T0(clk_r);\n        const Rows rw = rows_of(a, n, cl);\n        int r = rw.first;\n"
     "        for (int it"),
    (_F, "        // C = I + (Lam' G) Lam and its Cholesky\n",
     "        K10_ADD32(1, clk_r);\n        K10_T0(clk_c);\n"
     "        // C = I + (Lam' G) Lam and its Cholesky\n"),
    (_F, "                for (int i = 0; i < PB; ++i) pxz[i] = pxz[i] + sxz[i];\n"
         "            }\n        }\n    }\n",
     "                for (int i = 0; i < PB; ++i) pxz[i] = pxz[i] + sxz[i];\n"
     "            }\n        }\n        K10_ADD32(2, clk_c);\n    }\n"),
    (_F, "    T lap = T(0);\n    if (want_dev) {\n",
     "    K10_T0(clk_w);\n    T lap = T(0);\n    if (want_dev) {\n"),
    (_F, "        if (!want_a) return lap;\n",
     "        if (!want_a) {\n            K10_ADD32(3, clk_w);\n            return lap;\n        }\n"),
    (_F, "    if (!step) {  // K_MODE: the f64 fit's Schur matrix\n",
     "    K10_ADD32(3, clk_w);\n    K10_T0(clk_s);\n"
     "    if (!step) {  // K_MODE: the f64 fit's Schur matrix\n"),
    (_F, "    __syncwarp();\n    return T(0);\n}\n\n// `steps` passes",
     "    __syncwarp();\n    K10_ADD32(4, clk_s);\n    return T(0);\n}\n\n// `steps` passes"),
    (_F, "    const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP, t = threadIdx.x;\n",
     "    const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP, t = threadIdx.x;\n"
     "    K10_T0(clk_all);\n"),
    (_F, "            if (lane == 0) S.fc[warp] = isfinite(lap) ? (double)lap : SENTINEL;\n"
         "        }\n        __syncthreads();\n",
     "            if (lane == 0) S.fc[warp] = isfinite(lap) ? (double)lap : SENTINEL;\n"
     "        }\n        K10_T0(clk_b0);\n        __syncthreads();\n        K10_ADD(6, clk_b0);\n"),
    (_F, "        if (t == 0) mcp::nm_candidates(a.lower, S, D);\n        __syncthreads();\n",
     "        K10_T0(clk_n0);\n        if (t == 0) mcp::nm_candidates(a.lower, S, D);\n"
     "        K10_ADD(5, clk_n0);\n        K10_T0(clk_b1);\n        __syncthreads();\n"
     "        K10_ADD(6, clk_b1);\n"),
    (_F, "        if (lane == 0) S.fc[warp] = isfinite(lap) ? (double)lap : SENTINEL;\n"
         "        __syncthreads();\n        if (t == 0) S.src = mcp::nm_select_and_replace(S, D);\n"
         "        __syncthreads();\n",
     "        if (lane == 0) S.fc[warp] = isfinite(lap) ? (double)lap : SENTINEL;\n"
     "        K10_T0(clk_b2);\n        __syncthreads();\n        K10_ADD(6, clk_b2);\n"
     "        K10_T0(clk_n1);\n        if (t == 0) S.src = mcp::nm_select_and_replace(S, D);\n"
     "        K10_ADD(5, clk_n1);\n        K10_T0(clk_b3);\n        __syncthreads();\n"
     "        K10_ADD(6, clk_b3);\n"),
    (_F, "    // the cold f64 fit at the optimum (warp 0); the outcome's row sum\n",
     "    K10_T0(clk_d);\n    // the cold f64 fit at the optimum (warp 0); the outcome's row sum\n"),
    (_F, "        if (lane == 0) S.probe[warp] = pr;\n    }\n",
     "        if (lane == 0) S.probe[warp] = pr;\n    }\n    K10_ADD(7, clk_d);\n"),
    (_F, "    const int nv = a.hessian ? 1 + 2 * p + 2 * p * (p - 1) : 0;\n",
     "    const int nv = a.hessian ? 1 + 2 * p + 2 * p * (p - 1) : 0;\n    K10_T0(clk_h);\n"),
    (_F, "        if (lane == 0) S.hv[e] = hv;\n    }\n    __syncthreads();\n",
     "        if (lane == 0) S.hv[e] = hv;\n    }\n    K10_ADD(8, clk_h);\n    __syncthreads();\n"),
    (_F, "    if (t != 0) return;\n    constexpr int NT",
     "    K10_ADD(0, clk_all);\n    if (t != 0) return;\n    constexpr int NT"),
]


def k10_case_args(chip_smoke, case: str):
    """K10's arguments at ``case`` (CASES), from rows made on the card by the
    plain generator."""
    import torch

    from mcpower_tpu_torch.engine import datagen, lower
    from mcpower_tpu_torch.engine.spec import ClusterStatic

    dev = torch.device("cuda")
    flow = CASES[case]
    if flow is None:
        sims = chip_smoke.K10_CHECKS[case]
        spec, arr = chip_smoke.lower_design(lower, ClusterStatic, case)
    else:
        sims = chip_smoke.N_SIMS // 8
        spec, arr = chip_smoke.flow_lowered(flow)[0]
    arr_d = datagen.to_device(arr, dev)
    ids = torch.arange(sims, dtype=torch.int64, device=dev)
    X, y, _ = datagen.generate_batch(spec, arr_d, chip_smoke.SEED, 0, ids, plain=True)
    return chip_smoke.k10_args(spec, arr_d, X, y), sims * len(spec.grid)


def k10_launcher(k):
    """A function running K10 build ``k`` on K10's arguments."""
    import chip_smoke
    from mcpower_tpu_torch.engine import glmmfit, kernels

    def run(args):
        with chip_smoke.kernel_swapped(kernels, "glmm_slope", k):
            return glmmfit.glmm_slope_kernel(*args)
    return run


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_k10_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from mcpower_tpu_torch.engine import glmmfit, kernels

    smi = card_line()
    print(smi, flush=True)
    builds = build_pairs(kernels, argv, "glmm_slope", "glmm_slope.cu", "MCP_K10_CLOCKS",
                         FIRST_VERSION_PROBES, FIRST_VERSION_TAIL)
    out = {"card": smi, "launch_ms": {}, "clocks": {}, "geometry": {}}
    for case in CASES:
        args, cells = k10_case_args(chip_smoke, case)
        geo = {}
        for lb, (k, _) in builds.items():
            if "mcp_glmm_slope_geometry" in (k.csrc / k.source).read_text():
                with chip_smoke.kernel_swapped(kernels, "glmm_slope", k):
                    geo[lb] = glmmfit.glmm_slope_geometry(*args)
                print(f"K10 {case} ({lb}): {geo[lb]}", flush=True)
        out["geometry"][case] = geo
        turns, results = times_in_turns({lb: k10_launcher(ks[0]) for lb, ks in builds.items()},
                                        args)
        first = next(iter(results.values()))
        same = {lb: same_bits(r, first) for lb, r in results.items()}
        out["launch_ms"][case] = {"cells": cells, "ms": turns, "same_bits": same}
        print(f"K10 {case} ({cells} cells, N {list(args[5])}), ms a launch in turns: "
              + ", ".join(f"{lb} {' / '.join(f'{t:.3f}' for t in ts)}" for lb, ts in turns.items())
              + f"; outputs the same bits as {next(iter(results))}'s: {same}", flush=True)
        out["clocks"][case] = {}
        for lb, (_, kc) in builds.items():
            mean = clock_means(kc, "mcp_k10_clocks", k10_launcher(kc), args, cells, REGIONS,
                               PART_OF)
            out["clocks"][case][lb] = mean
            print_clocks(f"K10 warp-cycles a cell, {case} ({lb})", mean)

    (REPO / "chiprun_out").mkdir(exist_ok=True)
    (REPO / "chiprun_out" / "k10_profile.json").write_text(json.dumps(out, indent=1))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
