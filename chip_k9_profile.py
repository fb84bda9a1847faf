#!/usr/bin/env python3
"""Launch times and cycle breakdown of kernel K9 (the random-slope REML
fit) and K2's slope mode on one card.

    python3 chip_k9_profile.py [LABEL=CSRC ...]

Each ``LABEL=CSRC`` names a ``csrc`` directory (default: this tree's, as
``this``); the parent commit's, say, after ``git archive <commit>
mcpower_tpu_torch/csrc | tar -x -C _parent`` (``_parent/`` is gitignored).
At a launch of README flow 2's power flow (1,250 cells) and of its
sample-size flow (1,250 sims x 11 grid points, N 300..900), at the
lmm_slopes arm's cells (10,000) and at lmm_multislope's (1,024; p 5, q 3),
statistics from the port's plain generator and K2's plain slope sums on the
card:

1. K9's launch time for each build, in turns (first, second, ..., second,
   first): device time from torch.profiler's kernel events
   (``chip_smoke.device_ms``, inputs cycled through copies over twice the
   L2), and whether every output has the first build's bits;
2. K9's cycle breakdown: the source built again with ``-DMCP_K9_CLOCKS=N``
   (a source without those hooks, K9's first version's, gets them at the
   anchors of ``FIRST_VERSION_PROBES``); one launch, and the mean cycles a
   cell by region as the cell's first lane sees them: in the f32 search the
   cluster walk, the group's shuffle tree (the fold of the cluster sums),
   the p x p factor and deviance; the simplex steps (sort, candidates,
   selection), the waits at the warp's barriers, the f64 probes and the
   final fit, the twin's staging;
3. K2's slope mode at the lmm_slopes arm's rows and at both README flow 2
   launches, each build in turns, its G, A, b and prefix sums held to the
   first build's bits;
4. the host's time a call (the wrapper returning, the launch queued) of K9
   and of K2's slope mode, each build in turns;
5. the SASS of K2's slope-mode kernels of four sims a warp, each build's
   against the first's (``cuobjdump -sass``): whether the instructions are
   the same.

A ``slopes_null`` case (K9_CHECKS: a null slope that pins) joins the four
launches; the clock build also counts a cell's f32 clusters, those its fast
solves recomputed with the IEEE division, and those with a zero numerator
(0 in a build without the counts).

Where a build has ``mcp_slope_reml_geometry`` (the redesigned launcher), its
form, resident cells an SM and waves are printed too, and the f32
evaluations its cells ran. Prints the card's name and power limit first,
and writes the numbers to ``chiprun_out/k9_profile.json``. It imports
nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

from chip_k11_profile import REPO, build_pairs, card_line, clock_means, print_clocks, same_bits

REGIONS = ["total", "cluster walk", "shuffle tree", "p x p factor and deviance",
           "simplex steps", "waits at barriers", "f64 probes and final fit", "twin staging",
           "f32 clusters", "clusters recomputed", "clusters with a zero numerator", "-"]
# Slots 8-10 of the clock build are counts a cell, not cycles.
COUNTS = ("f32 clusters", "clusters recomputed", "clusters with a zero numerator")
PART_OF = set(COUNTS)
CASES = ("readme2_flow_launch", "readme2_sample_size_launch", "lmm_slopes", "lmm_multislope",
         "slopes_null")
K2_CASES = ("lmm_slopes", "readme2_flow_launch", "readme2_sample_size_launch")

CLOCK_HEAD = r'''
#ifdef MCP_K9_CLOCKS
__device__ unsigned long long mcp_k9_clk[MCP_K9_CLOCKS * 12];
#define K9_T0(v) long long v = clock64()
#define K9_ADD(k, v) do { if (threadIdx.x % 32 == 0 && cell < MCP_K9_CLOCKS) \
    atomicAdd(&mcp_k9_clk[cell * 12 + (k)], (unsigned long long)(clock64() - (v))); } while (0)
#define K9_ADD32(k, v) do { if (sizeof(T) == 4) K9_ADD(k, v); } while (0)
#else
#define K9_T0(v)
#define K9_ADD(k, v)
#define K9_ADD32(k, v)
#endif
'''
FIRST_VERSION_TAIL = r'''
#ifdef MCP_K9_CLOCKS
extern "C" int mcp_k9_clocks(void* dst, int zero) {
    if (zero) {
        void* p = nullptr;
        int err = (int)cudaGetSymbolAddress(&p, mcp_k9_clk);
        return err ? err : (int)cudaMemset(p, 0, sizeof(mcp_k9_clk));
    }
    return (int)cudaMemcpyFromSymbol(dst, mcp_k9_clk, sizeof(mcp_k9_clk));
}
#endif
'''
_F = "slope_reml.cu"
# Clock hooks for K9's first version (its slope_reml.cu before the forms), as (file,
# anchor, replacement); lane 0 of the cell's warp records.
FIRST_VERSION_PROBES = [
    (_F, '#include "smallchol.cuh"\n', '#include "smallchol.cuh"\n' + CLOCK_HEAD),
    (_F, "    for (int c = sl; c < m; c += GROUP) {\n",
     "    K9_T0(clk_w);\n    for (int c = sl; c < m; c += GROUP) {\n"),
    (_F, "    // the group's lanes combine: distances 4, 2, 1\n",
     "    K9_ADD32(1, clk_w);\n    K9_T0(clk_s);\n"
     "    // the group's lanes combine: distances 4, 2, 1\n"),
    (_F, "    // X'V^-1X, its factor, beta, rss and the deviance\n",
     "    K9_ADD32(2, clk_s);\n    K9_T0(clk_f);\n"
     "    // X'V^-1X, its factor, beta, rss and the deviance\n"),
    (_F, "    return (s.ld + ldx) + df * log(rss);\n}\n",
     "    const T dev_out = (s.ld + ldx) + df * log(rss);\n    K9_ADD32(3, clk_f);\n"
     "    return dev_out;\n}\n"),
    (_F, "    if (cell >= a.B) return;  // a whole warp leaves together\n",
     "    if (cell >= a.B) return;  // a whole warp leaves together\n    K9_T0(clk_all);\n"),
    (_F, "    if (twin) {  // G, A, b of the cell as f32, in that order\n",
     "    K9_T0(clk_tw);\n    if (twin) {  // G, A, b of the cell as f32, in that order\n"),
    (_F, "    if (lane == 0) {\n        for (int i = 0; i <= D; ++i) {\n",
     "    K9_ADD(7, clk_tw);\n    if (lane == 0) {\n        for (int i = 0; i <= D; ++i) {\n"),
    (_F, "                mcp::nm_candidates(a.lower, S, D);\n",
     "                K9_T0(clk_n0);\n                mcp::nm_candidates(a.lower, S, D);\n"
     "                K9_ADD(4, clk_n0);\n"),
    (_F, "        __syncwarp();\n        const float dv = deviance<Q, PM, float>(",
     "        K9_T0(clk_b0);\n        __syncwarp();\n        K9_ADD(5, clk_b0);\n"
     "        const float dv = deviance<Q, PM, float>("),
    (_F, "        const double f = isfinite(dv) ? (double)dv : (double)SENTINEL32;\n"
         "        __syncwarp();\n        if (sl == 0) S.fc[g] = f;\n        __syncwarp();\n",
     "        const double f = isfinite(dv) ? (double)dv : (double)SENTINEL32;\n"
     "        K9_T0(clk_b1);\n        __syncwarp();\n        K9_ADD(5, clk_b1);\n"
     "        if (sl == 0) S.fc[g] = f;\n"
     "        K9_T0(clk_b2);\n        __syncwarp();\n        K9_ADD(5, clk_b2);\n"),
    (_F, "                mcp::nm_select_and_replace(S, D);\n            }\n        }\n"
         "        __syncwarp();\n    }\n",
     "                K9_T0(clk_n1);\n                mcp::nm_select_and_replace(S, D);\n"
     "                K9_ADD(4, clk_n1);\n            }\n        }\n"
     "        K9_T0(clk_b3);\n        __syncwarp();\n        K9_ADD(5, clk_b3);\n    }\n"),
    (_F, "    // f64: the optimum and the q zero-column probes (slot 0 the optimum,\n",
     "    K9_T0(clk_d);\n"
     "    // f64: the optimum and the q zero-column probes (slot 0 the optimum,\n"),
    (_F, "                    if (i < p) a.cov[cell * p * p + i * p + j] = sigma2 * col[i];\n"
         "            }\n        }\n    }\n}\n",
     "                    if (i < p) a.cov[cell * p * p + i * p + j] = sigma2 * col[i];\n"
     "            }\n        }\n    }\n    K9_ADD(6, clk_d);\n    K9_ADD(0, clk_all);\n}\n"),
]


def case_rows(chip_smoke, case: str):
    """(spec, X, y) at ``case``: a README flow 2 launch (K9_FLOW_CASES) or a
    design of K9_CHECKS, rows made on the card by the plain generator."""
    import torch

    from mcpower_tpu_torch.engine import datagen, lower
    from mcpower_tpu_torch.engine.spec import ClusterStatic

    dev = torch.device("cuda")
    if case in chip_smoke.K9_FLOW_CASES:
        flow, sims = chip_smoke.K9_FLOW_CASES[case]
        spec, arr = chip_smoke.flow_lowered(flow)[0]
    else:
        sims = chip_smoke.K9_CHECKS[case]
        spec, arr = chip_smoke.lower_design(lower, ClusterStatic, case)
    ids = torch.arange(sims, dtype=torch.int64, device=dev)
    X, y, _ = datagen.generate_batch(spec, datagen.to_device(arr, dev), chip_smoke.SEED, 0, ids,
                                     plain=True)
    return spec, X, y


def device_turns(chip_smoke, kernels, name: str, variants, fn, inputs, reps: int = 10,
                 set_form=None):
    """``fn(*inputs)`` for each variant of ``variants`` (label -> (Kernel,
    form)): kernel ``name`` swapped for that build and, where the form is
    not None, ``set_form(form)`` before its calls; in turns (first, ...,
    last, last, ..., first), each the mean device ms of ``reps`` launches.
    Returns (label -> [ms, ms], label -> outputs of one call)."""
    copies = chip_smoke.input_copies(inputs)
    turns = {lb: [] for lb in variants}
    results = {}
    order = list(variants)
    for lb in order + order[::-1]:
        k, form = variants[lb]
        with chip_smoke.kernel_swapped(kernels, name, k):
            if form is not None:
                set_form(form)
            results[lb] = fn(*inputs)
            turns[lb].append(chip_smoke.device_ms(fn, copies, reps, name + "_kernel",
                                                  launches=1))
            if form is not None:
                set_form(0)
    return turns, results


def host_turns(chip_smoke, kernels, name: str, variants, fn, inputs, reps: int = 30,
               set_form=None):
    """The host's ms a call of ``fn(*inputs)`` (the wrapper returning, its
    launch queued on an idle card) for each variant of ``variants`` (as
    :func:`device_turns`), in turns; each the median of ``reps`` calls."""
    import statistics
    import time

    import torch

    turns = {lb: [] for lb in variants}
    order = list(variants)
    for lb in order + order[::-1]:
        k, form = variants[lb]
        with chip_smoke.kernel_swapped(kernels, name, k):
            if form is not None:
                set_form(form)
            fn(*inputs)
            times = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(*inputs)
                times.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            turns[lb].append(statistics.median(times))
            if form is not None:
                set_form(0)
    return turns


def sass_of(lib: Path):
    """Each kernel's SASS instructions in a built library (``cuobjdump
    -sass``; addresses and encodings left out), by mangled name."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                         timeout=300).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(.*?)\s*(/\*.*)?$", line)
        if cur is not None and m:
            cur.append(m.group(1))
    return funcs


def k2_slope_sass(k2_builds):
    """The SASS of K2's slope-mode kernels of four sims a warp
    (``grid_suffstats_kernel<PF, true>`` in a build of one form,
    ``<PF, true, 4>`` in a build of two), each build's against the first's:
    label -> {PF: (instructions, the same as the first build's)}."""
    import re

    by_build = {}
    for lb, k in k2_builds.items():
        kern = {}
        for name, ins in sass_of(k.lib_path).items():
            m = re.search(r"grid_suffstats_kernelILi(\d+)ELb1E(?:Li(\d+)E)?E", name)
            if m and m.group(2) in (None, "4"):
                kern[int(m.group(1))] = ins
        by_build[lb] = kern
    first = next(iter(by_build.values()))
    return {lb: {pf: (len(ins), ins == first.get(pf)) for pf, ins in sorted(kern.items())}
            for lb, kern in by_build.items()}


def k9_launcher(k):
    """A function running K9 build ``k`` on K9's arguments."""
    import chip_smoke
    from mcpower_tpu_torch.engine import kernels, mixedfit

    def run(args):
        with chip_smoke.kernel_swapped(kernels, "slope_reml", k):
            return mixedfit.slope_reml_kernel(*args)
    return run


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_k9_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from mcpower_tpu_torch.engine import kernels, mixedfit, olsfit

    smi = card_line()
    print(smi, flush=True)
    specs = argv or [f"this={REPO / 'mcpower_tpu_torch' / 'csrc'}"]
    k2_builds = {}
    for spec in specs:  # K2 from each tree, built while K9's pairs build
        label, _, path = spec.partition("=")
        k2_builds[label] = kernels.Kernel(f"grid_suffstats_{label}", "grid_suffstats.cu",
                                          kernels.KERNELS["grid_suffstats"].flags,
                                          csrc=Path(path).resolve())
    k2_procs = [(k, k.start_build()) for k in k2_builds.values()]
    builds = build_pairs(kernels, specs, "slope_reml", "slope_reml.cu", "MCP_K9_CLOCKS",
                         FIRST_VERSION_PROBES, FIRST_VERSION_TAIL)
    for k, proc in k2_procs:
        k.finish_build(proc)
    out = {"card": smi, "launch_ms": {}, "clocks": {}, "geometry": {}, "k2_slope_ms": {}}
    rows = {case: case_rows(chip_smoke, case) for case in CASES}
    for case in CASES:
        spec, X, y = rows[case]
        args = chip_smoke.k9_args(spec, olsfit.grid_suffstats_plain(spec, X, y, with_slopes=True))
        cells = int(args[5].numel())
        geo, variants = {}, {}
        for lb, (k, kc) in builds.items():
            variants[lb] = (k, None)
            if "mcp_slope_reml_geometry" not in (k.csrc / k.source).read_text():
                continue
            with chip_smoke.kernel_swapped(kernels, "slope_reml", k):
                for form, fname in [(0, "auto")] + list(mixedfit.SLOPE_FORMS.items()):
                    mixedfit.slope_reml_set_form(form)
                    g = mixedfit.slope_reml_geometry(*args)
                    taken = mixedfit.SLOPE_FORMS[g["form"]]
                    geo[f"{lb}:{fname}"] = g
                    print(f"K9 {case} ({lb}, {fname}: takes {taken}): {g}", flush=True)
                    # a form the bucket lacks is not taken: time each taken form once
                    if form and f"{lb}:{taken}" not in variants:
                        variants[f"{lb}:{taken}"] = (k, g["form"])
                mixedfit.slope_reml_set_form(0)
                evals = mixedfit.slope_reml_kernel(*args, evals=True)[6]
            geo[f"{lb}:evals"] = {"mean": float(evals.double().mean()),
                                  "min": int(evals.min()), "max": int(evals.max())}
            print(f"K9 {case} ({lb}): f32 evaluations a cell {geo[f'{lb}:evals']}", flush=True)
        out["geometry"][case] = geo
        turns, results = device_turns(chip_smoke, kernels, "slope_reml", variants,
                                      mixedfit.slope_reml_kernel, args,
                                      set_form=mixedfit.slope_reml_set_form)
        first = next(iter(results.values()))
        same = {lb: same_bits(r, first) for lb, r in results.items()}
        host = host_turns(chip_smoke, kernels, "slope_reml",
                          {lb: v for lb, v in variants.items() if ":" not in lb},
                          mixedfit.slope_reml_kernel, args)
        out["launch_ms"][case] = {"cells": cells, "ms": turns, "same_bits": same,
                                  "host_ms": host}
        print(f"K9 {case} ({cells} cells, m {args[0].shape[-3]}, p {args[3].shape[-1]}, q "
              f"{args[0].shape[-1]}), ms a launch in turns: "
              + ", ".join(f"{lb} {' / '.join(f'{t:.3f}' for t in ts)}" for lb, ts in turns.items())
              + f"; outputs the same bits as {next(iter(results))}'s: {same}; host ms a call "
              "in turns: " + ", ".join(f"{lb} {' / '.join(f'{t:.4f}' for t in ts)}"
                                       for lb, ts in host.items()), flush=True)
        out["clocks"][case] = {}
        for lb, (k, form) in variants.items():
            kc = builds[lb.split(":")[0]][1]
            with chip_smoke.kernel_swapped(kernels, "slope_reml", kc):
                if form is not None:
                    mixedfit.slope_reml_set_form(form)
                mean = clock_means(kc, "mcp_k9_clocks", k9_launcher(kc), args, cells, REGIONS,
                                   PART_OF)
                if form is not None:
                    mixedfit.slope_reml_set_form(0)
            counts = {c: mean.pop(c) for c in COUNTS}
            out["clocks"][case][lb] = dict(mean, **counts)
            print_clocks(f"K9 cycles a cell, {case} ({lb})", mean)
            if counts["f32 clusters"]:
                n = counts["f32 clusters"]
                print(f"K9 f32 clusters a cell, {case} ({lb}): {n:.1f}, recomputed by the IEEE "
                      f"path {counts['clusters recomputed']:.2f} "
                      f"({counts['clusters recomputed'] / n:.2%}), with a zero numerator "
                      f"{counts['clusters with a zero numerator']:.2f} "
                      f"({counts['clusters with a zero numerator'] / n:.2%})", flush=True)
    for case in K2_CASES:
        spec, X, y = rows[case]
        turns, results = device_turns(
            chip_smoke, kernels, "grid_suffstats", {lb: (k, None) for lb, k in k2_builds.items()},
            lambda X_, y_, spec=spec: [v for _, v in sorted(olsfit.grid_suffstats_kernel(
                spec, X_, y_, with_slopes=True).items())], (X, y), reps=20)
        first = next(iter(results.values()))
        same = {lb: same_bits(r, first) for lb, r in results.items()}
        host = host_turns(
            chip_smoke, kernels, "grid_suffstats", {lb: (k, None) for lb, k in k2_builds.items()},
            lambda X_, y_, spec=spec: olsfit.grid_suffstats_kernel(spec, X_, y_,
                                                                   with_slopes=True), (X, y))
        out["k2_slope_ms"][case] = {"X": list(X.shape), "G": len(spec.grid), "ms": turns,
                                    "same_bits": same, "host_ms": host}
        print(f"K2 slope mode {case} (X {tuple(X.shape)}, G {len(spec.grid)}), ms a launch in "
              "turns: " + ", ".join(f"{lb} {' / '.join(f'{t:.4f}' for t in ts)}"
                                    for lb, ts in turns.items())
              + f"; outputs the same bits as {next(iter(results))}'s: {same}; host ms a call "
              "in turns: " + ", ".join(f"{lb} {' / '.join(f'{t:.4f}' for t in ts)}"
                                       for lb, ts in host.items()), flush=True)
    try:
        out["k2_slope_sass"] = k2_slope_sass(k2_builds)
        print("K2 slope-mode kernels of four sims a warp, SASS instructions (the same as the "
              f"first build's): {out['k2_slope_sass']}", flush=True)
    except (OSError, ValueError, subprocess.SubprocessError) as err:  # no cuobjdump
        print(f"K2 SASS not compared: {err}", flush=True)

    (REPO / "chiprun_out").mkdir(exist_ok=True)
    (REPO / "chiprun_out" / "k9_profile.json").write_text(json.dumps(out, indent=1))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
