#!/usr/bin/env python3
"""Launch times and cycle breakdown of kernel K11 (the LMM fit with extra
groupings) on one card.

    python3 chip_k11_profile.py [LABEL=CSRC ...]

Each ``LABEL=CSRC`` names a ``csrc`` directory (default: this tree's, as
``this``); the parent commit's, say, after ``git archive <commit>
mcpower_tpu_torch/csrc | tar -x -C _parent`` (``_parent/`` is gitignored).
At the lmm_extras arm's cells and at a launch of each of the crossed, nested
and dense extras flows (``chip_smoke.K11_FLOW_CASES``: 1,250 sims, one grid
point; statistics from the port's plain generator and K2's plain joint sums
on the card):

1. the launch time of each build: device time by CUDA events, the median of
   3 launches after a warm-up, the builds in turns (first, second, ...,
   second, first), and whether every output has the first build's bits;
2. the cycle breakdown: the source built again with ``-DMCP_K11_CLOCKS=N``,
   under which lane 0 of each warp adds ``clock64()`` deltas by region into
   a device array, one row a cell (a source without those hooks, K11's first
   version's, gets them inserted at the fixed anchors of
   ``FIRST_VERSION_PROBES``); one launch, and the mean warp-cycles a cell by
   region (the sums over a cell's warps): the whole kernel; in the f32
   search, the capacitance (forming C or S, its factor and logs; the
   forming and the Cholesky alone as parts of it), its solves, the X'V^-1X
   tail with its p x p factor; thread 0's simplex steps, the waits at the
   search's barriers, the twin's staging and the f64 refit (its evaluation
   included).

Where a build has ``mcp_joint_reml_geometry`` (the redesigned launcher), its
form, resident cells an SM and waves are printed too. Prints the card's name
and power limit first, and writes the numbers to
``chiprun_out/k11_profile.json``. It imports nothing of JAX. The functions
below ``main``'s helpers serve ``chip_k10_profile.py`` too.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent
CLOCK_SLOTS = 12
MAX_CLOCK_CELLS = 2048
REGIONS = ["total", "forming C or S", "X'V^-1X tail and p x p factor", "twin staging",
           "capacitance (forming, factor, logs)", "capacitance solves", "simplex steps",
           "waits at barriers", "f64 refit", "-", "-", "of which the Cholesky"]
PART_OF = {"forming C or S": "capacitance (forming, factor, logs)",
           "of which the Cholesky": "capacitance (forming, factor, logs)"}
CASES = ("lmm_extras", "crossed_flow_launch", "nested_flow_launch", "dense_flow_launch")

# Clock hooks for K11's first version (joint_reml.cu and the capacitance
# hooks joint_cap.cuh already has for K12), as (file, anchor, replacement).
FIRST_VERSION_PROBES = [
    ("joint_cap.cuh", "#include <math.h>\n",
     "#include <math.h>\n#if defined(MCP_K11_CLOCKS) && !defined(MCP_K12_CLOCKS)\n"
     "#define MCP_K12_CLOCKS MCP_K11_CLOCKS\n#endif\n"),
    ("joint_cap.cuh", "        K12_T0(clk_c);\n        chol_auto(mat, n, n >= VEC_FROM, lane, ld);\n",
     "        K12_ADD32(1, clk_f);\n"
     "        K12_T0(clk_c);\n        chol_auto(mat, n, n >= VEC_FROM, lane, ld);\n"),
    ("joint_cap.cuh", "        K12_T0(clk_c);\n        chol_blocked(mat, n, ld, lane);\n",
     "        K12_ADD32(1, clk_f);\n        K12_T0(clk_c);\n        chol_blocked(mat, n, ld, lane);\n"),
    ("joint_reml.cu", "    const long long cell = blockIdx.x;\n    const int D = a.d;\n",
     "    const long long cell = blockIdx.x;\n    const int D = a.d;\n    K12_T0(clk_all);\n"),
    ("joint_reml.cu", "    if (a.staged) {  // the f32 twin of ztz and [zty | ztx], cast once\n",
     "    K12_T0(clk_tw);\n"
     "    if (a.staged) {  // the f32 twin of ztz and [zty | ztx], cast once\n"),
    ("joint_reml.cu", "    for (int col = lane; col < a.M; col += WARP) {  // the column table\n",
     "    K12_ADD(3, clk_tw);\n"
     "    for (int col = lane; col < a.M; col += WARP) {  // the column table\n"),
    ("joint_reml.cu",
     "    const T logdet_v = capacitance(a, S, th, c, sm, lay, a.structured != 0, true, lane);\n",
     "    const T logdet_v = capacitance(a, S, th, c, sm, lay, a.structured != 0, true, lane);\n"
     "    K12_T0(clk_t);\n"),
    ("joint_reml.cu", "    __syncwarp();\n    return dev;\n}\n",
     "    __syncwarp();\n    K12_ADD32(2, clk_t);\n    return dev;\n}\n"),
    ("joint_reml.cu",
     "            if (lane == 0) mcp::nm_candidates(a.lower, S, D);\n            __syncwarp();\n",
     "            K12_T0(clk_n0);\n            if (lane == 0) mcp::nm_candidates(a.lower, S, D);\n"
     "            __syncwarp();\n            K12_ADD(6, clk_n0);\n"),
    ("joint_reml.cu",
     "            if (lane == 0) mcp::nm_select_and_replace(S, D);\n            __syncwarp();\n",
     "            K12_T0(clk_n1);\n            if (lane == 0) mcp::nm_select_and_replace(S, D);\n"
     "            __syncwarp();\n            K12_ADD(6, clk_n1);\n"),
    ("joint_reml.cu",
     "                if (lane == 0) S.fc[k] = isfinite(dv) ? (double)dv : (double)SENTINEL32;\n"
     "                __syncwarp();\n",
     "                if (lane == 0) S.fc[k] = isfinite(dv) ? (double)dv : (double)SENTINEL32;\n"
     "                K12_T0(clk_b);\n                __syncwarp();\n                K12_ADD(7, clk_b);\n"),
    ("joint_reml.cu", "    // the f64 refit at the optimum\n",
     "    K12_T0(clk_r);\n    // the f64 refit at the optimum\n"),
    ("joint_reml.cu",
     "            for (int k = 0; k < D; ++k) a.theta_out[cell * D + k] = S.theta[k];\n    }\n}\n",
     "            for (int k = 0; k < D; ++k) a.theta_out[cell * D + k] = S.theta[k];\n    }\n"
     "    K12_ADD(8, clk_r);\n    K12_ADD(0, clk_all);\n}\n"),
]
FIRST_VERSION_TAIL = r'''
#ifdef MCP_K11_CLOCKS
extern "C" int mcp_k11_clocks(void* dst, int zero) {
    if (zero) {
        void* p = nullptr;
        int err = (int)cudaGetSymbolAddress(&p, mcp_k12_clk);
        return err ? err : (int)cudaMemset(p, 0, sizeof(mcp_k12_clk));
    }
    return (int)cudaMemcpyFromSymbol(dst, mcp_k12_clk, sizeof(mcp_k12_clk));
}
#endif
'''


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def instrumented_csrc(csrc: Path, out: Path, source: str, macro: str, probes, tail: str) -> Path:
    """``csrc`` copied to ``out``, the kernel ``source`` given its clock
    hooks where it has none (by ``probes``: (file, anchor, replacement),
    each anchor found exactly once, then ``tail`` appended to ``source``)."""
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(csrc, out)
    if macro in (out / source).read_text():
        return out
    files = sorted({f for f, _, _ in probes})
    texts = {f: (out / f).read_text() for f in files}
    for f, anchor, replacement in probes:
        if texts[f].count(anchor) != 1:
            raise SystemExit(f"{source}: anchor found {texts[f].count(anchor)} times in {f}: "
                             f"{anchor!r}")
        texts[f] = texts[f].replace(anchor, replacement, 1)
    texts[source] += tail
    for f, text in texts.items():
        (out / f).write_text(text)
    return out


def build_pairs(kernels, specs, name: str, source: str, macro: str, probes, tail: str):
    """For each ``LABEL=CSRC`` of ``specs``: the kernel built from that
    source, and again with its clock hooks (``-D<macro>=MAX_CLOCK_CELLS``);
    all nvcc at once. Prints each plain build's ptxas lines."""
    builds = {}
    for spec in specs or [f"this={REPO / 'mcpower_tpu_torch' / 'csrc'}"]:
        label, _, path = spec.partition("=")
        csrc = Path(path).resolve()
        clk = instrumented_csrc(csrc, kernels.BUILD_DIR / f"{name}clk_{label}", source, macro,
                                probes, tail)
        builds[label] = (
            kernels.Kernel(f"{name}_{label}", source, ["--fmad=false"], csrc=csrc),
            kernels.Kernel(f"{name}_clk_{label}", source,
                           ["--fmad=false", f"-D{macro}={MAX_CLOCK_CELLS}"], csrc=clk))
    procs = [(k, k.start_build()) for ks in builds.values() for k in ks]
    for k, p in procs:
        k.finish_build(p)
    for lb, (k, _) in builds.items():
        regs = [line.strip() for line in k.log_path.read_text().splitlines()
                if "registers" in line or "stack frame" in line]
        print(f"ptxas {lb}: " + " | ".join(regs), flush=True)
    return builds


def same_bits(got, want) -> bool:
    """Every output of ``got`` has the bits of ``want``'s (NaN where NaN)."""
    return all(bool(((a == b) | (a.isnan() & b.isnan())).all()) if a.is_floating_point()
               else bool((a == b).all()) for a, b in zip(got, want))


def times_in_turns(runs, args, reps: int = 3):
    """``runs`` (label -> function of ``args``) timed in turns (first,
    second, ..., second, first), each the median of ``reps`` launches by
    CUDA events after one untimed; returns (label -> [ms, ms], label ->
    outputs of its last untimed call)."""
    import torch

    turns = {lb: [] for lb in runs}
    results = {}
    order = list(runs)
    for lb in order + order[::-1]:
        results[lb] = runs[lb](args)
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            runs[lb](args)
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        turns[lb].append(statistics.median(times))
    return turns, results


def clock_means(kc, symbol: str, run, args, cells: int, regions, part_of):
    """One launch of the clock build ``kc`` after a warm-up; the mean
    warp-cycles a cell by region over its first ``cells`` cells, with
    ``other`` the total less every region that is not a part of another."""
    import torch

    fn = kc.fn(symbol, [ctypes.c_void_p, ctypes.c_int])
    cells = min(cells, MAX_CLOCK_CELLS)
    run(args)
    torch.cuda.synchronize()
    kc.check(fn(None, 1))
    run(args)
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (MAX_CLOCK_CELLS * CLOCK_SLOTS))()
    kc.check(fn(ctypes.cast(buf, ctypes.c_void_p), 0))
    mean = {regions[r]: statistics.fmean(buf[c * CLOCK_SLOTS + r] for c in range(cells))
            for r in range(len(regions)) if regions[r] != "-"}
    mean["other"] = mean["total"] - sum(v for k, v in mean.items()
                                        if k != "total" and k not in part_of)
    return mean


def print_clocks(tag: str, mean) -> None:
    print(f"{tag}: " + ", ".join(f"{k} {v:.0f} ({v / mean['total']:.1%})"
                                 for k, v in mean.items() if k != "total")
          + f"; total {mean['total']:.0f}", flush=True)


def k11_case_args(chip_smoke, case: str):
    """K11's arguments at ``case``: the lmm_extras arm's cells or a flow
    launch of K11_FLOW_CASES, from rows made on the card by the plain
    generator and K2's plain joint sums."""
    import torch

    from mcpower_tpu_torch.engine import datagen, lower, olsfit
    from mcpower_tpu_torch.engine.spec import ClusterStatic

    dev = torch.device("cuda")
    if case in chip_smoke.K11_FLOW_CASES:
        flow, sims = chip_smoke.K11_FLOW_CASES[case]
        spec, arr = chip_smoke.flow_lowered(flow)[0]
    else:
        sims = chip_smoke.K11_CHECKS[case]
        spec, arr = chip_smoke.lower_design(lower, ClusterStatic, case)
    ids = torch.arange(sims, dtype=torch.int64, device=dev)
    X, y, _ = datagen.generate_batch(spec, datagen.to_device(arr, dev), chip_smoke.SEED, 0, ids,
                                     plain=True)
    return chip_smoke.k11_args(spec, olsfit.joint_suffstats_plain(spec, X, y)), sims


def k11_launcher(k):
    """A function running K11 build ``k`` on K11's arguments."""
    import chip_smoke
    from mcpower_tpu_torch.engine import kernels, mixedfit

    def run(args):
        with chip_smoke.kernel_swapped(kernels, "joint_reml", k):
            return mixedfit.joint_reml_kernel(*args, with_theta=True)
    return run


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_k11_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from mcpower_tpu_torch.engine import kernels, mixedfit

    smi = card_line()
    print(smi, flush=True)
    builds = build_pairs(kernels, argv, "joint_reml", "joint_reml.cu", "MCP_K11_CLOCKS",
                         FIRST_VERSION_PROBES, FIRST_VERSION_TAIL)
    out = {"card": smi, "launch_ms": {}, "clocks": {}, "geometry": {}}
    for case in CASES:
        args, sims = k11_case_args(chip_smoke, case)
        geo = {}
        for lb, (k, _) in builds.items():
            if "mcp_joint_reml_geometry" in (k.csrc / k.source).read_text():
                with chip_smoke.kernel_swapped(kernels, "joint_reml", k):
                    geo[lb] = mixedfit.joint_reml_geometry(*args)
                print(f"K11 {case} ({lb}): {geo[lb]}", flush=True)
        out["geometry"][case] = geo
        turns, results = times_in_turns({lb: k11_launcher(ks[0]) for lb, ks in builds.items()},
                                        args)
        first = next(iter(results.values()))
        same = {lb: same_bits(r, first) for lb, r in results.items()}
        out["launch_ms"][case] = {"cells": sims, "ms": turns, "same_bits": same}
        print(f"K11 {case} ({sims} cells, M {args[0].shape[-1]}), ms a launch in turns: "
              + ", ".join(f"{lb} {' / '.join(f'{t:.3f}' for t in ts)}" for lb, ts in turns.items())
              + f"; outputs the same bits as {next(iter(results))}'s: {same}", flush=True)
        out["clocks"][case] = {}
        for lb, (_, kc) in builds.items():
            mean = clock_means(kc, "mcp_k11_clocks", k11_launcher(kc), args, sims, REGIONS,
                               PART_OF)
            out["clocks"][case][lb] = mean
            print_clocks(f"K11 warp-cycles a cell, {case} ({lb})", mean)

    (REPO / "chiprun_out").mkdir(exist_ok=True)
    (REPO / "chiprun_out" / "k11_profile.json").write_text(json.dumps(out, indent=1))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
