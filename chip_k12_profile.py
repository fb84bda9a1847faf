#!/usr/bin/env python3
"""Launch times and cycle breakdown of kernel K12 (the GLMM fit with extra
groupings) on one card.

    python3 chip_k12_profile.py [LABEL=CSRC ...]

Each ``LABEL=CSRC`` names a ``csrc`` directory (default: this tree's, as
``this``); the parent commit's, say, after ``git archive <commit>
mcpower_tpu_torch/csrc | tar -x -C _parent`` (``_parent/`` is gitignored).
At a launch of each of the crossed, nested and dense GLMM flows
(``chip_smoke.K12_FLOW_CASES``: 1,250 sims, N 480, one grid point; rows from
the port's plain generator on the card):

1. the launch time of each build: device time by CUDA events, the median of
   3 launches after a warm-up, the builds in turns (first, second, ...,
   second, first); a build whose launcher can put the f32 work areas in
   shared memory is timed with them forced into device scratch too, and in
   scratch with their capacitance parts in shared memory;
2. the cycle breakdown: the source built again with ``-DMCP_K12_CLOCKS=N``,
   under which lane 0 of each warp adds ``clock64()`` deltas by region into
   a device array, one row a cell (a source without those hooks, K12's first
   version's, gets them inserted at the fixed anchors of
   ``FIRST_VERSION_PROBES``); one launch,
   and the mean warp-cycles a cell by region (the four warps' sums): the
   whole kernel, then the f32 search's pass phases (the primary levels' row
   walk, the extras levels' row walk, the mirror and the whole-row sums,
   the capacitance's factor with its forming and its logs, its solves, the
   p x p Schur step), thread 0's simplex steps, the waits at the search's
   barriers, the f64 fit (its passes included) and the Hessian's stencil
   passes; and the factor's Cholesky alone (a part of the factor, the
   redesigned source's hooks only).

Where a build has ``mcp_glmm_extras_geometry`` (the redesigned launcher),
the form it chose for each launch (work areas in shared memory or in device
scratch) and its resident cells an SM are printed too. Prints the card's
name and power limit first, and writes the numbers to
``chiprun_out/k12_profile.json``. It imports nothing of JAX.
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
REGIONS = ["total", "primary rows", "extras rows", "mirror and combine", "capacitance factor",
           "capacitance solves", "p x p Schur", "simplex steps", "barrier waits", "f64 fit",
           "Hessian", "of which the Cholesky"]
# slot 11 is a part of slot 4 (the redesigned source's hooks only)
PART_OF = {"of which the Cholesky": "capacitance factor"}
CLOCK_SLOTS = 12
MAX_CLOCK_CELLS = 2048
FLOWS = ("glmm_crossed_flow_launch", "glmm_nested_flow_launch", "glmm_dense_flow_launch")

# Clock hooks for the first version's joint_cap.cuh and glmm_extras.cu, as (file, anchor,
# its replacement); the macros are those the redesigned source defines in
# joint_cap.cuh.
CLOCK_HEAD = r'''#ifdef MCP_K12_CLOCKS
__device__ unsigned long long mcp_k12_clk[MCP_K12_CLOCKS * 12];
#define K12_T0(v) long long v = clock64()
#define K12_RE(v) v = clock64()
#define K12_ADD(k, v) do { if (threadIdx.x % 32 == 0 && blockIdx.x < MCP_K12_CLOCKS) \
    atomicAdd(&mcp_k12_clk[(long long)blockIdx.x * 12 + (k)], \
              (unsigned long long)(clock64() - (v))); } while (0)
#define K12_ADD32(k, v) do { if (sizeof(T) == 4) K12_ADD(k, v); } while (0)
#else
#define K12_T0(v)
#define K12_RE(v)
#define K12_ADD(k, v)
#define K12_ADD32(k, v)
#endif
'''
CLOCK_TAIL = r'''
#ifdef MCP_K12_CLOCKS
extern "C" int mcp_k12_clocks(void* dst, int zero) {
    if (zero) {
        void* p = nullptr;
        int err = (int)cudaGetSymbolAddress(&p, mcp_k12_clk);
        return err ? err : (int)cudaMemset(p, 0, sizeof(mcp_k12_clk));
    }
    return (int)cudaMemcpyFromSymbol(dst, mcp_k12_clk, sizeof(mcp_k12_clk));
}
#endif
'''
FIRST_VERSION_PROBES = [
    ("joint_cap.cuh", "namespace mcp {\nnamespace jcap {\n",
     CLOCK_HEAD + "namespace mcp {\nnamespace jcap {\n"),
    ("joint_cap.cuh", "    T logdet_v;\n    if (structured) {\n",
     "    K12_T0(clk_f);\n    K12_T0(clk_v);\n    K12_T0(clk_l);\n    T logdet_v;\n"
     "    if (structured) {\n"),
    ("joint_cap.cuh", "        chol_auto(mat, n, n >= VEC_FROM, lane);\n        if (solve) {\n",
     "        chol_auto(mat, n, n >= VEC_FROM, lane);\n        K12_ADD32(4, clk_f);\n"
     "        K12_RE(clk_v);\n        if (solve) {\n"),
    ("joint_cap.cuh", "        T* logs = sm + lay.logs();  // log a, then the factor's log pivots\n",
     "        K12_ADD32(5, clk_v);\n        K12_RE(clk_l);\n"
     "        T* logs = sm + lay.logs();  // log a, then the factor's log pivots\n"),
    ("joint_cap.cuh", "        chol_blocked(mat, n, lane);\n        if (solve) {\n",
     "        chol_blocked(mat, n, lane);\n        K12_ADD32(4, clk_f);\n        K12_RE(clk_v);\n"
     "        if (solve) {\n"),
    ("joint_cap.cuh", "        T* logs = sm + lay.logs();  // the factor's log pivots\n",
     "        K12_ADD32(5, clk_v);\n        K12_RE(clk_l);\n"
     "        T* logs = sm + lay.logs();  // the factor's log pivots\n"),
    ("joint_cap.cuh", "    __syncwarp();\n    return logdet_v;\n",
     "    __syncwarp();\n    K12_ADD32(4, clk_l);\n    return logdet_v;\n"),
    ("glmm_extras.cu", "    // u = Lam v: column (g, level, i) sums v(g, level, k) Lg[i][k] from k = 0\n",
     "    K12_T0(clk_p);\n"
     "    // u = Lam v: column (g, level, i) sums v(g, level, k) Lg[i][k] from k = 0\n"),
    ("glmm_extras.cu", "    // the extras levels, from the kept row quantities\n",
     "    K12_ADD32(1, clk_p);\n    K12_T0(clk_e);\n"
     "    // the extras levels, from the kept row quantities\n"),
    ("glmm_extras.cu", "    // the blocks between groupings, mirrored: a row a lane, its columns in\n",
     "    K12_ADD32(2, clk_e);\n    K12_T0(clk_m);\n"
     "    // the blocks between groupings, mirrored: a row a lane, its columns in\n"),
    ("glmm_extras.cu", "    // the capacitance of Z'WZ and its solve of the right-hand sides\n",
     "    K12_ADD32(3, clk_m);\n"
     "    // the capacitance of Z'WZ and its solve of the right-hand sides\n"),
    ("glmm_extras.cu",
     "    const T logdet = capacitance(a, S, th, src, cw, lay, structured, kind != K_TAIL, lane);\n",
     "    const T logdet = capacitance(a, S, th, src, cw, lay, structured, kind != K_TAIL, lane);\n"
     "    K12_T0(clk_s);\n"),
    ("glmm_extras.cu", "        return lap;\n", "        K12_ADD32(6, clk_s);\n        return lap;\n"),
    ("glmm_extras.cu",
     "        __syncwarp();\n        return T(0);\n    }\n    // the Schur system, beta and v\n",
     "        __syncwarp();\n        K12_ADD32(6, clk_s);\n        return T(0);\n    }\n"
     "    // the Schur system, beta and v\n"),
    ("glmm_extras.cu", "    __syncwarp();\n    return T(0);\n}\n\n// `steps` passes",
     "    __syncwarp();\n    K12_ADD32(6, clk_s);\n    return T(0);\n}\n\n// `steps` passes"),
    ("glmm_extras.cu",
     "    const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP, t = threadIdx.x;\n",
     "    const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP, t = threadIdx.x;\n"
     "    K12_T0(clk_all);\n"),
    ("glmm_extras.cu",
     "                if (lane == 0) S.fc[warp] = isfinite(lap) ? (double)lap : SENTINEL;\n"
     "            }\n            __syncthreads();\n",
     "                if (lane == 0) S.fc[warp] = isfinite(lap) ? (double)lap : SENTINEL;\n"
     "            }\n            K12_T0(clk_b0);\n            __syncthreads();\n"
     "            K12_ADD(8, clk_b0);\n"),
    ("glmm_extras.cu",
     "            if (t == 0) mcp::nm_candidates(a.lower, S, D);\n            __syncthreads();\n",
     "            K12_T0(clk_n0);\n            if (t == 0) mcp::nm_candidates(a.lower, S, D);\n"
     "            K12_ADD(7, clk_n0);\n            K12_T0(clk_b1);\n            __syncthreads();\n"
     "            K12_ADD(8, clk_b1);\n"),
    ("glmm_extras.cu",
     "            if (lane == 0) S.fc[warp] = isfinite(lap) ? (double)lap : SENTINEL;\n"
     "            __syncthreads();\n"
     "            if (t == 0) S.src = mcp::nm_select_and_replace(S, D);\n            __syncthreads();\n",
     "            if (lane == 0) S.fc[warp] = isfinite(lap) ? (double)lap : SENTINEL;\n"
     "            K12_T0(clk_b2);\n            __syncthreads();\n            K12_ADD(8, clk_b2);\n"
     "            K12_T0(clk_n1);\n"
     "            if (t == 0) S.src = mcp::nm_select_and_replace(S, D);\n"
     "            K12_ADD(7, clk_n1);\n            K12_T0(clk_b3);\n            __syncthreads();\n"
     "            K12_ADD(8, clk_b3);\n"),
    ("glmm_extras.cu", "    // the cold f64 fit at the optimum (warp 0); the outcome's row sum\n",
     "    K12_T0(clk_d);\n"
     "    // the cold f64 fit at the optimum (warp 0); the outcome's row sum\n"),
    ("glmm_extras.cu",
     "            for (int k = 0; k < p; ++k) S.fin_beta[k] = wd[wl.bt + k];\n        }\n    }\n",
     "            for (int k = 0; k < p; ++k) S.fin_beta[k] = wd[wl.bt + k];\n        }\n    }\n"
     "    K12_ADD(9, clk_d);\n"),
    ("glmm_extras.cu", "    const int nv = a.hessian ? 1 + 2 * p + 2 * p * (p - 1) : 0;\n",
     "    const int nv = a.hessian ? 1 + 2 * p + 2 * p * (p - 1) : 0;\n    K12_T0(clk_h);\n"),
    ("glmm_extras.cu", "        if (lane == 0) S.hv[e] = hv;\n    }\n",
     "        if (lane == 0) S.hv[e] = hv;\n    }\n    K12_ADD(10, clk_h);\n"),
    ("glmm_extras.cu", "    if (warp != 0) return;\n",
     "    K12_ADD(0, clk_all);\n    if (warp != 0) return;\n"),
]


def instrumented_csrc(csrc: Path, out: Path) -> Path:
    """``csrc`` copied to ``out``, its K12 sources given the clock hooks
    where they have none (the first version's, by FIRST_VERSION_PROBES)."""
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(csrc, out)
    if "MCP_K12_CLOCKS" in (out / "glmm_extras.cu").read_text():
        return out
    texts = {f: (out / f).read_text() for f in ("joint_cap.cuh", "glmm_extras.cu")}
    for f, anchor, replacement in FIRST_VERSION_PROBES:
        if texts[f].count(anchor) != 1:
            raise SystemExit(f"chip_k12_profile: anchor found {texts[f].count(anchor)} times in "
                             f"{f}: {anchor!r}")
        texts[f] = texts[f].replace(anchor, replacement, 1)
    texts["glmm_extras.cu"] += CLOCK_TAIL
    for f, text in texts.items():
        (out / f).write_text(text)
    return out


def launcher(k, form: int = 0):
    """A function running K12 build ``k`` on K12's arguments; a nonzero
    ``form`` forces where the f32 work areas live (2 device scratch, 3
    scratch with their capacitance parts in shared memory; a build with
    ``mcp_glmm_extras_set_form``)."""
    import chip_smoke
    from mcpower_tpu_torch.engine import glmmfit, kernels

    def run(args):
        with chip_smoke.kernel_swapped(kernels, "glmm_extras", k):
            if form:
                glmmfit.glmm_extras_set_form(form)
            try:
                return glmmfit.glmm_extras_kernel(*args)
            finally:
                if form:
                    glmmfit.glmm_extras_set_form(0)
    return run


def geometry(k, args):
    """The form and residency build ``k``'s launcher picks for ``args``, or
    None where the build has no geometry entry (the first version's)."""
    import chip_smoke
    from mcpower_tpu_torch.engine import glmmfit, kernels

    if "mcp_glmm_extras_geometry" not in (k.csrc / k.source).read_text():
        return None
    with chip_smoke.kernel_swapped(kernels, "glmm_extras", k):
        return glmmfit.glmm_extras_geometry(*args)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_k12_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from mcpower_tpu_torch.engine import datagen, kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    builds = {}
    for spec in argv or [f"this={REPO / 'mcpower_tpu_torch' / 'csrc'}"]:
        label, _, path = spec.partition("=")
        csrc = Path(path).resolve()
        clk = instrumented_csrc(csrc, kernels.BUILD_DIR / f"k12clk_{label}")
        builds[label] = (
            kernels.Kernel(f"glmm_extras_{label}", "glmm_extras.cu", ["--fmad=false"], csrc=csrc),
            kernels.Kernel(f"glmm_extras_clk_{label}", "glmm_extras.cu",
                           ["--fmad=false", f"-DMCP_K12_CLOCKS={MAX_CLOCK_CELLS}"], csrc=clk))
    procs = [(k, k.start_build()) for ks in builds.values() for k in ks]
    for k, p in procs:
        k.finish_build(p)
    for lb, (k, _) in builds.items():
        regs = [line.strip() for line in k.log_path.read_text().splitlines()
                if "registers" in line or "stack frame" in line]
        print(f"ptxas {lb}: " + " | ".join(regs), flush=True)

    dev = torch.device("cuda")
    out = {"card": smi, "launch_ms": {}, "clocks": {}, "geometry": {}}
    for case in FLOWS:
        flow, sims = chip_smoke.K12_FLOW_CASES[case]
        spec, arr = chip_smoke.flow_lowered(flow)[0]
        arr_d = datagen.to_device(arr, dev)
        ids = torch.arange(sims, dtype=torch.int64, device=dev)
        X, y, _ = datagen.generate_batch(spec, arr_d, chip_smoke.SEED, 0, ids, plain=True)
        args = chip_smoke.k12_args(spec, arr_d, X, y)
        out["geometry"][case] = {lb: geometry(ks[0], args) for lb, ks in builds.items()}
        for lb, g in out["geometry"][case].items():
            if g is not None:
                print(f"K12 {case} ({lb}): {g}", flush=True)
        # a build with several forms is timed in each (its launcher's pick,
        # then the f32 areas forced into device scratch, then in scratch with
        # their capacitance parts in shared memory)
        forms = [(lb, 0) for lb in builds] + [
            (f"{lb} ({name})", form) for lb in builds if out["geometry"][case][lb]
            for name, form in (("scratch form", 2), ("capacitance in shared memory", 3))]
        turns = {lb: [] for lb, _ in forms}
        results = {}
        for lb, form in forms + forms[::-1]:
            base = lb.split()[0]
            run = launcher(builds[base][0], form)
            results[lb] = run(args)
            torch.cuda.synchronize()
            times = []
            for _ in range(3):
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                run(args)
                e1.record()
                torch.cuda.synchronize()
                times.append(e0.elapsed_time(e1))
            turns[lb].append(statistics.median(times))
        first = next(iter(results.values()))
        same = {lb: all(bool(((a == b) | (a.isnan() & b.isnan())).all()) if a.is_floating_point()
                        else bool((a == b).all()) for a, b in zip(r, first))
                for lb, r in results.items()}
        out["launch_ms"][case] = {"cells": sims, "ms": turns, "same_bits": same}
        print(f"K12 {case} ({sims} cells, N {spec.max_n}), ms a launch in turns: " + ", ".join(
            f"{lb} {' / '.join(f'{t:.3f}' for t in ts)}" for lb, ts in turns.items())
            + f"; outputs the same bits as {next(iter(results))}'s: {same}", flush=True)

        out["clocks"][case] = {}
        for lb, (_, kc) in builds.items():
            fn = kc.fn("mcp_k12_clocks", [ctypes.c_void_p, ctypes.c_int])
            cells = min(sims, MAX_CLOCK_CELLS)
            launcher(kc)(args)  # warm-up
            torch.cuda.synchronize()
            kc.check(fn(None, 1))
            launcher(kc)(args)
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * (MAX_CLOCK_CELLS * CLOCK_SLOTS))()
            kc.check(fn(ctypes.cast(buf, ctypes.c_void_p), 0))
            mean = {REGIONS[r]: statistics.fmean(buf[c * CLOCK_SLOTS + r] for c in range(cells))
                    for r in range(len(REGIONS))}
            # the f64 fit and the Hessian hold passes of their own, which
            # the pass regions (f32 only) leave out
            mean["other"] = mean["total"] - sum(v for k, v in mean.items()
                                                if k != "total" and k not in PART_OF)
            out["clocks"][case][lb] = mean
            print(f"K12 warp-cycles a cell, {case} ({lb}): " + ", ".join(
                f"{k} {v:.0f} ({v / mean['total']:.1%})" for k, v in mean.items()
                if k != "total") + f"; total {mean['total']:.0f}", flush=True)

    (REPO / "chiprun_out").mkdir(exist_ok=True)
    (REPO / "chiprun_out" / "k12_profile.json").write_text(json.dumps(out, indent=1))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
