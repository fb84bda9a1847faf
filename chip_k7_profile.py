#!/usr/bin/env python3
"""Wave curve and cycle breakdown of kernel K7 (the random-intercept GLMM
fit) on one card.

    python3 chip_k7_profile.py [LABEL=CSRC ...]

Each ``LABEL=CSRC`` names a ``csrc`` directory (default: this tree's, as
``this``); the parent commit's, say, after ``git archive <commit>
mcpower_tpu_torch/csrc | tar -x -C _parent`` (``_parent/`` is gitignored).
For each build, at the Laplace arm's design (``chip_smoke.GLMM_DESIGNS
["glmm_laplace"]``: N 200, 20 round-robin clusters, p 3, logit):

1. the wave curve: one launch at 132, 264, 528, 1,056, 2,112 and 4,224
   cells (one cell a sim), device time by CUDA events, the median of 5
   launches after a warm-up, the builds in turns (first, second, ...,
   second, first) at each size;
2. the cycle breakdown: the source built again with ``-DMCP_K7_CLOCKS=N``,
   under which lane 0 of each cell's first warp adds ``clock64()`` deltas
   by region into a device array (a source without those hooks, PR 10's,
   gets them inserted at the fixed anchors of ``PR10_PROBES``); one launch
   at 132 cells (one a SM, no neighbours) and one at 2,000 (the arm), and
   the mean cycles a cell by region: the whole fit, the row walks (row
   phases; PR 10's per-cluster walks, with their cluster sums and scratch
   writes), the warp sums, the p x p solves, the scratch and u-update
   passes, the Brent steps, the waits at the cell's barriers and the
   cluster phases (the redesigned kernel's own).

Prints the card's name and power limit first, and writes the numbers to
``chiprun_out/k7_profile.json``. It imports nothing of JAX.
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
WAVE_CELLS = [132, 264, 528, 1056, 2112, 4224]
CLOCK_CELLS = [132, 2000]
REGIONS = ["total", "row walks", "warp sums", "solve", "scratch and u update", "Brent",
           "barrier waits", "cluster sums"]
CLOCK_SLOTS = 8
MAX_CLOCK_CELLS = 4096

# Clock hooks for PR 10's glmm_intercept.cu, as (anchor, its replacement):
# lane 0 of each warp (a cell) adds clock64() deltas into
# mcp_k7_clk[cell * 8 + region].
_PR10_HEAD = r'''
#ifdef MCP_K7_CLOCKS
__device__ unsigned long long mcp_k7_clk[MCP_K7_CLOCKS * 8];
#define CLK_CELL ((long long)blockIdx.x * 4 + threadIdx.x / 32)
#define CLK_T0(v) long long v = clock64()
#define CLK_ADD(k, v) do { if (threadIdx.x % 32 == 0 && CLK_CELL < MCP_K7_CLOCKS) \
    atomicAdd(&mcp_k7_clk[CLK_CELL * 8 + (k)], (unsigned long long)(clock64() - (v))); } while (0)
#else
#define CLK_T0(v)
#define CLK_ADD(k, v)
#endif
'''
_PR10_TAIL = r'''
#ifdef MCP_K7_CLOCKS
extern "C" int mcp_k7_clocks(void* dst, int zero) {
    if (zero) {
        void* p = nullptr;
        int err = (int)cudaGetSymbolAddress(&p, mcp_k7_clk);
        return err ? err : (int)cudaMemset(p, 0, sizeof(mcp_k7_clk));
    }
    return (int)cudaMemcpyFromSymbol(dst, mcp_k7_clk, sizeof(mcp_k7_clk));
}
#endif
'''
PR10_PROBES = [
    ('namespace {\n', _PR10_HEAD + 'namespace {\n'),
    ('    for (int j = c.lane; j < a.m; j += WARP) {\n        double* cl = c.ws + (long long)j * c.sl;\n'
     '        const T uj = (T)cl[S_U];',
     'CLK_T0(clk_r);\n    for (int j = c.lane; j < a.m; j += WARP) {\n'
     '        double* cl = c.ws + (long long)j * c.sl;\n        const T uj = (T)cl[S_U];'),
    ('    T L[NT], rhs[PB];', 'CLK_ADD(1, clk_r); CLK_T0(clk_w);\n    T L[NT], rhs[PB];'),
    ('    pad_identity<PB, T>(a, L);', 'CLK_ADD(2, clk_w); CLK_T0(clk_s);\n    pad_identity<PB, T>(a, L);'),
    ('    bool lane_ok = true;', 'CLK_ADD(3, clk_s); CLK_T0(clk_u);\n    bool lane_ok = true;'),
    ('    return __all_sync(FULL, ok && lane_ok);',
     '    const bool all_ok = __all_sync(FULL, ok && lane_ok);\n    CLK_ADD(4, clk_u);\n    return all_ok;'),
    ('            if (i < a.pf) beta[i] = bn[i];\n',
     '            if (i < a.pf) beta[i] = bn[i];\n        CLK_T0(clk_c);\n'),
    ('            cl[S_U] = cl[S_UNEW];\n        }\n',
     '            cl[S_U] = cl[S_UNEW];\n        }\n        CLK_ADD(4, clk_c);\n'),
    ('    tail<PB>(a, c, b64, tau2, dt, u2, l1p);',
     '    CLK_T0(clk_t);\n    tail<PB>(a, c, b64, tau2, dt, u2, l1p);\n    CLK_ADD(1, clk_t);'),
    ('    return a.nagq > 1 ? agq_deviance<PB>(a, c, tau2, beta) : lap;',
     '    CLK_T0(clk_q);\n    const double dq = a.nagq > 1 ? agq_deviance<PB>(a, c, tau2, beta) : lap;\n'
     '    CLK_ADD(1, clk_q);\n    return dq;'),
    ('    return agq_deviance_hybrid<PB>(a, c, tau2, b64);',
     '    CLK_T0(clk_q);\n    const double dq = agq_deviance_hybrid<PB>(a, c, tau2, b64);\n'
     '    CLK_ADD(1, clk_q);\n    return dq;'),
    ('    // 1. the cold f64 evaluation from beta0, u = 0',
     '    CLK_T0(clk_all);\n    // 1. the cold f64 evaluation from beta0, u = 0'),
    ('        const double xm = 0.5 * (ax + bx);',
     '        CLK_T0(clk_b);\n        const double xm = 0.5 * (ax + bx);'),
    ('        const double fu = dev_at32<PB>(', '        CLK_ADD(5, clk_b);\n        const double fu = dev_at32<PB>('),
    ('        const bool better = fu <= fx;', '        CLK_T0(clk_b2);\n        const bool better = fu <= fx;'),
    ('        e = e2;\n    }\n', '        e = e2;\n        CLK_ADD(5, clk_b2);\n    }\n'),
    ('    if (c.lane == 0) {\n#pragma unroll\n        for (int k = 0; k < PB; ++k) {\n'
     '            if (k >= p) continue;\n            a.beta[',
     '    CLK_ADD(0, clk_all);\n    if (c.lane == 0) {\n#pragma unroll\n        for (int k = 0; k < PB; ++k) {\n'
     '            if (k >= p) continue;\n            a.beta['),
]


def instrumented_csrc(csrc: Path, out: Path) -> Path:
    """``csrc`` copied to ``out``, its glmm_intercept.cu given the clock
    hooks where it has none (PR 10's source, by PR10_PROBES)."""
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(csrc, out)
    src = out / "glmm_intercept.cu"
    text = src.read_text()
    if "MCP_K7_CLOCKS" in text:
        return out
    for anchor, replacement in PR10_PROBES:
        if text.count(anchor) != 1:
            raise SystemExit(f"chip_k7_profile: anchor found {text.count(anchor)} times: {anchor!r}")
        text = text.replace(anchor, replacement, 1)
    src.write_text(text + _PR10_TAIL)
    return out


def launcher(k):
    """A function running K7 ``k`` on args; PR 10's C entry takes its
    scratch from the caller, this tree's wrapper sizes its own."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from mcpower_tpu_torch.engine import glmmfit, kernels

    def run(args):
        with chip_smoke.kernel_swapped(kernels, "glmm_intercept", k):
            if chip_smoke.k7_is_pr10(k):
                return chip_smoke.k7_pr10_call(k, *args)
            return glmmfit.glmm_intercept_kernel(*args)
    return run


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_k7_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from mcpower_tpu_torch.engine import datagen, kernels, lower
    from mcpower_tpu_torch.engine.spec import ClusterStatic

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    builds = {}
    for spec in argv or [f"this={REPO / 'mcpower_tpu_torch' / 'csrc'}"]:
        label, _, path = spec.partition("=")
        csrc = Path(path).resolve()
        clk = instrumented_csrc(csrc, kernels.BUILD_DIR / f"k7clk_{label}")
        builds[label] = (
            kernels.Kernel(f"glmm_intercept_{label}", "glmm_intercept.cu", ["--fmad=false"], csrc=csrc),
            kernels.Kernel(f"glmm_intercept_clk_{label}", "glmm_intercept.cu",
                           ["--fmad=false", f"-DMCP_K7_CLOCKS={MAX_CLOCK_CELLS}"], csrc=clk))
    procs = [(k, k.start_build()) for ks in builds.values() for k in ks]
    for k, p in procs:
        k.finish_build(p)

    dev = torch.device("cuda")
    spec, arr = chip_smoke.lower_design(lower, ClusterStatic, "glmm_laplace")
    arr_d = datagen.to_device(arr, dev)
    most = max(WAVE_CELLS + CLOCK_CELLS)
    ids = torch.arange(most, dtype=torch.int64, device=dev)
    X, y, _ = datagen.generate_batch(spec, arr_d, chip_smoke.SEED, 0, ids, plain=True)
    full = chip_smoke.k7_args(spec, arr_d, X, y)

    def at(n):
        return full[:1] + (full[1][:n].contiguous(), full[2][:n].contiguous()) + full[3:]

    out = {"card": smi, "wave_curve_ms": {}, "clocks": {}}
    order = list(builds) + list(builds)[::-1]
    for n in WAVE_CELLS:
        args = at(n)
        turns = {lb: [] for lb in builds}
        for lb in order:
            run = launcher(builds[lb][0])
            run(args)
            torch.cuda.synchronize()
            times = []
            for _ in range(5):
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                run(args)
                e1.record()
                torch.cuda.synchronize()
                times.append(e0.elapsed_time(e1))
            turns[lb].append(statistics.median(times))
        out["wave_curve_ms"][n] = {lb: t for lb, t in turns.items()}
        print(f"K7 wave curve, Laplace arm design, {n} cells: " + ", ".join(
            f"{lb} {' / '.join(f'{t:.4f}' for t in ts)} ms" for lb, ts in turns.items()), flush=True)

    for lb, (_, kc) in builds.items():
        fn = kc.fn("mcp_k7_clocks", [ctypes.c_void_p, ctypes.c_int])
        out["clocks"][lb] = {}
        for n in CLOCK_CELLS:
            args = at(n)
            launcher(kc)(args)  # warm-up
            torch.cuda.synchronize()
            kc.check(fn(None, 1))
            launcher(kc)(args)
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * (MAX_CLOCK_CELLS * CLOCK_SLOTS))()
            kc.check(fn(ctypes.cast(buf, ctypes.c_void_p), 0))
            per = [[buf[c * CLOCK_SLOTS + r] for c in range(n)] for r in range(CLOCK_SLOTS)]
            mean = {REGIONS[r]: statistics.fmean(per[r]) for r in range(CLOCK_SLOTS)}
            mean["other"] = mean["total"] - sum(v for k, v in mean.items() if k != "total")
            out["clocks"][lb][n] = mean
            print(f"K7 cycles a cell ({lb}, {n} cells): " + ", ".join(
                f"{k} {v:.0f} ({v / mean['total']:.1%})" for k, v in mean.items()
                if k != "total") + f"; total {mean['total']:.0f}", flush=True)

    (REPO / "chiprun_out").mkdir(exist_ok=True)
    (REPO / "chiprun_out" / "k7_profile.json").write_text(json.dumps(out, indent=1))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
