#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mcpower_tpu_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0, no result line):

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build kernels K1-K4 from ``mcpower_tpu_torch/csrc`` (one nvcc per
   source, all started together) and print their register and spill use;
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (10,000 sims; the LMM's N = 200, p = 3, m = 20, G = 1
   and the curve design's p = 7, G = 8);
4. drive the main path through ``lower`` and ``run_batch(device="cuda")``:
   the 10,000-replicate random-intercept LMM headline (base seed 2137), the
   OLS arm and the 8-point power curve, with every kernel's launch count set
   to 0 before and read after; then check 1,024-sim counts against golden
   counts of the JAX reference (at most one flip per entry);
5. time each kernel and each arm, through the kernels and through the plain
   versions on the card;
6. print the ``kernels`` JSON line, then as the last line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

N_SIMS = 10_000
GOLDEN_SIMS = 1_024
SEED = 2137

_CORR5 = (np.full((5, 5), 0.2) + 0.8 * np.eye(5)).tolist()

# The main path's designs (bench.py:90-139): lower() keyword arguments, with
# the cluster given as ClusterStatic fields so either package can build it.
DESIGNS = {
    "lmm_headline": dict(
        grid=[200],
        var_types=["normal", "normal"],
        corr=[[1.0, 0.3], [0.3, 1.0]],
        effects=[0.0, 0.3, 0.2],
        target_cols=[1, 2],
        estimator="mle",
        cluster=dict(sizing_mode="fixed_clusters", sizing_value=20, tau_squared=0.25),
    ),
    "ols_10k": dict(
        grid=[200],
        var_types=["binary"],
        var_params=[0.5],
        effects=[0.0, 0.4],
        target_cols=[1],
    ),
    "curve_5pred_8grid": dict(
        grid=[50, 100, 150, 200, 250, 300, 400, 500],
        var_types=["normal"] * 5,
        corr=_CORR5,
        effects=[0.0, 0.25, 0.2, 0.15, 0.1, 0.1, 0.1],
        target_cols=[1, 2, 3, 4, 5, 6],
        interactions=[(1, 2)],
    ),
}

# Cluster layouts the main path does not reach, held against the plain
# versions in phase 3 only: round-robin and blocked clusters over a two-point
# grid (K2's per-segment cluster ranges, K4's cells at G > 1).
LAYOUT_CHECKS = {
    "lmm_round_robin_2grid": dict(DESIGNS["lmm_headline"], grid=[100, 200]),
    "lmm_blocked_2grid": dict(
        DESIGNS["lmm_headline"], grid=[100, 200],
        cluster=dict(sizing_mode="fixed_size", sizing_value=10, tau_squared=0.25),
    ),
}

# Counts of the JAX reference (mcpower_tpu.engine.batch.run_batch) at
# GOLDEN_SIMS sims, base seed SEED; tests/test_torch_batch.py recomputes
# them so they cannot go stale.
GOLDEN = {
    "lmm_headline": {
        "boundary_hi": [0], "boundary_hit": [5], "converged": [1024],
        "joint_corr": [719], "joint_unc": [719],
        "nsig_hist_corr": [[5, 300, 719]], "nsig_hist_unc": [[5, 300, 719]],
        "pinned_comp": [[5]], "sig_corr": [[994, 744]], "sig_unc": [[994, 744]],
        "tau2_hat": [255.0467965903161], "n_done": 1024,
    },
    "ols_10k": {
        "converged": [1024], "joint_corr": [841], "joint_unc": [841],
        "nsig_hist_corr": [[183, 841]], "nsig_hist_unc": [[183, 841]],
        "sig_corr": [[841]], "sig_unc": [[841]], "n_done": 1024,
    },
    "curve_5pred_8grid": {
        "converged": [1024] * 8,
        "joint_corr": [0, 0, 0, 4, 14, 28, 67, 154],
        "joint_unc": [0, 0, 0, 4, 14, 28, 67, 154],
        "nsig_hist_corr": [
            [335, 447, 195, 41, 6, 0, 0], [70, 366, 382, 170, 32, 4, 0],
            [13, 147, 414, 327, 111, 12, 0], [1, 37, 270, 441, 224, 47, 4],
            [0, 8, 175, 414, 297, 116, 14], [0, 5, 79, 369, 378, 165, 28],
            [0, 0, 20, 211, 382, 344, 67], [0, 0, 5, 106, 345, 414, 154],
        ],
        "nsig_hist_unc": [
            [335, 447, 195, 41, 6, 0, 0], [70, 366, 382, 170, 32, 4, 0],
            [13, 147, 414, 327, 111, 12, 0], [1, 37, 270, 441, 224, 47, 4],
            [0, 8, 175, 414, 297, 116, 14], [0, 5, 79, 369, 378, 165, 28],
            [0, 0, 20, 211, 382, 344, 67], [0, 0, 5, 106, 345, 414, 154],
        ],
        "sig_corr": [
            [335, 219, 147, 91, 92, 100], [637, 450, 258, 145, 142, 156],
            [841, 622, 376, 188, 189, 244], [936, 766, 517, 254, 268, 314],
            [987, 857, 595, 317, 329, 367], [1005, 914, 665, 391, 380, 420],
            [1019, 976, 811, 486, 492, 539], [1023, 1006, 895, 579, 569, 630],
        ],
        "sig_unc": [
            [335, 219, 147, 91, 92, 100], [637, 450, 258, 145, 142, 156],
            [841, 622, 376, 188, 189, 244], [936, 766, 517, 254, 268, 314],
            [987, 857, 595, 317, 329, 367], [1005, 914, 665, 391, 380, 420],
            [1019, 976, 811, 486, 492, 539], [1023, 1006, 895, 579, 569, 630],
        ],
        "n_done": 1024,
    },
}
# The f32 generation path's log may differ by an ULP between XLA:CPU and
# CUDA, which can move a statistic sitting on its threshold: allow one flip
# per count entry, and this relative band on the tau^2 sum.
MAX_FLIPS = 1
TAU2_REL = 2e-3

# Kernel tolerances on the card, against the plain versions on the same
# inputs. Relative errors are max |kernel - plain| / max |plain| per output.
K2_REL = 1e-12  # f64 sums in another order
K3_REL = 1e-10  # f64 solve, same operation order except sums
K4_REL = 1e-7  # 20-step search whose last steps are decided by rounding
NORMAL_MAX_ULP = 0  # K1 and the plain fill share CUDA's logf: bit-identical

KERNEL_META = {
    "philox_fill": ("mcpower_tpu_torch/csrc/philox_fill.cu", "benchmarks/pallas_datagen.py:78"),
    "grid_suffstats": ("mcpower_tpu_torch/csrc/grid_suffstats.cu", "mcpower_tpu/engine/olsfit.py:41"),
    "ols_solve": ("mcpower_tpu_torch/csrc/ols_solve.cu", "mcpower_tpu/engine/smallchol.py:34"),
    "reml_intercept": ("mcpower_tpu_torch/csrc/reml_intercept.cu", "mcpower_tpu/engine/mixedfit.py:846"),
}


def lower_design(lower_mod, cluster_cls, name: str):
    """``lower_mod.lower`` on design ``name``; works for either package."""
    kw = dict({**DESIGNS, **LAYOUT_CHECKS}[name])
    for key in ("corr", "effects"):
        if key in kw:
            kw[key] = np.asarray(kw[key], dtype=np.float64)
    if "cluster" in kw:
        kw["cluster"] = cluster_cls(**kw["cluster"])
    return lower_mod.lower(**kw)


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def rel_err(a, b) -> float:
    a = a.double()
    b = b.double()
    scale = b.abs().max().item()
    return (a - b).abs().max().item() / (scale if scale > 0 else 1.0)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events, after
    one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _ptxas_summary(log: str) -> str:
    regs = [int(v) for v in re.findall(r"Used (\d+) registers", log)]
    spills = [int(v) for v in re.findall(r"(\d+) bytes spill stores", log)]
    return (f"max registers {max(regs) if regs else 'n/a'}, "
            f"max spill-store bytes {max(spills) if spills else 0}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    from mcpower_tpu_torch.engine import (
        batch, datagen, kernels, lower, mixedfit, olsfit, rng, waldstats,
    )
    from mcpower_tpu_torch.engine.spec import ClusterStatic

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # --- phase 1: the card ---
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # --- phase 2: build ---
    took = kernels.build_all()
    for name, k in kernels.KERNELS.items():
        print(f"built {name}: {took[name]:.1f} s after start; "
              f"{_ptxas_summary(k.log_path.read_text()) if k.log_path.exists() else 'cached'}",
              flush=True)

    # --- phase 3: each kernel against its plain version ---
    specs = {name: lower_design(lower, ClusterStatic, name) for name in DESIGNS}
    arrs = {name: datagen.to_device(a, dev) for name, (s, a) in specs.items()}
    lmm, lmm_arr = specs["lmm_headline"][0], arrs["lmm_headline"]
    curve, curve_arr = specs["curve_5pred_8grid"][0], arrs["curve_5pred_8grid"]
    ols, ols_arr = specs["ols_10k"][0], arrs["ols_10k"]
    sim_ids = torch.arange(N_SIMS, dtype=torch.int64, device=dev)
    records = {}

    plan = datagen.stream_plan(lmm)
    w_k = rng.fill_streams_kernel(SEED, 0, sim_ids, plan, rng.MODE_WORDS)
    w_p = rng.fill_streams_plain(SEED, 0, sim_ids, plan, rng.MODE_WORDS)
    check(torch.equal(w_k, w_p), "K1 words differ from the plain Philox")
    z_k = rng.fill_streams_kernel(SEED, 0, sim_ids, plan, rng.MODE_NORMAL)
    z_p = rng.fill_streams_plain(SEED, 0, sim_ids, plan, rng.MODE_NORMAL)
    ulp = (z_k.view(torch.int32).long() - z_p.view(torch.int32).long()).abs().max().item()
    k1_err = (z_k - z_p).abs().max().item()
    print(f"K1 philox_fill {tuple(z_k.shape)}: words identical; normals max ULP {ulp}, "
          f"max abs err {k1_err}", flush=True)
    check(ulp <= NORMAL_MAX_ULP, f"K1 normals differ by {ulp} ULP")
    records["philox_fill"] = {"max_abs_err": k1_err}

    X, y, _ = datagen.generate_batch(lmm, lmm_arr, SEED, 0, sim_ids, plain=True)
    Xo, yo, _ = datagen.generate_batch(ols, ols_arr, SEED, 0, sim_ids, plain=True)
    Xc, yc, _ = datagen.generate_batch(curve, curve_arr, SEED, 0, sim_ids, plain=True)
    lmm_cases = [("lmm", lmm, X, y)]
    for name in LAYOUT_CHECKS:
        spec_, arr_ = lower_design(lower, ClusterStatic, name)
        X_, y_, _ = datagen.generate_batch(spec_, datagen.to_device(arr_, dev), SEED, 0, sim_ids,
                                           plain=True)
        lmm_cases.append((name, spec_, X_, y_))
    k2_err = 0.0
    for tag, spec_, X_, y_, clus in ([c + (True,) for c in lmm_cases]
                                     + [("ols", ols, Xo, yo, False), ("curve", curve, Xc, yc, False)]):
        got = olsfit.grid_suffstats_kernel(spec_, X_, y_, with_clusters=clus)
        want = olsfit.grid_suffstats_plain(spec_, X_, y_, with_clusters=clus)
        check(set(got) == set(want), f"K2 outputs {sorted(got)} != {sorted(want)}")
        rel = max(rel_err(got[k], want[k]) for k in want)
        k2_err = max(k2_err, max((got[k] - want[k]).abs().max().item() for k in want))
        print(f"K2 grid_suffstats {tag} X {tuple(X_.shape)}: max rel err {rel:.3e}", flush=True)
        check(rel <= K2_REL, f"K2 {tag}: rel err {rel:.3e} > {K2_REL}")
    records["grid_suffstats"] = {"max_abs_err": k2_err}

    k3_err = 0.0
    for tag, spec_, X_, y_ in (("ols", ols, Xo, yo), ("curve", curve, Xc, yc)):
        suff = olsfit.grid_suffstats_plain(spec_, X_, y_)
        ns = torch.as_tensor(spec_.grid, dtype=torch.float64, device=dev)
        args = (suff["xtx"], suff["xty"], suff["yty"], suff["ysum"], ns)
        got = olsfit.ols_solve_kernel(*args)
        want = olsfit.ols_solve_plain(*args)
        check(torch.equal(got[3], want[3]), f"K3 {tag}: converged flags differ")
        rel = max(rel_err(g, w) for g, w in zip(got[:3], want[:3]))
        t2_rel = rel_err(waldstats.t2_targets(spec_, got[0], got[1]),
                         waldstats.t2_targets(spec_, want[0], want[1]))
        k3_err = max(k3_err, max((g - w).abs().max().item() for g, w in zip(got[:3], want[:3])))
        print(f"K3 ols_solve {tag} cells {tuple(suff['yty'].shape)} p {spec_.n_predictors}: max "
              f"rel err {rel:.3e}, t2 {t2_rel:.3e}, flags identical", flush=True)
        check(max(rel, t2_rel) <= K3_REL, f"K3 {tag}: rel err {max(rel, t2_rel):.3e} > {K3_REL}")
    args_c = args  # the curve's cells, the larger p, for the timings
    records["ols_solve"] = {"max_abs_err": k3_err}

    k4_err = 0.0
    for tag, spec_, X_, y_ in lmm_cases:
        suff = olsfit.grid_suffstats_plain(spec_, X_, y_, with_clusters=True)
        ns = torch.as_tensor(spec_.grid, dtype=torch.float64, device=dev)
        args = (suff["n_j"], suff["s"], suff["t"], suff["xtx"], suff["xty"], suff["yty"], ns)
        got = mixedfit.reml_intercept_kernel(*args)
        want = mixedfit.reml_intercept_plain(*args)
        for i, flag in ((2, "converged"), (3, "boundary"), (5, "boundary_hi")):
            n_diff = (got[i] != want[i]).sum().item()
            check(n_diff == 0, f"K4 {tag}: {flag} flags differ in {n_diff} cells")
        beta_rel = rel_err(got[0], want[0])
        t2_rel = rel_err(waldstats.t2_targets(spec_, got[0], got[1]),
                         waldstats.t2_targets(spec_, want[0], want[1]))
        tau_rel = rel_err(got[4], want[4])
        k4_err = max(k4_err, max((got[i] - want[i]).abs().max().item() for i in (0, 1, 4)))
        print(f"K4 reml_intercept {tag} cells {tuple(suff['yty'].shape)} m {suff['n_j'].shape[-1]}: "
              f"beta rel {beta_rel:.3e}, t2 rel {t2_rel:.3e}, tau2 rel {tau_rel:.3e}, flags "
              f"identical (boundary {int(got[3].sum())}, converged {int(got[2].sum())})", flush=True)
        check(max(beta_rel, t2_rel) <= K4_REL,
              f"K4 {tag}: rel err {max(beta_rel, t2_rel):.3e} > {K4_REL}")
        if tag == "lmm":
            args_l, cells_l = args, tuple(suff["yty"].shape)  # the main path's, for the timings
    records["reml_intercept"] = {"max_abs_err": k4_err}
    torch.cuda.synchronize()
    print(f"phase 3 done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # --- phase 4: the main path through the kernels ---
    arm_s = {}
    for name in DESIGNS:  # warm-up at the timed shapes, before counting
        spec_, arr_ = specs[name]
        batch.run_batch(spec_, arr_, N_SIMS, 1, chunk_size=N_SIMS, device=dev)
    kernels.reset_counts()
    for name in DESIGNS:
        spec_, arr_ = specs[name]
        t0 = time.perf_counter()
        counts = batch.run_batch(spec_, arr_, N_SIMS, SEED, chunk_size=N_SIMS, device=dev)
        arm_s[name] = time.perf_counter() - t0
        check(int(counts["n_done"]) == N_SIMS, f"{name}: n_done {counts['n_done']}")
        conv = np.asarray(counts["converged"])
        check(bool((conv > 0.9 * N_SIMS).all()), f"{name}: converged {conv.tolist()}")
        for key, v in counts.items():
            check(bool(np.isfinite(np.asarray(v, dtype=np.float64)).all()), f"{name}: {key} not finite")
        power = np.asarray(counts["sig_unc"])[-1] / N_SIMS
        print(f"arm {name}: {arm_s[name] * 1e3:.1f} ms for {N_SIMS} sims through the kernels; "
              f"power at N={spec_.max_n}: {np.round(power, 4).tolist()}", flush=True)
    launches = kernels.counts()
    print(f"kernel launches on the main path: {launches}", flush=True)
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")

    for name in DESIGNS:
        spec_, arr_ = specs[name]
        counts = batch.run_batch(spec_, arr_, GOLDEN_SIMS, SEED, chunk_size=GOLDEN_SIMS, device=dev)
        flips = []
        for key, want in GOLDEN[name].items():
            got = np.asarray(counts[key])
            want = np.asarray(want)
            check(got.shape == want.shape, f"{name} {key}: shape {got.shape} != {want.shape}")
            if key == "tau2_hat":
                rel = float(np.abs(got - want).max() / np.abs(want).max())
                check(rel <= TAU2_REL, f"{name} tau2_hat rel {rel:.2e} > {TAU2_REL}")
                continue
            diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
            if diff.max() > 0:
                flips.append(f"{key}: max {int(diff.max())} at {np.argwhere(diff > 0).tolist()}")
            check(int(diff.max()) <= MAX_FLIPS, f"{name} {key}: {got.tolist()} vs golden {want.tolist()}")
        extra = set(counts) - set(GOLDEN[name])
        check(not extra, f"{name}: counts {sorted(extra)} not in the golden set")
        print(f"golden {name} at {GOLDEN_SIMS} sims: "
              f"{'identical' if not flips else 'flips ' + '; '.join(flips)}", flush=True)

    # --- phase 5: timings at the main path's shapes ---
    reps = 20
    timing = {
        "philox_fill": (
            lambda: rng.fill_streams_kernel(SEED, 0, sim_ids, plan, rng.MODE_NORMAL),
            lambda: rng.fill_streams_plain(SEED, 0, sim_ids, plan, rng.MODE_NORMAL),
        ),
        "grid_suffstats": (
            lambda: olsfit.grid_suffstats_kernel(lmm, X, y, with_clusters=True),
            lambda: olsfit.grid_suffstats_plain(lmm, X, y, with_clusters=True),
        ),
        "ols_solve": (
            lambda: olsfit.ols_solve_kernel(*args_c),
            lambda: olsfit.ols_solve_plain(*args_c),
        ),
        "reml_intercept": (
            lambda: mixedfit.reml_intercept_kernel(*args_l),
            lambda: mixedfit.reml_intercept_plain(*args_l),
        ),
    }
    shapes = {
        "philox_fill": f"{N_SIMS} sims x {len(plan)} streams x {lmm.max_n} rows",
        "grid_suffstats": f"LMM X {tuple(X.shape)}, m 20, G 1",
        "ols_solve": f"curve cells {tuple(args_c[2].shape)}, p {curve.n_predictors}",
        "reml_intercept": f"LMM cells {cells_l}, p 3, m 20",
    }
    for name, (fk, fp) in timing.items():
        plain_ms = cuda_ms(fp, 3)
        ms = cuda_ms(fk, reps)
        plain_ms = (plain_ms + cuda_ms(fp, 3)) / 2.0
        records[name].update(ms=ms, plain_ms=plain_ms)
        print(f"time {name} ({shapes[name]}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)

    for name in DESIGNS:
        spec_, arr_ = specs[name]
        t0 = time.perf_counter()
        batch.run_batch(spec_, arr_, N_SIMS, SEED, chunk_size=N_SIMS, device=dev, plain=True)
        plain_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        batch.run_batch(spec_, arr_, N_SIMS, SEED, chunk_size=N_SIMS, device=dev)
        again_s = time.perf_counter() - t0
        print(f"arm {name} ({N_SIMS} sims, wall): kernels {arm_s[name] * 1e3:.1f} ms and "
              f"{again_s * 1e3:.1f} ms, plain {plain_s * 1e3:.1f} ms", flush=True)

    # --- phase 6: results ---
    out = []
    for name, (source, replaces) in KERNEL_META.items():
        r = records[name]
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
        })
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        code = 1
    sys.exit(code)
