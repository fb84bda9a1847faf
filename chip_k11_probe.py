#!/usr/bin/env python3
"""A short card check of kernel K11 (the joint-Z REML fit of extra
groupings) and K2's joint mode, with their launch times.

Run from the repository root on a machine with one CUDA card:

    python3 chip_k11_probe.py [SIMS]

It builds only K2 and K11 (one nvcc each, about half a minute), then for a
few designs of the LMM with extra groupings (structured with Me = 10, 25 and
48 extras levels, nested ids, dense with a primary slope and with a crossed
grouping's own slope) generates SIMS (64) sims on the card and holds:

* K2's joint mode against its plain version (relative error of each
  statistic; the counts of an all-intercept plan exact);
* K11 against ``mixedfit.joint_reml_plain`` on the same statistics: the
  entries of beta, cov, the flags, tau^2, the pins and theta that differ
  (0 expected);
* for an all-intercept plan, the dense capacitance at the structured fit's
  theta and by its own search, against the structured fit.

Then it times K11 and K2 (its main entry and its joint mode) with CUDA
events at the launches of the extras flows (1,250 sims: the crossed, nested
and dense flows' single N, the crossed sample-size flow's three N) and of
the lmm_extras arm's shape. ``chip_smoke.py`` holds the same kernels in full;
this is the quick look while K11 changes.
"""

import sys
import time

import numpy as np
import torch

from mcpower_tpu_torch.engine import datagen, kernels, lower, mixedfit, olsfit
from mcpower_tpu_torch.engine.spec import ClusterStatic, ExtraGroupingStatic, SlopeStatic

SEED = 2137
FLOW_SIMS = 1250


def design(m1, extras, slopes=(), ex_slopes=(), grid=(200,), k=2, rel="crossed"):
    """A lowered LMM: k normal predictors (corr 0.3 between the first two),
    m1 round-robin primary clusters (tau^2 0.25, slopes on the columns
    ``slopes``), one extra grouping of each entry of ``extras`` levels
    (tau^2 0.15, its own slopes on ``ex_slopes``)."""
    corr = np.eye(k)
    if k > 1:
        corr[0, 1] = corr[1, 0] = 0.3
    sl = tuple(SlopeStatic(design_col=c, variance=0.2, intercept_corr=0.3) for c in slopes)
    eg = tuple(ExtraGroupingStatic(rel, lv, 0.15, slopes=tuple(
        SlopeStatic(design_col=c, variance=0.1, intercept_corr=0.2) for c in ex_slopes))
        for lv in extras)
    return lower.lower(grid=list(grid), var_types=["normal"] * k, corr=corr,
                       effects=np.array(([0.0, 0.3, 0.2] + [0.1] * k)[:k + 1]),
                       target_cols=list(range(1, k + 1)), estimator="mle",
                       cluster=ClusterStatic("fixed_clusters", m1, 0.25, slopes=sl,
                                             extra_groupings=eg))


CASES = {
    "struct_me10": design(20, [10]),
    "struct_me25": design(40, [25], grid=(500, 1000)),
    "nested_me48": design(12, [4], rel="nested", grid=(480,)),
    "dense_m50": design(20, [10], slopes=(1,)),
    "dense_exslope": design(10, [8], ex_slopes=(1,)),
}
TIMED = {
    "crossed_flow": design(40, [25], grid=(1000,)),
    "nested_flow": design(12, [4], rel="nested", grid=(720,)),
    "dense_flow": design(30, [10], slopes=(1,), grid=(600,), k=1),
    "crossed_ss": design(40, [25], grid=(1000, 2000, 3000)),
    "arm_struct": design(20, [10]),
}


def k11_args(spec, suff):
    plan = mixedfit.grouping_plan(spec)
    _, theta0, lower_ = mixedfit.theta_layout(plan)
    ns = torch.as_tensor(spec.grid, dtype=torch.float64, device="cuda")
    return [suff[k] for k in ("ztz", "ztx", "zty", "xtx", "xty", "yty")] + [
        ns, [(m, q) for m, q, _, _, _ in plan], theta0, lower_]


def event_ms(fn, *a, **k) -> float:
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    fn(*a, **k)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sims = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    t0 = time.time()
    built = {name: kernels.KERNELS[name] for name in ("grid_suffstats", "joint_reml")}
    procs = {name: k.start_build() for name, k in built.items()}
    for name, k in built.items():
        k.finish_build(procs[name])
        print(f"{name} built {time.time() - t0:.1f} s after start", flush=True)
    for name, (spec, arr) in CASES.items():
        X, y, _ = datagen.generate_batch(spec, datagen.to_device(arr, "cuda"), SEED, 0,
                                         torch.arange(sims, device="cuda"))
        got = olsfit.joint_suffstats(spec, X, y)
        want = olsfit.joint_suffstats_plain(spec, X, y)
        rel = {k: float((got[k] - want[k]).abs().max() / want[k].abs().max().clamp(min=1e-300))
               for k in ("ztz", "ztx", "zty", "xtx", "xty", "yty")}
        plan = mixedfit.grouping_plan(spec)
        args = k11_args(spec, got)
        k_out = mixedfit.joint_reml_kernel(*args, with_theta=True)
        p_out = mixedfit.joint_reml_plain(*args, with_theta=True)
        diff = [int((a != b).sum()) for a, b in zip(k_out, p_out)]
        print(f"{name} M {mixedfit.joint_width(plan)}: K2 joint relative errors {rel}; K11 "
              f"entries that differ from the plain version {diff}", flush=True)
        if mixedfit.plan_all_q1(plan):
            at = mixedfit.joint_reml_kernel(*args, theta=k_out[6], dense=True)
            own = mixedfit.joint_reml_kernel(*args, dense=True, with_theta=True)
            print(f"  dense at the structured theta: beta rel "
                  f"{float((at[0] - k_out[0]).abs().max() / k_out[0].abs().max()):.2e}, pins "
                  f"that differ {int((at[5] != k_out[5]).sum())}; its own search: theta max "
                  f"diff {float((own[6] - k_out[6]).abs().max()):.2e}", flush=True)
    for name, (spec, arr) in TIMED.items():
        X, y, _ = datagen.generate_batch(spec, datagen.to_device(arr, "cuda"), SEED, 0,
                                         torch.arange(FLOW_SIMS, device="cuda"))
        args = k11_args(spec, olsfit.joint_suffstats(spec, X, y))
        mixedfit.joint_reml_kernel(*args)  # warm-up
        k11 = [event_ms(mixedfit.joint_reml_kernel, *args) for _ in range(3)]
        k2 = event_ms(olsfit.joint_suffstats, spec, X, y)
        print(f"{name} ({FLOW_SIMS} sims, N {list(spec.grid)}, M "
              f"{mixedfit.joint_width(mixedfit.grouping_plan(spec))}): K11 ms "
              f"{[round(t, 2) for t in k11]}, K2 with its joint mode ms {k2:.3f}", flush=True)
    print(f"launches {kernels.counts()}, tagged {kernels.tagged_counts()}")
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
