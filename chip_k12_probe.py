#!/usr/bin/env python3
"""A short card check of kernel K12 (the GLMM fit with extra groupings) and
of K11 after their shared capacitance header, with K12's launch times.

Run from the repository root on a machine with one CUDA card:

    python3 chip_k12_probe.py [SIMS]

It builds only K11 and K12 (one nvcc each, all at once), then for each
design of ``chip_smoke.GLMM_EXTRAS_DESIGNS`` and ``chip_smoke.K12_DESIGNS``
generates SIMS (32) sims with the port's plain generator, moves them to the
card and holds K12 against ``glmmfit.glmm_extras_plain`` on the card on the
same rows: the entries of beta, cov, tau^2, ybar, the flags, the pins and
theta that differ (0 expected). For the structured arm it also fits the
dense capacitance at the structured fit's theta. K11 is held against its
plain version at the two LMM extras arms. Then it times K12 with CUDA events
at a launch of the crossed GLMM flow's shape (1,250 sims, N 480).
``chip_smoke.py`` holds the same kernels in full; this is the quick look while
K12 changes.
"""

import sys
import time

import torch

import chip_smoke
from mcpower_tpu_torch.engine import datagen, glmmfit, kernels, lower, mixedfit, olsfit
from mcpower_tpu_torch.engine.spec import ClusterStatic


def generated(name, sims, dev):
    spec, arr = chip_smoke.lower_design(lower, ClusterStatic, name)
    arr = datagen.to_device(arr, "cpu")
    X, y, _ = datagen.generate_batch(spec, arr, chip_smoke.SEED, 0,
                                     torch.arange(sims, dtype=torch.int64), plain=True)
    return spec, datagen.to_device(arr, dev), X.to(dev), y.to(dev)


K12_OUT = ("beta", "cov", "converged", "boundary", "tau2", "ybar", "pinned", "theta")
K11_OUT = ("beta", "cov", "converged", "boundary", "tau2", "pinned", "theta")


def differing(got, want, names=K12_OUT) -> dict:
    out = {}
    for n, g, w in zip(names, got, want):
        same = (g == w) | (g.isnan() & w.isnan()) if g.is_floating_point() else g == w
        if int((~same).sum()):
            out[n] = int((~same).sum())
    return out


def main() -> int:
    sims = int(sys.argv[1]) if len(sys.argv) > 1 else 32
    if not torch.cuda.is_available():
        print("chip_k12_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    procs = {n: kernels.KERNELS[n].start_build() for n in ("joint_reml", "glmm_extras")}
    for n, proc in procs.items():
        kernels.KERNELS[n].finish_build(proc)
        print(f"built {n} at {time.perf_counter() - t0:.1f} s", flush=True)
    log = kernels.KERNELS["glmm_extras"].log_path.read_text()
    print("\n".join(line for line in log.splitlines() if "registers" in line or "spill" in line),
          flush=True)
    bad = 0
    for name in list(chip_smoke.GLMM_EXTRAS_DESIGNS) + list(chip_smoke.K12_DESIGNS):
        spec, arr, X, y = generated(name, sims, dev)
        a = chip_smoke.k12_args(spec, arr, X, y)
        t1 = time.perf_counter()
        got = glmmfit.glmm_extras_kernel(*a)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        want = glmmfit.glmm_extras_plain(*a)
        torch.cuda.synchronize()
        diff = differing(got, want)
        bad += bool(diff)
        print(f"K12 {name}: cells {tuple(got[2].shape)}, M {mixedfit.joint_width(mixedfit.grouping_plan(spec))}, "
              f"converged {int(got[2].sum())}, pins {got[6].sum((0, 1)).tolist()}, kernel "
              f"{(t2 - t1) * 1e3:.1f} ms, plain {(time.perf_counter() - t2) * 1e3:.1f} ms; "
              f"differing entries {diff or 'none'}", flush=True)
        if name == "glmm_extras":
            dk = glmmfit.glmm_extras_kernel(*a, theta=got[7], dense=True)
            dp = glmmfit.glmm_extras_plain(*a, theta=got[7], dense=True)
            rel = float(((dk[0] - got[0]).abs().max() / got[0].abs().max()))
            d2 = differing(dk, dp)
            bad += bool(d2)
            print(f"K12 {name} forced dense at the structured theta: beta rel {rel:.2e} to the "
                  f"structured fit, pins differ {int((dk[6] != got[6]).sum())}; differing "
                  f"entries against its plain version {d2 or 'none'}", flush=True)
    for name in ("lmm_extras", "lmm_extras_dense"):
        spec, arr, X, y = generated(name, sims, dev)
        ka = chip_smoke.k11_args(spec, olsfit.joint_suffstats_plain(spec, X, y))
        got = mixedfit.joint_reml_kernel(*ka, with_theta=True)
        want = mixedfit.joint_reml_plain(*ka, with_theta=True)
        diff = differing(got, want, K11_OUT)
        bad += bool(diff)
        print(f"K11 {name}: differing entries {diff or 'none'}", flush=True)
    # timing at a launch of the crossed GLMM flow
    spec2, arr2 = chip_smoke.flow_lowered("model_glmm_crossed_power")[0]
    arr2 = datagen.to_device(arr2, "cpu")
    X, y, _ = datagen.generate_batch(spec2, arr2, chip_smoke.SEED, 0,
                                     torch.arange(1250, dtype=torch.int64), plain=True)
    a = chip_smoke.k12_args(spec2, datagen.to_device(arr2, dev), X.to(dev), y.to(dev))
    glmmfit.glmm_extras_kernel(*a)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        glmmfit.glmm_extras_kernel(*a)
    end.record()
    torch.cuda.synchronize()
    print(f"K12 crossed flow launch (1,250 cells, N {spec2.max_n}): "
          f"{start.elapsed_time(end) / 3:.3f} ms a launch", flush=True)
    print(f"probe done in {time.perf_counter() - t0:.1f} s; {bad} case(s) differ", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
