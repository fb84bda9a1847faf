#!/usr/bin/env python3
"""A short card check of kernel K12 (the GLMM fit with extra groupings), of
K11 after their shared capacitance header and of K2's joint mode, with
launch times.

Run from the repository root on a machine with one CUDA card:

    python3 chip_k12_probe.py [SIMS] [--parent CSRC]

It builds only K2, K11 and K12 (one nvcc each, all at once; with
``--parent``, K2 and K12 of that ``csrc`` directory too), then for each
design of ``chip_smoke.GLMM_EXTRAS_DESIGNS`` and ``chip_smoke.K12_DESIGNS``
generates SIMS (32) sims with the port's plain generator, moves them to the
card and holds K12 against ``glmmfit.glmm_extras_plain`` on the card on the
same rows: the entries of beta, cov, tau^2, ybar, the flags, the pins and
theta that differ (0 expected); the same for K12 with its work areas forced
into device scratch (and there with their capacitance parts in shared
memory), and for the parent's build. For the structured arm it
also fits the dense capacitance at the structured fit's theta. K11 is held
against its plain version at the two LMM extras arms, K2's joint mode
against its plain version at ``chip_smoke.K2_JOINT_CHECKS`` (and bit for bit
against the parent's). Then it times K12 with CUDA events at a launch of the
crossed GLMM flow's shape (1,250 sims, N 480), and K2's joint mode at the
``lmm_extras`` arm's rows and a crossed flow launch's beside one dense
``torch.bmm`` (device time from torch.profiler's kernel events), each
build in turns; ``--times-only`` skips the checks. ``chip_smoke.py`` holds the same kernels
in full; this is the quick look while they change.
"""

import argparse
import time
from pathlib import Path

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


def flow_rows(flow, sims, dev):
    spec, arr = chip_smoke.flow_lowered(flow)[0]
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


def launch_ms(fn, reps=3):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("sims", nargs="?", type=int, default=32)
    ap.add_argument("--parent", type=Path, default=None, help="another tree's csrc directory")
    ap.add_argument("--times-only", action="store_true", help="skip the checks, only time")
    opts = ap.parse_args()
    sims = opts.sims
    if not torch.cuda.is_available():
        print("chip_k12_probe: no CUDA device", file=__import__("sys").stderr)
        return 2
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    names = ("grid_suffstats", "joint_reml", "glmm_extras")
    builds = [kernels.KERNELS[n] for n in names]
    parent = {}
    if opts.parent is not None:
        parent = chip_smoke.other_kernels(kernels, opts.parent.resolve(), "parent",
                                          ("grid_suffstats", "glmm_extras"))
        builds += list(parent.values())
    procs = [(k, k.start_build()) for k in builds]
    for k, proc in procs:
        k.finish_build(proc)
        print(f"built {k.name} at {time.perf_counter() - t0:.1f} s", flush=True)
    for k in builds:  # ptxas on K12's functions and K2's joint kernel
        if not k.name.startswith(("glmm_extras", "grid_suffstats")):
            continue
        lines = k.log_path.read_text().splitlines()
        keep = [i for i, line in enumerate(lines) if "Function properties" in line
                and ("glmm_extras" in k.name or "joint" in line)]
        print(f"ptxas {k.name}: " + " | ".join(
            " ".join(lines[j].split()) for i in keep for j in range(i, min(i + 3, len(lines)))
            if "Compiling" not in lines[j]), flush=True)
    bad = 0
    checks = [] if opts.times_only else list(chip_smoke.GLMM_EXTRAS_DESIGNS) + list(
        chip_smoke.K12_DESIGNS)
    for name in checks:
        spec, arr, X, y = generated(name, sims, dev)
        a = chip_smoke.k12_args(spec, arr, X, y)
        print(f"K12 {name} geometry: {glmmfit.glmm_extras_geometry(*a)}", flush=True)
        t1 = time.perf_counter()
        got = glmmfit.glmm_extras_kernel(*a)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        want = glmmfit.glmm_extras_plain(*a)
        torch.cuda.synchronize()
        diff = differing(got, want)
        dscr = {}
        for form in (2, 3):  # the areas in scratch; their capacitance parts in shared memory
            glmmfit.glmm_extras_set_form(form)
            dscr.update({f"{k} (form {form})": v for k, v in differing(
                glmmfit.glmm_extras_kernel(*a), want).items()})
            glmmfit.glmm_extras_set_form(0)
        dpar = {}
        if "glmm_extras" in parent:
            with chip_smoke.kernel_swapped(kernels, "glmm_extras", parent["glmm_extras"]):
                dpar = differing(glmmfit.glmm_extras_kernel(*a), got)
        bad += bool(diff) + bool(dscr) + bool(dpar)
        print(f"K12 {name}: cells {tuple(got[2].shape)}, M {mixedfit.joint_width(mixedfit.grouping_plan(spec))}, "
              f"converged {int(got[2].sum())}, pins {got[6].sum((0, 1)).tolist()}, kernel "
              f"{(t2 - t1) * 1e3:.1f} ms, plain {(time.perf_counter() - t2) * 1e3:.1f} ms; "
              f"differing entries {diff or 'none'}; other forms {dscr or 'none'}"
              + (f"; against the parent's build {dpar or 'none'}" if parent else ""), flush=True)
        if name == "glmm_extras":
            dk = glmmfit.glmm_extras_kernel(*a, theta=got[7], dense=True)
            dp = glmmfit.glmm_extras_plain(*a, theta=got[7], dense=True)
            rel = float(((dk[0] - got[0]).abs().max() / got[0].abs().max()))
            d2 = differing(dk, dp)
            bad += bool(d2)
            print(f"K12 {name} forced dense at the structured theta: beta rel {rel:.2e} to the "
                  f"structured fit, pins differ {int((dk[6] != got[6]).sum())}; differing "
                  f"entries against its plain version {d2 or 'none'}", flush=True)
    for name in () if opts.times_only else ("lmm_extras", "lmm_extras_dense"):
        spec, arr, X, y = generated(name, sims, dev)
        ka = chip_smoke.k11_args(spec, olsfit.joint_suffstats_plain(spec, X, y))
        got = mixedfit.joint_reml_kernel(*ka, with_theta=True)
        want = mixedfit.joint_reml_plain(*ka, with_theta=True)
        diff = differing(got, want, K11_OUT)
        bad += bool(diff)
        print(f"K11 {name}: differing entries {diff or 'none'}", flush=True)
    for name in () if opts.times_only else chip_smoke.K2_JOINT_CHECKS:
        spec, arr, X, y = generated(name, max(sims, 64), dev)
        got = olsfit.joint_suffstats_kernel(spec, X, y)
        want = olsfit.joint_suffstats_plain(spec, X, y)
        rel = max(chip_smoke.rel_err(got[k], want[k]) for k in ("ztz", "ztx", "zty"))
        q1 = all(not cols for _, _, cols in olsfit.joint_layout(spec)[0])
        counts_ok = (not q1) or torch.equal(got["ztz"], want["ztz"])
        npar = None
        if "grid_suffstats" in parent:
            with chip_smoke.kernel_swapped(kernels, "grid_suffstats", parent["grid_suffstats"]):
                theirs = olsfit.joint_suffstats_kernel(spec, X, y)
            npar = sum(int((theirs[k] != got[k]).sum()) for k in ("ztz", "ztx", "zty"))
        bad += (rel > chip_smoke.K2_JOINT_REL) + (not counts_ok) + bool(npar)
        print(f"K2 joint {name} X {tuple(X.shape)}: max rel err {rel:.3e} against the plain "
              f"version, counts {'exact' if counts_ok else 'DIFFER'}"
              + (f"; entries differing from the parent's build {npar}" if npar is not None else ""),
              flush=True)
    # timing at a launch of the crossed GLMM flow, each build in turns
    k12s = {"this": kernels.KERNELS["glmm_extras"], **({"parent": parent["glmm_extras"]}
                                                       if "glmm_extras" in parent else {})}
    spec2, arr2, X, y = flow_rows("model_glmm_crossed_power", 1250, dev)
    a = chip_smoke.k12_args(spec2, arr2, X, y)
    print(f"K12 crossed flow launch geometry: {glmmfit.glmm_extras_geometry(*a)}", flush=True)
    for lb in list(k12s) + list(k12s)[::-1]:
        with chip_smoke.kernel_swapped(kernels, "glmm_extras", k12s[lb]):
            ms = launch_ms(lambda: glmmfit.glmm_extras_kernel(*a))
        print(f"K12 crossed flow launch (1,250 cells, N {spec2.max_n}), {lb}: {ms:.3f} ms a launch",
              flush=True)
    # K2's joint mode at the arm's and a crossed flow launch's rows
    k2s = {"this": kernels.KERNELS["grid_suffstats"], **({"parent": parent["grid_suffstats"]}
                                                         if "grid_suffstats" in parent else {})}
    for tag, (spec3, arr3, X3, y3) in (
            ("lmm_extras arm", generated("lmm_extras", chip_smoke.EXTRAS_SIMS, dev)),
            ("crossed flow launch", flow_rows("model_crossed_power", 1250, dev))):
        out = olsfit.joint_suffstats_kernel(spec3, X3, y3)
        Z = torch.zeros(X3.shape[:2] + (out["ztz"].shape[-1],), dtype=torch.float64, device=dev)
        zcols, zvals, _ = olsfit._joint_z(spec3, X3)
        Z.scatter_(2, zcols.expand(X3.shape[0], -1, -1), zvals)
        rhs = torch.cat([Z, X3[..., list(spec3.effective_fit_cols)].double(),
                         y3.double()[..., None]], dim=-1)
        Zt = Z.transpose(1, 2).contiguous()
        times = [f"bmm {chip_smoke.device_ms(torch.bmm, chip_smoke.input_copies((Zt, rhs)), 10):.4f}"]
        copies = chip_smoke.input_copies((X3, y3))
        for lb in list(k2s) + list(k2s)[::-1]:
            with chip_smoke.kernel_swapped(kernels, "grid_suffstats", k2s[lb]):
                times.append(f"{lb} " + "%.4f" % chip_smoke.device_ms(
                    lambda X_, y_: olsfit.joint_suffstats_kernel(spec3, X_, y_), copies, 10,
                    "grid_suffstats_joint_kernel", launches=1))
        print(f"K2 joint {tag} X {tuple(X3.shape)}, device ms a launch: " + ", ".join(times),
              flush=True)
    print(f"probe done in {time.perf_counter() - t0:.1f} s; {bad} case(s) differ", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
