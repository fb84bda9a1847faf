#!/usr/bin/env python3
"""A/B of ``MCPower`` flow walls on one card: another tree against this one.

    git archive <commit> | tar -x -C _parent      # _parent/ is gitignored
    python3 chip_flow_ab.py [--kernels NAME,...] [--build-only] _parent [flow ...]

Builds both trees' kernels at once (with ``--kernels`` only those of
``kernels.KERNELS`` named, the others on first use, before the timed calls;
``--build-only`` stops there), then runs each tree in a process of its
own in turns (other, this, this, other): per flow of ``chip_smoke.MODEL_FLOWS``
(default: README flow 1's power and sample size, the Tukey ANOVA, the logit
and the LMM power flows) one warm-up call and 7 timed calls of 10,000 sims
on the host clock, and prints each turn's median, min and max (ms), with the
card's name and power limit. It imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time

FLOWS = ["model_readme_ols_power", "model_readme_ols_sample_size", "model_anova_tukey",
         "model_logit_power", "model_lmm_power"]
BUILD = ("import sys; sys.path.insert(0, {t!r}); "
         "from mcpower_tpu_torch.engine import kernels; "
         "ks = [kernels.KERNELS[n] for n in ({names!r} or kernels.KERNELS)]; "
         "[k.finish_build(p) for k, p in [(k, k.start_build()) for k in ks]]")
RUN = """
import json, statistics, sys, time
sys.path.insert(0, {t!r})
import chip_smoke
from mcpower_tpu_torch import MCPower
out = {{}}
for name in {flows!r}:
    chip_smoke.run_flow(MCPower, name, 10000, device="cuda")
    walls = []
    for _ in range(7):
        t0 = time.perf_counter()
        chip_smoke.run_flow(MCPower, name, 10000, device="cuda")
        walls.append((time.perf_counter() - t0) * 1e3)
    out[name] = [statistics.median(walls), min(walls), max(walls)]
print("RESULT " + json.dumps(out))
"""


def main(argv) -> int:
    argv = list(argv)
    names = []
    build_only = "--build-only" in argv
    if build_only:
        argv.remove("--build-only")
    if "--kernels" in argv:
        i = argv.index("--kernels")
        names = argv[i + 1].split(",") if i + 1 < len(argv) else []
        del argv[i:i + 2]
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"other": os.path.abspath(argv[1]), "this": os.path.dirname(os.path.abspath(__file__))}
    flows = argv[2:] or FLOWS
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    t0 = time.time()
    procs = {k: subprocess.Popen([sys.executable, "-c", BUILD.format(t=t, names=names)], cwd=t)
             for k, t in trees.items()}
    if any(p.wait() != 0 for p in procs.values()):
        return 1
    print(f"built both trees in {time.time() - t0:.0f} s", flush=True)
    if build_only:
        return 0
    turns = []
    for k in ("other", "this", "this", "other"):
        r = subprocess.run([sys.executable, "-c", RUN.format(t=trees[k], flows=flows)],
                           cwd=trees[k], capture_output=True, text=True)
        line = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")]
        if r.returncode != 0 or not line:
            print(r.stderr[-3000:], file=sys.stderr)
            return 1
        turns.append((k, json.loads(line[0][len("RESULT "):])))
        print(k, json.dumps({n: [round(v, 3) for v in w] for n, w in turns[-1][1].items()}),
              flush=True)
    for name in flows:
        o = [g[name][0] for k, g in turns if k == "other"]
        t = [g[name][0] for k, g in turns if k == "this"]
        print(f"{name}: other {o[0]:.3f} / {o[1]:.3f} ms, this {t[0]:.3f} / {t[1]:.3f} ms "
              f"(medians in turn order)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
