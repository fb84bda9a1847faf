#!/usr/bin/env python3
"""Golden values of ``chip_smoke.py``'s arms and flows, on the CPU.

For each name (an arm of ``chip_smoke.lower_design`` or a flow of
``chip_smoke.MODEL_FLOWS``) this runs GOLDEN_SIMS sims at base seed SEED
through the JAX reference (``mcpower_tpu``: an arm's ``run_batch`` counts in
one chunk, a flow's ``MCPower`` call summarized by ``chip_smoke.flow_summary``)
or through the port's plain path on the CPU (``mcpower_tpu_torch``,
``device="cpu"``), and prints one JSON object per name. With both, it also
prints the largest difference per key: the measured bands that
``chip_smoke.py``'s tolerances for a path are set from before any card run.

    JAX_PLATFORMS=cpu python3 golden_values.py --which ref glmm_extras model_glmm_nested_power
    python3 golden_values.py --which port --out port.json glmm_extras

``--which both`` runs the reference, then the port. ``--out`` writes the
objects to a JSON file too; ``--compare A.json B.json`` prints the
differences of two such files.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke  # noqa: E402


def _plain(v):
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, np.ndarray):
        return _plain(v.tolist())
    if isinstance(v, np.generic):
        return v.item()
    return v


def reference(name: str):
    import jax

    jax.config.update("jax_enable_x64", True)
    if name in chip_smoke.MODEL_FLOWS:
        from mcpower_tpu import MCPower

        return chip_smoke.flow_summary(chip_smoke.run_flow(MCPower, name, chip_smoke.GOLDEN_SIMS))
    from mcpower_tpu.engine import batch, lower
    from mcpower_tpu.engine.spec import ClusterStatic

    spec, arr = chip_smoke.lower_design(lower, ClusterStatic, name)
    return batch.run_batch(spec, arr, chip_smoke.GOLDEN_SIMS, chip_smoke.SEED,
                           chunk_size=chip_smoke.GOLDEN_SIMS)


def port(name: str):
    if name in chip_smoke.MODEL_FLOWS:
        from mcpower_tpu_torch import MCPower

        return chip_smoke.flow_summary(chip_smoke.run_flow(MCPower, name, chip_smoke.GOLDEN_SIMS,
                                                           device="cpu"))
    from mcpower_tpu_torch.engine import batch, lower
    from mcpower_tpu_torch.engine.spec import ClusterStatic

    spec, arr = chip_smoke.lower_design(lower, ClusterStatic, name)
    return batch.run_batch(spec, arr, chip_smoke.GOLDEN_SIMS, chip_smoke.SEED,
                           chunk_size=chip_smoke.GOLDEN_SIMS, device="cpu")


def differences(a, b, path=""):
    """The largest |a - b| of each leaf key of two result objects (relative
    for the tau^2 estimates)."""
    out = {}
    if isinstance(a, dict):
        for k in a:
            out.update(differences(a[k], b[k], f"{path}.{k}" if path else k))
        return out
    x, y = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    key = path.rsplit(".", 1)[-1]
    if key in ("tau2_hat", "tau_squared_hat_mean", "glm_baseline"):
        out[path] = float(np.abs(x - y).max() / np.abs(y).max())
    else:
        out[path] = float(np.nanmax(np.abs(x - y))) if x.size else 0.0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*")
    ap.add_argument("--which", choices=("ref", "port", "both"), default="both")
    ap.add_argument("--out", default=None)
    ap.add_argument("--compare", nargs=2, default=None, metavar=("A", "B"))
    opts = ap.parse_args(argv)
    if opts.compare:
        a, b = (json.loads(Path(f).read_text()) for f in opts.compare)
        for name in a:
            if name in b:
                print(name, json.dumps(differences(a[name], b[name])))
        return 0
    results = {}
    for name in opts.names:
        for which in (("ref", "port") if opts.which == "both" else (opts.which,)):
            t0 = time.perf_counter()
            got = _plain((reference if which == "ref" else port)(name))
            results.setdefault(which, {})[name] = got
            print(f"{which} {name} ({time.perf_counter() - t0:.1f} s): {json.dumps(got)}",
                  flush=True)
        if opts.which == "both":
            print(f"differences {name}: "
                  f"{json.dumps(differences(results['port'][name], results['ref'][name]))}",
                  flush=True)
    if opts.out:
        Path(opts.out).write_text(json.dumps(results if opts.which == "both"
                                             else results[opts.which], indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
