"""Counter-pooling merge of per-worker results.

Pool raw integer counters from independently-run batches (different machines,
sessions, or heterogeneous device pools) and re-derive every rate, CI, and
crossing fit — statistically exact because all derived quantities are pure
functions of (counters, n). The same algebra as the reference's merge
(crates/engine-orchestrator/src/merge.rs:26,242): it is the cross-run /
cross-host fan-out story.

Workers must run DISJOINT sim-id ranges of the same lowered spec (worker w
of W covers ids [w*k, (w+1)*k), see ``split_sims``); with
overlapping ranges the pooled counts double-count draws.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .aggregation import rate, wilson_ci

_COUNT_KEYS = (
    "success_counts_uncorrected",
    "success_counts_corrected",
    "converged_counts",
    "joint_counts_uncorrected",
    "joint_counts_corrected",
    "success_count_histogram_uncorrected",
    "success_count_histogram_corrected",
    "overall_counts",
    "posthoc_counts",
)


def merge_power_results(parts: Sequence[Dict]) -> Dict:
    """Pool counters across per-worker folded results and re-derive rates."""
    if not parts:
        raise ValueError("nothing to merge")
    base = parts[0]
    for p in parts[1:]:
        if p["sample_sizes"] != base["sample_sizes"]:
            raise ValueError("merge requires identical sample-size grids")
        if p["target_labels"] != base["target_labels"]:
            raise ValueError("merge requires identical target sets")

    out = {k: v for k, v in base.items()}
    n = sum(int(p["n_sims"]) for p in parts)
    out["n_sims"] = n

    pooled: Dict[str, np.ndarray] = {}
    for key in _COUNT_KEYS:
        if key in base:
            pooled[key] = np.sum(
                [np.asarray(p[key], dtype=np.int64) for p in parts], axis=0
            )
            out[key] = pooled[key].tolist()

    sig_unc = pooled["success_counts_uncorrected"]
    sig_corr = pooled["success_counts_corrected"]
    lo_u, hi_u = wilson_ci(sig_unc, n)
    lo_c, hi_c = wilson_ci(sig_corr, n)
    out["powers"] = {
        "uncorrected": (sig_unc / max(n, 1)).tolist(),
        "corrected": (sig_corr / max(n, 1)).tolist(),
        "ci_uncorrected": np.stack([lo_u, hi_u], axis=-1).tolist(),
        "ci_corrected": np.stack([lo_c, hi_c], axis=-1).tolist(),
    }
    # Flat reference-envelope aliases track the pooled values exactly.
    out["power_uncorrected"] = out["powers"]["uncorrected"]
    out["power_corrected"] = out["powers"]["corrected"]
    out["ci_uncorrected"] = out["powers"]["ci_uncorrected"]
    out["ci_corrected"] = out["powers"]["ci_corrected"]
    out["convergence_rate"] = (pooled["converged_counts"] / max(n, 1)).tolist()

    # Boundary-hit rates are per-sim means — n-weighted pooling recovers the
    # pooled counters exactly (rate_p * n_p sums to the underlying count).
    for key in ("boundary_hit_rate_tau_zero", "boundary_hit_rate_high_tau"):
        if key in base:
            num = np.sum(
                [np.asarray(p[key], np.float64) * int(p["n_sims"]) for p in parts],
                axis=0,
            )
            out[key] = (num / max(n, 1)).tolist()

    if "joint_counts_uncorrected" in pooled:
        out["joint_uncorrected_rate"] = rate(
            pooled["joint_counts_uncorrected"], n
        ).tolist()
        out["joint_corrected_rate"] = rate(
            pooled["joint_counts_corrected"], n
        ).tolist()
    if "overall_counts" in pooled:
        k_ov = pooled["overall_counts"]
        lo, hi = wilson_ci(k_ov, n)
        out["overall_significant_rate"] = rate(k_ov, n).tolist()
        out["overall_significant_ci"] = np.stack(
            [np.atleast_1d(lo), np.atleast_1d(hi)], axis=-1
        ).tolist()
    if "posthoc_counts" in pooled and base.get("posthoc"):
        ph_counts = pooled["posthoc_counts"]
        ph_out: Dict = {}
        col = 0
        for flabel, pairs in base["posthoc"].items():
            ph_out[flabel] = {}
            for plabel in pairs:
                kc = ph_counts[:, col]
                lo, hi = wilson_ci(kc, n)
                ph_out[flabel][plabel] = {
                    "power": rate(kc, n).tolist(),
                    "ci": np.stack([np.atleast_1d(lo), np.atleast_1d(hi)], axis=-1).tolist(),
                }
                col += 1
        out["posthoc"] = ph_out

    # Float diagnostics: n-weighted pooling of per-part means (reference
    # merge.rs pools the underlying sums; means weighted by each part's
    # denominator recover exactly that).
    if "estimator_extras" in base:
        out["estimator_extras"] = _pool_estimator_extras(parts)

    # Sample-size outputs (per-target, joint, overall) re-derived from the
    # pooled counters through the SAME derivation the one-shot run uses —
    # never copied from part 0 (reference merge.rs:242 re-derives everything).
    if "fitted" in base:
        from .runner import derive_sample_size_outputs

        derive_sample_size_outputs(
            out,
            target_power=base.get("target_power", 0.8),
            atom=base.get("cluster_atom", 1),
        )

    merged_warnings: List[str] = []
    for p in parts:
        for w in p.get("warnings", []):
            if w not in merged_warnings:
                merged_warnings.append(w)
    out["warnings"] = merged_warnings
    return out


def _pool_estimator_extras(parts: Sequence[Dict]) -> Dict:
    """Exact pooling of per-part diagnostic means.

    Per-sim means (baseline prob, singular/boundary rates) weight by each
    part's n_sims; tau^2 means are over CONVERGED sims only (the engine masks
    the device sum), so they weight by per-grid converged counts. Integer
    diagnostics (boundary_hits) sum.
    """
    pooled: Dict = {}
    arms = [k for p in parts for k in (p.get("estimator_extras") or {})]
    for arm in dict.fromkeys(arms):
        arm_parts = [
            (p, p["estimator_extras"][arm])
            for p in parts
            if arm in (p.get("estimator_extras") or {})
        ]
        keys = [k for _, e in arm_parts for k in e]
        merged: Dict = {}
        for key in dict.fromkeys(keys):
            rows = [(p, e[key]) for p, e in arm_parts if key in e]
            if key in ("boundary_hits", "boundary_component_counts"):
                merged[key] = np.sum(
                    [np.asarray(v, dtype=np.int64) for _, v in rows], axis=0
                ).tolist()
                if key == "boundary_component_counts":
                    # Rate re-derived from pooled counts over pooled
                    # converged counts (exact, like every counter).
                    conv = np.maximum(
                        np.sum(
                            [
                                np.asarray(p["converged_counts"], np.float64)
                                for p, _ in rows
                            ],
                            axis=0,
                        ),
                        1.0,
                    )
                    merged["boundary_rate_per_component"] = (
                        np.asarray(merged[key], np.float64) / conv[:, None]
                    ).tolist()
            elif key in ("tau_estimate", "boundary_rate_per_component"):
                continue  # re-derived from pooled counters above/below
            elif key == "tau_squared_hat_mean":
                num = np.sum(
                    [
                        np.asarray(v, np.float64) * np.asarray(p["converged_counts"], np.float64)
                        for p, v in rows
                    ],
                    axis=0,
                )
                den = np.sum(
                    [np.asarray(p["converged_counts"], np.float64) for p, _ in rows],
                    axis=0,
                )
                mean = num / np.maximum(den, 1.0)
                merged[key] = mean.tolist()
                merged["tau_estimate"] = np.sqrt(np.maximum(mean, 0.0)).tolist()
            else:
                num = np.sum(
                    [np.asarray(v, np.float64) * int(p["n_sims"]) for p, v in rows],
                    axis=0,
                )
                den = sum(int(p["n_sims"]) for p, _ in rows)
                merged[key] = (num / max(den, 1)).tolist()
        pooled[arm] = merged
    return pooled


def split_sims(n_sims: int, n_workers: int) -> List[tuple]:
    """(offset, count) per worker — disjoint global sim-id ranges, so the
    pooled result is draw-identical to one big run (stronger than the
    reference's per-worker-seed scheme)."""
    per = n_sims // n_workers
    rem = n_sims % n_workers
    out = []
    off = 0
    for w in range(n_workers):
        c = per + (1 if w < rem else 0)
        out.append((off, c))
        off += c
    return out
