"""Result folding: raw device counters -> host result trees.

The single source of result shape for every consumer (reports, plots, merge,
ports) — the role of the reference's aggregation fold + HostValue projection
(crates/engine-orchestrator/src/aggregation.rs, result_host.rs). Everything is
derived from integer counters so that merging worker results (pool counters,
re-derive) is exact.

Result tree (per scenario), all rates as proportions in [0, 1]:

    {
      "n_sims": int, "sample_sizes": [N...], "target_labels": [...],
      "powers": {                       # per grid point g
        "uncorrected": [[p per target]...], "corrected": [...],
        "ci_uncorrected": [[(lo,hi)...]...], "ci_corrected": [...],
      },
      "success_counts_uncorrected": [[k per target]...],
      "success_counts_corrected":   [[...]...],
      "convergence_rate": [per g], "converged_counts": [per g],
      "joint_uncorrected_rate": [per g], "joint_corrected_rate": [per g],
      "success_count_histogram_uncorrected": [[...k+1]...],
      "success_count_histogram_corrected":   [[...]...],
      "overall_significant_rate": [per g] | None,
      "overall_significant_ci":   [(lo,hi) per g] | None,
      "posthoc": {factor_label: {pair_label: {"power": [per g], "ci": [...]}}},
      "estimator_extras": {...}, "warnings": [str...],
    }
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..engine.spec import SimSpec
from .aggregation import rate, wilson_ci


def _converged_mean(total, converged_counts) -> np.ndarray:
    """Per-grid mean of a diagnostic summed over CONVERGED sims only (the
    engine masks non-converged contributions to zero before the device sum)."""
    return np.asarray(total, dtype=np.float64) / np.maximum(
        np.asarray(converged_counts, dtype=np.float64), 1.0
    )


def fold_counts(
    spec: SimSpec,
    counts: Dict[str, np.ndarray],
    *,
    target_labels: Sequence[str],
    posthoc_labels: Optional[Dict[str, List[str]]] = None,
    warnings: Optional[List[str]] = None,
) -> Dict:
    """Fold one scenario's device counters into the host result tree."""
    n_done = int(counts["n_done"])
    n_grid = spec.n_grid
    k = spec.n_targets

    sig_unc = np.asarray(counts["sig_unc"], dtype=np.int64).reshape(n_grid, k)
    sig_corr = np.asarray(counts["sig_corr"], dtype=np.int64).reshape(n_grid, k)
    converged = np.asarray(counts["converged"], dtype=np.int64).reshape(n_grid)

    p_unc = sig_unc / max(n_done, 1)
    p_corr = sig_corr / max(n_done, 1)
    ci_unc_lo, ci_unc_hi = wilson_ci(sig_unc, n_done)
    ci_corr_lo, ci_corr_hi = wilson_ci(sig_corr, n_done)
    p_unc_l = p_unc.tolist()
    p_corr_l = p_corr.tolist()
    ci_unc_l = np.stack([ci_unc_lo, ci_unc_hi], axis=-1).tolist()
    ci_corr_l = np.stack([ci_corr_lo, ci_corr_hi], axis=-1).tolist()

    result: Dict = {
        "n_sims": n_done,
        "sample_sizes": list(spec.grid),
        "target_labels": list(target_labels),
        "estimator": spec.estimator,
        "alpha_correction": spec.correction,
        "scenario": spec.scenario.label,
        "powers": {
            "uncorrected": p_unc_l,
            "corrected": p_corr_l,
            "ci_uncorrected": ci_unc_l,
            "ci_corrected": ci_corr_l,
        },
        "success_counts_uncorrected": sig_unc.tolist(),
        "success_counts_corrected": sig_corr.tolist(),
        "converged_counts": converged.tolist(),
        "convergence_rate": (converged / max(n_done, 1)).tolist()
        if n_done
        else [1.0] * n_grid,
        "warnings": list(warnings or []),
        # Flat reference-envelope aliases (result_host.rs:63-140): the
        # reference's raw dict exposes per-N power/CI lists and the integer
        # target layout at the top level — kept so code written against the
        # reference port reads this tree unchanged (EP-1 contract:
        # len(power_uncorrected[g]) == len(target_indices) +
        # len(contrast_pairs)).
        "n_sample_sizes": n_grid,
        "n_targets": k,
        "target_indices": [int(c) for c in spec.target_cols],
        "contrast_pairs": [[int(a), int(b)] for a, b in spec.contrasts],
        "power_uncorrected": p_unc_l,
        "power_corrected": p_corr_l,
        "ci_uncorrected": ci_unc_l,
        "ci_corrected": ci_corr_l,
    }

    # Boundary-hit rates at the result-envelope top level (reference
    # output/results.py add_boundary_hit_rates): tau_zero = τ̂ pinned at 0
    # (boundary code 1), high_tau = upper-edge variance pin (code 2, Brent
    # intercept path only). Zero-filled for OLS/GLM so the keys are always
    # present with convergence_rate's shape.
    bh_lo = counts.get("boundary_hit")
    bh_hi = counts.get("boundary_hi")
    result["boundary_hit_rate_tau_zero"] = (
        rate(bh_lo, n_done).tolist() if bh_lo is not None else [0.0] * n_grid
    )
    result["boundary_hit_rate_high_tau"] = (
        rate(bh_hi, n_done).tolist() if bh_hi is not None else [0.0] * n_grid
    )

    if "joint_unc" in counts:
        result["joint_counts_uncorrected"] = np.asarray(counts["joint_unc"]).tolist()
        result["joint_counts_corrected"] = np.asarray(counts["joint_corr"]).tolist()
        result["joint_uncorrected_rate"] = rate(
            counts["joint_unc"], n_done
        ).tolist()
        result["joint_corrected_rate"] = rate(counts["joint_corr"], n_done).tolist()
        result["success_count_histogram_uncorrected"] = np.asarray(
            counts["nsig_hist_unc"]
        ).tolist()
        result["success_count_histogram_corrected"] = np.asarray(
            counts["nsig_hist_corr"]
        ).tolist()

    if "overall" in counts:
        k_ov = np.asarray(counts["overall"], dtype=np.int64)
        lo, hi = wilson_ci(k_ov, n_done)
        result["overall_counts"] = k_ov.tolist()
        result["overall_significant_rate"] = rate(k_ov, n_done).tolist()
        result["overall_significant_ci"] = np.stack(
            [np.atleast_1d(lo), np.atleast_1d(hi)], axis=-1
        ).tolist()

    if "factor_excluded" in counts:
        fx = np.asarray(counts["factor_excluded"], dtype=np.int64)
        result["factor_exclusion_counts"] = fx.tolist()
        max_rate = rate(fx, n_done)
        worst = float(np.max(np.atleast_1d(max_rate))) if fx.size else 0.0
        from ..config import CONFIG as _CFG

        if worst > _CFG["report"]["thresholds"]["factor_exclusion_max"]:
            result["warnings"].append(
                f"sparse factor levels in {worst:.1%} of simulations (fewer "
                f"than {_CFG['limits']['factor_min_level_count']} rows in a "
                "cell) — increase N, rebalance proportions, or drop levels"
            )

    if "posthoc_sig" in counts and posthoc_labels:
        ph_counts = np.asarray(counts["posthoc_sig"], dtype=np.int64)
        result["posthoc_counts"] = ph_counts.tolist()
        ph_out: Dict = {}
        col = 0
        for flabel, pair_labels in posthoc_labels.items():
            ph_out[flabel] = {}
            for plabel in pair_labels:
                kc = ph_counts[:, col]
                lo, hi = wilson_ci(kc, n_done)
                ph_out[flabel][plabel] = {
                    "power": rate(kc, n_done).tolist(),
                    "ci": np.stack([np.atleast_1d(lo), np.atleast_1d(hi)], axis=-1).tolist(),
                }
                col += 1
        result["posthoc"] = ph_out

    extras: Dict = {}
    if spec.estimator == "glm":
        if "glm_baseline" in counts:
            extras["baseline_prob_realized"] = (
                np.asarray(counts["glm_baseline"]) / max(n_done, 1)
            ).tolist()
        if "singular" in counts:
            extras["singular_fit_rate"] = rate(counts["singular"], n_done).tolist()
        if "separation_fallback" in counts:
            extras["separation_fallback_rate"] = rate(
                counts["separation_fallback"], n_done
            ).tolist()
        if "tau2_hat" in counts:
            extras["tau_squared_hat_mean"] = _converged_mean(
                counts["tau2_hat"], converged
            ).tolist()
    elif spec.estimator == "mle":
        if "tau2_hat" in counts:
            tau2_mean = _converged_mean(counts["tau2_hat"], converged)
            extras["tau_estimate"] = np.sqrt(np.maximum(tau2_mean, 0.0)).tolist()
            extras["tau_squared_hat_mean"] = tau2_mean.tolist()
        if "boundary_hit" in counts:
            extras["boundary_hits"] = np.asarray(counts["boundary_hit"]).tolist()
            extras["boundary_hit_rate"] = rate(counts["boundary_hit"], n_done).tolist()
    if spec.estimator in ("glm", "mle") and "pinned_comp" in counts:
        # Per-variance-component boundary-pin diagnostics, diagonal-theta
        # order [intercept, slope_0, ..., extra_1, ...]; rate denominator is
        # the per-grid converged count (reference pinned_components →
        # boundary_rate_per_component, result.rs:360-398).
        pc = np.asarray(counts["pinned_comp"], dtype=np.int64)  # (G, n_comp)
        conv = np.maximum(np.asarray(converged, dtype=np.float64), 1.0)
        extras["boundary_component_counts"] = pc.tolist()
        extras["boundary_rate_per_component"] = (
            pc / conv[:, None]
        ).tolist()
    if extras:
        result["estimator_extras"] = {spec.estimator: extras}

    return result


