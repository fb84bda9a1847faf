"""Single-source runtime configuration (typed, embedded defaults).

Mirrors the role of the reference's ``configs/config.json`` +
``configs/scenarios.json`` single-source config (embedded at build into
``engine_contract::CONFIG_JSON``; see reference ``crates/engine-contract/src/
config.rs`` and ``crates/engine-orchestrator/src/lib.rs:36-51``): one place
that every layer — engine lowering, orchestrator, user API, reports — reads
defaults and limits from, so no table is ever duplicated per port. Values are
kept numerically identical to the reference's defaults so a user switching
frameworks sees the same behavior (seed 2137, alpha .05, target power .8,
n_sims 1600/800/1000, grid bounds 30..200, etc.).

The model states *structure* (what varies), the scenario states *magnitude*
(how much) — scenario presets below are the optimistic/realistic/doomer
triple from the reference's scenarios.json.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

CONFIG: Dict[str, Any] = {
    "simulation": {
        "seed": 2137,
        "alpha": 0.05,
        "target_power": 0.8,
        "n_sims": {"ols": 1600, "mixed": 800, "anova": 1000},
        "max_failed_fraction": 0.1,
        "sample_size_bounds": {"from": 30, "to": 200, "by": "auto"},
        "cluster_auto_count": 12,
        # Target progress beats per scenario run. Each beat is one device
        # dispatch (chunk), so this trades host-sync/cancel granularity
        # against per-dispatch batch size; the reference's thread loop
        # reports ~50x/run (batch.rs:449) but pays nothing per report —
        # here chunks below ~256 sims start to under-fill the device.
        "progress_beats": 8,
        "min_chunk_sims": 256,
    },
    "estimation": {
        # GLMM defaults: wald_se "rx" is the fast Schur SE mode; "hessian"
        # the accurate opt-in. nagq 1 = Laplace.
        "wald_se": "rx",
        "nagq": 1,
    },
    "benchmarks": {
        "continuous": [0.1, 0.25, 0.4],
        "binary_factor": [0.2, 0.5, 0.8],
        # log odds-ratios for OR = 1.5 / 2.5 / 4.0
        "odds": [0.405, 0.916, 1.386],
    },
    "limits": {
        "max_alpha": 0.25,
        "icc_stability": [0.05, 0.95],
        "baseline_p_warn": [0.05, 0.95],
        "factor_levels": [2, 20],
        "min_clusters": 5,
        "min_rows_per_cluster": 2,
        "reliable_rows_per_cluster": 5,
        "recommended_rows_per_cluster": 10,
        "factor_min_level_count": 5,
        "max_primary_q": 4,
        "max_extra_groupings": 2,
        "max_extra_q": 3,
    },
    "report": {
        "format": {
            "power_decimals_short": 1,
            "power_decimals_long": 1,
            "target_decimals": 0,
            "drop_decimals": 1,
            "joint_table_decimals": 1,
        },
        "thresholds": {
            "convergence_min": 0.95,
            "lme_boundary_hit_max": 0.01,
            "glm_baseline_drift_max": 0.05,
            "factor_exclusion_max": 0.0,
            "glmm_tau_sq_warn": 1.0,
        },
        "baseline_scenario": {"prefer_label": "optimistic", "fallback_to_first": True},
        "overall_label_by_estimator": {
            "ols": "Overall F",
            "glm": "LR χ²",
            "mle": "Wald χ²",
        },
        # Interpretive strings — kept textually identical to the reference's
        # configs/config.json report.text so reports read the same across
        # frameworks (single-source text, never duplicated per port).
        "text": {
            "long_title": "MCPower · Power Analysis",
            "main_caption": "Per-test power",
            "uncorrected_suffix": " — Uncorrected",
            "corrected_suffix": " — Corrected",
            "ci_caption": "Power & 95% CI",
            "ci_footnote": "95% CIs are Monte-Carlo (Wilson), n_sims={n_sims}.",
            "estimator_extras_caption": "Estimator details",
            "sample_size_caption": "Required sample size per effect",
            "required_n_ci_caption": "Required N & 95% CI",
            "required_n_ci_footnote": (
                "Required N from the model-based crossing fit (isotonic); "
                "CI by Wilson band inversion, rounded outward."
            ),
            "required_n_ci_footnote_appr": (
                "appr. = probit extrapolation beyond the search range — "
                "rerun with a higher `to` to confirm."
            ),
            "required_n_ci_footnote_suppressed": (
                "— = fit suppressed ({labels}: non-monotone within the grid)."
            ),
            "required_n_ci_footnote_floor": (
                "≤ = target reached at or below the search floor — rerun "
                "with a lower `from` to localise."
            ),
            "non_monotone_warning": (
                "⚠ {label}: power not monotone in N (max drop {drop} > MC "
                "noise); model-based fit suppressed — grid value shown."
            ),
            "vs_token": "vs",
            "columns": {
                "test": "Test",
                "power": "Power",
                "target": "Target",
                "or": "OR",
                "ci": "CI 95%",
                "required_n": "Required N",
                "uncorrected": "uncorrected",
                "corrected": "corrected",
            },
        },
    },
    "upload": {
        "max_rows": 1_000_000,
        "min_rows": 20,
        "max_factor_k_soft": 7,
        "max_factor_ratio": 15,
        "strict_warning_ratio": 2.0,
    },
    "correction_aliases": {
        "bh": "benjamini_hochberg",
        "fdr": "benjamini_hochberg",
        "tukey": "tukey_hsd",
    },
}

# Robustness scenario presets. The optimistic preset is the no-perturbation
# baseline every single-scenario run uses implicitly.
SCENARIO_PRESETS: Dict[str, Dict[str, Any]] = {
    "optimistic": {
        "heterogeneity": 0.0,
        "heteroskedasticity_ratio": 1.0,
        "correlation_noise_sd": 0.0,
        "sampled_factor_proportions": False,
        "truth_start": True,
        "distribution_change_prob": 0.0,
        "new_distributions": ["right_skewed", "left_skewed", "uniform"],
        "random_effect_dist": "normal",
        "random_effect_df": 5,
        "icc_noise_sd": 0.0,
        "residual_dists": ["high_kurtosis", "right_skewed"],
        "residual_change_prob": 0.0,
        "residual_df": 10,
    },
    "realistic": {
        "heterogeneity": 0.2,
        "heteroskedasticity_ratio": 2.0,
        "correlation_noise_sd": 0.15,
        "sampled_factor_proportions": True,
        "truth_start": False,
        "distribution_change_prob": 0.5,
        "new_distributions": ["right_skewed", "left_skewed", "uniform"],
        "random_effect_dist": "heavy_tailed",
        "random_effect_df": 10,
        "icc_noise_sd": 0.15,
        "residual_dists": ["high_kurtosis", "right_skewed"],
        "residual_change_prob": 0.5,
        "residual_df": 8,
    },
    "doomer": {
        "heterogeneity": 0.4,
        "heteroskedasticity_ratio": 4.0,
        "correlation_noise_sd": 0.3,
        "sampled_factor_proportions": True,
        "truth_start": False,
        "distribution_change_prob": 0.8,
        "new_distributions": ["right_skewed", "left_skewed", "uniform"],
        "random_effect_dist": "heavy_tailed",
        "random_effect_df": 5,
        "icc_noise_sd": 0.3,
        "residual_dists": ["high_kurtosis", "right_skewed"],
        "residual_change_prob": 0.8,
        "residual_df": 5,
    },
}

DISTRIBUTION_NAMES = (
    "normal",
    "binary",
    "right_skewed",
    "left_skewed",
    "high_kurtosis",
    "uniform",
)

RESIDUAL_NAMES = ("normal", "right_skewed", "left_skewed", "high_kurtosis", "uniform")

CORRECTION_NAMES = ("none", "bonferroni", "holm", "benjamini_hochberg", "tukey_hsd")
# Wire codes pinned for serialization parity with the reference contract
# (crates/engine-contract/src/test_spec.rs:38-57).
CORRECTION_CODES = {name: i for i, name in enumerate(CORRECTION_NAMES)}


def config() -> Dict[str, Any]:
    """A deep copy of the embedded config (callers may mutate freely)."""
    return copy.deepcopy(CONFIG)


def get_simulation_defaults() -> Dict[str, Any]:
    return copy.deepcopy(CONFIG["simulation"])


def get_default_scenario_config() -> Dict[str, Dict[str, Any]]:
    return copy.deepcopy(SCENARIO_PRESETS)


def normalize_correction(name) -> str:
    """Resolve a user correction string (aliases, case) to the canonical name."""
    if name is None:
        return "none"
    # Separator-insensitive like the reference port: "Benjamini-Hochberg",
    # "benjamini hochberg", and "Tukey-HSD" all resolve.
    key = str(name).strip().lower().replace("-", "_").replace(" ", "_")
    key = CONFIG["correction_aliases"].get(key, key)
    if key not in CORRECTION_NAMES:
        raise ValueError(
            f"unknown correction {name!r}; expected one of {CORRECTION_NAMES} "
            f"or aliases {sorted(CONFIG['correction_aliases'])}"
        )
    return key
