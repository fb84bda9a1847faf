"""Projection: registry + setter state -> one SimulationContract per scenario.

The single lowering every host shares (reference:
crates/engine-spec-builder/src/project_contract.rs:39
``build_linear_contract_with_skeleton``): resolves names to label-free
column/term indices, expands factors to dummy design terms, interactions over
factor dummies, builds the correlation block, cluster spec, targets and
posthoc blocks, and stamps one scenario block per requested scenario.
"""

from __future__ import annotations

import math
import re as _re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import SCENARIO_PRESETS
from ..contract.types import (
    ClusterSpec,
    ColumnSpec,
    GenerationSpec,
    GroupingSpec,
    OutcomeSpec,
    PosthocSpec,
    ResidualSpec,
    ScenarioBlock,
    SimulationContract,
    SlopeTerm,
    TestSpec,
    EstimatorSpec,
)
from .variables import VariableRegistry

_LEVEL = _re.compile(r"^([A-Za-z_][A-Za-z0-9_.]*)\[(.+)\]$")


@dataclass
class ProjectedScenario:
    label: str
    contract: SimulationContract
    target_labels: List[str]
    posthoc_labels: Optional[Dict[str, List[str]]] = None
    warnings: List[str] = field(default_factory=list)


def _scenario_block(
    label: str, cfg: Dict[str, Any], has_cluster: bool = True
) -> ScenarioBlock:
    base = dict(SCENARIO_PRESETS.get(label, SCENARIO_PRESETS["optimistic"]))
    base.update(cfg or {})
    if not has_cluster:
        # LME-scenario gating (invariant 13): the lme knob block is inert
        # without clustering — strip it so preset scenarios run on any design.
        base["random_effect_dist"] = "normal"
        base["icc_noise_sd"] = 0.0
    return ScenarioBlock(
        label=label,
        heterogeneity=float(base["heterogeneity"]),
        heteroskedasticity_ratio=float(base["heteroskedasticity_ratio"]),
        correlation_noise_sd=float(base["correlation_noise_sd"]),
        sampled_factor_proportions=bool(base["sampled_factor_proportions"]),
        truth_start=bool(base["truth_start"]),
        distribution_change_prob=float(base["distribution_change_prob"]),
        new_distributions=list(base["new_distributions"]),
        residual_change_prob=float(base["residual_change_prob"]),
        residual_dists=list(base["residual_dists"]),
        residual_df=float(base["residual_df"]),
        random_effect_dist=str(base["random_effect_dist"]),
        random_effect_df=float(base["random_effect_df"]),
        icc_noise_sd=float(base["icc_noise_sd"]),
    )


def build_contracts(
    registry: VariableRegistry,
    *,
    outcome_kind: str = "continuous",
    link: Optional[str] = None,
    estimator: str = "ols",
    intercept: float = 0.0,
    effects: Optional[Dict[str, float]] = None,
    correlation_matrix: Optional[Sequence[Sequence[float]]] = None,
    correlation_pairs: Optional[Sequence[Tuple[Tuple[str, str], float]]] = None,
    residual: Tuple[str, bool] = ("normal", False),
    het_driver_name: Optional[str] = None,
    clusters: Optional[Dict[str, Dict[str, Any]]] = None,
    alpha: float = 0.05,
    correction: str = "none",
    tests: Optional[Dict] = None,  # resolve_tests output
    scenario_labels: Sequence[str] = ("optimistic",),
    scenario_configs: Optional[Dict[str, Dict[str, Any]]] = None,
    wald_se: str = "rx",
    nagq: int = 1,
    max_failed_fraction: float = 0.1,
    effective_n_clusters: Optional[int] = None,
    upload=None,  # data.upload.UploadedData
) -> List[ProjectedScenario]:
    effects = effects or {}
    parsed = registry.parsed
    upload_names = (
        [n for n in registry.predictor_names if upload and n in upload.columns]
        if upload
        else []
    )
    frame_col_of = {n: i for i, n in enumerate(upload_names)}

    # --- generation columns (one per predictor, registry order) ---
    columns: List[ColumnSpec] = []
    col_of: Dict[str, int] = {}
    for name in registry.predictor_names:
        info = registry.var_info(name)
        vt = info["type"]
        up = upload.columns.get(name) if (upload and name in frame_col_of) else None
        if up is not None and up.kind == "factor":
            columns.append(
                ColumnSpec(
                    kind="factor_from_frame",
                    n_levels=up.n_levels,
                    proportions=list(up.proportions),
                    frame_col=frame_col_of[name],
                    sampled=info.get("sampled_proportions"),
                )
            )
        elif up is not None and up.kind == "binary":
            columns.append(
                ColumnSpec(
                    kind="resampled_binary",
                    param=up.param,
                    frame_col=frame_col_of[name],
                    pinned=True,
                )
            )
        elif up is not None:
            columns.append(
                ColumnSpec(
                    kind="resampled",
                    frame_col=frame_col_of[name],
                    pinned=True,
                )
            )
        elif vt == "factor":
            columns.append(
                ColumnSpec(
                    kind="factor_synthetic",
                    n_levels=int(info.get("n_levels", 3)),
                    proportions=list(
                        info.get("proportions", [])
                        or [1.0 / info.get("n_levels", 3)] * info.get("n_levels", 3)
                    ),
                    # per-factor allocation override (reference
                    # variables.py:266-280 sampled_proportions kwarg:
                    # None = inherit the scenario default)
                    sampled=info.get("sampled_proportions"),
                )
            )
        elif vt == "binary":
            columns.append(
                ColumnSpec(
                    kind="synthetic",
                    dist="binary",
                    param=float(info.get("proportion", 0.5)),
                    pinned=registry._pinned[name],
                )
            )
        else:
            columns.append(
                ColumnSpec(kind="synthetic", dist=vt, pinned=registry._pinned[name])
            )
        col_of[name] = len(columns) - 1

    # --- design terms + effect-name maps ---
    design: List[Tuple] = [("const",)]
    coeffs: List[float] = [0.0]
    term_of_effect: Dict[str, int] = {}

    for t in parsed.terms:
        if t["kind"] != "main":
            continue
        name = t["name"]
        if registry.var_info(name)["type"] == "factor":
            for lvl in range(2, registry.factor_levels(name) + 1):
                design.append(("dummy", col_of[name], lvl - 1))
                label = f"{name}[{registry.factor_level_label(name, lvl)}]"
                term_of_effect[label] = len(design) - 1
                coeffs.append(float(effects.get(label, 0.0)))
        else:
            design.append(("direct", col_of[name]))
            term_of_effect[name] = len(design) - 1
            coeffs.append(float(effects.get(name, 0.0)))

    for t in parsed.terms:
        if t["kind"] != "interaction":
            continue
        base_name = ":".join(t["vars"])
        for label, parts in registry.interaction_effect_names(t["vars"]):
            comp_terms = []
            for v, lvl in parts:
                key = (
                    v if lvl == 0
                    else f"{v}[{registry.factor_level_label(v, lvl)}]"
                )
                if key not in term_of_effect:
                    raise ValueError(
                        f"interaction component {key!r} has no main design term"
                    )
                comp_terms.append(term_of_effect[key])
            design.append(("interaction", comp_terms))
            term_of_effect[label] = len(design) - 1
            coeffs.append(float(effects.get(label, effects.get(base_name, 0.0))))

    unknown_effects = set(effects) - set(term_of_effect)
    if unknown_effects:
        raise ValueError(f"effects set for unknown terms: {sorted(unknown_effects)}")

    # --- correlations over the continuous block ---
    non_factor = registry.non_factor_names
    corr = None
    if correlation_matrix is not None:
        corr = [list(map(float, row)) for row in correlation_matrix]
        if len(corr) != len(non_factor):
            raise ValueError(
                f"correlation matrix is {len(corr)}x{len(corr)}, but there are "
                f"{len(non_factor)} non-factor predictors"
            )
    if upload and upload.measured_correlations:
        # Measured Spearman->latent correlations seed the matrix; explicit
        # user pairs (below) take precedence (upload.rs measure_correlations).
        m = np.asarray(corr, dtype=np.float64) if corr else np.eye(len(non_factor))
        idx = {n: i for i, n in enumerate(non_factor)}
        for (a, b), r in upload.measured_correlations.items():
            if a in idx and b in idx:
                m[idx[a], idx[b]] = m[idx[b], idx[a]] = float(r)
        corr = m.tolist()
    if correlation_pairs:
        m = np.asarray(corr, dtype=np.float64) if corr else np.eye(len(non_factor))
        idx = {n: i for i, n in enumerate(non_factor)}
        for (a, b), r in correlation_pairs:
            if a not in idx or b not in idx:
                raise ValueError(
                    f"correlations are continuous-only; {a!r}/{b!r} must be "
                    "non-factor predictors"
                )
            m[idx[a], idx[b]] = m[idx[b], idx[a]] = float(r)
        corr = m.tolist()

    # --- cluster spec from set_cluster state + parsed REs ---
    cluster = None
    warnings: List[str] = []
    if clusters:
        parsed_groups = [re.group for re in parsed.random_effects]
        primary_name = None
        for g in parsed_groups:
            if g in clusters and ":" not in g:
                primary_name = g
                break
        if primary_name is None:
            raise ValueError(
                f"no cluster configuration matches a formula grouping; "
                f"groupings: {parsed_groups}, configured: {list(clusters)}"
            )
        cfg = clusters[primary_name]
        tau2 = _tau_squared(cfg, outcome_kind, link)
        slopes = _slope_terms(cfg, registry, col_of)
        if cfg.get("n_clusters"):
            sizing_mode, sizing_value = "fixed_clusters", int(cfg["n_clusters"])
        elif cfg.get("cluster_size"):
            sizing_mode, sizing_value = "fixed_size", int(cfg["cluster_size"])
        elif effective_n_clusters:
            sizing_mode, sizing_value = "fixed_clusters", int(effective_n_clusters)
        else:
            raise ValueError(
                f"set_cluster({primary_name!r}) needs n_clusters= or cluster_size="
            )
        between = [
            col_of[v]
            for v in (cfg.get("cluster_level_vars") or [])
        ]
        extras: List[GroupingSpec] = []
        for g in parsed_groups:
            if g == primary_name or g not in clusters:
                continue
            gcfg = clusters[g]
            if ":" in g:  # nested child "A:B"
                npp = gcfg.get("n_per_parent")
                if not npp:
                    raise ValueError(
                        f"nested grouping {g!r} needs n_per_parent="
                    )
                extras.append(
                    GroupingSpec(
                        relation="nested",
                        n_clusters=int(npp),
                        tau_squared=_tau_squared(gcfg, outcome_kind, link),
                        slopes=_slope_terms(gcfg, registry, col_of),
                    )
                )
            else:
                extras.append(
                    GroupingSpec(
                        relation="crossed",
                        n_clusters=int(gcfg.get("n_clusters") or 0),
                        tau_squared=_tau_squared(gcfg, outcome_kind, link),
                        slopes=_slope_terms(gcfg, registry, col_of),
                    )
                )
        unconfigured = [
            g for g in parsed_groups if g not in clusters
        ]
        if unconfigured:
            warnings.append(
                f"random-effect groupings without set_cluster config: "
                f"{unconfigured} (generated with tau^2 = 0)"
            )
        cluster = ClusterSpec(
            sizing_mode=sizing_mode,
            sizing_value=sizing_value,
            tau_squared=tau2,
            slopes=slopes,
            extra_groupings=extras,
            between_columns=between,
        )

    # --- tests ---
    tests = tests or {"targets": list(term_of_effect), "contrast_pairs": [],
                      "report_overall": False, "posthoc_factors": []}
    targets: List[Tuple] = []
    target_labels: List[str] = []
    for name in tests["targets"]:
        if name not in term_of_effect:
            raise ValueError(f"unknown test target {name!r}")
        targets.append(("marginal", term_of_effect[name]))
        target_labels.append(name)
    for a, b in tests.get("contrast_pairs", []):
        ta = _contrast_term(a, registry, term_of_effect)
        tb = _contrast_term(b, registry, term_of_effect)
        if ta is None and tb is None:
            raise ValueError(f"contrast {a} vs {b}: both sides are the reference")
        if tb is None:
            targets.append(("marginal", ta))
        elif ta is None:
            targets.append(("marginal", tb))
        else:
            targets.append(("contrast", ta, tb))
        target_labels.append(f"{a} vs {b}")

    posthoc_specs: List[PosthocSpec] = []
    posthoc_labels: Dict[str, List[str]] = {}
    for fname in tests.get("posthoc_factors", []):
        k = registry.factor_levels(fname)
        terms = [term_of_effect[d] for d in registry.dummy_names(fname)]
        posthoc_specs.append(PosthocSpec(factor_column=col_of[fname], terms=terms))
        labels = []
        lab = registry.factor_level_label
        for a in range(1, k + 1):
            for b in range(a + 1, k + 1):
                labels.append(
                    f"{fname}[{lab(fname, a)}] vs {fname}[{lab(fname, b)}]"
                )
        posthoc_labels[fname] = labels

    frame = None
    if upload and upload_names:
        from ..contract.types import UploadedFrame

        mat = upload.frame_matrix(upload_names)
        frame = UploadedFrame(
            n_rows=int(mat.shape[0]),
            n_cols=int(mat.shape[1]),
            data=[float(v) for v in mat.reshape(-1)],
            bootstrap=upload.mode == "strict",
        )

    out: List[ProjectedScenario] = []
    for label in scenario_labels:
        cfg = (scenario_configs or {}).get(label, {})
        contract = SimulationContract(
            generation=GenerationSpec(
                columns=[ColumnSpec(**vars(c)) for c in columns],
                correlations=corr or [],
                cluster=cluster,
                frame=frame,
            ),
            design=list(design),
            outcome=OutcomeSpec(
                kind=outcome_kind,
                link=link,
                intercept=float(intercept),
                coefficients=list(coeffs),
                residual=ResidualSpec(dist=residual[0], pinned=residual[1]),
                heteroskedasticity_column=(
                    col_of[het_driver_name] if het_driver_name else None
                ),
            ),
            estimator=EstimatorSpec(kind=estimator, wald_se=wald_se, nagq=nagq),
            test=TestSpec(
                targets=list(targets),
                correction=correction,
                alpha=alpha,
                posthoc=posthoc_specs,
                report_overall=tests.get("report_overall", False),
            ),
            scenario=_scenario_block(label, cfg, has_cluster=cluster is not None),
            max_failed_fraction=max_failed_fraction,
        )
        out.append(
            ProjectedScenario(
                label=label,
                contract=contract,
                target_labels=list(target_labels),
                posthoc_labels=posthoc_labels or None,
                warnings=list(warnings),
            )
        )
    return out


def _tau_squared(
    cfg: Dict[str, Any], outcome_kind: str = "continuous",
    link: Optional[str] = None,
) -> float:
    """Family/link-aware ICC -> tau^2 (reference ports/py model.py
    ``_encode``' Decision 8/9 block, mirrored by R spec-builder.R
    .encode_outcome_and_clusters):

    - explicit tau_squared wins (Poisson REQUIRES it — no latent ICC scale
      exists for a log-link count model);
    - binary logit: ``icc/(1-icc) * pi^2/3`` (log-odds residual variance);
    - binary probit: ``icc/(1-icc) * 1`` (latent residual variance is 1);
    - gaussian: ``icc/(1-icc)`` (standardized sigma^2 = 1).
    """
    if cfg.get("tau_squared") is not None:
        return float(cfg["tau_squared"])
    icc = float(cfg.get("icc", 0.0) or 0.0)
    if icc <= 0.0:
        return 0.0
    if icc >= 1.0:
        raise ValueError("ICC must be < 1")
    if outcome_kind == "count":
        raise ValueError(
            "count-outcome clusters are sized by tau_squared=, not ICC"
        )
    if outcome_kind == "binary" and link != "probit":
        scale = math.pi * math.pi / 3.0  # logit latent residual variance
    else:
        scale = 1.0
    return icc / (1.0 - icc) * scale


def _slope_terms(cfg, registry, col_of) -> List[SlopeTerm]:
    out = []
    for v in cfg.get("random_slopes") or []:
        if v not in col_of:
            raise ValueError(f"random slope variable {v!r} is not a predictor")
        out.append(
            SlopeTerm(
                column=col_of[v],
                variance=float(cfg.get("slope_variance", 0.0)),
                intercept_corr=float(cfg.get("slope_intercept_corr", 0.0)),
            )
        )
    return out


def _contrast_term(token: str, registry, term_of_effect) -> Optional[int]:
    """Map a contrast side to its design term; None = factor reference level.

    Label-aware: the reference level is the side whose bracket text equals
    the factor's LEVEL-1 LABEL (the uploaded data value when labels came
    from pilot data), never a literal '1' — with labels ['0','1','2'],
    'g[1]' is the dummy for data value 1 and 'g[0]' is the baseline."""
    m = _LEVEL.match(token)
    if (
        m
        and m.group(1) in registry.factor_names
        and m.group(2) == registry.factor_level_label(m.group(1), 1)
    ):
        return None
    if token in term_of_effect:
        return term_of_effect[token]
    raise ValueError(f"unknown contrast side {token!r}")
