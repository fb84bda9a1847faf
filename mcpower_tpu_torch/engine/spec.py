"""Lowered simulation spec: the static/traced split the XLA engine runs on.

The reference lowers its wire contract into a flat POD ``SimulationSpec``
(crates/engine-core/src/spec.rs:251-417) consumed by a Rust hot loop. The
TPU-native equivalent splits that POD along XLA's compilation model:

* :class:`SimSpec` — the **static** half: shapes, column layout, estimator
  arm, grid, scenario switches. Frozen, hashable; it keys the jit cache, so
  every distinct design compiles exactly one XLA program and reuses it across
  chunks, scenarios with identical structure, and devices.
* ``arrays`` — the **traced** half: a dict of small device arrays (effect
  sizes, correlation matrix, factor proportions, crit tables...). Changing
  magnitudes never recompiles.

Column layout of the design plane ``X`` (identical to the reference,
crates/engine-core/src/data_gen.rs:87):

    [ intercept | continuous/binary predictors | factor dummies | interactions ]

Factors are reference-coded: a k-level factor owns k-1 dummy columns; level 0
is the reference. Interaction columns are elementwise products of earlier
columns.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

# Integer codes for predictor marginal distributions (device-side dispatch).
DIST_NORMAL = 0
DIST_BINARY = 1
DIST_RIGHT_SKEWED = 2
DIST_LEFT_SKEWED = 3
DIST_HIGH_KURTOSIS = 4
DIST_UNIFORM = 5
DIST_UPLOADED = 6
DIST_UPLOADED_BINARY = 7

DIST_CODES = {
    "normal": DIST_NORMAL,
    "binary": DIST_BINARY,
    "right_skewed": DIST_RIGHT_SKEWED,
    "left_skewed": DIST_LEFT_SKEWED,
    "high_kurtosis": DIST_HIGH_KURTOSIS,
    "uniform": DIST_UNIFORM,
    "uploaded": DIST_UPLOADED,
    "uploaded_binary": DIST_UPLOADED_BINARY,
}

RESID_NORMAL = 0
RESID_RIGHT_SKEWED = 1
RESID_LEFT_SKEWED = 2
RESID_HIGH_KURTOSIS = 3
RESID_UNIFORM = 4

RESID_CODES = {
    "normal": RESID_NORMAL,
    "right_skewed": RESID_RIGHT_SKEWED,
    "left_skewed": RESID_LEFT_SKEWED,
    "high_kurtosis": RESID_HIGH_KURTOSIS,
    "uniform": RESID_UNIFORM,
}


@dataclass(frozen=True)
class ScenarioStatic:
    """Per-scenario DGP perturbation knobs (static: scenarios re-jit).

    Semantics mirror the reference's ScenarioPerturbations
    (crates/engine-contract/src/scenarios.rs:11-44): heterogeneity is the
    per-study beta-jitter ratio tau/|beta|; heteroskedasticity_ratio is the
    variance ratio lambda; correlation noise is a symmetric Gaussian on the
    off-diagonals with PSD repair; distribution/residual swaps hit unpinned
    columns with the given probability.
    """

    label: str = "optimistic"
    heterogeneity: float = 0.0
    heteroskedasticity_ratio: float = 1.0
    correlation_noise_sd: float = 0.0
    sampled_factor_proportions: bool = False
    truth_start: bool = True
    distribution_change_prob: float = 0.0
    new_distributions: Tuple[str, ...] = ("right_skewed", "left_skewed", "uniform")
    residual_change_prob: float = 0.0
    residual_dists: Tuple[str, ...] = ("high_kurtosis", "right_skewed")
    residual_df: float = 10.0
    random_effect_dist: str = "normal"
    random_effect_df: float = 5.0
    icc_noise_sd: float = 0.0

    @property
    def is_baseline(self) -> bool:
        """True when no perturbation is active (the fast no-scenario path)."""
        return (
            self.heterogeneity <= 0.0
            and self.heteroskedasticity_ratio <= 1.0
            and self.correlation_noise_sd <= 0.0
            and self.distribution_change_prob <= 0.0
            and self.residual_change_prob <= 0.0
            and self.icc_noise_sd <= 0.0
            and self.random_effect_dist == "normal"
        )

    @classmethod
    def from_dict(cls, label: str, d: dict) -> "ScenarioStatic":
        return cls(
            label=label,
            heterogeneity=float(d.get("heterogeneity", 0.0)),
            heteroskedasticity_ratio=float(d.get("heteroskedasticity_ratio", 1.0)),
            correlation_noise_sd=float(d.get("correlation_noise_sd", 0.0)),
            sampled_factor_proportions=bool(d.get("sampled_factor_proportions", False)),
            truth_start=bool(d.get("truth_start", True)),
            distribution_change_prob=float(d.get("distribution_change_prob", 0.0)),
            new_distributions=tuple(d.get("new_distributions", ())),
            residual_change_prob=float(d.get("residual_change_prob", 0.0)),
            residual_dists=tuple(d.get("residual_dists", ())),
            residual_df=float(d.get("residual_df", 10.0)),
            random_effect_dist=str(d.get("random_effect_dist", "normal")),
            random_effect_df=float(d.get("random_effect_df", 5.0)),
            icc_noise_sd=float(d.get("icc_noise_sd", 0.0)),
        )


@dataclass(frozen=True)
class SlopeStatic:
    """One random slope on the primary grouping."""

    design_col: int  # column of X whose coefficient varies across clusters
    variance: float
    intercept_corr: float


@dataclass(frozen=True)
class ExtraGroupingStatic:
    """A crossed or nested extra grouping factor."""

    relation: str  # "crossed" | "nested"
    n_levels: int  # crossed: level count; nested: levels per parent
    tau_squared: float
    slopes: Tuple[SlopeStatic, ...] = ()


@dataclass(frozen=True)
class ClusterStatic:
    """Primary grouping structure for clustered DGPs.

    sizing_mode "fixed_clusters": cluster id = row % m (round-robin, m fixed,
    size grows with N). "fixed_size": id = row // s (blocks of s; count grows
    with N). Mirrors crates/engine-contract/src/generation.rs:125-158.
    """

    sizing_mode: str  # "fixed_clusters" | "fixed_size"
    sizing_value: int
    tau_squared: float
    slopes: Tuple[SlopeStatic, ...] = ()
    extra_groupings: Tuple[ExtraGroupingStatic, ...] = ()
    # design columns measured at cluster level (broadcast within cluster)
    between_cols: Tuple[int, ...] = ()

    def n_clusters_at(self, n: int) -> int:
        if self.sizing_mode == "fixed_clusters":
            return max(int(self.sizing_value), 1)
        s = max(int(self.sizing_value), 1)
        return (n + s - 1) // s

    @property
    def atom(self) -> int:
        """Grid atom: every valid N is a multiple of this."""
        return max(int(self.sizing_value), 1)

    @property
    def q(self) -> int:
        return 1 + len(self.slopes)


@dataclass(frozen=True)
class PosthocStatic:
    """Post-hoc pairwise contrasts for one factor.

    ``pairs`` are (col_a, col_b) design-column pairs; -1 denotes the
    reference level (contrast against the intercept-absorbed baseline).
    """

    factor_index: int
    n_levels: int
    pairs: Tuple[Tuple[int, int], ...]


@dataclass(frozen=True)
class SimSpec:
    """Static engine spec — one compiled XLA program per distinct value."""

    max_n: int
    grid: Tuple[int, ...]  # ascending; last == max_n
    n_cont: int
    var_types: Tuple[int, ...]  # DIST_* code per continuous/binary column
    var_pinned: Tuple[bool, ...]
    factor_levels: Tuple[int, ...] = ()
    factor_sampled: Tuple[Optional[bool], ...] = ()  # per-factor override
    interactions: Tuple[Tuple[int, ...], ...] = ()
    outcome: str = "continuous"  # "continuous" | "binary" | "count"
    link: str = "canonical"  # "canonical" | "probit"
    estimator: str = "ols"  # "ols" | "glm" | "mle"
    # Columns of X used by the FITTED model (None = all). Tested targets and
    # contrasts index into this tuple's positions.
    fit_cols: Optional[Tuple[int, ...]] = None
    target_cols: Tuple[int, ...] = ()  # fit-column positions of marginal targets
    contrasts: Tuple[Tuple[int, int], ...] = ()  # (pos, neg) fit-col positions
    report_overall: bool = False
    correction: str = "none"
    residual: int = RESID_NORMAL
    residual_pinned: bool = False
    het_driver: Optional[int] = None  # X column driving heteroskedasticity
    cluster: Optional[ClusterStatic] = None
    scenario: ScenarioStatic = field(default_factory=ScenarioStatic)
    posthoc: Tuple[PosthocStatic, ...] = ()
    # GLMM estimation knobs
    wald_se: str = "rx"  # "rx" | "hessian"
    nagq: int = 1
    factor_min_level_count: int = 5
    # Uploaded pilot data (NORTA / strict bootstrap)
    upload_rows: int = 0  # frame row count (0 = no upload)
    bootstrap: bool = False  # strict whole-row resampling
    # per engine continuous column: frame column index or -1 (synthetic);
    # per factor: frame column index or -1
    upload_cont_frame_cols: Tuple[int, ...] = ()
    upload_factor_frame_cols: Tuple[int, ...] = ()

    # ---- derived layout ----
    @property
    def n_factors(self) -> int:
        return len(self.factor_levels)

    @property
    def n_factor_dummies(self) -> int:
        return sum(max(l - 1, 0) for l in self.factor_levels)

    @property
    def n_predictors(self) -> int:
        """Total X columns: intercept + cont + dummies + interactions."""
        return 1 + self.n_cont + self.n_factor_dummies + len(self.interactions)

    @property
    def factor_col_start(self) -> int:
        return 1 + self.n_cont

    def factor_dummy_cols(self, f: int) -> Tuple[int, ...]:
        start = self.factor_col_start + sum(
            max(l - 1, 0) for l in self.factor_levels[:f]
        )
        return tuple(range(start, start + max(self.factor_levels[f] - 1, 0)))

    @property
    def interaction_col_start(self) -> int:
        return 1 + self.n_cont + self.n_factor_dummies

    @property
    def effective_fit_cols(self) -> Tuple[int, ...]:
        return self.fit_cols if self.fit_cols is not None else tuple(
            range(self.n_predictors)
        )

    @property
    def n_targets(self) -> int:
        return len(self.target_cols) + len(self.contrasts)

    @property
    def n_grid(self) -> int:
        return len(self.grid)

    def validate_layout(self) -> None:
        p = self.n_predictors
        assert len(self.var_types) == self.n_cont
        assert self.grid == tuple(sorted(self.grid)), "grid must ascend"
        assert self.grid[-1] == self.max_n
        for cols in self.interactions:
            for c in cols:
                assert 1 <= c < self.interaction_col_start, (
                    "interaction components must be non-intercept base columns"
                )
        fit = self.effective_fit_cols
        assert all(0 <= c < p for c in fit)
        for t in self.target_cols:
            assert 0 <= t < len(fit)
        for a, b in self.contrasts:
            assert 0 <= a < len(fit) and 0 <= b < len(fit)


def factor_dependent_cols(spec: SimSpec, f: int) -> Tuple[int, ...]:
    """Design columns removed when factor ``f`` is excluded: its dummies and
    every interaction touching one of them (reference batch.rs
    build_exclusion_remap, crates/engine-core/src/batch.rs:2502)."""
    dummies = set(spec.factor_dummy_cols(f))
    cols = sorted(dummies)
    for j, comps in enumerate(spec.interactions):
        if any(c in dummies for c in comps):
            cols.append(spec.interaction_col_start + j)
    return tuple(cols)


def tukey_k_per_target(spec: SimSpec) -> Tuple[float, ...]:
    """Studentized-range ``k`` (factor level count) per inference target.

    Mirrors the reference's ``tukey_k_for_kernel_col``
    (crates/engine-core/src/batch.rs:2233): a target pointing at a factor
    dummy column carries that factor's level count L; the intercept, a
    continuous predictor, or an interaction carries NaN (always fails under
    Tukey). Contrast targets take k from the POSITIVE side's column — a
    same-factor pairwise contrast has both sides in the same block either way
    (batch.rs:2353-2365). Order matches the t^2 layout: marginals first,
    then contrasts (waldstats.t2_targets).
    """

    def k_for_col(col: int) -> float:
        for f, levels in enumerate(spec.factor_levels):
            if col in spec.factor_dummy_cols(f):
                return float(levels)
        return float("nan")

    fit = spec.effective_fit_cols
    ks = [k_for_col(fit[pos]) for pos in spec.target_cols]
    ks += [k_for_col(fit[pos_a]) for pos_a, _ in spec.contrasts]
    return tuple(ks)


def max_droppable_fit_cols(spec: SimSpec) -> int:
    """Largest number of FIT columns sparse-factor exclusion can remove
    (sizes the reduced-df crit tables)."""
    fit = set(spec.effective_fit_cols)
    dropped = set()
    for f in range(len(spec.factor_levels)):
        dropped |= set(factor_dependent_cols(spec, f)) & fit
    return len(dropped)


def expected_arrays(spec: SimSpec) -> Dict[str, tuple]:
    """Shapes the `arrays` dict must carry for a given spec (documentation +
    validation helper used by tests)."""
    p = spec.n_predictors
    shapes = {
        "corr": (spec.n_cont, spec.n_cont),  # f64 base correlation
        "var_params": (spec.n_cont,),  # f32 (binary p, etc.)
        "effects": (p,),  # f64 beta per design column
        "factor_props": (sum(spec.factor_levels),),  # f64
        "t2_uncorrected": (spec.n_grid, max(spec.n_targets, 1)),
        "t2_corrected_ranks": (spec.n_grid, max(spec.n_targets, 1)),
        "overall_crit": (spec.n_grid,),
        "het_col_mean": (p,),
        "het_col_std": (p,),
    }
    for f, levels in enumerate(spec.factor_levels):
        shapes[f"fixed_codes_{f}"] = (spec.max_n,)
    return shapes
