"""The 25 numbered contract invariants — the sole gate before lowering.

Same invariant set as the reference's validator
(crates/engine-contract/src/validate.rs:24-48); each check raises
ContractError with the invariant number so hosts can map failures to inputs.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..config import CONFIG, CORRECTION_NAMES, DISTRIBUTION_NAMES, RESIDUAL_NAMES
from .types import SimulationContract


class ContractError(ValueError):
    def __init__(self, invariant: int, message: str):
        self.invariant = invariant
        super().__init__(f"[invariant {invariant:02d}] {message}")


def _design_len(c: SimulationContract) -> int:
    return len(c.design)


def _cont_columns(c: SimulationContract) -> List[int]:
    return [
        i
        for i, col in enumerate(c.generation.columns)
        if col.kind in ("synthetic", "resampled", "resampled_binary")
    ]


def validate(c: SimulationContract) -> None:
    lim = CONFIG["limits"]
    n_cols = len(c.generation.columns)
    n_terms = len(c.design)

    # 01 — coefficient vector length matches the design term list.
    if len(c.outcome.coefficients) != n_terms:
        raise ContractError(
            1,
            f"outcome.coefficients has {len(c.outcome.coefficients)} entries "
            f"for {n_terms} design terms",
        )

    # 02 — test target term indices in range.
    for t in c.test.targets:
        idxs = (
            [t[1]]
            if t[0] == "marginal"
            else list(t[1])
            if t[0] == "joint"
            else [t[1], t[2]]
        )
        for i in idxs:
            if not 0 <= int(i) < n_terms:
                raise ContractError(2, f"test target index {i} out of range")

    # 03 — test targets well-formed (no empty joint, no const target,
    # contrast endpoints distinct).
    for t in c.test.targets:
        if t[0] == "joint" and not t[1]:
            raise ContractError(3, "joint target with no terms")
        if t[0] == "contrast" and t[1] == t[2]:
            raise ContractError(3, "contrast with identical terms")
        if t[0] == "marginal" and c.design[t[1]][0] == "const":
            raise ContractError(3, "marginal target on the intercept")

    # 04 — design-term column ids in range.
    for term in c.design:
        if term[0] in ("direct", "dummy") and not 0 <= term[1] < n_cols:
            raise ContractError(4, f"design term references column {term[1]}")

    # 05 — correlation matrix dimensions match the continuous block.
    cont = _cont_columns(c)
    corr = c.generation.correlations
    if corr:
        if len(corr) != len(cont) or any(len(r) != len(cont) for r in corr):
            raise ContractError(
                5,
                f"correlation matrix is {len(corr)}x..., continuous block "
                f"has {len(cont)} columns",
            )

    # 06 — correlations only over continuous-block columns (factor kinds
    # excluded by construction of the matrix block).
    for i, col in enumerate(c.generation.columns):
        if col.kind.startswith("factor") and corr and i in cont:
            raise ContractError(6, f"factor column {i} inside correlation block")

    # 07 — factor proportions well-formed.
    for i, col in enumerate(c.generation.columns):
        if col.kind.startswith("factor"):
            k = col.n_levels
            if not (lim["factor_levels"][0] <= k <= lim["factor_levels"][1]):
                raise ContractError(7, f"factor column {i} has {k} levels")
            if col.proportions:
                if len(col.proportions) != k:
                    raise ContractError(
                        7, f"factor column {i}: {len(col.proportions)} proportions for {k} levels"
                    )
                if any(p <= 0 for p in col.proportions):
                    raise ContractError(7, f"factor column {i}: non-positive proportion")
                if abs(sum(col.proportions) - 1.0) > 1e-6:
                    raise ContractError(7, f"factor column {i}: proportions must sum to 1")

    # 08 — dummy levels in range (1..k-1 under reference coding).
    for term in c.design:
        if term[0] == "dummy":
            col = c.generation.columns[term[1]]
            if not 1 <= term[2] <= max(col.n_levels - 1, 0):
                raise ContractError(
                    8, f"dummy level {term[2]} out of range for {col.n_levels} levels"
                )

    # 09 — direct terms only on non-factor columns.
    for term in c.design:
        if term[0] == "direct" and c.generation.columns[term[1]].kind.startswith(
            "factor"
        ):
            raise ContractError(9, f"direct design term on factor column {term[1]}")

    # 10 — heteroskedasticity driver must be a continuous column.
    h = c.outcome.heteroskedasticity_column
    if h is not None:
        if not 0 <= h < n_cols or c.generation.columns[h].kind.startswith("factor"):
            raise ContractError(10, f"heteroskedasticity driver column {h} invalid")

    # 11 — uploaded column kinds require a frame.
    needs_frame = any(
        col.kind in ("resampled", "resampled_binary", "factor_from_frame")
        for col in c.generation.columns
    )
    if needs_frame and (c.generation.frame is None or c.generation.frame.n_rows == 0):
        raise ContractError(11, "uploaded column kinds present but no frame")

    # 12 — estimator x outcome compatibility matrix.
    est, kind = c.estimator.kind, c.outcome.kind
    if est == "ols" and kind != "continuous":
        raise ContractError(12, f"ols estimator on {kind} outcome")
    if est == "glm" and kind == "continuous" and c.generation.cluster is None:
        raise ContractError(12, "glm estimator on unclustered continuous outcome")
    if est == "mle" and c.generation.cluster is None:
        raise ContractError(12, "mle estimator requires a cluster spec")

    # 13 — LME scenario knobs only with the mle/glmm estimator.
    if (
        c.scenario.icc_noise_sd > 0 or c.scenario.random_effect_dist != "normal"
    ) and c.generation.cluster is None:
        raise ContractError(13, "LME scenario perturbations without clustering")

    # 14 — max_failed_fraction in [0, 1].
    if not 0.0 <= c.max_failed_fraction <= 1.0:
        raise ContractError(14, f"max_failed_fraction {c.max_failed_fraction}")

    # 15 — alpha in (0, 1).
    if not 0.0 < c.test.alpha < 1.0:
        raise ContractError(15, f"alpha {c.test.alpha}")

    # 16 — correlation matrix symmetric PSD with unit diagonal.
    if corr:
        m = np.asarray(corr, dtype=np.float64)
        if not np.allclose(m, m.T, atol=1e-9):
            raise ContractError(16, "correlation matrix not symmetric")
        if not np.allclose(np.diag(m), 1.0, atol=1e-9):
            raise ContractError(16, "correlation diagonal must be 1")
        if np.linalg.eigvalsh(m).min() < -1e-8:
            raise ContractError(16, "correlation matrix not PSD")

    # 17 — posthoc blocks reference factor columns and their dummy terms.
    for ph in c.test.posthoc:
        if not 0 <= ph.factor_column < n_cols:
            raise ContractError(17, f"posthoc factor column {ph.factor_column}")
        if not c.generation.columns[ph.factor_column].kind.startswith("factor"):
            raise ContractError(17, "posthoc block on a non-factor column")
        for t in ph.terms:
            if not (0 <= t < n_terms and c.design[t][0] == "dummy"):
                raise ContractError(17, f"posthoc term {t} is not a dummy term")

    # 18 — interactions reference earlier non-interaction, non-const terms.
    for i, term in enumerate(c.design):
        if term[0] == "interaction":
            comps = term[1]
            if len(comps) < 2:
                raise ContractError(18, "interaction with fewer than 2 components")
            for comp in comps:
                if not 0 <= comp < n_terms:
                    raise ContractError(18, f"interaction component {comp} out of range")
                if c.design[comp][0] in ("const", "interaction"):
                    raise ContractError(
                        18, "interaction components must be direct/dummy terms"
                    )

    # 19/20 — extra grouping structure + capacity ceilings.
    cl = c.generation.cluster
    if cl is not None:
        if len(cl.extra_groupings) > lim["max_extra_groupings"]:
            raise ContractError(20, "too many extra groupings")
        for g in cl.extra_groupings:
            if g.relation not in ("crossed", "nested"):
                raise ContractError(20, f"unknown grouping relation {g.relation!r}")
            if g.n_clusters < 2:
                raise ContractError(20, "extra grouping needs >= 2 levels")
            if 1 + len(g.slopes) > lim["max_extra_q"]:
                raise ContractError(19, "extra grouping exceeds max q")
            for s in g.slopes:
                if s.variance < 0 or not -1 <= s.intercept_corr <= 1:
                    raise ContractError(19, "invalid extra slope term")

        # 21 — primary slope structure: q ceiling, tau0 > 0 with slopes.
        if 1 + len(cl.slopes) > lim["max_primary_q"]:
            raise ContractError(21, "primary grouping exceeds max q")
        if cl.slopes and cl.tau_squared <= 0:
            raise ContractError(21, "random slopes require tau_squared > 0")
        for s in cl.slopes:
            if s.variance < 0 or not -1 <= s.intercept_corr <= 1:
                raise ContractError(21, "invalid slope term")
        if cl.sizing_value < 1:
            raise ContractError(21, "cluster sizing value must be >= 1")

    # 22 — scenario perturbations well-formed.
    sc = c.scenario
    if sc.heterogeneity < 0 or sc.correlation_noise_sd < 0 or sc.icc_noise_sd < 0:
        raise ContractError(22, "negative scenario perturbation SD")
    if sc.heteroskedasticity_ratio < 1.0:
        raise ContractError(22, "heteroskedasticity ratio must be >= 1")
    if not 0 <= sc.distribution_change_prob <= 1:
        raise ContractError(22, "distribution_change_prob out of range")
    if not 0 <= sc.residual_change_prob <= 1:
        raise ContractError(22, "residual_change_prob out of range")
    for d in sc.new_distributions:
        if d not in DISTRIBUTION_NAMES:
            raise ContractError(22, f"unknown distribution {d!r} in swap pool")
    for d in sc.residual_dists:
        if d not in RESIDUAL_NAMES:
            raise ContractError(22, f"unknown residual {d!r} in swap pool")
    if c.outcome.residual.dist not in RESIDUAL_NAMES:
        raise ContractError(22, f"unknown residual dist {c.outcome.residual.dist!r}")
    if c.test.correction not in CORRECTION_NAMES:
        raise ContractError(22, f"unknown correction {c.test.correction!r}")

    # 23 — binary probabilities in range.
    for i, col in enumerate(c.generation.columns):
        if col.dist == "binary" or col.kind == "resampled_binary":
            if not 0.0 < col.param < 1.0:
                raise ContractError(23, f"binary column {i} p={col.param}")

    # 24 — link matches outcome kind.
    if c.outcome.link == "probit" and c.outcome.kind != "binary":
        raise ContractError(24, "probit link requires a binary outcome")
    if c.outcome.link not in (None, "probit", "canonical"):
        raise ContractError(24, f"unknown link {c.outcome.link!r}")

    # 25 — nAGQ eligibility backstop.
    nagq = c.estimator.nagq
    if nagq != 1:
        if nagq % 2 == 0 or not 3 <= nagq <= 25:
            raise ContractError(25, f"nagq {nagq} must be 1 or odd in 3..25")
        eligible = (
            c.outcome.kind in ("binary", "count")
            and cl is not None
            and not cl.extra_groupings
            and 1 + len(cl.slopes) <= 3
        )
        if not eligible:
            raise ContractError(25, "design not AGQ-eligible")
