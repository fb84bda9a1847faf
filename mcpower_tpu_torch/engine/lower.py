"""Lowering: validated design description -> (SimSpec, host arrays).

The counterpart of the reference's contract adapter
(crates/engine-core/src/contract_adapter.rs:74 ``contract_to_simulation_spec``):
one-way, label-free, and the only place that knows both the wire-level design
terms and the engine's column layout. Everything precomputable on host is
precomputed here, once per run: Cholesky of the base correlation, critical
value tables, heteroskedasticity population moments, deterministic factor
allocation walks.

The arrays are numpy, with the reference's dtypes; ``batch.run_batch`` moves
them to the device it runs on.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import critvals
from .datagen import fixed_allocation_codes
from .spec import (
    DIST_BINARY,
    DIST_CODES,
    RESID_CODES,
    ClusterStatic,
    PosthocStatic,
    ScenarioStatic,
    SimSpec,
)


def compute_het_coeffs(
    n_cont: int,
    var_types: Sequence[int],
    var_params: Sequence[float],
    factor_levels: Sequence[int],
    factor_props: Sequence[float],
    effects: np.ndarray,
    corr: np.ndarray,
    n_interactions: int,
) -> Tuple[float, float, np.ndarray, np.ndarray]:
    """Analytic population moments of the heteroskedasticity driver.

    Mirrors crates/engine-core/src/spec.rs:436-515: per-column means/SDs of
    the transformed design (standardized continuous => (0,1); binary and
    factor dummies => (p, sqrt(p(1-p)))), lp mean = beta'mu, lp var = beta'
    Sigma beta over the continuous block; interactions contribute 0 (the
    reference stops at the dummy block — an accepted approximation).
    """
    p = 1 + n_cont + sum(max(l - 1, 0) for l in factor_levels) + n_interactions
    mu = np.zeros(p)
    sd = np.zeros(p)
    mu[0] = 1.0
    for j in range(n_cont):
        if var_types[j] == DIST_BINARY:
            pp = float(var_params[j])
            mu[1 + j] = pp
            sd[1 + j] = np.sqrt(max(pp * (1.0 - pp), 0.0))
        else:
            sd[1 + j] = 1.0
    col = 1 + n_cont
    off = 0
    for n_levels in factor_levels:
        for d in range(max(n_levels - 1, 0)):
            pp = float(factor_props[off + d + 1]) if off + d + 1 < len(factor_props) else 0.0
            mu[col + d] = pp
            sd[col + d] = np.sqrt(max(pp * (1.0 - pp), 0.0))
        col += max(n_levels - 1, 0)
        off += n_levels

    beta = np.asarray(effects, dtype=np.float64)
    lp_mean = float(beta[: len(mu)] @ mu)
    lp_var = float(np.sum((beta[: len(sd)] * sd) ** 2))
    for j in range(n_cont):
        for k2 in range(j + 1, n_cont):
            lp_var += (
                2.0
                * beta[1 + j]
                * beta[1 + k2]
                * float(corr[j, k2])
                * sd[1 + j]
                * sd[1 + k2]
            )
    return lp_mean, float(np.sqrt(max(lp_var, 0.0))), mu, sd


def lower(
    *,
    grid: Sequence[int],
    n_sims_hint: int = 0,
    alpha: float = 0.05,
    # generation side
    var_types: Sequence[str] = (),
    var_params: Optional[Sequence[float]] = None,
    var_pinned: Optional[Sequence[bool]] = None,
    corr: Optional[np.ndarray] = None,
    factor_levels: Sequence[int] = (),
    factor_props: Optional[Sequence[float]] = None,
    factor_sampled: Optional[Sequence[Optional[bool]]] = None,
    interactions: Sequence[Sequence[int]] = (),
    effects: Optional[np.ndarray] = None,
    outcome: str = "continuous",
    link: str = "canonical",
    residual: str = "normal",
    residual_pinned: bool = False,
    het_driver: Optional[int] = None,
    cluster: Optional[ClusterStatic] = None,
    # analysis side
    estimator: str = "ols",
    fit_cols: Optional[Sequence[int]] = None,
    target_cols: Sequence[int] = (),
    contrasts: Sequence[Tuple[int, int]] = (),
    report_overall: bool = False,
    correction: str = "none",
    posthoc: Sequence[PosthocStatic] = (),
    scenario: Optional[ScenarioStatic] = None,
    wald_se: str = "rx",
    nagq: int = 1,
    factor_min_level_count: int = 5,
    # uploaded pilot data
    upload_frame: Optional[np.ndarray] = None,  # (rows, frame_cols) float
    bootstrap: bool = False,
    upload_cont_frame_cols: Sequence[int] = (),
    upload_factor_frame_cols: Sequence[int] = (),
) -> Tuple[SimSpec, Dict]:
    """Assemble the static spec and the host array dict for one scenario."""
    grid = tuple(int(n) for n in grid)
    n_cont = len(var_types)
    var_codes = tuple(DIST_CODES[v] for v in var_types)
    var_params = list(var_params) if var_params is not None else [0.5] * n_cont
    var_pinned = tuple(bool(b) for b in (var_pinned or [False] * n_cont))
    factor_levels = tuple(int(l) for l in factor_levels)
    factor_sampled = tuple(factor_sampled or [None] * len(factor_levels))
    if factor_props is None:
        factor_props = []
        for l in factor_levels:
            factor_props.extend([1.0 / l] * l)
    interactions = tuple(tuple(int(c) for c in t) for t in interactions)
    scenario = scenario or ScenarioStatic()

    spec = SimSpec(
        max_n=grid[-1],
        grid=grid,
        n_cont=n_cont,
        var_types=var_codes,
        var_pinned=var_pinned,
        factor_levels=factor_levels,
        factor_sampled=factor_sampled,
        interactions=interactions,
        outcome=outcome,
        link=link,
        estimator=estimator,
        fit_cols=tuple(int(c) for c in fit_cols) if fit_cols is not None else None,
        target_cols=tuple(int(c) for c in target_cols),
        contrasts=tuple((int(a), int(b)) for a, b in contrasts),
        report_overall=report_overall,
        correction=correction,
        residual=RESID_CODES[residual],
        residual_pinned=residual_pinned,
        het_driver=het_driver,
        cluster=cluster,
        scenario=scenario,
        posthoc=tuple(posthoc),
        wald_se=wald_se,
        nagq=nagq,
        factor_min_level_count=factor_min_level_count,
        upload_rows=0 if upload_frame is None else int(upload_frame.shape[0]),
        bootstrap=bool(bootstrap and upload_frame is not None),
        upload_cont_frame_cols=tuple(upload_cont_frame_cols)
        or tuple([-1] * n_cont),
        upload_factor_frame_cols=tuple(upload_factor_frame_cols)
        or tuple([-1] * len(factor_levels)),
    )
    spec.validate_layout()

    p = spec.n_predictors
    effects_arr = np.zeros(p) if effects is None else np.asarray(effects, np.float64)
    assert effects_arr.shape == (p,), (effects_arr.shape, p)
    corr_arr = np.eye(n_cont) if corr is None else np.asarray(corr, np.float64)

    # Crit tables (host, scipy-backed; once per run).
    use_t = estimator == "ols"
    pf = len(spec.effective_fit_cols)
    overall_kind = None
    if report_overall:
        overall_kind = "f" if estimator == "ols" else "chi2"
    ph_factors = {b.factor_index: b.n_levels for b in posthoc}
    from .spec import tukey_k_per_target as _tukey_k

    tukey_k = _tukey_k(spec) if correction == "tukey_hsd" else None
    table = critvals.build_crit_table(
        alpha=alpha,
        grid=grid,
        p_fit=pf,
        n_targets=spec.n_targets,
        use_t=use_t,
        correction=correction,
        overall=overall_kind,
        overall_df1=max(pf - 1, 1),
        posthoc_factors=ph_factors,
        posthoc_correction="tukey_hsd",
        tukey_k_per_target=tukey_k,
    )

    lp_mean, lp_std, col_mu, col_sd = compute_het_coeffs(
        n_cont,
        var_codes,
        var_params,
        factor_levels,
        factor_props,
        effects_arr,
        corr_arr,
        len(interactions),
    )

    arrays: Dict = {
        "corr": np.asarray(corr_arr, np.float64),
        "corr_chol": np.asarray(np.linalg.cholesky(corr_arr), np.float32)
        if n_cont > 0
        else np.zeros((0, 0), np.float32),
        "var_params": np.asarray(var_params, np.float32),
        "effects": np.asarray(effects_arr, np.float64),
        "factor_props": np.asarray(factor_props, np.float64),
        "t2_uncorrected": np.asarray(table.t2_uncorrected),
        "t2_corrected_ranks": np.asarray(table.t2_corrected_ranks),
        "overall_crit": np.asarray(table.overall_crit),
        "het_lp_mean": np.float64(lp_mean),
        "het_lp_std": np.float64(lp_std),
        "het_col_mean": np.asarray(col_mu, np.float64),
        "het_col_std": np.asarray(col_sd, np.float64),
    }

    # Uploaded-frame device arrays: sorted columns for NORTA quantiles,
    # the raw frame for strict bootstrap row copies.
    if upload_frame is not None:
        frame = np.asarray(upload_frame, dtype=np.float32)
        arrays["boot_frame"] = np.asarray(frame)
        for j, fc in enumerate(spec.upload_cont_frame_cols):
            if fc >= 0 and spec.var_types[j] == DIST_CODES["uploaded"]:
                arrays[f"upload_sorted_{j}"] = np.asarray(
                    np.sort(frame[:, fc]), np.float32
                )

    # Deterministic factor walks (host; pure function of proportions).
    off = 0
    for f, n_levels in enumerate(factor_levels):
        probs = factor_props[off : off + n_levels]
        arrays[f"fixed_codes_{f}"] = np.asarray(
            fixed_allocation_codes(probs, spec.max_n), np.int32
        )
        off += n_levels

    # Posthoc crit per pair, concatenated in block order.
    def _posthoc_cols(tbl):
        cols = []
        for block in posthoc:
            crit_g = tbl.posthoc_t2[block.factor_index]  # (G,)
            for _ in block.pairs:
                cols.append(crit_g)
        return np.stack(cols, axis=1)

    if posthoc:
        arrays["posthoc_t2"] = np.asarray(_posthoc_cols(table))

    # Reduced-df crit stacks for sparse-factor exclusion refits: layer d
    # holds every threshold at p_fit - d fitted columns (t/F/studentized-
    # range are df-dependent for OLS; z/chi2 arms need no stack). The device
    # side selects the layer by the per-(sim, grid) dropped-column count —
    # the memoized reduced-crit tables of the reference (batch.rs:2418-2570).
    from .spec import max_droppable_fit_cols

    d_max = max_droppable_fit_cols(spec)
    # df-dependent thresholds need one layer per droppable-column count:
    # OLS t/F always; Tukey's studentized range (df = N - P) and the GLM
    # overall chi2 (df = P - 1) even under Wald-z marginals.
    df_dependent = use_t or correction == "tukey_hsd" or overall_kind == "chi2"
    if d_max > 0 and df_dependent:
        stacks = {"unc": [], "corr": [], "overall": [], "posthoc": []}
        for d in range(d_max + 1):
            t_d = (
                table
                if d == 0
                else critvals.build_crit_table(
                    alpha=alpha,
                    grid=grid,
                    p_fit=pf - d,
                    n_targets=spec.n_targets,
                    use_t=use_t,
                    correction=correction,
                    overall=overall_kind,
                    overall_df1=max(pf - d - 1, 1),
                    posthoc_factors=ph_factors,
                    posthoc_correction="tukey_hsd",
                    tukey_k_per_target=tukey_k,
                )
            )
            stacks["unc"].append(t_d.t2_uncorrected)
            stacks["corr"].append(t_d.t2_corrected_ranks)
            stacks["overall"].append(t_d.overall_crit)
            if posthoc:
                stacks["posthoc"].append(_posthoc_cols(t_d))
        arrays["t2_unc_by_dropped"] = np.asarray(np.stack(stacks["unc"], 1))
        arrays["t2_corr_by_dropped"] = np.asarray(np.stack(stacks["corr"], 1))
        if report_overall:
            arrays["overall_crit_by_dropped"] = np.asarray(
                np.stack(stacks["overall"], 1)
            )
        if posthoc:
            arrays["posthoc_t2_by_dropped"] = np.asarray(
                np.stack(stacks["posthoc"], 1)
            )

    return spec, arrays
