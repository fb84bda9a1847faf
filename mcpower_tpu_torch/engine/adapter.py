"""Contract -> engine lowering: the one-way bridge from wire types to the
static ``SimSpec`` and host arrays that ``batch.run_batch`` runs.

The counterpart of the reference's contract adapter
(crates/engine-core/src/contract_adapter.rs:74): resolves design terms to
engine column positions, targets/contrasts to fit-column indices, slope
generation-columns to design columns, and hands everything to
:func:`.lower.lower` for crit tables + array assembly. It lowers every
design the contract can describe; ``batch.run_batch`` (through
``datagen.check_supported``) names the ROADMAP item of any the port cannot
run yet.

The engine's column layout is canonical (intercept | non-factor columns in
generation order | factor dummies | interactions). Contracts whose design
term list does not follow that canonical order are rejected — the spec
builder always produces it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import CONFIG
from ..contract.types import SimulationContract
from ..contract.validate import validate
from . import lower as lower_mod
from .spec import (
    ClusterStatic,
    ExtraGroupingStatic,
    PosthocStatic,
    ScenarioStatic,
    SimSpec,
    SlopeStatic,
)


class AdapterError(ValueError):
    pass


def _canonical_maps(c: SimulationContract):
    """Map generation columns / design terms into the engine layout.

    Returns (var_types, var_params, var_pinned, var_sampled_kinds,
    factor_levels, factor_props, factor_sampled, gen_col_to_engine_col,
    term_to_engine_col, interactions).
    """
    cols = c.generation.columns
    non_factor_gen: List[int] = []
    factor_gen: List[int] = []
    for i, col in enumerate(cols):
        (factor_gen if col.kind.startswith("factor") else non_factor_gen).append(i)

    var_types, var_params, var_pinned = [], [], []
    for i in non_factor_gen:
        col = cols[i]
        if col.kind == "resampled":
            var_types.append("uploaded")
        elif col.kind == "resampled_binary":
            var_types.append("uploaded_binary")
        else:
            var_types.append(col.dist)
        var_params.append(col.param)
        var_pinned.append(col.pinned)

    factor_levels, factor_props, factor_sampled = [], [], []
    for i in factor_gen:
        col = cols[i]
        factor_levels.append(col.n_levels)
        props = col.proportions or [1.0 / col.n_levels] * col.n_levels
        factor_props.extend(props)
        factor_sampled.append(col.sampled)

    # generation column -> engine design column of its first value column
    gen_to_engine: Dict[int, int] = {}
    for pos, i in enumerate(non_factor_gen):
        gen_to_engine[i] = 1 + pos
    dummy_start = 1 + len(non_factor_gen)
    off = 0
    factor_first_dummy: Dict[int, int] = {}
    for fi, i in enumerate(factor_gen):
        factor_first_dummy[i] = dummy_start + off
        off += max(cols[i].n_levels - 1, 0)

    # design term -> engine column; collect interactions.
    term_to_col: Dict[int, int] = {}
    interactions: List[Tuple[int, ...]] = []
    inter_start = dummy_start + off
    n_inter = 0
    for ti, term in enumerate(c.design):
        if term[0] == "const":
            term_to_col[ti] = 0
        elif term[0] == "direct":
            term_to_col[ti] = gen_to_engine[term[1]]
        elif term[0] == "dummy":
            term_to_col[ti] = factor_first_dummy[term[1]] + (term[2] - 1)
        elif term[0] == "interaction":
            comp_cols = []
            for comp in term[1]:
                if comp not in term_to_col:
                    raise AdapterError(
                        "interaction references a later term (non-canonical order)"
                    )
                comp_cols.append(term_to_col[comp])
            term_to_col[ti] = inter_start + n_inter
            interactions.append(tuple(comp_cols))
            n_inter += 1
        else:
            raise AdapterError(f"unknown design term {term!r}")

    return (
        var_types,
        var_params,
        var_pinned,
        factor_levels,
        factor_props,
        factor_sampled,
        gen_to_engine,
        factor_first_dummy,
        term_to_col,
        interactions,
        non_factor_gen,
        factor_gen,
    )


def contract_to_lowered(
    c: SimulationContract,
    grid: Sequence[int],
) -> Tuple[SimSpec, Dict]:
    """Validate + lower one contract at the given sample-size grid."""
    validate(c)
    (
        var_types,
        var_params,
        var_pinned,
        factor_levels,
        factor_props,
        factor_sampled,
        gen_to_engine,
        factor_first_dummy,
        term_to_col,
        interactions,
        non_factor_gen,
        factor_gen,
    ) = _canonical_maps(c)

    n_cont = len(var_types)
    n_dummies = sum(max(l - 1, 0) for l in factor_levels)
    p = 1 + n_cont + n_dummies + len(interactions)

    # Effects vector in engine layout.
    effects = np.zeros(p)
    effects[0] = c.outcome.intercept
    for ti, coef in enumerate(c.outcome.coefficients):
        col = term_to_col[ti]
        if col == 0:
            effects[0] += coef  # const term coefficient folds into intercept
        else:
            effects[col] = coef

    # Fitted model columns (test_design) — canonical subset of engine columns.
    if c.test_design is not None:
        fit_cols = []
        test_term_to_fitpos: Dict[int, int] = {}
        # re-run mapping for test terms against the SAME engine layout
        for ti, term in enumerate(c.test_design):
            if term[0] == "const":
                col = 0
            elif term[0] == "direct":
                col = gen_to_engine[term[1]]
            elif term[0] == "dummy":
                col = factor_first_dummy[term[1]] + (term[2] - 1)
            elif term[0] == "interaction":
                comp_cols = tuple(
                    fit_cols[test_term_to_fitpos[comp]] for comp in term[1]
                )
                try:
                    col = (
                        1
                        + n_cont
                        + n_dummies
                        + interactions.index(comp_cols)
                    )
                except ValueError:
                    raise AdapterError(
                        "test-design interaction not present in the DGP design"
                    )
            else:
                raise AdapterError(f"unknown test design term {term!r}")
            test_term_to_fitpos[ti] = len(fit_cols)
            fit_cols.append(col)
        # Targets reference GENERATION design terms (contract/types.py test
        # spec); re-key them to fit positions by the engine COLUMN each
        # generation term denotes. Keying by test-term index (the old bug)
        # crashed when a kept target followed a dropped term and silently
        # tested the WRONG column when test_formula reordered predictors.
        term_to_fitpos = {
            ti: fit_cols.index(col)
            for ti, col in term_to_col.items()
            if col in fit_cols
        }
        fit_cols_t = tuple(fit_cols)
    else:
        fit_cols_t = None
        # fit position of design term ti = position of its column in 0..p-1
        term_to_fitpos = {ti: col for ti, col in term_to_col.items()}

    # Targets.
    target_cols: List[int] = []
    contrasts: List[Tuple[int, int]] = []
    report_overall = c.test.report_overall
    for t in c.test.targets:
        if t[0] == "marginal":
            if t[1] not in term_to_fitpos:
                raise AdapterError(f"target term {t[1]} not in the fitted model")
            target_cols.append(term_to_fitpos[t[1]])
        elif t[0] == "contrast":
            contrasts.append((term_to_fitpos[t[1]], term_to_fitpos[t[2]]))
        elif t[0] == "joint":
            # v1 omnibus routing: a joint target over the whole model is the
            # overall test (reference JointNotSupported otherwise).
            report_overall = True
        else:
            raise AdapterError(f"unknown target {t!r}")

    # Cluster.
    cluster = None
    if c.generation.cluster is not None:
        cl = c.generation.cluster
        slopes = tuple(
            SlopeStatic(
                design_col=gen_to_engine[s.column],
                variance=s.variance,
                intercept_corr=s.intercept_corr,
            )
            for s in cl.slopes
        )
        extras = tuple(
            ExtraGroupingStatic(
                relation=g.relation,
                n_levels=g.n_clusters,
                tau_squared=g.tau_squared,
                slopes=tuple(
                    SlopeStatic(
                        design_col=gen_to_engine[s.column],
                        variance=s.variance,
                        intercept_corr=s.intercept_corr,
                    )
                    for s in g.slopes
                ),
            )
            for g in cl.extra_groupings
        )
        between = tuple(
            gen_to_engine[b] if b in gen_to_engine else factor_first_dummy[b]
            for b in cl.between_columns
        )
        cluster = ClusterStatic(
            sizing_mode=cl.sizing_mode,
            sizing_value=cl.sizing_value,
            tau_squared=cl.tau_squared,
            slopes=slopes,
            extra_groupings=extras,
            between_cols=between,
        )

    # Posthoc blocks: pairwise level contrasts per factor (level 1 ==
    # reference == "no column", encoded -1).
    posthoc_blocks: List[PosthocStatic] = []
    for ph in c.test.posthoc:
        gen_col = ph.factor_column
        fidx = factor_gen.index(gen_col)
        k = c.generation.columns[gen_col].n_levels
        first = factor_first_dummy[gen_col]
        level_col = lambda lvl: -1 if lvl == 0 else first + (lvl - 1)
        pairs = []
        for a in range(k):
            for b in range(a + 1, k):
                pairs.append((level_col(a), level_col(b)))
        posthoc_blocks.append(
            PosthocStatic(factor_index=fidx, n_levels=k, pairs=tuple(pairs))
        )

    corr = (
        np.asarray(c.generation.correlations, dtype=np.float64)
        if c.generation.correlations
        else None
    )

    het_col = None
    if c.outcome.heteroskedasticity_column is not None:
        het_col = gen_to_engine[c.outcome.heteroskedasticity_column]

    scenario = ScenarioStatic(
        label=c.scenario.label,
        heterogeneity=c.scenario.heterogeneity,
        heteroskedasticity_ratio=c.scenario.heteroskedasticity_ratio,
        correlation_noise_sd=c.scenario.correlation_noise_sd,
        sampled_factor_proportions=c.scenario.sampled_factor_proportions,
        truth_start=c.scenario.truth_start,
        distribution_change_prob=c.scenario.distribution_change_prob,
        new_distributions=tuple(c.scenario.new_distributions),
        residual_change_prob=c.scenario.residual_change_prob,
        residual_dists=tuple(c.scenario.residual_dists),
        residual_df=c.scenario.residual_df,
        random_effect_dist=c.scenario.random_effect_dist,
        random_effect_df=c.scenario.random_effect_df,
        icc_noise_sd=c.scenario.icc_noise_sd,
    )

    # Uploaded frame: per-column frame indices in engine layout.
    upload_frame = None
    bootstrap = False
    up_cont = [-1] * len(non_factor_gen)
    up_fact = [-1] * len(factor_gen)
    if c.generation.frame is not None and c.generation.frame.n_rows > 0:
        fr = c.generation.frame
        upload_frame = np.asarray(fr.data, dtype=np.float64).reshape(
            fr.n_rows, fr.n_cols
        )
        bootstrap = fr.bootstrap
        for pos, i in enumerate(non_factor_gen):
            col = c.generation.columns[i]
            if col.frame_col is not None:
                up_cont[pos] = int(col.frame_col)
        for pos, i in enumerate(factor_gen):
            col = c.generation.columns[i]
            if col.frame_col is not None:
                up_fact[pos] = int(col.frame_col)

    return lower_mod.lower(
        grid=grid,
        alpha=c.test.alpha,
        var_types=var_types,
        var_params=var_params,
        var_pinned=var_pinned,
        corr=corr,
        factor_levels=factor_levels,
        factor_props=factor_props or None,
        factor_sampled=factor_sampled,
        interactions=interactions,
        effects=effects,
        outcome=c.outcome.kind,
        link=c.outcome.link or "canonical",
        residual=c.outcome.residual.dist,
        residual_pinned=c.outcome.residual.pinned,
        het_driver=het_col,
        cluster=cluster,
        estimator=c.estimator.kind,
        fit_cols=fit_cols_t,
        target_cols=target_cols,
        contrasts=contrasts,
        report_overall=report_overall,
        correction=c.test.correction,
        posthoc=posthoc_blocks,
        scenario=scenario,
        wald_se=c.estimator.wald_se,
        nagq=c.estimator.nagq,
        factor_min_level_count=int(CONFIG["limits"]["factor_min_level_count"]),
        upload_frame=upload_frame,
        bootstrap=bootstrap,
        upload_cont_frame_cols=up_cont,
        upload_factor_frame_cols=up_fact,
    )
