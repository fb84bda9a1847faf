"""Critical-value tables, precomputed on host once per run.

The device hot loop never evaluates a distribution CDF/ppf: every threshold a
simulation can be compared against is computed here, once, and shipped as
small f64 arrays. Comparisons happen in t^2 space (one squared statistic vs
one precomputed squared critical value), which is what lets the per-sim device
code be pure arithmetic — the same design invariant the reference engine
enforces (crates/engine-core/src/critvals.rs:1-9).

The ppf implementations delegate to scipy (stdtrit / chdtri / fdtri /
studentized_range), which match R's qt/qnorm/qchisq/qf to <= 1e-12 — inside
the reference's published validation tolerances (BASELINE.md: abs <= 1e-9 for
OLS t crits, <= 1e-8 for z/chi2). These run once per call, not per sim, so
host scipy costs nothing at scale.

Estimator-awareness: OLS fits test with Student-t on df = N - P (per grid N);
GLM / MLE (mixed) fits test with Wald z. Correction rows are per-rank
thresholds (Bonferroni / Holm / Benjamini-Hochberg) mapped into t^2 space;
Tukey HSD uses the studentized-range ppf at the factor's level count.
"""

from __future__ import annotations

import functools as _functools
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
from scipy import stats as _stats


def norm_ppf(p):
    return _stats.norm.ppf(p)


def t_ppf(p, df):
    return _stats.t.ppf(p, df)


def chi2_ppf(p, df):
    return _stats.chi2.ppf(p, df)


def f_ppf(p, dfn, dfd):
    return _stats.f.ppf(p, dfn, dfd)


@_functools.lru_cache(maxsize=8192)
def _q_tukey_scalar(p: float, k: float, df: float) -> float:
    return float(_stats.studentized_range.ppf(p, k, df))


def q_tukey_ppf(p, k, df):
    """Studentized-range quantile (Tukey HSD), q such that P(Q <= q) = p.

    Edge semantics mirror the reference's q_tukey_ppf
    (crates/engine-core/src/critvals.rs:687): k <= 1, df < 2, or non-finite
    k/df yield NaN (matching R's qtukey degenerate cases) — never finite
    garbage.

    scipy's studentized-range ppf costs ~0.2 s per element on this class of
    host, and the marginal-Tukey tables repeat the same (k, df) pair across
    targets, grid rows, and reduced-refit layers — so evaluations are
    memoized per unique finite (k, df) pair and degenerate entries are
    never evaluated at all.
    """
    p = float(p)
    k = np.asarray(k, dtype=np.float64)
    df = np.asarray(df, dtype=np.float64)
    k, df = np.broadcast_arrays(k, df)
    bad = ~np.isfinite(k) | ~np.isfinite(df) | (k <= 1.0) | (df < 2.0)
    out = np.full(k.shape, np.nan, dtype=np.float64)
    kf, dff, badf, outf = k.ravel(), df.ravel(), bad.ravel(), out.reshape(-1)
    for i in np.nonzero(~badf)[0]:
        outf[i] = _q_tukey_scalar(p, float(kf[i]), float(dff[i]))
    return out if out.shape else np.float64(outf[0])


def _two_sided_t2(alpha: np.ndarray, df: np.ndarray, use_t: bool) -> np.ndarray:
    """t^2 (or z^2) critical value for a two-sided test at level alpha."""
    p = 1.0 - np.asarray(alpha) / 2.0
    if use_t:
        crit = _stats.t.ppf(p, df)
    else:
        crit = _stats.norm.ppf(p)
    return np.square(crit)


@dataclass(frozen=True)
class CritTable:
    """All per-run thresholds, shaped over the sample-size grid.

    Arrays are float64 and indexed by grid position g (ascending N).
    """

    grid: Tuple[int, ...]
    n_targets: int
    use_t: bool  # True: OLS t (df = N - P); False: Wald z
    # (n_grid, n_targets): uncorrected two-sided t^2 crit per target.
    t2_uncorrected: np.ndarray
    # (n_grid, n_targets): per-RANK corrected crits (rank 0 = most significant
    # = smallest p). Interpretation depends on the correction method; "none"
    # duplicates the uncorrected row. Under "tukey_hsd" the second axis is
    # per-TARGET (original target order, no rank sorting): each target's
    # studentized-range threshold (q_{alpha,k,df}/sqrt(2))^2 with k = its
    # factor's level count (NaN for non-factor targets -> always fail).
    t2_corrected_ranks: np.ndarray
    correction: str
    # (n_grid,): overall omnibus crit — F crit (OLS), chi2 crit (GLM LRT /
    # MLE joint Wald). NaN when the omnibus is not reported.
    overall_crit: np.ndarray
    overall_df1: int
    # (n_grid,) residual df per grid point (np.inf for z tests).
    df_resid: np.ndarray
    # joint "all tests significant" chi2 crit at k = n_targets (MLE joint).
    joint_chi2_crit: float
    # posthoc: per factor, (n_grid,) t^2 crit for its pairwise contrasts.
    posthoc_t2: Dict[int, np.ndarray] = field(default_factory=dict)
    posthoc_correction: str = "tukey_hsd"


def build_crit_table(
    *,
    alpha: float,
    grid: Sequence[int],
    p_fit: int,
    n_targets: int,
    use_t: bool,
    correction: str = "none",
    overall: Optional[str] = None,  # None | "f" | "chi2"
    overall_df1: int = 0,
    posthoc_factors: Optional[Dict[int, int]] = None,  # factor idx -> k levels
    posthoc_correction: str = "tukey_hsd",
    tukey_k_per_target: Optional[Sequence[float]] = None,
) -> CritTable:
    """Precompute every threshold for a run over the ascending N ``grid``.

    ``p_fit`` is the fitted model's column count (incl. intercept) — it sets
    the OLS residual df per grid point. ``overall_df1`` is the omnibus
    numerator df (number of tested model terms).
    """
    grid_arr = np.asarray(grid, dtype=np.int64)
    n_grid = grid_arr.size
    if use_t:
        df_resid = np.maximum(grid_arr - p_fit, 1).astype(np.float64)
    else:
        df_resid = np.full(n_grid, np.inf)

    # Uncorrected: same alpha for every target.
    alpha_row = np.full((n_grid, max(n_targets, 1)), alpha)
    df_mat = np.repeat(df_resid[:, None], max(n_targets, 1), axis=1)
    t2_unc = _two_sided_t2(alpha_row, df_mat, use_t)

    # Corrected per-rank thresholds. Rank r (0-based) of k sorted p-values
    # (ascending p == descending t^2) is tested against:
    #   bonferroni:          alpha / k                (same for all ranks)
    #   holm:                alpha / (k - r)          (step-down)
    #   benjamini_hochberg:  alpha * (r + 1) / k      (step-up)
    #   none:                alpha
    k = max(n_targets, 1)
    ranks = np.arange(k, dtype=np.float64)
    if correction == "bonferroni":
        alpha_ranks = np.full(k, alpha / k)
    elif correction == "holm":
        alpha_ranks = alpha / (k - ranks)
    elif correction == "benjamini_hochberg":
        alpha_ranks = alpha * (ranks + 1.0) / k
    elif correction == "none":
        alpha_ranks = np.full(k, alpha)
    elif correction != "tukey_hsd":
        raise ValueError(f"unknown correction {correction!r}")

    if correction == "tukey_hsd":
        # Per-TARGET single-step thresholds (reference critvals.rs:827
        # build_with_tukey_k): each target compares against
        # (q_{alpha, k_i, df}/sqrt(2))^2 where k_i is the level count L of the
        # factor the target's column belongs to. Non-factor targets carry
        # k_i = NaN -> NaN threshold -> always fail (a Tukey design should not
        # point a marginal target at a non-factor column). df = N - P_fit for
        # every estimator arm (the reference feeds the residual df into the
        # studentized range even under Wald-z fits, critvals.rs:936).
        ks = np.asarray(
            tukey_k_per_target
            if tukey_k_per_target is not None
            else [np.nan] * k,
            dtype=np.float64,
        )
        if ks.shape == (0,) and n_targets == 0:
            # no marginal/contrast t^2 targets (e.g. "overall,
            # all-contrasts": contrasts ride the posthoc block) — pad the
            # placeholder row the table always carries
            ks = np.full(k, np.nan)
        if ks.shape != (k,):
            raise ValueError(
                f"tukey_k_per_target must have one k per target ({k}); got "
                f"shape {ks.shape}"
            )
        grid_len = np.asarray(grid, dtype=np.float64)
        df_tukey = np.maximum(grid_len - p_fit, 1.0)
        q = q_tukey_ppf(1.0 - alpha, ks[None, :], df_tukey[:, None])
        t2_corr = np.square(q / np.sqrt(2.0))
    else:
        t2_corr = _two_sided_t2(
            np.repeat(alpha_ranks[None, :], n_grid, axis=0), df_mat, use_t
        )

    # Overall omnibus crit.
    if overall == "f":
        dfn = max(overall_df1, 1)
        overall_crit = _stats.f.ppf(1.0 - alpha, dfn, np.maximum(df_resid, 1.0))
    elif overall == "chi2":
        overall_crit = np.full(n_grid, _stats.chi2.ppf(1.0 - alpha, max(overall_df1, 1)))
    else:
        overall_crit = np.full(n_grid, np.nan)

    joint_crit = float(_stats.chi2.ppf(1.0 - alpha, max(n_targets, 1)))

    # Posthoc pairwise crits per factor.
    posthoc: Dict[int, np.ndarray] = {}
    for fidx, k_levels in (posthoc_factors or {}).items():
        n_pairs = k_levels * (k_levels - 1) // 2
        if posthoc_correction == "tukey_hsd":
            dfv = df_resid if use_t else np.full(n_grid, 1e9)
            q = q_tukey_ppf(1.0 - alpha, float(k_levels), dfv)
            posthoc[fidx] = np.square(q / np.sqrt(2.0))
        elif posthoc_correction == "bonferroni":
            posthoc[fidx] = _two_sided_t2(
                np.full(n_grid, alpha / max(n_pairs, 1)), df_resid, use_t
            )
        else:  # none
            posthoc[fidx] = _two_sided_t2(np.full(n_grid, alpha), df_resid, use_t)

    return CritTable(
        grid=tuple(int(n) for n in grid_arr),
        n_targets=n_targets,
        use_t=use_t,
        t2_uncorrected=t2_unc,
        t2_corrected_ranks=t2_corr,
        correction=correction,
        overall_crit=np.asarray(overall_crit, dtype=np.float64),
        overall_df1=overall_df1,
        df_resid=df_resid,
        joint_chi2_crit=joint_crit,
        posthoc_t2=posthoc,
        posthoc_correction=posthoc_correction,
    )
