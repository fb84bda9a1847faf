"""Batched dataset synthesis: the generation half of the main path.

The port of ``mcpower_tpu.engine.datagen.generate``, with the sim axis
written out: one call builds ``X (sims, max_n, P) f32``, ``y (sims, max_n)
f32`` and the cluster ids for a batch of sims.

Every draw comes from batched Philox fills (``rng.fill_streams``, kernel K1
on the card) over the streams :func:`fill_plan` lists, at the reference's
addresses, so ``X[:, :N]`` is a nested prefix across the grid (common random
numbers) and a value never depends on the batch. K1 fills one mode a launch:
the normals of the long streams (predictors, cluster draws, residual and
chi-square planes), a words or uniforms fill of the outcome's RESID stream
and the sampled factors' FACTOR words, and, under a scenario, two short
launches of the SCENARIO and HET streams (normals, then words), so that
streams of a few rows are not padded to ``max_n``.

The stages follow the reference in order: the per-sim scenario design
(:func:`design_draw`: correlation noise with its PSD repair, marginal and
residual swaps, the ICC jitter), the f32 mix ``z @ L.T``, the marginals, the
reference-coded factor dummies, the cluster-level broadcast, the
interactions, the heterogeneity beta-jitter, ``eta = X @ beta``, the random
effects (an intercept and any slopes, each component's draws normal or
heavy-tailed, mixed by the Cholesky of their covariance; then each extra
grouping's, crossed or nested, at its level ids) and the outcome: a residual of the
scenario's family (with heteroskedasticity), a binary draw (logit: a
top-24-bit uniform of the RESID words against ``sigmoid(eta)``; probit: the
RESID normal against ``eta``) or a Poisson count (the open uniform of the
RESID words through :func:`poisson_quantile`, kernel K8 on the card). The
reference also fills ``df`` chi-square planes for the residual families it
discards in a select; where the scenario can only give a normal or uniform
residual the port skips them, which leaves every value unchanged.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import kernels, marginals, rng
from .spec import (
    DIST_CODES,
    DIST_NORMAL,
    RESID_CODES,
    RESID_HIGH_KURTOSIS,
    RESID_LEFT_SKEWED,
    RESID_NORMAL,
    RESID_RIGHT_SKEWED,
    RESID_UNIFORM,
    SimSpec,
)

FLOAT_NEAR_ZERO = 1e-12
# Random-effect components (intercept and slopes) a primary grouping may
# have: the searches of kernels K9 and K10 run over d = q (q + 1) / 2 <= 10.
MAX_RE_Q = 4
# CLUSTER stream columns of one random-effect component: component c draws
# its normals at column c * RE_COLUMNS, a heavy-tailed one its chi-square
# planes at the columns after it; extra grouping g (0-based) shifts its
# components by (g + 1) * GROUPING_COLUMNS (the reference's column bases).
RE_COLUMNS = 32
GROUPING_COLUMNS = 1024

# Scenario-stream column ids (CLASS_SCENARIO), the reference's.
_SC_CORR = 0
_SC_VARSWAP_U = 1
_SC_VARSWAP_PICK = 2
_SC_RESID_U = 3
_SC_RESID_PICK = 4
_SC_ICC = 5

_MARGINALS = tuple(range(6))  # DIST_NORMAL .. DIST_UNIFORM: synthetic marginals


def fixed_allocation_codes(probs, n: int) -> np.ndarray:
    """Deterministic largest-remainder factor assignment for rows 0..n-1.

    Row ``i`` gets the level with the largest running deficit
    ``p_g*(i+1) - counts_g``, ties to the lowest level index; prefix-stable
    and RNG-free. The numpy form of the reference's walk; its native host
    library waits for ROADMAP A13.
    """
    p = np.asarray(probs, dtype=np.float64)
    total = p.sum()
    p = p / total if total > 0 else np.full_like(p, 1.0 / len(p))
    counts = np.zeros(len(p), dtype=np.int64)
    out = np.empty(n, dtype=np.int32)
    for i in range(n):
        g = int(np.argmax(p * (i + 1) - counts))
        out[i] = g
        counts[g] += 1
    return out


# ---------------------------------------------------------------------------
# The port's scope
# ---------------------------------------------------------------------------


def unsupported(spec: SimSpec) -> str:
    """Why the port cannot run ``spec`` yet, naming the ROADMAP item that
    will port it; '' when the spec is inside the port."""
    if spec.estimator == "glm" or spec.outcome != "continuous":
        if spec.estimator != "glm" and (spec.estimator != "mle" or spec.cluster is None):
            return f"estimator {spec.estimator!r} with a {spec.outcome} outcome"
        if spec.outcome not in ("binary", "count"):
            return f"a GLM of a {spec.outcome} outcome"
    elif spec.estimator not in ("ols", "mle"):
        return f"estimator {spec.estimator!r}"
    if spec.upload_rows > 0 or spec.bootstrap or any(v not in _MARGINALS
                                                      for v in spec.var_types):
        return "uploaded data (ROADMAP A13)"
    c = spec.cluster
    if c is not None:
        if c.extra_groupings:
            if spec.outcome != "continuous":
                from .glmmfit import extras_unsupported as why_not
            else:
                from .mixedfit import joint_unsupported as why_not
            why = why_not(spec)
            if why:
                return why
        if c.q > MAX_RE_Q:
            kernel = "K9" if spec.outcome == "continuous" else "K10"
            return (f"{c.q} random-effect components; kernel {kernel} takes q <= {MAX_RE_Q} "
                    f"(theta of d <= {MAX_RE_Q * (MAX_RE_Q + 1) // 2}, optim.py's range)")
    elif spec.estimator == "mle":
        return "the mle estimator without a cluster"
    if len(spec.effective_fit_cols) > kernels.MAX_FIT_P:
        return f"wide fits, p > {kernels.MAX_FIT_P} (ROADMAP B10)"
    if (c is not None and spec.outcome != "continuous" and not c.slopes
            and not c.extra_groupings):  # kernel K7's limits
        from .glmmfit import MAX_AGQ, MAX_CLUSTERS

        if not 1 <= int(spec.nagq) <= MAX_AGQ:
            return f"a GLMM at nagq {spec.nagq}; kernel K7 takes 1..{MAX_AGQ} nodes"
        if c.n_clusters_at(spec.max_n) > MAX_CLUSTERS:
            return (f"a GLMM of {c.n_clusters_at(spec.max_n)} clusters; kernel K7 takes at "
                    f"most {MAX_CLUSTERS}")
    return ""


def check_supported(spec: SimSpec) -> None:
    reason = unsupported(spec)
    if reason:
        raise NotImplementedError(f"not ported yet: {reason}")


# ---------------------------------------------------------------------------
# What the scenario draws, and the fill plan
# ---------------------------------------------------------------------------


def _df(df: float) -> Tuple[float, int]:
    """The reference's ``df = max(df, 3)`` and the count of chi-square
    planes, ``round(df)``."""
    df = max(float(df), 3.0)
    return df, max(int(round(df)), 1)


def swappable_cols(spec: SimSpec) -> List[int]:
    """The continuous columns a marginal swap can change (unpinned normal
    columns); none when the scenario swaps no marginal."""
    sc = spec.scenario
    if not (sc.distribution_change_prob > 0.0 and sc.new_distributions):
        return []
    return [j for j, (v, pinned) in enumerate(zip(spec.var_types, spec.var_pinned))
            if v == DIST_NORMAL and not pinned]


def resid_swap(spec: SimSpec) -> bool:
    """Whether the residual family is drawn per sim. Only a continuous
    outcome reads its residual, so the port draws the swap for it alone."""
    sc = spec.scenario
    return (spec.outcome == "continuous" and sc.residual_change_prob > 0.0
            and not spec.residual_pinned and bool(sc.residual_dists))


def resid_codes(spec: SimSpec) -> List[int]:
    """The residual families a sim can draw: the spec's, and under a swap
    each family of the pool."""
    codes = {spec.residual}
    if resid_swap(spec):
        codes |= {RESID_CODES[d] for d in spec.scenario.residual_dists}
    return sorted(codes)


def chi2_planes(spec: SimSpec) -> int:
    """RESID chi-square planes the residual reads: ``round(df)`` when it
    can be skewed or heavy-tailed, else 0."""
    if spec.outcome != "continuous" or not set(resid_codes(spec)) & {
            RESID_RIGHT_SKEWED, RESID_LEFT_SKEWED, RESID_HIGH_KURTOSIS}:
        return 0
    return _df(spec.scenario.residual_df)[1]


def heavy_re_planes(spec: SimSpec) -> int:
    """CLUSTER chi-square planes of a heavy-tailed random intercept, else 0."""
    if spec.cluster is None or spec.scenario.random_effect_dist == "normal":
        return 0
    return _df(spec.scenario.random_effect_df)[1]


def _het(spec: SimSpec) -> float:
    return max(spec.scenario.heterogeneity, 0.0)


def _het_gamma(spec: SimSpec) -> float:
    """Heteroskedasticity's ``gamma = ln(lambda) / 4``, lambda >= 1."""
    return float(np.log(max(spec.scenario.heteroskedasticity_ratio, 1.0)) / 4.0)


def _corr_noise(spec: SimSpec) -> bool:
    return spec.scenario.correlation_noise_sd > 0.0 and spec.n_cont > 1


def _icc_noise(spec: SimSpec) -> bool:
    return spec.cluster is not None and spec.scenario.icc_noise_sd > 0.0


def _resid_mode(spec: SimSpec):
    """The fill mode of the RESID words of a logit outcome or of a uniform
    residual (words), or of a count outcome (open uniforms); None when the
    outcome reads only the RESID normals."""
    if spec.outcome == "binary" and spec.link != "probit":
        return rng.MODE_WORDS
    if spec.outcome == "count":
        return rng.MODE_OPEN_UNIFORM
    if spec.outcome == "continuous" and RESID_UNIFORM in resid_codes(spec):
        return rng.MODE_WORDS
    return None


def sampled_factors(spec: SimSpec) -> List[int]:
    """The factors whose levels are drawn per row: ``factor_sampled[f]``,
    else the scenario's ``sampled_factor_proportions``. The others take the
    fixed allocation codes of the lowering."""
    out = []
    for f in range(spec.n_factors):
        sampled = spec.factor_sampled[f]
        if sampled is None:
            sampled = spec.scenario.sampled_factor_proportions
        if sampled:
            out.append(f)
    return out


def stream_plan(spec: SimSpec) -> List[Tuple[int, int, int]]:
    """``(class, column, rows)`` of every long stream the generation reads
    as normals: the latent predictor normals, the random-effect draws (per
    component c, CLUSTER column c * RE_COLUMNS, and the columns after it up
    to round(df) of a heavy-tailed one, at the cluster count, padded to
    ``max_n`` in the launch: padding costs K1 a store, not a cipher) and, for a continuous or probit outcome, the
    residual normals (RESID column 0) and the chi-square planes (RESID
    1..round(df))."""
    plan = [(rng.CLASS_XNORM, j, spec.max_n) for j in range(spec.n_cont)]
    if spec.cluster is not None:
        planes = 1 + heavy_re_planes(spec)
        m = spec.cluster.n_clusters_at(spec.max_n)
        plan += [(rng.CLASS_CLUSTER, comp * RE_COLUMNS + c, m)
                 for comp in range(spec.cluster.q) for c in range(planes)]
        for g, eg in enumerate(spec.cluster.extra_groupings):
            n_lv = extra_grouping_ids(spec, g)[1]
            plan += [(rng.CLASS_CLUSTER, re_column_base(1 + g, comp) + c, n_lv)
                     for comp in range(1 + len(eg.slopes)) for c in range(planes)]
    if spec.outcome == "continuous" or (spec.outcome == "binary" and spec.link == "probit"):
        plan += [(rng.CLASS_RESID, c, spec.max_n) for c in range(1 + chi2_planes(spec))]
    return plan


def outcome_plan(spec: SimSpec):
    """``(mode, streams)`` of the second fill: the RESID stream of a logit
    outcome or a uniform residual (words, of which the draw takes the top 24
    bits) or a count outcome (open uniforms), then column f of FACTOR for
    each sampled factor f (words, whose top 24 bits are its uniforms). With
    factor words a count outcome's RESID stream is filled as words too and
    turned into the same open uniforms after. None when the generation
    reads no long stream but the normals of :func:`stream_plan`."""
    mode = _resid_mode(spec)
    streams = [(rng.CLASS_RESID, 0, spec.max_n)] if mode is not None else []
    factors = [(rng.CLASS_FACTOR, f, spec.max_n) for f in sampled_factors(spec)]
    if not streams + factors:
        return None
    return (rng.MODE_WORDS if factors else mode), streams + factors


def scenario_plans(spec: SimSpec) -> List[Tuple[int, List[Tuple[int, int, int]]]]:
    """``(mode, streams)`` of the short fills of a scenario, each a launch
    of its own: the normals of the correlation noise (SCENARIO column 0,
    one row per off-diagonal pair), the ICC jitter (column 5, one row) and
    the beta-jitter (HET column 0, one row per design column); then the
    words of the swap uniforms (SCENARIO columns 1 and 2 over the continuous
    columns, 3 and 4 one row each). Empty for the baseline."""
    n = spec.n_cont
    normals, words = [], []
    if _corr_noise(spec):
        normals.append((rng.CLASS_SCENARIO, _SC_CORR, n * (n - 1) // 2))
    if _icc_noise(spec):  # one row per grouping, the primary first
        normals.append((rng.CLASS_SCENARIO, _SC_ICC, 1 + len(spec.cluster.extra_groupings)))
    if _het(spec) > FLOAT_NEAR_ZERO:
        normals.append((rng.CLASS_HET, 0, spec.n_predictors))
    if swappable_cols(spec):
        words += [(rng.CLASS_SCENARIO, _SC_VARSWAP_U, n), (rng.CLASS_SCENARIO, _SC_VARSWAP_PICK, n)]
    if resid_swap(spec):
        words += [(rng.CLASS_SCENARIO, _SC_RESID_U, 1), (rng.CLASS_SCENARIO, _SC_RESID_PICK, 1)]
    return [(mode, st) for mode, st in ((rng.MODE_NORMAL, normals), (rng.MODE_WORDS, words)) if st]


def fill_plan(spec: SimSpec) -> List[Tuple[int, List[Tuple[int, int, int]]]]:
    """``(mode, streams)`` of every fill the generation makes, in order: the
    long normals, the second fill (if any), the scenario's short fills.
    ``rng.fill_streams`` launches K1 once per MAX_STREAMS streams of each."""
    second = outcome_plan(spec)
    return ([(rng.MODE_NORMAL, stream_plan(spec))] + ([second] if second else [])
            + scenario_plans(spec))


def k1_launches(spec: SimSpec) -> int:
    """K1 launches per chunk of sims: one per MAX_STREAMS streams a fill."""
    return sum(-(-len(streams) // rng.MAX_STREAMS) for _, streams in fill_plan(spec))


class Draws:
    """The filled streams of a batch, by ``(class, column)``: each fill's
    tensor ``(sims, streams, rows)`` cut to each stream's own rows."""

    def __init__(self, fills):
        self._at = {}
        for (mode, streams), t in fills:
            for i, (cls, col, rows) in enumerate(streams):
                self._at[(cls, col, mode)] = t[:, i, :rows]

    def normals(self, cls: int, col: int) -> torch.Tensor:
        return self._at[(cls, col, rng.MODE_NORMAL)]

    def words(self, cls: int, col: int) -> torch.Tensor:
        return self._at[(cls, col, rng.MODE_WORDS)]

    def uniform(self, cls: int, col: int) -> torch.Tensor:
        """The top-24-bit uniform in [0, 1) of the words."""
        return rng.u32_to_uniform(self.words(cls, col))

    def open_uniform(self, cls: int, col: int) -> torch.Tensor:
        """The open uniform, filled as such or from the words."""
        got = self._at.get((cls, col, rng.MODE_OPEN_UNIFORM))
        return got if got is not None else rng.u32_to_open_uniform(self.words(cls, col))


def cluster_ids(spec: SimSpec, device=None) -> torch.Tensor:
    """Primary-grouping cluster id per row, (max_n,) int32."""
    rows = torch.arange(spec.max_n, dtype=torch.int32, device=device)
    c = spec.cluster
    if c is None:
        return torch.zeros_like(rows)
    s = max(c.sizing_value, 1)
    return rows % s if c.sizing_mode == "fixed_clusters" else rows // s


def extra_grouping_ids(spec: SimSpec, g: int, device=None):
    """Level id per row ``(max_n,)`` int32 of extra grouping ``g`` and its
    level count, the reference's ``extra_grouping_ids`` (:120): the
    lexicographic stride chain, so each atom block holds every (primary,
    level_1, ..., level_g) combination once. ``fixed_clusters``: stride =
    S * the block levels of the earlier groupings, ``within = (i / stride)
    % blk``; crossed takes ``within`` (blk levels), nested ``(i % S) * blk +
    within`` (S * blk). ``fixed_size`` (nested only): ``(i / cs) * blk + (i %
    cs) % blk``."""
    c = spec.cluster
    eg = c.extra_groupings[g]
    rows = torch.arange(spec.max_n, dtype=torch.int32, device=device)
    blk = max(eg.n_levels, 1)  # crossed: the level count; nested: levels per parent
    if c.sizing_mode == "fixed_size":
        if eg.relation == "crossed":
            raise ValueError("crossed extra groupings require fixed_clusters sizing "
                             "(reference validate: Crossed x FixedSize is rejected)")
        cs = max(c.sizing_value, 1)
        return (rows // cs) * blk + (rows % cs) % blk, c.n_clusters_at(spec.max_n) * blk
    s = max(c.sizing_value, 1)
    stride = s
    for h in c.extra_groupings[:g]:
        stride *= max(h.n_levels, 1)
    within = (rows // stride) % blk
    if eg.relation == "crossed":
        return within, blk
    return (rows % s) * blk + within, s * blk


def re_column_base(grouping: int, comp: int) -> int:
    """The CLUSTER column of component ``comp`` of grouping ``grouping`` (0
    the primary, 1 + g extra grouping g)."""
    return grouping * GROUPING_COLUMNS + comp * RE_COLUMNS


def rep_rows(spec: SimSpec, device=None) -> torch.Tensor:
    """The first row of each row's cluster (the reference's ``_rep_rows``),
    (max_n,) int64: a cluster-level column takes that row's value."""
    rows = torch.arange(spec.max_n, dtype=torch.int64, device=device)
    s = max(spec.cluster.sizing_value, 1)
    return rows % s if spec.cluster.sizing_mode == "fixed_clusters" else rows - rows % s


def re_chol(tau0_sq, slopes) -> torch.Tensor:
    """chol(D + 1e-12 I) in f32 for D = diag(tau) R diag(tau) of the
    intercept and the slopes, as the reference's ``_re_chol`` (:416): R has
    ``intercept_corr`` between the intercept and each slope and ``corr_i *
    corr_j`` between slopes (the single-factor model). ``tau0_sq`` is a
    number or an f32 tensor of per-sim values ``(sims,)``; returns ``(q, q)``
    or ``(sims, q, q)``. The Cholesky is smallchol's operation order, so at
    q = 1 it is sqrt(tau * 1 * tau + 1e-12), the reference's value bit for
    bit."""
    from . import smallchol

    q = 1 + len(slopes)
    t0 = torch.as_tensor(tau0_sq, dtype=torch.float32)
    taus = [torch.sqrt(torch.clamp(t0, min=0.0))] + [
        torch.full_like(t0, marginals.f32(np.sqrt(max(s.variance, 0.0)))) for s in slopes]
    corr = np.eye(q)
    for i, s in enumerate(slopes):
        corr[0, 1 + i] = corr[1 + i, 0] = s.intercept_corr
    for i, si in enumerate(slopes):
        for j, sj in enumerate(slopes):
            if i != j:
                corr[1 + i, 1 + j] = si.intercept_corr * sj.intercept_corr
    corr = corr.astype(np.float32)
    eps = marginals.f32(1e-12)
    D = torch.stack([torch.stack([taus[i] * float(corr[i, j]) * taus[j] + (eps if i == j else 0.0)
                                  for j in range(q)], dim=-1) for i in range(q)], dim=-2)
    return smallchol.chol(D)


# ---------------------------------------------------------------------------
# The per-sim scenario design, residual families and random effects
# ---------------------------------------------------------------------------


def psd_repair_chol(sigma: torch.Tensor) -> torch.Tensor:
    """Spectral-clip PSD repair (eigenvalues floored at 1e-10) and
    Cholesky of a batch of f64 correlation matrices ``(..., n, n)``, as the
    reference's ``_psd_repair_chol``: ``eigh``, the floor, ``(V w) V^T``,
    ``cholesky``. The repaired matrix is positive definite by construction,
    so the Cholesky skips torch's error check, a wait for the device."""
    w, v = torch.linalg.eigh(sigma)
    w = torch.clamp(w, min=1e-10)
    return torch.linalg.cholesky_ex((v * w[..., None, :]) @ v.transpose(-1, -2)).L


def design_draw(spec: SimSpec, arr: Dict[str, torch.Tensor], draws: Draws, sims: int, device):
    """The reference's ``_design_draw`` (:289) per sim: ``(L, var_codes,
    resid_code, tau2_eff)``. ``L`` is the f32 mixing factor, ``(n_cont,
    n_cont)`` from the lowering or ``(sims, n_cont, n_cont)`` under
    correlation noise; ``var_codes (sims, n_cont)`` int64 or None when no
    marginal is swapped; ``resid_code (sims,)`` int64 or None when the
    residual family is the spec's; ``tau2_eff`` the f32 intercept variance,
    ``(sims,)`` under ICC noise, else a number.

    Integer draws compare the f32 uniforms with f32 thresholds and
    truncate ``u * k`` in f32, as the reference does."""
    sc = spec.scenario
    n = spec.n_cont
    f32 = marginals.f32
    if _corr_noise(spec):
        noise = draws.normals(rng.CLASS_SCENARIO, _SC_CORR).to(torch.float64) \
            * sc.correlation_noise_sd
        i, j = np.triu_indices(n, k=1)
        sigma = arr["corr"].to(device=device, dtype=torch.float64).repeat(sims, 1, 1)
        sigma[:, i, j] += noise
        sigma[:, j, i] += noise
        sigma = torch.where(torch.eye(n, dtype=torch.bool, device=device), 1.0,
                            torch.clamp(sigma, -0.8, 0.8))
        L = psd_repair_chol(sigma).to(torch.float32)
    else:
        L = arr["corr_chol"].to(device=device, dtype=torch.float32)

    var_codes = None
    swappable = swappable_cols(spec)
    if swappable:
        pool = torch.as_tensor([DIST_CODES[d] for d in sc.new_distributions], device=device)
        k = len(sc.new_distributions)
        u_swap = draws.uniform(rng.CLASS_SCENARIO, _SC_VARSWAP_U)
        pick = torch.clamp((draws.uniform(rng.CLASS_SCENARIO, _SC_VARSWAP_PICK) * k)
                           .to(torch.int64), max=k - 1)
        mask = torch.zeros(n, dtype=torch.bool, device=device)
        mask[swappable] = True
        base = torch.as_tensor(spec.var_types, dtype=torch.int64, device=device)
        var_codes = torch.where(mask & (u_swap < f32(sc.distribution_change_prob)), pool[pick],
                                base)

    resid_code = None
    if resid_swap(spec):
        pool_r = torch.as_tensor([RESID_CODES[d] for d in sc.residual_dists], device=device)
        k = len(sc.residual_dists)
        u_r = draws.uniform(rng.CLASS_SCENARIO, _SC_RESID_U)[:, 0]
        pick_r = torch.clamp((draws.uniform(rng.CLASS_SCENARIO, _SC_RESID_PICK)[:, 0] * k)
                             .to(torch.int64), max=k - 1)
        resid_code = torch.where(u_r < f32(sc.residual_change_prob), pool_r[pick_r],
                                 spec.residual)

    tau2_eff = None
    if spec.cluster is not None:
        tau2_eff = f32(spec.cluster.tau_squared)
        if _icc_noise(spec):
            jitter = draws.normals(rng.CLASS_SCENARIO, _SC_ICC)[:, 0]
            tau2_eff = torch.clamp(tau2_eff + jitter * f32(sc.icc_noise_sd), min=0.0)
    return L, var_codes, resid_code, tau2_eff


def extra_tau2_eff(spec: SimSpec, draws: Draws) -> list:
    """The f32 variance of each extra grouping's intercept, in order: its
    tau^2, or under ICC noise ``max(tau^2 + z sd, 0)`` with z row 1 + g of
    the ICC draw (row 0 is the primary's, :func:`design_draw`), each
    ``(sims,)``, as the reference's per-grouping ``tau2_eff`` (:365-379)."""
    f32 = marginals.f32
    out = []
    for g, eg in enumerate(spec.cluster.extra_groupings):
        tau2 = f32(eg.tau_squared)
        if _icc_noise(spec):
            jitter = draws.normals(rng.CLASS_SCENARIO, _SC_ICC)[:, 1 + g]
            tau2 = torch.clamp(tau2 + jitter * f32(spec.scenario.icc_noise_sd), min=0.0)
        out.append(tau2)
    return out


def _t_scaled(z: torch.Tensor, chi2: torch.Tensor, df: float) -> torch.Tensor:
    """``where(denom > 0, z / denom, z)`` with ``denom = sqrt(chi2 / df)``
    (f32 division by the f32 df)."""
    denom = torch.sqrt(chi2 / marginals.const(df, chi2))
    return torch.where(denom > 0, z / denom, z)


def _chi2(planes) -> torch.Tensor:
    """The chi-square accumulator: squares summed plane by plane, in f32."""
    chi2 = torch.zeros_like(planes[0])
    for g in planes:
        chi2 = chi2 + g * g
    return chi2


def unit_residuals(spec: SimSpec, draws: Draws, resid_code) -> torch.Tensor:
    """Unit-variance residual draws ``(sims, max_n)`` of the family
    ``resid_code`` (per sim, or None for the spec's own), as the reference's
    ``_unit_residual_draws`` (:172): slot 0 is z (and, through its words,
    the uniform U(-sqrt 3, sqrt 3)); slots 1..round(df) are the chi-square
    planes of t(df), scaled by sqrt((df - 2) / df), and of chi-square(df),
    centred and scaled by 1 / sqrt(2 df), sign-flipped for left skew."""
    f32 = marginals.f32
    z = draws.normals(rng.CLASS_RESID, 0)
    codes = resid_codes(spec)
    cand = {RESID_NORMAL: z}
    if chi2_planes(spec):
        df, df_int = _df(spec.scenario.residual_df)
        chi2 = _chi2([draws.normals(rng.CLASS_RESID, 1 + s) for s in range(df_int)])
        cand[RESID_HIGH_KURTOSIS] = _t_scaled(z, chi2, df) * f32(1.0 / np.sqrt(df / (df - 2.0)))
        centred = (chi2 - f32(df)) * f32(1.0 / np.sqrt(2.0 * df))
        cand[RESID_RIGHT_SKEWED], cand[RESID_LEFT_SKEWED] = centred, -centred
    if RESID_UNIFORM in codes:
        u = draws.uniform(rng.CLASS_RESID, 0)
        cand[RESID_UNIFORM] = (2.0 * u - 1.0) * f32(marginals.SQRT3)
    if resid_code is None:
        return cand[spec.residual]
    out = z
    for code in codes:
        out = torch.where((resid_code == code)[:, None], cand[code], out)
    return out


def re_draws(spec: SimSpec, draws: Draws, comp: int = 0, grouping: int = 0) -> torch.Tensor:
    """Unit-variance draws ``(sims, levels)`` of random-effect component
    ``comp`` (0 the intercept, 1 + k slope k) of grouping ``grouping`` (0
    the primary) under the scenario's RE distribution, as the reference's
    ``_re_draw`` (:391) at column base :func:`re_column_base`: CLUSTER
    column base, or the standardized t(df) of columns base..base +
    round(df), scaled by sqrt((df - 2) / df)."""
    base = re_column_base(grouping, comp)
    z = draws.normals(rng.CLASS_CLUSTER, base)
    planes = heavy_re_planes(spec)
    if not planes:
        return z
    df, _ = _df(spec.scenario.random_effect_df)
    chi2 = _chi2([draws.normals(rng.CLASS_CLUSTER, base + 1 + s) for s in range(planes)])
    return _t_scaled(z, chi2, df) * marginals.f32(np.sqrt((df - 2.0) / df))


def re_contribution(spec: SimSpec, draws: Draws, X: torch.Tensor, tau2_eff,
                    ids: torch.Tensor) -> torch.Tensor:
    """The random-effect value of each row ``(sims, max_n)``, as the
    reference's ``_cluster_re_contribution`` (:441-475): per grouping (the
    primary, then each extra grouping at its level ids) the component draws
    ``z (sims, levels, q)``, ``u = z @ L^T`` with L = :func:`re_chol` of its
    ``tau2_eff`` (per sim under ICC noise, which scales the intercept
    alone), then ``u[ids, 0] + sum_k u[ids, 1 + k] X[:, col_k]`` added on.
    ``z @ L^T`` is written out in f32 multiply-adds over L's lower triangle,
    in column order, so that the CPU and the card agree; with no slope it is
    the intercept draw times its scale. ``tau2_eff`` is the primary's."""
    c = spec.cluster
    groups = [(c.slopes, tau2_eff, ids)]
    extras = extra_tau2_eff(spec, draws) if c.extra_groupings else []
    for g, eg in enumerate(c.extra_groupings):
        groups.append((eg.slopes, extras[g], extra_grouping_ids(spec, g, ids.device)[0]))
    u_re = None
    for grouping, (slopes, tau2, gids) in enumerate(groups):
        q = 1 + len(slopes)
        L = re_chol(tau2, slopes)
        if L.dim() == 3:  # per sim: (sims, 1, q, q) against (sims, levels)
            L = L[:, None]
        z = [re_draws(spec, draws, comp, grouping) for comp in range(q)]
        idx = gids.long()
        for i in range(q):
            ui = z[0] * L[..., i, 0]
            for k in range(1, i + 1):
                ui = ui + z[k] * L[..., i, k]
            term = ui[:, idx]
            if i:
                term = term * X[..., slopes[i - 1].design_col]
            u_re = term if u_re is None else u_re + term
    return u_re


def beta_jitter(spec: SimSpec, beta: torch.Tensor, draws: Draws) -> torch.Tensor:
    """The per-sim effects ``(sims, P)`` under heterogeneity (the
    reference's :585-603): ``beta + z * s`` with ``s = het |beta|`` on the
    effect columns and, on the intercept, 0 for a continuous outcome and
    ``het`` otherwise; effects clipped toward zero, never across it, the
    intercept unclipped."""
    het = marginals.f32(_het(spec))
    delta = draws.normals(rng.CLASS_HET, 0)
    s0 = 0.0 if spec.outcome == "continuous" else het
    s = torch.cat([torch.full((1,), s0, dtype=torch.float32, device=beta.device),
                   het * torch.abs(beta[1:])])
    raw = beta + delta * s
    clipped = torch.where(beta > 0, torch.clamp(raw, min=0.0),
                          torch.where(beta < 0, torch.clamp(raw, max=0.0), raw))
    return torch.cat([raw[:, :1], clipped[:, 1:]], dim=1)


def heteroskedastic(spec: SimSpec, arr: Dict[str, torch.Tensor], eps: torch.Tensor,
                    lp_clean: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """The residuals scaled by ``sqrt(exp(gamma z) exp(-gamma^2 / 2))``,
    ``gamma = ln(lambda) / 4``, with z the driver (``lp_clean`` or a design
    column) standardized by the lowering's f64 mean and sd, as the
    reference's :620-640. The reference's f64 centre and sd promote the
    driver, the multiplier and the scaled residuals to f64 (x64 on), so the
    residuals come back in f64 and y is rounded to f32 once, after ``eta +
    eps``; where the sd is 0 the residuals are kept."""
    gamma = _het_gamma(spec)
    if spec.het_driver is None:
        center, std, driver = arr["het_lp_mean"], arr["het_lp_std"], lp_clean
    else:
        d = spec.het_driver
        center, std, driver = arr["het_col_mean"][d], arr["het_col_std"][d], X[..., d]
    center = center.to(device=eps.device, dtype=torch.float64)
    std = std.to(device=eps.device, dtype=torch.float64)
    active = std > FLOAT_NEAR_ZERO
    zdrv = torch.where(active, (driver.to(torch.float64) - center) / std, 0.0)
    mult = torch.exp(marginals.f32(gamma) * zdrv) * marginals.f32(np.exp(-gamma * gamma / 2.0))
    eps = eps.to(torch.float64)
    return torch.where(active, eps * torch.sqrt(mult), eps)


# ---------------------------------------------------------------------------
# Count outcomes: kernel K8 and its plain version
# ---------------------------------------------------------------------------

U_TOP = float(np.float32(1.0 - 6e-8))  # the clamp of the count draw's uniform
POISSON_WALK_MAX_LAM = 20.0
POISSON_WALK_STEPS = 200


def poisson_quantile_plain(u: torch.Tensor, eta: torch.Tensor) -> torch.Tensor:
    """Poisson inverse CDF at the open uniform ``u`` (f32) with rate
    ``exp(eta)`` (f32), as the reference's ``_poisson_quantile`` (datagen.py
    :217) with its caller's clamp and rate (:654-665).

    ``u`` is clamped at 1 - 6e-8. Rates up to 20 walk the f64 cumulative PMF,
    at most 200 steps; a lane stops once its CDF reaches ``u``, which is where
    the reference's batch-wide loop stops changing it. Above 20 the normal
    approximation ``floor(lam + z sqrt(lam) + 0.5)``, floored at 0, with ``z``
    the f32 Acklam ppf of ``u``. A zero rate (``eta`` below about -104) gives
    0. Returns f32 counts.
    """
    u = torch.clamp(u.to(torch.float32), max=U_TOP)
    lam = torch.exp(eta.to(torch.float32))
    u64, lam64 = u.double(), lam.double()
    p = torch.exp(-lam64)
    cdf = p
    y = torch.zeros_like(u)
    walk = lam64 <= POISSON_WALK_MAX_LAM
    k = 0
    while k < POISSON_WALK_STEPS and bool(((cdf < u64) & walk).any()):
        # a tensor divisor: torch divides by a Python number through its
        # reciprocal, K8 (and the reference) by IEEE division
        p = p * lam64 / torch.full_like(p, float(k + 1))
        y = torch.where(cdf < u64, y + 1.0, y)
        cdf = cdf + p
        k += 1
    z = rng.norm_ppf_f32(u)
    y_norm = torch.clamp(torch.floor(lam + z * torch.sqrt(lam) + 0.5), min=0.0)
    y = torch.where(lam <= POISSON_WALK_MAX_LAM, y, y_norm)
    return torch.where(lam > 0.0, y, torch.zeros_like(y))


_POISSON_ARGS = [
    ctypes.c_void_p,  # u (n,) f32 open uniforms
    ctypes.c_void_p,  # eta (n,) f32
    ctypes.c_longlong,  # n
    ctypes.c_void_p,  # y out (n,) f32
    ctypes.c_void_p,  # cudaStream_t
]


def poisson_quantile_kernel(u: torch.Tensor, eta: torch.Tensor) -> torch.Tensor:
    """Kernel K8 (``csrc/poisson_quantile.cu``): the same counts on the
    card, one thread per row."""
    if u.dtype != torch.float32 or eta.dtype != torch.float32 or u.shape != eta.shape:
        raise ValueError(f"poisson_quantile kernel takes f32 u and eta of one shape, got "
                         f"{u.dtype} {tuple(u.shape)} and {eta.dtype} {tuple(eta.shape)}")
    u, eta = u.contiguous(), eta.contiguous()
    y = torch.empty_like(u)
    kernels.require_cuda("poisson_quantile", u, eta, y)
    if u.numel():
        k = kernels.KERNELS["poisson_quantile"]
        fn = k.fn("mcp_poisson_quantile", _POISSON_ARGS)
        k.check(fn(kernels.ptr(u), kernels.ptr(eta), u.numel(), kernels.ptr(y),
                   kernels.stream_of(u)))
    return y


def poisson_quantile(u: torch.Tensor, eta: torch.Tensor) -> torch.Tensor:
    """K8 for CUDA tensors, the plain version for CPU tensors."""
    if u.is_cuda:
        return poisson_quantile_kernel(u, eta)
    if u.device.type != "cpu":
        raise ValueError(f"poisson_quantile: no kernel for device {u.device}")
    return poisson_quantile_plain(u, eta)


# ---------------------------------------------------------------------------
# Main entry
# ---------------------------------------------------------------------------


def _factor_levels(spec: SimSpec, arr: Dict[str, torch.Tensor], f: int, words, sims: int,
                   device) -> torch.Tensor:
    """Level codes ``(sims, max_n)`` of factor ``f`` (the reference's
    generate, :541-562): the fixed allocation codes of the lowering, or, for
    a sampled factor, ``u >= cdf[:-1]`` summed, with ``u`` the top-24-bit
    uniform of its FACTOR words and ``cdf = cumsum(probs) / sum(probs)`` in
    the f64 of the lowered proportions, against which the f32 ``u`` is
    compared exactly, as the reference compares it."""
    n_levels = spec.factor_levels[f]
    if words is None:
        codes = arr[f"fixed_codes_{f}"].to(device=device, dtype=torch.int64)
        return codes.expand(sims, spec.max_n)
    off = sum(spec.factor_levels[:f])
    probs = arr["factor_props"][off : off + n_levels].to(device)
    cdf = torch.cumsum(probs, 0) / probs.sum()
    u = rng.u32_to_uniform(words).to(probs.dtype)
    return (u[..., None] >= cdf[:-1]).sum(-1)


def generate_from_draws(spec: SimSpec, arr: Dict[str, torch.Tensor], draws: Draws, sims: int,
                        device, *, plain: bool = False):
    """``(X, y, ids)`` from the filled streams ``draws``, in the order of
    the reference's ``generate`` (:484-665). ``plain=True`` draws counts
    through the plain version of K8 on any device."""
    max_n = spec.max_n
    L, var_codes, resid_code, tau2_eff = design_draw(spec, arr, draws, sims, device)
    cols = [torch.ones((sims, max_n), dtype=torch.float32, device=device)]
    if spec.n_cont > 0:
        z = torch.stack([draws.normals(rng.CLASS_XNORM, j) for j in range(spec.n_cont)], -1)
        # f32; TF32 is off (package __init__); a per-sim L under correlation noise
        mixed = torch.matmul(z, L.transpose(-1, -2))
        params = np.asarray(arr["var_params"].cpu(), np.float32)
        pool = [DIST_CODES[d] for d in spec.scenario.new_distributions]
        for j in range(spec.n_cont):
            if var_codes is not None and j in swappable_cols(spec):
                col = marginals.apply_marginal(mixed[..., j], var_codes[:, j], params[j],
                                               [spec.var_types[j]] + pool)
            else:
                col = marginals.apply_marginal_static(mixed[..., j], spec.var_types[j], params[j])
            cols.append(col)
    for f, n_levels in enumerate(spec.factor_levels):  # reference-coded dummies
        words = draws.words(rng.CLASS_FACTOR, f) if f in sampled_factors(spec) else None
        lvl = _factor_levels(spec, arr, f, words, sims, device)
        for d in range(n_levels - 1):
            cols.append((lvl == d + 1).to(torch.float32))
    if spec.cluster is not None and spec.cluster.between_cols:  # cluster-level columns
        rep = rep_rows(spec, device)
        for c in spec.cluster.between_cols:
            cols[c] = cols[c][:, rep]
    for comps in spec.interactions:
        prod = cols[comps[0]]
        for cidx in comps[1:]:
            prod = prod * cols[cidx]
        cols.append(prod)
    X = torch.stack(cols, dim=-1)  # (sims, max_n, P)

    beta = arr["effects"].to(device=device, dtype=torch.float32)
    lp_clean = torch.matmul(X, beta)  # (sims, max_n)
    if _het(spec) > FLOAT_NEAR_ZERO:
        lp = torch.matmul(X, beta_jitter(spec, beta, draws)[..., None])[..., 0]
    else:
        lp = lp_clean

    ids = cluster_ids(spec, device)
    if spec.cluster is not None:
        eta = lp + re_contribution(spec, draws, X, tau2_eff, ids)
    else:
        eta = lp
    one, zero = torch.ones_like(eta), torch.zeros_like(eta)
    if spec.outcome == "continuous":
        eps = unit_residuals(spec, draws, resid_code)
        if _het_gamma(spec) > FLOAT_NEAR_ZERO:
            y = (eta.to(torch.float64) + heteroskedastic(spec, arr, eps, lp_clean, X)).to(
                torch.float32)
        else:
            y = eta + eps
    elif spec.outcome == "binary" and spec.link == "probit":
        y = torch.where(draws.normals(rng.CLASS_RESID, 0) < eta, one, zero)
    elif spec.outcome == "binary":
        y = torch.where(draws.uniform(rng.CLASS_RESID, 0) < torch.sigmoid(eta), one, zero)
    else:  # count
        u = draws.open_uniform(rng.CLASS_RESID, 0)
        y = (poisson_quantile_plain if plain else poisson_quantile)(u, eta)
    return X, y, ids.unsqueeze(0).expand(sims, max_n)


def factor_min_counts(spec: SimSpec, X: torch.Tensor) -> torch.Tensor:
    """Smallest realized level count per (sim, grid point, factor), ``(sims,
    G, n_factors)`` in X's f32, from the dummies of the generated design (the
    reference's ``factor_min_counts``, :263): the level counts are prefix
    sums of 0/1 values below 2^24, exact in any order, and the reference
    level's count is n less their sum."""
    idx = torch.as_tensor([n - 1 for n in spec.grid], device=X.device)
    ns = torch.as_tensor(spec.grid, dtype=X.dtype, device=X.device)
    out = []
    for f in range(spec.n_factors):
        counts = torch.cumsum(X[..., list(spec.factor_dummy_cols(f))], dim=1)[:, idx]
        ref_count = ns - counts.sum(-1)
        out.append(torch.minimum(counts.amin(-1), ref_count))
    return torch.stack(out, dim=-1)


def to_device(arrays: Dict, device) -> Dict[str, torch.Tensor]:
    """The lowered numpy arrays as tensors on ``device`` (dtypes kept)."""
    return {k: torch.as_tensor(np.asarray(v), device=device) for k, v in arrays.items()}


def generate_batch(spec: SimSpec, arr: Dict[str, torch.Tensor], seed_lo: int, seed_hi: int,
                   sim_ids: torch.Tensor, *, plain: bool = False):
    """``X (sims, max_n, P) f32``, ``y (sims, max_n) f32``, ``ids (sims,
    max_n) int32`` for the sims ``sim_ids`` (int64, on the run's device).
    y is the continuous outcome, or 0/1 or counts as f32.

    ``plain=True`` runs the plain PyTorch Philox fill and Poisson quantile
    on any device (used to time and check kernels K1 and K8 against them).
    """
    check_supported(spec)
    fill = rng.fill_streams_plain if plain else rng.fill_streams
    fills = [(plan, fill(seed_lo, seed_hi, sim_ids, plan[1], plan[0])) for plan in fill_plan(spec)]
    return generate_from_draws(spec, arr, Draws(fills), sim_ids.shape[0], sim_ids.device,
                               plain=plain)
