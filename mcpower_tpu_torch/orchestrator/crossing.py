"""Model-based crossing fit for sample-size search.

Isotonic (PAVA) fit of a corrected power-vs-N series, read off at the target
power; 95% CI on the required N by Wilson band inversion; probit-in-sqrt(N)
extrapolation hint when the target is never reached in range. Pure and
deterministic over ``(grid, counts, n_sims, target, atom)`` so the merge path
recomputes identical values from pooled counters.

Semantics mirror the reference's crossing fit
(crates/engine-orchestrator/src/fit.rs): 2-SE monotonicity gate on the raw
series, leftmost crossing on flat blocks, CI from PAVA'd Wilson lo/hi bands,
probit WLS with delta-method weights gated at fitted endpoint power >= 0.5 and
capped at 2x the grid ceiling, atom-ceiled achievable N.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from scipy import stats as _stats

from .aggregation import wilson_ci

Z_GATE = 2.0
MIN_HINT_POWER = 0.5
EXTRAPOLATION_CAP = 2.0


@dataclass
class CrossingFit:
    """One curve's crossing result.

    kind: "fitted" | "not_reached" | "at_or_below_min" | "non_monotone"
    """

    kind: str
    n_star: Optional[float] = None
    n_achievable: Optional[int] = None
    ci_lo: Optional[float] = None
    ci_hi: Optional[float] = None
    n_approx: Optional[int] = None  # probit extrapolation hint (not_reached)
    n_min: Optional[int] = None  # at_or_below_min
    max_violation: Optional[float] = None  # non_monotone

    def to_dict(self) -> dict:
        """Result-tree form. ``status`` duplicates ``kind`` — the reference
        envelope's key for the same vocabulary (result_host.rs:292
        status-tagged map), kept so reference-written consumers read it."""
        d = dict(self.__dict__)
        d["status"] = self.kind
        return d


def pava(y: Sequence[float]) -> np.ndarray:
    """Least-squares non-decreasing fit (pool adjacent violators), unweighted.

    Python only: the native host library is not ported yet (ROADMAP A13)."""
    means: List[float] = []
    lens: List[int] = []
    for v in y:
        means.append(float(v))
        lens.append(1)
        while len(means) >= 2 and means[-2] > means[-1]:
            m = means.pop()
            l = lens.pop()
            means[-1] = (means[-1] * lens[-1] + m * l) / (lens[-1] + l)
            lens[-1] += l
    return np.repeat(means, lens)


def _crossing(grid: np.ndarray, fitted: np.ndarray, target: float) -> Optional[float]:
    """Leftmost linear-interpolated crossing of a non-decreasing series."""
    if fitted[0] >= target:
        return float(grid[0])
    above = np.nonzero(fitted >= target)[0]
    if above.size == 0:
        return None
    i = int(above[0])
    x0, x1 = float(grid[i - 1]), float(grid[i])
    y0, y1 = float(fitted[i - 1]), float(fitted[i])
    return x0 + (target - y0) * (x1 - x0) / (y1 - y0)


def ceil_to_atom(n: float, atom: int) -> int:
    """Ceil a continuous N to the next multiple of the cluster atom.

    The 1e-9 backoff absorbs interpolation float noise so an exact multiple
    is not inflated to the next one.
    """
    a = max(int(atom), 1)
    n_int = max(int(np.ceil(n - 1e-9)), 1)
    return ((n_int + a - 1) // a) * a


def _monotonicity_violation(p_hat: np.ndarray, n_sims: float) -> Optional[float]:
    """Largest decrease across any i<j pair, gated at Z_GATE independent-SEs."""
    # max over j of (max over i<=j of p_i) - p_j
    run_max = np.maximum.accumulate(p_hat)
    drops = run_max - p_hat
    j = int(np.argmax(drops))
    max_drop = float(drops[j])
    if max_drop <= 0.0:
        return None
    i = int(np.argmax(p_hat[: j + 1]))
    pi, pj = float(p_hat[i]), float(p_hat[j])
    se = np.sqrt((pi * (1 - pi) + pj * (1 - pj)) / n_sims)
    return max_drop if max_drop > Z_GATE * se else None


def _probit_hint(
    grid: np.ndarray,
    p_hat: np.ndarray,
    fitted: np.ndarray,
    n_sims: float,
    target: float,
    atom: int,
) -> Optional[int]:
    """Probit-in-sqrt(N) WLS extrapolation, inverted at the target power."""
    if fitted[-1] < MIN_HINT_POWER:
        return None
    clamp = 0.5 / n_sims
    p = np.clip(p_hat, clamp, 1.0 - clamp)
    z = _stats.norm.ppf(p)
    pdf = _stats.norm.pdf(z)
    w = n_sims * pdf * pdf / (p * (1.0 - p))
    x = np.sqrt(grid.astype(np.float64))
    sw, swx, swy = w.sum(), (w * x).sum(), (w * z).sum()
    swxx, swxy = (w * x * x).sum(), (w * x * z).sum()
    denom = sw * swxx - swx * swx
    if not np.isfinite(denom) or denom <= 0.0:
        return None
    slope = (sw * swxy - swx * swy) / denom
    intercept = (swy - slope * swx) / sw
    if not np.isfinite(slope) or slope <= 0.0:
        return None
    z_target = float(_stats.norm.ppf(target))
    sqrt_n = (z_target - intercept) / slope
    if sqrt_n <= 0.0:
        return None
    n_hint = sqrt_n * sqrt_n
    if n_hint > EXTRAPOLATION_CAP * float(grid[-1]):
        return None
    return ceil_to_atom(n_hint, atom)


def fit_crossing(
    grid: Sequence[int],
    counts: Sequence[int],
    n_sims: int,
    target_power: float,
    atom: int = 1,
) -> CrossingFit:
    """Fit one power-vs-N curve and locate the target-power crossing.

    ``target_power`` is a percentage (80) or proportion (0.8) — values > 1 are
    treated as percentages.
    """
    grid = np.asarray(grid, dtype=np.int64)
    counts = np.asarray(counts, dtype=np.int64)
    if n_sims == 0 or grid.size == 0:
        return CrossingFit(kind="not_reached", n_approx=None)
    target = target_power / 100.0 if target_power > 1.0 else float(target_power)
    n_f = float(n_sims)
    p_hat = counts / n_f

    violation = _monotonicity_violation(p_hat, n_f)
    if violation is not None:
        return CrossingFit(kind="non_monotone", max_violation=violation)

    fitted = pava(p_hat)
    if fitted[0] >= target:
        return CrossingFit(kind="at_or_below_min", n_min=int(grid[0]))
    if fitted[-1] < target:
        return CrossingFit(
            kind="not_reached",
            n_approx=_probit_hint(grid, p_hat, fitted, n_f, target, atom),
        )

    n_star = _crossing(grid, fitted, target)
    assert n_star is not None
    lo_series, hi_series = wilson_ci(counts, n_sims)
    hi_band = pava(np.atleast_1d(hi_series))
    lo_band = pava(np.atleast_1d(lo_series))
    ci_lo = None if hi_band[0] >= target else _crossing(grid, hi_band, target)
    ci_hi = _crossing(grid, lo_band, target)
    return CrossingFit(
        kind="fitted",
        n_star=n_star,
        n_achievable=ceil_to_atom(n_star, atom),
        ci_lo=ci_lo,
        ci_hi=ci_hi,
    )
