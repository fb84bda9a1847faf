"""Host-side aggregation: Wilson intervals and count -> power folding.

All rates in results are derived from raw integer counters; the counters are
the only thing a multi-device / multi-host run has to communicate (small int
tensors per run), and the only thing the merge algebra pools
(:mod:`.merge`). Semantics mirror
the reference's aggregation fold (crates/engine-orchestrator/src/
aggregation.rs): Wilson 95% score interval with z = 1.96, rate 0 on an empty
batch, convergence defaulting to 1 on an empty batch.
"""

from __future__ import annotations

import numpy as np

WILSON_Z = 1.96


def wilson_ci(k, n, z: float = WILSON_Z):
    """Wilson 95% score interval for k successes out of n. Vectorized.

    Returns ``(lo, hi)`` float arrays (or scalars). ``n == 0`` -> (0, 1).
    """
    k = np.asarray(k, dtype=np.float64)
    n_arr = np.asarray(n, dtype=np.float64)
    safe_n = np.where(n_arr > 0, n_arr, 1.0)
    p = k / safe_n
    z2 = z * z
    denom = 1.0 + z2 / safe_n
    center = (p + z2 / (2.0 * safe_n)) / denom
    margin = z * np.sqrt(p * (1.0 - p) / safe_n + z2 / (4.0 * safe_n * safe_n)) / denom
    lo = np.maximum(center - margin, 0.0)
    hi = np.minimum(center + margin, 1.0)
    lo = np.where(n_arr > 0, lo, 0.0)
    hi = np.where(n_arr > 0, hi, 1.0)
    if lo.ndim == 0:
        return float(lo), float(hi)
    return lo, hi


def rate(k, n):
    """k / n with the n == 0 -> 0.0 guard, vectorized."""
    k = np.asarray(k, dtype=np.float64)
    n_arr = np.asarray(n, dtype=np.float64)
    out = np.where(n_arr > 0, k / np.where(n_arr > 0, n_arr, 1.0), 0.0)
    return float(out) if out.ndim == 0 else out
