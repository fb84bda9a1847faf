"""Batched dataset synthesis: the generation half of the main path.

The port of ``mcpower_tpu.engine.datagen.generate`` for the designs of this
slice, with the sim axis written out: one call builds ``X (sims, max_n, P)
f32``, ``y (sims, max_n) f32`` and the cluster ids for a batch of sims.

Every draw comes from one batched Philox fill (``rng.fill_streams``, kernel
K1 on the card) over the streams :func:`stream_plan` lists, at the
reference's addresses, so ``X[:, :N]`` is a nested prefix across the grid
(common random numbers) and a value never depends on the batch.

The stages follow the reference in order: the static design draw (``L =
corr_chol``), the f32 mix ``z @ L.T``, the normal/binary marginals, the
interaction block, ``lp = X @ beta``, the primary random intercept
(``u = z_c * chol(tau^2 + 1e-12)`` indexed by cluster id) and the normal
residual. The reference also fills ``df`` chi-square planes for the other
residual families and discards them in a select; for a statically normal
residual the port skips them, which leaves every value unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from . import marginals, rng
from .spec import DIST_BINARY, DIST_NORMAL, RESID_NORMAL, SimSpec


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
# The slice's scope
# ---------------------------------------------------------------------------


def unsupported(spec: SimSpec) -> str:
    """Why the port cannot run ``spec`` yet, naming the ROADMAP item that
    will port it; '' when the spec is inside this slice."""
    sc = spec.scenario
    if spec.estimator == "glm" or spec.outcome != "continuous":
        if spec.cluster is not None:
            return "GLMM fits (ROADMAP A9)"
        return "GLM fits and binary/count outcomes (ROADMAP A8)"
    if spec.estimator not in ("ols", "mle"):
        return f"estimator {spec.estimator!r}"
    if spec.factor_levels:
        return "factor predictors (ROADMAP A8)"
    if spec.posthoc:
        return "posthoc contrasts (ROADMAP A8)"
    if spec.upload_rows > 0 or spec.bootstrap:
        return "uploaded data (ROADMAP A13)"
    if any(v not in (DIST_NORMAL, DIST_BINARY) for v in spec.var_types):
        return "marginals other than normal and binary (ROADMAP A10)"
    if not sc.is_baseline:
        return "scenario perturbations, heterogeneity and heteroskedasticity (ROADMAP A10)"
    if spec.residual != RESID_NORMAL:
        return "non-normal residuals (ROADMAP A10)"
    c = spec.cluster
    if c is not None:
        if c.slopes:
            return "random slopes (ROADMAP A11)"
        if c.extra_groupings:
            return "extra groupings (ROADMAP A12)"
        if c.between_cols:
            return "cluster-level predictor columns (ROADMAP A10)"
    elif spec.estimator == "mle":
        return "the mle estimator without a cluster"
    return ""


def check_supported(spec: SimSpec) -> None:
    reason = unsupported(spec)
    if reason:
        raise NotImplementedError(f"not ported yet: {reason}")


# ---------------------------------------------------------------------------
# Draw plan and small host pieces
# ---------------------------------------------------------------------------


def stream_plan(spec: SimSpec) -> List[Tuple[int, int, int]]:
    """``(class, column, rows)`` of every stream the generation reads:
    the latent predictor normals, the primary-intercept draws (column 0 of
    CLUSTER) and the residual normals (column 0 of RESID)."""
    plan = [(rng.CLASS_XNORM, j, spec.max_n) for j in range(spec.n_cont)]
    if spec.cluster is not None:
        plan.append((rng.CLASS_CLUSTER, 0, spec.cluster.n_clusters_at(spec.max_n)))
    plan.append((rng.CLASS_RESID, 0, spec.max_n))
    return plan


def cluster_ids(spec: SimSpec, device=None) -> torch.Tensor:
    """Primary-grouping cluster id per row, (max_n,) int32."""
    rows = torch.arange(spec.max_n, dtype=torch.int32, device=device)
    c = spec.cluster
    if c is None:
        return torch.zeros_like(rows)
    s = max(c.sizing_value, 1)
    return rows % s if c.sizing_mode == "fixed_clusters" else rows // s


def re_chol_intercept(tau0_sq: float) -> float:
    """chol(D + 1e-12 I) for the intercept-only D = tau^2, in f32 as the
    reference's ``_re_chol`` computes it (a 1x1 Cholesky is the square
    root)."""
    f32 = np.float32
    tau = np.sqrt(np.maximum(f32(tau0_sq), f32(0.0)))
    d = tau * f32(1.0) * tau
    return float(np.sqrt(d + f32(1e-12)))


# ---------------------------------------------------------------------------
# Main entry
# ---------------------------------------------------------------------------


def generate_from_normals(spec: SimSpec, arr: Dict[str, torch.Tensor], Z: torch.Tensor):
    """``(X, y, ids)`` from the filled normals ``Z (sims, n_streams, rows)``
    laid out as :func:`stream_plan` says."""
    max_n = spec.max_n
    sims = Z.shape[0]
    device = Z.device
    cols = [torch.ones((sims, max_n), dtype=torch.float32, device=device)]
    if spec.n_cont > 0:
        z = Z[:, : spec.n_cont, :max_n].transpose(1, 2)  # (sims, max_n, n_cont)
        L = arr["corr_chol"].to(device=device, dtype=torch.float32)
        mixed = torch.matmul(z, L.T)  # f32; TF32 is off (package __init__)
        params = np.asarray(arr["var_params"].cpu(), np.float32)
        for j in range(spec.n_cont):
            cols.append(
                marginals.apply_marginal_static(mixed[:, :, j], spec.var_types[j], params[j])
            )
    for comps in spec.interactions:
        prod = cols[comps[0]]
        for cidx in comps[1:]:
            prod = prod * cols[cidx]
        cols.append(prod)
    X = torch.stack(cols, dim=-1)  # (sims, max_n, P)

    beta = arr["effects"].to(device=device, dtype=torch.float32)
    lp = torch.matmul(X, beta)  # (sims, max_n)

    ids = cluster_ids(spec, device)
    s_resid = Z.shape[1] - 1
    if spec.cluster is not None:
        m = spec.cluster.n_clusters_at(max_n)
        u = Z[:, spec.n_cont, :m] * re_chol_intercept(spec.cluster.tau_squared)
        eta = lp + u[:, ids.long()]
    else:
        eta = lp
    y = eta + Z[:, s_resid, :max_n]
    return X, y, ids.unsqueeze(0).expand(sims, max_n)


def to_device(arrays: Dict, device) -> Dict[str, torch.Tensor]:
    """The lowered numpy arrays as tensors on ``device`` (dtypes kept)."""
    return {k: torch.as_tensor(np.asarray(v), device=device) for k, v in arrays.items()}


def generate_batch(spec: SimSpec, arr: Dict[str, torch.Tensor], seed_lo: int, seed_hi: int,
                   sim_ids: torch.Tensor, *, plain: bool = False):
    """``X (sims, max_n, P) f32``, ``y (sims, max_n) f32``, ``ids (sims,
    max_n) int32`` for the sims ``sim_ids`` (int64, on the run's device).

    ``plain=True`` fills through the plain PyTorch Philox on any device
    (used to time and check kernel K1 against it).
    """
    check_supported(spec)
    fill = rng.fill_streams_plain if plain else rng.fill_streams
    Z = fill(seed_lo, seed_hi, sim_ids, stream_plan(spec), rng.MODE_NORMAL)
    return generate_from_normals(spec, arr, Z)
