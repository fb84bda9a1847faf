"""Batched dataset synthesis: the generation half of the main path.

The port of ``mcpower_tpu.engine.datagen.generate`` for the designs of this
slice, with the sim axis written out: one call builds ``X (sims, max_n, P)
f32``, ``y (sims, max_n) f32`` and the cluster ids for a batch of sims.

Every draw comes from batched Philox fills (``rng.fill_streams``, kernel K1
on the card) over the streams :func:`stream_plan` and :func:`outcome_plan`
list, at the reference's addresses, so ``X[:, :N]`` is a nested prefix
across the grid (common random numbers) and a value never depends on the
batch.

The stages follow the reference in order: the static design draw (``L =
corr_chol``), the f32 mix ``z @ L.T``, the normal/binary marginals, the
reference-coded factor dummies (fixed allocation codes, or levels drawn from
the FACTOR words of a sampled factor), the interaction block, ``eta = X @
beta``, the primary random intercept (``u = z_c * chol(tau^2 + 1e-12)``
indexed by cluster id) and the outcome:
a normal residual, a binary draw (logit: a top-24-bit uniform of the RESID
words against ``sigmoid(eta)``; probit: the RESID normal against ``eta``)
or a Poisson count (the open uniform of the RESID words through
:func:`poisson_quantile`, kernel K8 on the card). The reference also fills
``df`` chi-square planes for the other residual families and discards them
in a select; for a statically normal residual the port skips them, which
leaves every value unchanged.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import kernels, marginals, rng
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
        if spec.estimator != "glm":
            return f"estimator {spec.estimator!r} with a {spec.outcome} outcome"
        if spec.outcome not in ("binary", "count"):
            return f"a GLM of a {spec.outcome} outcome"
    elif spec.estimator not in ("ols", "mle"):
        return f"estimator {spec.estimator!r}"
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
    # the widths the kernels take: K1's stream table and the fits' p
    if n_streams(spec) > rng.MAX_STREAMS:
        return f"more than {rng.MAX_STREAMS} generated streams (ROADMAP A10)"
    if len(spec.effective_fit_cols) > kernels.MAX_FIT_P:
        return f"wide fits, p > {kernels.MAX_FIT_P} (ROADMAP B10)"
    return ""


def check_supported(spec: SimSpec) -> None:
    reason = unsupported(spec)
    if reason:
        raise NotImplementedError(f"not ported yet: {reason}")


# ---------------------------------------------------------------------------
# Draw plan and small host pieces
# ---------------------------------------------------------------------------


def _resid_mode(spec: SimSpec):
    """The fill mode of the RESID stream of a logit (words) or count (open
    uniforms) outcome; None when the outcome reads the residual normals."""
    if spec.outcome == "binary" and spec.link != "probit":
        return rng.MODE_WORDS
    if spec.outcome == "count":
        return rng.MODE_OPEN_UNIFORM
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
    """``(class, column, rows)`` of every stream the generation reads as
    normals: the latent predictor normals, the primary-intercept draws
    (column 0 of CLUSTER) and, for a continuous or probit outcome, the
    residual normals (column 0 of RESID)."""
    plan = [(rng.CLASS_XNORM, j, spec.max_n) for j in range(spec.n_cont)]
    if spec.cluster is not None:
        plan.append((rng.CLASS_CLUSTER, 0, spec.cluster.n_clusters_at(spec.max_n)))
    if _resid_mode(spec) is None:
        plan.append((rng.CLASS_RESID, 0, spec.max_n))
    return plan


def outcome_plan(spec: SimSpec):
    """``(mode, streams)`` of the second fill (K1 fills one mode per
    launch): the RESID stream of a logit outcome (words, of which the draw
    takes the top 24 bits) or a count outcome (open uniforms), then column
    f of FACTOR for each sampled factor f (words, whose top 24 bits are its
    uniforms). With factor words a count outcome's RESID stream is filled as
    words too and turned into the same open uniforms after. None when the
    generation reads nothing but the normals of :func:`stream_plan`."""
    mode = _resid_mode(spec)
    streams = [(rng.CLASS_RESID, 0, spec.max_n)] if mode is not None else []
    factors = [(rng.CLASS_FACTOR, f, spec.max_n) for f in sampled_factors(spec)]
    if not streams + factors:
        return None
    return (rng.MODE_WORDS if factors else mode), streams + factors


def n_streams(spec: SimSpec) -> int:
    """Streams the generation fills, over both fills."""
    second = outcome_plan(spec)
    return len(stream_plan(spec)) + (len(second[1]) if second is not None else 0)


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


def generate_from_normals(spec: SimSpec, arr: Dict[str, torch.Tensor], Z: torch.Tensor,
                          second: torch.Tensor = None, *, plain: bool = False):
    """``(X, y, ids)`` from the filled normals ``Z (sims, n_streams, rows)``
    laid out as :func:`stream_plan` says and the second fill ``second
    (sims, streams, max_n)`` laid out as :func:`outcome_plan` says (the
    RESID words or open uniforms of a logit or count outcome, then the
    FACTOR words of the sampled factors). ``plain=True`` draws counts
    through the plain version of K8 on any device."""
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
    plan2 = outcome_plan(spec)
    first = int(_resid_mode(spec) is not None)  # the factor words follow any RESID stream
    words_at = {f: first + i for i, f in enumerate(sampled_factors(spec))}
    for f, n_levels in enumerate(spec.factor_levels):  # reference-coded dummies
        words = second[:, words_at[f]] if f in words_at else None
        lvl = _factor_levels(spec, arr, f, words, sims, device)
        for d in range(n_levels - 1):
            cols.append((lvl == d + 1).to(torch.float32))
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
    one, zero = torch.ones_like(eta), torch.zeros_like(eta)
    if spec.outcome == "continuous":
        y = eta + Z[:, s_resid, :max_n]
    elif spec.outcome == "binary" and spec.link == "probit":
        y = torch.where(Z[:, s_resid, :max_n] < eta, one, zero)
    elif spec.outcome == "binary":
        y = torch.where(rng.u32_to_uniform(second[:, 0]) < torch.sigmoid(eta), one, zero)
    else:  # count
        u = second[:, 0]
        if plan2[0] == rng.MODE_WORDS:  # filled with factor words: the same open uniforms
            u = rng.u32_to_open_uniform(u)
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
    Z = fill(seed_lo, seed_hi, sim_ids, stream_plan(spec), rng.MODE_NORMAL)
    plan2 = outcome_plan(spec)
    second = fill(seed_lo, seed_hi, sim_ids, plan2[1], plan2[0]) if plan2 is not None else None
    return generate_from_normals(spec, arr, Z, second, plain=plain)
