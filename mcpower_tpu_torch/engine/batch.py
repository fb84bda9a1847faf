"""Batch driver: generation, fit, thresholds and on-device count reduction.

The port of ``mcpower_tpu.engine.batch`` for this slice. Where the reference
vmaps ``run_one_sim`` over sims inside one jitted program, :func:`run_sims`
runs each stage once over a chunk of sims with the sim axis written out:
the Philox fills (K1: the long normals; a words or uniforms fill for a
logit or count outcome, whose counts go through K8, a uniform residual and
sampled factor levels; a scenario's short SCENARIO and HET streams), the
scenario's per-sim design, the design and outcome, the fit (K2 + K3 for
OLS, K2 + K4 for the random-intercept LMM, K2's joint mode + K11 for the
LMM with extra groupings, K6
for an unclustered GLM, with a second K6 launch for the separation fallback
of a design with factors, K7 for the random-intercept GLMM, K10 for the GLMM
with random slopes, K12 for the GLMM with extra groupings), t^2 thresholds
and corrections (with the
reduced-df crit rows of cells whose sparse factor levels were excluded),
posthoc contrasts, and the reduction of per-sim flags to int32 counts before
they leave the device.
Results depend only on sim ids, never on chunking or the device.

Specs outside the slice raise ``NotImplementedError`` naming the ROADMAP
item that will port them; nothing quietly computes something else.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import corrections, datagen, glmfit, glmmfit, mixedfit, olsfit
from .spec import SimSpec, factor_dependent_cols


def _split_seed(base_seed: int) -> Tuple[int, int]:
    base_seed = int(base_seed) & 0xFFFFFFFFFFFFFFFF
    return base_seed & 0xFFFFFFFF, base_seed >> 32


def _exclusion_colmask(spec: SimSpec, excluded: torch.Tensor):
    """The fit-column mask ``(sims, G, pf)`` f64 (0 drops a column) and the
    dropped-column count ``(sims, G)`` int32 from the per-cell exclusion
    flags ``excluded (sims, G, n_factors)``: an excluded factor drops its
    dummies and every interaction touching them (the reference's
    ``_exclusion_colmask``, :36)."""
    fit_cols = spec.effective_fit_cols
    mask = torch.ones(excluded.shape[:2] + (len(fit_cols),), dtype=torch.float64,
                      device=excluded.device)
    for f in range(spec.n_factors):
        dep_cols = factor_dependent_cols(spec, f)
        dep = [i for i, c in enumerate(fit_cols) if c in dep_cols]
        if dep:
            keep = 1.0 - excluded[..., f].to(torch.float64)
            mask[..., dep] = mask[..., dep] * keep[..., None]
    dropped = torch.round(len(fit_cols) - mask.sum(-1)).to(torch.int32)
    return mask, dropped


def _crit_rows(arr: Dict[str, torch.Tensor], key2d: str, key3d: str,
               dropped: torch.Tensor) -> torch.Tensor:
    """The crit row of each cell: from a reduced-df stack ``(G, D + 1, ...)``
    the layer of the cell's dropped-column count (clipped to the stack),
    ``(sims, G, ...)``; without one the flat ``(G, ...)`` table, whose z- and
    chi^2-based crits do not depend on the fitted columns (the reference's
    ``_crit_rows``, :53)."""
    if key3d not in arr:
        return arr[key2d]
    table = arr[key3d]
    d = dropped.clamp(0, table.shape[1] - 1).long()
    return table[torch.arange(table.shape[0], device=d.device), d]


def run_sims(spec: SimSpec, arr: Dict[str, torch.Tensor], seed_lo: int, seed_hi: int,
             sim_ids: torch.Tensor, *, plain: bool = False) -> Dict[str, torch.Tensor]:
    """Per-sim significance flags across the grid for the sims ``sim_ids``:
    the reference's ``run_one_sim`` batched over sims, in its order (the
    sparse-factor exclusion before the fits, the reduced-df crit rows after
    them). Returns tensors with a leading sim axis.
    """
    X, y, _ = datagen.generate_batch(spec, arr, seed_lo, seed_hi, sim_ids, plain=plain)
    excluded = colmask = min_counts = None
    dropped = torch.zeros((), dtype=torch.int32, device=X.device)
    if spec.n_factors:
        min_counts = datagen.factor_min_counts(spec, X)  # (sims, G, n_factors)
        excluded = min_counts < spec.factor_min_level_count
        colmask, dropped = _exclusion_colmask(spec, excluded)

    # The clustered fits take no column mask, as the reference's (batch.py:101-125):
    # exclusion moves only their crit rows, through `dropped`.
    if spec.estimator == "ols":
        stats = olsfit.ols_grid_stats(spec, X, y, colmask=colmask, plain=plain)
    elif spec.cluster is not None and spec.outcome != "continuous":  # "glm" or "mle": a GLMM
        stats = glmmfit.glmm_grid_stats(spec, arr, X, y, plain=plain)
    elif spec.estimator == "glm":  # unclustered: generate_batch has checked the scope
        stats = glmfit.glm_grid_stats(spec, arr, X, y, colmask=colmask, min_counts=min_counts,
                                      plain=plain)
    else:  # "mle" with a cluster and a continuous outcome
        stats = mixedfit.mixed_grid_stats(spec, X, y, plain=plain)

    t2 = stats["t2"]  # (sims, G, k)
    converged = stats["converged"]  # (sims, G)
    unc = _crit_rows(arr, "t2_uncorrected", "t2_unc_by_dropped", dropped)
    corr = _crit_rows(arr, "t2_corrected_ranks", "t2_corr_by_dropped", dropped)
    sig_unc = (t2 > unc) & converged[..., None]
    sig_corr = corrections.apply_correction(t2, corr.expand_as(t2), spec.correction) \
        & converged[..., None]
    out = {"sig_unc": sig_unc, "sig_corr": sig_corr, "converged": converged, "t2": t2}
    if spec.report_overall:
        crit = _crit_rows(arr, "overall_crit", "overall_crit_by_dropped", dropped)
        out["overall"] = (stats["overall"] > crit) & converged

    k = spec.n_targets
    if k > 0:
        nsig_unc = sig_unc.sum(-1)
        nsig_corr = sig_corr.sum(-1)
        out["joint_unc"] = nsig_unc == k
        out["joint_corr"] = nsig_corr == k
        levels = torch.arange(k + 1, device=t2.device)
        out["nsig_hist_unc"] = nsig_unc[..., None] == levels
        out["nsig_hist_corr"] = nsig_corr[..., None] == levels

    if spec.posthoc and "posthoc_t2" in stats:
        crit = _crit_rows(arr, "posthoc_t2", "posthoc_t2_by_dropped", dropped)
        out["posthoc_sig"] = (stats["posthoc_t2"] > crit) & converged[..., None]

    for extra in ("boundary_hit", "boundary_hi", "singular", "tau2_hat", "glm_baseline",
                  "separation_fallback", "pinned_comp"):
        if extra in stats:
            out[extra] = stats[extra]
    # tau2 counts only for converged fits (the host divides by that count)
    if "tau2_hat" in out:
        out["tau2_hat"] = torch.where(converged, out["tau2_hat"], torch.zeros_like(out["tau2_hat"]))
    if excluded is not None:
        out["factor_excluded"] = excluded
    return out


def _reduce_counts(per_sim: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Booleans -> int32 sums over the sim axis; floats -> f64 sums of the
    finite values (the host divides by n)."""
    counts = {}
    for name, v in per_sim.items():
        if name == "t2":
            continue
        if v.dtype == torch.bool:
            counts[name] = v.sum(0, dtype=torch.int32)
        else:
            v = v.to(torch.float64)
            counts[name] = torch.where(torch.isfinite(v), v, torch.zeros_like(v)).sum(0)
    return counts


# The joint statistics of extra groupings are the largest tensor of a chunk:
# ztz (chunk, G, M, M) f64, 465 MB at M = 65, G = 11 and 1,250 sims. The
# reference caps such a chunk at 1,024 or 4,096 sims, a TPU runtime limit
# (batch.py:304-335); the port sizes it by memory instead: ztz may take at
# most JOINT_MEMORY_SHARE of the card's memory (JOINT_CPU_BYTES on the CPU).
# A GLMM with extra groupings builds no ztz: its largest allocation is kernel
# K12's device scratch, a cell's four warps' areas (Z'WZ, the right-hand
# sides, the kept row quantities, the capacitance's work area; 347 KB a cell
# at M = 58, p = 2, N = 480), sized by K12's C entry point, so the same share
# bounds chunk x G cells of it; on the CPU the plain version's Z'WZ of the
# four candidates a cell (of the Hessian's stencil points, where more), in
# f64, within JOINT_CPU_BYTES.
JOINT_MEMORY_SHARE = 1 / 8
JOINT_CPU_BYTES = 1 << 30


def joint_chunk_cap(spec: SimSpec, device) -> Optional[int]:
    """The most sims a chunk of an extra-grouping spec holds, or None."""
    if spec.cluster is None or not spec.cluster.extra_groupings:
        return None
    plan = mixedfit.grouping_plan(spec)
    M = mixedfit.joint_width(plan)
    device = torch.device(device)
    if device.type == "cuda":
        budget = torch.cuda.get_device_properties(device).total_memory * JOINT_MEMORY_SHARE
    else:
        budget = JOINT_CPU_BYTES
    if spec.outcome == "continuous":
        per_cell = M * M * 8
    else:  # the GLMM: K12's scratch, or the plain version's Z'WZ
        pf = len(spec.effective_fit_cols)
        hessian = spec.wald_se == "hessian"
        if device.type == "cuda":
            per_cell = glmmfit.glmm_extras_scratch_bytes(
                1, M, plan[0][0] * plan[0][1], pf, spec.max_n, mixedfit.plan_all_q1(plan),
                hessian)
        else:
            lanes = max(4, len(glmmfit.hessian_offsets(pf))) if hessian else 4
            per_cell = lanes * M * M * 8
    return max(int(budget // (spec.n_grid * per_cell)), 1)


def run_batch(
    spec: SimSpec,
    arrays: Dict,
    n_sims: int,
    base_seed: int,
    *,
    sim_id_offset: int = 0,
    chunk_size: Optional[int] = None,
    progress: Optional[Callable[[int, int], None]] = None,
    cancel: Optional[Callable[[], bool]] = None,
    device="cuda",
    plain: bool = False,
) -> Dict[str, np.ndarray]:
    """Run ``n_sims`` simulations on ``device`` and return host count arrays.

    The default is the CUDA card; with none present the call raises rather
    than run elsewhere. ``device="cpu"`` runs the plain PyTorch versions.

    ``arrays`` is the dict ``lower.lower`` returns (numpy, or tensors).
    ``progress(done, total)`` is called between chunks; ``cancel()``
    returning True stops between chunks, and ``counts['n_done']`` records
    how many sims completed. ``plain=True`` runs every stage through its
    plain PyTorch version on any device, to time and check the kernels.
    """
    spec.validate_layout()
    datagen.check_supported(spec)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"run_batch: device={str(device)!r} but no CUDA device is available")
    arr = datagen.to_device(arrays, device)
    seed_lo, seed_hi = _split_seed(base_seed)

    chunk = int(chunk_size) if chunk_size else max(min(n_sims, 4096), 1)
    cap = joint_chunk_cap(spec, device)
    if cap is not None and cap < chunk:
        if chunk_size:
            import warnings

            warnings.warn(f"extra-grouping spec: chunk capped at {cap} sims by memory "
                          f"(requested {chunk})", UserWarning, stacklevel=2)
        chunk = cap
    totals: Dict[str, np.ndarray] = {}
    done = 0
    while done < n_sims:
        m = min(chunk, n_sims - done)
        sim_ids = torch.arange(
            sim_id_offset + done, sim_id_offset + done + m, dtype=torch.int64, device=device
        ) & 0xFFFFFFFF  # sim ids are uint32 in the reference
        counts = _reduce_counts(run_sims(spec, arr, seed_lo, seed_hi, sim_ids, plain=plain))
        for name, v in counts.items():
            totals[name] = totals.get(name, 0) + v.cpu().numpy()
        done += m
        if progress is not None:
            progress(done, n_sims)
        if cancel is not None and cancel():
            break
    totals["n_done"] = np.asarray(done)
    return totals
