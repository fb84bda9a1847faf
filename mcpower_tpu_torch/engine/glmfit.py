"""Batched GLM IRLS: logit / probit / Poisson-log, Wald z tests, LRT omnibus.

The port of ``mcpower_tpu.engine.glmfit`` for unclustered GLMs. Every (sim,
grid) cell fits its own IRLS on the rows below its grid point, in the
reference's two phases: ``N_IRLS_ITERS`` steps with f32 state, then
``N_IRLS_POLISH`` f64 Newton steps, the beta cap, freezing on ``done | ~ok``,
the unridged rank probe and ``converged = done & finite & ~at_cap &
rank_ok``. Kernel K6 (``csrc/glm_irls.cu``) runs the fits on the card;
:func:`glm_irls_plain` beside it is its PyTorch version.

Sums over rows follow the kernel's order rather than the reference's
reduction (``smallchol.lane_sum``, ``rowmv``, ``crossprod``). Both then
perform the same operations in the same order and agree bit for bit on the
card; against the reference the f32 phase differs by its rounding and the
f64 polish removes that difference. K6 combines its lanes by a
recursive-halving reduce-scatter in ``lane_sum``'s pair tree, masks the f32
phase's columns in f32 and computes the final X'WX, deviance and null
deviance in one pass (one log per binomial row, the null model's logs once
per cell); each gives the bits of the plain form here
(tests/test_torch_irls_order.py).

Each cell carries its own column mask: a sparse-factor exclusion fits the
cell's reduced model with the excluded columns pinned at 0. For a design with
factors, the cells whose fit did not converge (separation being the usual
cause for logit) are refit once, cold, without the sparsest factor's columns:
the reference's separation fallback (:258-278), a second K6 launch over those
cells alone. Its fits replace the primary's where they converge, which gives
the totals of the reference's fused program bit for bit: its separation gate
(batch.py:229-276) only decides which sims pay for the second fit.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch

from . import kernels, rng, smallchol, waldstats
from .spec import SimSpec

N_IRLS_ITERS = 30
N_IRLS_POLISH = 4
BETA_CAP = 30.0
CONV_TOL = 1e-8
CONV_TOL_F32 = 1e-5
MU_EPS = 1e-10
EPS_RANK = smallchol.EPS_RANK
MAX_P = kernels.MAX_FIT_P

# Outcome and link of a launch, as K6 takes them.
LINK_LOGIT, LINK_PROBIT, LINK_POISSON = 0, 1, 2


def link_code(outcome: str, link: str) -> int:
    if outcome == "binary":
        return LINK_PROBIT if link == "probit" else LINK_LOGIT
    if outcome == "count":
        return LINK_POISSON
    raise ValueError(f"GLM does not support outcome {outcome!r}")


def _mu_var_dmu(code: int, eta: torch.Tensor):
    """Mean, variance and d mu / d eta in eta's dtype (the reference's
    ``_link_funcs``, :44). The logistic is 1 / (1 + exp(-eta)), as K6
    computes it."""
    if code == LINK_PROBIT:
        mu = torch.clamp(rng.norm_cdf(eta), MU_EPS, 1.0 - MU_EPS)
        var = mu * (1.0 - mu)
        dmu = torch.exp(-0.5 * eta * eta) * 0.3989422804014327
        return mu, var, torch.clamp(dmu, min=MU_EPS)
    if code == LINK_LOGIT:
        mu = torch.clamp(1.0 / (1.0 + torch.exp(-eta)), MU_EPS, 1.0 - MU_EPS)
        var = mu * (1.0 - mu)
        return mu, var, var
    mu = torch.clamp(torch.exp(torch.clamp(eta, -30.0, 30.0)), min=MU_EPS)
    return mu, mu, mu


def _deviance_terms(code: int, y: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Per-row deviance terms (the reference's ``_deviance``, :72, before
    the sum and the factor 2)."""
    zero = torch.zeros_like(mu)
    if code != LINK_POISSON:
        t1 = torch.where(y > 0.5, -torch.log(mu), zero)
        t2 = torch.where(y < 0.5, -torch.log(1.0 - mu), zero)
        return t1 + t2
    ylogy = torch.where(y > 0, y * torch.log(torch.clamp(y, min=MU_EPS)), zero)
    return ylogy - y * torch.log(mu) - (y - mu)


def _irls_phase(code, X, y, mask, beta, ridge_diag, tol, n_iter):
    """``n_iter`` IRLS steps in X's dtype from ``beta``, freezing a cell on
    ``done | ~ok`` (the reference's ``make_body``, :111-127). Returns
    (beta, done, steps), ``steps`` the iterations up to and including the
    one after which the cell's state no longer changes (K6 stops there)."""
    done = torch.zeros(beta.shape[:-1], dtype=torch.bool, device=beta.device)
    bad = torch.zeros_like(done)  # a non-finite step froze the cell
    steps = torch.zeros(beta.shape[:-1], dtype=torch.int32, device=beta.device)
    for _ in range(n_iter):
        if bool((done | bad).all()):  # every cell frozen: the rest change nothing
            break
        steps = steps + (~(done | bad)).to(torch.int32)
        eta = smallchol.rowmv(X, beta)
        mu, var, dmu = _mu_var_dmu(code, eta)
        w = (dmu * dmu / torch.clamp(var, min=MU_EPS)) * mask
        z = eta + (y - mu) / dmu
        wz = w * z
        A = smallchol.crossprod(X, w) + torch.diag_embed(ridge_diag.expand(beta.shape))
        b = torch.stack([smallchol.lane_sum(X[..., i] * wz) for i in range(X.shape[-1])], dim=-1)
        beta_new = smallchol.cho_solve(smallchol.chol(A), b)
        beta_new = torch.clamp(beta_new, -BETA_CAP, BETA_CAP)
        ok = torch.isfinite(beta_new).all(-1)
        step = (beta_new - beta).abs().amax(-1)
        bad = bad | (~ok & ~done)
        beta = torch.where((done | ~ok)[..., None], beta, beta_new)
        done = done | (step < tol)
    return beta, done, steps


def _irls_cells(code, X64, y64, mask64, beta0, pin):
    """One grid point's cells: ``X64 (cells, rows, pf)`` f64 with pinned
    columns zeroed and rows padded to a multiple of smallchol.LANES (padding has mask
    0), ``y64``/``mask64 (cells, rows)``, ``beta0 (cells, pf)`` f64, ``pin
    (cells, pf)``. Returns beta, cov, converged, dev and the iterations of
    each phase."""
    ridge64 = 1e-10 + pin
    ridge32 = ridge64.to(torch.float32) + torch.tensor(1e-6, dtype=torch.float32)
    beta32, _, it32 = _irls_phase(
        code, X64.to(torch.float32), y64.to(torch.float32), mask64.to(torch.float32),
        beta0.to(torch.float32), ridge32.to(X64.device), CONV_TOL_F32, N_IRLS_ITERS)
    beta, done, it64 = _irls_phase(
        code, X64, y64, mask64, beta32.to(torch.float64), ridge64.to(X64.device), CONV_TOL,
        N_IRLS_POLISH)

    eta = smallchol.rowmv(X64, beta)
    mu, var, dmu = _mu_var_dmu(code, eta)
    w = (dmu * dmu / torch.clamp(var, min=MU_EPS)) * mask64
    raw = smallchol.crossprod(X64, w)
    cov = smallchol.cho_inverse(smallchol.chol(raw + torch.diag_embed(ridge64)))
    dev = 2.0 * smallchol.lane_sum(_deviance_terms(code, y64, mu) * mask64)
    at_cap = (beta.abs() >= BETA_CAP - 1e-6).any(-1)
    d = torch.diagonal(smallchol.chol(raw + torch.diag_embed(pin)), dim1=-2, dim2=-1)
    rank_ok = torch.isfinite(d).all(-1) & (d.amin(-1) >= EPS_RANK * d.amax(-1))
    converged = done & torch.isfinite(beta).all(-1) & ~at_cap & rank_ok
    return beta, cov, converged, dev, torch.stack([it32, it64], dim=-1)


def _padded_rows(n: int) -> int:
    return -(-n // smallchol.LANES) * smallchol.LANES


def _cell_masks(colmask: torch.Tensor, sims: int, G: int, pf: int) -> torch.Tensor:
    """A ``(G, pf)`` mask shared by every sim, or each cell's ``(sims, G,
    pf)``, as ``(sims, G, pf)`` f64."""
    if colmask.dim() == 2:
        colmask = colmask.expand(sims, G, pf)
    if colmask.shape != (sims, G, pf):
        raise ValueError(f"glm_irls: colmask {tuple(colmask.shape)} for (sims, G, p) = "
                         f"{(sims, G, pf)}")
    return colmask.to(torch.float64)


def glm_irls_plain(code: int, X: torch.Tensor, y: torch.Tensor, fit: Sequence[int],
                   grid: Sequence[int], beta0: torch.Tensor, colmask: torch.Tensor,
                   iters: bool = False, active: torch.Tensor = None):
    """Every (sim, grid) cell's IRLS. ``X (sims, max_n, P)`` and ``y (sims,
    max_n)`` f32; ``fit`` the pf fit columns of X; ``grid`` G ascending row
    counts; ``beta0 (sims, G, pf)`` f64 start; ``colmask`` f64 0/1 (0 pins
    a column at 0), each cell's ``(sims, G, pf)`` or ``(G, pf)`` for every
    sim; ``active (sims, G)`` bool, or None for every cell: the cells to
    fit, the others' outputs are 0.

    Returns f64 ``beta (sims, G, pf)``, ``cov (sims, G, pf, pf)``, bool
    ``converged (sims, G)``, f64 ``dev``, ``dev0`` (the intercept-only
    deviance) and ``ybar (sims, G)``; with ``iters`` also the int32
    iterations each cell ran in each phase, ``(sims, G, 2)``.
    """
    sims, pf, G = X.shape[0], len(fit), len(grid)
    Xf = X[..., list(fit)].to(torch.float64)
    yf = y.to(torch.float64)
    colmask = _cell_masks(colmask.to(X.device), sims, G, pf)
    kw = dict(dtype=torch.float64, device=X.device)
    out = [torch.zeros((sims, G, pf), **kw), torch.zeros((sims, G, pf, pf), **kw),
           torch.zeros((sims, G), dtype=torch.bool, device=X.device),
           torch.zeros((sims, G), **kw), torch.zeros((sims, G), **kw),
           torch.zeros((sims, G), **kw),
           torch.zeros((sims, G, 2), dtype=torch.int32, device=X.device)]
    for g, n in enumerate(grid):
        cells = torch.arange(sims, device=X.device) if active is None else \
            active[:, g].nonzero().reshape(-1)
        if cells.numel() == 0:
            continue
        rows = _padded_rows(n)
        cm = colmask[cells, g]
        Xg = torch.nn.functional.pad(Xf[cells, :n] * cm[:, None, :], (0, 0, 0, rows - n))
        yg = torch.nn.functional.pad(yf[cells, :n], (0, rows - n))
        mask = torch.nn.functional.pad(torch.ones_like(yf[cells, :n]), (0, rows - n))
        beta, cov, conv, dev, it = _irls_cells(code, Xg, yg, mask, beta0[cells, g], 1.0 - cm)
        ysum = smallchol.lane_sum(yg)
        # a tensor divisor: torch divides by a Python number through its
        # reciprocal, K6 (and the reference) by IEEE division
        ybar = ysum / torch.full_like(ysum, float(n))
        mu0 = torch.clamp(ybar, min=MU_EPS)
        if code != LINK_POISSON:
            mu0 = torch.clamp(mu0, max=1.0 - MU_EPS)
        dev0 = 2.0 * smallchol.lane_sum(_deviance_terms(code, yg, mu0[:, None].expand_as(yg)) * mask)
        for o, v in zip(out, (beta, cov, conv, dev, dev0, ybar, it)):
            o[cells, g] = v
    res = tuple(out[:6])
    return res + (out[6],) if iters else res


_IRLS_ARGS = [
    ctypes.c_void_p,  # X (sims, max_n, P) f32
    ctypes.c_void_p,  # y (sims, max_n) f32
    ctypes.c_int,  # sims
    ctypes.c_int,  # max_n
    ctypes.c_int,  # P
    ctypes.POINTER(ctypes.c_int),  # fit columns (host)
    ctypes.c_int,  # pf
    ctypes.c_void_p,  # grid (G,) int32, device
    ctypes.c_int,  # G
    ctypes.c_void_p,  # beta0 (sims, G, pf) f64
    ctypes.c_void_p,  # colmask (sims, G, pf) f64
    ctypes.c_void_p,  # active (sims, G) uint8, or null for every cell
    ctypes.c_int,  # link code
    ctypes.c_void_p,  # beta out (sims, G, pf) f64
    ctypes.c_void_p,  # cov out (sims, G, pf, pf) f64
    ctypes.c_void_p,  # converged out (sims, G) uint8
    ctypes.c_void_p,  # dev out (sims, G) f64
    ctypes.c_void_p,  # dev0 out (sims, G) f64
    ctypes.c_void_p,  # ybar out (sims, G) f64
    ctypes.c_void_p,  # iterations out (sims, G, 2) int32, or null
    ctypes.c_void_p,  # cudaStream_t
]


def glm_irls_kernel(code: int, X: torch.Tensor, y: torch.Tensor, fit: Sequence[int],
                    grid: Sequence[int], beta0: torch.Tensor, colmask: torch.Tensor,
                    iters: bool = False, active: torch.Tensor = None):
    """Kernel K6: :func:`glm_irls_plain` on the card, one warp per cell; with
    ``active``, the cells outside it leave the launch at once and their
    outputs are 0."""
    fit, grid = [int(c) for c in fit], [int(n) for n in grid]
    pf, G = len(fit), len(grid)
    if not 1 <= pf <= MAX_P:
        raise ValueError(f"glm_irls kernel takes 1 <= p <= {MAX_P}, got {pf}")
    if X.dtype != torch.float32 or y.dtype != torch.float32:
        raise ValueError("glm_irls kernel takes f32 X and y")
    sims, max_n, P = X.shape
    if y.shape != (sims, max_n) or beta0.shape != (sims, G, pf):
        raise ValueError(f"glm_irls: X {tuple(X.shape)}, y {tuple(y.shape)}, beta0 "
                         f"{tuple(beta0.shape)} for G {G}, p {pf}")
    if active is not None and active.shape != (sims, G):
        raise ValueError(f"glm_irls: active {tuple(active.shape)} for (sims, G) = {(sims, G)}")
    if G == 0 or any(not 0 < n <= max_n for n in grid):
        raise ValueError(f"glm_irls: grid {grid} outside 1..{max_n}")
    if any(not 0 <= c < P for c in fit):
        raise ValueError(f"glm_irls: fit columns {fit} outside 0..{P - 1}")
    dev_ = X.device
    X, y = X.contiguous(), y.contiguous()
    beta0 = beta0.to(torch.float64).contiguous()
    colmask = _cell_masks(colmask.to(dev_), sims, G, pf).contiguous()
    grid_t = torch.tensor(grid, dtype=torch.int32, device=dev_)
    kw = dict(dtype=torch.float64, device=dev_)
    new = torch.empty if active is None else torch.zeros  # idle cells write nothing
    beta = new((sims, G, pf), **kw)
    cov = new((sims, G, pf, pf), **kw)
    conv = new((sims, G), dtype=torch.uint8, device=dev_)
    dev, dev0, ybar = (new((sims, G), **kw) for _ in range(3))
    it = new((sims, G, 2), dtype=torch.int32, device=dev_) if iters else None
    act = active.to(device=dev_, dtype=torch.uint8).contiguous() if active is not None else None
    kernels.require_cuda("glm_irls", X, y, grid_t, beta0, colmask, beta, cov, conv, dev, dev0, ybar,
                         *([act] if act is not None else []))
    if sims:
        k = kernels.KERNELS["glm_irls"]
        fn = k.fn("mcp_glm_irls", _IRLS_ARGS)
        k.check(fn(
            kernels.ptr(X), kernels.ptr(y), sims, max_n, P, (ctypes.c_int * pf)(*fit), pf,
            kernels.ptr(grid_t), G, kernels.ptr(beta0), kernels.ptr(colmask),
            kernels.ptr(act) if act is not None else ctypes.c_void_p(0), code,
            kernels.ptr(beta), kernels.ptr(cov), kernels.ptr(conv), kernels.ptr(dev),
            kernels.ptr(dev0), kernels.ptr(ybar),
            kernels.ptr(it) if iters else ctypes.c_void_p(0), kernels.stream_of(X)),
            tag="fallback" if active is not None else None)
    res = (beta, cov, conv.bool(), dev, dev0, ybar)
    return res + (it,) if iters else res


def glm_irls(code, X, y, fit, grid, beta0, colmask, iters: bool = False, active=None):
    """K6 for CUDA tensors, the plain version for CPU tensors."""
    if X.is_cuda:
        return glm_irls_kernel(code, X, y, fit, grid, beta0, colmask, iters, active)
    if X.device.type != "cpu":
        raise ValueError(f"glm_irls: no kernel for device {X.device}")
    return glm_irls_plain(code, X, y, fit, grid, beta0, colmask, iters, active)


def data_intercept(outcome: str, link: str, ybar: torch.Tensor) -> torch.Tensor:
    """Cold-start intercept on the link scale from the realized outcome
    mean (the reference's ``data_intercept``, :171)."""
    if outcome == "binary":
        ybar = torch.clamp(ybar, 1e-6, 1 - 1e-6)
        icpt = torch.log(ybar / (1 - ybar))
        return icpt / 1.6 if link == "probit" else icpt
    return torch.log(torch.clamp(ybar, min=1e-6))


def _data_intercepts(spec: SimSpec, y: torch.Tensor) -> torch.Tensor:
    """The cold-start intercept of every cell, ``(sims, G)`` f64, from the
    prefix mean of y (the reference's :243-252)."""
    # y is 0/1 or counts: its prefix sums are exact in f64 in any order
    csum = torch.cumsum(y.to(torch.float64), dim=-1)
    idx = torch.as_tensor([n - 1 for n in spec.grid], device=y.device)
    ns = torch.as_tensor(spec.grid, dtype=torch.float64, device=y.device)
    return data_intercept(spec.outcome, spec.link, csum[:, idx] / ns)


def start_values(spec: SimSpec, arr: Dict[str, torch.Tensor], y: torch.Tensor,
                 colmask: torch.Tensor) -> torch.Tensor:
    """Each cell's IRLS start ``beta0 (sims, G, pf)`` f64: the true
    coefficients of the fit columns times the cell's column mask (``(G,
    pf)`` or ``(sims, G, pf)``) under ``scenario.truth_start``, else zeros
    with the data intercept (the reference's :235-252)."""
    fit = list(spec.effective_fit_cols)
    sims, G = y.shape[0], spec.n_grid
    cm = _cell_masks(colmask.to(y.device), sims, G, len(fit))
    if spec.scenario.truth_start:
        b = arr["effects"].to(device=y.device, dtype=torch.float64)[fit]
        return (b * cm).contiguous()
    beta0 = torch.zeros((sims, G, len(fit)), dtype=torch.float64, device=y.device)
    beta0[..., 0] = _data_intercepts(spec, y)
    return beta0


def _drop_rows(spec: SimSpec) -> torch.Tensor:
    """``(n_factors, pf)`` f64: 1 at the fit columns each factor's
    exclusion drops."""
    from .spec import factor_dependent_cols

    fit = spec.effective_fit_cols
    return torch.tensor([[1.0 if c in factor_dependent_cols(spec, f) else 0.0 for c in fit]
                         for f in range(spec.n_factors)], dtype=torch.float64)


def fallback_inputs(spec: SimSpec, y: torch.Tensor, colmask: torch.Tensor,
                    min_counts: torch.Tensor):
    """The separation fallback's start and column mask, ``(sims, G, pf)``
    f64 each (the reference's :259-264): zeros with the data intercept, and
    the cell's mask less the columns of its sparsest factor (the first on
    ties, as ``argmin``)."""
    sparsest = torch.argmin(min_counts, dim=-1)  # (sims, G)
    cm_fb = colmask * (1.0 - _drop_rows(spec).to(colmask.device)[sparsest])
    beta0_fb = torch.zeros(cm_fb.shape, dtype=torch.float64, device=y.device)
    beta0_fb[..., 0] = _data_intercepts(spec, y)
    return beta0_fb, cm_fb


def glm_grid_stats(spec: SimSpec, arr: Dict[str, torch.Tensor], X: torch.Tensor,
                   y: torch.Tensor, *, colmask: torch.Tensor = None,
                   min_counts: torch.Tensor = None,
                   plain: bool = False) -> Dict[str, torch.Tensor]:
    """All GLM statistics for a batch of sims across the grid: ``t2 (sims,
    G, k)``, ``overall`` (the LRT statistic dev0 - dev, against a chi^2 crit
    of df = pf - 1), ``converged``, ``glm_baseline`` (the realized outcome
    mean) and ``singular`` (~converged), each ``(sims, G)``; for a posthoc
    spec ``posthoc_t2``.

    ``colmask (sims, G, pf)`` f64 runs each cell's reduced fit, its masked
    columns pinned at 0. With factors (``min_counts (sims, G, n_factors)``,
    the smallest realized level counts), each cell that did not converge is
    refit once, cold from the data intercept, without the columns of its
    sparsest factor (the first on ties); the refit replaces beta, cov and
    dev where it converges, and ``separation_fallback`` marks those cells.
    ``plain=True`` runs the plain PyTorch IRLS on any device (used to time
    and check K6 against it).
    """
    fit = spec.effective_fit_cols
    sims, G = X.shape[0], spec.n_grid
    if colmask is None:
        colmask = torch.ones((sims, G, len(fit)), dtype=torch.float64, device=X.device)
    code = link_code(spec.outcome, spec.link)
    irls = glm_irls_plain if plain else glm_irls
    beta0 = start_values(spec, arr, y, colmask)
    beta, cov, converged, dev, dev0, ybar = irls(code, X, y, fit, spec.grid, beta0, colmask)
    fb_used = None
    if spec.n_factors:
        beta0_fb, cm_fb = fallback_inputs(spec, y, colmask, min_counts)
        failed = ~converged
        beta_fb, cov_fb, conv_fb, dev_fb, _, _ = irls(code, X, y, fit, spec.grid, beta0_fb, cm_fb,
                                                      active=failed)
        fb_used = failed & conv_fb
        beta = torch.where(fb_used[..., None], beta_fb, beta)
        cov = torch.where(fb_used[..., None, None], cov_fb, cov)
        dev = torch.where(fb_used, dev_fb, dev)
        converged = converged | fb_used
    out = {
        "t2": waldstats.t2_targets(spec, beta, cov),
        "overall": dev0 - dev,
        "converged": converged,
        "glm_baseline": ybar,
        "singular": ~converged,
    }
    if fb_used is not None:
        out["separation_fallback"] = fb_used
    return waldstats.add_posthoc(out, spec, beta, cov)
