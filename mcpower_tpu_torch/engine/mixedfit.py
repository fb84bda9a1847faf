"""Batched random-intercept LMM: profiled REML over per-cluster statistics.

For V0 = I + gamma Z Z' the REML profile deviance reduces, by per-cluster
Woodbury, to arithmetic over the cluster row counts n_j, column sums s_j,
outcome sums t_j and the global X'X, X'y, y'y:

    X'V0^-1 X = X'X - sum_j c_j s_j s_j',   c_j = gamma / (1 + gamma n_j)
    log|V0|   = sum_j log(1 + gamma n_j)

so one deviance evaluation is an (m, p) contraction plus a p x p Cholesky.
Those statistics are prefix sums over the CRN grid: the reference's
``_cluster_suffstats`` is ``olsfit.grid_suffstats(..., with_clusters=True)``
here (kernel K2). The search
over log gamma in [-14, 7] is a fixed 20-step safeguarded Brent, then the
gamma = 0 probe decides the low pin, log gamma > 6.5 the high pin, and the
final fit gives beta, cov = sigma^2 (X'V0^-1 X)^-1 and tau^2.

On the card the whole per-cell fit is kernel K4 (``csrc/reml_intercept.cu``,
a group of lanes per (sim, grid) cell). :func:`reml_intercept_plain` is its
plain PyTorch version, written with the sim and grid axes as batch axes and
the reference's branch-free lane selects.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import kernels, olsfit, smallchol, waldstats
from .spec import SimSpec

LOG_GAMMA_LO = -14.0
LOG_GAMMA_HI = 7.0
BOUNDARY_LOG_GAMMA_HI = 6.5
BRENT_ITERS = 20
BOUNDARY_LOG_GAMMA = -12.0
_CGOLD = 0.3819660112501051  # 2 - phi: golden fraction into the larger arm
MAX_P = olsfit.MAX_P


def _reml_quantities(gamma, n_j, s, t, xtx, xty, yty, n, p: int):
    """Profile-REML pieces at ``gamma`` for a batch of cells: returns
    (deviance, beta, chol, sigma2, rss)."""
    c = gamma[..., None] / (1.0 + gamma[..., None] * n_j)  # (..., m)
    a_xx = xtx - smallchol.wouter(c, s)
    a_xy = xty - smallchol.wvec(c, s, t)
    a_yy = yty - (c * t * t).sum(-1)
    chol = smallchol.chol(a_xx)
    beta = smallchol.cho_solve(chol, a_xy)
    rss = a_yy - (beta * a_xy).sum(-1)
    df = n - p
    sigma2 = rss / df
    logdet_v = torch.log1p(gamma[..., None] * n_j).sum(-1)
    dev = logdet_v + smallchol.logdet_from_chol(chol) + df * torch.log(rss)
    return dev, beta, chol, sigma2, rss


def _brent_minimize(lo: float, hi: float, aux0, phases, init_eval=None, tol: float = 1e-9):
    """Fixed-iteration safeguarded parabolic minimization (Brent's method)
    over lanes, the reference's ``mixedfit._brent_minimize``: a parabolic
    step only when it lands inside the bracket and moves less than half the
    step before last, else a golden step into the larger arm.

    ``phases`` is a tuple of ``(n_iters, eval_fn)`` with ``eval_fn(x, aux)
    -> (f, aux)``; ``x`` is an f64 tensor. Returns ``(x_best, f_best,
    aux)``, the best evaluated point.
    """
    x0 = torch.tensor(lo + _CGOLD * (hi - lo), dtype=torch.float64)
    fx, aux = (init_eval or phases[0][1])(x0, aux0)
    fx = torch.as_tensor(fx, dtype=torch.float64)
    x0 = x0.to(fx.device).expand_as(fx)
    a = torch.full_like(fx, lo)
    b = torch.full_like(fx, hi)
    x, w, v = x0, x0, x0
    fw, fv = fx, fx
    d = torch.zeros_like(fx)
    e = torch.zeros_like(fx)
    where = torch.where
    for n_iters, eval_fn in phases:
        for _ in range(n_iters):
            xm = 0.5 * (a + b)
            tol1 = tol * torch.abs(x) + 1e-13
            tol2 = 2.0 * tol1
            r = (x - w) * (fx - fv)
            q = (x - v) * (fx - fw)
            p = (x - v) * q - (x - w) * r
            q = 2.0 * (q - r)
            p = where(q > 0.0, -p, p)
            q = torch.abs(q)
            e_gold = where(x >= xm, a - x, b - x)
            d_gold = _CGOLD * e_gold
            para_ok = (
                (torch.abs(e) > tol1)
                & (q > 0.0)
                & (torch.abs(p) < torch.abs(0.5 * q * e))
                & (p > q * (a - x))
                & (p < q * (b - x))
            )
            d_para = p / where(q == 0.0, torch.ones_like(q), q)
            u_try = x + d_para
            d_para = where(
                (u_try - a < tol2) | (b - u_try < tol2),
                where(xm >= x, tol1, -tol1),
                d_para,
            )
            e2 = where(para_ok, d, e_gold)
            d2 = where(para_ok, d_para, d_gold)
            u = x + where(torch.abs(d2) >= tol1, d2, where(d2 >= 0.0, tol1, -tol1))
            fu, aux = eval_fn(u, aux)
            better = fu <= fx
            a2 = where(better, where(u >= x, x, a), where(u < x, u, a))
            b2 = where(better, where(u >= x, b, x), where(u < x, b, u))
            demote_w = (~better) & ((fu <= fw) | (w == x))
            demote_v = (~better) & (~demote_w) & ((fu <= fv) | (v == x) | (v == w))
            keep_w = better | demote_w
            v, fv = where(keep_w, w, where(demote_v, u, v)), where(keep_w, fw, where(demote_v, fu, fv))
            w, fw = where(better, x, where(demote_w, u, w)), where(better, fx, where(demote_w, fu, fw))
            x, fx = where(better, u, x), where(better, fu, fx)
            a, b, d, e = a2, b2, d2, e2
    return x, fx, aux


# ---------------------------------------------------------------------------
# K4: the whole random-intercept REML fit per (sim, grid) cell
# ---------------------------------------------------------------------------


def reml_intercept_plain(n_j, s, t, xtx, xty, yty, ns):
    """Random-intercept REML per cell from K2's statistics.

    ``n_j (..., G, m)``, ``s (..., G, m, p)``, ``t (..., G, m)``, ``xtx
    (..., G, p, p)``, ``xty (..., G, p)``, ``yty (..., G)``, ``ns (G,)``.
    Returns ``beta``, ``cov``, ``converged``, ``boundary`` (low pin),
    ``tau2_hat``, ``boundary_hi`` (high pin).
    """
    p = xtx.shape[-1]
    n = ns.to(torch.float64).expand_as(yty)

    def dev_at(log_gamma):
        gamma = torch.exp(log_gamma).to(yty.device).expand_as(yty)
        return _reml_quantities(gamma, n_j, s, t, xtx, xty, yty, n, p)[0]

    log_gamma_hat, _, _ = _brent_minimize(
        LOG_GAMMA_LO, LOG_GAMMA_HI, (), ((BRENT_ITERS, lambda lg, aux: (dev_at(lg), aux)),)
    )
    dev_interior = dev_at(log_gamma_hat)
    dev_zero = dev_at(torch.tensor(LOG_GAMMA_LO, dtype=torch.float64, device=yty.device))
    boundary = (dev_zero <= dev_interior + 1e-10) | (log_gamma_hat < BOUNDARY_LOG_GAMMA)
    boundary_hi = ~boundary & (log_gamma_hat > BOUNDARY_LOG_GAMMA_HI)
    gamma_hat = torch.where(boundary, torch.zeros_like(log_gamma_hat), torch.exp(log_gamma_hat))

    dev, beta, chol, sigma2, _ = _reml_quantities(gamma_hat, n_j, s, t, xtx, xty, yty, n, p)
    cov = sigma2[..., None, None] * smallchol.cho_inverse(chol)
    tau2_hat = gamma_hat * sigma2
    converged = (
        torch.isfinite(dev)
        & torch.isfinite(beta).all(-1)
        & (sigma2 > 0.0)
        & smallchol.chol_rank_ok(chol)
    )
    return beta, cov, converged, boundary, tau2_hat, boundary_hi


_REML_ARGS = [
    ctypes.c_void_p,  # n_j (B, m) f64
    ctypes.c_void_p,  # s (B, m, p)
    ctypes.c_void_p,  # t (B, m)
    ctypes.c_void_p,  # xtx (B, p, p)
    ctypes.c_void_p,  # xty (B, p)
    ctypes.c_void_p,  # yty (B,)
    ctypes.c_void_p,  # ns (G,) f64; cell b uses ns[b % G]
    ctypes.c_int,  # B
    ctypes.c_int,  # G
    ctypes.c_int,  # m
    ctypes.c_int,  # p
    ctypes.c_double,  # eps_rank
    ctypes.c_void_p,  # beta out (B, p)
    ctypes.c_void_p,  # cov out (B, p, p)
    ctypes.c_void_p,  # tau2_hat out (B,)
    ctypes.c_void_p,  # flags out (B,) uint8: bit0 converged, bit1 boundary, bit2 boundary_hi
    ctypes.c_void_p,  # cudaStream_t
]


def reml_intercept_kernel(n_j, s, t, xtx, xty, yty, ns):
    """Kernel K4: :func:`reml_intercept_plain` on the card, a group of
    lanes per (sim, grid) cell."""
    p, m, G = xtx.shape[-1], n_j.shape[-1], xtx.shape[-3]
    if not 1 <= p <= MAX_P:
        raise ValueError(f"reml_intercept kernel takes 1 <= p <= {MAX_P}, got {p}")
    lead = yty.shape
    n_j, s, t, xtx, xty, yty, ns = (
        v.to(torch.float64).contiguous() for v in (n_j, s, t, xtx, xty, yty, ns)
    )
    if (n_j.shape != lead + (m,) or s.shape != lead + (m, p) or t.shape != lead + (m,)
            or xtx.shape != lead + (p, p) or xty.shape != lead + (p,) or ns.shape != (G,)):
        raise ValueError("reml_intercept: inconsistent shapes")
    B = yty.numel()
    kw = dict(dtype=torch.float64, device=xtx.device)
    beta = torch.empty(lead + (p,), **kw)
    cov = torch.empty(lead + (p, p), **kw)
    tau2 = torch.empty(lead, **kw)
    flags = torch.empty(lead, dtype=torch.uint8, device=xtx.device)
    kernels.require_cuda("reml_intercept", n_j, s, t, xtx, xty, yty, ns, beta, cov, tau2, flags)
    if B:
        k = kernels.KERNELS["reml_intercept"]
        fn = k.fn("mcp_reml_intercept", _REML_ARGS)
        k.check(
            fn(
                kernels.ptr(n_j), kernels.ptr(s), kernels.ptr(t), kernels.ptr(xtx),
                kernels.ptr(xty), kernels.ptr(yty), kernels.ptr(ns), B, G, m, p,
                smallchol.EPS_RANK, kernels.ptr(beta), kernels.ptr(cov), kernels.ptr(tau2),
                kernels.ptr(flags), kernels.stream_of(xtx),
            )
        )
    converged = (flags & 1).bool()
    boundary = (flags & 2).bool()
    boundary_hi = (flags & 4).bool()
    return beta, cov, converged, boundary, tau2, boundary_hi


def reml_intercept(n_j, s, t, xtx, xty, yty, ns):
    """K4 for CUDA tensors, the plain version for CPU tensors."""
    if xtx.is_cuda:
        return reml_intercept_kernel(n_j, s, t, xtx, xty, yty, ns)
    if xtx.device.type != "cpu":
        raise ValueError(f"reml_intercept: no kernel for device {xtx.device}")
    return reml_intercept_plain(n_j, s, t, xtx, xty, yty, ns)


# ---------------------------------------------------------------------------
# The arm
# ---------------------------------------------------------------------------


def mixed_grid_stats(spec: SimSpec, X: torch.Tensor, y: torch.Tensor, *,
                     plain: bool = False) -> Dict[str, torch.Tensor]:
    """All random-intercept LMM statistics for a batch of sims across the
    grid (the intercept branch of the reference's ``mixed_grid_stats``).

    ``plain=True`` runs the plain PyTorch versions of K2 and K4 on any
    device (used to time and check the kernels against them).
    """
    c = spec.cluster
    if c is None:
        raise ValueError("mle estimator requires a cluster spec")
    if c.slopes or c.extra_groupings:
        raise NotImplementedError("not ported yet: random slopes and extra groupings (ROADMAP A11, A12)")
    suff = (olsfit.grid_suffstats_plain if plain else olsfit.grid_suffstats)(
        spec, X, y, with_clusters=True
    )
    ns = torch.as_tensor(spec.grid, dtype=torch.float64, device=X.device)
    beta, cov, converged, boundary, tau2_hat, boundary_hi = (
        reml_intercept_plain if plain else reml_intercept
    )(suff["n_j"], suff["s"], suff["t"], suff["xtx"], suff["xty"], suff["yty"], ns)
    return _assemble_outputs(
        spec, beta, cov, converged, boundary, tau2_hat, boundary[..., None], boundary_hi
    )


def _assemble_outputs(spec: SimSpec, beta, cov, converged, boundary, tau2_hat, pinned,
                      boundary_hi=None) -> Dict[str, torch.Tensor]:
    """t^2, omnibus and posthoc assembly; ``pinned (..., G, n_components)``
    is masked to converged fits."""
    out = {
        "t2": waldstats.t2_targets(spec, beta, cov),
        "converged": converged,
        "boundary_hit": boundary,
        "tau2_hat": tau2_hat,
        "pinned_comp": pinned & converged[..., None],
    }
    if spec.report_overall:
        out["overall"] = waldstats.overall_wald_chi2(spec, beta, cov)
    if boundary_hi is not None:
        out["boundary_hi"] = boundary_hi
    return waldstats.add_posthoc(out, spec, beta, cov)
