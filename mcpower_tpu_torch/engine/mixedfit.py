"""Batched LMM: profiled REML over per-cluster statistics, with a random
intercept (kernel K4) or random slopes (kernel K9).

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

With random slopes (q components, the reference's ``_slope_grid_stats``) the
deviance is a sum of q x q per-cluster terms over K2's slope-mode
statistics G = sum z z', A = sum z x', b = sum z y, and the search is a
140-iteration Nelder-Mead (``optim.nelder_mead``) over theta = vech chol of
the relative covariance, ranked on f32 twins of the statistics, then the
f64 zero-column pin probes and the final f64 fit: kernel K9
(``csrc/slope_reml.cu``, a warp per cell), whose plain version
:func:`slope_reml_plain` sums in K9's order so that the two agree bit for
bit.

With extra groupings (crossed or nested, the reference's
``_joint_grid_stats``) the random-effect design is one joint Z of M = sum
of levels x components columns, its statistics Z'Z, Z'X, Z'y come from
K2's joint mode, and each deviance runs through the joint capacitance: a
Schur complement of the extras block when every grouping is
intercept-only, the dense M x M factor otherwise, in ``smallchol``'s
blocked order. The search is the same Nelder-Mead on f32 twins, then an
f64 refit: kernel K11 (``csrc/joint_reml.cu``), whose plain version is
:func:`joint_reml_plain`.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from . import kernels, olsfit, optim, smallchol, waldstats
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
# K9: the whole random-slope REML fit per (sim, grid) cell
# ---------------------------------------------------------------------------

# The reference's search (mixedfit.py:405-407): 140 Nelder-Mead iterations
# from the truth start with an initial step of 0.3.
SLOPE_NM_ITERS = 140
SLOPE_NM_STEP = 0.3
# K9's lanes on one candidate: lane l takes clusters l, l + 8, ... in turn,
# then the lanes combine in a pair tree (distances 4, 2, 1). The plain
# version sums over clusters in this order.
SLOPE_LANES = 8
MAX_Q = 4
# What a failed f32 evaluation ranks as: f32(1e30) widened to f64 (the
# reference's dev_at32); a failed f64 evaluation is Python's 1e30.
SENTINEL32 = float(np.float32(1e30))
SENTINEL64 = 1e30
PIN_MARGIN = 1e-10


def vech_to_lower(theta: torch.Tensor, q: int) -> torch.Tensor:
    """theta ``(..., q (q + 1) / 2)`` -> lower triangular ``(..., q, q)``,
    column-major vech (the reference's ``_vech_to_lower``, :298)."""
    L = theta.new_zeros(theta.shape[:-1] + (q, q))
    k = 0
    for j in range(q):
        for i in range(j, q):
            L[..., i, j] = theta[..., k]
            k += 1
    return L


def vech_diagonal(q: int):
    """The vech positions of the diagonal entries, in component order."""
    out, k = [], 0
    for j in range(q):
        out.append(k)
        k += q - j
    return out


def slope_start(spec: SimSpec):
    """The truth start of the theta search and its bounds, on the host in
    numpy (the reference's :364-383): ``theta0 = vech chol(D + 1e-10 I)`` of
    the generating D (sigma^2 = 1), variances floored at 1e-4; ``lower`` 0
    on the Cholesky diagonal (a component pins at 0), -inf elsewhere."""
    c = spec.cluster
    q = c.q
    taus = np.sqrt([max(c.tau_squared, 1e-4)] + [max(s.variance, 1e-4) for s in c.slopes])
    corr = np.eye(q)
    for i, s in enumerate(c.slopes):
        corr[0, 1 + i] = corr[1 + i, 0] = s.intercept_corr
    for i, si in enumerate(c.slopes):
        for j, sj in enumerate(c.slopes):
            if i != j:
                corr[1 + i, 1 + j] = si.intercept_corr * sj.intercept_corr
    D = np.outer(taus, taus) * corr
    L0 = np.linalg.cholesky(D + 1e-10 * np.eye(q))
    theta0 = np.concatenate([L0[j:, j] for j in range(q)])
    lower = np.full(theta0.shape, -np.inf)
    lower[vech_diagonal(q)] = 0.0
    return theta0, lower


def _ordered_sum(terms):
    """terms[0] + terms[1] + ..., left to right."""
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def _cluster_lane_sum(v: torch.Tensor, axis: int) -> torch.Tensor:
    """Sum over the cluster axis ``axis`` in K9's order: SLOPE_LANES lanes
    each add clusters l, l + SLOPE_LANES, ... to a zero in turn, then the
    lanes combine in a pair tree."""
    v = v.movedim(axis, -1)
    pad = -v.shape[-1] % SLOPE_LANES
    if pad:
        v = torch.nn.functional.pad(v, (0, pad))
    v = v.reshape(*v.shape[:-1], -1, SLOPE_LANES)
    acc = torch.zeros_like(v[..., 0, :])
    for r in range(v.shape[-2]):
        acc = acc + v[..., r, :]
    half = SLOPE_LANES // 2
    while half:
        acc = acc[..., :half] + acc[..., half:2 * half]
        half //= 2
    return acc[..., 0]


def slope_deviance(theta, G, A, b, xtx, xty, yty, n, full: bool = False):
    """The profiled REML deviance of the q-dimensional random-effect
    structure at ``theta (cells, k, d)`` for k candidates a cell, in the
    dtype of the statistics (the reference's ``_reml_quantities_q``, :309,
    in kernel K9's operation order).

    Statistics ``G (cells, m, q, q)``, ``A (cells, m, q, p)``, ``b (cells,
    m, q)``, ``xtx (cells, p, p)``, ``xty (cells, p)``, ``yty``, ``n
    (cells,)``. Per cluster, with Lam = vech_to_lower(theta): C = I + Lam'
    G Lam and its Cholesky, A~ = Lam' A, b~ = Lam' b, C^-1 A~ and C^-1 b~ by
    ``smallchol`` solves, then the terms A~' C^-1 A~, A~' C^-1 b~, b~' C^-1
    b~ and log|C|, each a sum over the q components from the first; the
    cluster sums in K9's lane order (:func:`_cluster_lane_sum`); then X'V^-1X
    = X'X - sum, its Cholesky, beta, rss, and dev = (log|V| + log|X'V^-1X|)
    + (n - p) log(rss). Returns dev ``(cells, k)``, with ``full`` also beta,
    the Cholesky of X'V^-1X and sigma^2."""
    q, p = G.shape[-1], A.shape[-1]
    Lam = vech_to_lower(theta, q)[:, :, None]  # (cells, k, 1, q, q)
    G, A, b = G[:, None], A[:, None], b[:, None]  # (cells, 1, m, ...)

    def lam(r, j):
        return Lam[..., r, j]

    # Lam' G (j, c) and C = I + (Lam' G) Lam, lower triangle; Lam' A, Lam' b
    LtG = [[_ordered_sum([lam(r, j) * G[..., r, c] for r in range(j, q)]) for c in range(q)]
           for j in range(q)]
    zero = torch.zeros_like(LtG[0][0])
    C = torch.stack([torch.stack([
        (1.0 + _ordered_sum([LtG[j][r] * lam(r, k) for r in range(k, q)]) if k == j else
         _ordered_sum([LtG[j][r] * lam(r, k) for r in range(k, q)])) if k <= j else zero
        for k in range(q)], dim=-1) for j in range(q)], dim=-2)
    At = torch.stack([_ordered_sum([lam(s, r)[..., None] * A[..., s, :] for s in range(r, q)])
                      for r in range(q)], dim=-1)  # (cells, k, m, p, q)
    bt = torch.stack([_ordered_sum([lam(s, r) * b[..., s] for s in range(r, q)])
                      for r in range(q)], dim=-1)  # (cells, k, m, q)
    cholC = smallchol.chol(C)
    sol_b = smallchol.cho_solve(cholC, bt)
    sol_A = smallchol.cho_solve(cholC[..., None, :, :], At)  # (cells, k, m, p, q)
    cxx = _ordered_sum([At[..., :, None, r] * sol_A[..., None, :, r] for r in range(q)])
    cxy = _ordered_sum([At[..., r] * sol_b[..., r, None] for r in range(q)])
    cyy = _ordered_sum([bt[..., r] * sol_b[..., r] for r in range(q)])
    cld = 2.0 * _ordered_sum([torch.log(cholC[..., r, r]) for r in range(q)])

    a_xx = xtx[:, None] - _cluster_lane_sum(cxx, 2)
    a_xy = xty[:, None] - _cluster_lane_sum(cxy, 2)
    a_yy = yty[:, None] - _cluster_lane_sum(cyy, 2)
    logdet_v = _cluster_lane_sum(cld, 2)
    chol = smallchol.chol(a_xx)
    beta = smallchol.cho_solve(chol, a_xy)
    rss = a_yy - _ordered_sum([beta[..., a] * a_xy[..., a] for a in range(p)])
    df = (n - torch.full((), float(p), dtype=n.dtype, device=n.device))[:, None]
    logdet_xvx = 2.0 * _ordered_sum([torch.log(chol[..., a, a]) for a in range(p)])
    dev = (logdet_v + logdet_xvx) + df * torch.log(rss)
    if not full:
        return dev
    return dev, beta, chol, rss / df


def slope_reml_plain(G, A, b, xtx, xty, yty, ns, theta0, lower, theta=None):
    """Random-slope REML per (sim, grid) cell from K2's slope-mode
    statistics (the reference's ``_slope_grid_stats.per_grid``, :385-459).

    ``G (..., Gn, m, q, q)``, ``A (..., Gn, m, q, p)``, ``b (..., Gn, m,
    q)``, ``xtx (..., Gn, p, p)``, ``xty (..., Gn, p)``, ``yty (..., Gn)``
    f64, ``ns (Gn,)``; ``theta0``, ``lower`` ``(d,)`` f64 from
    :func:`slope_start`. Steps: the f32 twins of the statistics (cast after
    the prefix sum), SLOPE_NM_ITERS Nelder-Mead iterations on the f32
    deviance (a non-finite one ranks as SENTINEL32), the f64 deviance at the
    optimum and with each component's Cholesky column zeroed (a component
    whose removal costs at most PIN_MARGIN is pinned and stays zeroed), the
    final f64 fit. ``theta (..., Gn, d)`` f64, where given, replaces the
    search's optimum (to fit at another search's theta).

    Returns ``beta``, ``cov = sigma^2 (X'V^-1X)^-1``, ``converged``,
    ``boundary`` (any component pinned), ``tau2_hat = Gamma[0, 0] sigma^2``
    and ``pinned (..., Gn, q)`` in component order.
    """
    lead = yty.shape
    q, p = G.shape[-1], A.shape[-1]
    d = q * (q + 1) // 2
    dev_ = yty.device
    flat = [v.reshape((-1,) + v.shape[len(lead):]) for v in (G, A, b, xtx, xty, yty)]
    n64 = ns.to(device=dev_, dtype=torch.float64).expand(lead).reshape(-1)
    cells = n64.shape[0]
    theta0 = torch.as_tensor(theta0, dtype=torch.float64, device=dev_)
    lower = torch.as_tensor(lower, dtype=torch.float64, device=dev_)
    if theta is None:
        st32 = [v.to(torch.float32) for v in flat] + [n64.to(torch.float32)]

        def dev32(th):
            dv = slope_deviance(th.to(torch.float32), *st32)
            return torch.where(torch.isfinite(dv), dv, torch.full_like(dv, SENTINEL32)).double()

        theta_hat, _ = optim.nelder_mead(dev32, theta0.expand(cells, d), iters=SLOPE_NM_ITERS,
                                         init_step=SLOPE_NM_STEP, lower=lower)
    else:
        theta_hat = theta.to(device=dev_, dtype=torch.float64).reshape(cells, d)

    masks = torch.ones((q, d), dtype=torch.float64, device=dev_)
    off = 0
    for j in range(q):
        masks[j, off:off + q - j] = 0.0
        off += q - j
    probes = torch.cat([theta_hat[:, None], theta_hat[:, None] * masks], dim=1)
    dv = slope_deviance(probes, *flat, n64)
    dv = torch.where(torch.isfinite(dv), dv, torch.full_like(dv, SENTINEL64))
    pinned = dv[:, 1:] <= dv[:, :1] + PIN_MARGIN
    keep = torch.ones_like(theta_hat)
    for j in range(q):
        keep = keep * torch.where(pinned[:, j:j + 1], masks[j], torch.ones_like(masks[j]))
    theta_fin = theta_hat * keep

    dev, beta, chol, sigma2 = (v[:, 0] for v in slope_deviance(theta_fin[:, None], *flat, n64,
                                                                full=True))
    cov = sigma2[:, None, None] * smallchol.cho_inverse(chol)
    l00 = theta_fin[:, 0]
    tau2_hat = (l00 * l00) * sigma2
    converged = (
        torch.isfinite(dev)
        & torch.isfinite(beta).all(-1)
        & (sigma2 > 0.0)
        & smallchol.chol_rank_ok(chol)
    )
    shape = lambda v, *tail: v.reshape(lead + tail)  # noqa: E731
    return (shape(beta, p), shape(cov, p, p), shape(converged), shape(pinned.any(-1)),
            shape(tau2_hat), shape(pinned, q))


_SLOPE_ARGS = [
    ctypes.c_void_p,  # G (B, m, q, q) f64
    ctypes.c_void_p,  # A (B, m, q, p)
    ctypes.c_void_p,  # b (B, m, q)
    ctypes.c_void_p,  # xtx (B, p, p)
    ctypes.c_void_p,  # xty (B, p)
    ctypes.c_void_p,  # yty (B,)
    ctypes.c_void_p,  # ns (Gn,) f64; cell c uses ns[c % Gn]
    ctypes.c_int,  # B
    ctypes.c_int,  # Gn
    ctypes.c_int,  # m
    ctypes.c_int,  # q
    ctypes.c_int,  # p
    ctypes.POINTER(ctypes.c_double),  # theta0 (d,) host
    ctypes.POINTER(ctypes.c_double),  # lower (d,) host
    ctypes.c_int,  # Nelder-Mead iterations
    ctypes.c_double,  # initial step
    ctypes.c_double,  # eps_rank
    ctypes.c_void_p,  # beta out (B, p)
    ctypes.c_void_p,  # cov out (B, p, p)
    ctypes.c_void_p,  # tau2_hat out (B,)
    ctypes.c_void_p,  # flags out (B,) uint8: bit0 converged, bit1 boundary
    ctypes.c_void_p,  # pinned out (B, q) uint8
    ctypes.c_void_p,  # cudaStream_t
]


def slope_reml_staged(m: int, q: int, p: int) -> bool:
    """Whether K9 keeps a cell's f32 twins of G, A and b in shared memory
    (its staged path) or casts them from device memory at every f32
    evaluation (its streamed path, for cells of many clusters); asks the
    kernel's library, so it builds K9 on first use."""
    fn = kernels.KERNELS["slope_reml"].fn("mcp_slope_reml_staged", [ctypes.c_int] * 3)
    got = fn(m, q, p)
    if got < 0:
        raise ValueError(f"slope_reml: no instantiation for q = {q}")
    return bool(got)


# K9's launch forms (csrc/slope_reml.cu): at p <= 4 packed, 8 lanes a cell
# and four cells a warp, the candidates evaluated as the selection reads
# them, or pair, two warps a cell, the four candidates at once on 16 lanes
# each; at p > 4 quad, a warp a cell, the four candidates on its four 8-lane
# groups.
SLOPE_FORMS = {1: "packed", 2: "pair", 3: "quad"}
_SLOPE_GEOMETRY_KEYS = ("form", "smem", "cells_per_sm", "waves", "registers", "local_bytes",
                        "staged", "cells_per_block")


def slope_reml_geometry(G, A, b, xtx, xty, yty, ns, theta0, lower) -> Dict[str, int]:
    """The launch form K9's C launcher takes for :func:`slope_reml_kernel`'s
    arguments (``SLOPE_FORMS``), the dynamic shared bytes a block, resident
    cells an SM, the launch's waves, its kernel's registers and local (spill
    and stack) bytes a thread, whether the f32 twins are staged and cells a
    block. Builds and loads K9; needs a CUDA device."""
    fn = kernels.KERNELS["slope_reml"].fn("mcp_slope_reml_geometry",
                                          [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)])
    out = (ctypes.c_int * len(_SLOPE_GEOMETRY_KEYS))()
    err = fn(int(yty.numel()), int(G.shape[-3]), int(G.shape[-1]), int(xtx.shape[-1]), out)
    if err:
        raise RuntimeError(f"mcp_slope_reml_geometry: CUDA error {err}")
    return dict(zip(_SLOPE_GEOMETRY_KEYS, out))


def slope_reml_set_form(form: int) -> None:
    """The form K9's later launches take: 0 as its launcher picks, else one
    of ``SLOPE_FORMS`` where the launch's p bucket has it (else the
    launcher's pick). A measurement and check knob: every form gives the
    same bits."""
    fn = kernels.KERNELS["slope_reml"].fn("mcp_slope_reml_set_form", [ctypes.c_int])
    fn.restype = None
    fn(int(form))


def slope_reml_kernel(G, A, b, xtx, xty, yty, ns, theta0, lower, evals: bool = False):
    """Kernel K9: :func:`slope_reml_plain` on the card, in the form its
    launcher picks (:func:`slope_reml_geometry`). With ``evals`` also each
    cell's count of the f32 evaluations its search needed (int32)."""
    q, p, m, Gn = G.shape[-1], xtx.shape[-1], G.shape[-3], xtx.shape[-3]
    if not 2 <= q <= MAX_Q or not 1 <= p <= MAX_P:
        raise ValueError(f"slope_reml kernel takes 2 <= q <= {MAX_Q} and 1 <= p <= {MAX_P}, "
                         f"got q {q}, p {p}")
    lead = yty.shape
    G, A, b, xtx, xty, yty, ns = (
        v.to(torch.float64).contiguous() for v in (G, A, b, xtx, xty, yty, ns)
    )
    if (G.shape != lead + (m, q, q) or A.shape != lead + (m, q, p) or b.shape != lead + (m, q)
            or xtx.shape != lead + (p, p) or xty.shape != lead + (p,) or ns.shape != (Gn,)):
        raise ValueError("slope_reml: inconsistent shapes")
    d = q * (q + 1) // 2
    theta0 = np.asarray(theta0, dtype=np.float64).reshape(d)
    lower = np.asarray(lower, dtype=np.float64).reshape(d)
    B = yty.numel()
    kw = dict(dtype=torch.float64, device=xtx.device)
    beta = torch.empty(lead + (p,), **kw)
    cov = torch.empty(lead + (p, p), **kw)
    tau2 = torch.empty(lead, **kw)
    flags = torch.empty(lead, dtype=torch.uint8, device=xtx.device)
    pinned = torch.empty(lead + (q,), dtype=torch.uint8, device=xtx.device)
    counts = torch.empty(lead, dtype=torch.int32, device=xtx.device) if evals else None
    kernels.require_cuda("slope_reml", G, A, b, xtx, xty, yty, ns, beta, cov, tau2, flags, pinned,
                         *(() if counts is None else (counts,)))
    if B:
        k = kernels.KERNELS["slope_reml"]
        args = [kernels.ptr(G), kernels.ptr(A), kernels.ptr(b), kernels.ptr(xtx),
                kernels.ptr(xty), kernels.ptr(yty), kernels.ptr(ns), B, Gn, m, q, p,
                (ctypes.c_double * d)(*theta0), (ctypes.c_double * d)(*lower),
                SLOPE_NM_ITERS, SLOPE_NM_STEP, smallchol.EPS_RANK,
                kernels.ptr(beta), kernels.ptr(cov), kernels.ptr(tau2), kernels.ptr(flags),
                kernels.ptr(pinned)]
        if counts is None:
            k.check(k.fn("mcp_slope_reml", _SLOPE_ARGS)(*args, kernels.stream_of(xtx)))
        else:
            fn = k.fn("mcp_slope_reml_counted", _SLOPE_ARGS[:-1] + [ctypes.c_void_p] * 2)
            k.check(fn(*args, kernels.ptr(counts), kernels.stream_of(xtx)))
    out = (beta, cov, (flags & 1).bool(), (flags & 2).bool(), tau2, pinned.bool())
    return out + (counts,) if evals else out


def slope_reml(G, A, b, xtx, xty, yty, ns, theta0, lower):
    """K9 for CUDA tensors, the plain version for CPU tensors."""
    if xtx.is_cuda:
        return slope_reml_kernel(G, A, b, xtx, xty, yty, ns, theta0, lower)
    if xtx.device.type != "cpu":
        raise ValueError(f"slope_reml: no kernel for device {xtx.device}")
    return slope_reml_plain(G, A, b, xtx, xty, yty, ns, theta0, lower)


# ---------------------------------------------------------------------------
# K11: the joint-Z REML fit of extra groupings per (sim, grid) cell
# ---------------------------------------------------------------------------

# Kernel K11's limits: theta of d <= JOINT_MAX_D entries (the Nelder-Mead's
# range, as K9's), a joint Z of M <= JOINT_MAX_M columns (the M x M
# capacitance and K2's joint accumulator in shared memory), p <= MAX_P.
JOINT_MAX_D = 10
JOINT_MAX_M = 128
JOINT_MAX_GROUPINGS = 4
# The reference's pin of a joint fit (mixedfit.py:797-806): a component
# whose Cholesky diagonal ends below this.
JOINT_PIN = 1e-4


def grouping_plan(spec: SimSpec):
    """``[(n_levels, q_g, slope_cols, tau2, slopes)]`` per grouping, the
    primary first, then the extra groupings in declaration order (the
    reference's ``_grouping_plan``, :482)."""
    from . import datagen

    c = spec.cluster
    plan = [(c.n_clusters_at(spec.max_n), c.q, tuple(s.design_col for s in c.slopes),
             c.tau_squared, c.slopes)]
    for g, eg in enumerate(c.extra_groupings):
        plan.append((datagen.extra_grouping_ids(spec, g)[1], 1 + len(eg.slopes),
                     tuple(s.design_col for s in eg.slopes), eg.tau_squared, eg.slopes))
    return plan


def plan_all_q1(plan) -> bool:
    """Every grouping intercept-only: the structured capacitance."""
    return all(q == 1 for _, q, _, _, _ in plan)


def joint_width(plan) -> int:
    """M, the columns of the joint Z: sum of levels x components."""
    return sum(n_lv * q for n_lv, q, _, _, _ in plan)


def theta_layout(plan):
    """Per-grouping vech sizes, the truth start and the lower bounds, in
    numpy (the reference's ``_theta_layout``, :536): each grouping's theta
    is vech chol(D + 1e-10 I) of its generating D, variances floored at
    1e-4; 0 bounds the Cholesky diagonals, -inf the rest."""
    sizes = [q * (q + 1) // 2 for _, q, _, _, _ in plan]
    theta0, lower = [], []
    for _, q, _, tau2, slopes in plan:
        taus = np.sqrt([max(tau2, 1e-4)] + [max(s.variance, 1e-4) for s in slopes])
        corr = np.eye(q)
        for i, s in enumerate(slopes):
            corr[0, 1 + i] = corr[1 + i, 0] = s.intercept_corr
        for i, si in enumerate(slopes):
            for j, sj in enumerate(slopes):
                if i != j:
                    corr[1 + i, 1 + j] = si.intercept_corr * sj.intercept_corr
        D = np.outer(taus, taus) * corr
        L0 = np.linalg.cholesky(D + 1e-10 * np.eye(q))
        theta0.extend(np.concatenate([L0[j:, j] for j in range(q)]))
        lower.extend(0.0 if i == j else -np.inf for j in range(q) for i in range(j, q))
    return sizes, np.asarray(theta0, np.float64), np.asarray(lower, np.float64)


def joint_unsupported(spec: SimSpec) -> str:
    """Why kernels K2 (joint mode) and K11 cannot fit ``spec``'s extra
    groupings; '' when they can."""
    plan = grouping_plan(spec)
    d = sum(sizes for sizes in theta_layout(plan)[0])
    M = joint_width(plan)
    if len(plan) > JOINT_MAX_GROUPINGS:
        return f"{len(plan)} groupings; kernel K11 takes at most {JOINT_MAX_GROUPINGS}"
    if d > JOINT_MAX_D:
        return (f"a joint theta of {d} entries; kernel K11 takes d <= {JOINT_MAX_D} "
                f"(optim.py's range)")
    if M > JOINT_MAX_M:
        return (f"a joint Z of {M} columns; kernels K2 (joint mode) and K11 take M <= "
                f"{JOINT_MAX_M} (the M x M capacitance in shared memory)")
    return ""


def _joint_lams(theta, plan_shape):
    """Each grouping's Lg ``(..., q, q)`` from the stacked theta."""
    out, off = [], 0
    for _, q in plan_shape:
        sz = q * (q + 1) // 2
        out.append(vech_to_lower(theta[..., off:off + sz], q))
        off += sz
    return out


def _lam_rows(lams, plan_shape, v):
    """Lam' v for v ``(..., M, r)``: row (g, level, r) is sum over r' >= r of
    Lg[r', r] v[(g, level, r')], from r' = r up."""
    rows, off = [], 0
    for Lg, (m, q) in zip(lams, plan_shape):
        blk = v[..., off:off + m * q, :].reshape(*v.shape[:-2], m, q, v.shape[-1])
        lam = Lg[..., None, :, :, None]  # (..., 1, q, q, 1) against (..., m, q, r)
        comps = [_ordered_sum([lam[..., rr, r, :] * blk[..., rr, :] for rr in range(r, q)])
                 for r in range(q)]
        rows.append(torch.stack(comps, dim=-2).reshape(*v.shape[:-2], m * q, v.shape[-1]))
        off += m * q
    return torch.cat(rows, dim=-2)


def _contract_rows(U, V):
    """sum over rows of U[row, i] V[row, j], ``(..., M, r)`` twice -> ``(...,
    r, r)``, the rows added to a zero in ascending order."""
    acc = torch.zeros(U.shape[:-2] + (U.shape[-1], V.shape[-1]), dtype=U.dtype, device=U.device)
    for row in range(U.shape[-2]):
        acc = acc + U[..., row, :, None] * V[..., row, None, :]
    return acc


def _joint_tail(rhs, sol, logdet_v, xtx, xty, yty, n, p: int, full: bool):
    """X'V^-1X = X'X - At' sol_A, X'V^-1y, y'V^-1y from the capacitance solve,
    then the p x p factor (chol_auto), beta, rss and the deviance."""
    acc = _contract_rows(rhs, sol)
    a_xx = xtx - acc[..., 1:, 1:]
    a_xy = xty - acc[..., 1:, 0]
    a_yy = yty - acc[..., 0, 0]
    chol = smallchol.chol_auto(a_xx)
    beta = smallchol.cho_solve_auto(chol, a_xy)
    rss = a_yy - _ordered_sum([beta[..., a] * a_xy[..., a] for a in range(p)])
    df = n - torch.full((), float(p), dtype=n.dtype, device=n.device)
    dev = (logdet_v + smallchol.logdet_ordered(chol)) + df * torch.log(rss)
    if not full:
        return dev
    return dev, beta, chol, rss / df


def joint_capacitance(theta, plan_shape, ztz, rhs_raw, dense: bool = False,
                      solve: bool = True):
    """The joint capacitance C = I + Lam' ztz Lam at ``theta (..., d)`` in
    kernel K11's order, shared by the REML fit (:func:`joint_deviance`) and
    the GLMM with extra groupings (``glmmfit.glmm_extras_plain``, whose
    ``ztz`` is a PIRLS pass's Z'WZ). ``ztz (..., M, M)`` and ``rhs_raw (...,
    M, r)`` broadcast against ``theta``'s leading axes.

    All groupings intercept-only (structured): Lam = diag(d), a = 1 + l1^2
    diag(G_PP), Cpe = (l1 G_PE) dE, S = (I + (dE dE') G_EE) - Cpe' (Cpe /
    a) summed over the primary levels in order, S's factor (chol_auto),
    the extras' solves t = re - Cpe' (rp / a) and xe = S^-1 t, the primary's
    xp = rp / a - (Cpe xe) / a (the sums over levels in order), log|C| =
    sum log a + log|S|. Otherwise (dense): C = I + Lam' ztz Lam with Lam =
    blockdiag(I_m (x) Lg) applied block by block (:func:`_lam_rows`), its
    blocked factor and the blocked solve of Lam' rhs_raw. ``dense=True``
    takes the dense form for an all-intercept plan too.

    Returns ``(rhs, sol, logdet_v)``: rhs = Lam' rhs_raw, sol = C^-1 rhs and
    log|C|; with ``solve=False`` only log|C| (rhs and sol None).
    """
    lead = theta.shape[:-1]
    if all(q == 1 for _, q in plan_shape) and not dense:
        m1 = plan_shape[0][0]
        l1 = theta[..., 0]
        grp = torch.cat([torch.full((m,), 1 + g, dtype=torch.long, device=theta.device)
                         for g, (m, _) in enumerate(plan_shape[1:])])
        dE = theta[..., grp]  # (..., Me)
        gpp = torch.diagonal(ztz[..., :m1, :m1], dim1=-2, dim2=-1)
        a = 1.0 + (l1 * l1)[..., None] * gpp
        Cpe = (l1[..., None, None] * ztz[..., :m1, m1:]) * dE[..., None, :]
        Me = dE.shape[-1]
        eye = torch.eye(Me, dtype=ztz.dtype, device=ztz.device)
        Cee = eye + (dE[..., :, None] * dE[..., None, :]) * ztz[..., m1:, m1:]
        Cpe_a = Cpe / a[..., None]
        S = Cee - _contract_rows(Cpe, Cpe_a)
        cholS = smallchol.chol_auto(S)
        la = torch.log(a)
        logdet_v = _ordered_sum([la[..., j] for j in range(m1)]) + smallchol.logdet_ordered(cholS)
        if not solve:
            return None, None, logdet_v
        rp = l1[..., None, None] * rhs_raw[..., :m1, :]
        re = dE[..., :, None] * rhs_raw[..., m1:, :]
        rp_a = rp / a[..., None]
        xe = smallchol.cho_solve_mat_auto(cholS, re - _contract_rows(Cpe, rp_a))
        xp = rp_a - _contract_rows(Cpe.transpose(-1, -2), xe) / a[..., None]
        return torch.cat([rp, re], dim=-2), torch.cat([xp, xe], dim=-2), logdet_v
    lams = _joint_lams(theta, plan_shape)
    W = _lam_rows(lams, plan_shape, ztz.expand(*lead, *ztz.shape[-2:]))
    C = _lam_rows(lams, plan_shape, W.transpose(-1, -2)).transpose(-1, -2)
    M = C.shape[-1]
    C = torch.eye(M, dtype=C.dtype, device=C.device) + C
    cholC = smallchol.chol_vec(C)
    logdet_v = smallchol.logdet_ordered(cholC)
    if not solve:
        return None, None, logdet_v
    rhs = _lam_rows(lams, plan_shape, rhs_raw.expand(*lead, *rhs_raw.shape[-2:]))
    return rhs, smallchol.cho_solve_mat_vec(cholC, rhs), logdet_v


def joint_deviance(theta, plan_shape, ztz, ztx, zty, xtx, xty, yty, n, full: bool = False,
                   dense: bool = False):
    """The profiled REML deviance with the joint capacitance at ``theta
    (cells, k, d)``, k candidates a cell, in the statistics' dtype (the
    reference's ``_reml_quantities_joint`` and ``_reml_quantities_joint_q1``,
    :588-717, in kernel K11's order). ``plan_shape`` is ``[(levels, q)]`` per
    grouping; statistics ``ztz (cells, M, M)``, ``ztx (cells, M, p)``,
    ``zty (cells, M)``, ``xtx``, ``xty``, ``yty``, ``n (cells,)``. The
    capacitance solve of [zty | ztx] is :func:`joint_capacitance`'s (its
    structured form when every grouping is intercept-only, unless
    ``dense``), then :func:`_joint_tail`. Returns dev ``(cells, k)``, with
    ``full`` also beta, the factor of X'V^-1X and sigma^2.
    """
    p = xtx.shape[-1]
    theta = theta.to(ztz.dtype)
    ztz, ztx, zty = ztz[:, None], ztx[:, None], zty[:, None]
    xtx, xty, yty, n = xtx[:, None], xty[:, None], yty[:, None], n[:, None]
    rhs_raw = torch.cat([zty[..., None], ztx], dim=-1)  # (cells, 1, M, p + 1)
    rhs, sol, logdet_v = joint_capacitance(theta, plan_shape, ztz, rhs_raw, dense=dense)
    return _joint_tail(rhs, sol, logdet_v, xtx, xty, yty, n, p, full)


def joint_reml_plain(ztz, ztx, zty, xtx, xty, yty, ns, plan_shape, theta0, lower,
                     theta=None, dense: bool = False, with_theta: bool = False):
    """The joint-Z REML fit per (sim, grid) cell from K2's joint statistics
    (the reference's ``_joint_grid_stats.per_grid``, :719-817), the plain
    version of kernel K11.

    ``ztz (..., Gn, M, M)``, ``ztx (..., Gn, M, p)``, ``zty (..., Gn, M)``,
    ``xtx``, ``xty``, ``yty`` f64, ``ns (Gn,)``, ``plan_shape`` ``[(levels,
    q)]`` per grouping, ``theta0``, ``lower`` ``(d,)`` from
    :func:`theta_layout`. Steps: the f32 twins of the statistics (a cast of
    the f64 prefix sums), JOINT_NM_ITERS Nelder-Mead iterations on the f32
    deviance (a non-finite one ranks as SENTINEL32), the f64 refit at the
    optimum. ``theta (..., Gn, d)`` f64, where given, replaces the search's
    optimum; ``dense=True`` takes the dense capacitance for an all-intercept
    plan too.

    Returns ``beta``, ``cov = sigma^2 (X'V^-1X)^-1``, ``converged``,
    ``boundary`` (any component pinned), ``tau2_hat = (Lam1 Lam1')[0, 0]
    sigma^2`` and ``pinned (..., Gn, sum q)``: diag(Lg) < JOINT_PIN, the
    primary's components first, then each extra grouping's; with
    ``with_theta`` also the optimum ``(..., Gn, d)``.
    """
    lead = yty.shape
    p = xtx.shape[-1]
    d = sum(q * (q + 1) // 2 for _, q in plan_shape)
    dev_ = yty.device
    flat = [v.reshape((-1,) + v.shape[len(lead):]) for v in (ztz, ztx, zty, xtx, xty, yty)]
    n64 = ns.to(device=dev_, dtype=torch.float64).expand(lead).reshape(-1)
    cells = n64.shape[0]
    theta0 = torch.as_tensor(theta0, dtype=torch.float64, device=dev_)
    lower = torch.as_tensor(lower, dtype=torch.float64, device=dev_)
    if theta is None:
        st32 = [v.to(torch.float32) for v in flat] + [n64.to(torch.float32)]

        def dev32(th):
            dv = joint_deviance(th.to(torch.float32), plan_shape, *st32, dense=dense)
            return torch.where(torch.isfinite(dv), dv, torch.full_like(dv, SENTINEL32)).double()

        theta_hat, _ = optim.nelder_mead(dev32, theta0.expand(cells, d), iters=SLOPE_NM_ITERS,
                                         init_step=SLOPE_NM_STEP, lower=lower)
    else:
        theta_hat = theta.to(device=dev_, dtype=torch.float64).reshape(cells, d)

    dev, beta, chol, sigma2 = (v[:, 0] for v in joint_deviance(theta_hat[:, None], plan_shape,
                                                                *flat, n64, full=True,
                                                                dense=dense))
    cov = sigma2[:, None, None] * smallchol.cho_inverse_auto(chol)
    l00 = theta_hat[:, 0]
    tau2_hat = (l00 * l00) * sigma2
    diag, off = [], 0
    for _, q in plan_shape:
        diag += [off + k for k in vech_diagonal(q)]
        off += q * (q + 1) // 2
    pinned = theta_hat[:, diag] < JOINT_PIN
    converged = (
        torch.isfinite(dev)
        & torch.isfinite(beta).all(-1)
        & (sigma2 > 0.0)
        & smallchol.chol_rank_ok(chol)
    )
    shape = lambda v, *tail: v.reshape(lead + tail)  # noqa: E731
    out = (shape(beta, p), shape(cov, p, p), shape(converged), shape(pinned.any(-1)),
           shape(tau2_hat), shape(pinned, len(diag)))
    return out + (shape(theta_hat, d),) if with_theta else out


_JOINT_ARGS = [
    ctypes.c_void_p,  # ztz (B, M, M) f64
    ctypes.c_void_p,  # ztx (B, M, p)
    ctypes.c_void_p,  # zty (B, M)
    ctypes.c_void_p,  # xtx (B, p, p)
    ctypes.c_void_p,  # xty (B, p)
    ctypes.c_void_p,  # yty (B,)
    ctypes.c_void_p,  # ns (Gn,) f64; cell c uses ns[c % Gn]
    ctypes.c_int,  # B
    ctypes.c_int,  # Gn
    ctypes.c_int,  # M
    ctypes.c_int,  # p
    ctypes.c_int,  # groupings
    ctypes.POINTER(ctypes.c_int),  # levels per grouping (host)
    ctypes.POINTER(ctypes.c_int),  # components per grouping (host)
    ctypes.POINTER(ctypes.c_double),  # theta0 (d,) host
    ctypes.POINTER(ctypes.c_double),  # lower (d,) host
    ctypes.c_int,  # Nelder-Mead iterations
    ctypes.c_double,  # initial step
    ctypes.c_double,  # eps_rank
    ctypes.c_int,  # force the dense capacitance
    ctypes.c_void_p,  # theta in (B, d) f64, or null: fit there, no search
    ctypes.c_void_p,  # beta out (B, p)
    ctypes.c_void_p,  # cov out (B, p, p)
    ctypes.c_void_p,  # tau2_hat out (B,)
    ctypes.c_void_p,  # flags out (B,) uint8: bit0 converged, bit1 boundary
    ctypes.c_void_p,  # pinned out (B, sum q) uint8
    ctypes.c_void_p,  # theta out (B, d) f64, or null
    ctypes.c_void_p,  # cudaStream_t
]


_JOINT_GEOMETRY_KEYS = ("structured", "warps_per_cell", "twin_staged", "smem", "static_smem",
                        "cells_per_sm", "waves", "twin_bytes", "registers", "local_bytes")


def joint_reml_geometry(ztz, ztx, zty, xtx, xty, yty, ns, plan_shape, theta0, lower,
                        dense: bool = False) -> Dict[str, int]:
    """The launch form K11's C launcher takes for :func:`joint_reml_kernel`'s
    arguments: the capacitance's form, warps a cell (the search's candidates
    at once), whether the f32 twin of the statistics is staged in shared
    memory, the dynamic and static shared bytes a block, resident cells an
    SM, the launch's waves, the twin's bytes, and the kernel's registers and
    local (spill and stack) bytes a thread. Builds and loads K11; needs a
    CUDA device."""
    levels = [int(m) for m, _ in plan_shape]
    comps = [int(q) for _, q in plan_shape]
    fn = kernels.KERNELS["joint_reml"].fn(
        "mcp_joint_reml_geometry", [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 2
        + [ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    out = (ctypes.c_int * len(_JOINT_GEOMETRY_KEYS))()
    ng = len(levels)
    err = fn(int(yty.numel()), int(ztz.shape[-1]), int(xtx.shape[-1]), ng,
             (ctypes.c_int * ng)(*levels), (ctypes.c_int * ng)(*comps), int(dense), out)
    if err:
        raise RuntimeError(f"mcp_joint_reml_geometry: CUDA error {err}")
    return dict(zip(_JOINT_GEOMETRY_KEYS, out))


def joint_reml_kernel(ztz, ztx, zty, xtx, xty, yty, ns, plan_shape, theta0, lower,
                      theta=None, dense: bool = False, with_theta: bool = False):
    """Kernel K11: :func:`joint_reml_plain` on the card (the same optional
    arguments), a (sim, grid) cell a block of up to four warps, the search's
    candidates at once (:func:`joint_reml_geometry`)."""
    M, p, Gn = ztz.shape[-1], xtx.shape[-1], xtx.shape[-3]
    levels = [m for m, _ in plan_shape]
    comps = [q for _, q in plan_shape]
    d = sum(q * (q + 1) // 2 for q in comps)
    if (sum(m * q for m, q in plan_shape) != M or not 1 <= p <= MAX_P or M > JOINT_MAX_M
            or d > JOINT_MAX_D or len(plan_shape) > JOINT_MAX_GROUPINGS):
        raise ValueError(f"joint_reml kernel takes M <= {JOINT_MAX_M} (the plan's), p <= "
                         f"{MAX_P}, d <= {JOINT_MAX_D}; got M {M}, p {p}, d {d}")
    lead = yty.shape
    ztz, ztx, zty, xtx, xty, yty, ns = (
        v.to(torch.float64).contiguous() for v in (ztz, ztx, zty, xtx, xty, yty, ns)
    )
    if (ztz.shape != lead + (M, M) or ztx.shape != lead + (M, p) or zty.shape != lead + (M,)
            or xtx.shape != lead + (p, p) or xty.shape != lead + (p,) or ns.shape != (Gn,)):
        raise ValueError("joint_reml: inconsistent shapes")
    theta0 = np.asarray(theta0, dtype=np.float64).reshape(d)
    lower = np.asarray(lower, dtype=np.float64).reshape(d)
    B, ng, nq = yty.numel(), len(plan_shape), sum(comps)
    kw = dict(dtype=torch.float64, device=xtx.device)
    beta = torch.empty(lead + (p,), **kw)
    cov = torch.empty(lead + (p, p), **kw)
    tau2 = torch.empty(lead, **kw)
    flags = torch.empty(lead, dtype=torch.uint8, device=xtx.device)
    pinned = torch.empty(lead + (nq,), dtype=torch.uint8, device=xtx.device)
    theta_out = torch.empty(lead + (d,), **kw)
    if theta is not None:
        theta = theta.to(**kw).reshape(lead + (d,)).contiguous()
    kernels.require_cuda("joint_reml", ztz, ztx, zty, xtx, xty, yty, ns, beta, cov, tau2, flags,
                         pinned, theta_out, *(() if theta is None else (theta,)))
    if B:
        k = kernels.KERNELS["joint_reml"]
        fn = k.fn("mcp_joint_reml", _JOINT_ARGS)
        k.check(
            fn(
                kernels.ptr(ztz), kernels.ptr(ztx), kernels.ptr(zty), kernels.ptr(xtx),
                kernels.ptr(xty), kernels.ptr(yty), kernels.ptr(ns), B, Gn, M, p, ng,
                (ctypes.c_int * ng)(*levels), (ctypes.c_int * ng)(*comps),
                (ctypes.c_double * d)(*theta0), (ctypes.c_double * d)(*lower),
                SLOPE_NM_ITERS, SLOPE_NM_STEP, smallchol.EPS_RANK, int(dense),
                ctypes.c_void_p(0) if theta is None else kernels.ptr(theta),
                kernels.ptr(beta), kernels.ptr(cov), kernels.ptr(tau2), kernels.ptr(flags),
                kernels.ptr(pinned), kernels.ptr(theta_out), kernels.stream_of(xtx),
            )
        )
    out = (beta, cov, (flags & 1).bool(), (flags & 2).bool(), tau2, pinned.bool())
    return out + (theta_out,) if with_theta else out


def joint_reml(ztz, ztx, zty, xtx, xty, yty, ns, plan_shape, theta0, lower):
    """K11 for CUDA tensors, the plain version for CPU tensors."""
    if xtx.is_cuda:
        return joint_reml_kernel(ztz, ztx, zty, xtx, xty, yty, ns, plan_shape, theta0, lower)
    if xtx.device.type != "cpu":
        raise ValueError(f"joint_reml: no kernel for device {xtx.device}")
    return joint_reml_plain(ztz, ztx, zty, xtx, xty, yty, ns, plan_shape, theta0, lower)


# ---------------------------------------------------------------------------
# The arm
# ---------------------------------------------------------------------------


def mixed_grid_stats(spec: SimSpec, X: torch.Tensor, y: torch.Tensor, *,
                     plain: bool = False) -> Dict[str, torch.Tensor]:
    """All LMM statistics for a batch of sims across the grid: the
    random-intercept branch of the reference's ``mixed_grid_stats`` (K2 and
    K4) or, with random slopes, its slope branch (K2's slope mode and K9;
    ``pinned_comp`` is then per component).

    ``plain=True`` runs the plain PyTorch versions of the kernels on any
    device (used to time and check the kernels against them).
    """
    c = spec.cluster
    if c is None:
        raise ValueError("mle estimator requires a cluster spec")
    ns = torch.as_tensor(spec.grid, dtype=torch.float64, device=X.device)
    if c.extra_groupings:  # the joint-Z capacitance, K2's joint mode and K11
        plan = grouping_plan(spec)
        suff = (olsfit.joint_suffstats_plain if plain else olsfit.joint_suffstats)(spec, X, y)
        _, theta0, lower = theta_layout(plan)
        shape = [(n_lv, q) for n_lv, q, _, _, _ in plan]
        beta, cov, converged, boundary, tau2_hat, pinned = (
            joint_reml_plain if plain else joint_reml
        )(suff["ztz"], suff["ztx"], suff["zty"], suff["xtx"], suff["xty"], suff["yty"], ns,
          shape, theta0, lower)
        return _assemble_outputs(spec, beta, cov, converged, boundary, tau2_hat, pinned)
    if c.slopes:  # the q-dimensional theta search, kernel K9
        suff = (olsfit.grid_suffstats_plain if plain else olsfit.grid_suffstats)(
            spec, X, y, with_slopes=True
        )
        theta0, lower = slope_start(spec)
        beta, cov, converged, boundary, tau2_hat, pinned = (
            slope_reml_plain if plain else slope_reml
        )(suff["G"], suff["A"], suff["b"], suff["xtx"], suff["xty"], suff["yty"], ns, theta0,
          lower)
        return _assemble_outputs(spec, beta, cov, converged, boundary, tau2_hat, pinned)
    suff = (olsfit.grid_suffstats_plain if plain else olsfit.grid_suffstats)(
        spec, X, y, with_clusters=True
    )
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
