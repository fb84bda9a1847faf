"""Batched random-intercept GLMM: penalized IRLS, Laplace or adaptive
Gauss-Hermite deviance, and a warm-carried Brent search over log tau^2.

The port of ``mcpower_tpu.engine.glmmfit``'s random-intercept arm
(``_intercept_glmm_grid_stats``, :909-1264) for logit, probit and Poisson
outcomes. For fixed tau^2 the joint (beta, u) mode comes from PIRLS with u
absorbed per cluster (u_i = c_i (t_i - s_i' beta), c_i = 1 / (W_i +
1/tau^2)), so a step is per-cluster sums and a p x p Schur solve. The
search over log tau^2 in [-14, 7] is the reference's two-phase Brent: a cold
f64 first evaluation, 6 evaluations of f32 PIRLS at 12 iterations and 8 at
5, each carrying (beta, u) from the last evaluation, the deviance always in
f64 from the mode (AGQ: an f64 centre node plus f32 node deltas). Then the
f64 fit at the optimum, the tau^2 = 0 probe, the final fit and its Schur
covariance, or under ``wald_se="hessian"`` the covariance from central
differences of the beta-profiled Laplace deviance.

On the card the whole per-cell fit is kernel K7 (``csrc/glmm_intercept.cu``:
one to four warps a (sim, grid) cell, its rows spread over its threads and
its cluster sums taken by its first warp, a lane per cluster).
:func:`glmm_intercept_plain` is its plain PyTorch version, with the sim and
grid axes as batch axes. Both sum every row quantity the same way: first
over each cluster's rows in row order, then over clusters as K7's lanes hold
them (lane l takes clusters l, l + 32, ... in turn, then the lanes combine
in ``smallchol.lane_sum``'s pair tree), so that the two perform the same
operations in the same order and agree bit for bit on the card.

Random slopes take :func:`glmm_slope`: the reference's
``_slope_glmm_grid_stats`` (:556-906), a warm-carried Nelder-Mead over the
q-dimensional theta on f32 PIRLS modes and their Laplace deviance, then the
f64 fit, the pin probes and the FD Hessian; on the card kernel K10
(``csrc/glmm_slope.cu``, a cell a block, the four candidates of an
iteration on its four warps), :func:`glmm_slope_plain` its plain version.

Extra groupings (crossed or nested) take :func:`glmm_extras`: the
reference's ``_extras_glmm_grid_stats`` (:155-553), a warm-carried
Nelder-Mead over every grouping's vech-Cholesky on f32 joint-Z PIRLS modes
and their Laplace deviance, each pass through the joint capacitance (the
structured Schur complement of the extras block when every grouping is
intercept-only, the dense M x M factor otherwise: ``mixedfit.
joint_capacitance``), then the f64 fit and the Schur or FD Hessian
covariance; on the card kernel K12 (``csrc/glmm_extras.cu``, a cell a
block, the four candidates on its four warps), :func:`glmm_extras_plain` its
plain version. Their row sums follow one fixed order (:class:`_JointCells`).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from . import kernels, optim, smallchol, waldstats
from .glmfit import LINK_POISSON, MU_EPS, _deviance_terms, _mu_var_dmu, link_code
from .mixedfit import (BOUNDARY_LOG_GAMMA, LOG_GAMMA_HI, LOG_GAMMA_LO, _CGOLD, _brent_minimize,
                       _contract_rows, _ordered_sum, grouping_plan, joint_capacitance, joint_width,
                       theta_layout, vech_diagonal, vech_to_lower)
from .olsfit import joint_layout
from .spec import SimSpec

# The reference's budgets and their reasoning (glmmfit.py:45-60): PIRLS
# iterations of the cold, probe and final fits and of the first Brent phase,
# of the warm second phase, and the split of the 14 Brent steps.
N_PIRLS = 12
N_PIRLS_WARM = 5
BRENT_FULL_GLMM = 6
BRENT_ITERS_GLMM = 14
# FD Hessian: step in beta and u-Newton passes per evaluation (:65, :1215).
HESSIAN_STEP = 1e-4
N_U_NEWTON = 20
# K7's limits (datagen.unsupported names them before any run): quadrature
# nodes, whose values K7 keeps per cluster, and clusters. A cell whose
# clusters, rows and width outgrow K7's shared-memory plan (1,024 clusters,
# say) takes its streamed path, with its state in a device scratch that
# ``glmm_intercept_geometry`` sizes.
MAX_AGQ = 25
MAX_CLUSTERS = 1024
MAX_P = kernels.MAX_FIT_P

_LOG_2PI = 1.8378770664093453
_SQRT2 = math.sqrt(2.0)


def _tri(p: int):
    """(a, b), b <= a, in packed lower-triangle order."""
    return [(a, b) for a in range(p) for b in range(a + 1)]


def gh_nodes(nagq: int):
    """Gauss-Hermite nodes (physicists' weight e^{-x^2}) for AGQ, from
    numpy on the host as the reference takes them (:1020-1028): ``x``,
    ``log w``, the centre node ``k0`` and the search's f32 node offsets
    ``dw = ((log w + x^2) - log w[k0]) - x[k0]^2``."""
    x, w = np.polynomial.hermite.hermgauss(nagq)
    lw = np.log(w)
    k0 = int(np.argmin(np.abs(x)))
    dw = ((lw + x ** 2) - lw[k0]) - x[k0] ** 2
    return x, lw, k0, dw.astype(np.float32)


# ---------------------------------------------------------------------------
# The plain version of K7
# ---------------------------------------------------------------------------


class _Cells:
    """The (sim, grid) cells of one launch in the plain version's layout:
    ``X (S, 1, n, p)`` in f64 and f32, ``y (S, 1, n)``, the row mask ``(G,
    n)`` and the active clusters ``(G, m)``; with ``zcols`` (the slope
    path) also ``Z (S, 1, n, q)``, a column of ones and then X's columns
    ``zcols``."""

    def __init__(self, code: int, X, y, fit, grid, layout, zcols=None):
        self.code = code
        self.rr, self.period, self.m = layout
        max_n = X.shape[1]
        Xf = X[..., list(fit)]
        self.X = {torch.float64: Xf.to(torch.float64)[:, None],
                  torch.float32: Xf.to(torch.float32)[:, None]}
        self.y = {torch.float64: y.to(torch.float64)[:, None],
                  torch.float32: y.to(torch.float32)[:, None]}
        rows = torch.arange(max_n, device=X.device)
        ns = torch.as_tensor(list(grid), device=X.device)
        mask = (rows < ns[:, None]).to(torch.float64)
        self.mask = {torch.float64: mask, torch.float32: mask.to(torch.float32)}
        self.active = self.seg(mask) > 0.0  # (G, m)
        self.ns = ns.to(torch.float64)
        self.p = Xf.shape[-1]
        if zcols is not None:
            Z = torch.cat([torch.ones_like(X[..., :1]), X[..., list(zcols)]], dim=-1)
            self.Z = {torch.float64: Z.to(torch.float64)[:, None],
                      torch.float32: Z.to(torch.float32)[:, None]}

    def seg(self, v: torch.Tensor) -> torch.Tensor:
        """(..., n) -> (..., m): each cluster's rows added in row order."""
        if self.rr:  # row r in cluster r % m
            b = v.reshape(*v.shape[:-1], -1, self.m)
            acc = torch.zeros_like(b[..., 0, :])
            for k in range(b.shape[-2]):
                acc = acc + b[..., k, :]
            return acc
        b = v.reshape(*v.shape[:-1], self.m, self.period)  # rows of cluster j: a block
        acc = torch.zeros_like(b[..., 0])
        for k in range(self.period):
            acc = acc + b[..., k]
        return acc

    def lanes(self, v: torch.Tensor) -> torch.Tensor:
        """(..., m) -> (...): the sum over clusters in K7's lane order."""
        pad = -self.m % smallchol.LANES
        return smallchol.lane_sum(torch.nn.functional.pad(v, (0, pad)))

    def per_row(self, u: torch.Tensor) -> torch.Tensor:
        """(..., m) -> (..., n): each row's cluster value."""
        n = self.mask[torch.float64].shape[-1]
        if self.rr:
            return u.repeat(*([1] * (u.dim() - 1)), n // self.m)
        return u.repeat_interleave(self.period, dim=-1)

    def where_active(self, v: torch.Tensor) -> torch.Tensor:
        return torch.where(self.active, v, torch.zeros_like(v))


def _cols_dot(s: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., p, m) x (..., p) -> (..., m), the columns added in turn."""
    out = torch.zeros_like(s[..., 0, :])
    for a in range(s.shape[-2]):
        out = out + s[..., a, :] * b[..., a:a + 1]
    return out


def _loglik_rows(code: int, y: torch.Tensor, eta: torch.Tensor) -> torch.Tensor:
    """Per-row conditional log-likelihood (the reference's ``_loglik_rows``,
    :108): binomial ``log mu`` or ``log(1 - mu)`` by y (the reference's y
    log mu + (1 - y) log(1 - mu) at y in {0, 1}), Poisson ``y eta - e^eta``
    at the clipped eta."""
    if code == LINK_POISSON:
        eta_c = torch.clamp(eta, -30.0, 30.0)
        return y * eta_c - torch.exp(eta_c)
    mu = _mu_var_dmu(code, eta)[0]
    return torch.where(y > 0.5, torch.log(mu), torch.log(1.0 - mu))


def _schur(cells: _Cells, A, ss, ridge):
    """a_xx = (X'WX - sum c s s') + ridge I from the lane sums, ``A`` and
    ``ss`` packed ``(..., NT)``."""
    p = cells.p
    M = A.new_zeros(A.shape[:-1] + (p, p))
    for k, (i, j) in enumerate(_tri(p)):
        v = A[..., k] - ss[..., k]
        if i == j:
            v = v + ridge
        M[..., i, j] = M[..., j, i] = v
    return M


def _step_sums(cells: _Cells, dtype, beta, u, inv_tau2):
    """One PIRLS step's sums at (beta, u): per-cluster s, t and c, and the
    lane sums of X'WX, X'Wz, sum c s s' and sum c s t. Every divisor is a
    tensor: torch divides by a Python number through its reciprocal."""
    p, tri = cells.p, _tri(cells.p)
    X, y, mask = cells.X[dtype], cells.y[dtype], cells.mask[dtype]
    eta = smallchol.rowmv(X, beta) + cells.per_row(u)
    mu, var, dmu = _mu_var_dmu(cells.code, eta)
    w = dmu * dmu / torch.clamp(var, min=MU_EPS) * mask
    z = eta + (y - mu) / dmu
    wz = w * z
    xs = [X[..., a].expand_as(w) for a in range(p)]
    q = [w] + [w * xa for xa in xs] + [wz] + [(xs[a] * w) * xs[b] for a, b in tri] \
        + [xa * wz for xa in xs]
    q = cells.seg(torch.stack(q, dim=-2))  # (..., K, m)
    W, s, t = q[..., 0, :], q[..., 1:1 + p, :], q[..., 1 + p, :]
    c = cells.where_active(torch.ones_like(W) / (W + inv_tau2[..., None]))
    cs = [c * s[..., a, :] for a in range(p)]
    per = torch.cat([q[..., 2 + p:, :],
                     torch.stack([cs[a] * s[..., b, :] for a, b in tri]
                                 + [cs[a] * t for a in range(p)], dim=-2)], dim=-2)
    sums = cells.lanes(per)  # (..., 2 NT + 2p)
    nt = len(tri)
    return (s, t, c), sums[..., :nt], sums[..., nt:nt + p], sums[..., nt + p:2 * nt + p], \
        sums[..., 2 * nt + p:]


def _pirls(cells: _Cells, dtype, tau2, beta, u, iters: int):
    """``iters`` PIRLS steps in ``dtype`` from (beta, u), a cell frozen on a
    step that is not finite (the reference's ``make_pirls``, :947-1013);
    then in f64 at the mode the row weights' cluster sums ``W (..., m)`` and
    the Laplace deviance. ``tau2 (...)`` f64."""
    inv64 = torch.ones_like(tau2) / torch.clamp(tau2, min=1e-12)
    inv = inv64.to(dtype)
    ridge = torch.tensor(1e-10 if dtype == torch.float64 else 1e-6, dtype=dtype,
                         device=beta.device)
    for _ in range(iters):
        (s, t, c), A, b, ss, st = _step_sums(cells, dtype, beta, u, inv)
        beta_new = smallchol.cho_solve(smallchol.chol(_schur(cells, A, ss, ridge)), b - st)
        u_new = c * (t - _cols_dot(s, beta_new))
        ok = torch.isfinite(beta_new).all(-1) & torch.isfinite(u_new).all(-1)
        beta = torch.where(ok[..., None], beta_new, beta)
        u = torch.where(ok[..., None], u_new, u)
    W, dev_cond = _tail(cells, beta.to(torch.float64), u.to(torch.float64))
    u64 = u.to(torch.float64)
    laplace = (dev_cond + cells.lanes(cells.where_active(u64 * u64)) * inv64
               + cells.lanes(cells.where_active(torch.log1p(tau2[..., None] * W))))
    return beta, u, W, laplace


def _tail(cells: _Cells, beta, u):
    """f64 at (beta, u): the cluster sums of the row weights and the
    conditional deviance."""
    X, y, mask = cells.X[torch.float64], cells.y[torch.float64], cells.mask[torch.float64]
    eta = smallchol.rowmv(X, beta) + cells.per_row(u)
    mu, var, dmu = _mu_var_dmu(cells.code, eta)
    w = dmu * dmu / torch.clamp(var, min=MU_EPS) * mask
    dt = _deviance_terms(cells.code, y.expand_as(mu), mu) * mask
    q = cells.seg(torch.stack([w, dt], dim=-2))
    return q[..., 0, :], 2.0 * cells.lanes(q[..., 1, :])


def _logsumexp(v: torch.Tensor) -> torch.Tensor:
    """log sum exp over axis -2 (nodes): the max, then the exponentials
    added in node order."""
    mx = v.amax(-2)
    acc = torch.zeros_like(mx)
    for k in range(v.shape[-2]):
        acc = acc + torch.exp(v[..., k, :] - mx)
    return torch.log(acc) + mx


def _agq_deviance(cells: _Cells, gh, tau2, beta, u, W):
    """-2 sum_i log of the adaptive-GH integral at the mode, all in f64 (the
    reference's ``agq_deviance``, :1030)."""
    x, lw = gh
    inv = (torch.ones_like(tau2) / torch.clamp(tau2, min=1e-12))[..., None]
    sigma = torch.ones_like(W) / torch.sqrt(W + inv)  # (..., m)
    ss = _SQRT2 * sigma
    lp = smallchol.rowmv(cells.X[torch.float64], beta)
    u_k = u[..., None, :] + ss[..., None, :] * x[:, None]  # (..., k, m)
    eta = lp[..., None, :] + cells.per_row(u_k)
    ll = _loglik_rows(cells.code, cells.y[torch.float64][..., None, :], eta) \
        * cells.mask[torch.float64][:, None, :]
    ll_i = cells.seg(ll)  # (..., k, m)
    logt = torch.log(torch.clamp(tau2, min=1e-12))[..., None, None]
    prior = (-0.5 * (u_k * u_k)) * inv[..., None] - 0.5 * (logt + _LOG_2PI)
    stacked = ((lw + x * x)[:, None] + ll_i) + prior
    log_int = _logsumexp(stacked) + torch.log(ss)
    return -2.0 * cells.lanes(cells.where_active(log_int))


def _agq_deviance_hybrid(cells: _Cells, gh, dw32, k0: int, tau2, beta, u, W):
    """The search's AGQ deviance: an f64 centre node plus f32 node deltas
    (the reference's ``agq_deviance_hybrid``, :1053); ``beta``, ``u`` the
    f64 casts of the f32 mode, ``W`` its f64 cluster weights."""
    x, lw = gh
    f32 = torch.float32
    inv = (torch.ones_like(tau2) / torch.clamp(tau2, min=1e-12))[..., None]
    sigma = torch.ones_like(W) / torch.sqrt(W + inv)
    ss = _SQRT2 * sigma
    y64, m64 = cells.y[torch.float64], cells.mask[torch.float64]
    eta_c = smallchol.rowmv(cells.X[torch.float64], beta) + cells.per_row(u)
    ll_c = cells.lanes(cells.seg(_loglik_rows(cells.code, y64, eta_c) * m64))
    logt = torch.log(torch.clamp(tau2, min=1e-12))[..., None]
    prior_c = (-0.5 * (u * u)) * inv - 0.5 * (logt + _LOG_2PI)
    s0 = ((lw[k0] + x[k0] * x[k0]) + prior_c) + torch.log(ss)
    eta_c32 = eta_c.to(f32)
    y32, m32 = cells.y[f32], cells.mask[f32]
    shift = ss.to(f32)[..., None, :] * x.to(f32)[:, None]  # (..., k, m)
    eta_k = eta_c32[..., None, :] + cells.per_row(shift)
    dll = (_loglik_rows(cells.code, y32[..., None, :], eta_k)
           - _loglik_rows(cells.code, y32, eta_c32)[..., None, :]) * m32[:, None, :]
    dll_i = cells.seg(dll)
    u32 = u.to(f32)[..., None, :]
    uk = u32 + shift
    dprior = (-0.5 * (uk * uk - u32 * u32)) * inv.to(f32)[..., None]
    delta = (dw32[:, None] + dll_i) + dprior
    lse = _logsumexp(delta).to(torch.float64)
    return -2.0 * (cells.lanes(cells.where_active(s0 + lse)) + ll_c)


def _final_stats(cells: _Cells, beta, u, tau2):
    """The f64 fit's Schur complement at the mode, ridged and unridged:
    ``(X'WX - sum c s s') + 1e-10 I`` and that less the ridge."""
    p, tri = cells.p, _tri(cells.p)
    X, y, mask = cells.X[torch.float64], cells.y[torch.float64], cells.mask[torch.float64]
    eta = smallchol.rowmv(X, beta) + cells.per_row(u)
    mu, var, dmu = _mu_var_dmu(cells.code, eta)
    w = dmu * dmu / torch.clamp(var, min=MU_EPS) * mask
    xs = [X[..., a].expand_as(w) for a in range(p)]
    q = cells.seg(torch.stack([w] + [w * xa for xa in xs] + [(xs[a] * w) * xs[b] for a, b in tri],
                              dim=-2))
    W, s = q[..., 0, :], q[..., 1:1 + p, :]
    inv = torch.ones_like(tau2) / torch.clamp(tau2, min=1e-12)
    c = cells.where_active(torch.ones_like(W) / (W + inv[..., None]))
    cs = [c * s[..., a, :] for a in range(p)]
    per = torch.cat([q[..., 1 + p:, :], torch.stack([cs[a] * s[..., b, :] for a, b in tri], -2)],
                    dim=-2)
    sums = cells.lanes(per)
    nt = len(tri)
    ridge = torch.tensor(1e-10, dtype=torch.float64, device=beta.device)
    a_xx = _schur(cells, sums[..., :nt], sums[..., nt:], ridge)
    return a_xx, a_xx - torch.diag_embed(ridge.expand(p))


def _dev_beta(cells: _Cells, beta_q, u, tau2c):
    """The beta-profiled Laplace deviance at ``beta_q (..., V, p)`` (the
    reference's ``dev_beta``, :1215-1235): u re-optimised from the mode's
    ``u (..., m)`` by N_U_NEWTON u-only Newton passes."""
    X, y, mask = cells.X[torch.float64], cells.y[torch.float64], cells.mask[torch.float64]
    X, y, mask = X[:, :, None], y[:, :, None], mask[:, None]
    tc = tau2c[..., None, None]  # (..., 1, 1)
    inv = torch.ones_like(tc) / tc
    lp = smallchol.rowmv(X, beta_q)  # (..., V, n)
    u_q = u[..., None, :].expand(lp.shape[:-1] + (cells.m,))
    for _ in range(N_U_NEWTON):
        eta = lp + cells.per_row(u_q)
        mu, var, dmu = _mu_var_dmu(cells.code, eta)
        w = dmu * dmu / torch.clamp(var, min=MU_EPS) * mask
        r = (y - mu) * mask
        q = cells.seg(torch.stack([r, w], dim=-2))
        g = q[..., 0, :] - u_q / tc
        h = q[..., 1, :] + inv
        u_q = torch.where(cells.active[:, None], u_q + g / h, torch.zeros_like(u_q))
    eta = lp + cells.per_row(u_q)
    mu, var, dmu = _mu_var_dmu(cells.code, eta)
    w = dmu * dmu / torch.clamp(var, min=MU_EPS) * mask
    dt = _deviance_terms(cells.code, y.expand_as(mu), mu) * mask
    q = cells.seg(torch.stack([w, dt], dim=-2))
    act = cells.active[:, None]
    zero = torch.zeros_like(u_q)
    return (2.0 * cells.lanes(q[..., 1, :])
            + cells.lanes(torch.where(act, u_q * u_q, zero)) / tc[..., 0]
            + cells.lanes(torch.where(act, torch.log1p(tc * q[..., 0, :]), zero)))


def hessian_offsets(p: int) -> np.ndarray:
    """The central stencil of ``_fd_hessian_cov`` (:65): 0, +-e_i, then
    (+e_i +e_j, +e_i -e_j, -e_i +e_j, -e_i -e_j) per pair i < j."""
    eye = np.eye(p)
    offs = [np.zeros(p)]
    for i in range(p):
        offs.extend([eye[i], -eye[i]])
    for i in range(p):
        for j in range(i + 1, p):
            offs.extend([eye[i] + eye[j], eye[i] - eye[j], -eye[i] + eye[j], -eye[i] - eye[j]])
    return np.array(offs)


def _fd_hessian_cov(cells: _Cells, beta, u, tau2c, cov_fallback):
    """cov = 2 H^-1 from central differences of the profiled deviance,
    the rx covariance where that is not finite (:65-105)."""
    offs = torch.as_tensor(hessian_offsets(beta.shape[-1]) * HESSIAN_STEP, dtype=torch.float64,
                           device=beta.device)
    vals = _dev_beta(cells, beta[..., None, :] + offs, u, tau2c)  # (..., V)
    return _stencil_cov(vals, beta, cov_fallback)


def _stencil_cov(vals, beta, cov_fallback):
    """cov = 2 H^-1 from the profiled deviances ``vals (..., V)`` at the
    stencil points of :func:`hessian_offsets`."""
    p = beta.shape[-1]
    h = HESSIAN_STEP
    f0 = vals[..., 0]
    H = beta.new_zeros(beta.shape[:-1] + (p, p))
    hh = torch.full_like(f0, h * h)
    for i in range(p):
        H[..., i, i] = ((vals[..., 1 + 2 * i] - 2.0 * f0) + vals[..., 2 + 2 * i]) / hh
    base = 1 + 2 * p
    hh4 = torch.full_like(f0, 4.0 * h * h)
    k = 0
    for i in range(p):
        for j in range(i + 1, p):
            v = vals[..., base + 4 * k:base + 4 * k + 4]
            hij = (((v[..., 0] - v[..., 1]) - v[..., 2]) + v[..., 3]) / hh4
            H[..., i, j] = H[..., j, i] = hij
            k += 1
    eye = torch.diag_embed(torch.full_like(beta, 1e-10))
    cov_h = 2.0 * smallchol.cho_inverse(smallchol.chol(H + eye))
    ok = torch.isfinite(cov_h).flatten(-2).all(-1)
    return torch.where(ok[..., None, None], cov_h, cov_fallback)


def glmm_intercept_plain(code: int, X: torch.Tensor, y: torch.Tensor, fit: Sequence[int],
                         grid: Sequence[int], layout: Tuple[bool, int, int],
                         beta0: torch.Tensor, nagq: int = 1, hessian: bool = False,
                         log_tau2: torch.Tensor = None):
    """Every (sim, grid) cell's random-intercept GLMM fit.

    ``X (sims, max_n, P)`` and ``y (sims, max_n)`` f32; ``fit`` the pf fit
    columns; ``grid`` G ascending row counts; ``layout`` (round robin, its
    period, m clusters at max_n); ``beta0 (pf,)`` f64, the start of every
    cell; ``nagq`` 1 (Laplace) or the AGQ nodes; ``hessian`` the FD Wald
    covariance; ``log_tau2 (sims, G)``, where given, replaces the search's
    optimum (the cold first evaluation's carry then starts the fit), to hold
    the fit apart from the search. Returns f64 ``beta (sims, G, pf)``, ``cov (sims, G, pf,
    pf)``, bool ``converged`` and ``boundary (sims, G)``, f64 ``tau2_hat``
    and ``ybar (sims, G)``.
    """
    cells = _Cells(code, X, y, fit, grid, layout)
    sims, G, pf, m = X.shape[0], len(grid), len(fit), cells.m
    dev_ = X.device
    f64, f32 = torch.float64, torch.float32
    if nagq > 1:
        x, lw, k0, dw = gh_nodes(nagq)
        gh = (torch.as_tensor(x, dtype=f64, device=dev_), torch.as_tensor(lw, dtype=f64, device=dev_))
        dw32 = torch.as_tensor(dw, device=dev_)

    def dev_at(lt, beta, u, iters):
        tau2 = torch.exp(lt.to(dev_)).expand(sims, G)
        beta, u, W, lap = _pirls(cells, f64, tau2, beta, u, iters)
        if nagq > 1:
            lap = _agq_deviance(cells, gh, tau2, beta, u, W)
        return lap, beta, u

    def dev_at32(lt, beta, u, iters):
        tau2 = torch.exp(lt.to(dev_)).expand(sims, G)
        beta, u, W, lap = _pirls(cells, f32, tau2, beta, u, iters)
        if nagq > 1:
            lap = _agq_deviance_hybrid(cells, gh, dw32, k0, tau2, beta.to(f64), u.to(f64), W)
        return lap, beta, u

    beta_start = beta0.to(device=dev_, dtype=f64).expand(sims, G, pf)
    u_start = torch.zeros((sims, G, m), dtype=f64, device=dev_)

    def init_eval(lt, _aux):
        f, b, u = dev_at(lt, beta_start, u_start, N_PIRLS)
        return f, (b.to(f32), u.to(f32))

    def make_eval(iters):
        def ev(lt, aux):
            f, b, u = dev_at32(lt, aux[0], aux[1], iters)
            return f, (b, u)
        return ev

    lt_hat, _, (beta_c, u_c) = _brent_minimize(
        LOG_GAMMA_LO, LOG_GAMMA_HI, (None, None),
        ((BRENT_FULL_GLMM, make_eval(N_PIRLS)),
         (BRENT_ITERS_GLMM - BRENT_FULL_GLMM, make_eval(N_PIRLS_WARM))),
        init_eval=init_eval) if log_tau2 is None else (log_tau2.to(dev_), None, init_eval(
            torch.tensor(LOG_GAMMA_LO + _CGOLD * (LOG_GAMMA_HI - LOG_GAMMA_LO), dtype=f64),
            None)[1])
    dev_int, beta_c, u_c = dev_at(lt_hat, beta_c.to(f64), u_c.to(f64), N_PIRLS)
    lo = torch.tensor(LOG_GAMMA_LO, dtype=f64, device=dev_)
    dev_zero, _, _ = dev_at(lo, beta_c, u_c, N_PIRLS)
    boundary = (dev_zero <= dev_int + 1e-10) | (lt_hat < BOUNDARY_LOG_GAMMA)
    tau2_hat = torch.where(boundary, torch.zeros_like(lt_hat), torch.exp(lt_hat))
    tau2c = torch.clamp(tau2_hat, min=1e-12)

    beta, u, _, _ = _pirls(cells, f64, tau2c, beta_c, u_c, N_PIRLS)
    a_xx, raw = _final_stats(cells, beta, u, tau2c)
    chol = smallchol.chol(a_xx)
    cov = smallchol.cho_inverse(chol)
    if hessian:
        cov = _fd_hessian_cov(cells, beta, u, tau2c, cov)
    converged = (torch.isfinite(beta).all(-1) & smallchol.chol_ok(chol)
                 & smallchol.rank_ok(raw) & torch.isfinite(dev_int))
    ysum = cells.lanes(cells.seg(cells.y[f64] * cells.mask[f64]))
    ybar = ysum / cells.ns
    return beta, cov, converged, boundary, tau2_hat, ybar


# ---------------------------------------------------------------------------
# K7 on the card
# ---------------------------------------------------------------------------

_GLMM_ARGS = [
    ctypes.c_void_p,  # X (sims, max_n, P) f32
    ctypes.c_void_p,  # y (sims, max_n) f32
    ctypes.c_int,  # sims
    ctypes.c_int,  # max_n
    ctypes.c_int,  # P
    ctypes.POINTER(ctypes.c_int),  # fit columns (host)
    ctypes.c_int,  # pf
    ctypes.c_void_p,  # grid (G,) int32, device
    ctypes.c_int,  # G
    ctypes.c_int,  # round robin (1) or blocked (0)
    ctypes.c_int,  # period: m (round robin) or the cluster size (blocked)
    ctypes.c_int,  # m
    ctypes.c_int,  # link code
    ctypes.c_void_p,  # beta0 (pf,) f64, device
    ctypes.c_int,  # nagq
    ctypes.POINTER(ctypes.c_double),  # gh x (nagq,) host
    ctypes.POINTER(ctypes.c_double),  # gh log w (nagq,) host
    ctypes.POINTER(ctypes.c_float),  # gh dw (nagq,) f32 host
    ctypes.c_int,  # k0
    ctypes.c_int,  # hessian
    ctypes.c_void_p,  # scratch: glmm_intercept_geometry's bytes, or null (the staged path)
    ctypes.c_void_p,  # beta out (sims, G, pf) f64
    ctypes.c_void_p,  # cov out (sims, G, pf, pf) f64
    ctypes.c_void_p,  # tau2_hat out (sims, G) f64
    ctypes.c_void_p,  # ybar out (sims, G) f64
    ctypes.c_void_p,  # flags out (sims, G) uint8: bit0 converged, bit1 boundary
    ctypes.c_void_p,  # cudaStream_t
]

_GEOMETRY_KEYS = ("cells_per_sm", "threads", "smem", "staged", "warps_per_cell",
                  "cells_per_block", "waves", "blocks")


def glmm_intercept_geometry(sims: int, max_n: int, pf: int, G: int, m: int, nagq: int = 1,
                            hessian: bool = False) -> Dict[str, int]:
    """The launch geometry K7's C launcher takes for a shape: cells
    resident per SM, threads and dynamic shared memory a block, the staged
    (1) or streamed (0) path, warps a cell, cells a block, waves on the card,
    blocks, and ``scratch`` the bytes of device scratch the launch needs (0
    on the staged path). Builds and loads K7; needs a CUDA device."""
    out, scratch = (ctypes.c_int * len(_GEOMETRY_KEYS))(), ctypes.c_longlong(0)
    k = kernels.KERNELS["glmm_intercept"]
    fn = k.fn("mcp_glmm_intercept_geometry", [ctypes.c_int] * 7
              + [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong)])
    err = fn(sims, max_n, pf, G, m, nagq, int(hessian), out, ctypes.byref(scratch))
    if err != 0:
        raise RuntimeError(f"glmm_intercept geometry failed with CUDA error {err}")
    return dict(zip(_GEOMETRY_KEYS, out), scratch=scratch.value)


def glmm_intercept_kernel(code: int, X: torch.Tensor, y: torch.Tensor, fit: Sequence[int],
                          grid: Sequence[int], layout: Tuple[bool, int, int],
                          beta0: torch.Tensor, nagq: int = 1, hessian: bool = False):
    """Kernel K7: :func:`glmm_intercept_plain` on the card, each (sim,
    grid) cell's rows over one to four warps."""
    fit, grid = [int(c) for c in fit], [int(n) for n in grid]
    rr, period, m = bool(layout[0]), int(layout[1]), int(layout[2])
    pf, G = len(fit), len(grid)
    if not 1 <= pf <= MAX_P:
        raise ValueError(f"glmm_intercept kernel takes 1 <= p <= {MAX_P}, got {pf}")
    if not 1 <= nagq <= MAX_AGQ:
        raise ValueError(f"glmm_intercept kernel takes 1 <= nagq <= {MAX_AGQ}, got {nagq}")
    if not 1 <= m <= MAX_CLUSTERS:
        raise ValueError(f"glmm_intercept kernel takes 1 <= m <= {MAX_CLUSTERS}, got {m}")
    if X.dtype != torch.float32 or y.dtype != torch.float32:
        raise ValueError("glmm_intercept kernel takes f32 X and y")
    sims, max_n, P = X.shape
    if y.shape != (sims, max_n) or beta0.shape != (pf,):
        raise ValueError(f"glmm_intercept: X {tuple(X.shape)}, y {tuple(y.shape)}, beta0 "
                         f"{tuple(beta0.shape)} for p {pf}")
    if G == 0 or any(not 0 < n <= max_n for n in grid) or any(not 0 <= c < P for c in fit):
        raise ValueError(f"glmm_intercept: grid {grid} or fit columns {fit} out of range")
    if (rr and max_n % m) or (not rr and (period < 1 or max_n != m * period)):
        raise ValueError(f"glmm_intercept: layout {layout} does not tile {max_n} rows")
    dev_ = X.device
    X, y = X.contiguous(), y.contiguous()
    beta0 = beta0.to(device=dev_, dtype=torch.float64).contiguous()
    grid_t = torch.tensor(grid, dtype=torch.int32, device=dev_)
    kw = dict(dtype=torch.float64, device=dev_)
    beta = torch.empty((sims, G, pf), **kw)
    cov = torch.empty((sims, G, pf, pf), **kw)
    tau2, ybar = torch.empty((sims, G), **kw), torch.empty((sims, G), **kw)
    flags = torch.empty((sims, G), dtype=torch.uint8, device=dev_)
    kernels.require_cuda("glmm_intercept", X, y, grid_t, beta0, beta, cov, tau2, ybar, flags)
    if nagq > 1:
        x, lw, k0, dw = gh_nodes(nagq)
    else:
        x, lw, k0, dw = np.zeros(1), np.zeros(1), 0, np.zeros(1, np.float32)
    if sims:
        nbytes = glmm_intercept_geometry(sims, max_n, pf, G, m, nagq, hessian)["scratch"]
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev_) if nbytes else None
        k = kernels.KERNELS["glmm_intercept"]
        fn = k.fn("mcp_glmm_intercept", _GLMM_ARGS)
        k.check(fn(
            kernels.ptr(X), kernels.ptr(y), sims, max_n, P, (ctypes.c_int * pf)(*fit), pf,
            kernels.ptr(grid_t), G, int(rr), period, m, code, kernels.ptr(beta0), nagq,
            (ctypes.c_double * len(x))(*x.tolist()), (ctypes.c_double * len(lw))(*lw.tolist()),
            (ctypes.c_float * len(dw))(*dw.tolist()), k0, int(hessian),
            kernels.ptr(scratch) if scratch is not None else None,
            kernels.ptr(beta), kernels.ptr(cov), kernels.ptr(tau2), kernels.ptr(ybar),
            kernels.ptr(flags), kernels.stream_of(X)))
    return beta, cov, (flags & 1).bool(), (flags & 2).bool(), tau2, ybar


def glmm_intercept(code, X, y, fit, grid, layout, beta0, nagq: int = 1, hessian: bool = False):
    """K7 for CUDA tensors, the plain version for CPU tensors."""
    if X.is_cuda:
        return glmm_intercept_kernel(code, X, y, fit, grid, layout, beta0, nagq, hessian)
    if X.device.type != "cpu":
        raise ValueError(f"glmm_intercept: no kernel for device {X.device}")
    return glmm_intercept_plain(code, X, y, fit, grid, layout, beta0, nagq, hessian)


# ---------------------------------------------------------------------------
# The plain version of K10: the GLMM with random slopes
# ---------------------------------------------------------------------------

# The reference's slope-path budgets and their reasoning (glmmfit.py:112-126):
# PIRLS steps of the initial simplex and the first NM_FULL_SLOPE iterations,
# of the warm iterations after them, and the Nelder-Mead's length and step.
N_PIRLS_SLOPE = 8
N_PIRLS_SLOPE_WARM = 3
NM_ITERS_GLMM = 45
NM_FULL_SLOPE = 12
NM_STEP_SLOPE = 0.2
SLOPE_PHASES = ((NM_FULL_SLOPE, N_PIRLS_SLOPE), (NM_ITERS_GLMM - NM_FULL_SLOPE,
                                                   N_PIRLS_SLOPE_WARM))
N_V_PIRLS = 20  # v-only PIRLS passes of a Hessian evaluation (:836)
SLOPE_SENTINEL = 1e30  # a non-finite search deviance's rank
PIN_MARGIN = 1e-10
# K10's limit on q (datagen.unsupported names it before any run); its
# per-cluster state lives in a device scratch, so it takes any cluster count.
MAX_SLOPE_Q = 4


def _slope_pass(cells: _Cells, dtype, Lam, beta, v, kind: str):
    """One pass of the slope fit over every cell's rows at ``Lam (..., q,
    q)``, ``beta (..., p)`` and the modes ``v (..., m, q)`` in ``dtype``,
    the leading axes ``(S, G, K)``; kernel K10's pass, in its order.

    Per row: ``u = Lam v`` of its cluster, eta = X beta + Z u, the link's mu,
    var and dmu, w = dmu^2 / max(var, MU_EPS) (masked) and the working
    response zw = eta + (y - mu) / dmu. Per cluster, its rows in row order:
    G = sum (Z_r w) Z_c (lower triangle), and by ``kind``

    - ``"step"``, a PIRLS step: A = sum (Z_r w) x, b = sum (Z_r w) zw, X'WX
      and X'Wz; C = I + Lam' G Lam, its Cholesky, the solves of Lam' A and
      Lam' b, the Schur system (X'WX - sum A~' C^-1 A~) + ridge, beta, and v
      = C^-1 b~ - C^-1 A~ beta. Returns ``(beta, v)``, each cell kept where
      the step is not finite;
    - ``"vstep"``, a v-only step at fixed beta: r = sum (Z_r w) (zw - X
      beta) and v = C^-1 Lam' r, kept where not finite. Returns ``v``;
    - ``"tail"``: the Laplace deviance (2 sum dev + sum |v|^2) + sum log|C|;
    - ``"mode"``: the Laplace deviance and the f64 fit's Schur matrix (X'WX
      - sum A~' C^-1 A~) + 1e-10 I. Returns ``(lap, a_xx)``.

    Every sum over clusters is K7's lane sum (``_Cells.lanes``); every
    per-cluster term sums over the q components from the first.
    """
    p, q = cells.p, v.shape[-1]
    X = cells.X[dtype][:, :, None]  # (S, 1, 1, n, p)
    Z = cells.Z[dtype][:, :, None]
    y = cells.y[dtype][:, :, None]
    mask = cells.mask[dtype][:, None]  # (G, 1, n)
    xb = smallchol.rowmv(X, beta)
    lam = lambda r, j: Lam[..., r, j, None]  # noqa: E731  (..., 1) against (..., m)
    u = [_ordered_sum([v[..., k] * lam(i, k) for k in range(i + 1)]) for i in range(q)]
    zu = cells.per_row(u[0])
    for k in range(1, q):
        zu = zu + Z[..., k] * cells.per_row(u[k])
    eta = xb + zu
    mu, var, dmu = _mu_var_dmu(cells.code, eta)
    w = dmu * dmu / torch.clamp(var, min=MU_EPS) * mask
    wz = [w] + [Z[..., r] * w for r in range(1, q)]
    xs = [X[..., a].expand_as(w) for a in range(p)]
    terms = [wz[r] * Z[..., c] for r in range(q) for c in range(r + 1)]
    if kind in ("step", "mode"):
        terms += [wz[r] * xs[a] for r in range(q) for a in range(p)]
        terms += [(xs[a] * w) * xs[b] for a, b in _tri(p)]
    if kind in ("step", "vstep"):
        zw = eta + (y - mu) / dmu
        rz = zw if kind == "step" else zw - xb
        terms += [wz[r] * rz for r in range(q)]
    if kind == "step":
        wzw = w * zw
        terms += [xa * wzw for xa in xs]
    if kind in ("tail", "mode"):
        terms.append(_deviance_terms(cells.code, y.expand_as(mu), mu) * mask)
    sums = cells.seg(torch.stack(terms, dim=-2))  # (..., T, m)
    nt, ng = len(_tri(p)), q * (q + 1) // 2
    Gl = [[None] * q for _ in range(q)]
    k = 0
    for r in range(q):
        for c in range(r + 1):
            Gl[r][c] = Gl[c][r] = sums[..., k, :]
            k += 1
    # C = I + (Lam' G) Lam, lower triangle, and its Cholesky
    LtG = [[_ordered_sum([lam(r, j) * Gl[r][c] for r in range(j, q)]) for c in range(q)]
           for j in range(q)]
    zero = torch.zeros_like(LtG[0][0])
    C = torch.stack([torch.stack([
        (1.0 + _ordered_sum([LtG[j][r] * lam(r, kk) for r in range(kk, q)]) if kk == j else
         _ordered_sum([LtG[j][r] * lam(r, kk) for r in range(kk, q)])) if kk <= j else zero
        for kk in range(q)], dim=-1) for j in range(q)], dim=-2)  # (..., m, q, q)
    cholC = smallchol.chol(C)

    def lam_t(vals):  # Lam' x per cluster: vals[s] (..., m, *t) -> (..., m, *t, q)
        ex = (...,) + (None,) * (vals[0].dim() - zero.dim())
        return torch.stack([_ordered_sum([lam(s, r)[ex] * vals[s] for s in range(r, q)])
                            for r in range(q)], dim=-1)

    if kind in ("tail", "mode"):
        vv = _ordered_sum([v[..., r] * v[..., r] for r in range(q)])
        ld = 2.0 * _ordered_sum([torch.log(cholC[..., r, r]) for r in range(q)])
        dev = 2.0 * cells.lanes(sums[..., -1, :])
        lap = (dev + cells.lanes(vv)) + cells.lanes(ld)
        if kind == "tail":
            return lap
    if kind == "vstep":
        rt = lam_t([sums[..., ng + r, :] for r in range(q)])
        v_new = smallchol.cho_solve(cholC, rt)
        ok = torch.isfinite(v_new).flatten(-2).all(-1)
        return torch.where(ok[..., None, None], v_new, v)
    # A~ = Lam' A (..., m, p, q) and its solves; the Schur system
    A = [sums[..., ng + r * p:ng + (r + 1) * p, :].movedim(-2, -1) for r in range(q)]
    At = lam_t(A)
    sol_A = smallchol.cho_solve(cholC[..., None, :, :], At)  # (..., m, p, q)
    cxx = _ordered_sum([At[..., :, None, r] * sol_A[..., None, :, r] for r in range(q)])
    o = ng + q * p
    sxx = torch.stack([cells.lanes(cxx[..., i, j]) for i, j in _tri(p)], dim=-1)
    xwx = cells.lanes(sums[..., o:o + nt, :])
    if kind == "mode":
        ridge = torch.tensor(1e-10, dtype=dtype, device=beta.device)
        return lap, _schur(cells, xwx, sxx, ridge)
    ridge = torch.tensor(1e-10 if dtype == torch.float64 else 1e-6, dtype=dtype,
                         device=beta.device)
    bt = lam_t([sums[..., o + nt + r, :] for r in range(q)])
    sol_b = smallchol.cho_solve(cholC, bt)  # (..., m, q)
    cxy = _ordered_sum([At[..., r] * sol_b[..., r, None] for r in range(q)])  # (..., m, p)
    sxy = torch.stack([cells.lanes(cxy[..., a]) for a in range(p)], dim=-1)
    xwz = cells.lanes(sums[..., o + nt + q:o + nt + q + p, :])
    beta_new = smallchol.cho_solve(smallchol.chol(_schur(cells, xwx, sxx, ridge)), xwz - sxy)
    v_new = torch.stack([sol_b[..., r] - _ordered_sum([sol_A[..., a, r] * beta_new[..., a, None]
                                                for a in range(p)]) for r in range(q)], dim=-1)
    ok = torch.isfinite(beta_new).all(-1) & torch.isfinite(v_new).flatten(-2).all(-1)
    return (torch.where(ok[..., None], beta_new, beta),
            torch.where(ok[..., None, None], v_new, v))


def _slope_pirls(cells: _Cells, dtype, Lam, beta, v, iters: int):
    """``iters`` PIRLS steps (the reference's ``make_pirls`` loop, :660-745)."""
    for _ in range(iters):
        beta, v = _slope_pass(cells, dtype, Lam, beta, v, "step")
    return beta, v


def _col_zero_masks(q: int, dtype, device) -> torch.Tensor:
    """(q, d): theta's entries with Cholesky column j zeroed, row j."""
    d = q * (q + 1) // 2
    masks = torch.ones((q, d), dtype=dtype, device=device)
    off = 0
    for j in range(q):
        masks[j, off:off + q - j] = 0.0
        off += q - j
    return masks


def glmm_slope_plain(code: int, X: torch.Tensor, y: torch.Tensor, fit: Sequence[int],
                     zcols: Sequence[int], grid: Sequence[int], layout: Tuple[bool, int, int],
                     beta0: torch.Tensor, theta0, lower, hessian: bool = False,
                     theta: torch.Tensor = None):
    """Every (sim, grid) cell's random-slope GLMM fit (the reference's
    ``_slope_glmm_grid_stats.per_grid``, :594-891).

    ``X (sims, max_n, P)`` and ``y (sims, max_n)`` f32; ``fit`` the pf fit
    columns; ``zcols`` the q - 1 slope columns of X (Z = [1, X[:, zcols]]);
    ``grid``, ``layout`` and ``beta0`` as :func:`glmm_intercept_plain`;
    ``theta0``, ``lower`` ``(d,)`` from ``mixedfit.slope_start``. Steps: the
    warm-carried Nelder-Mead (``optim.nelder_mead_carry``) over theta on the
    f32 Laplace deviance from f32 PIRLS (the d + 1 initial vertices from
    (beta0, v = 0) at N_PIRLS_SLOPE steps, then SLOPE_PHASES, every
    candidate from the carried mode); the cold f64 fit at the optimum
    (N_PIRLS steps from (beta0, 0)), its Laplace deviance and cov = (X'WX -
    sum A~' C^-1 A~ + 1e-10 I)^-1, or 2 H^-1 of the FD Hessian under
    ``hessian``; each component's pin probe (its Cholesky column zeroed,
    N_PIRLS_SLOPE_WARM f64 steps from the fit's mode, then the deviance: a
    removal that costs at most PIN_MARGIN pins the component, and changes
    nothing in the fit). ``theta (sims, G, d)`` f64, where given, replaces
    the search's optimum.

    Returns f64 ``beta (sims, G, pf)``, ``cov``, bool ``converged`` and
    ``boundary`` (any pin), f64 ``tau2_hat = (Lam Lam')[0, 0]`` and ``ybar``,
    bool ``pinned (sims, G, q)`` and the optimum ``theta (sims, G, d)``.
    """
    from . import optim
    from .mixedfit import vech_to_lower

    cells = _Cells(code, X, y, fit, grid, layout, zcols)
    sims, G, pf, m = X.shape[0], len(grid), len(fit), cells.m
    q = len(zcols) + 1
    d = q * (q + 1) // 2
    dev_ = X.device
    f64, f32 = torch.float64, torch.float32
    theta0 = torch.as_tensor(np.asarray(theta0), dtype=f64, device=dev_)
    lower = torch.as_tensor(np.asarray(lower), dtype=f64, device=dev_)
    beta0 = beta0.to(device=dev_, dtype=f64)
    cl = sims * G

    if theta is None:
        def search_eval(points, aux, budget):
            k = points.shape[1]
            Lam = vech_to_lower(points.reshape(sims, G, k, d), q).to(f32)
            beta = aux[0].reshape(sims, G, 1, pf).expand(sims, G, k, pf)
            v = aux[1].reshape(sims, G, 1, m, q).expand(sims, G, k, m, q)
            beta, v = _slope_pirls(cells, f32, Lam, beta, v, budget)
            lap = _slope_pass(cells, f32, Lam, beta, v, "tail").to(f64)
            lap = torch.where(torch.isfinite(lap), lap, torch.full_like(lap, SLOPE_SENTINEL))
            return lap.reshape(cl, k), (beta.reshape(cl, k, pf), v.reshape(cl, k, m, q))

        aux0 = (beta0.to(f32).expand(cl, pf), torch.zeros((cl, m, q), dtype=f32, device=dev_))
        theta_hat, _, _ = optim.nelder_mead_carry(
            search_eval, theta0.expand(cl, d), aux0, phases=SLOPE_PHASES,
            init_step=NM_STEP_SLOPE, lower=lower)
        theta_hat = theta_hat.reshape(sims, G, d)
    else:
        theta_hat = theta.to(device=dev_, dtype=f64).reshape(sims, G, d)

    # the cold f64 fit at the optimum and its Schur covariance
    Lam = vech_to_lower(theta_hat, q)[:, :, None]  # (S, G, 1, q, q)
    beta, v = _slope_pirls(cells, f64, Lam, beta0.expand(sims, G, 1, pf),
                           torch.zeros((sims, G, 1, m, q), dtype=f64, device=dev_), N_PIRLS)
    lap, a_xx = _slope_pass(cells, f64, Lam, beta, v, "mode")
    chol = smallchol.chol(a_xx)
    cov = smallchol.cho_inverse(chol)
    if hessian:  # the v-profiled Laplace deviance at the stencil (:816-860)
        offs = torch.as_tensor(hessian_offsets(pf) * HESSIAN_STEP, dtype=f64, device=dev_)
        beta_q = beta + offs  # (S, G, V, pf)
        v_q = v.expand(sims, G, offs.shape[0], m, q)
        for _ in range(N_V_PIRLS):
            v_q = _slope_pass(cells, f64, Lam, beta_q, v_q, "vstep")
        vals = _slope_pass(cells, f64, Lam, beta_q, v_q, "tail")
        cov = _stencil_cov(vals, beta[:, :, 0], cov[:, :, 0])[:, :, None]
    # the pin probes: component j's Cholesky column zeroed (:863-881)
    th_j = theta_hat[:, :, None] * _col_zero_masks(q, f64, dev_)  # (S, G, q, d)
    Lam_j = vech_to_lower(th_j, q)
    bj, vj = _slope_pirls(cells, f64, Lam_j, beta.expand(sims, G, q, pf),
                          v.expand(sims, G, q, m, q), N_PIRLS_SLOPE_WARM)
    probes = _slope_pass(cells, f64, Lam_j, bj, vj, "tail")
    pinned = probes <= lap + PIN_MARGIN  # (S, G, q)
    ridge = torch.diag_embed(torch.full_like(beta, 1e-10))
    converged = (torch.isfinite(beta).all(-1) & smallchol.chol_ok(chol)
                 & smallchol.rank_ok(a_xx - ridge) & torch.isfinite(lap))[:, :, 0]
    l00 = theta_hat[..., 0]
    ysum = cells.lanes(cells.seg(cells.y[f64] * cells.mask[f64]))
    return (beta[:, :, 0], cov[:, :, 0], converged, pinned.any(-1), l00 * l00,
            ysum / cells.ns, pinned, theta_hat)


# ---------------------------------------------------------------------------
# K10 on the card
# ---------------------------------------------------------------------------

_GLMM_SLOPE_ARGS = [
    ctypes.c_void_p,  # X (sims, max_n, P) f32
    ctypes.c_void_p,  # y (sims, max_n) f32
    ctypes.c_int,  # sims
    ctypes.c_int,  # max_n
    ctypes.c_int,  # P
    ctypes.POINTER(ctypes.c_int),  # fit columns (host)
    ctypes.c_int,  # pf
    ctypes.POINTER(ctypes.c_int),  # slope columns (host), q - 1 of them
    ctypes.c_int,  # q
    ctypes.c_void_p,  # grid (G,) int32, device
    ctypes.c_int,  # G
    ctypes.c_int,  # round robin (1) or blocked (0)
    ctypes.c_int,  # period: m (round robin) or the cluster size (blocked)
    ctypes.c_int,  # m
    ctypes.c_int,  # link code
    ctypes.c_void_p,  # beta0 (pf,) f64, device
    ctypes.POINTER(ctypes.c_double),  # theta0 (d,) host
    ctypes.POINTER(ctypes.c_double),  # lower (d,) host
    ctypes.c_int,  # hessian
    ctypes.c_void_p,  # scratch: mcp_glmm_slope_scratch_bytes
    ctypes.c_void_p,  # beta out (sims, G, pf) f64
    ctypes.c_void_p,  # cov out (sims, G, pf, pf) f64
    ctypes.c_void_p,  # tau2_hat out (sims, G) f64
    ctypes.c_void_p,  # ybar out (sims, G) f64
    ctypes.c_void_p,  # flags out (sims, G) uint8: bit0 converged, bit1 boundary
    ctypes.c_void_p,  # pinned out (sims, G, q) uint8
    ctypes.c_void_p,  # theta out (sims, G, d) f64
    ctypes.c_void_p,  # cudaStream_t
]


def glmm_slope_scratch_bytes(cells: int, m: int, q: int, p: int) -> int:
    """Bytes of device scratch K10 takes for ``cells`` cells (its C entry
    point's count). Builds and loads K10; needs a CUDA device."""
    fn = kernels.KERNELS["glmm_slope"].fn("mcp_glmm_slope_scratch_bytes",
                                          [ctypes.c_longlong] + [ctypes.c_int] * 3)
    fn.restype = ctypes.c_longlong
    return int(fn(cells, m, q, p))


_SLOPE_GEOMETRY_KEYS = ("form", "smem", "static_smem", "cells_per_sm", "waves", "registers",
                        "local_bytes", "p_bucket", "min_cells_per_sm")


def glmm_slope_geometry(code: int, X: torch.Tensor, y: torch.Tensor, fit: Sequence[int],
                        zcols: Sequence[int], grid: Sequence[int], layout: Tuple[bool, int, int],
                        *_rest) -> Dict[str, int]:
    """The launch form K10's C launcher takes for :func:`glmm_slope_kernel`'s
    arguments: ``form`` 1 with the rows and the f32 state in shared memory,
    2 streamed (state in device scratch); the dynamic and static shared
    bytes a block, resident cells an SM, the launch's waves, its kernel's
    registers and local (spill and stack) bytes a thread, the p bucket and
    the cells an SM its registers are held to. Builds and loads K10; needs
    a CUDA device."""
    fn = kernels.KERNELS["glmm_slope"].fn("mcp_glmm_slope_geometry",
                                          [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)])
    out = (ctypes.c_int * len(_SLOPE_GEOMETRY_KEYS))()
    err = fn(X.shape[0], X.shape[1], len(fit), len(zcols) + 1, len(grid), int(layout[2]), out)
    if err:
        raise RuntimeError(f"mcp_glmm_slope_geometry: CUDA error {err}")
    return dict(zip(_SLOPE_GEOMETRY_KEYS, out))


def glmm_slope_set_form(form: int) -> None:
    """Where K10's later launches put the rows and the f32 state: 0 as its
    launcher picks, 2 the streamed form (device scratch). A measurement and
    check knob: both forms give the same bits."""
    fn = kernels.KERNELS["glmm_slope"].fn("mcp_glmm_slope_set_form", [ctypes.c_int])
    fn.restype = None
    fn(int(form))


def glmm_slope_kernel(code: int, X: torch.Tensor, y: torch.Tensor, fit: Sequence[int],
                      zcols: Sequence[int], grid: Sequence[int], layout: Tuple[bool, int, int],
                      beta0: torch.Tensor, theta0, lower, hessian: bool = False):
    """Kernel K10: :func:`glmm_slope_plain` on the card, a (sim, grid) cell
    a block, its four warps the search's four candidates, the cell's rows
    and f32 state in shared memory where they fit
    (:func:`glmm_slope_geometry`), with the device scratch its C entry point
    sizes."""
    fit, zcols, grid = [int(c) for c in fit], [int(c) for c in zcols], [int(n) for n in grid]
    rr, period, m = bool(layout[0]), int(layout[1]), int(layout[2])
    pf, G, q = len(fit), len(grid), len(zcols) + 1
    d = q * (q + 1) // 2
    if not 1 <= pf <= MAX_P:
        raise ValueError(f"glmm_slope kernel takes 1 <= p <= {MAX_P}, got {pf}")
    if not 2 <= q <= MAX_SLOPE_Q:
        raise ValueError(f"glmm_slope kernel takes 2 <= q <= {MAX_SLOPE_Q}, got {q}")
    if X.dtype != torch.float32 or y.dtype != torch.float32:
        raise ValueError("glmm_slope kernel takes f32 X and y")
    sims, max_n, P = X.shape
    theta0, lower = np.asarray(theta0, np.float64), np.asarray(lower, np.float64)
    if y.shape != (sims, max_n) or beta0.shape != (pf,) or theta0.shape != (d,) \
            or lower.shape != (d,):
        raise ValueError(f"glmm_slope: X {tuple(X.shape)}, y {tuple(y.shape)}, beta0 "
                         f"{tuple(beta0.shape)}, theta0 {theta0.shape} for p {pf}, q {q}")
    if G == 0 or m < 1 or any(not 0 < n <= max_n for n in grid) \
            or any(not 0 <= c < P for c in fit + zcols):
        raise ValueError(f"glmm_slope: grid {grid}, fit {fit} or slope columns {zcols} out of "
                         "range")
    if (rr and max_n % m) or (not rr and (period < 1 or max_n != m * period)):
        raise ValueError(f"glmm_slope: layout {layout} does not tile {max_n} rows")
    dev_ = X.device
    X, y = X.contiguous(), y.contiguous()
    beta0 = beta0.to(device=dev_, dtype=torch.float64).contiguous()
    grid_t = torch.tensor(grid, dtype=torch.int32, device=dev_)
    kw = dict(dtype=torch.float64, device=dev_)
    beta = torch.empty((sims, G, pf), **kw)
    cov = torch.empty((sims, G, pf, pf), **kw)
    tau2, ybar = torch.empty((sims, G), **kw), torch.empty((sims, G), **kw)
    theta = torch.empty((sims, G, d), **kw)
    flags = torch.empty((sims, G), dtype=torch.uint8, device=dev_)
    pinned = torch.empty((sims, G, q), dtype=torch.uint8, device=dev_)
    kernels.require_cuda("glmm_slope", X, y, grid_t, beta0, beta, cov, tau2, ybar, theta, flags,
                         pinned)
    if sims:
        scratch = torch.empty(glmm_slope_scratch_bytes(sims * G, m, q, pf), dtype=torch.uint8,
                              device=dev_)
        k = kernels.KERNELS["glmm_slope"]
        fn = k.fn("mcp_glmm_slope", _GLMM_SLOPE_ARGS)
        k.check(fn(
            kernels.ptr(X), kernels.ptr(y), sims, max_n, P, (ctypes.c_int * pf)(*fit), pf,
            (ctypes.c_int * (q - 1))(*zcols), q, kernels.ptr(grid_t), G, int(rr), period, m, code,
            kernels.ptr(beta0), (ctypes.c_double * d)(*theta0.tolist()),
            (ctypes.c_double * d)(*lower.tolist()), int(hessian), kernels.ptr(scratch),
            kernels.ptr(beta), kernels.ptr(cov), kernels.ptr(tau2), kernels.ptr(ybar),
            kernels.ptr(flags), kernels.ptr(pinned), kernels.ptr(theta), kernels.stream_of(X)))
    return (beta, cov, (flags & 1).bool(), (flags & 2).bool(), tau2, ybar, pinned.bool(), theta)


def glmm_slope(code, X, y, fit, zcols, grid, layout, beta0, theta0, lower, hessian: bool = False):
    """K10 for CUDA tensors, the plain version for CPU tensors."""
    if X.is_cuda:
        return glmm_slope_kernel(code, X, y, fit, zcols, grid, layout, beta0, theta0, lower,
                                 hessian)
    if X.device.type != "cpu":
        raise ValueError(f"glmm_slope: no kernel for device {X.device}")
    return glmm_slope_plain(code, X, y, fit, zcols, grid, layout, beta0, theta0, lower, hessian)


# ---------------------------------------------------------------------------
# The plain version of K12: the GLMM with extra groupings
# ---------------------------------------------------------------------------

# The reference's joint-Z search (glmmfit.py:458-478): the slope path's
# phased budgets, 30 Nelder-Mead iterations for a theta of d <= 3 and 45
# beyond; its pin (:521-528): a Cholesky diagonal below 1e-3 at the optimum.
EXTRAS_PIN = 1e-3
# Kernel K12's limits (datagen.unsupported names them before any run): a
# joint Z of M <= 128 columns (so at most 128 extras levels; its capacitance
# and Z'WZ in a device scratch), theta of d <= 10 (optim.py's range), at
# most 4 groupings, p <= 16, and the Laplace deviance alone (the reference's
# contract error 25 refuses nagq != 1 with extra groupings).
EXTRAS_MAX_M = 128
EXTRAS_MAX_D = 10
EXTRAS_MAX_GROUPINGS = 4


def extras_unsupported(spec: SimSpec) -> str:
    """Why kernel K12 cannot fit ``spec``'s GLMM with extra groupings; ''
    when it can."""
    plan = grouping_plan(spec)
    d = sum(theta_layout(plan)[0])
    M = joint_width(plan)
    Me = sum(m for m, _, _, _, _ in plan[1:])
    if int(spec.nagq) != 1:
        return (f"a GLMM with extra groupings at nagq {spec.nagq}; kernel K12 takes the "
                "Laplace deviance alone (nagq 1, the reference's contract error 25)")
    if len(plan) > EXTRAS_MAX_GROUPINGS:
        return f"{len(plan)} groupings; kernel K12 takes at most {EXTRAS_MAX_GROUPINGS}"
    if d > EXTRAS_MAX_D:
        return (f"a joint theta of {d} entries; kernel K12 takes d <= {EXTRAS_MAX_D} "
                "(optim.py's range)")
    if M > EXTRAS_MAX_M:
        return (f"a joint Z of {M} columns ({Me} extras levels); kernel K12 takes M <= "
                f"{EXTRAS_MAX_M}")
    return ""


def extras_nm_iters(d: int) -> int:
    return 30 if d <= 3 else NM_ITERS_GLMM


def extras_phases(d: int):
    return ((NM_FULL_SLOPE, N_PIRLS_SLOPE),
            (extras_nm_iters(d) - NM_FULL_SLOPE, N_PIRLS_SLOPE_WARM))


class _JointCells:
    """The (sim, grid) cells of one launch of the GLMM with extra groupings,
    their leading axes ``(S, G, K)`` (K candidates): ``X (S, 1, 1, n, p)``,
    ``y``, the row mask ``(G, 1, n)``, each grouping's Z columns (slopes)
    and the row lists of its levels.

    ``groups`` is ``[(ids (max_n,), m_g, slope_cols)]``, the primary first
    (``olsfit.joint_layout``). Every sum over rows follows one order, the
    one kernel K12 repeats: an entry owned by a level (its rows of Z'WZ,
    wZ'X, wZ'z) adds that level's rows in ascending row order to a zero;
    Z'WZ's entries between groupings g < h are owned by g's level; a sum
    over all rows (X'WX, X'Wz, the deviance, the outcome's) adds each primary
    level's rows in row order, then the primary levels in K7's lane order
    (``smallchol.lane_sum``). Rows at or past a cell's grid point, and the
    padding of a level's row list, add exact zeros.
    """

    def __init__(self, code: int, X, y, fit, grid, groups):
        self.code = code
        dev_ = X.device
        max_n = X.shape[1]
        Xf = X[..., list(fit)]
        self.p = Xf.shape[-1]
        self.X = {torch.float64: Xf.to(torch.float64)[:, None, None],
                  torch.float32: Xf.to(torch.float32)[:, None, None]}
        self.y = {torch.float64: y.to(torch.float64)[:, None, None],
                  torch.float32: y.to(torch.float32)[:, None, None]}
        rows = torch.arange(max_n, device=dev_)
        ns = torch.as_tensor(list(grid), device=dev_)
        mask = (rows < ns[:, None]).to(torch.float64)[:, None]  # (G, 1, n)
        self.mask = {torch.float64: mask, torch.float32: mask.to(torch.float32)}
        self.ns = ns.to(torch.float64)
        self.ng = len(groups)
        self.levels = [int(m) for _, m, _ in groups]
        self.comps = [1 + len(cols) for _, _, cols in groups]
        self.shape = list(zip(self.levels, self.comps))
        self.coff = np.concatenate([[0], np.cumsum([m * q for m, q in self.shape])]).tolist()
        self.M = int(self.coff[-1])
        self.ids, self.Z, self.idx, self.hot = [], [], [], {}
        for ids, m, cols in groups:
            ids = torch.as_tensor(ids, device=dev_).long()
            self.ids.append(ids)
            self.Z.append({dt: [X[..., c].to(dt)[:, None, None] for c in cols]
                           for dt in (torch.float64, torch.float32)})
            # level j's rows ascending, padded with max_n (a zero row)
            counts = torch.bincount(ids, minlength=m)
            K = max(int(counts.max()) if len(ids) else 0, 1)
            order = torch.argsort(ids * max_n + rows)
            start = torch.cumsum(counts, 0) - counts
            pos = torch.arange(K, device=dev_)
            take = start[:, None] + pos
            ok = pos < counts[:, None]
            self.idx.append(torch.where(ok, order[take.clamp(max=max_n - 1)],
                                        torch.full_like(take, max_n)))
        for g in range(self.ng):  # where each row of g's levels meets h's levels
            for h in range(g + 1, self.ng):
                lv = torch.cat([self.ids[h], self.ids[h].new_full((1,), -1)])[self.idx[g]]
                self.hot[g, h] = lv[..., None] == torch.arange(self.levels[h], device=dev_)

    def _gather(self, g: int, v: torch.Tensor) -> torch.Tensor:
        """(..., n) -> (..., m_g, K_g): each level's rows, zero-padded."""
        v = torch.nn.functional.pad(v, (0, 1))
        idx = self.idx[g]
        return v.index_select(-1, idx.reshape(-1)).reshape(*v.shape[:-1], *idx.shape)

    def lvl_sum(self, g: int, v: torch.Tensor) -> torch.Tensor:
        """(..., n) -> (..., m_g): each level of grouping g, its rows in order."""
        b = self._gather(g, v)
        acc = torch.zeros_like(b[..., 0])
        for k in range(b.shape[-1]):
            acc = acc + b[..., k]
        return acc

    def cross_sum(self, g: int, h: int, v: torch.Tensor) -> torch.Tensor:
        """(..., n) -> (..., m_g, m_h): entry (j, l) sums the rows of g's
        level j that lie in h's level l, in row order."""
        b = self._gather(g, v)
        hot = self.hot[g, h]
        acc = b.new_zeros(b.shape[:-1] + (self.levels[h],))
        zero = torch.zeros((), dtype=b.dtype, device=b.device)
        for k in range(b.shape[-1]):
            acc = acc + torch.where(hot[:, k], b[..., k, None], zero)
        return acc

    def total(self, v: torch.Tensor) -> torch.Tensor:
        """(..., n) -> (...): the primary levels' sums in K7's lane order."""
        s = self.lvl_sum(0, v)
        return smallchol.lane_sum(torch.nn.functional.pad(s, (0, -s.shape[-1] % smallchol.LANES)))

    def per_row(self, g: int, u: torch.Tensor) -> torch.Tensor:
        """(..., m_g) -> (..., n): each row's level value."""
        return u.index_select(-1, self.ids[g])


def _extras_pass(cells: _JointCells, dtype, th, beta, v, kind: str, dense: bool):
    """One pass of the joint-Z PIRLS over every cell's rows at ``th (...,
    d)``, ``beta (..., p)`` and the modes ``v (..., M)`` in ``dtype``, the
    leading axes ``(S, G, K)``; kernel K12's pass, in its order.

    Per row: u = Lam v of each grouping's level (u_i = sum over k <= i of
    v_k Lg[i, k], from k = 0), eta = X beta + sum over groupings and
    components of z u (the primary's intercept first), the link's mu, var
    and dmu, w = dmu^2 / max(var, MU_EPS) (masked), zw = eta + (y - mu) /
    dmu and wz_k = w (k = 0) or z_k w. Sums (:class:`_JointCells`' order):
    Z'WZ's entries wz_k z_l (a level's block, k >= l, mirrored; between
    groupings g < h), and by ``kind``

    - ``"step"``: wZ'zw, wZ'X (x_a), X'WX ((x_a w) x_b) and X'Wz (x_a (w zw));
      the capacitance solve of [wZ'zw | wZ'X] (``mixedfit.joint_capacitance``,
      structured unless ``dense``), the Schur system (X'WX - acc) + ridge
      (1e-6 f32, 1e-10 f64) by the width rule (``smallchol.chol_auto``),
      beta, and v = sol_b - sum_a sol_A[:, a] beta_a. Returns ``(beta, v)``,
      each cell kept where the step is not finite;
    - ``"vstep"``, v alone at fixed beta: wZ'(zw - X beta), v = C^-1 Lam' r.
      Returns ``v``, kept where not finite;
    - ``"tail"``: the Laplace deviance (2 sum dev + sum v^2) + log|C|;
    - ``"mode"``: the Laplace deviance and the Schur matrix (X'WX - acc) +
      1e-10 I. Returns ``(lap, a_xx)``.
    """
    p, M, ng = cells.p, cells.M, cells.ng
    X, y, mask = cells.X[dtype], cells.y[dtype], cells.mask[dtype]
    lead = beta.shape[:-1]
    xb = smallchol.rowmv(X, beta)
    # u = Lam v per grouping and level, then each row's z u
    zu, toff = None, 0
    us = []
    for g, (m, q) in enumerate(cells.shape):
        Lg = vech_to_lower(th[..., toff:toff + q * (q + 1) // 2], q)
        toff += q * (q + 1) // 2
        vg = v[..., cells.coff[g]:cells.coff[g + 1]].reshape(*lead, m, q)
        ug = [_ordered_sum([vg[..., k] * Lg[..., i, k, None] for k in range(i + 1)])
              for i in range(q)]
        us.append(ug)
        for i in range(q):
            t = cells.per_row(g, ug[i])
            if i:
                t = cells.Z[g][dtype][i - 1] * t
            zu = t if zu is None else zu + t
    eta = xb + zu
    mu, var, dmu = _mu_var_dmu(cells.code, eta)
    w = dmu * dmu / torch.clamp(var, min=MU_EPS) * mask
    zs = [[None] + cells.Z[g][dtype] for g in range(ng)]  # component k's value (k >= 1)
    wz = [[w] + [zs[g][k] * w for k in range(1, q)] for g, (_, q) in enumerate(cells.shape)]
    xs = [X[..., a].expand_as(w) for a in range(p)]
    want_r, want_a = kind in ("step", "vstep"), kind in ("step", "mode")
    if want_r:  # the working response, less X beta for a v-only step
        zw = eta + (y - mu) / dmu
        rz = zw if kind == "step" else zw - xb
    # Each grouping's level sums in one stack: its block's terms (k >= l),
    # then the right-hand sides wz_k r and wz_k x_a; then its blocks with the
    # later groupings. Z'WZ mirrored, the right-hand sides (..., M, r).
    r = 1 if kind == "vstep" else p + 1
    ztz = w.new_zeros(lead + (M, M))
    raw = w.new_zeros(lead + (M, r))
    for g, (m, q) in enumerate(cells.shape):
        base = cells.coff[g] + q * torch.arange(m, device=w.device)
        block = [(k, l) for k in range(q) for l in range(k + 1)]
        terms = [wz[g][k] if l == 0 else wz[g][k] * zs[g][l] for k, l in block]
        if want_r:
            terms += [wz[g][k] * rz for k in range(q)]
        if want_a:
            terms += [wz[g][k] * xs[a] for k in range(q) for a in range(p)]
        sums = cells.lvl_sum(g, torch.stack(terms, dim=-2))  # (..., T, m)
        for i, (k, l) in enumerate(block):
            ztz[..., base + k, base + l] = ztz[..., base + l, base + k] = sums[..., i, :]
        i = len(block)
        if want_r:
            for k in range(q):
                raw[..., base + k, 0] = sums[..., i, :]
                i += 1
        if want_a:
            for k in range(q):
                for a in range(p):
                    raw[..., base + k, 1 + a] = sums[..., i, :]
                    i += 1
        for h in range(g + 1, ng):
            mh, qh = cells.shape[h]
            bh = cells.coff[h] + qh * torch.arange(mh, device=w.device)
            pairs = [(k, l) for k in range(q) for l in range(qh)]
            cs = cells.cross_sum(g, h, torch.stack(
                [wz[g][k] if l == 0 else wz[g][k] * zs[h][l] for k, l in pairs], dim=-2))
            for i, (k, l) in enumerate(pairs):
                r_idx, c_idx = (base + k)[:, None], (bh + l)[None, :]
                ztz[..., r_idx, c_idx] = cs[..., i, :, :]
                ztz[..., c_idx.T, r_idx.T] = cs[..., i, :, :].transpose(-1, -2)
    # the sums over all rows: X'WX, X'Wz, the deviance
    tri = _tri(p) if want_a else []
    terms = [(xs[a] * w) * xs[b] for a, b in tri]
    if kind == "step":
        wzw = w * zw
        terms += [xa * wzw for xa in xs]
    if kind in ("tail", "mode"):
        terms.append(_deviance_terms(cells.code, y.expand_as(mu), mu) * mask)
    tot = cells.total(torch.stack(terms, dim=-2)) if terms else None  # (..., T)
    if kind in ("tail", "mode"):
        vv = _ordered_sum([v[..., i] * v[..., i] for i in range(M)])
        dev = tot[..., -1]
    if kind == "vstep":
        _, sol, _ = joint_capacitance(th, cells.shape, ztz, raw, dense=True)
        v_new = sol[..., 0]
        ok = torch.isfinite(v_new).all(-1)
        return torch.where(ok[..., None], v_new, v)
    if kind == "tail":
        _, _, logdet = joint_capacitance(th, cells.shape, ztz, None, dense=dense, solve=False)
        return (2.0 * dev + vv) + logdet
    rhs, sol, logdet = joint_capacitance(th, cells.shape, ztz, raw, dense=dense)
    acc = _contract_rows(rhs, sol)
    xwx = w.new_zeros(lead + (p, p))
    for i, (a, b) in enumerate(tri):
        xwx[..., a, b] = xwx[..., b, a] = tot[..., i]
    eye = torch.eye(p, dtype=dtype, device=w.device)
    if kind == "mode":
        ridge = torch.tensor(1e-10, dtype=dtype, device=w.device)
        return (2.0 * dev + vv) + logdet, (xwx - acc[..., 1:, 1:]) + ridge * eye
    ridge = torch.tensor(1e-10 if dtype == torch.float64 else 1e-6, dtype=dtype, device=w.device)
    xwz = tot[..., len(tri):len(tri) + p]
    chol = smallchol.chol_auto((xwx - acc[..., 1:, 1:]) + ridge * eye)
    beta_new = smallchol.cho_solve_auto(chol, xwz - acc[..., 1:, 0])
    v_new = sol[..., 0] - _ordered_sum([sol[..., 1 + a] * beta_new[..., a, None]
                                        for a in range(p)])
    ok = torch.isfinite(beta_new).all(-1) & torch.isfinite(v_new).all(-1)
    return torch.where(ok[..., None], beta_new, beta), torch.where(ok[..., None], v_new, v)


def glmm_extras_plain(code: int, X: torch.Tensor, y: torch.Tensor, fit: Sequence[int],
                      grid: Sequence[int], groups, beta0: torch.Tensor, theta0, lower,
                      hessian: bool = False, theta: torch.Tensor = None, dense: bool = False):
    """Every (sim, grid) cell's GLMM fit with extra groupings (the
    reference's ``_extras_glmm_grid_stats.per_grid``, :155-553), the plain
    version of kernel K12.

    ``X (sims, max_n, P)`` and ``y (sims, max_n)`` f32; ``fit`` the pf fit
    columns; ``grid`` G ascending row counts; ``groups`` ``[(ids, m_g,
    slope_cols)]`` per grouping, the primary first (``olsfit.joint_layout``);
    ``beta0 (pf,)`` f64; ``theta0``, ``lower`` ``(d,)`` from
    ``mixedfit.theta_layout``. Steps: the warm-carried Nelder-Mead
    (``optim.nelder_mead_carry``, init step 0.2, :func:`extras_phases`) over
    theta on the f32 Laplace deviance of f32 PIRLS modes (a non-finite one
    ranks as 1e30), the carry (beta, v) from (beta0, 0); the cold f64 fit at
    the optimum (N_PIRLS steps from (beta0, 0)), its Laplace deviance and
    cov = (X'WX - acc + 1e-10 I)^-1 by the width rule, or under ``hessian``
    2 H^-1 of central differences of the v-profiled deviance (N_V_PIRLS
    v-only f64 passes a stencil point, always through the dense capacitance,
    as the reference's). Every pass is :func:`_extras_pass`: the structured
    capacitance when every grouping is intercept-only, unless ``dense``.
    ``theta (sims, G, d)`` f64, where given, replaces the search's optimum.

    Returns f64 ``beta (sims, G, pf)``, ``cov``, bool ``converged`` and
    ``boundary`` (any pin), f64 ``tau2_hat = Lam1[0, 0]^2`` (no sigma^2) and
    ``ybar``, bool ``pinned (sims, G, sum q)`` (diag Lg < EXTRAS_PIN, the
    primary's components first) and the optimum ``theta (sims, G, d)``.
    """
    cells = _JointCells(code, X, y, fit, grid, groups)
    sims, G, pf, M = X.shape[0], len(grid), len(fit), cells.M
    d = sum(q * (q + 1) // 2 for q in cells.comps)
    dense = dense or any(q > 1 for q in cells.comps)
    dev_ = X.device
    f64, f32 = torch.float64, torch.float32
    theta0 = torch.as_tensor(np.asarray(theta0), dtype=f64, device=dev_)
    lower = torch.as_tensor(np.asarray(lower), dtype=f64, device=dev_)
    beta0 = beta0.to(device=dev_, dtype=f64)
    cl = sims * G

    if theta is None:
        def search_eval(points, aux, budget):
            k = points.shape[1]
            th = points.reshape(sims, G, k, d).to(f32)
            beta = aux[0].reshape(sims, G, 1, pf).expand(sims, G, k, pf)
            v = aux[1].reshape(sims, G, 1, M).expand(sims, G, k, M)
            for _ in range(budget):
                beta, v = _extras_pass(cells, f32, th, beta, v, "step", dense)
            lap = _extras_pass(cells, f32, th, beta, v, "tail", dense).to(f64)
            lap = torch.where(torch.isfinite(lap), lap, torch.full_like(lap, SLOPE_SENTINEL))
            return lap.reshape(cl, k), (beta.reshape(cl, k, pf), v.reshape(cl, k, M))

        aux0 = (beta0.to(f32).expand(cl, pf), torch.zeros((cl, M), dtype=f32, device=dev_))
        theta_hat, _, _ = optim.nelder_mead_carry(
            search_eval, theta0.expand(cl, d), aux0, phases=extras_phases(d),
            init_step=NM_STEP_SLOPE, lower=lower)
        theta_hat = theta_hat.reshape(sims, G, d)
    else:
        theta_hat = theta.to(device=dev_, dtype=f64).reshape(sims, G, d)

    # the cold f64 fit at the optimum, its Laplace deviance and Schur matrix
    th = theta_hat[:, :, None]
    beta = beta0.expand(sims, G, 1, pf)
    v = torch.zeros((sims, G, 1, M), dtype=f64, device=dev_)
    for _ in range(N_PIRLS):
        beta, v = _extras_pass(cells, f64, th, beta, v, "step", dense)
    lap, a_xx = _extras_pass(cells, f64, th, beta, v, "mode", dense)
    chol = smallchol.chol_auto(a_xx)
    cov = smallchol.cho_inverse_auto(chol)
    if hessian:  # the v-profiled Laplace deviance at the stencil (:486-517)
        offs = torch.as_tensor(hessian_offsets(pf) * HESSIAN_STEP, dtype=f64, device=dev_)
        beta_q = beta + offs  # (S, G, V, pf)
        v_q = v.expand(sims, G, offs.shape[0], M)
        th_q = th.expand(sims, G, offs.shape[0], d)
        for _ in range(N_V_PIRLS):
            v_q = _extras_pass(cells, f64, th_q, beta_q, v_q, "vstep", True)
        vals = _extras_pass(cells, f64, th_q, beta_q, v_q, "tail", True)
        cov = _stencil_cov(vals, beta[:, :, 0], cov[:, :, 0])[:, :, None]
    ridge = torch.diag_embed(torch.full_like(beta, 1e-10))
    converged = (torch.isfinite(beta).all(-1) & smallchol.chol_ok(chol)
                 & smallchol.chol_rank_ok(smallchol.chol_auto(a_xx - ridge))
                 & torch.isfinite(lap))[:, :, 0]
    diag, off = [], 0
    for q in cells.comps:
        diag += [off + k for k in vech_diagonal(q)]
        off += q * (q + 1) // 2
    pinned = theta_hat[..., diag] < EXTRAS_PIN
    l00 = theta_hat[..., 0]
    ysum = cells.total(cells.y[f64][:, :, 0] * cells.mask[f64][:, 0])
    return (beta[:, :, 0], cov[:, :, 0], converged, pinned.any(-1), l00 * l00,
            ysum / cells.ns, pinned, theta_hat)


# ---------------------------------------------------------------------------
# K12 on the card
# ---------------------------------------------------------------------------

_GLMM_EXTRAS_ARGS = [
    ctypes.c_void_p,  # X (sims, max_n, P) f32
    ctypes.c_void_p,  # y (sims, max_n) f32
    ctypes.c_int,  # sims
    ctypes.c_int,  # max_n
    ctypes.c_int,  # P
    ctypes.POINTER(ctypes.c_int),  # fit columns (host)
    ctypes.c_int,  # pf
    ctypes.c_int,  # groupings
    ctypes.POINTER(ctypes.c_int),  # levels per grouping (host)
    ctypes.POINTER(ctypes.c_int),  # components per grouping (host)
    ctypes.POINTER(ctypes.c_int),  # slope columns, comps - 1 a grouping, concatenated (host)
    ctypes.c_void_p,  # ids (ng, max_n) int32
    ctypes.c_void_p,  # level offsets, m_g + 1 a grouping, int32
    ctypes.c_void_p,  # rows by level (ng, max_n) int32
    ctypes.c_void_p,  # grid (G,) int32, device
    ctypes.c_int,  # G
    ctypes.c_int,  # link code
    ctypes.c_void_p,  # beta0 (pf,) f64, device
    ctypes.POINTER(ctypes.c_double),  # theta0 (d,) host
    ctypes.POINTER(ctypes.c_double),  # lower (d,) host
    ctypes.c_int,  # hessian
    ctypes.c_int,  # force the dense capacitance
    ctypes.c_void_p,  # theta in (sims, G, d) f64, or null: fit there, no search
    ctypes.c_void_p,  # scratch: mcp_glmm_extras_scratch_bytes
    ctypes.c_void_p,  # beta out (sims, G, pf) f64
    ctypes.c_void_p,  # cov out (sims, G, pf, pf) f64
    ctypes.c_void_p,  # tau2_hat out (sims, G) f64
    ctypes.c_void_p,  # ybar out (sims, G) f64
    ctypes.c_void_p,  # flags out (sims, G) uint8: bit0 converged, bit1 boundary
    ctypes.c_void_p,  # pinned out (sims, G, sum q) uint8
    ctypes.c_void_p,  # theta out (sims, G, d) f64
    ctypes.c_void_p,  # cudaStream_t
]


def extras_row_lists(groups, max_n: int):
    """K12's row lists, built on the host once a launch (the level ids
    depend on the spec and the row alone): ``ids (ng, max_n)``, each
    grouping's level offsets (m_g + 1 each, concatenated) and its rows by
    level, ascending ``(ng, max_n)``, all int32 numpy."""
    ids = np.stack([np.asarray(g.cpu() if torch.is_tensor(g) else g, dtype=np.int64)
                    for g, _, _ in groups])
    offs, rows = [], []
    for (_, m, _), lv in zip(groups, ids):
        rows.append(np.argsort(lv * max_n + np.arange(max_n), kind="stable"))
        offs.append(np.concatenate([[0], np.cumsum(np.bincount(lv, minlength=int(m)))]))
    return (ids.astype(np.int32), np.concatenate(offs).astype(np.int32),
            np.stack(rows).astype(np.int32))


def glmm_extras_scratch_bytes(cells: int, M: int, m1: int, p: int, max_n: int,
                              structured: bool, hessian: bool) -> int:
    """Bytes of device scratch K12 takes for ``cells`` cells (its C entry
    point's count; ``m1`` the primary's columns). Builds and loads K12;
    needs a CUDA device."""
    fn = kernels.KERNELS["glmm_extras"].fn("mcp_glmm_extras_scratch_bytes",
                                           [ctypes.c_longlong] + [ctypes.c_int] * 7)
    fn.restype = ctypes.c_longlong
    return int(fn(cells, M, m1, M - m1, p, max_n, int(structured), int(hessian)))


_EXTRAS_GEOMETRY_KEYS = ("areas_shared", "stage_shared", "dynamic_smem", "static_smem",
                         "cells_per_sm", "p_bucket", "register_bound_cells", "cap_shared")


def glmm_extras_geometry(code: int, X: torch.Tensor, y: torch.Tensor, fit: Sequence[int],
                         grid: Sequence[int], groups, beta0=None, theta0=None, lower=None,
                         hessian: bool = False, theta=None, dense: bool = False) -> Dict[str, int]:
    """The form K12's C launcher takes for :func:`glmm_extras_kernel`'s
    arguments (the same order; only the shapes count): ``areas_shared`` 1
    where the four warps' f32 work areas sit in shared memory (else device
    scratch), ``stage_shared`` 1 where the staged rows do, the dynamic and
    static shared bytes a block, resident cells an SM, the p bucket and the
    cells an SM its registers are held to (3 or 1) of the kernel variant
    that runs, and ``cap_shared`` 1 where the areas are in scratch but their
    capacitance parts in shared memory. Builds and loads K12; needs a CUDA
    device."""
    fit = [int(c) for c in fit]
    levels = [int(m) for _, m, _ in groups]
    comps = [1 + len(cols) for _, _, cols in groups]
    zcols = [int(c) for _, _, cols in groups for c in cols]
    sims, max_n, P = X.shape
    pf, ng = len(fit), len(groups)
    out = (ctypes.c_int * len(_EXTRAS_GEOMETRY_KEYS))()
    fn = kernels.KERNELS["glmm_extras"].fn("mcp_glmm_extras_geometry", [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 4
        + [ctypes.POINTER(ctypes.c_int)])
    err = fn(sims, max_n, P, (ctypes.c_int * pf)(*fit), pf, ng, (ctypes.c_int * ng)(*levels),
             (ctypes.c_int * ng)(*comps), (ctypes.c_int * max(len(zcols), 1))(*zcols),
             len(list(grid)), code, int(hessian), int(dense), out)
    if err != 0:
        raise RuntimeError(f"glmm_extras geometry failed with CUDA error {err}")
    return dict(zip(_EXTRAS_GEOMETRY_KEYS, out))


def glmm_extras_set_form(form: int) -> None:
    """Where K12's later launches put the warps' f32 work areas: 0 as its
    launcher picks, 1 shared memory where they fit, 2 device scratch, 3
    scratch with their capacitance parts in shared memory where those fit.
    Every form gives the same bits; a knob to time one against another."""
    fn = kernels.KERNELS["glmm_extras"].fn("mcp_glmm_extras_set_form", [ctypes.c_int])
    fn.restype = None
    fn(int(form))


def glmm_extras_kernel(code: int, X: torch.Tensor, y: torch.Tensor, fit: Sequence[int],
                       grid: Sequence[int], groups, beta0: torch.Tensor, theta0, lower,
                       hessian: bool = False, theta: torch.Tensor = None, dense: bool = False):
    """Kernel K12: :func:`glmm_extras_plain` on the card (the same optional
    arguments), a (sim, grid) cell a block, its four warps the search's four
    candidates, with the device scratch its C entry point sizes."""
    fit, grid = [int(c) for c in fit], [int(n) for n in grid]
    levels = [int(m) for _, m, _ in groups]
    comps = [1 + len(cols) for _, _, cols in groups]
    zcols = [int(c) for _, _, cols in groups for c in cols]
    pf, G, ng = len(fit), len(grid), len(groups)
    M = sum(m * q for m, q in zip(levels, comps))
    d = sum(q * (q + 1) // 2 for q in comps)
    if not 1 <= pf <= MAX_P:
        raise ValueError(f"glmm_extras kernel takes 1 <= p <= {MAX_P}, got {pf}")
    if not 2 <= ng <= EXTRAS_MAX_GROUPINGS or M > EXTRAS_MAX_M or d > EXTRAS_MAX_D \
            or max(comps) > MAX_SLOPE_Q:
        raise ValueError(f"glmm_extras kernel takes 2..{EXTRAS_MAX_GROUPINGS} groupings, M <= "
                         f"{EXTRAS_MAX_M}, d <= {EXTRAS_MAX_D}; got {ng}, M {M}, d {d}")
    if X.dtype != torch.float32 or y.dtype != torch.float32:
        raise ValueError("glmm_extras kernel takes f32 X and y")
    sims, max_n, P = X.shape
    theta0, lower = np.asarray(theta0, np.float64), np.asarray(lower, np.float64)
    if y.shape != (sims, max_n) or beta0.shape != (pf,) or theta0.shape != (d,) \
            or lower.shape != (d,):
        raise ValueError(f"glmm_extras: X {tuple(X.shape)}, y {tuple(y.shape)}, beta0 "
                         f"{tuple(beta0.shape)}, theta0 {theta0.shape} for p {pf}, d {d}")
    if G == 0 or any(not 0 < n <= max_n for n in grid) or any(not 0 <= c < P for c in fit + zcols):
        raise ValueError(f"glmm_extras: grid {grid}, fit {fit} or slope columns {zcols} out of "
                         "range")
    dev_ = X.device
    X, y = X.contiguous(), y.contiguous()
    beta0 = beta0.to(device=dev_, dtype=torch.float64).contiguous()
    ids, offs, rows = (torch.as_tensor(a, device=dev_) for a in extras_row_lists(groups, max_n))
    grid_t = torch.tensor(grid, dtype=torch.int32, device=dev_)
    kw = dict(dtype=torch.float64, device=dev_)
    beta = torch.empty((sims, G, pf), **kw)
    cov = torch.empty((sims, G, pf, pf), **kw)
    tau2, ybar = torch.empty((sims, G), **kw), torch.empty((sims, G), **kw)
    theta_out = torch.empty((sims, G, d), **kw)
    flags = torch.empty((sims, G), dtype=torch.uint8, device=dev_)
    pinned = torch.empty((sims, G, sum(comps)), dtype=torch.uint8, device=dev_)
    if theta is not None:
        theta = theta.to(**kw).reshape(sims, G, d).contiguous()
    kernels.require_cuda("glmm_extras", X, y, ids, offs, rows, grid_t, beta0, beta, cov, tau2,
                         ybar, theta_out, flags, pinned, *(() if theta is None else (theta,)))
    if sims:
        structured = all(q == 1 for q in comps) and not dense
        scratch = torch.empty(glmm_extras_scratch_bytes(sims * G, M, levels[0] * comps[0], pf,
                                                        max_n, structured, hessian),
                              dtype=torch.uint8, device=dev_)
        k = kernels.KERNELS["glmm_extras"]
        fn = k.fn("mcp_glmm_extras", _GLMM_EXTRAS_ARGS)
        k.check(fn(
            kernels.ptr(X), kernels.ptr(y), sims, max_n, P, (ctypes.c_int * pf)(*fit), pf, ng,
            (ctypes.c_int * ng)(*levels), (ctypes.c_int * ng)(*comps),
            (ctypes.c_int * max(len(zcols), 1))(*zcols), kernels.ptr(ids), kernels.ptr(offs),
            kernels.ptr(rows), kernels.ptr(grid_t), G, code, kernels.ptr(beta0),
            (ctypes.c_double * d)(*theta0.tolist()), (ctypes.c_double * d)(*lower.tolist()),
            int(hessian), int(dense), ctypes.c_void_p(0) if theta is None else kernels.ptr(theta),
            kernels.ptr(scratch), kernels.ptr(beta), kernels.ptr(cov), kernels.ptr(tau2),
            kernels.ptr(ybar), kernels.ptr(flags), kernels.ptr(pinned), kernels.ptr(theta_out),
            kernels.stream_of(X)))
    return (beta, cov, (flags & 1).bool(), (flags & 2).bool(), tau2, ybar, pinned.bool(),
            theta_out)


def glmm_extras(code, X, y, fit, grid, groups, beta0, theta0, lower, hessian: bool = False):
    """K12 for CUDA tensors, the plain version for CPU tensors."""
    if X.is_cuda:
        return glmm_extras_kernel(code, X, y, fit, grid, groups, beta0, theta0, lower, hessian)
    if X.device.type != "cpu":
        raise ValueError(f"glmm_extras: no kernel for device {X.device}")
    return glmm_extras_plain(code, X, y, fit, grid, groups, beta0, theta0, lower, hessian)


# ---------------------------------------------------------------------------
# The arm
# ---------------------------------------------------------------------------


def layout_of(spec: SimSpec) -> Tuple[bool, int, int]:
    """(round robin, period, m at max_n) of the primary grouping."""
    c = spec.cluster
    return (c.sizing_mode == "fixed_clusters", max(int(c.sizing_value), 1),
            c.n_clusters_at(spec.max_n))


def glmm_grid_stats(spec: SimSpec, arr: Dict[str, torch.Tensor], X: torch.Tensor,
                    y: torch.Tensor, *, plain: bool = False) -> Dict[str, torch.Tensor]:
    """All GLMM statistics for a batch of sims across the grid (the
    reference's ``glmm_grid_stats``, :140): ``t2``, ``overall`` (the joint
    Wald chi^2), ``converged``, ``boundary_hit`` and ``singular`` (the tau^2
    = 0 pin, or with slopes any component's pin), ``tau2_hat``,
    ``glm_baseline`` (the realized outcome mean) and ``pinned_comp`` (per
    component); ``posthoc_t2`` for a posthoc spec. A random intercept goes
    to K7, random slopes to K10, extra groupings to K12 (``pinned_comp`` then
    one column a component of every grouping, the primary's first);
    ``plain=True`` runs their plain versions on any device.
    """
    c = spec.cluster
    if c is None:
        raise ValueError("a GLMM needs a cluster spec")
    fit = list(spec.effective_fit_cols)
    if spec.scenario.truth_start:
        beta0 = arr["effects"].to(device=X.device, dtype=torch.float64)[fit]
    else:
        beta0 = torch.zeros(len(fit), dtype=torch.float64, device=X.device)
    code, hessian = link_code(spec.outcome, spec.link), spec.wald_se == "hessian"
    if c.extra_groupings:  # the joint-Z Laplace path; nagq is 1 (contract error 25)
        _, theta0, lower = theta_layout(grouping_plan(spec))
        beta, cov, converged, boundary, tau2_hat, ybar, pinned, _ = (
            glmm_extras_plain if plain else glmm_extras
        )(code, X, y, fit, spec.grid, joint_layout(spec, X.device)[0], beta0, theta0, lower,
          hessian)
    elif c.slopes:  # the q-dimensional Nelder-Mead path; nagq does not apply (:572)
        from .mixedfit import slope_start

        theta0, lower = slope_start(spec)
        beta, cov, converged, boundary, tau2_hat, ybar, pinned, _ = (
            glmm_slope_plain if plain else glmm_slope
        )(code, X, y, fit, [s.design_col for s in c.slopes], spec.grid, layout_of(spec), beta0,
          theta0, lower, hessian)
    else:
        beta, cov, converged, boundary, tau2_hat, ybar = (
            glmm_intercept_plain if plain else glmm_intercept
        )(code, X, y, fit, spec.grid, layout_of(spec), beta0, max(int(spec.nagq), 1), hessian)
        pinned = boundary[..., None]
    out = {
        "t2": waldstats.t2_targets(spec, beta, cov),
        "overall": waldstats.overall_wald_chi2(spec, beta, cov),
        "converged": converged,
        "boundary_hit": boundary,
        "singular": boundary,
        "tau2_hat": tau2_hat,
        "glm_baseline": ybar,
        "pinned_comp": pinned & converged[..., None],
    }
    return waldstats.add_posthoc(out, spec, beta, cov)
