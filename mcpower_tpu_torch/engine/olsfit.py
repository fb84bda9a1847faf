"""Batched OLS over the CRN sample-size grid via prefix sufficient statistics.

Rows are prefix-stable, so X'X, X'y, y'y and sum(y) at grid point g are the
point-(g-1) statistics plus one row segment's contribution. Two kernels
carry the arm on the card:

* K2 ``grid_suffstats`` (``csrc/grid_suffstats.cu``): per-segment sums in
  f64 from the f32 design, the per-cluster n_j, s_j, t_j for the mixed arm
  (and, in its slope mode, the per-cluster Z moments G, A, b of the
  random-slope fit; in its joint mode, an entry of its own, the joint Z'Z,
  Z'X, Z'y of extra groupings), and the cumulative sum over the grid;
* K3 ``ols_solve`` (``csrc/ols_solve.cu``): per (sim, grid) cell the
  Cholesky solve, inverse, rss, sigma^2, Wald covariance, overall F and the
  pivot-ratio convergence flag.

Each wrapper launches its kernel for CUDA tensors and runs its plain
PyTorch version (``*_plain``, beside it) for CPU tensors. Fits run in f64;
generation stays f32.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import clusterops, kernels, smallchol, waldstats
from .spec import SimSpec

EPS_RANK = smallchol.EPS_RANK
MAX_P = kernels.MAX_FIT_P


# ---------------------------------------------------------------------------
# K2: grid (and cluster) sufficient statistics
# ---------------------------------------------------------------------------


def _layout_args(spec: SimSpec, with_clusters: bool):
    if not with_clusters:
        return 0, 1, 1
    c = spec.cluster
    m = c.n_clusters_at(spec.max_n)
    return m, int(c.sizing_mode == "fixed_clusters"), max(int(c.sizing_value), 1)


def slope_cols(spec: SimSpec):
    """The design columns of the primary grouping's random slopes (indices
    of X, not of the fit columns), in component order."""
    c = spec.cluster
    return [s.design_col for s in c.slopes] if c is not None else []


def grid_suffstats_plain(spec: SimSpec, X: torch.Tensor, y: torch.Tensor,
                         with_clusters: bool = False, with_slopes: bool = False
                         ) -> Dict[str, torch.Tensor]:
    """Prefix sufficient statistics per grid point for a batch of sims.

    ``X (sims, max_n, P) f32``, ``y (sims, max_n) f32``. Returns f64
    ``xtx (sims, G, p, p)``, ``xty (sims, G, p)``, ``yty``, ``ysum (sims,
    G)`` over the fit columns, and with ``with_clusters`` also ``n_j (sims,
    G, m)``, ``s (sims, G, m, p)``, ``t (sims, G, m)``. ``with_slopes`` (a
    spec with random slopes) adds the reference's ``_slope_cluster_suffstats``
    (:263) with the random-effect design Z = [1, X[:, slope_cols]] of q
    columns: ``G = sum z z' (sims, G, m, q, q)``, ``A = sum z x' (sims, G,
    m, q, p)`` and ``b = sum z y (sims, G, m, q)``; their first row is n_j,
    s and t.
    """
    fit = list(spec.effective_fit_cols)
    Xf = X[..., fit].to(torch.float64)
    yf = y.to(torch.float64)
    m = _layout_args(spec, with_clusters or with_slopes)[0]
    Zf = None
    if with_slopes:
        Zf = torch.cat([torch.ones_like(yf)[..., None], X[..., slope_cols(spec)].to(torch.float64)],
                       dim=-1)
    segs = {k: [] for k in ("xtx", "xty", "yty", "ysum", "n_j", "s", "t", "G", "A", "b")}

    def seg(v, prev):  # (sims, rows, ...) -> (sims, m, ...)
        moved = v.movedim(1, -1)
        return clusterops.seg_segment(spec, moved, prev, m).movedim(-1, 1)

    prev = 0
    for n in spec.grid:
        Xs = Xf[:, prev:n]
        ys = yf[:, prev:n]
        segs["xtx"].append(torch.einsum("bnp,bnq->bpq", Xs, Xs))
        segs["xty"].append(torch.einsum("bnp,bn->bp", Xs, ys))
        segs["yty"].append((ys * ys).sum(-1))
        segs["ysum"].append(ys.sum(-1))
        if with_clusters or with_slopes:
            ones = torch.ones_like(ys)
            segs["n_j"].append(clusterops.seg_segment(spec, ones, prev, m))
            segs["s"].append(
                clusterops.seg_segment(spec, Xs.transpose(-1, -2), prev, m).transpose(-1, -2)
            )
            segs["t"].append(clusterops.seg_segment(spec, ys, prev, m))
        if with_slopes:
            Zs = Zf[:, prev:n]
            segs["G"].append(seg(Zs[..., :, None] * Zs[..., None, :], prev))
            segs["A"].append(seg(Zs[..., :, None] * Xs[..., None, :], prev))
            segs["b"].append(seg(Zs * ys[..., None], prev))
        prev = n
    return {k: torch.cumsum(torch.stack(v, dim=1), dim=1) for k, v in segs.items() if v}


_SUFF_ARGS = [
    ctypes.c_void_p,  # X (sims, max_n, P) f32
    ctypes.c_void_p,  # y (sims, max_n) f32
    ctypes.c_int,  # sims
    ctypes.c_int,  # max_n
    ctypes.c_int,  # P
    ctypes.POINTER(ctypes.c_int),  # fit columns
    ctypes.c_int,  # pf
    ctypes.POINTER(ctypes.c_int),  # grid (host, for the checks and the row chunks)
    ctypes.c_void_p,  # grid (G,) int32 (device, for the kernel)
    ctypes.c_int,  # G
    ctypes.c_int,  # m (0: no cluster statistics)
    ctypes.c_int,  # round robin (1) or blocked (0)
    ctypes.c_int,  # layout period
    ctypes.c_void_p,  # xtx out (sims, G, pf, pf) f64
    ctypes.c_void_p,  # xty out (sims, G, pf)
    ctypes.c_void_p,  # yty out (sims, G)
    ctypes.c_void_p,  # ysum out (sims, G)
    ctypes.c_void_p,  # n_j out (sims, G, m) or null
    ctypes.c_void_p,  # s out (sims, G, m, pf) or null
    ctypes.c_void_p,  # t out (sims, G, m) or null
    ctypes.POINTER(ctypes.c_int),  # slope columns of X (host), or null
    ctypes.c_int,  # slope columns, qs = q - 1 (0: no slope statistics)
    ctypes.c_void_p,  # G out (sims, G, m, q, q) or null
    ctypes.c_void_p,  # A out (sims, G, m, q, pf) or null
    ctypes.c_void_p,  # b out (sims, G, m, q) or null
    ctypes.c_void_p,  # cudaStream_t
]
MAX_SLOPES = 3  # K2's slope mode: q <= 4


def grid_suffstats_kernel(spec: SimSpec, X: torch.Tensor, y: torch.Tensor,
                          with_clusters: bool = False, with_slopes: bool = False
                          ) -> Dict[str, torch.Tensor]:
    """Kernel K2: :func:`grid_suffstats_plain` on the card."""
    fit = list(spec.effective_fit_cols)
    pf, G = len(fit), spec.n_grid
    if pf > MAX_P:
        raise ValueError(f"grid_suffstats kernel takes p <= {MAX_P}, got {pf}")
    if X.dtype != torch.float32 or y.dtype != torch.float32:
        raise ValueError("grid_suffstats kernel takes f32 X and y")
    sims, max_n, P = X.shape
    if max_n != spec.max_n or y.shape != (sims, max_n):
        raise ValueError(f"grid_suffstats: X {tuple(X.shape)}, y {tuple(y.shape)} for max_n {spec.max_n}")
    zcols = slope_cols(spec) if with_slopes else []
    if with_slopes and not 0 < len(zcols) <= MAX_SLOPES:
        raise ValueError(f"grid_suffstats kernel takes 1..{MAX_SLOPES} slopes, got {len(zcols)}")
    clusters = with_clusters or with_slopes
    m, rr, period = _layout_args(spec, clusters)
    q = 1 + len(zcols)
    kw = dict(dtype=torch.float64, device=X.device)
    out = {
        "xtx": torch.empty((sims, G, pf, pf), **kw),
        "xty": torch.empty((sims, G, pf), **kw),
        "yty": torch.empty((sims, G), **kw),
        "ysum": torch.empty((sims, G), **kw),
    }
    if clusters:
        out["n_j"] = torch.empty((sims, G, m), **kw)
        out["s"] = torch.empty((sims, G, m, pf), **kw)
        out["t"] = torch.empty((sims, G, m), **kw)
    if with_slopes:
        out["G"] = torch.empty((sims, G, m, q, q), **kw)
        out["A"] = torch.empty((sims, G, m, q, pf), **kw)
        out["b"] = torch.empty((sims, G, m, q), **kw)
    grid_t = torch.tensor(spec.grid, dtype=torch.int32, device=X.device)
    kernels.require_cuda("grid_suffstats", X, y, grid_t, *out.values())
    if sims == 0:
        return out
    null = ctypes.c_void_p(0)

    def opt(key):
        return kernels.ptr(out[key]) if key in out else null

    k = kernels.KERNELS["grid_suffstats"]
    fn = k.fn("mcp_grid_suffstats", _SUFF_ARGS)
    k.check(
        fn(
            kernels.ptr(X), kernels.ptr(y), sims, max_n, P,
            (ctypes.c_int * pf)(*fit), pf, (ctypes.c_int * G)(*spec.grid), kernels.ptr(grid_t), G,
            m, rr, period,
            kernels.ptr(out["xtx"]), kernels.ptr(out["xty"]),
            kernels.ptr(out["yty"]), kernels.ptr(out["ysum"]),
            opt("n_j"), opt("s"), opt("t"),
            (ctypes.c_int * max(len(zcols), 1))(*zcols), len(zcols), opt("G"), opt("A"), opt("b"),
            kernels.stream_of(X),
        )
    )
    return out


def grid_suffstats(spec: SimSpec, X: torch.Tensor, y: torch.Tensor,
                   with_clusters: bool = False, with_slopes: bool = False
                   ) -> Dict[str, torch.Tensor]:
    """K2 for CUDA tensors, the plain version for CPU tensors."""
    if X.is_cuda:
        return grid_suffstats_kernel(spec, X.contiguous(), y.contiguous(), with_clusters,
                                     with_slopes)
    if X.device.type != "cpu":
        raise ValueError(f"grid_suffstats: no kernel for device {X.device}")
    return grid_suffstats_plain(spec, X, y, with_clusters, with_slopes)


# ---------------------------------------------------------------------------
# K2's joint mode: the joint-Z statistics of extra groupings
# ---------------------------------------------------------------------------


def joint_layout(spec: SimSpec, device=None):
    """The joint Z of a spec with extra groupings, as the reference's
    ``_build_joint_z`` (:511) lays it out: per grouping (the primary first)
    its level ids ``(max_n,)`` int32, levels m_g and the design columns of
    its slopes; grouping g owns columns ``off_g + level * q_g + r`` with
    value 1 (r = 0) or ``X[:, slope_cols[r - 1]]``. Returns ``[(ids, m_g,
    slope_cols)]`` and M."""
    from . import datagen

    c = spec.cluster
    groups = [(datagen.cluster_ids(spec, device), c.n_clusters_at(spec.max_n), slope_cols(spec))]
    for g, eg in enumerate(c.extra_groupings):
        ids, n_lv = datagen.extra_grouping_ids(spec, g, device)
        groups.append((ids, n_lv, [s.design_col for s in eg.slopes]))
    return groups, sum(m * (1 + len(cols)) for _, m, cols in groups)


def _joint_z(spec: SimSpec, X: torch.Tensor):
    """Per row the Z columns it touches ``(max_n, Q)`` int64 (Q = sum q_g)
    and their values ``(sims, max_n, Q)`` f64."""
    groups, M = joint_layout(spec, X.device)
    cols, vals, off = [], [], 0
    for ids, m, scols in groups:
        q = 1 + len(scols)
        for r in range(q):
            cols.append(off + ids.long() * q + r)
            vals.append(torch.ones_like(X[..., 0], dtype=torch.float64) if r == 0
                        else X[..., scols[r - 1]].to(torch.float64))
        off += m * q
    return torch.stack(cols, dim=-1), torch.stack(vals, dim=-1), M


def joint_suffstats_plain(spec: SimSpec, X: torch.Tensor, y: torch.Tensor
                          ) -> Dict[str, torch.Tensor]:
    """The reference's ``_joint_suffstats`` (:570) without a dense Z: per
    grid prefix ``ztz (sims, G, M, M)``, ``ztx (sims, G, M, p)``, ``zty
    (sims, G, M)`` f64 from each row's Z columns (:func:`_joint_z`), summed
    by ``scatter_add``, with :func:`grid_suffstats_plain`'s ``xtx``,
    ``xty``, ``yty`` and ``ysum``. Counts are exact; the X sums agree with
    kernel K2's joint mode to rounding."""
    out = grid_suffstats_plain(spec, X, y)
    fit = list(spec.effective_fit_cols)
    Xf = X[..., fit].to(torch.float64)
    yf = y.to(torch.float64)
    cols, vals, M = _joint_z(spec, X)
    sims, Q, p = X.shape[0], cols.shape[-1], len(fit)
    segs = {"ztz": [], "ztx": [], "zty": []}
    prev = 0
    for n in spec.grid:
        c, v = cols[prev:n], vals[:, prev:n]
        rows = n - prev
        idx = (c[:, :, None] * M + c[:, None, :]).reshape(1, -1).expand(sims, -1)
        segs["ztz"].append(torch.zeros((sims, M * M), dtype=torch.float64, device=X.device)
                           .scatter_add_(1, idx, (v[..., :, None] * v[..., None, :])
                                         .reshape(sims, -1)).reshape(sims, M, M))
        kk = torch.arange(p, device=X.device)
        idx = (c[:, :, None] * p + kk).reshape(1, -1).expand(sims, -1)
        segs["ztx"].append(torch.zeros((sims, M * p), dtype=torch.float64, device=X.device)
                           .scatter_add_(1, idx, (v[..., :, None] * Xf[:, prev:n, None, :])
                                         .reshape(sims, -1)).reshape(sims, M, p))
        idx = c.reshape(1, rows * Q).expand(sims, -1)
        segs["zty"].append(torch.zeros((sims, M), dtype=torch.float64, device=X.device)
                           .scatter_add_(1, idx, (v * yf[:, prev:n, None]).reshape(sims, -1)))
        prev = n
    out.update({k: torch.cumsum(torch.stack(v, dim=1), dim=1) for k, v in segs.items()})
    return out


_JOINT_ARGS = [
    ctypes.c_void_p,  # X (sims, max_n, P) f32
    ctypes.c_void_p,  # y (sims, max_n) f32
    ctypes.c_int,  # sims
    ctypes.c_int,  # max_n
    ctypes.c_int,  # P
    ctypes.POINTER(ctypes.c_int),  # fit columns (host)
    ctypes.c_int,  # pf
    ctypes.POINTER(ctypes.c_int),  # grid (host, for the checks)
    ctypes.c_void_p,  # grid (G,) int32 (device, for the kernel)
    ctypes.c_int,  # G
    ctypes.c_void_p,  # level ids (n_groupings, max_n) int32 (device)
    ctypes.c_int,  # n_groupings
    ctypes.POINTER(ctypes.c_int),  # levels per grouping (host)
    ctypes.POINTER(ctypes.c_int),  # components per grouping (host)
    ctypes.POINTER(ctypes.c_int),  # slope columns of X, grouping by grouping (host)
    ctypes.c_void_p,  # ztz out (sims, G, M, M) f64
    ctypes.c_void_p,  # ztx out (sims, G, M, pf)
    ctypes.c_void_p,  # zty out (sims, G, M)
    ctypes.c_void_p,  # cudaStream_t
]


def joint_suffstats_kernel(spec: SimSpec, X: torch.Tensor, y: torch.Tensor
                           ) -> Dict[str, torch.Tensor]:
    """K2's joint mode: :func:`joint_suffstats_plain` on the card, a launch
    of K2 for ``xtx``, ``xty``, ``yty``, ``ysum`` and one of its joint entry
    (``mcp_grid_suffstats_joint``, counted under the tag ``joint``) for
    ``ztz``, ``ztx``, ``zty``."""
    out = grid_suffstats_kernel(spec, X, y)
    fit = list(spec.effective_fit_cols)
    pf, G = len(fit), spec.n_grid
    sims, max_n, P = X.shape
    groups, M = joint_layout(spec, X.device)
    ids = torch.stack([g[0] for g in groups]).contiguous()
    levels = [g[1] for g in groups]
    comps = [1 + len(g[2]) for g in groups]
    scols = [c for g in groups for c in g[2]]
    kw = dict(dtype=torch.float64, device=X.device)
    out["ztz"] = torch.empty((sims, G, M, M), **kw)
    out["ztx"] = torch.empty((sims, G, M, pf), **kw)
    out["zty"] = torch.empty((sims, G, M), **kw)
    grid_t = torch.tensor(spec.grid, dtype=torch.int32, device=X.device)
    kernels.require_cuda("grid_suffstats", X, y, ids, grid_t, out["ztz"], out["ztx"], out["zty"])
    if sims == 0:
        return out
    k = kernels.KERNELS["grid_suffstats"]
    fn = k.fn("mcp_grid_suffstats_joint", _JOINT_ARGS)
    ng = len(groups)
    k.check(
        fn(
            kernels.ptr(X), kernels.ptr(y), sims, max_n, P, (ctypes.c_int * pf)(*fit), pf,
            (ctypes.c_int * G)(*spec.grid), kernels.ptr(grid_t), G, kernels.ptr(ids), ng,
            (ctypes.c_int * ng)(*levels), (ctypes.c_int * ng)(*comps),
            (ctypes.c_int * max(len(scols), 1))(*scols),
            kernels.ptr(out["ztz"]), kernels.ptr(out["ztx"]), kernels.ptr(out["zty"]),
            kernels.stream_of(X),
        ),
        tag="joint",
    )
    return out


def joint_suffstats(spec: SimSpec, X: torch.Tensor, y: torch.Tensor) -> Dict[str, torch.Tensor]:
    """K2's joint mode for CUDA tensors, the plain version for CPU tensors."""
    if X.is_cuda:
        return joint_suffstats_kernel(spec, X.contiguous(), y.contiguous())
    if X.device.type != "cpu":
        raise ValueError(f"joint_suffstats: no kernel for device {X.device}")
    return joint_suffstats_plain(spec, X, y)


# ---------------------------------------------------------------------------
# K3: the per-cell OLS solve
# ---------------------------------------------------------------------------


def ols_solve_plain(xtx, xty, yty, ysum, ns, p_eff=None):
    """Per-cell OLS from prefix statistics. ``xtx (..., G, p, p)``, ``xty
    (..., G, p)``, ``yty``/``ysum (..., G)``, ``ns (G,)`` f64 row counts;
    ``p_eff (..., G)`` f64, the columns each cell fits (a reduced fit's
    masked columns carry a unit pivot in ``xtx``), or None for p in every
    cell. ``p_eff`` sets the residual df ``max(n - p_eff, 1)`` and the
    overall F's ``max(p_eff - 1, 1)``.

    Returns ``beta (..., G, p)``, ``cov (..., G, p, p)`` (sigma^2 (X'X)^-1),
    ``overall (..., G)`` (the F statistic) and ``converged (..., G)``.
    """
    p = xtx.shape[-1]
    chol = smallchol.chol(xtx)
    beta = smallchol.cho_solve(chol, xty)
    inv = smallchol.cho_inverse(chol)
    rss = yty - (beta * xty).sum(-1)
    if p_eff is None:
        p_eff = float(p)
        df1 = max(p_eff - 1.0, 1.0)
    else:
        df1 = torch.clamp(p_eff - 1.0, min=1.0)
    sigma2 = rss / torch.clamp(ns - p_eff, min=1.0)
    cov = sigma2[..., None, None] * inv
    tss = yty - ysum * ysum / ns
    overall = ((tss - rss) / df1) / sigma2
    diag = torch.diagonal(chol, dim1=-2, dim2=-1)
    converged = (
        torch.isfinite(sigma2)
        & (sigma2 > 0.0)
        & torch.isfinite(diag).all(-1)
        & (diag > 0.0).all(-1)
        & (diag.amin(-1) >= EPS_RANK * diag.amax(-1))
    )
    return beta, cov, overall, converged


_SOLVE_ARGS = [
    ctypes.c_void_p,  # xtx (B, p, p) f64
    ctypes.c_void_p,  # xty (B, p)
    ctypes.c_void_p,  # yty (B,)
    ctypes.c_void_p,  # ysum (B,)
    ctypes.c_void_p,  # ns (G,) f64; cell b uses ns[b % G]
    ctypes.c_void_p,  # p_eff (B,) f64, or null for p
    ctypes.c_int,  # B
    ctypes.c_int,  # G
    ctypes.c_int,  # p
    ctypes.c_double,  # eps_rank
    ctypes.c_void_p,  # beta out (B, p)
    ctypes.c_void_p,  # cov out (B, p, p)
    ctypes.c_void_p,  # overall out (B,)
    ctypes.c_void_p,  # converged out (B,) uint8
    ctypes.c_void_p,  # cudaStream_t
]


def ols_solve_kernel(xtx, xty, yty, ysum, ns, p_eff=None):
    """Kernel K3: :func:`ols_solve_plain` on the card, a group of lanes per cell."""
    p, G = xtx.shape[-1], xtx.shape[-3]
    if not 1 <= p <= MAX_P:
        raise ValueError(f"ols_solve kernel takes 1 <= p <= {MAX_P}, got {p}")
    lead = xtx.shape[:-2]
    xtx, xty, yty, ysum, ns = (
        v.to(torch.float64).contiguous() for v in (xtx, xty, yty, ysum, ns)
    )
    if ns.shape != (G,) or xty.shape != lead + (p,) or yty.shape != lead or ysum.shape != lead:
        raise ValueError("ols_solve: inconsistent shapes")
    if p_eff is not None:
        p_eff = p_eff.to(device=xtx.device, dtype=torch.float64).expand(lead).contiguous()
    B = yty.numel()
    beta = torch.empty(lead + (p,), dtype=torch.float64, device=xtx.device)
    cov = torch.empty(lead + (p, p), dtype=torch.float64, device=xtx.device)
    overall = torch.empty(lead, dtype=torch.float64, device=xtx.device)
    conv = torch.empty(lead, dtype=torch.uint8, device=xtx.device)
    kernels.require_cuda("ols_solve", xtx, xty, yty, ysum, ns, beta, cov, overall, conv,
                         *([p_eff] if p_eff is not None else []))
    if B:
        k = kernels.KERNELS["ols_solve"]
        fn = k.fn("mcp_ols_solve", _SOLVE_ARGS)
        k.check(
            fn(
                kernels.ptr(xtx), kernels.ptr(xty), kernels.ptr(yty), kernels.ptr(ysum),
                kernels.ptr(ns), kernels.ptr(p_eff) if p_eff is not None else ctypes.c_void_p(0),
                B, G, p, EPS_RANK,
                kernels.ptr(beta), kernels.ptr(cov), kernels.ptr(overall), kernels.ptr(conv),
                kernels.stream_of(xtx),
            )
        )
    return beta, cov, overall, conv.bool()


def ols_solve(xtx, xty, yty, ysum, ns, p_eff=None):
    """K3 for CUDA tensors, the plain version for CPU tensors."""
    if xtx.is_cuda:
        return ols_solve_kernel(xtx, xty, yty, ysum, ns, p_eff)
    if xtx.device.type != "cpu":
        raise ValueError(f"ols_solve: no kernel for device {xtx.device}")
    return ols_solve_plain(xtx, xty, yty, ysum, ns, p_eff)


# ---------------------------------------------------------------------------
# The arm
# ---------------------------------------------------------------------------


def reduced_stats(xtx, xty, colmask):
    """The statistics of each cell's reduced fit under ``colmask (..., G,
    p)`` f64 0/1 (the reference's olsfit.py:91-95): X'X with the masked
    rows and columns zeroed and a unit diagonal, X'y with the masked entries
    zeroed, and ``p_eff``, the columns each cell keeps."""
    xtx = xtx * colmask[..., :, None] * colmask[..., None, :]
    xtx = xtx + torch.diag_embed(1.0 - colmask)
    return xtx, xty * colmask, colmask.sum(-1)


def ols_grid_stats(spec: SimSpec, X: torch.Tensor, y: torch.Tensor, *,
                   colmask: torch.Tensor = None, plain: bool = False) -> Dict[str, torch.Tensor]:
    """All OLS statistics for a batch of sims across the grid: ``t2 (sims,
    G, k)``, ``overall (sims, G)``, ``converged (sims, G)`` and, for a
    posthoc spec, ``posthoc_t2``.

    ``colmask (sims, G, pf)`` f64 0/1 runs each cell's reduced fit (the
    reference's :91-95): between K2 and K3 the masked rows and columns of
    X'X are zeroed and given a unit diagonal, which pins their beta at 0 and
    takes part in the pivot-ratio rank test as the reference's does, the
    masked entries of X'y are zeroed, and K3 takes ``p_eff = colmask.sum(-1)``
    per cell. ``plain=True`` runs the plain PyTorch versions on any device
    (used to time and check K2 and K3 against them).
    """
    suff = (grid_suffstats_plain if plain else grid_suffstats)(spec, X, y)
    ns = torch.as_tensor(spec.grid, dtype=torch.float64, device=X.device)
    xtx, xty, p_eff = suff["xtx"], suff["xty"], None
    if colmask is not None:
        xtx, xty, p_eff = reduced_stats(xtx, xty, colmask)
    beta, cov, overall, converged = (ols_solve_plain if plain else ols_solve)(
        xtx, xty, suff["yty"], suff["ysum"], ns, p_eff
    )
    out = {
        "t2": waldstats.t2_targets(spec, beta, cov),
        "overall": overall,
        "converged": converged,
    }
    return waldstats.add_posthoc(out, spec, beta, cov)
