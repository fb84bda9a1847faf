"""Batched, branch-free, shrink-free Nelder-Mead over a leading cell axis.

The port of ``mcpower_tpu.engine.optim`` (``_select_candidate`` :44,
``nelder_mead`` :61): a fixed number of iterations, each evaluating the four
candidates (reflection, expansion, outside and inside contraction) of every
cell in one batch and replacing the worst vertex by the selected one; when
no textbook case accepts, a reflection that improved on the worst vertex is
kept, else the inside contraction is taken, so no shrink is ever evaluated.
``theta`` is the vech-Cholesky of a q x q relative covariance (q <= 4, so
d = q (q + 1) / 2 <= 10).

This is the plain version of the search inside kernel K9
(``csrc/slope_reml.cu``), which repeats every step below in the same f64
operations and order: the stable sort of the d + 1 values (ties keep their
vertex order; every non-finite deviance is the same sentinel, so ties are
real), the centroid as the d best vertices added in sorted order and then
multiplied by the f64 reciprocal of d (as XLA computes the reference's
``jnp.mean``), each candidate clipped at ``lower`` (0 on Cholesky diagonals,
-inf elsewhere), the first minimum's vertex at the end.

:func:`nelder_mead_carry` is the same search with a warm-start state
threaded through it (the reference's ``nelder_mead_carry``, :113): every
candidate of an iteration starts its solver from the carried state, and the
accepted candidate's end state becomes the next carry. It is the plain
version of the searches inside kernels K10 (``csrc/glmm_slope.cu``) and K12
(``csrc/glmm_extras.cu``), with the same rules.
"""

from __future__ import annotations

import torch

ALPHA, GAMMA, RHO = 1.0, 2.0, 0.5


def select_candidate(f_best, second, f_worst, fr, fe, fc_out, fc_in):
    """Candidate index (0 reflect, 1 expand, 2 outside, 3 inside) for the
    worst vertex's replacement, elementwise over cells (the reference's
    ``_select_candidate``, with its precedence)."""
    use_expand = (fr < f_best) & (fe < fr)
    use_reflect = ((fr < second) & ~use_expand) | ((fr < f_best) & ~(fe < fr))
    use_cout = (~use_expand) & (~use_reflect) & (fr < f_worst) & (fc_out <= fr)
    use_rfall = (~use_expand) & (~use_reflect) & (fr < f_worst) & ~use_cout
    three = torch.full_like(fr, 3, dtype=torch.int64)
    return torch.where(use_expand, 1, torch.where(use_reflect | use_rfall, 0,
                                                  torch.where(use_cout, 2, three)))


def _initial(x0: torch.Tensor, init_step: float, lower):
    """The d + 1 starting vertices ``(cells, d + 1, d)``: x0 and x0 +
    init_step e_i, clipped."""
    eye = torch.eye(x0.shape[1], dtype=x0.dtype, device=x0.device)
    return _clip(torch.cat([x0[:, None, :], x0[:, None, :] + init_step * eye], dim=1), lower)


def _clip(x, lower):
    return x if lower is None else torch.maximum(x, lower)


def _candidates(verts, fvals, lower):
    """Sort the simplex (stable) and form the four candidates ``(cells, 4,
    d)`` from its sorted vertices."""
    d = verts.shape[-1]
    fvals, order = torch.sort(fvals, dim=-1, stable=True)
    verts = torch.gather(verts, 1, order[..., None].expand(-1, -1, d))
    worst = verts[:, -1]
    acc = verts[:, 0]
    for k in range(1, d):
        acc = acc + verts[:, k]
    centroid = acc * (1.0 / d)
    xr = _clip(centroid + ALPHA * (centroid - worst), lower)
    xe = _clip(centroid + GAMMA * (xr - centroid), lower)
    xc_out = _clip(centroid + RHO * (xr - centroid), lower)
    xc_in = _clip(centroid - RHO * (centroid - worst), lower)
    return verts, fvals, torch.stack([xr, xe, xc_out, xc_in], dim=1)


def _replace(verts, fvals, cands, fc):
    """The selected candidate in the worst vertex's place; its index."""
    rows = torch.arange(verts.shape[0], device=verts.device)
    idx = select_candidate(fvals[:, 0], fvals[:, -2], fvals[:, -1],
                           fc[:, 0], fc[:, 1], fc[:, 2], fc[:, 3])
    verts = verts.clone()
    fvals = fvals.clone()
    verts[:, -1] = cands[rows, idx]
    fvals[:, -1] = fc[rows, idx]
    return verts, fvals, idx


def _best(verts, fvals):
    rows = torch.arange(verts.shape[0], device=verts.device)
    i_best = torch.argmin(fvals, dim=-1)  # the first minimum
    return verts[rows, i_best], fvals[rows, i_best], i_best


def nelder_mead(f, x0: torch.Tensor, *, iters: int = 150, init_step: float = 0.5,
                lower: torch.Tensor = None):
    """Minimize ``f`` from ``x0 (cells, d)`` f64 for every cell at once.

    ``f`` takes points ``(cells, k, d)`` and returns their values ``(cells,
    k)`` (finite: the caller maps a failed evaluation to a sentinel).
    ``lower`` (d,) clips every vertex and candidate from below. Returns
    ``(x_best (cells, d), f_best (cells,))``.
    """
    verts = _initial(x0, init_step, lower)
    fvals = f(verts)
    for _ in range(iters):
        verts, fvals, cands = _candidates(verts, fvals, lower)
        verts, fvals, _ = _replace(verts, fvals, cands, f(cands))
    return _best(verts, fvals)[:2]


def nelder_mead_carry(f, x0: torch.Tensor, aux0, *, phases, init_step: float = 0.5,
                      lower: torch.Tensor = None):
    """:func:`nelder_mead` with a warm-start state and phased budgets.

    ``f(points (cells, k, d), aux, budget)`` returns the values ``(cells,
    k)`` and each point's end state, ``aux`` a tuple of tensors ``(cells,
    ...)`` from which every point starts, its result a tuple of ``(cells, k,
    ...)``. ``aux0`` starts the d + 1 initial vertices (at the first phase's
    budget); the first minimum among them seeds the carry. ``phases`` is a
    sequence of ``(iterations, budget)``; in each iteration the four
    candidates start from the carry and the accepted one's state becomes the
    next carry. The reference's extra-groupings search passes
    ``dynamic_budget=True``, which only keeps one traced body: its budget at
    iteration i is that of the phase holding i, the schedule of this phased
    loop (tests/test_torch_optim.py holds the two equal). Returns ``(x_best,
    f_best, aux)``, ``aux`` the final carry.
    """
    rows = torch.arange(x0.shape[0], device=x0.device)
    verts = _initial(x0, init_step, lower)
    fvals, auxs = f(verts, aux0, phases[0][1])
    i0 = _best(verts, fvals)[2]
    aux = tuple(a[rows, i0] for a in auxs)
    for n_iters, budget in phases:
        for _ in range(n_iters):
            verts, fvals, cands = _candidates(verts, fvals, lower)
            fc, auxc = f(cands, aux, budget)
            verts, fvals, idx = _replace(verts, fvals, cands, fc)
            aux = tuple(a[rows, idx] for a in auxc)
    x, fx, _ = _best(verts, fvals)
    return x, fx, aux
