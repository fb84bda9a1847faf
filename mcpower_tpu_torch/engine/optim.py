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
-inf elsewhere), the first minimum's vertex at the end. ``nelder_mead_carry`` (the GLMM's warm-carried
search) waits for ROADMAP A11.2.
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


def nelder_mead(f, x0: torch.Tensor, *, iters: int = 150, init_step: float = 0.5,
                lower: torch.Tensor = None):
    """Minimize ``f`` from ``x0 (cells, d)`` f64 for every cell at once.

    ``f`` takes points ``(cells, k, d)`` and returns their values ``(cells,
    k)`` (finite: the caller maps a failed evaluation to a sentinel).
    ``lower`` (d,) clips every vertex and candidate from below. Returns
    ``(x_best (cells, d), f_best (cells,))``.
    """
    cells, d = x0.shape
    dtype, dev = x0.dtype, x0.device

    def clip(x):
        return x if lower is None else torch.maximum(x, lower)

    eye = torch.eye(d, dtype=dtype, device=dev)
    verts = clip(torch.cat([x0[:, None, :], x0[:, None, :] + init_step * eye], dim=1))
    fvals = f(verts)
    inv_d = 1.0 / d
    rows = torch.arange(cells, device=dev)
    for _ in range(iters):
        fvals, order = torch.sort(fvals, dim=-1, stable=True)
        verts = torch.gather(verts, 1, order[..., None].expand(-1, -1, d))
        worst = verts[:, -1]
        acc = verts[:, 0]
        for k in range(1, d):
            acc = acc + verts[:, k]
        centroid = acc * inv_d
        xr = clip(centroid + ALPHA * (centroid - worst))
        xe = clip(centroid + GAMMA * (xr - centroid))
        xc_out = clip(centroid + RHO * (xr - centroid))
        xc_in = clip(centroid - RHO * (centroid - worst))
        cands = torch.stack([xr, xe, xc_out, xc_in], dim=1)
        fc = f(cands)
        idx = select_candidate(fvals[:, 0], fvals[:, -2], fvals[:, -1],
                               fc[:, 0], fc[:, 1], fc[:, 2], fc[:, 3])
        verts = verts.clone()
        fvals = fvals.clone()
        verts[:, -1] = cands[rows, idx]
        fvals[:, -1] = fc[rows, idx]
    i_best = torch.argmin(fvals, dim=-1)
    return verts[rows, i_best], fvals[rows, i_best]
