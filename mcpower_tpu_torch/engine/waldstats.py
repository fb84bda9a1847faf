"""Wald-statistic assembly: beta/cov -> t^2, the joint omnibus and the
posthoc pairwise contrasts.

``beta (..., G, P)`` and ``cov (..., G, P, P)`` with any leading batch axes
(the port writes the sim axis out where the reference vmaps it).
"""

from __future__ import annotations

from typing import Dict

import torch

from . import smallchol
from .spec import SimSpec


def t2_targets(spec: SimSpec, beta: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
    """Marginal + contrast t^2 per target, shape (..., G, n_targets)."""
    cols = [beta[..., t] ** 2 / cov[..., t, t] for t in spec.target_cols]
    for a, b in spec.contrasts:
        d = beta[..., a] - beta[..., b]
        var_c = cov[..., a, a] + cov[..., b, b] - 2.0 * cov[..., a, b]
        cols.append(d * d / var_c)
    if not cols:
        return beta.new_zeros(beta.shape[:-1] + (0,))
    return torch.stack(cols, dim=-1)


def overall_wald_chi2(spec: SimSpec, beta: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
    """Joint Wald chi^2 over the marginal targets, b_T' Cov_T^-1 b_T, (..., G)."""
    if not spec.target_cols:
        return beta.new_zeros(beta.shape[:-1])
    tc = list(spec.target_cols)
    bt = beta[..., tc]
    ct = cov[..., tc, :][..., tc]
    sol = smallchol.cho_solve(smallchol.chol(ct), bt)
    return (bt * sol).sum(-1)


def posthoc_t2(spec: SimSpec, beta: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
    """Pairwise-contrast t^2 per posthoc pair, (..., G, n_pairs), in the
    reference's operations (``posthoc_t2``, :52). Pair columns are design
    columns; -1 is the reference level, absorbed into the intercept, which
    adds nothing to the contrast."""
    col_to_fit = {c: i for i, c in enumerate(spec.effective_fit_cols)}
    zeros = beta.new_zeros(beta.shape[:-1])
    ph = []
    for block in spec.posthoc:
        for ca, cb in block.pairs:
            ia = col_to_fit.get(ca, -1) if ca >= 0 else -1
            ib = col_to_fit.get(cb, -1) if cb >= 0 else -1
            d, var_q = zeros, zeros
            if ia >= 0:
                d = d + beta[..., ia]
                var_q = var_q + cov[..., ia, ia]
            if ib >= 0:
                d = d - beta[..., ib]
                var_q = var_q + cov[..., ib, ib]
            if ia >= 0 and ib >= 0:
                var_q = var_q - 2.0 * cov[..., ia, ib]
            ph.append(d * d / var_q)
    if not ph:
        return beta.new_zeros(beta.shape[:-1] + (0,))
    return torch.stack(ph, dim=-1)


def add_posthoc(out: Dict[str, torch.Tensor], spec: SimSpec, beta: torch.Tensor,
                cov: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Attach ``posthoc_t2`` to an arm's output when the spec asks for it."""
    if spec.posthoc:
        out["posthoc_t2"] = posthoc_t2(spec, beta, cov)
    return out
