"""Wald-statistic assembly: beta/cov -> t^2 and the joint omnibus.

``beta (..., G, P)`` and ``cov (..., G, P, P)`` with any leading batch axes
(the port writes the sim axis out where the reference vmaps it).
"""

from __future__ import annotations

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
