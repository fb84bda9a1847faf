"""Multiple-testing corrections in t^2 space.

The crit table ships per-RANK t^2 thresholds (rank 0 = most significant);
only the k target statistics are sorted and step-down / step-up logic runs
as cumulative scans. NaN statistics sink to non-significant: NaN compares
False and sorts to the last rank under a descending sort.
"""

from __future__ import annotations

import torch


def apply_correction(t2: torch.Tensor, rank_crits: torch.Tensor, method: str) -> torch.Tensor:
    """Per-target significance after correction, bool (..., k) in the
    ORIGINAL target order. ``rank_crits`` (..., k) holds per-rank thresholds
    (per-target under 'tukey_hsd')."""
    k = t2.shape[-1]
    if k == 0:
        return torch.zeros(t2.shape, dtype=torch.bool, device=t2.device)
    if method in ("none", "bonferroni"):
        return t2 > rank_crits[..., :1]
    if method == "tukey_hsd":
        return t2 > rank_crits

    # Descending t^2 with NaN last, stable like the reference's argsort of
    # -t2 (NaN sorts last there too).
    key = torch.where(torch.isnan(t2), torch.full_like(t2, float("inf")), -t2)
    order = torch.argsort(key, dim=-1, stable=True)
    t2_sorted = torch.gather(t2, -1, order)
    beats = t2_sorted > rank_crits

    if method == "holm":
        # step-down: rank r significant iff every rank s <= r beats its crit
        sig_sorted = torch.cumprod(beats.to(torch.int32), dim=-1).bool()
    elif method == "benjamini_hochberg":
        # step-up: rank r significant iff any rank s >= r beats its crit
        rev = torch.flip(beats, dims=[-1])
        sig_sorted = torch.flip(torch.cumsum(rev.to(torch.int32), dim=-1) > 0, dims=[-1])
    else:
        raise ValueError(f"unknown correction method {method!r}")

    inv_order = torch.argsort(order, dim=-1)
    return torch.gather(sig_sorted, -1, inv_order)
