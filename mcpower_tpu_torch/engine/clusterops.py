"""Cluster segment sums on the static row layout.

The primary grouping's layout is iota math (``datagen.cluster_ids``):

* ``fixed_clusters``: ``id(i) = i % m``   (round-robin over m clusters)
* ``fixed_size``:     ``id(i) = i // cs`` (contiguous blocks of cs rows)

and every grid point is snapped to the cluster atom, so per-cluster sums of
a grid segment are exact reshapes. These are the plain versions kernel K2
(``csrc/grid_suffstats.cu``) is held against. All helpers take the row axis
LAST; leading axes are batch.
"""

from __future__ import annotations

import torch

from .spec import SimSpec


def _layout(spec: SimSpec):
    c = spec.cluster
    if c is None:
        raise ValueError("cluster layout requested for a spec without a cluster")
    return c.sizing_mode == "fixed_clusters", max(int(c.sizing_value), 1)


def seg_sum(spec: SimSpec, x: torch.Tensor) -> torch.Tensor:
    """Sum the trailing row axis (..., n_rows) into clusters (..., m).

    ``n_rows`` must be a multiple of the layout period.
    """
    round_robin, period = _layout(spec)
    lead = x.shape[:-1]
    blocks = x.reshape(*lead, x.shape[-1] // period, period)
    # round robin: rows interleave over the m clusters; blocked: each
    # cluster owns ``period`` consecutive rows
    return blocks.sum(-2) if round_robin else blocks.sum(-1)


def seg_segment(spec: SimSpec, x: torch.Tensor, start: int, m: int) -> torch.Tensor:
    """Segment-sum a grid slice of rows (..., seg_len) starting at global row
    ``start`` into the full (..., m) cluster axis; blocked layouts cover only
    their own clusters and are zero elsewhere."""
    round_robin, period = _layout(spec)
    if round_robin:
        return seg_sum(spec, x)
    part = seg_sum(spec, x)
    offset = start // period
    return torch.nn.functional.pad(part, (offset, m - offset - part.shape[-1]))


def per_row(spec: SimSpec, v: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Broadcast per-cluster values (..., m) to per-row (..., n_rows)."""
    round_robin, period = _layout(spec)
    if round_robin:
        return v.repeat(*([1] * (v.dim() - 1)), n_rows // v.shape[-1])
    return v.repeat_interleave(period, dim=-1)[..., :n_rows]
