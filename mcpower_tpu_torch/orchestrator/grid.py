"""Cluster-aware sample-size grid construction and N snapping.

Behavioral parity with the reference's grid builder
(crates/engine-orchestrator/src/grid.rs:37 ``build_grid``, find_power.rs:25
``snap_single_n``, find_sample_size.rs:22 ``resolve_cluster_grid_params``):
endpoints snap to the cluster atom, the ``to`` endpoint is pinned even when
the regular step skips it, auto mode targets ~12 points, log mode spaces
points in log10(N), and every adjustment is surfaced as a warning string.
"""

from __future__ import annotations


from typing import List, Optional, Sequence, Tuple

from ..config import CONFIG


def _ceil_to(x: int, a: int) -> int:
    a = max(a, 1)
    return ((x + a - 1) // a) * a


def _floor_to(x: int, a: int) -> int:
    a = max(a, 1)
    return (x // a) * a


def _round_to(x: int, a: int) -> int:
    a = max(a, 1)
    return ((x + a // 2) // a) * a


def cluster_atom(cluster) -> int:
    """Smallest legal N increment for a clustered design.

    FixedClusters: one extra row per cluster => atom = n_clusters.
    FixedSize: whole clusters only => atom = cluster_size.
    Extra groupings multiply their block size in so each grid point is a
    balanced design across all grouping factors.
    """
    if cluster is None:
        return 1
    a = max(int(cluster.sizing_value), 1)
    # Every extra grouping multiplies its block size in (reference
    # ClusterSpec::atom, generation.rs:291-295: plain product over
    # block_levels — crossed level count, nested n_per_parent) so one atom
    # block enumerates every grouping combination exactly once.
    for eg in cluster.extra_groupings:
        a *= max(int(eg.n_levels), 1)
    return a


def hard_min_n(cluster) -> int:
    """Regime floor: every cluster keeps min_rows_per_cluster rows and there
    are at least min_clusters clusters."""
    if cluster is None:
        return 1
    lim = CONFIG["limits"]
    if cluster.sizing_mode == "fixed_clusters":
        return int(cluster.sizing_value) * int(lim["min_rows_per_cluster"])
    return int(lim["min_clusters"]) * int(cluster.sizing_value)


def snap_single_n(cluster, requested: int) -> Tuple[int, Optional[str]]:
    """Snap a find_power N down to the cluster atom (never to zero rows)."""
    a = cluster_atom(cluster)
    if a <= 1:
        return requested, None
    snapped = max(_floor_to(requested, a), a)
    if cluster is not None and cluster.sizing_mode == "fixed_size":
        min_clusters = int(CONFIG["limits"]["min_clusters"])
        got = snapped // max(int(cluster.sizing_value), 1)
        if got < min_clusters:
            raise ValueError(
                f"sample_size {requested} gives only {got} clusters of size "
                f"{cluster.sizing_value}; at least {min_clusters} required"
            )
    warning = (
        f"sample_size {requested} is not a multiple of the cluster atom {a}; "
        f"using {snapped}"
        if snapped != requested
        else None
    )
    return snapped, warning


def build_grid(
    from_req: int,
    to_req: int,
    by="auto",
    mode: str = "linear",
    atom: int = 1,
    hard_min: int = 1,
) -> Tuple[List[int], List[str]]:
    """Build the ascending N grid. ``by``: "auto" | int (linear step / log
    point count). Returns (grid, warnings)."""
    if atom < 1:
        raise ValueError("cluster atom must be >= 1")
    if from_req < 1 or to_req < from_req:
        raise ValueError(f"invalid grid bounds from={from_req} to={to_req}")

    warnings: List[str] = []
    snapped_from = max(_ceil_to(from_req, atom), _ceil_to(hard_min, atom))
    snapped_to = _floor_to(to_req, atom)

    if snapped_from > from_req:
        warnings.append(
            f"raised `from` from {from_req} to {snapped_from} so each cluster "
            f"keeps enough rows (atom={atom})"
        )
    if snapped_to < to_req:
        warnings.append(
            f"lowered `to` from {to_req} to {snapped_to} (nearest multiple of "
            f"the cluster atom {atom})"
        )
    if snapped_to < snapped_from:
        raise ValueError(
            f"grid collapsed after cluster snapping: from={snapped_from} "
            f"to={snapped_to} atom={atom}"
        )

    max_feasible = (snapped_to - snapped_from) // atom + 1
    if max_feasible < 2:
        raise ValueError(
            f"grid has a single feasible point (from={snapped_from}, "
            f"to={snapped_to}, atom={atom}); widen the bounds"
        )
    if max_feasible < 4:
        warnings.append(
            f"only {max_feasible} grid points after cluster snapping; "
            "required-N (and model-based crossing) will be coarse"
        )

    auto_count = int(CONFIG["simulation"]["cluster_auto_count"])

    if mode == "linear":
        if by == "auto":
            c = min(max(auto_count, 2), max_feasible)
            span = snapped_to - snapped_from
            denom = atom * (c - 1)
            step = atom * max((span + denom // 2) // denom, 1)
        else:
            step = max(_ceil_to(int(by), atom), atom)
        grid = list(range(snapped_from, snapped_to + 1, step))
        if grid[-1] != snapped_to:
            grid.append(snapped_to)
    elif mode == "log":
        import math

        c = min(max(auto_count if by == "auto" else int(by), 2), max_feasible)
        lo, hi = math.log10(snapped_from), math.log10(snapped_to)
        raw = [
            min(
                max(_round_to(round(10 ** (lo + i * (hi - lo) / (c - 1))), atom), snapped_from),
                snapped_to,
            )
            for i in range(c)
        ]
        raw[0], raw[-1] = snapped_from, snapped_to
        grid = sorted(set(raw))
    else:
        raise ValueError(f"unknown grid mode {mode!r}")

    return grid, warnings


def as_proportion(p: float) -> float:
    """Values > 1 are percentages (Python-port parity)."""
    return p / 100.0 if p > 1.0 else p


def first_n_at_target(powers_by_n: Sequence[Sequence[float]], grid, target_power, idx) -> Optional[int]:
    """Smallest grid N whose corrected power reaches the target."""
    t = as_proportion(target_power)
    for row, n in zip(powers_by_n, grid):
        if row[idx] >= t:
            return int(n)
    return None
