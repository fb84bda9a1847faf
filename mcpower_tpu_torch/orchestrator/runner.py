"""Run orchestration: power at N, sample-size search, scenario loops.

The thin host layer over the engine's ``run_batch`` — scenario iteration,
grid construction, chunked dispatch with progress/cancel, count folding,
crossing fits. Mirrors crates/engine-orchestrator/src/{find_power,
find_sample_size,scenario_loop}.rs in behavior. Every entry takes the torch
``device`` the batches run on ("cuda", the card, or "cpu" for the plain
versions) and passes it to ``run_batch``, which raises rather than fall back
when the card is missing.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..engine import batch
from ..engine.spec import SimSpec
from . import crossing, grid as gridmod, results
from .progress import CancellationToken, ProgressEvent, ProgressRouter


@dataclass
class LoweredScenario:
    """One scenario's lowered workload: static spec + host arrays +
    labeling metadata from the spec builder."""

    label: str
    spec: SimSpec
    arrays: Dict
    target_labels: List[str] = field(default_factory=list)
    posthoc_labels: Optional[Dict[str, List[str]]] = None
    warnings: List[str] = field(default_factory=list)


def find_power(
    scenarios: Sequence[LoweredScenario],
    *,
    n_sims: int,
    base_seed: int,
    progress=None,
    cancel: Optional[CancellationToken] = None,
    chunk_size: Optional[int] = None,
    device,
    sim_id_offset: int = 0,
) -> Dict[str, Dict]:
    """Power at a single N (the spec's grid must be a single point), one
    result per scenario. Scenarios share the seed (paired draws where
    unperturbed — the reference's lower_contracts invariant).

    ``sim_id_offset`` starts the global sim-id range at an offset: workers
    of a cross-machine pool each run a disjoint range of the SAME seed
    (merge.split_sims) and the pooled counters are draw-identical to one
    big run — the host-pool convention (reference ports/wasm worker pool,
    merge.rs), made exact by global-id addressing."""
    router = ProgressRouter(progress, cancel)
    out: Dict[str, Dict] = {}
    for sc in scenarios:
        if router.cancel.is_cancelled():
            break
        counts = _run_counts(
            sc, n_sims, base_seed, router, chunk_size=chunk_size,
            device=device, sim_id_offset=sim_id_offset,
        )
        out[sc.label] = results.fold_counts(
            sc.spec,
            counts,
            target_labels=sc.target_labels,
            posthoc_labels=sc.posthoc_labels,
            warnings=sc.warnings,
        )
    return out


def find_sample_size(
    scenarios: Sequence[LoweredScenario],
    *,
    n_sims: int,
    base_seed: int,
    target_power: float,
    atom: int = 1,
    progress=None,
    cancel: Optional[CancellationToken] = None,
    chunk_size: Optional[int] = None,
    device,
    sim_id_offset: int = 0,
) -> Dict[str, Dict]:
    """Grid sample-size search: ONE batch per scenario covers every grid N
    via CRN prefix suff-stats; first-achieved read-off + crossing fits.
    ``sim_id_offset`` as in find_power (disjoint worker ranges for merge)."""
    router = ProgressRouter(progress, cancel)
    out: Dict[str, Dict] = {}
    for sc in scenarios:
        if router.cancel.is_cancelled():
            break
        counts = _run_counts(
            sc, n_sims, base_seed, router, chunk_size=chunk_size,
            device=device, sim_id_offset=sim_id_offset,
        )
        res = results.fold_counts(
            sc.spec,
            counts,
            target_labels=sc.target_labels,
            posthoc_labels=sc.posthoc_labels,
            warnings=sc.warnings,
        )
        res["target_power"] = gridmod.as_proportion(target_power)
        res["cluster_atom"] = atom
        derive_sample_size_outputs(res, target_power=target_power, atom=atom)
        out[sc.label] = res
    return out


def derive_sample_size_outputs(res: Dict, *, target_power, atom) -> None:
    """Derive first-achieved + crossing fits (per-target, joint, overall)
    from the counters already folded into ``res``, in place.

    A pure function of the result dict, shared by the one-shot sample-size
    path and the counter-pooling merge — the reference re-derives ALL
    sample-size outputs after pooling (merge.rs:242), so merged results must
    go through the same derivation as a single run, never copy part 0's.
    """
    grid_ns = list(res["sample_sizes"])
    n_done = int(res["n_sims"])
    p_corr = np.asarray(res["powers"]["corrected"])  # (G, k)

    first = {}
    fits = {}
    for i, label in enumerate(res["target_labels"]):
        first[label] = gridmod.first_n_at_target(p_corr, grid_ns, target_power, i)
        fit = crossing.fit_crossing(
            grid_ns,
            np.asarray(res["success_counts_corrected"])[:, i],
            n_done,
            target_power,
            atom,
        )
        fits[label] = fit.to_dict()
    res["first_achieved"] = first
    res["fitted"] = fits

    # Joint family from the per-N CORRECTED histograms (matching
    # first_achieved, which reads corrected power): index j is k = j+1, so
    # first_joint_achieved[j] / fitted_joint[j] answer "first N / crossing fit
    # for P(at least j+1 of the targets significant) >= target". Tail-sum of
    # histogram buckets >= k gives the at-least-k success counts per grid N.
    # Mirrors the reference derivation (engine-orchestrator/src/grid.rs:254-287).
    if "success_count_histogram_corrected" in res:
        hist = np.asarray(res["success_count_histogram_corrected"])  # (G, m+1)
        n_joint = hist.shape[1] - 1
        p_target = gridmod.as_proportion(target_power)
        first_joint: Dict[int, Optional[int]] = {}
        fitted_joint: Dict[int, Dict] = {}
        for j in range(n_joint):
            k = j + 1
            counts = hist[:, k:].sum(axis=1)
            rates = counts / max(n_done, 1)
            first_joint[j] = next(
                (int(n) for n, r in zip(grid_ns, rates) if r >= p_target),
                None,
            )
            fitted_joint[j] = crossing.fit_crossing(
                grid_ns, counts, n_done, target_power, atom
            ).to_dict()
        res["first_joint_achieved"] = first_joint
        res["fitted_joint"] = fitted_joint
    if "overall_counts" in res:
        oc = np.asarray(res["overall_counts"])
        orate = oc / max(n_done, 1)
        res["first_overall_achieved"] = next(
            (
                int(n)
                for n, r in zip(grid_ns, orate)
                if r >= gridmod.as_proportion(target_power)
            ),
            None,
        )
        res["fitted_overall"] = crossing.fit_crossing(
            grid_ns, oc, n_done, target_power, atom
        ).to_dict()


def _run_counts(sc, n_sims, base_seed, router, *, device, chunk_size=None,
                sim_id_offset=0):
    from ..config import CONFIG

    total = n_sims
    cb = router.chunk_callback(sc.label, total)
    # config-driven progress cadence (each beat = one run_sims pass over a
    # chunk; more beats = finer progress/cancel, smaller batches). Raise
    # simulation.progress_beats for long GLMM runs needing finer cancel.
    sim_cfg = CONFIG["simulation"]
    chunk = chunk_size or max(
        sim_cfg["min_chunk_sims"], -(-n_sims // sim_cfg["progress_beats"])
    )
    return batch.run_batch(
        sc.spec,
        sc.arrays,
        n_sims,
        base_seed,
        chunk_size=chunk,
        progress=cb,
        cancel=router.cancel,
        sim_id_offset=sim_id_offset,
        device=device,
    )
