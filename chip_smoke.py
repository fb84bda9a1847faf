#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mcpower_tpu_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

(``--checks-only`` stops after phase 3; ``--compare LABEL=DIR`` adds phase
5's A/B against K1, K2 (its slope and joint modes too), K3, K6, K7 and
K9-K12 built from another ``csrc`` directory.)

Phases, each fatal on failure (exit code != 0, no result line):

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build kernels K1-K4 and K6-K12 from ``mcpower_tpu_torch/csrc`` (one nvcc
   per source, all started together) and print their register and spill
   use, per instantiation (of p for K2-K4 and K6, K2's slope mode on a line
   of its own, of p = 1..4 and the p <= 8 and p <= 16 buckets for K7, of q =
   2..4 and p = 2, 3, 4 and the p <= 8 and p <= 16 buckets for K9 and K10
   (K10's pass function, not inlined, by q, p and type beside it; K12's
   pass function by type), of mode
   and store width for K1), the static
   SASS instruction count of K1 and K3
   (``cuobjdump``), K6's launch geometry and resident blocks per SM at
   p = 1..16 at the GLM arm's and the logit sample-size flow's launch, and
   K7's (warps a cell, cells a block, resident cells per SM, waves, the
   staged or streamed path) at its timed shapes, K10's (shared or streamed
   form, shared bytes, resident cells an SM, waves, registers and local
   bytes a thread) and K11's (its capacitance's form, warps a cell, the
   twin staged or not, shared bytes, resident cells an SM, waves,
   registers and local bytes) and K9's (its form, shared bytes, resident
   cells an SM, waves, registers and local bytes) at theirs
   (``K10_SHAPES``, ``K11_SHAPES``, ``K9_SHAPES``);
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (10,000 sims; the LMM's N = 200, p = 3, m = 20, G = 1,
   the curve design's p = 7, G = 8 and the GLM arm's N = 300, p = 4), and
   off the path: K1 in all three modes at every table of ``K1_CHECKS`` (the
   arms' stream plans and a ragged plan at sim ids across 2**31), K2 at two
   cluster layouts, a 91-point grid, a design tall enough for row chunks
   that cut a segment and a cluster and at p = 9 (two statistic groups), K3
   at every case of ``K3_CHECKS`` (p = 1, p = 16, rank-deficient cells,
   pivot ratios on both sides of EPS_RANK, and reduced fits with a p_eff
   per cell, one where a masked column's unit pivot decides the pivot
   ratio), K4 at both layouts, m = 7 and m = 150, K6 at every case of
   ``K6_CHECKS`` (the logit sample-size flow's launch, probit, Poisson, the
   cold start, a 12-point grid, a pinned column, p = 1 and p = 16,
   separated and rank-deficient cells, a column mask per cell that differs
   between sims, and the separation fallback's launch over the failed cells
   of a sparse and of a separated factor design) and K8 on synthetic rows
   (rates up to 20, above 20 and 0, uniforms at the clamp) and on the
   Poisson design's rows; K1 also at the second fill of a design with a
   sampled factor (RESID and FACTOR words), at the three fills of the
   realistic LMM (its long normals with a heavy-tailed intercept and the
   residual swap's chi-square planes, its short normals, the words of its
   swap uniforms) and at a plan of 33 streams, which
   ``rng.fill_streams_kernel`` splits into two K1 launches (counted); K7 at
   every case of ``K7_CHECKS`` (the GLMM arms' 2,000 cells at nagq 7 and 1,
   a launch of README flow 3, and off the path probit, Poisson, nagq 25, the
   FD Hessian, a three-point grid, blocked clusters, 40 clusters, p = 1, 4, 6
   and 16, boundary cells, the cold start, a launch of README flow 3's
   sample-size flow and 1,024 clusters on K7's streamed path), every output
   bit-identical (flags, beta, cov, tau^2, ybar), with K7's launch geometry
   at each; K2's slope mode (p = 3, q = 2 and p = 16, q = 4) within
   ``K2_REL``; K9 at every case of ``K9_CHECKS`` (a launch of README flow
   2's power and sample-size flows, ``benchmarks/throughput.py``'s
   lmm_slopes at 10,000 sims and lmm_multislope, and off the path a null
   slope, q = 4, q = 4 at p = 16 and 1,024 clusters on K9's streamed path),
   every output bit-identical (flags, pins, beta, cov, tau^2), in the form
   its launcher takes and forced into each of its three forms (p <= 4; the
   wider buckets have one); K10 at every
   case of ``K10_CHECKS`` (``benchmarks/throughput.py``'s glmm_slopes, a
   launch of the slope-GLMM flow, and off the path q = 3, q = 4 at p = 16,
   probit, Poisson, the FD Hessian, blocked clusters and 300 clusters),
   every output bit-identical (flags, pins, beta, cov, tau^2, ybar, theta),
   and at ``K10_STREAMED_CHECKS`` again in its streamed form (state in
   device scratch), the same bits;
   K2's joint mode (structured, dense, an extra grouping's own slope and
   p = 16) within ``K2_JOINT_REL``, its counts exact; K11 at every case of
   ``K11_CHECKS`` (the two extras arms, a launch of each extras flow:
   crossed Me = 25, nested Me = 48, dense M = 70; and off the path two
   extra groupings, an extra grouping's own slope and p = 16), every output
   bit-identical (flags, pins, beta, cov, tau^2, theta), and the
   structured arm forced through the dense capacitance: at the structured
   fit's theta within ``EXTRAS_AB_FIT_REL`` with every pin equal, its own
   search within ``EXTRAS_AB_THETA``; K12 at every case of ``K12_CHECKS``
   (the two GLMM extras arms, a launch of the crossed, nested and dense GLMM
   flows: structured Me 10, nested Me 48 with the blocked Schur factor,
   dense M 58; and off the path two extra groupings, an extra grouping's own
   slope, probit, Poisson, the FD Hessian and p = 16), every output
   bit-identical (flags, pins, beta, cov, tau^2, ybar, theta), and the
   structured arm forced through the dense capacitance at the structured
   fit's theta within ``GLMM_EXTRAS_AB_FIT_REL``, every flag equal;
4. drive the main path through ``lower`` and ``run_batch(device="cuda")``:
   the 10,000-replicate random-intercept LMM headline (base seed 2137), the
   OLS arm, the 8-point power curve and the GLM arm (logit, Bonferroni),
   with every kernel's launch count set to 0 before each arm and read after
   (the GLM arm must launch K1 twice and K6 once); then check 1,024-sim
   counts against golden counts of the JAX reference (at most one flip per
   entry); then the scenario arm (``SCENARIO_ARMS``: heterogeneity and a
   residual swap, 40,000 sims, counted on its own), its power held within
   1 pp of a NumPy oracle of 400,000 draws and its 1,024-sim counts
   against the reference's; then the GLMM arms of ``GLMM_DESIGNS``
   (bench.py's ``glmm_agq7`` and its Laplace twin, 2,000 sims in one chunk,
   each counted on its own: K1 twice and K7 once) and their 1,024-sim
   counts against the reference's; then the random-slope arm
   (``SLOPE_DESIGNS``: lmm_slopes, 10,000 sims in one chunk through K1, K2's
   slope mode and K9, each once) and its 1,024-sim counts against the
   reference's (pin counts within ``SLOPE_PIN_FLIPS``); then the
   slope-GLMM arm (``SLOPE_GLMM_DESIGNS``: glmm_slopes, 4,000 sims in one
   chunk through K1 twice and K10 once), its 1,024-sim counts against the
   reference's (pins within ``SLOPE_GLMM_PIN_FLIPS``, tau^2 within
   ``SLOPE_GLMM_TAU2_REL``) and against the plain path's on the card, equal;
   then the extras arms (``EXTRAS_DESIGNS``: lmm_extras and its dense twin,
   2,000 sims each in one chunk through K1, K2 and its joint mode and K11,
   each once), their 1,024-sim counts against the reference's (pins within
   ``EXTRAS_PIN_FLIPS``, tau^2 within ``EXTRAS_TAU2_REL``) and against the
   plain path's on the card; then the GLMM extras arms
   (``GLMM_EXTRAS_DESIGNS``: bench.py's glmm_extras and its dense twin,
   2,000 sims each in one chunk through K1 twice and K12 once) and their
   1,024-sim counts against the reference's (within ``GLMM_EXTRAS_*``);
5. time each kernel (K1 and K2 at the LMM, OLS and curve arms' shapes, K1
   also at the realistic LMM's long and short normal fills, K3
   at the OLS and curve shapes and at a launch of the README model's
   sample-size flow, K4 at the LMM's, K6 at the GLM arm's, at a launch of
   the logit sample-size flow and at both launches of the logit factor
   flow, K8 at a launch of the Poisson flow, K7 at the GLMM arms' cells and
   at a launch of README flow 3's power and sample-size flows, K9 at a
   launch of README flow 2's power and sample-size flows and at the
   lmm_slopes and lmm_multislope cells (its bound from the f32 evaluations
   its cells needed, the kernel's count), K2's slope mode at the lmm_slopes
   rows and both README flow 2 launches', K10
   at a launch of the slope-GLMM flow, at the glmm_slopes cells and at a
   launch of the slope-GLMM sample-size flow (1,250 sims x 11 grid points),
   K11 at the lmm_extras arm's cells and at a launch of the crossed, the
   nested and the dense extras flows (K10's and K11's plain versions at one
   shape each), K12 at
   the glmm_extras arm's cells and at a launch of the crossed, the nested
   and the dense GLMM flows (its plain version's time the one call of phase
   3; the form its launcher takes, work areas in shared memory or in
   scratch, printed beside), K2's joint
   mode at the arm's rows and a crossed flow
   launch's, beside one ``torch.bmm`` of a dense one-hot Z) on
   the device, from
   torch.profiler's kernel events, and per call through its wrapper (CUDA
   events, launch overhead included), each call on inputs that are not in
   L2, beside its plain version, its bound
   (the larger of bytes over the memory rate and operations over the peak
   rate for their type; K6's counts the steps its cells ran, from the
   kernel's step counter) and, for K2, one ``torch.bmm`` that computes the
   same statistics at the OLS shape; with ``--compare LABEL=DIR`` (another
   ``csrc`` directory, such as the parent commit's; repeatable) its K1, K2,
   K3, K6, K7 and K9-K12 are built too, checked against this tree's
   (K7 bit for bit; K9's six outputs at every case of ``K9_CHECKS``, K11's
   seven at every case of ``K11_CHECKS``, K10's and K12's eight at every
   case of ``K10_CHECKS`` and ``K12_CHECKS``, K2's slope-mode outputs at
   ``K2_SLOPE_CHECKS`` and both README flow 2 launches and at every K2
   timing row, and its joint ztz, ztx and zty at ``K2_JOINT_CHECKS``, bit
   for bit) and timed beside them in turns (other, this, this, other; K9 at
   its four rows, K10 at its three, K11 and K12 at their four, K2 at its
   six rows and in its joint mode at its two); K1 at
   the realistic LMM's long
   normals with its cluster streams padded in one launch against them in a
   launch of their own; then each arm's wall (the GLMM and slope arms' too),
   and a profile of each arm (wall median of PROFILE_REPS (3) calls, busy share, largest
   device items);
6. drive the thirty-five user flows of ``MODEL_FLOWS`` through
   ``mcpower_tpu_torch.MCPower`` on the card (the random-intercept LMM's
   and the OLS model's ``find_power`` and ``find_sample_size``, the logit
   model's ``find_power`` and ``find_sample_size``, the Poisson model's
   ``find_power``, README flow 1's ``find_power`` and ``find_sample_size``
   as written, the Tukey ANOVA, the logit model with a rare factor
   level's ``find_sample_size``, and ``scenarios=True`` (optimistic,
   realistic, doomer) on README flow 1's ``find_sample_size`` as written,
   the LMM's and the logit model's ``find_power``; README flow 3's GLMM
   ``find_power(480)`` as written, its ``find_sample_size(from_size=240,
   to_size=720)``, ``agq=7``, ``wald_se="hessian"`` and ``scenarios=True``,
   each launching K7 once a chunk; README flow 2's random-slope LMM
   ``find_power(600)`` as written, its ``find_sample_size(from_size=300,
   to_size=900)`` and ``scenarios=True``, each launching K2 and K9 once a
   chunk; README flow 3's model with a random slope on dose:
   ``find_power(480)``, ``find_sample_size(from_size=240, to_size=720)``
   and ``scenarios=True``, each launching K10 once a chunk; example 13's
   crossed ``find_power(1000)``, ``find_sample_size(from_size=1000,
   to_size=3000)`` and ``scenarios=True``, example 15's nested
   ``find_power(720)`` and README flow 2 with a crossed rater
   ``find_power(600)``, each launching K2 twice (its joint mode once) and
   K11 once a chunk; README flow 3 with a crossed rater: ``find_power(480)``,
   ``find_sample_size(from_size=240, to_size=720)`` and ``scenarios=True``,
   with wards nested in its clinics and with a slope on dose beside the
   rater: ``find_power(480)``, each launching K12 once a chunk; 10,000
   sims, base seed
   2137), each with every launch count set to 0 before it and read after
   (the logit factor flow must launch K6 twice a chunk, the second the
   fallback's; K1 as often a chunk as each scenario's fill plan says); check
   1,024-sim results against
   golden values of the JAX reference's ``MCPower`` (at most one flip per
   count) and their result trees at TREE_SIMS (256; TREE_SIMS_ON_CARD, 128,
   where the plain path runs on the card) sims against the plain
   path's on the CPU (the slope-GLMM flows' against the plain path's on
   the card, K10's plain version in K10's place, and the extras flows' with
   K2's joint mode and K11's plain versions, and the GLMM extras flows'
   with K12's: on the CPU they would take minutes);
   print each flow's wall median (range) of PROFILE_REPS (3) calls (one
   for the extras flows), the split into
   projection, lowering, runner (run_batch inside it) and packaging, the
   chunk count, the busy share and the same design's one-chunk
   ``run_batch`` wall (per scenario);
7. print the ``kernels`` JSON line (launches on each kernel's path: the
   arms' for K1-K4 and K6, the GLMM arms' for K7, the slope arm's for K9,
   the slope-GLMM arm's for K10, the GLMM extras arms' for K12, the extras
   arms' for K11 and K2's joint
   mode (its own entry, ``grid_suffstats_joint``),
   the Poisson flow's for K8; and by arm and by
   flow, with K6's fallback launches by flow and K1's launches a chunk of
   each flow's scenarios), then as the last line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

N_SIMS = 10_000
GOLDEN_SIMS = 1_024
# Sims of each flow's whole result tree held against the plain path's
# (phase 6): at GOLDEN_SIMS the CPU's plain runs of the GLMM and slope flows
# took ~3 minutes of the script's 1,200 s.
TREE_SIMS = 256
# The flows whose plain path runs on the card (the slope GLMM's, the LMM
# extras' and the GLMM extras': K10's, K11's and K12's plain versions take
# minutes on the CPU) hold their trees at TREE_SIMS_ON_CARD sims, to keep the
# script in its time.
TREE_SIMS_ON_CARD = 128
SEED = 2137

_CORR5 = (np.full((5, 5), 0.2) + 0.8 * np.eye(5)).tolist()

# The main path's designs (bench.py:90-139): lower() keyword arguments, with
# the cluster given as ClusterStatic fields so either package can build it.
DESIGNS = {
    "lmm_headline": dict(
        grid=[200],
        var_types=["normal", "normal"],
        corr=[[1.0, 0.3], [0.3, 1.0]],
        effects=[0.0, 0.3, 0.2],
        target_cols=[1, 2],
        estimator="mle",
        cluster=dict(sizing_mode="fixed_clusters", sizing_value=20, tau_squared=0.25),
    ),
    "ols_10k": dict(
        grid=[200],
        var_types=["binary"],
        var_params=[0.5],
        effects=[0.0, 0.4],
        target_cols=[1],
    ),
    "curve_5pred_8grid": dict(
        grid=[50, 100, 150, 200, 250, 300, 400, 500],
        var_types=["normal"] * 5,
        corr=_CORR5,
        effects=[0.0, 0.25, 0.2, 0.15, 0.1, 0.1, 0.1],
        target_cols=[1, 2, 3, 4, 5, 6],
        interactions=[(1, 2)],
    ),
    "glm_bonferroni_10k": dict(
        grid=[300],
        var_types=["normal", "normal", "normal"],
        effects=[-0.4, 0.3, 0.2, 0.15],
        target_cols=[1, 2, 3],
        outcome="binary",
        estimator="glm",
        correction="bonferroni",
    ),
}

# The random-intercept GLMM arms (kernel K7): bench.py's glmm_agq7 arm
# (bench.py:168-178, timed there at 2,000 sims) and its Laplace twin
# (benchmarks/throughput.py:119-125's glmm_base, the same design at nagq 1),
# each driven as one chunk of GLMM_SIMS sims.
GLMM_DESIGNS = {
    name: dict(
        grid=[200],
        var_types=["normal", "normal"],
        corr=[[1.0, 0.3], [0.3, 1.0]],
        effects=[-0.3, 0.3, 0.2],
        target_cols=[1, 2],
        outcome="binary",
        estimator="glm",
        cluster=dict(sizing_mode="fixed_clusters", sizing_value=20, tau_squared=0.25),
        nagq=nagq,
    )
    for name, nagq in (("glmm_agq7", 7), ("glmm_laplace", 1))
}
GLMM_SIMS = 2_000

# The scenario arm (tests/test_ols_power.py:198): one normal predictor,
# beta 0.55, N = 100, alpha 5e-7, heterogeneity 0.3 and a residual swap
# (probability 0.5) over t(8) and chi-square(8); phase 4 holds its
# rejection rate at SCENARIO_SIMS sims against a NumPy oracle of its own.
SCENARIO_ARMS = {
    "ols_composed_scenario": dict(
        grid=[100],
        alpha=5e-7,
        var_types=["normal"],
        effects=[0.0, 0.55],
        target_cols=[1],
        scenario=dict(label="robust5", heterogeneity=0.3, residual_change_prob=0.5,
                      residual_dists=("high_kurtosis", "right_skewed"), residual_df=8.0),
    ),
}

# The realistic scenario (config.SCENARIO_PRESETS) on the LMM headline, as
# model_lmm_scenarios lowers it, and with 13 predictors (33 long streams).
REALISTIC = dict(
    label="realistic", heterogeneity=0.2, heteroskedasticity_ratio=2.0, correlation_noise_sd=0.15,
    sampled_factor_proportions=True, truth_start=False, distribution_change_prob=0.5,
    new_distributions=("right_skewed", "left_skewed", "uniform"),
    random_effect_dist="heavy_tailed", random_effect_df=10.0, icc_noise_sd=0.15,
    residual_dists=("high_kurtosis", "right_skewed"), residual_change_prob=0.5, residual_df=8.0,
)
SCENARIO_DESIGNS = {
    "lmm_realistic": dict(DESIGNS["lmm_headline"], scenario=REALISTIC),
    "lmm_realistic_13": dict(DESIGNS["lmm_headline"], var_types=["normal"] * 13,
                             corr=np.eye(13).tolist(), effects=[0.0] + [0.1] * 13,
                             target_cols=list(range(1, 14)), scenario=REALISTIC),
}

SCENARIO_SIMS = 40_000
SCENARIO_POWER_PP = 0.01
ORACLE_DRAWS = 400_000


def composed_scenario_oracle(draws: int = ORACLE_DRAWS, chunk: int = 25_000) -> float:
    """The rejection rate of SCENARIO_ARMS["ols_composed_scenario"] by the
    independent NumPy simulator of tests/test_ols_power.py:198, with its
    own generator (seed 424242): effects jittered by het * beta and clipped
    at 0, residuals swapped with probability 0.5 to t(8) scaled by
    sqrt(6 / 8) or to chi-square(8) centred and scaled by 1 / 4, the
    two-sided t test of the slope at alpha 5e-7."""
    from scipy import stats

    alpha, beta, n, het, swap_prob, df = 5e-7, 0.55, 100, 0.3, 0.5, 8
    tcrit = stats.t.ppf(1 - alpha / 2, n - 2)
    rs = np.random.default_rng(424242)
    t_scale, chi_scale = np.sqrt((df - 2.0) / df), 1.0 / np.sqrt(2.0 * df)
    hits = 0
    for _ in range(draws // chunk):
        x = rs.standard_normal((chunk, n))
        beta_eff = np.maximum(beta + rs.standard_normal(chunk) * het * beta, 0.0)
        swap = rs.random(chunk) < swap_prob
        pick = np.minimum((rs.random(chunk) * 2).astype(int), 1)
        eps = rs.standard_normal((chunk, n))
        t_eps = rs.standard_t(df, (chunk, n)) * t_scale
        chi_eps = (rs.chisquare(df, (chunk, n)) - df) * chi_scale
        eps = np.where(swap[:, None], np.where(pick[:, None] == 0, t_eps, chi_eps), eps)
        y = x * beta_eff[:, None] + eps
        xc, yc = x - x.mean(1, keepdims=True), y - y.mean(1, keepdims=True)
        sxx = (xc * xc).sum(1)
        b1 = (xc * yc).sum(1) / sxx
        resid = yc - b1[:, None] * xc
        t = b1 / np.sqrt((resid * resid).sum(1) / (n - 2) / sxx)
        hits += int(np.sum(np.abs(t) > tcrit))
    return hits / draws

# Cluster layouts the main path does not reach, held against the plain
# versions in phase 3 only: round-robin and blocked clusters over a two-point
# grid (K2's per-segment cluster ranges, K4's cells at G > 1).
LAYOUT_CHECKS = {
    "lmm_round_robin_2grid": dict(DESIGNS["lmm_headline"], grid=[100, 200]),
    "lmm_blocked_2grid": dict(
        DESIGNS["lmm_headline"], grid=[100, 200],
        cluster=dict(sizing_mode="fixed_size", sizing_value=10, tau_squared=0.25),
    ),
}

# Off the main path, held against K2's plain version in phase 3 only: the
# curve design on the 91-point grid find_sample_size(from_size=50,
# to_size=500, by=5) builds (more points than K2 once took). K2
# stages a design taller than one stage in row chunks (csrc/grid_suffstats.cu,
# chunk_rows_for): the tall blocked LMM (N = 400, 40 clusters of 10) in
# chunks of 256 rows, which cut the segment [150, 400) and cluster 25; the
# p = 9 LMM, whose 56 global statistics K2 splits over two warps per sim, in
# chunks of 100 rows, which cut the segment [60, 200).
K2_CHECKS = {
    "c1_grid91": dict(DESIGNS["curve_5pred_8grid"], grid=list(range(50, 505, 5))),
    "lmm_blocked_tall": dict(LAYOUT_CHECKS["lmm_blocked_2grid"], grid=[150, 400]),
    "wide_p9": dict(
        LAYOUT_CHECKS["lmm_round_robin_2grid"],
        grid=[60, 200],
        var_types=["normal"] * 8,
        corr=np.eye(8).tolist(),
        effects=[0.0] + [0.1] * 8,
        target_cols=list(range(1, 9)),
    ),
}
# K4 cluster counts off the path: fewer clusters than lanes x registers,
# and more than 32 lanes hold (p = 3), so some come from memory.
K4_SYNTHETIC_M = (7, 150)

# K1's tables, each held against the plain fill in all three modes (words,
# open uniforms, normals): the stream plans of the main path's three arms
# (sim ids 0.., seed (SEED, 0) as run_batch derives it), and off the path a
# plan of row counts that are not multiples of 4, one stream shorter than a
# 4-row block, sim ids that cross 2**31 and a nonzero high seed word. Plans
# are (class, column, rows): class 0 predictor normals, 3 cluster
# intercepts, 1 residuals (rng.CLASS_*).
K1_CHECKS = {
    "lmm_headline": dict(design="lmm_headline"),
    "ols_10k": dict(design="ols_10k"),
    "curve_5pred_8grid": dict(design="curve_5pred_8grid"),
    "glm_bonferroni_10k": dict(design="glm_bonferroni_10k"),
    "ragged_high_ids": dict(plan=[(0, 3, 13), (3, 0, 3), (1, 0, 201)], sim0=2**31 - 2, seed_hi=3),
    # the second fill of a logit design with a sampled factor: the RESID
    # words and the FACTOR words (class 2) in one launch
    "logit_factor_words": dict(design="logit_factor_sampled", fill=1),
    # the realistic LMM of model_lmm_scenarios: its long normals (2
    # predictors, CLUSTER 0..10 of the t(10) intercept at 20 rows, RESID
    # 0..8 of the t(8) / chi-square(8) swap), its short normals (SCENARIO 0
    # and 5, HET 0) and the words of its swap uniforms (SCENARIO 1..4)
    "lmm_realistic": dict(design="lmm_realistic", fill=0),
    "lmm_realistic_short": dict(design="lmm_realistic", fill=1),
    "lmm_realistic_swaps": dict(design="lmm_realistic", fill=2),
    # 33 long streams (13 predictors in the realistic LMM): two launches
    "split_33": dict(design="lmm_realistic_13", fill=0),
}


def k1_table(lower_mod, cluster_cls, datagen_mod, name: str):
    """``(plan, first sim id, seed_hi)`` of K1_CHECKS[name]; a design's plan
    is fill ``fill`` (default 0, the long normals) of
    ``datagen_mod.fill_plan`` of the lowered design."""
    c = K1_CHECKS[name]
    if "design" in c:
        spec, _ = lower_design(lower_mod, cluster_cls, c["design"])
        return datagen_mod.fill_plan(spec)[c.get("fill", 0)][1], 0, 0
    return [tuple(s) for s in c["plan"]], c["sim0"], c["seed_hi"]


# K3's cases, each held against the plain solve: the cells of the OLS and
# curve arms (phase 3's generated data), and off the path synthetic cells on
# a two-point grid: p = 1 and p = 16 (one group of 2 and of 32 lanes per
# cell), rank-deficient cells (the last column a copy of column 1, zero, or
# twice column 2) and cells whose pivot ratio straddles EPS_RANK = 1e-6,
# with the last column delta (x1 + w) ("scaled", a well-conditioned solve in
# relative terms) or x1 + delta w ("collinear"), delta log-uniform over
# [10^-6.6, 10^-5.6] per sim. The reduced fits of a sparse-factor exclusion
# ("mask"): each cell's own column mask (each of columns 1..6 dropped with
# probability 0.3, per sim and grid point), the masked rows and columns of
# X'X zeroed with a unit diagonal and a per-cell p_eff, as olsfit does;
# "masked_unit_pivot" scales column 1 by 10^[4.5, 5.3] per sim and masks
# only columns 2..6, so that a masked column's unit pivot is the smallest
# and the pivot ratio straddles EPS_RANK only in the cells with a mask; its
# y does not load on column 1 (a y of that scale makes rss = y'y - b'X'y a
# difference of two ~1e10-times larger sums, whose order alone moved t^2 by
# 3e-7 between K3 and the plain sum on the H100).
K3_GRID = (100, 200)
K3_CHECKS = {
    "ols_10k": dict(design="ols_10k"),
    "curve_5pred_8grid": dict(design="curve_5pred_8grid"),
    "p1": dict(p=1, last="free"),
    "p16": dict(p=16, last="free"),
    "rank_deficient": dict(p=7, last="dependent"),
    "straddle_scaled": dict(p=7, last="scaled"),
    "straddle_collinear": dict(p=7, last="collinear"),
    "masked_p_eff": dict(p=7, last="free", mask=1),
    "masked_unit_pivot": dict(p=7, last="wide", mask=2),
}
K3_MASK_DROP = 0.3


def k3_synthetic_xy(name: str, sims: int, seed: int = SEED):
    """f32 ``X (sims, 200, p)`` with an intercept column and ``y (sims,
    200)`` for the synthetic K3_CHECKS case ``name``, from ``seed``."""
    c = K3_CHECKS[name]
    p, last, n = c["p"], c["last"], K3_GRID[-1]
    rs = np.random.RandomState(seed + p)
    X = rs.standard_normal((sims, n, p))
    X[..., 0] = 1.0
    delta = 10.0 ** rs.uniform(-6.6, -5.6, size=(sims, 1))
    w = rs.standard_normal((sims, n))
    if last == "scaled":
        X[..., -1] = delta * (X[..., 1] + w)
    elif last == "collinear":
        X[..., -1] = X[..., 1] + delta * w
    elif last == "wide":
        X[..., 1] *= 10.0 ** rs.uniform(4.5, 5.3, size=(sims, 1))
    elif last == "dependent":
        third = sims // 3
        X[:third, :, -1] = X[:third, :, 1]
        X[third:2 * third, :, -1] = 0.0
        X[2 * third:, :, -1] = 2.0 * X[2 * third:, :, 2]
    coef = np.linspace(0.3, -0.1, p)
    if last == "wide":  # y free of the scaled column: no cancellation in rss
        coef[1] = 0.0
    y = X @ coef + rs.standard_normal((sims, n))
    return X.astype(np.float32), y.astype(np.float32)


def k3_mask(name: str, sims: int, seed: int = SEED):
    """The K3_CHECKS case's column mask ``(sims, G, p)`` f64: columns from
    its ``mask`` on each dropped with probability K3_MASK_DROP."""
    c = K3_CHECKS[name]
    rs = np.random.RandomState(seed + 7 * c["p"])
    cm = np.ones((sims, len(K3_GRID), c["p"]))
    cm[..., c["mask"]:] = rs.uniform(size=cm[..., c["mask"]:].shape) >= K3_MASK_DROP
    return cm


def k3_stats(X, y, grid=K3_GRID):
    """Prefix statistics of f32 ``X``, ``y`` in f64 numpy, as K3 takes them:
    ``(xtx (sims, G, p, p), xty (sims, G, p), yty, ysum (sims, G), ns (G,))``."""
    Xf, yf = X.astype(np.float64), y.astype(np.float64)
    stats = [(np.einsum("bnp,bnq->bpq", Xf[:, :n], Xf[:, :n]), np.einsum("bnp,bn->bp", Xf[:, :n], yf[:, :n]),
              (yf[:, :n] ** 2).sum(-1), yf[:, :n].sum(-1)) for n in grid]
    return tuple(np.stack(v, axis=1) for v in zip(*stats)) + (np.asarray(grid, np.float64),)

# K6's cases, each held against the plain IRLS (glmfit.glm_irls_plain) on the
# same f32 X and y: the GLM arm's cells (generated data, 10,000 sims), the
# launch of the logit sample-size flow (the arm's design on that flow's
# 13-point grid, one chunk of N_SIMS / 8 sims), and off the path GLM designs
# on generated data (probit, Poisson, the cold start of truth_start=False, a
# 12-point grid, one pinned column) and synthetic cells on one grid point of
# 300 rows (p = 1 and p = 16; separated cells, y = 1 exactly where x1 > 0,
# whose slope runs to BETA_CAP; a rank-deficient last column, a copy of
# column 1).
# find_sample_size(from_size=100, to_size=600)'s grid (orchestrator/grid.py,
# linear, the CONFIG step).
FLOW_GRID_LOGIT = [100, 145, 190, 235, 280, 325, 370, 415, 460, 505, 550, 595, 600]
# The grids of the README model's and the logit factor model's
# find_sample_size (MODEL_FLOWS), and those models as lower() arguments:
# the README model's columns are the intercept, x1, x2 (binary), group[2],
# group[3] and x1:x2; the logit factor model's intercept is the log odds of
# its baseline probability 0.2. "logit_factor_sampled" draws the levels per
# row (the scenario's sampled_factor_proportions), so that exclusion, and
# with it the column mask, differs between sims.
FLOW_GRID_README = [50, 91, 132, 173, 214, 255, 296, 337, 378, 419, 460, 500]
FLOW_GRID_LOGIT_FACTOR = [40, 60, 80, 100, 120, 140, 160, 180, 200]
FACTOR_DESIGNS = {
    "readme_sample_size": dict(
        grid=FLOW_GRID_README, var_types=["normal", "binary"], var_params=[0.0, 0.5],
        corr=[[1.0, 0.3], [0.3, 1.0]], factor_levels=[3], factor_props=[0.4, 0.3, 0.3],
        effects=[0.0, 0.3, 0.25, 0.4, 0.2, 0.15], target_cols=[1, 2, 3, 4, 5],
        interactions=[(1, 2)], correction="holm", report_overall=True),
    "logit_factor": dict(
        grid=FLOW_GRID_LOGIT_FACTOR, var_types=["normal"], factor_levels=[3],
        factor_props=[0.8, 0.1, 0.1], effects=[float(np.log(0.25)), 0.4, 0.5, 0.5],
        target_cols=[1, 2, 3], outcome="binary", estimator="glm", report_overall=True),
}
FACTOR_DESIGNS["logit_factor_sampled"] = dict(
    FACTOR_DESIGNS["logit_factor"], scenario=dict(sampled_factor_proportions=True))
# tests/test_reduced_refit.py's separated design: level 4 of the factor
# predicts y = 1 in nearly every sim, so nearly every cell needs the fallback.
FACTOR_DESIGNS["separated_factor"] = dict(
    grid=[100], var_types=["normal"], factor_levels=[4], factor_props=[0.55, 0.20, 0.15, 0.10],
    effects=[-1.5, 0.5, 0.0, 0.0, 8.0], target_cols=[1], outcome="binary", estimator="glm")
K6_DESIGNS = {
    "probit": dict(DESIGNS["glm_bonferroni_10k"], link="probit"),
    "poisson": dict(grid=[150], var_types=["normal", "normal"], effects=[0.6931471805599453, 0.2, 0.15],
                    target_cols=[1, 2], outcome="count", estimator="glm"),
    "cold_start": dict(DESIGNS["glm_bonferroni_10k"], truth_start=False),
    "grid12": dict(DESIGNS["glm_bonferroni_10k"], grid=list(range(25, 325, 25))),
    "logit_sample_size": dict(DESIGNS["glm_bonferroni_10k"], grid=FLOW_GRID_LOGIT),
}
# With factors: each cell's column mask from the exclusion of its sparse
# levels ("exclusion"), and the separation fallback's launch over the cells
# whose first fit did not converge, with its cold start and its mask less
# the sparsest factor ("fallback"): the logit factor flow's launch (its
# fixed allocation, one chunk), the sampled design, whose masks differ
# between sims and whose failed cells are few, and the separated design.
K6_CHECKS = {
    "glm_bonferroni_10k": dict(design="glm_bonferroni_10k", sims=N_SIMS),
    "logit_sample_size": dict(design="logit_sample_size", sims=N_SIMS // 8),
    **{name: dict(design=name) for name in ("probit", "poisson", "cold_start", "grid12")},
    "pinned": dict(design="glm_bonferroni_10k", pin=2),
    "p1": dict(p=1, kind="free"),
    "p16": dict(p=16, kind="free"),
    "separated": dict(p=3, kind="separated"),
    "rank_deficient": dict(p=4, kind="dependent"),
    "logit_factor_flow": dict(design="logit_factor", sims=N_SIMS // 8, exclusion=True),
    "logit_factor_flow_fallback": dict(design="logit_factor", sims=N_SIMS // 8, exclusion=True,
                                       fallback=True),
    "colmask_per_sim": dict(design="logit_factor_sampled", sims=N_SIMS // 8, exclusion=True),
    "fallback_sparse": dict(design="logit_factor_sampled", sims=N_SIMS // 8, exclusion=True,
                            fallback=True),
    "fallback_separated": dict(design="separated_factor", exclusion=True, fallback=True),
}
K6_ROWS = 300


# K7's cases (phase 3), each held against the plain fit
# (glmmfit.glmm_intercept_plain) on the same generated f32 X and y: the
# GLMM arms' cells (2,000 sims, nagq 7 and 1), a launch of README flow 3 (one
# chunk of N_SIMS / 8 sims, N = 480, 24 clusters, p = 2, lowered by the
# flow itself), and off the path probit, Poisson (tests/test_glmm.py:118's
# design, its counts through K8), nagq 25, the FD Hessian at p = 3, a
# three-point grid, blocked clusters, 40 clusters (more than a warp's
# lanes), p = 1 and p = 16, boundary cells (tau^2 = 0.02) and the cold
# start of truth_start=False; then a launch of README flow 3's
# find_sample_size (one chunk of N_SIMS / 8 sims on its 11-point grid, N
# 240..720, as the flow lowers it), 1,024 clusters of two rows (p = 3), a
# cell too large for K7's shared-memory plan, so its streamed path, and p =
# 4 and p = 6 (K7's p = 4 and p <= 8 instantiations).
_GLMM_BASE = GLMM_DESIGNS["glmm_laplace"]
K7_DESIGNS = {
    "glmm_probit": dict(_GLMM_BASE, link="probit", effects=[-0.2, 0.3, 0.2]),
    "glmm_poisson": dict(grid=[300], var_types=["normal"], effects=[0.6931471805599453, 0.2],
                         target_cols=[1], outcome="count", estimator="glm",
                         cluster=dict(sizing_mode="fixed_clusters", sizing_value=30,
                                      tau_squared=0.2)),
    "glmm_agq25": dict(_GLMM_BASE, nagq=25),
    "glmm_hessian": dict(_GLMM_BASE, wald_se="hessian"),
    "glmm_grid3": dict(_GLMM_BASE, grid=[60, 120, 200]),
    "glmm_blocked": dict(_GLMM_BASE, grid=[100, 200],
                         cluster=dict(sizing_mode="fixed_size", sizing_value=10, tau_squared=0.25)),
    "glmm_m40": dict(_GLMM_BASE, grid=[200, 400],
                     cluster=dict(sizing_mode="fixed_clusters", sizing_value=40, tau_squared=0.25)),
    "glmm_p1": dict(grid=[200], var_types=[], effects=[-0.3], target_cols=[], outcome="binary",
                    estimator="glm", cluster=_GLMM_BASE["cluster"]),
    "glmm_p16": dict(grid=[400], var_types=["normal"] * 15, effects=[-0.3] + [0.05] * 15,
                     target_cols=list(range(1, 16)), outcome="binary", estimator="glm",
                     cluster=_GLMM_BASE["cluster"]),
    "glmm_boundary": dict(_GLMM_BASE, cluster=dict(_GLMM_BASE["cluster"], tau_squared=0.02)),
    "glmm_cold_start": dict(_GLMM_BASE, truth_start=False),
    "glmm_p4": dict(grid=[200], var_types=["normal"] * 3, effects=[-0.3, 0.3, 0.2, 0.1],
                    target_cols=[1, 2, 3], outcome="binary", estimator="glm",
                    cluster=_GLMM_BASE["cluster"]),
    "glmm_p6": dict(grid=[300], var_types=["normal"] * 5, effects=[-0.3, 0.3, 0.2, 0.1, 0.1, -0.1],
                    target_cols=[1, 2, 3, 4, 5], outcome="binary", estimator="glm",
                    cluster=_GLMM_BASE["cluster"]),
    "glmm_m1024": dict(_GLMM_BASE, grid=[2048],
                       cluster=dict(sizing_mode="fixed_clusters", sizing_value=1024,
                                    tau_squared=0.25)),
}
# Cases lowered by a README flow 3 call: (flow, sims).
K7_FLOW_CASES = {"readme_flow_launch": ("model_glmm_power", N_SIMS // 8),
                 "readme_sample_size_launch": ("model_glmm_sample_size", N_SIMS // 8)}
K7_CHECKS = {
    "glmm_agq7": GLMM_SIMS, "glmm_laplace": GLMM_SIMS,
    **{name: sims for name, (_, sims) in K7_FLOW_CASES.items()},
    **{name: GOLDEN_SIMS for name in K7_DESIGNS}, "glmm_p6": 256, "glmm_p16": 64,
    "glmm_m1024": 64,
}
# The cases that must take K7's streamed path (the others its staged one).
K7_STREAMED = ("glmm_m1024",)

# The random-slope LMM (K2's slope mode and kernel K9). The arm:
# benchmarks/throughput.py's lmm_slopes (:130-139), the LMM headline's design
# with a random slope on x1 (variance 0.2, corr 0.3 to the intercept; q = 2,
# p = 3), driven as one chunk of N_SIMS sims in phase 4. Off the arm, held in
# phase 3 only: throughput.py's lmm_multislope (:236-246: q = 3, p = 5,
# N = 480), tests/test_slopes.py:110-126's null slope (which pins often),
# q = 4 (p = 5), q = 4 at p = 16 and 1,024 clusters of two rows, whose f32
# twins outgrow K9's shared-memory stage (its streamed path).
_SLOPE = dict(design_col=1, variance=0.2, intercept_corr=0.3)
SLOPE_DESIGNS = {
    "lmm_slopes": dict(DESIGNS["lmm_headline"],
                       cluster=dict(DESIGNS["lmm_headline"]["cluster"], slopes=[_SLOPE])),
}
_MULTISLOPE = dict(grid=[480], var_types=["normal"] * 4, corr=np.eye(4).tolist(),
                   effects=[0.0, 0.15, 0.15, 0.0, 0.0], target_cols=[1, 2], estimator="mle",
                   cluster=dict(sizing_mode="fixed_clusters", sizing_value=20, tau_squared=0.25,
                                slopes=[dict(design_col=1, variance=0.10, intercept_corr=0.3),
                                        dict(design_col=2, variance=0.08, intercept_corr=0.1)]))
_SLOPE_Q4 = _MULTISLOPE["cluster"]["slopes"] + [dict(design_col=3, variance=0.05,
                                                     intercept_corr=0.2)]
K9_DESIGNS = {
    "lmm_multislope": _MULTISLOPE,
    "slopes_null": dict(grid=[240], var_types=["normal"], effects=[0.0, 0.4], target_cols=[1],
                        estimator="mle",
                        cluster=dict(sizing_mode="fixed_clusters", sizing_value=30,
                                     tau_squared=0.3,
                                     slopes=[dict(design_col=1, variance=0.0,
                                                  intercept_corr=0.0)])),
    "slopes_q4": dict(_MULTISLOPE, cluster=dict(_MULTISLOPE["cluster"], slopes=_SLOPE_Q4)),
    "slopes_p16": dict(grid=[240], var_types=["normal"] * 15, effects=[0.0] + [0.05] * 15,
                       target_cols=list(range(1, 16)), estimator="mle",
                       cluster=dict(sizing_mode="fixed_clusters", sizing_value=24,
                                    tau_squared=0.25, slopes=_SLOPE_Q4)),
    "slopes_m1024": dict(SLOPE_DESIGNS["lmm_slopes"], grid=[2048],
                         cluster=dict(sizing_mode="fixed_clusters", sizing_value=1024,
                                      tau_squared=0.25, slopes=[_SLOPE])),
}
# Cases lowered by a README flow 2 call: (flow, sims).
K9_FLOW_CASES = {"readme2_flow_launch": ("model_lmm_slopes_power", N_SIMS // 8),
                 "readme2_sample_size_launch": ("model_lmm_slopes_sample_size", N_SIMS // 8)}
K9_CHECKS = {
    "readme2_flow_launch": N_SIMS // 8, "lmm_slopes": N_SIMS, "lmm_multislope": GOLDEN_SIMS,
    "slopes_null": GOLDEN_SIMS, "readme2_sample_size_launch": N_SIMS // 8,
    "slopes_q4": GOLDEN_SIMS, "slopes_p16": 256, "slopes_m1024": 256,
}
# The cases that must take K9's streamed path (the others its staged one).
K9_STREAMED = ("slopes_m1024",)
# K2's slope mode against its plain version: p = 3, q = 2 and p = 16, q = 4.
K2_SLOPE_CHECKS = ("lmm_slopes", "slopes_p16")

# The GLMM with random slopes (kernel K10). The arm: benchmarks/
# throughput.py's glmm_slopes (:140-145), its base design (:91-97) with
# cl_slopes (:133-138): logit, effects -0.3 / 0.3 / 0.2, N 200, 20 clusters,
# a slope on x1 (variance 0.2, corr 0.3), q = 2, p = 3, driven as one chunk
# of its N_SIMS (4,000) sims in phase 4. K10's cases (phase 3), each held
# against glmmfit.glmm_slope_plain bit for bit on the same generated rows:
# the arm's design, a launch of the slope GLMM flow (N_SIMS / 8 sims, N 480,
# 24 clusters, p 2, lowered by the flow), and off the path q = 3 (slopes on
# x1 and x2), q = 4 at p = 16 (the widest bucket), probit, Poisson (its
# counts through K8), the FD Hessian, blocked clusters on a two-point grid
# and 300 clusters of eight rows (clusters l, l + 32, ... on a lane, many
# times round). K10 keeps its per-cluster state in device scratch, so it
# has no streamed path apart.
SLOPE_GLMM_SIMS = 4_000
_SLOPE_GLMM = dict(_GLMM_BASE, cluster=dict(_GLMM_BASE["cluster"], slopes=[_SLOPE]))
SLOPE_GLMM_DESIGNS = {"glmm_slopes": _SLOPE_GLMM}
_SLOPE2 = dict(design_col=2, variance=0.1, intercept_corr=0.1)
K10_DESIGNS = {
    "glmm_slopes_q3": dict(_SLOPE_GLMM, cluster=dict(_SLOPE_GLMM["cluster"],
                                                     slopes=[_SLOPE, _SLOPE2])),
    "glmm_slopes_q4_p16": dict(grid=[240], var_types=["normal"] * 15,
                               effects=[-0.3] + [0.05] * 15, target_cols=list(range(1, 16)),
                               outcome="binary", estimator="glm",
                               cluster=dict(sizing_mode="fixed_clusters", sizing_value=24,
                                            tau_squared=0.25, slopes=_SLOPE_Q4)),
    "glmm_slopes_probit": dict(_SLOPE_GLMM, link="probit", effects=[-0.2, 0.3, 0.2]),
    "glmm_slopes_poisson": dict(_SLOPE_GLMM, outcome="count", effects=[0.5, 0.2, 0.1],
                                cluster=dict(_SLOPE_GLMM["cluster"], tau_squared=0.2,
                                             slopes=[dict(_SLOPE, variance=0.1)])),
    "glmm_slopes_hessian": dict(_SLOPE_GLMM, wald_se="hessian"),
    "glmm_slopes_blocked": dict(_SLOPE_GLMM, grid=[100, 200],
                                cluster=dict(sizing_mode="fixed_size", sizing_value=10,
                                             tau_squared=0.25, slopes=[_SLOPE])),
    "glmm_slopes_m300": dict(_SLOPE_GLMM, grid=[2400],
                             cluster=dict(sizing_mode="fixed_clusters", sizing_value=300,
                                          tau_squared=0.25, slopes=[_SLOPE])),
}
# Cases lowered by a flow of the slope GLMM: (flow, sims).
K10_FLOW_CASES = {"glmm_slopes_flow_launch": ("model_glmm_slopes_power", N_SIMS // 8)}
# Sims of each case: the plain version runs many small operations a pass,
# so its windows stay small. K10_STREAMED_CHECKS run again in the streamed
# form, which a launch takes where the shared form does not fit.
K10_STREAMED_CHECKS = ("glmm_slopes_blocked", "glmm_slopes_m300")
K10_CHECKS = {
    "glmm_slopes": 512, "glmm_slopes_flow_launch": N_SIMS // 8, "glmm_slopes_q3": 128,
    "glmm_slopes_q4_p16": 16, "glmm_slopes_probit": 128, "glmm_slopes_poisson": 128,
    "glmm_slopes_hessian": 64, "glmm_slopes_blocked": 64, "glmm_slopes_m300": 16,
}

# The LMM with extra groupings (K2's joint mode and kernel K11). The arms:
# bench.py's cliff arm lmm_extras (:146-166; benchmarks/throughput.py
# :147-161): the LMM headline's design with a crossed grouping of 10 levels
# (tau^2 0.15; M = 30, d = 2, the structured capacitance, Me = 10), and the
# same with throughput.py's cl_slopes slope on x1 (:133-138: variance 0.2,
# corr 0.3; M = 40 + 10 = 50, d = 4, the dense capacitance), each driven as
# one chunk of EXTRAS_SIMS sims in phase 4. K11's cases (phase 3), each held
# against mixedfit.joint_reml_plain bit for bit on the same generated rows:
# the two arms, a launch of each extras flow (N_SIMS / 8 sims, lowered by the
# flow: crossed Me = 25, nested Me = 48, dense M = 70), and off the path two
# extra groupings (crossed 4, then nested 2 per parent: the stride chain),
# a dense plan whose crossed grouping carries a slope of its own, p = 16
# (the blocked p x p factor), and the forced-dense A/B of the structured
# arm (EXTRAS_AB_THETA).
EXTRAS_SIMS = 2_000
_EXTRAS = dict(DESIGNS["lmm_headline"], cluster=dict(
    DESIGNS["lmm_headline"]["cluster"],
    extra_groupings=[dict(relation="crossed", n_levels=10, tau_squared=0.15)]))
EXTRAS_DESIGNS = {
    "lmm_extras": _EXTRAS,
    "lmm_extras_dense": dict(_EXTRAS, cluster=dict(_EXTRAS["cluster"], slopes=[_SLOPE])),
}
K11_DESIGNS = {
    "extras_two": dict(_EXTRAS, grid=[192], cluster=dict(
        sizing_mode="fixed_clusters", sizing_value=12, tau_squared=0.25,
        extra_groupings=[dict(relation="crossed", n_levels=4, tau_squared=0.15),
                         dict(relation="nested", n_levels=2, tau_squared=0.1)])),
    "extras_exslope": dict(_EXTRAS, grid=[160], cluster=dict(
        sizing_mode="fixed_clusters", sizing_value=10, tau_squared=0.25,
        extra_groupings=[dict(relation="crossed", n_levels=8, tau_squared=0.15,
                              slopes=[dict(design_col=1, variance=0.1, intercept_corr=0.2)])])),
    "extras_p16": dict(grid=[288], var_types=["normal"] * 15, effects=[0.0] + [0.05] * 15,
                       target_cols=list(range(1, 16)), estimator="mle",
                       cluster=dict(sizing_mode="fixed_clusters", sizing_value=12,
                                    tau_squared=0.25, extra_groupings=[
                                        dict(relation="crossed", n_levels=6,
                                             tau_squared=0.15)])),
}
# Cases lowered by a flow of the extras: (flow, sims).
K11_FLOW_CASES = {"crossed_flow_launch": ("model_crossed_power", N_SIMS // 8),
                  "nested_flow_launch": ("model_nested_power", N_SIMS // 8),
                  "dense_flow_launch": ("model_dense_extras_power", N_SIMS // 8)}
K11_CHECKS = {
    "lmm_extras": EXTRAS_SIMS, "lmm_extras_dense": 512, "crossed_flow_launch": N_SIMS // 8,
    "nested_flow_launch": N_SIMS // 8, "dense_flow_launch": 512, "extras_two": 256,
    "extras_exslope": 256, "extras_p16": 64,
}
# K2's joint mode against its plain version: structured, dense and p = 16.
K2_JOINT_CHECKS = ("lmm_extras", "lmm_extras_dense", "extras_exslope", "extras_p16")

# The GLMM with extra groupings (kernel K12). The arms: bench.py's cliff arm
# glmm_extras (:146-166; benchmarks/throughput.py:161-165): glmm_laplace's
# logit design with a crossed grouping of 10 levels (tau^2 0.15; M = 30, d =
# 2, the structured capacitance, Me = 10), and the same with throughput.py's
# cl_slopes slope on x1 (:133-138: variance 0.2, corr 0.3; M = 40 + 10 = 50,
# d = 4, the dense capacitance), each driven as one chunk of
# GLMM_EXTRAS_SIMS sims in phase 4. K12's cases (phase 3), each held against
# glmmfit.glmm_extras_plain bit for bit on the same generated rows (theta
# too): the two arms, a launch of the crossed, nested and dense GLMM flows
# (N_SIMS / 8 sims, lowered by the flow: Me 10, nested Me 48 with the blocked
# Schur factor, dense M 58), and off the path two extra groupings (crossed 4,
# then nested 2 a parent), a dense plan whose crossed grouping carries a
# slope of its own, probit, Poisson (its counts through K8), the FD Hessian
# and p = 16 (the blocked p x p factor); and the structured arm forced
# through the dense capacitance at the structured fit's theta
# (GLMM_EXTRAS_AB_FIT_REL).
GLMM_EXTRAS_SIMS = 2_000
_GLMM_EXTRAS = dict(_GLMM_BASE, cluster=dict(
    _GLMM_BASE["cluster"],
    extra_groupings=[dict(relation="crossed", n_levels=10, tau_squared=0.15)]))
GLMM_EXTRAS_DESIGNS = {
    "glmm_extras": _GLMM_EXTRAS,
    "glmm_extras_dense": dict(_GLMM_EXTRAS, cluster=dict(_GLMM_EXTRAS["cluster"],
                                                         slopes=[_SLOPE])),
}
K12_DESIGNS = {
    "glmm_extras_two": dict(_GLMM_EXTRAS, grid=[192], cluster=dict(
        sizing_mode="fixed_clusters", sizing_value=12, tau_squared=0.25,
        extra_groupings=[dict(relation="crossed", n_levels=4, tau_squared=0.15),
                         dict(relation="nested", n_levels=2, tau_squared=0.1)])),
    "glmm_extras_exslope": dict(_GLMM_EXTRAS, grid=[160], cluster=dict(
        sizing_mode="fixed_clusters", sizing_value=10, tau_squared=0.25,
        extra_groupings=[dict(relation="crossed", n_levels=8, tau_squared=0.15,
                              slopes=[dict(design_col=1, variance=0.1, intercept_corr=0.2)])])),
    "glmm_extras_probit": dict(_GLMM_EXTRAS, link="probit", effects=[-0.2, 0.3, 0.2]),
    "glmm_extras_poisson": dict(_GLMM_EXTRAS, outcome="count", effects=[0.5, 0.2, 0.1]),
    "glmm_extras_hessian": dict(_GLMM_EXTRAS, wald_se="hessian"),
    "glmm_extras_p16": dict(grid=[288], var_types=["normal"] * 15, effects=[-0.3] + [0.05] * 15,
                            target_cols=list(range(1, 16)), outcome="binary", estimator="glm",
                            cluster=dict(sizing_mode="fixed_clusters", sizing_value=12,
                                         tau_squared=0.25, extra_groupings=[
                                             dict(relation="crossed", n_levels=6,
                                                  tau_squared=0.15)])),
}
# Cases lowered by a flow of the GLMM with extra groupings: (flow, sims).
K12_FLOW_CASES = {"glmm_crossed_flow_launch": ("model_glmm_crossed_power", N_SIMS // 8),
                  "glmm_nested_flow_launch": ("model_glmm_nested_power", N_SIMS // 8),
                  "glmm_dense_flow_launch": ("model_glmm_dense_extras_power", N_SIMS // 8)}
# Sims of each case: the main path's at the arm and the crossed, nested and
# dense flow launches (phase 5 times K12 there); the plain version runs many
# small operations a pass, so the other windows stay small.
K12_CHECKS = {
    "glmm_extras": GLMM_EXTRAS_SIMS, "glmm_extras_dense": 256,
    "glmm_crossed_flow_launch": N_SIMS // 8, "glmm_nested_flow_launch": N_SIMS // 8,
    "glmm_dense_flow_launch": N_SIMS // 8, "glmm_extras_two": 128,
    "glmm_extras_exslope": 128, "glmm_extras_probit": 128, "glmm_extras_poisson": 128,
    "glmm_extras_hessian": 64, "glmm_extras_p16": 32,
}


def k7_args(spec, arr, X, y):
    """K7's arguments for a lowered GLMM design and its generated rows (the
    order glmmfit.glmm_grid_stats passes them)."""
    import torch

    from mcpower_tpu_torch.engine import glmfit, glmmfit

    fit = list(spec.effective_fit_cols)
    beta0 = (arr["effects"].to(torch.float64)[fit] if spec.scenario.truth_start
             else torch.zeros(len(fit), dtype=torch.float64, device=X.device))
    return (glmfit.link_code(spec.outcome, spec.link), X, y, fit, list(spec.grid),
            glmmfit.layout_of(spec), beta0, max(int(spec.nagq), 1), spec.wald_se == "hessian")


def k9_args(spec, suff):
    """K9's arguments from a lowered slope design's K2 slope-mode statistics
    (the order mixedfit.mixed_grid_stats passes them)."""
    import torch

    from mcpower_tpu_torch.engine import mixedfit

    ns = torch.as_tensor(spec.grid, dtype=torch.float64, device=suff["yty"].device)
    theta0, lower_ = mixedfit.slope_start(spec)
    return (suff["G"], suff["A"], suff["b"], suff["xtx"], suff["xty"], suff["yty"], ns, theta0,
            lower_)


def k10_args(spec, arr, X, y):
    """K10's arguments for a lowered slope-GLMM design and its generated
    rows (the order glmmfit.glmm_grid_stats passes them)."""
    import torch

    from mcpower_tpu_torch.engine import glmfit, glmmfit, mixedfit

    fit = list(spec.effective_fit_cols)
    beta0 = (arr["effects"].to(torch.float64)[fit] if spec.scenario.truth_start
             else torch.zeros(len(fit), dtype=torch.float64, device=X.device))
    theta0, lower_ = mixedfit.slope_start(spec)
    return (glmfit.link_code(spec.outcome, spec.link), X, y, fit,
            [s.design_col for s in spec.cluster.slopes], list(spec.grid), glmmfit.layout_of(spec),
            beta0, theta0, lower_, spec.wald_se == "hessian")


@contextmanager
def k10_plain():
    """Inside the block, K10's wrapper runs its plain version (on the
    card): the plain path of a slope-GLMM flow, its other kernels kept."""
    from mcpower_tpu_torch.engine import glmmfit

    real = glmmfit.glmm_slope_kernel
    glmmfit.glmm_slope_kernel = glmmfit.glmm_slope_plain
    try:
        yield
    finally:
        glmmfit.glmm_slope_kernel = real


@contextmanager
def k11_plain():
    """Inside the block, K11's and K2's joint-mode wrappers run their plain
    versions (on the card): the plain path of an extras flow, its other
    kernels kept."""
    from mcpower_tpu_torch.engine import mixedfit, olsfit

    real = mixedfit.joint_reml_kernel, olsfit.joint_suffstats_kernel
    mixedfit.joint_reml_kernel = mixedfit.joint_reml_plain
    olsfit.joint_suffstats_kernel = olsfit.joint_suffstats_plain
    try:
        yield
    finally:
        mixedfit.joint_reml_kernel, olsfit.joint_suffstats_kernel = real


def k11_args(spec, suff):
    """K11's arguments from a lowered extras design's joint statistics (the
    order mixedfit.mixed_grid_stats passes them)."""
    import torch

    from mcpower_tpu_torch.engine import mixedfit

    plan = mixedfit.grouping_plan(spec)
    _, theta0, lower_ = mixedfit.theta_layout(plan)
    return (suff["ztz"], suff["ztx"], suff["zty"], suff["xtx"], suff["xty"], suff["yty"],
            torch.as_tensor(spec.grid, dtype=torch.float64, device=suff["xtx"].device),
            [(m, q) for m, q, _, _, _ in plan], theta0, lower_)


def k12_args(spec, arr, X, y):
    """K12's arguments for a lowered GLMM design with extra groupings and its
    generated rows (the order glmmfit.glmm_grid_stats passes them)."""
    import torch

    from mcpower_tpu_torch.engine import glmfit, mixedfit, olsfit

    fit = list(spec.effective_fit_cols)
    beta0 = (arr["effects"].to(device=X.device, dtype=torch.float64)[fit]
             if spec.scenario.truth_start
             else torch.zeros(len(fit), dtype=torch.float64, device=X.device))
    _, theta0, lower_ = mixedfit.theta_layout(mixedfit.grouping_plan(spec))
    return (glmfit.link_code(spec.outcome, spec.link), X, y, fit, list(spec.grid),
            olsfit.joint_layout(spec, X.device)[0], beta0, theta0, lower_,
            spec.wald_se == "hessian")


@contextmanager
def k12_plain():
    """Inside the block, K12's wrapper runs its plain version (on the card):
    the plain path of a GLMM extras flow, its other kernels kept."""
    from mcpower_tpu_torch.engine import glmmfit

    real = glmmfit.glmm_extras_kernel
    glmmfit.glmm_extras_kernel = glmmfit.glmm_extras_plain
    try:
        yield
    finally:
        glmmfit.glmm_extras_kernel = real


def k7_is_pr10(k) -> bool:
    """Whether K7 build ``k`` is PR 10's, whose launcher takes a per-cell
    scratch from its caller (its source has no geometry entry)."""
    return "mcp_glmm_intercept_geometry" not in (k.csrc / k.source).read_text()


def k7_pr10_call(k, code, X, y, fit, grid, layout, beta0, nagq=1, hessian=False):
    """PR 10's K7 build ``k`` on K7's arguments, launched as PR 10's wrapper
    launched it (its scratch (sims * G, m, pf + 6) f64 from the caller);
    counted on ``k``. The outputs of ``glmmfit.glmm_intercept_kernel``."""
    import ctypes

    import torch

    from mcpower_tpu_torch.engine import glmmfit, kernels

    fit, grid = [int(c) for c in fit], [int(n) for n in grid]
    rr, period, m = bool(layout[0]), int(layout[1]), int(layout[2])
    pf, G = len(fit), len(grid)
    sims, max_n, P = X.shape
    dev_ = X.device
    kw = dict(dtype=torch.float64, device=dev_)
    beta0 = beta0.to(**kw).contiguous()
    grid_t = torch.tensor(grid, dtype=torch.int32, device=dev_)
    beta, cov = torch.empty((sims, G, pf), **kw), torch.empty((sims, G, pf, pf), **kw)
    tau2, ybar = torch.empty((sims, G), **kw), torch.empty((sims, G), **kw)
    flags = torch.empty((sims, G), dtype=torch.uint8, device=dev_)
    scratch = torch.empty((sims * G, m, pf + 6), **kw)
    x, lw, k0, dw = (glmmfit.gh_nodes(nagq) if nagq > 1 else
                     (np.zeros(1), np.zeros(1), 0, np.zeros(1, np.float32)))
    fn = k.fn("mcp_glmm_intercept", glmmfit._GLMM_ARGS)
    k.check(fn(kernels.ptr(X), kernels.ptr(y), sims, max_n, P, (ctypes.c_int * pf)(*fit), pf,
               kernels.ptr(grid_t), G, int(rr), period, m, code, kernels.ptr(beta0), nagq,
               (ctypes.c_double * len(x))(*x.tolist()), (ctypes.c_double * len(lw))(*lw.tolist()),
               (ctypes.c_float * len(dw))(*dw.tolist()), k0, int(hessian), kernels.ptr(scratch),
               kernels.ptr(beta), kernels.ptr(cov), kernels.ptr(tau2), kernels.ptr(ybar),
               kernels.ptr(flags), kernels.stream_of(X)))
    return beta, cov, (flags & 1).bool(), (flags & 2).bool(), tau2, ybar


def flow_lowered(name: str):
    """The (spec, arrays) of each scenario flow ``name`` lowers to, from a
    run of 8 sims through the port's plain path on the CPU."""
    from mcpower_tpu_torch import MCPower
    from mcpower_tpu_torch import model as model_mod
    from mcpower_tpu_torch.engine import batch
    from mcpower_tpu_torch.orchestrator import runner

    with stage_clock(model_mod, runner, batch) as clock:
        run_flow(MCPower, name, 8, device="cpu")
    return clock.take()["lowered"]


def k6_synthetic(name: str, sims: int, seed: int = SEED):
    """f32 ``X (sims, 300, p)`` with an intercept column and 0/1 ``y (sims,
    300)`` for the synthetic K6_CHECKS case ``name``, from ``seed``."""
    c = K6_CHECKS[name]
    p, kind = c["p"], c["kind"]
    rs = np.random.RandomState(seed + 100 * p)
    X = rs.standard_normal((sims, K6_ROWS, p))
    X[..., 0] = 1.0
    if kind == "dependent":
        X[..., -1] = X[..., 1]
    eta = X @ np.linspace(0.3, -0.2, p) * (1.0 if p < 16 else 0.5)
    y = (rs.uniform(size=eta.shape) < 1.0 / (1.0 + np.exp(-eta))).astype(np.float64)
    if kind == "separated":
        y = (X[..., 1] > 0).astype(np.float64)
    return X.astype(np.float32), y.astype(np.float32)


# K8's rows: synthetic eta spanning rates up to 20 (the walk), above 20
# (the normal approximation) and below exp(-104) (a zero rate), each with
# open uniforms from the whole range, the top ones at the clamp.
def k8_synthetic(torch, rows: int, seed: int = SEED, dev="cpu"):
    """``(u, eta)`` f32 of ``rows`` rows from ``seed``."""
    rs = np.random.RandomState(seed)
    eta = np.concatenate([rs.uniform(-6.0, np.log(20.0), rows // 2),
                          rs.uniform(np.log(20.0), 9.0, rows // 4),
                          rs.uniform(-120.0, -104.0, rows - rows // 2 - rows // 4)])
    u = (rs.randint(0, 2 ** 32, size=rows).astype(np.float64) + 0.5) / 2.0 ** 32
    u[::97] = 1.0  # the top open uniforms round to 1.0 in f32
    u[1::97] = float(np.float32(1.0 - 6e-8))
    return (torch.as_tensor(u.astype(np.float32), device=dev),
            torch.as_tensor(eta.astype(np.float32), device=dev))


# Counts of the JAX reference (mcpower_tpu.engine.batch.run_batch) at
# GOLDEN_SIMS sims, base seed SEED; tests/test_torch_batch.py recomputes
# them so they cannot go stale (the GLMM arms': tests/test_torch_glmm_batch.py).
GOLDEN = {
    "lmm_headline": {
        "boundary_hi": [0], "boundary_hit": [5], "converged": [1024],
        "joint_corr": [719], "joint_unc": [719],
        "nsig_hist_corr": [[5, 300, 719]], "nsig_hist_unc": [[5, 300, 719]],
        "pinned_comp": [[5]], "sig_corr": [[994, 744]], "sig_unc": [[994, 744]],
        "tau2_hat": [255.0467965903161], "n_done": 1024,
    },
    "ols_10k": {
        "converged": [1024], "joint_corr": [841], "joint_unc": [841],
        "nsig_hist_corr": [[183, 841]], "nsig_hist_unc": [[183, 841]],
        "sig_corr": [[841]], "sig_unc": [[841]], "n_done": 1024,
    },
    "curve_5pred_8grid": {
        "converged": [1024] * 8,
        "joint_corr": [0, 0, 0, 4, 14, 28, 67, 154],
        "joint_unc": [0, 0, 0, 4, 14, 28, 67, 154],
        "nsig_hist_corr": [
            [335, 447, 195, 41, 6, 0, 0], [70, 366, 382, 170, 32, 4, 0],
            [13, 147, 414, 327, 111, 12, 0], [1, 37, 270, 441, 224, 47, 4],
            [0, 8, 175, 414, 297, 116, 14], [0, 5, 79, 369, 378, 165, 28],
            [0, 0, 20, 211, 382, 344, 67], [0, 0, 5, 106, 345, 414, 154],
        ],
        "nsig_hist_unc": [
            [335, 447, 195, 41, 6, 0, 0], [70, 366, 382, 170, 32, 4, 0],
            [13, 147, 414, 327, 111, 12, 0], [1, 37, 270, 441, 224, 47, 4],
            [0, 8, 175, 414, 297, 116, 14], [0, 5, 79, 369, 378, 165, 28],
            [0, 0, 20, 211, 382, 344, 67], [0, 0, 5, 106, 345, 414, 154],
        ],
        "sig_corr": [
            [335, 219, 147, 91, 92, 100], [637, 450, 258, 145, 142, 156],
            [841, 622, 376, 188, 189, 244], [936, 766, 517, 254, 268, 314],
            [987, 857, 595, 317, 329, 367], [1005, 914, 665, 391, 380, 420],
            [1019, 976, 811, 486, 492, 539], [1023, 1006, 895, 579, 569, 630],
        ],
        "sig_unc": [
            [335, 219, 147, 91, 92, 100], [637, 450, 258, 145, 142, 156],
            [841, 622, 376, 188, 189, 244], [936, 766, 517, 254, 268, 314],
            [987, 857, 595, 317, 329, 367], [1005, 914, 665, 391, 380, 420],
            [1019, 976, 811, 486, 492, 539], [1023, 1006, 895, 579, 569, 630],
        ],
        "n_done": 1024,
    },
    "ols_composed_scenario": {
        "converged": [1024], "joint_corr": [537], "joint_unc": [537],
        "nsig_hist_corr": [[487, 537]], "nsig_hist_unc": [[487, 537]],
        "sig_corr": [[537]], "sig_unc": [[537]], "n_done": 1024,
    },
    "glm_bonferroni_10k": {
        "converged": [1024], "glm_baseline": [415.28333333333336],
        "joint_corr": [16], "joint_unc": [66],
        "nsig_hist_corr": [[320, 519, 169, 16]], "nsig_hist_unc": [[149, 473, 336, 66]],
        "sig_corr": [[551, 223, 131]], "sig_unc": [[713, 381, 249]], "singular": [0],
        "n_done": 1024,
    },
    "glmm_agq7": {
        "boundary_hit": [165],
        "converged": [1024],
        "glm_baseline": [442.78],
        "joint_corr": [77],
        "joint_unc": [77],
        "nsig_hist_corr": [[408, 539, 77]],
        "nsig_hist_unc": [[408, 539, 77]],
        "pinned_comp": [[165]],
        "sig_corr": [[464, 229]],
        "sig_unc": [[464, 229]],
        "singular": [165],
        "tau2_hat": [263.8836983635589],
        "n_done": 1024,
    },
    "lmm_slopes": {
        "boundary_hit": [41], "converged": [1024], "joint_corr": [449], "joint_unc": [449],
        "nsig_hist_corr": [[87, 488, 449]], "nsig_hist_unc": [[87, 488, 449]],
        "pinned_comp": [[1, 40]], "sig_corr": [[665, 721]], "sig_unc": [[665, 721]],
        "tau2_hat": [254.48892835600924], "n_done": 1024,
    },
    "glmm_slopes": {
        "boundary_hit": [585], "converged": [1024], "glm_baseline": [443.66499999999996],
        "joint_corr": [58], "joint_unc": [58], "nsig_hist_corr": [[516, 450, 58]],
        "nsig_hist_unc": [[516, 450, 58]], "pinned_comp": [[27, 585]], "sig_corr": [[331, 235]],
        "sig_unc": [[331, 235]], "singular": [585], "tau2_hat": [271.3981728317036],
        "n_done": 1024,
    },
    "glmm_laplace": {
        "boundary_hit": [165],
        "converged": [1024],
        "glm_baseline": [442.78],
        "joint_corr": [77],
        "joint_unc": [77],
        "nsig_hist_corr": [[409, 538, 77]],
        "nsig_hist_unc": [[409, 538, 77]],
        "pinned_comp": [[165]],
        "sig_corr": [[464, 228]],
        "sig_unc": [[464, 228]],
        "singular": [165],
        "tau2_hat": [248.82575843569634],
        "n_done": 1024,
    },
    # the JAX reference on the CPU, lmm_extras at GOLDEN_SIMS
    "lmm_extras": {
        "boundary_hit": [17],
        "converged": [1024],
        "joint_corr": [715],
        "joint_unc": [715],
        "nsig_hist_corr": [[6, 303, 715]],
        "nsig_hist_unc": [[6, 303, 715]],
        "pinned_comp": [[3, 14]],
        "sig_corr": [[994, 739]],
        "sig_unc": [[994, 739]],
        "tau2_hat": [254.86853240096613],
        "n_done": 1024,
    },
    # the JAX reference on the CPU, lmm_extras_dense at GOLDEN_SIMS
    "lmm_extras_dense": {
        "boundary_hit": [5],
        "converged": [1024],
        "joint_corr": [445],
        "joint_unc": [445],
        "nsig_hist_corr": [[91, 488, 445]],
        "nsig_hist_unc": [[91, 488, 445]],
        "pinned_comp": [[0, 3, 2]],
        "sig_corr": [[666, 712]],
        "sig_unc": [[666, 712]],
        "tau2_hat": [254.53568191755173],
        "n_done": 1024,
    },
    # the JAX reference on the CPU, glmm_extras at GOLDEN_SIMS (golden_values.py)
    "glmm_extras": {
        "boundary_hit": [379],
        "converged": [1024],
        "glm_baseline": [446.0950000000001],
        "joint_corr": [57],
        "joint_unc": [57],
        "nsig_hist_corr": [[411, 556, 57]],
        "nsig_hist_unc": [[411, 556, 57]],
        "pinned_comp": [[149, 286]],
        "sig_corr": [[437, 233]],
        "sig_unc": [[437, 233]],
        "singular": [379],
        "tau2_hat": [250.20601392337284],
        "n_done": 1024,
    },
    # the JAX reference on the CPU, glmm_extras_dense at GOLDEN_SIMS (golden_values.py)
    "glmm_extras_dense": {
        "boundary_hit": [174],
        "converged": [1024],
        "glm_baseline": [446.4600000000001],
        "joint_corr": [35],
        "joint_unc": [35],
        "nsig_hist_corr": [[541, 448, 35]],
        "nsig_hist_unc": [[541, 448, 35]],
        "pinned_comp": [[27, 96, 80]],
        "sig_corr": [[300, 218]],
        "sig_unc": [[300, 218]],
        "singular": [174],
        "tau2_hat": [273.6153214722745],
        "n_done": 1024,
    },
}
# The user flows of phase 6: ``MCPower`` built as a user writes it, then one
# call. The OLS model is the README's first flow with the factor replaced by
# a normal x3, kept beside the README's own model ("readme", factor group
# with fixed allocation, p = 6). The logit model is the GLM arm
# (bench.py:116-125) as a user writes it: intercept -0.4 as the baseline
# probability 1 / (1 + e^0.4). The Poisson model is tests/test_glm.py:133's
# design with a second predictor, at a baseline rate of 2. The ANOVA is a
# one-way design of four levels tested by its Tukey pairwise contrasts; the
# logit factor model has two rare levels (10% each), excluded where they
# hold fewer than 5 rows and separated (a level without events) in some
# sims above that, so that its sample-size search runs the fallback.
MODELS = {
    "lmm": dict(formula="y ~ x1 + x2 + (1|cluster)", family="lme",
                cluster=dict(tau_squared=0.25, n_clusters=20), types=None,
                corr="corr(x1, x2)=0.3", effects="x1=0.3, x2=0.2"),
    "ols": dict(formula="y ~ x1*x2 + x3", family="ols", cluster=None, types="x2=binary",
                corr="corr(x1, x2)=0.3", effects="x1=0.3, x2=0.25, x1:x2=0.15, x3=0.2"),
    "logit": dict(formula="y ~ x1 + x2 + x3", family="logit", cluster=None, types=None,
                  corr=None, effects="x1=0.3, x2=0.2, x3=0.15",
                  baseline_probability=1.0 / (1.0 + float(np.exp(0.4)))),
    "poisson": dict(formula="y ~ x1 + x2", family="poisson", cluster=None, types=None,
                    corr=None, effects="x1=0.2, x2=0.15", baseline_rate=2.0),
    "readme": dict(formula="y ~ x1*x2 + group", family="ols", cluster=None,
                   types="group=(factor,0.4,0.3,0.3), x2=binary", corr="corr(x1, x2)=0.3",
                   effects="x1=0.3, x2=0.25, x1:x2=0.15, group[2]=0.4, group[3]=0.2"),
    "anova": dict(formula="y ~ group", family="ols", cluster=None,
                  types="group=(factor,0.25,0.25,0.25,0.25)", corr=None,
                  effects="group[2]=0.3, group[3]=0.3, group[4]=0.5"),
    "logit_factor": dict(formula="y ~ x1 + group", family="logit", cluster=None,
                         types="group=(factor,0.8,0.1,0.1)", corr=None,
                         effects="x1=0.4, group[2]=0.5, group[3]=0.5",
                         baseline_probability=0.2),
    # README flow 3 (README.md:38-43) as written: a clustered logistic GLMM
    "glmm": dict(formula="y ~ dose + (1|clinic)", family="logit", cluster_name="clinic",
                 cluster=dict(ICC=0.15, n_clusters=24), types=None, corr=None,
                 effects="dose=0.35", baseline_probability=0.3),
    # README flow 3 with a random slope on dose, as flow 2 adds one to the
    # LMM: a logit GLMM with (1+dose|clinic), slope variance 0.1
    "glmm_slopes": dict(formula="y ~ dose + (1+dose|clinic)", family="logit",
                        cluster_name="clinic",
                        cluster=dict(ICC=0.15, n_clusters=24, random_slopes=["dose"],
                                     slope_variance=0.1),
                        types=None, corr=None, effects="dose=0.35", baseline_probability=0.3),
    # README flow 2 (README.md:31-36) as written: a random intercept and a
    # random slope on treatment, 30 sites
    "lmm_slopes": dict(formula="y ~ treatment + (1+treatment|site)", family="lme",
                       cluster_name="site",
                       cluster=dict(ICC=0.2, n_clusters=30, random_slopes=["treatment"],
                                    slope_variance=0.1),
                       types=None, corr=None, effects="treatment=0.4"),
    # extra groupings (K2's joint mode and kernel K11), each grouping sized by
    # its own set_cluster: examples/13_crossed_random_effects.py:12-22 as
    # written (subjects x items, crossed), examples/15_advanced_mixed_models.py
    # :32-42 as written (classrooms nested in schools) and README flow 2 with
    # a crossed rater, as docs/api.md:63 writes it (the dense capacitance)
    "crossed": dict(formula="rt = frequency + length + (1|subject) + (1|item)", family="lme",
                    clusters=[("subject", dict(ICC=0.2, n_clusters=40)),
                              ("item", dict(ICC=0.1, n_clusters=25))],
                    cluster=None, types=None, corr=None,
                    effects="frequency=-0.35, length=0.2"),
    "nested": dict(formula="score = method + (1|school/classroom)", family="lme",
                   clusters=[("school", dict(ICC=0.08, n_clusters=12)),
                             ("school:classroom", dict(ICC=0.1, n_clusters=48, n_per_parent=4))],
                   cluster=None, types="method=binary", corr=None, effects="method=0.35"),
    # the GLMM with extra groupings (kernel K12): README flow 3 with a
    # crossed rater (docs/api.md:63's form), with wards nested in clinics
    # (docs/api.md:63-64's (1|clinic/ward)), and with the slope GLMM flow's
    # (1+dose|clinic) beside the rater (the dense capacitance)
    "glmm_crossed": dict(formula="y ~ dose + (1|clinic) + (1|rater)", family="logit",
                         clusters=[("clinic", dict(ICC=0.15, n_clusters=24)),
                                   ("rater", dict(ICC=0.1, n_clusters=10))],
                         cluster=None, types=None, corr=None, effects="dose=0.35",
                         baseline_probability=0.3),
    "glmm_nested": dict(formula="y ~ dose + (1|clinic/ward)", family="logit",
                        clusters=[("clinic", dict(ICC=0.15, n_clusters=24)),
                                  ("clinic:ward", dict(ICC=0.1, n_clusters=48, n_per_parent=2))],
                        cluster=None, types=None, corr=None, effects="dose=0.35",
                        baseline_probability=0.3),
    "glmm_dense_extras": dict(formula="y ~ dose + (1+dose|clinic) + (1|rater)", family="logit",
                              clusters=[("clinic", dict(ICC=0.15, n_clusters=24,
                                                        random_slopes=["dose"],
                                                        slope_variance=0.1)),
                                        ("rater", dict(ICC=0.1, n_clusters=10))],
                              cluster=None, types=None, corr=None, effects="dose=0.35",
                              baseline_probability=0.3),
    "dense_extras": dict(formula="y ~ treatment + (1+treatment|site) + (1|rater)", family="lme",
                         clusters=[("site", dict(ICC=0.2, n_clusters=30,
                                                 random_slopes=["treatment"],
                                                 slope_variance=0.1)),
                                   ("rater", dict(ICC=0.1, n_clusters=10))],
                         cluster=None, types=None, corr=None, effects="treatment=0.4"),
}
# flow -> (model, method, arguments, the kernels its path must launch)
MODEL_FLOWS = {
    "model_lmm_power": ("lmm", "find_power", dict(sample_size=200),
                        ("philox_fill", "grid_suffstats", "reml_intercept")),
    "model_ols_power": ("ols", "find_power", dict(sample_size=200, correction="holm"),
                        ("philox_fill", "grid_suffstats", "ols_solve")),
    "model_ols_sample_size": ("ols", "find_sample_size", dict(from_size=50, to_size=500),
                              ("philox_fill", "grid_suffstats", "ols_solve")),
    "model_lmm_sample_size": ("lmm", "find_sample_size", dict(from_size=100, to_size=400),
                              ("philox_fill", "grid_suffstats", "reml_intercept")),
    "model_logit_power": ("logit", "find_power", dict(sample_size=300, correction="bonferroni"),
                          ("philox_fill", "glm_irls")),
    "model_logit_sample_size": ("logit", "find_sample_size", dict(from_size=100, to_size=600),
                                ("philox_fill", "glm_irls")),
    "model_poisson_power": ("poisson", "find_power", dict(sample_size=150),
                            ("philox_fill", "glm_irls", "poisson_quantile")),
    "model_readme_ols_power": ("readme", "find_power", dict(sample_size=200, correction="holm"),
                               ("philox_fill", "grid_suffstats", "ols_solve")),
    "model_readme_ols_sample_size": ("readme", "find_sample_size",
                                     dict(from_size=50, to_size=500),
                                     ("philox_fill", "grid_suffstats", "ols_solve")),
    "model_anova_tukey": ("anova", "find_power",
                          dict(sample_size=120, correction="tukey_hsd",
                               target_test="all-posthoc"),
                          ("philox_fill", "grid_suffstats", "ols_solve")),
    "model_logit_factor_sample_size": ("logit_factor", "find_sample_size",
                                       dict(from_size=40, to_size=200, by=20),
                                       ("philox_fill", "glm_irls")),
    # the three scenarios (optimistic, realistic, doomer) of scenarios=True:
    # README flow 1's last line as written, the LMM's heavy-tailed intercept
    # and ICC noise, and the logit model's intercept jitter and cold start
    "model_readme_ols_scenarios": ("readme", "find_sample_size",
                                   dict(from_size=50, to_size=500, scenarios=True),
                                   ("philox_fill", "grid_suffstats", "ols_solve")),
    "model_lmm_scenarios": ("lmm", "find_power", dict(sample_size=200, scenarios=True),
                            ("philox_fill", "grid_suffstats", "reml_intercept")),
    "model_logit_scenarios": ("logit", "find_power",
                              dict(sample_size=300, correction="bonferroni", scenarios=True),
                              ("philox_fill", "glm_irls")),
    # README flow 3 (the random-intercept GLMM, kernel K7): its find_power as
    # written, a sample-size search, AGQ at 7 nodes, the FD Hessian Wald
    # covariance and its three scenarios
    "model_glmm_power": ("glmm", "find_power", dict(sample_size=480),
                         ("philox_fill", "glmm_intercept")),
    "model_glmm_sample_size": ("glmm", "find_sample_size", dict(from_size=240, to_size=720),
                               ("philox_fill", "glmm_intercept")),
    "model_glmm_agq": ("glmm", "find_power", dict(sample_size=480, agq=7),
                       ("philox_fill", "glmm_intercept")),
    "model_glmm_hessian": ("glmm", "find_power", dict(sample_size=480, wald_se="hessian"),
                           ("philox_fill", "glmm_intercept")),
    "model_glmm_scenarios": ("glmm", "find_power", dict(sample_size=480, scenarios=True),
                             ("philox_fill", "glmm_intercept")),
    # README flow 2 (random slopes, K2's slope mode and kernel K9): its
    # find_power as written, a sample-size search on the 30-site atom and
    # its three scenarios
    "model_lmm_slopes_power": ("lmm_slopes", "find_power", dict(sample_size=600),
                               ("philox_fill", "grid_suffstats", "slope_reml")),
    "model_lmm_slopes_sample_size": ("lmm_slopes", "find_sample_size",
                                     dict(from_size=300, to_size=900),
                                     ("philox_fill", "grid_suffstats", "slope_reml")),
    "model_lmm_slopes_scenarios": ("lmm_slopes", "find_power",
                                   dict(sample_size=600, scenarios=True),
                                   ("philox_fill", "grid_suffstats", "slope_reml")),
    # the GLMM with random slopes (kernel K10): README flow 3's calls on the
    # model with a slope on dose
    "model_glmm_slopes_power": ("glmm_slopes", "find_power", dict(sample_size=480),
                                ("philox_fill", "glmm_slope")),
    "model_glmm_slopes_sample_size": ("glmm_slopes", "find_sample_size",
                                      dict(from_size=240, to_size=720),
                                      ("philox_fill", "glmm_slope")),
    "model_glmm_slopes_scenarios": ("glmm_slopes", "find_power",
                                    dict(sample_size=480, scenarios=True),
                                    ("philox_fill", "glmm_slope")),
    # the LMM with extra groupings (K2's joint mode and kernel K11): example
    # 13's crossed design (find_power as written, a sample-size search on its
    # 1,000-row atom, 40 subjects x 25 items, whose grid from 500 to 1,500
    # by 100 holds one feasible point, so 1,000 to 3,000; its three
    # scenarios), example 15's nested design and the dense capacitance of a
    # slope beside a crossed grouping
    "model_crossed_power": ("crossed", "find_power", dict(sample_size=1000),
                            ("philox_fill", "grid_suffstats", "joint_reml")),
    "model_crossed_sample_size": ("crossed", "find_sample_size",
                                  dict(from_size=1000, to_size=3000),
                                  ("philox_fill", "grid_suffstats", "joint_reml")),
    "model_crossed_scenarios": ("crossed", "find_power", dict(sample_size=1000, scenarios=True),
                                ("philox_fill", "grid_suffstats", "joint_reml")),
    "model_nested_power": ("nested", "find_power", dict(sample_size=720),
                           ("philox_fill", "grid_suffstats", "joint_reml")),
    "model_dense_extras_power": ("dense_extras", "find_power", dict(sample_size=600),
                                 ("philox_fill", "grid_suffstats", "joint_reml")),
    # the GLMM with extra groupings (kernel K12): README flow 3's calls on the
    # crossed model (find_power, a sample-size search on its 240-row atom:
    # 24 clinics x 10 raters, and its three scenarios), and find_power on the
    # nested and the dense models
    "model_glmm_crossed_power": ("glmm_crossed", "find_power", dict(sample_size=480),
                                 ("philox_fill", "glmm_extras")),
    "model_glmm_crossed_sample_size": ("glmm_crossed", "find_sample_size",
                                       dict(from_size=240, to_size=720),
                                       ("philox_fill", "glmm_extras")),
    "model_glmm_crossed_scenarios": ("glmm_crossed", "find_power",
                                     dict(sample_size=480, scenarios=True),
                                     ("philox_fill", "glmm_extras")),
    "model_glmm_nested_power": ("glmm_nested", "find_power", dict(sample_size=480),
                                ("philox_fill", "glmm_extras")),
    "model_glmm_dense_extras_power": ("glmm_dense_extras", "find_power", dict(sample_size=480),
                                      ("philox_fill", "glmm_extras")),
}


# The flows of the random-slope LMM, whose pin counts hold to SLOPE_PIN_FLIPS,
# and of the GLMM with random slopes (SLOPE_GLMM_PIN_FLIPS).
SLOPE_FLOWS = tuple(name for name, flow in MODEL_FLOWS.items() if flow[0] == "lmm_slopes")
SLOPE_GLMM_FLOWS = tuple(name for name, flow in MODEL_FLOWS.items() if flow[0] == "glmm_slopes")
# The flows of the LMM with extra groupings (EXTRAS_PIN_FLIPS, EXTRAS_TAU2_REL).
EXTRAS_FLOWS = tuple(name for name, flow in MODEL_FLOWS.items()
                     if flow[0] in ("crossed", "nested", "dense_extras"))
# The flows of the GLMM with extra groupings (GLMM_EXTRAS_PIN_FLIPS,
# GLMM_EXTRAS_COUNT_FLIPS, GLMM_EXTRAS_TAU2_REL).
GLMM_EXTRAS_FLOWS = tuple(name for name, flow in MODEL_FLOWS.items()
                          if flow[0] in ("glmm_crossed", "glmm_nested", "glmm_dense_extras"))
PLAIN_ON_CARD_FLOWS = SLOPE_GLMM_FLOWS + EXTRAS_FLOWS + GLMM_EXTRAS_FLOWS


def build_model(mcpower_cls, model: str):
    """``MODELS[model]`` as an instance of ``mcpower_cls`` (either package's
    ``MCPower``)."""
    c = MODELS[model]
    m = mcpower_cls(c["formula"], family=c["family"])
    if c["cluster"]:
        m.set_cluster(c.get("cluster_name", "cluster"), **c["cluster"])
    for name, kw in c.get("clusters", ()):  # one call per grouping
        m.set_cluster(name, **kw)
    if c["types"]:
        m.set_variable_type(c["types"])
    if c["corr"]:
        m.set_correlations(c["corr"])
    if "baseline_probability" in c:
        m.set_baseline_probability(c["baseline_probability"])
    if "baseline_rate" in c:
        m.set_baseline_rate(c["baseline_rate"])
    m.set_effects(c["effects"])
    return m


def run_flow(mcpower_cls, name: str, n_sims: int, **kw):
    """One call of flow ``name`` at ``n_sims`` sims, base seed SEED; ``kw``
    goes to the call (the port's ``device=``) and overrides the flow's own
    arguments (``scenarios=`` a list of labels)."""
    model, method, args, _ = MODEL_FLOWS[name]
    return getattr(build_model(mcpower_cls, model), method)(
        **{**args, **kw}, n_sims=n_sims, seed=SEED, verbose=False)


def flow_summary(res) -> Dict:
    """The golden values of a flow's result: significant counts per test
    (uncorrected and corrected), joint, overall, posthoc and factor
    exclusion counts and the separation fallback's count per N (where the
    design has them), the mean tau^2 estimate of an LMM or a GLMM, a GLMM's
    boundary counts, and for a
    sample-size search the first N reaching the target and the fitted
    crossing per test; of a run of several scenarios, these per scenario."""
    if "scenarios" in res:
        return {label: flow_summary(r) for label, r in res["scenarios"].items()}
    out = {k: res[k] for k in ("success_counts_uncorrected", "success_counts_corrected",
                               "joint_counts_uncorrected", "joint_counts_corrected",
                               "overall_counts", "posthoc_counts", "factor_exclusion_counts")
           if k in res}
    glm = res.get("estimator_extras", {}).get("glm", {})
    if "separation_fallback_rate" in glm:
        out["separation_fallback_counts"] = [int(round(r * res["n_sims"]))
                                             for r in glm["separation_fallback_rate"]]
    mle = res.get("estimator_extras", {}).get("mle", {})
    for extras in (mle, glm):  # the LMM's, or a GLMM's
        if "tau_squared_hat_mean" in extras:
            out["tau_squared_hat_mean"] = extras["tau_squared_hat_mean"]
    if "boundary_component_counts" in glm:
        out["boundary_component_counts"] = glm["boundary_component_counts"]
    if len(mle.get("boundary_component_counts", [[0]])[0]) > 1:  # per component, with slopes
        out["boundary_component_counts"] = mle["boundary_component_counts"]
    if "first_achieved" in res:
        out["first_achieved"] = res["first_achieved"]
        out["fitted"] = {k: v["n_star"] for k, v in res["fitted"].items()}
    return out


def tree_keys(tree, prefix: str = "") -> set:
    """Every key path of a nested result dict, as ``a.b.c`` strings."""
    out = set()
    for k, v in tree.items():
        out.add(prefix + str(k))
        if isinstance(v, dict):
            out |= tree_keys(v, f"{prefix}{k}.")
    return out


def _leaves(v, keys=()):
    """``(dict keys on the path, value)`` of every leaf, in key order; list
    items are leaves of their list's key."""
    if isinstance(v, dict):
        return [leaf for k, x in sorted(v.items(), key=lambda kv: str(kv[0]))
                for leaf in _leaves(x, keys + (str(k),))]
    if isinstance(v, (list, tuple)):
        return [leaf for x in v for leaf in _leaves(x, keys)]
    return [(keys, v)]


# Result-tree keys holding counts, and those holding fitted variance
# estimates (every other number is a function of the counts).
_COUNT_KEY = re.compile(r"count|histogram|boundary_hits$|^n_sims$")
_FIT_KEYS = ("tau_estimate", "tau_squared_hat_mean")
# Counts of fits with a variance component pinned at 0.
_PIN_KEYS = ("boundary_component_counts", "boundary_hits")
# The realized outcome mean of a GLM: two runs can draw an outcome row apart
# (an f32 rounding at its threshold: the reference's FMA-contracted normals,
# or the card's and the CPU's libm under a scenario's extra draws), which
# moves it by 1 / (sims N) and may or may not flip a count.
_OUTCOME_MEAN_KEYS = ("baseline_prob_realized",)


def _row_step(tree: Dict, keys) -> float:
    """1 / (sims x smallest N) of the result holding the leaf at ``keys``:
    what one outcome row moves its realized mean by."""
    node, step = tree, None
    for k in keys:
        if isinstance(node, dict) and "n_sims" in node and "sample_sizes" in node:
            step = 1.0 / (node["n_sims"] * min(node["sample_sizes"]))
        node = node.get(k) if isinstance(node, dict) else None
    return step


def compare_trees(name: str, got: Dict, want: Dict, max_flips: int = None,
                  tau_rel: float = None, pin_flips: int = None) -> list:
    """Hold a whole result tree against another: the same keys at every
    level, every count within ``max_flips`` (MAX_FLIPS), the variance-pin
    counts (``_PIN_KEYS``) within ``pin_flips`` (``max_flips``), the fitted
    variance estimates within ``tau_rel`` (TAU2_REL) relative, a GLM's
    realized outcome mean within ``max_flips`` outcome rows, and, where every
    count is equal, every other value equal (numbers to 1e-9 relative):
    rates, intervals, first N and crossing fits are functions of the counts.
    Returns the flips found, as text."""
    max_flips = MAX_FLIPS if max_flips is None else max_flips
    tau_rel = TAU2_REL if tau_rel is None else tau_rel
    pin_flips = max_flips if pin_flips is None else pin_flips
    keys_g, keys_w = tree_keys(got), tree_keys(want)
    check(keys_g == keys_w, f"{name}: result keys differ: {sorted(keys_g ^ keys_w)}")
    leaves_g, leaves_w = _leaves(got), _leaves(want)
    check([k for k, _ in leaves_g] == [k for k, _ in leaves_w], f"{name}: result shapes differ")
    flips, derived = [], []
    for (keys, g), (_, w) in zip(leaves_g, leaves_w):
        path = ".".join(keys)
        if _COUNT_KEY.search(keys[-1]) and isinstance(w, (int, np.integer)):
            if g != w:
                flips.append(f"{path}: {g} vs {w}")
            band = pin_flips if keys[-1] in _PIN_KEYS else max_flips
            check(isinstance(g, (int, np.integer)) and abs(g - w) <= band,
                  f"{name} {path}: {g} vs {w}")
        elif keys[-1] in _FIT_KEYS:
            check(abs(g - w) <= tau_rel * abs(w), f"{name} {path}: {g} vs {w} (> {tau_rel} rel)")
        elif keys[-1] in _OUTCOME_MEAN_KEYS:
            step = _row_step(want, keys)
            check(g == w or (step is not None and abs(g - w) <= max_flips * step * (1 + 1e-9)),
                  f"{name} {path}: {g} vs {w}, more than {max_flips} outcome rows apart")
        else:
            derived.append((path, g, w))
    for path, g, w in derived if not flips else ():
        num = isinstance(w, (float, np.floating)) and not isinstance(w, bool)
        same = (isinstance(g, (int, float, np.number))
                and (abs(g - w) <= 1e-9 * abs(w) or (g != g and w != w)) if num else g == w)
        check(same, f"{name} {path}: {g!r} vs {w!r} with every count equal")
    return flips


@contextmanager
def stage_clock(model_mod, runner_mod, batch_mod):
    """Host time of the stages of ``MCPower`` calls made inside the block,
    by wrapping the functions that bound them: projection
    (``MCPower._project``), lowering (``contract_to_lowered``), the runner
    (``runner.find_power`` / ``find_sample_size``), ``run_batch`` inside the
    runner, and packaging (``MCPower._package``); also the chunks (calls of
    ``run_sims``), the K1 launches each chunk made (from the wrappers' own
    count, by the chunk's scenario label) and the lowered scenarios the
    runner was given. A stage
    entered inside another (packaging projects again for its warnings)
    counts to the outer one. ``clock.take()`` returns what was gathered since
    the last take and starts afresh."""
    from collections import defaultdict

    from mcpower_tpu_torch.engine import kernels

    state = {"depth": 0}

    class Clock:
        def __init__(self):
            self.ms, self.chunks, self.lowered = defaultdict(float), 0, []
            self.k1_by_chunk = defaultdict(list)

        def take(self):
            got = dict(ms=dict(self.ms), chunks=self.chunks, lowered=self.lowered,
                       k1_by_chunk=dict(self.k1_by_chunk))
            self.__init__()
            return got

    clock = Clock()

    def timed(stage, fn, exclusive=True):
        def wrapper(*a, **k):
            outer = state["depth"] == 0 or not exclusive
            state["depth"] += exclusive
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                state["depth"] -= exclusive
                if outer:
                    clock.ms[stage] += (time.perf_counter() - t0) * 1e3
        return wrapper

    def runner_entry(fn):
        def wrapper(scenarios, **k):
            clock.lowered.extend((sc.spec, sc.arrays) for sc in scenarios)
            return fn(scenarios, **k)
        return timed("runner", wrapper)

    def counted(fn):
        def wrapper(spec, *a, **k):
            clock.chunks += 1
            before = kernels.counts()["philox_fill"]
            try:
                return fn(spec, *a, **k)
            finally:
                clock.k1_by_chunk[spec.scenario.label].append(
                    kernels.counts()["philox_fill"] - before)
        return wrapper

    cls = model_mod.MCPower
    patches = [
        (cls, "_project", timed("projection", cls._project)),
        (model_mod, "contract_to_lowered", timed("lowering", model_mod.contract_to_lowered)),
        (runner_mod, "find_power", runner_entry(runner_mod.find_power)),
        (runner_mod, "find_sample_size", runner_entry(runner_mod.find_sample_size)),
        (cls, "_package", timed("packaging", cls._package)),
        (batch_mod, "run_batch", timed("run_batch", batch_mod.run_batch, exclusive=False)),
        (batch_mod, "run_sims", counted(batch_mod.run_sims)),
    ]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    try:
        for obj, attr, fn in patches:
            setattr(obj, attr, fn)
        yield clock
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)


# flow_summary of the JAX reference's MCPower (mcpower_tpu) at GOLDEN_SIMS
# sims; tests/test_torch_model*.py recompute them so they cannot go stale
# (the GLMM flows': tests/test_torch_model_glmm*.py).
# model_lmm_power lowers to DESIGNS["lmm_headline"], so its counts are that
# design's GOLDEN counts.
MODEL_GOLDEN = {
    "model_lmm_power": {
        "success_counts_uncorrected": [[994, 744]], "success_counts_corrected": [[994, 744]],
        "joint_counts_uncorrected": [719], "joint_counts_corrected": [719],
        "tau_squared_hat_mean": [0.24906913729523056],
    },
    "model_ols_power": {
        "success_counts_uncorrected": [[847, 412, 816, 169]],
        "success_counts_corrected": [[707, 266, 656, 91]],
        "joint_counts_uncorrected": [25], "joint_counts_corrected": [14],
        "overall_counts": [1024],
    },
    "model_ols_sample_size": {
        "success_counts_uncorrected": [
            [295, 122, 245, 69], [489, 200, 460, 96], [658, 274, 596, 119], [772, 330, 749, 157],
            [867, 437, 841, 180], [927, 476, 907, 220], [959, 546, 960, 240], [988, 590, 981, 263],
            [1006, 632, 992, 302], [1011, 696, 1006, 332], [1015, 734, 1010, 357],
            [1022, 780, 1016, 368],
        ],
        "success_counts_corrected": [
            [295, 122, 245, 69], [489, 200, 460, 96], [658, 274, 596, 119], [772, 330, 749, 157],
            [867, 437, 841, 180], [927, 476, 907, 220], [959, 546, 960, 240], [988, 590, 981, 263],
            [1006, 632, 992, 302], [1011, 696, 1006, 332], [1015, 734, 1010, 357],
            [1022, 780, 1016, 368],
        ],
        "joint_counts_uncorrected": [0, 0, 1, 15, 28, 65, 93, 123, 169, 212, 242, 272],
        "joint_counts_corrected": [0, 0, 1, 15, 28, 65, 93, 123, 169, 212, 242, 272],
        "overall_counts": [712, 978, 1017, 1023, 1024, 1024, 1024, 1024, 1024, 1024, 1024, 1024],
        "first_achieved": {"x1": 214, "x2": None, "x3": 214, "x1:x2": None},
        "fitted": {"x1": 193.3705263157895, "x2": None, "x3": 204.28478260869568, "x1:x2": None},
    },
    "model_lmm_sample_size": {
        "success_counts_uncorrected": [
            [799, 434], [863, 512], [919, 572], [963, 640], [975, 685], [994, 744], [1009, 789],
            [1016, 821], [1019, 873], [1019, 890], [1020, 911], [1023, 934], [1022, 942],
            [1024, 955], [1024, 970], [1024, 974],
        ],
        "success_counts_corrected": [
            [799, 434], [863, 512], [919, 572], [963, 640], [975, 685], [994, 744], [1009, 789],
            [1016, 821], [1019, 873], [1019, 890], [1020, 911], [1023, 934], [1022, 942],
            [1024, 955], [1024, 970], [1024, 974],
        ],
        "joint_counts_uncorrected": [306, 399, 493, 588, 643, 719, 775, 814, 868, 885, 907, 933,
                                     940, 955, 970, 974],
        "joint_counts_corrected": [306, 399, 493, 588, 643, 719, 775, 814, 868, 885, 907, 933,
                                   940, 955, 970, 974],
        "first_achieved": {"x1": 120, "x2": 240},
        "fitted": {"x1": 106.31250000000001, "x2": 238.87500000000003},
        "tau_squared_hat_mean": [
            0.24495677020025403, 0.2457569949777752, 0.24781109063310092, 0.24750927551378282,
            0.24880732038094378, 0.24906913738841152, 0.24959012015268045, 0.2510582054786648,
            0.251794966786533, 0.25144136200525086, 0.2517569541315118, 0.2514259410430032,
            0.25139522030105566, 0.2518699843864873, 0.2510143168313314, 0.25105132132420965,
        ],
    },
    "model_logit_power": {
        "success_counts_uncorrected": [[713, 381, 249]],
        "success_counts_corrected": [[551, 223, 131]],
        "joint_counts_uncorrected": [66], "joint_counts_corrected": [16],
        "overall_counts": [802],
    },
    "model_logit_sample_size": {
        "success_counts_uncorrected": [
            [286, 158, 116], [406, 196, 138], [513, 258, 174], [616, 314, 206], [689, 371, 240],
            [744, 403, 284], [792, 451, 296], [855, 498, 316], [885, 551, 355], [913, 597, 381],
            [949, 652, 431], [968, 675, 447], [970, 685, 452],
        ],
        "success_counts_corrected": [
            [286, 158, 116], [406, 196, 138], [513, 258, 174], [616, 314, 206], [689, 371, 240],
            [744, 403, 284], [792, 451, 296], [855, 498, 316], [885, 551, 355], [913, 597, 381],
            [949, 652, 431], [968, 675, 447], [970, 685, 452],
        ],
        "joint_counts_uncorrected": [4, 12, 21, 40, 65, 79, 104, 123, 168, 211, 258, 276, 278],
        "joint_counts_corrected": [4, 12, 21, 40, 65, 79, 104, 123, 168, 211, 258, 276, 278],
        "overall_counts": [342, 454, 584, 702, 780, 847, 888, 920, 962, 981, 1005, 1013, 1013],
        "first_achieved": {"x1": 415, "x2": None, "x3": None},
        "fitted": {"x1": 389.42857142857144, "x2": None, "x3": None},
    },
    "model_poisson_power": {
        "success_counts_uncorrected": [[962, 766]], "success_counts_corrected": [[962, 766]],
        "joint_counts_uncorrected": [728], "joint_counts_corrected": [728],
        "overall_counts": [1001],
    },
    "model_readme_ols_power": {
        "success_counts_uncorrected": [[838, 408, 665, 227, 165]],
        "success_counts_corrected": [[665, 215, 428, 113, 64]],
        "joint_counts_uncorrected": [3], "joint_counts_corrected": [0],
        "overall_counts": [1024], "factor_exclusion_counts": [[0]],
    },
    "model_readme_ols_sample_size": {
        "success_counts_uncorrected": [
            [291, 111, 206, 83, 66], [489, 194, 363, 146, 100], [653, 272, 494, 161, 119],
            [773, 319, 605, 194, 154], [865, 431, 700, 231, 183], [922, 477, 763, 262, 208],
            [959, 546, 840, 310, 245], [986, 598, 906, 345, 269], [1004, 641, 932, 374, 311],
            [1010, 688, 953, 408, 333], [1015, 735, 977, 434, 359], [1022, 781, 990, 483, 367],
        ],
        "success_counts_corrected": [
            [291, 111, 206, 83, 66], [489, 194, 363, 146, 100], [653, 272, 494, 161, 119],
            [773, 319, 605, 194, 154], [865, 431, 700, 231, 183], [922, 477, 763, 262, 208],
            [959, 546, 840, 310, 245], [986, 598, 906, 345, 269], [1004, 641, 932, 374, 311],
            [1010, 688, 953, 408, 333], [1015, 735, 977, 434, 359], [1022, 781, 990, 483, 367],
        ],
        "joint_counts_uncorrected": [0, 0, 1, 2, 4, 13, 30, 42, 63, 82, 94, 112],
        "joint_counts_corrected": [0, 0, 1, 2, 4, 13, 30, 42, 63, 82, 94, 112],
        "overall_counts": [642, 943, 1015, 1024, 1024, 1024, 1024, 1024, 1024, 1024, 1024, 1024],
        "factor_exclusion_counts": [[0]] * 12,
        "first_achieved": {"x1": 214, "x2": None, "group[2]": 296, "group[3]": None, "x1:x2": None},
        "fitted": {"x1": 193.58913043478262, "x2": None, "group[2]": 284.9246753246753,
                   "group[3]": None, "x1:x2": None},
    },
    "model_anova_tukey": {
        "success_counts_uncorrected": [[]], "success_counts_corrected": [[]],
        "posthoc_counts": [[73, 82, 249, 13, 35, 50]], "factor_exclusion_counts": [[0]],
    },
    "model_logit_factor_sample_size": {
        "success_counts_uncorrected": [
            [128, 0, 0], [195, 77, 64], [282, 95, 70], [337, 122, 96], [421, 130, 113],
            [473, 153, 110], [553, 161, 133], [585, 180, 138], [634, 186, 143],
        ],
        "success_counts_corrected": [
            [128, 0, 0], [195, 77, 64], [282, 95, 70], [337, 122, 96], [421, 130, 113],
            [473, 153, 110], [553, 161, 133], [585, 180, 138], [634, 186, 143],
        ],
        "joint_counts_uncorrected": [0, 0, 6, 6, 8, 12, 12, 20, 24],
        "joint_counts_corrected": [0, 0, 6, 6, 8, 12, 12, 20, 24],
        "overall_counts": [177, 170, 220, 301, 374, 436, 500, 560, 594],
        "factor_exclusion_counts": [[1024], [0], [0], [0], [0], [0], [0], [0], [0]],
        "separation_fallback_counts": [0, 227, 126, 61, 30, 20, 11, 6, 2],
        "first_achieved": {"x1": None, "group[2]": None, "group[3]": None},
        "fitted": {"x1": None, "group[2]": None, "group[3]": None},
    },
    # per scenario (optimistic, realistic, doomer) of scenarios=True
    "model_readme_ols_scenarios": {
        "optimistic": {
            "success_counts_uncorrected": [[291, 111, 206, 83, 66], [489, 194, 363, 146, 100],
                                           [653, 272, 494, 161, 119],
                                           [773, 319, 605, 194, 154],
                                           [865, 431, 700, 231, 183],
                                           [922, 477, 763, 262, 208],
                                           [959, 546, 840, 310, 245],
                                           [986, 598, 906, 345, 269],
                                           [1004, 641, 932, 374, 311],
                                           [1010, 688, 953, 408, 333],
                                           [1015, 735, 977, 434, 359],
                                           [1022, 781, 990, 483, 367]],
            "success_counts_corrected": [[291, 111, 206, 83, 66], [489, 194, 363, 146, 100],
                                         [653, 272, 494, 161, 119], [773, 319, 605, 194, 154],
                                         [865, 431, 700, 231, 183], [922, 477, 763, 262, 208],
                                         [959, 546, 840, 310, 245], [986, 598, 906, 345, 269],
                                         [1004, 641, 932, 374, 311],
                                         [1010, 688, 953, 408, 333],
                                         [1015, 735, 977, 434, 359],
                                         [1022, 781, 990, 483, 367]],
            "joint_counts_uncorrected": [0, 0, 1, 2, 4, 13, 30, 42, 63, 82, 94, 112],
            "joint_counts_corrected": [0, 0, 1, 2, 4, 13, 30, 42, 63, 82, 94, 112],
            "overall_counts": [642, 943, 1015, 1024, 1024, 1024, 1024, 1024, 1024, 1024, 1024,
                               1024],
            "factor_exclusion_counts": [[0], [0], [0], [0], [0], [0], [0], [0], [0], [0], [0],
                                        [0]],
            "first_achieved": {"x1": 214, "x2": None, "group[2]": 296, "group[3]": None,
                               "x1:x2": None},
            "fitted": {"x1": 193.58913043478262, "x2": None, "group[2]": 284.9246753246753,
                       "group[3]": None, "x1:x2": None},
        },
        "realistic": {
            "success_counts_uncorrected": [[288, 112, 203, 92, 77], [470, 200, 358, 126, 106],
                                           [619, 277, 462, 150, 124],
                                           [739, 339, 580, 216, 158],
                                           [827, 420, 661, 244, 191],
                                           [885, 479, 736, 275, 209],
                                           [925, 545, 811, 321, 231],
                                           [956, 586, 847, 350, 262],
                                           [969, 637, 878, 383, 305],
                                           [980, 684, 907, 412, 318],
                                           [988, 719, 931, 447, 337],
                                           [996, 757, 954, 486, 351]],
            "success_counts_corrected": [[288, 112, 203, 92, 77], [470, 200, 358, 126, 106],
                                         [619, 277, 462, 150, 124], [739, 339, 580, 216, 158],
                                         [827, 420, 661, 244, 191], [885, 479, 736, 275, 209],
                                         [925, 545, 811, 321, 231], [956, 586, 847, 350, 262],
                                         [969, 637, 878, 383, 305], [980, 684, 907, 412, 318],
                                         [988, 719, 931, 447, 337], [996, 757, 954, 486, 351]],
            "joint_counts_uncorrected": [0, 0, 1, 6, 6, 22, 31, 42, 60, 74, 90, 112],
            "joint_counts_corrected": [0, 0, 1, 6, 6, 22, 31, 42, 60, 74, 90, 112],
            "overall_counts": [641, 912, 991, 1015, 1021, 1023, 1023, 1024, 1024, 1024, 1024,
                               1024],
            "factor_exclusion_counts": [[0], [0], [0], [0], [0], [0], [0], [0], [0], [0], [0],
                                        [0]],
            "first_achieved": {"x1": 214, "x2": None, "group[2]": 337, "group[3]": None,
                               "x1:x2": None},
            "fitted": {"x1": 210.3659090909091, "x2": None, "group[2]": 305.33888888888896,
                       "group[3]": None, "x1:x2": None},
        },
        "doomer": {
            "success_counts_uncorrected": [[298, 130, 225, 91, 82], [438, 221, 372, 139, 130],
                                           [560, 302, 472, 169, 151],
                                           [653, 373, 572, 214, 187],
                                           [718, 430, 625, 252, 198],
                                           [773, 467, 685, 289, 217],
                                           [803, 525, 734, 335, 247],
                                           [825, 567, 776, 358, 277],
                                           [856, 604, 808, 396, 295],
                                           [870, 640, 846, 415, 323],
                                           [881, 660, 866, 445, 336],
                                           [899, 700, 875, 481, 359]],
            "success_counts_corrected": [[298, 130, 225, 91, 82], [438, 221, 372, 139, 130],
                                         [560, 302, 472, 169, 151], [653, 373, 572, 214, 187],
                                         [718, 430, 625, 252, 198], [773, 467, 685, 289, 217],
                                         [803, 525, 734, 335, 247], [825, 567, 776, 358, 277],
                                         [856, 604, 808, 396, 295], [870, 640, 846, 415, 323],
                                         [881, 660, 866, 445, 336], [899, 700, 875, 481, 359]],
            "joint_counts_uncorrected": [0, 0, 2, 6, 10, 12, 18, 32, 54, 60, 72, 96],
            "joint_counts_corrected": [0, 0, 2, 6, 10, 12, 18, 32, 54, 60, 72, 96],
            "overall_counts": [636, 873, 954, 990, 1003, 1017, 1015, 1019, 1021, 1022, 1022,
                               1023],
            "factor_exclusion_counts": [[0], [0], [0], [0], [0], [0], [0], [0], [0], [0], [0],
                                        [0]],
            "first_achieved": {"x1": 337, "x2": None, "group[2]": 419, "group[3]": None,
                               "x1:x2": None},
            "fitted": {"x1": 326.1909090909092, "x2": None, "group[2]": 390.0842105263158,
                       "group[3]": None, "x1:x2": None},
        },
    },
    "model_lmm_scenarios": {
        "optimistic": {
            "success_counts_uncorrected": [[994, 744]],
            "success_counts_corrected": [[994, 744]],
            "joint_counts_uncorrected": [719],
            "joint_counts_corrected": [719],
            "tau_squared_hat_mean": [0.24906913729523056],
        },
        "realistic": {
            "success_counts_uncorrected": [[960, 718]],
            "success_counts_corrected": [[960, 718]],
            "joint_counts_uncorrected": [664],
            "joint_counts_corrected": [664],
            "tau_squared_hat_mean": [0.2594011416867773],
        },
        "doomer": {
            "success_counts_uncorrected": [[852, 670]],
            "success_counts_corrected": [[852, 670]],
            "joint_counts_uncorrected": [545],
            "joint_counts_corrected": [545],
            "tau_squared_hat_mean": [0.2996262323525873],
        },
    },
    "model_logit_scenarios": {
        "optimistic": {
            "success_counts_uncorrected": [[713, 381, 249]],
            "success_counts_corrected": [[551, 223, 131]],
            "joint_counts_uncorrected": [66],
            "joint_counts_corrected": [16],
            "overall_counts": [802],
        },
        "realistic": {
            "success_counts_uncorrected": [[666, 364, 254]],
            "success_counts_corrected": [[513, 226, 136]],
            "joint_counts_uncorrected": [62],
            "joint_counts_corrected": [16],
            "overall_counts": [781],
        },
        "doomer": {
            "success_counts_uncorrected": [[589, 345, 248]],
            "success_counts_corrected": [[440, 214, 129]],
            "joint_counts_uncorrected": [52],
            "joint_counts_corrected": [12],
            "overall_counts": [780],
        },
    },
    "model_glmm_power": {
        "success_counts_uncorrected": [[938]],
        "success_counts_corrected": [[938]],
        "joint_counts_uncorrected": [938],
        "joint_counts_corrected": [938],
        "tau_squared_hat_mean": [0.5530672534266242],
        "boundary_component_counts": [[2]],
    },
    "model_glmm_sample_size": {
        "success_counts_uncorrected": [[640], [724], [799], [864], [899], [938], [961], [980], [1000], [1006], [1016]],
        "success_counts_corrected": [[640], [724], [799], [864], [899], [938], [961], [980], [1000], [1006], [1016]],
        "joint_counts_uncorrected": [640, 724, 799, 864, 899, 938, 961, 980, 1000, 1006, 1016],
        "joint_counts_corrected": [640, 724, 799, 864, 899, 938, 961, 980, 1000, 1006, 1016],
        "tau_squared_hat_mean": [0.5487463975068307, 0.5514313323851757, 0.5509628342639047, 0.5546585087309146, 0.5546549430609116, 0.5530605876954059, 0.5503367954755797, 0.5496896525803292, 0.5496802001615022, 0.5517262384267957, 0.553944516568886],
        "boundary_component_counts": [[11], [6], [4], [2], [2], [2], [0], [0], [0], [0], [0]],
        "first_achieved": {
            "dose": 384,
        },
        "fitted": {
            "dose": 350.9169230769231,
        },
    },
    "model_glmm_agq": {
        "success_counts_uncorrected": [[938]],
        "success_counts_corrected": [[938]],
        "joint_counts_uncorrected": [938],
        "joint_counts_corrected": [938],
        "tau_squared_hat_mean": [0.565170302335327],
        "boundary_component_counts": [[2]],
    },
    "model_glmm_hessian": {
        "success_counts_uncorrected": [[928]],
        "success_counts_corrected": [[928]],
        "joint_counts_uncorrected": [928],
        "joint_counts_corrected": [928],
        "tau_squared_hat_mean": [0.5530672534266242],
        "boundary_component_counts": [[2]],
    },
    "model_lmm_slopes_power": {
        "success_counts_uncorrected": [[1024]], "success_counts_corrected": [[1024]],
        "joint_counts_uncorrected": [1024], "joint_counts_corrected": [1024],
        "tau_squared_hat_mean": [0.2523556028895634], "boundary_component_counts": [[0, 2]],
    },
    "model_lmm_slopes_sample_size": {
        "success_counts_uncorrected": [[1019], [1020], [1020], [1023], [1024], [1024], [1024],
                                       [1024], [1024], [1024], [1024]],
        "success_counts_corrected": [[1019], [1020], [1020], [1023], [1024], [1024], [1024],
                                     [1024], [1024], [1024], [1024]],
        "joint_counts_uncorrected": [1019, 1020, 1020, 1023, 1024, 1024, 1024, 1024, 1024, 1024,
                                     1024],
        "joint_counts_corrected": [1019, 1020, 1020, 1023, 1024, 1024, 1024, 1024, 1024, 1024,
                                   1024],
        "tau_squared_hat_mean": [0.2518635298986708, 0.2509472030857206, 0.2504877887811412,
                                 0.25080902093891705, 0.252254089666787, 0.25235560288956393,
                                 0.2519468578978486, 0.2520433012012934, 0.2517103062425074,
                                 0.2514945541950263, 0.2514446552990315],
        "boundary_component_counts": [[0, 47], [0, 20], [0, 12], [0, 7], [0, 3], [0, 2], [0, 1],
                                      [0, 0], [0, 0], [0, 0], [0, 0]],
        "first_achieved": {"treatment": 300},
        "fitted": {"treatment": None},
    },
    "model_lmm_slopes_scenarios": {
        "optimistic": {
            "success_counts_uncorrected": [[1024]], "success_counts_corrected": [[1024]],
            "joint_counts_uncorrected": [1024], "joint_counts_corrected": [1024],
            "tau_squared_hat_mean": [0.2523556028895634], "boundary_component_counts": [[0, 2]],
        },
        "realistic": {
            "success_counts_uncorrected": [[1018]], "success_counts_corrected": [[1018]],
            "joint_counts_uncorrected": [1018], "joint_counts_corrected": [1018],
            "tau_squared_hat_mean": [0.2588452392238622], "boundary_component_counts": [[1, 18]],
        },
        "doomer": {
            "success_counts_uncorrected": [[952]], "success_counts_corrected": [[952]],
            "joint_counts_uncorrected": [952], "joint_counts_corrected": [952],
            "tau_squared_hat_mean": [0.29494549867546005], "boundary_component_counts": [[4, 90]],
        },
    },
    "model_glmm_slopes_power": {
        "success_counts_uncorrected": [[782]], "success_counts_corrected": [[782]],
        "joint_counts_uncorrected": [782], "joint_counts_corrected": [782],
        "tau_squared_hat_mean": [0.559952616677734], "boundary_component_counts": [[0, 363]],
    },
    "model_glmm_slopes_sample_size": {
        "success_counts_uncorrected": [[516], [576], [640], [696], [749], [782], [810], [834],
                                       [866], [881], [899]],
        "success_counts_corrected": [[516], [576], [640], [696], [749], [782], [810], [834],
                                     [866], [881], [899]],
        "joint_counts_uncorrected": [516, 576, 640, 696, 749, 782, 810, 834, 866, 881, 899],
        "joint_counts_corrected": [516, 576, 640, 696, 749, 782, 810, 834, 866, 881, 899],
        "tau_squared_hat_mean": [0.5732999879342873, 0.5658262881240945, 0.5642013132934088,
                                 0.5655438595486562, 0.5625399726778809, 0.5599133839275324,
                                 0.5569763577016574, 0.5560715086171364, 0.555251167651051,
                                 0.5563611560277106, 0.5579893696453955],
        "boundary_component_counts": [[6, 625], [4, 572], [1, 489], [3, 462], [3, 409], [0, 363],
                                      [0, 342], [0, 306], [0, 275], [0, 246], [0, 226]],
        "first_achieved": {"dose": 576},
        "fitted": {"dose": 546.4000000000001},
    },
    "model_glmm_slopes_scenarios": {
        "optimistic": {
            "success_counts_uncorrected": [[782]], "success_counts_corrected": [[782]],
            "joint_counts_uncorrected": [782], "joint_counts_corrected": [782],
            "tau_squared_hat_mean": [0.559952616677734], "boundary_component_counts": [[0, 363]],
        },
        "realistic": {
            "success_counts_uncorrected": [[748]], "success_counts_corrected": [[748]],
            "joint_counts_uncorrected": [748], "joint_counts_corrected": [748],
            "tau_squared_hat_mean": [0.5412062582567907], "boundary_component_counts": [[1, 405]],
        },
        "doomer": {
            "success_counts_uncorrected": [[691]], "success_counts_corrected": [[691]],
            "joint_counts_uncorrected": [691], "joint_counts_corrected": [691],
            "tau_squared_hat_mean": [0.5115693675545984], "boundary_component_counts": [[14, 452]],
        },
    },
    "model_glmm_scenarios": {
        "optimistic": {
            "success_counts_uncorrected": [[938]],
            "success_counts_corrected": [[938]],
            "joint_counts_uncorrected": [938],
            "joint_counts_corrected": [938],
            "tau_squared_hat_mean": [0.5530672534266242],
            "boundary_component_counts": [[2]],
        },
        "realistic": {
            "success_counts_uncorrected": [[877]],
            "success_counts_corrected": [[877]],
            "joint_counts_uncorrected": [877],
            "joint_counts_corrected": [877],
            "tau_squared_hat_mean": [0.531850240753931],
            "boundary_component_counts": [[6]],
        },
        "doomer": {
            "success_counts_uncorrected": [[780]],
            "success_counts_corrected": [[780]],
            "joint_counts_uncorrected": [780],
            "joint_counts_corrected": [780],
            "tau_squared_hat_mean": [0.5029337071289814],
            "boundary_component_counts": [[43]],
        },
    },
    # the extras flows: the JAX reference's MCPower on the CPU at GOLDEN_SIMS
    "model_crossed_power": {
        "success_counts_uncorrected": [[1024, 1024]],
        "success_counts_corrected": [[1024, 1024]],
        "joint_counts_uncorrected": [1024],
        "joint_counts_corrected": [1024],
        "tau_squared_hat_mean": [0.25126564627995057],
        "boundary_component_counts": [[0, 0]],
    },
    "model_crossed_sample_size": {
        "success_counts_uncorrected": [[1024, 1024], [1024, 1024], [1024, 1024]],
        "success_counts_corrected": [[1024, 1024], [1024, 1024], [1024, 1024]],
        "joint_counts_uncorrected": [1024, 1024, 1024],
        "joint_counts_corrected": [1024, 1024, 1024],
        "tau_squared_hat_mean": [0.2512743486117039, 0.2505607831543924, 0.25071274608903527],
        "boundary_component_counts": [[0, 0], [0, 0], [0, 0]],
        "first_achieved": {"frequency": 1000, "length": 1000},
        "fitted": {"frequency": None, "length": None},
    },
    "model_crossed_scenarios": {
        "optimistic": {
            "success_counts_uncorrected": [[1024, 1024]],
            "success_counts_corrected": [[1024, 1024]],
            "joint_counts_uncorrected": [1024],
            "joint_counts_corrected": [1024],
            "tau_squared_hat_mean": [0.25126564627995057],
            "boundary_component_counts": [[0, 0]],
        },
        "realistic": {
            "success_counts_uncorrected": [[1024, 1020]],
            "success_counts_corrected": [[1024, 1020]],
            "joint_counts_uncorrected": [1020],
            "joint_counts_corrected": [1020],
            "tau_squared_hat_mean": [0.2560146367399002],
            "boundary_component_counts": [[33, 139]],
        },
        "doomer": {
            "success_counts_uncorrected": [[998, 961]],
            "success_counts_corrected": [[998, 961]],
            "joint_counts_uncorrected": [939],
            "joint_counts_corrected": [939],
            "tau_squared_hat_mean": [0.286205609435525],
            "boundary_component_counts": [[148, 212]],
        },
    },
    "model_nested_power": {
        "success_counts_uncorrected": [[1021]],
        "success_counts_corrected": [[1021]],
        "joint_counts_uncorrected": [1021],
        "joint_counts_corrected": [1021],
        "tau_squared_hat_mean": [0.0863962356021785],
        "boundary_component_counts": [[50, 0]],
    },
    "model_dense_extras_power": {
        "success_counts_uncorrected": [[1024]],
        "success_counts_corrected": [[1024]],
        "joint_counts_uncorrected": [1024],
        "joint_counts_corrected": [1024],
        "tau_squared_hat_mean": [0.2523622606826891],
        "boundary_component_counts": [[0, 0, 2]],
    },
    # the GLMM extras flows: the JAX reference's MCPower on the CPU at GOLDEN_SIMS
    # (golden_values.py)
    "model_glmm_crossed_power": {
        "success_counts_uncorrected": [[908]],
        "success_counts_corrected": [[908]],
        "joint_counts_uncorrected": [908],
        "joint_counts_corrected": [908],
        "tau_squared_hat_mean": [0.5601237306309677],
        "boundary_component_counts": [[1, 23]],
    },
    "model_glmm_crossed_sample_size": {
        "success_counts_uncorrected": [[587], [908], [1005]],
        "success_counts_corrected": [[587], [908], [1005]],
        "joint_counts_uncorrected": [587, 908, 1005],
        "joint_counts_corrected": [587, 908, 1005],
        "tau_squared_hat_mean": [0.5518167006634372, 0.5601095570517607, 0.5646604294342578],
        "boundary_component_counts": [[17, 66], [1, 21], [0, 9]],
        "first_achieved": {"dose": 480},
        "fitted": {"dose": 413.6074766355141},
    },
    "model_glmm_crossed_scenarios": {
        "optimistic": {
            "success_counts_uncorrected": [[908]],
            "success_counts_corrected": [[908]],
            "joint_counts_uncorrected": [908],
            "joint_counts_corrected": [908],
            "tau_squared_hat_mean": [0.5601237306309677],
            "boundary_component_counts": [[1, 23]],
        },
        "realistic": {
            "success_counts_uncorrected": [[866]],
            "success_counts_corrected": [[866]],
            "joint_counts_uncorrected": [866],
            "joint_counts_corrected": [866],
            "tau_squared_hat_mean": [0.5445691578565689],
            "boundary_component_counts": [[2, 49]],
        },
        "doomer": {
            "success_counts_uncorrected": [[777]],
            "success_counts_corrected": [[777]],
            "joint_counts_uncorrected": [777],
            "joint_counts_corrected": [777],
            "tau_squared_hat_mean": [0.5200522800749091],
            "boundary_component_counts": [[38, 128]],
        },
    },
    "model_glmm_nested_power": {
        "success_counts_uncorrected": [[897]],
        "success_counts_corrected": [[897]],
        "joint_counts_uncorrected": [897],
        "joint_counts_corrected": [897],
        "tau_squared_hat_mean": [0.5413829850798161],
        "boundary_component_counts": [[28, 46]],
    },
    "model_glmm_dense_extras_power": {
        "success_counts_uncorrected": [[745]],
        "success_counts_corrected": [[745]],
        "joint_counts_uncorrected": [745],
        "joint_counts_corrected": [745],
        "tau_squared_hat_mean": [0.5679644442173022],
        "boundary_component_counts": [[0, 74, 3]],
    },
}

# The f32 generation path's log may differ by an ULP between XLA:CPU and
# CUDA, which can move a statistic sitting on its threshold: allow one flip
# per count entry, and this relative band on the tau^2 sum.
MAX_FLIPS = 1
TAU2_REL = 2e-3
# The GLMM's tau^2 sum (the arms' and the flows'). Its Brent search (the
# reference's) re-fits the same parabola after a parabolic step it rejected,
# and the safeguard p < q (b - x) then compares two roundings of one number:
# a cell whose f32 deviances differ from the reference's in the 7th digit
# may take the other branch there, and the two branches can end at optima
# far apart (a glmm_laplace cell: tau^2 0.175 in the reference, 0.360 in
# the port, whose objective is 0.56 higher there). 3 such cells of 1,024
# moved the glmm_laplace sum by 2.2e-3 on the H100 (1.4e-3 on the CPU).
GLMM_TAU2_REL = 5e-3
# The random-slope LMM's pin counts (per component, and any component). A
# pin is decided by f64 probes at the f32 search's optimum; where a
# component's variance is truly near 0 (a null slope, the doomer scenario's
# ICC noise driving tau^2 to 0) the deviance is flat along it, two f32
# searches whose sums round differently stop at different points of that
# flat, and the probe's 1e-10 margin can fall either way. Measured on the
# CPU, the port's plain path against the JAX reference at 1,024 sims
# (tests/test_torch_model_slopes*.py): at most 3 per entry (the doomer
# scenario's intercept pins, 1 against 4), 1 at the power and sample-size
# flows and 0 at the lmm_slopes arm. Twice that is the band, for the golden
# values and for the card's tree against the CPU's. A standing record in
# ROADMAP C.
SLOPE_PIN_FLIPS = 6
# The GLMM with random slopes (K10): its search ranks on f32 Laplace
# deviances, as the slope LMM's does, so its pins (per component, any
# component) and its tau^2 sums carry the same kind of difference from the
# reference. Measured on the CPU before any card run, the port's plain path
# against the JAX reference at 1,024 sims (the glmm_slopes arm and the
# three slope-GLMM flows): pin counts at most 2 apart (the arm's boundary
# hits, 587 against 585; the doomer scenario's slope pins, 454 against
# 452; one point of the sample-size flow, 277 against 275), every other
# count at most 1 (the realistic and doomer scenarios' significant counts),
# the mean tau^2 at most 2.2e-4 relative (the doomer scenario). The bands:
# the slope LMM's pin band (6: the same mechanism, three times the
# measured 2) and 1e-3 for tau^2 (~4.6x the measured; TAU2_REL is 12x its
# measured 1.7e-4); counts keep MAX_FLIPS. A standing record in ROADMAP C;
# frozen before the first card run.
SLOPE_GLMM_PIN_FLIPS = 6
SLOPE_GLMM_TAU2_REL = 1e-3
# The LMM with extra groupings (K11): its Nelder-Mead ranks on f32
# deviances of the joint capacitance, as the slope LMM's does, so most cells
# stop at another simplex point than the reference's, and its pins (a
# Cholesky diagonal below 1e-4 at the optimum), its significance counts
# where a cell sits near its threshold, and its tau^2 sums carry the
# difference. Measured on the CPU before any card run of the goldens, the
# port's plain path against the JAX reference at 1,024 sims (the two extras
# arms and the five extras flows): pin counts at most 7 apart (the crossed
# doomer scenario's item pins, 205 against 212, where ICC noise drives an
# item variance to 0 and the searches stop on either side of the 1e-4 pin
# on a flat deviance; 3 in the realistic one, at most 2 elsewhere),
# significance counts at most 2 (the dense arm's x1, 664 against 666; its
# joint and histogram counts 1), the mean tau^2 at most 4.0e-4 relative
# (model_nested_power). The bands: twice the measured for pins and counts
# (EXTRAS_PIN_FLIPS 14, EXTRAS_COUNT_FLIPS 4; MAX_FLIPS elsewhere), and
# TAU2_REL's 2e-3 for tau^2 (5x the measured). A standing record in ROADMAP
# C; frozen before the first card run of the goldens.
EXTRAS_PIN_FLIPS = 14
EXTRAS_COUNT_FLIPS = 4
EXTRAS_TAU2_REL = 2e-3
# The structured arm forced through the dense capacitance (phase 3). The two
# forms agree to rounding at one theta (measured on the CPU: the f64
# deviance to 2.1e-16 relative; on the H100: beta 1.5e-14, tau^2 6e-16),
# but each search ranks its own f32 roundings, so the two searches stop
# apart (measured: theta up to 1.8e-3 on the CPU, 2.1e-3 on the H100, pins
# equal): the fits at one theta within EXTRAS_AB_FIT_REL, the searches'
# theta within EXTRAS_AB_THETA, every pin equal.
EXTRAS_AB_FIT_REL = 1e-10
EXTRAS_AB_THETA = 1e-2
# The GLMM with extra groupings (K12): its Nelder-Mead ranks on f32 Laplace
# deviances from f32 PIRLS modes, as the slope GLMM's does, and a component
# pins where its Cholesky diagonal ends below 1e-3, so where a variance is
# near 0 (many of the arms' crossed and nested components) two searches
# whose sums round differently stop on either side of the pin on a flat
# deviance. Measured on the CPU before any card run of the goldens, the
# port's plain path against the JAX reference at 1,024 sims (the two GLMM
# extras arms and the five flows, golden_values.py): pin counts at most 7
# apart (the glmm_extras arm's crossed-grouping pins, 293 against 286, and
# its boundary hits, 385 against 379; at most 4 in a flow, the sample-size
# flow's), significance counts at most 2 (the dense arm's histogram, 446
# against 448; its joint counts 1; 0 in every flow), the tau^2 sums at most
# 1.75e-4 relative (the sample-size flow). The bands: twice the measured for
# pins and counts, as the LMM extras' (GLMM_EXTRAS_PIN_FLIPS 14,
# GLMM_EXTRAS_COUNT_FLIPS 4), and TAU2_REL's 2e-3 for tau^2 (11x the
# measured). A standing record in ROADMAP C; frozen before the first card
# run of the goldens.
GLMM_EXTRAS_PIN_FLIPS = 14
GLMM_EXTRAS_COUNT_FLIPS = 4
GLMM_EXTRAS_TAU2_REL = 2e-3
# The structured arm forced through the dense capacitance (phase 3), at the
# structured fit's theta: the two forms agree to rounding (measured on the
# CPU: beta 1.5e-15 and cov 1.0e-15 relative, tau^2 equal, every flag equal,
# at 256 sims of glmm_extras).
GLMM_EXTRAS_AB_FIT_REL = 1e-10

# Kernel tolerances on the card, against the plain versions on the same
# inputs. Relative errors are max |kernel - plain| / max |plain| per output.
K2_REL = 1e-12  # f64 sums in another order
K2_JOINT_REL = 1e-13  # the joint mode's f64 sums, rows in order against scatter_add's
K3_REL = 1e-10  # f64 solve, same operation order except sums
K4_REL = 1e-7  # 20-step search whose last steps are decided by rounding
# The same IRLS steps in the same order and the same libdevice
# transcendentals: measured bit-identical (0) in beta, cov, dev, dev0 and
# ybar at every case on the H100; the band leaves room for another toolkit.
K6_REL = 1e-10
NORMAL_MAX_ULP = 0  # K1 and the plain fill share CUDA's logf: bit-identical
# glm_baseline sums the realized outcome means: one flipped row of a 300-row
# sim moves the 1,024-sim sum by about 1e-5 of itself.
GLM_BASELINE_REL = 2e-5

# H100 SXM peaks (NVIDIA's data sheet; the f64 and int32 rates are 132 SMs x
# 64 lanes x 1.98 GHz, one instruction per lane and clock).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_INSTR_PER_S = 132 * 64 * 1.98e9
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# Instruction counts of the f64 pieces that are not single instructions
# (CUDA's f64 division, square root, and log, log1p or exp), and per-item
# counts of K1 (Philox4x32-10: 10 rounds of 2 mul.hi, 2 mul.lo, 4 xor and 2
# key adds per 4 words; the Acklam ppf: a log, a sqrt and ~20 multiply-adds
# per normal). Estimates.
F64_DIV_INSTR = 10
F64_SQRT_INSTR = 10
F64_LOG_INSTR = 20
PHILOX_INT_OPS_PER_WORD = 25
PHILOX_INT_OPS_PER_CIPHER = 4 * PHILOX_INT_OPS_PER_WORD
PPF_F32_OPS_PER_NORMAL = 30
REML_EVALS = 24  # 1 + 20 Brent steps, the interior and gamma = 0 probes, the final fit
F32_EXP_OPS = 20  # an f32 exp or erf, and the link's few other operations, per row
F64_EXP_INSTR = 20  # CUDA's f64 exp or erf

KERNEL_META = {
    "philox_fill": ("mcpower_tpu_torch/csrc/philox_fill.cu", "benchmarks/pallas_datagen.py:78"),
    "grid_suffstats": ("mcpower_tpu_torch/csrc/grid_suffstats.cu", "mcpower_tpu/engine/olsfit.py:41"),
    "ols_solve": ("mcpower_tpu_torch/csrc/ols_solve.cu", "mcpower_tpu/engine/smallchol.py:34"),
    "reml_intercept": ("mcpower_tpu_torch/csrc/reml_intercept.cu", "mcpower_tpu/engine/mixedfit.py:846"),
    "glm_irls": ("mcpower_tpu_torch/csrc/glm_irls.cu", "mcpower_tpu/engine/glmfit.py:82"),
    "poisson_quantile": ("mcpower_tpu_torch/csrc/poisson_quantile.cu",
                         "mcpower_tpu/engine/datagen.py:217"),
    "glmm_intercept": ("mcpower_tpu_torch/csrc/glmm_intercept.cu",
                       "mcpower_tpu/engine/glmmfit.py:909"),
    "slope_reml": ("mcpower_tpu_torch/csrc/slope_reml.cu", "mcpower_tpu/engine/mixedfit.py:385"),
    "glmm_slope": ("mcpower_tpu_torch/csrc/glmm_slope.cu", "mcpower_tpu/engine/glmmfit.py:556"),
    "joint_reml": ("mcpower_tpu_torch/csrc/joint_reml.cu", "mcpower_tpu/engine/mixedfit.py:719"),
    "glmm_extras": ("mcpower_tpu_torch/csrc/glmm_extras.cu", "mcpower_tpu/engine/glmmfit.py:155"),
    # K2's joint mode, an entry of grid_suffstats.cu counted under its tag
    "grid_suffstats_joint": ("mcpower_tpu_torch/csrc/grid_suffstats.cu",
                             "mcpower_tpu/engine/mixedfit.py:570"),
}
# Kernels that the arms of DESIGNS launch; K8 draws count outcomes, which
# only the Poisson flow of phase 6 has.
ARM_KERNELS = ("philox_fill", "grid_suffstats", "ols_solve", "reml_intercept", "glm_irls")


def k1_launches_per_chunk(what: str, by_chunk: Dict[str, list], lowered, datagen_mod) -> Dict:
    """K1 launches a chunk by scenario label, as counted in each chunk
    (``stage_clock``'s ``k1_by_chunk``). Fails unless every scenario ran
    chunks and each of its chunks launched K1 as often as its fill plan says
    (``datagen.k1_launches``)."""
    want = {sp.scenario.label: datagen_mod.k1_launches(sp) for sp, _ in lowered}
    check(sorted(by_chunk) == sorted(want),
          f"{what}: K1 counted for scenarios {sorted(by_chunk)}, ran {sorted(want)}")
    for label, counts in by_chunk.items():
        check(counts and set(counts) == {want[label]},
              f"{what} {label}: K1 launches by chunk {counts}, {want[label]} a chunk planned")
    return {label: by_chunk[label][0] for label in want}


def lower_design(lower_mod, cluster_cls, name: str):
    """``lower_mod.lower`` on design ``name``; works for either package. A
    ``truth_start`` entry becomes the scenario's."""
    kw = dict({**DESIGNS, **SCENARIO_ARMS, **SCENARIO_DESIGNS, **LAYOUT_CHECKS, **K2_CHECKS,
               **FACTOR_DESIGNS, **K6_DESIGNS, **GLMM_DESIGNS, **K7_DESIGNS, **SLOPE_DESIGNS,
               **K9_DESIGNS, **SLOPE_GLMM_DESIGNS, **K10_DESIGNS, **EXTRAS_DESIGNS,
               **K11_DESIGNS, **GLMM_EXTRAS_DESIGNS, **K12_DESIGNS}[name])
    for key in ("corr", "effects"):
        if key in kw:
            kw[key] = np.asarray(kw[key], dtype=np.float64)
    if "cluster" in kw:
        cl = dict(kw["cluster"])
        mod = sys.modules[cluster_cls.__module__]  # the same package's SlopeStatic
        if "slopes" in cl:
            cl["slopes"] = tuple(mod.SlopeStatic(**sl) for sl in cl["slopes"])
        if "extra_groupings" in cl:
            cl["extra_groupings"] = tuple(
                mod.ExtraGroupingStatic(**dict(eg, slopes=tuple(
                    mod.SlopeStatic(**sl) for sl in eg.get("slopes", ()))))
                for eg in cl["extra_groupings"])
        kw["cluster"] = cluster_cls(**cl)
    if "truth_start" in kw:
        kw["scenario"] = lower_mod.ScenarioStatic(truth_start=kw.pop("truth_start"))
    elif "scenario" in kw:
        kw["scenario"] = lower_mod.ScenarioStatic(**kw["scenario"])
    return lower_mod.lower(**kw)


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def synthetic_reml_inputs(torch, cells: int, m: int, rows_per_cluster: int, seed: int, dev):
    """K4's inputs for ``cells`` random-intercept datasets of m round-robin
    clusters (p = 3, tau^2 = 0.25), made on the CPU from ``seed``: ``(n_j, s,
    t, xtx, xty, yty, ns)`` with one grid point."""
    g = torch.Generator().manual_seed(seed)
    n = m * rows_per_cluster
    X = torch.randn(cells, n, 3, generator=g, dtype=torch.float64)
    X[..., 0] = 1.0
    ids = torch.arange(n) % m
    u = 0.5 * torch.randn(cells, m, generator=g, dtype=torch.float64)
    y = X @ torch.tensor([0.0, 0.3, 0.2], dtype=torch.float64) + u[:, ids]
    y = y + torch.randn(cells, n, generator=g, dtype=torch.float64)
    onehot = torch.nn.functional.one_hot(ids, m).to(torch.float64)
    out = (
        onehot.sum(0).expand(cells, m).contiguous(),
        torch.einsum("nm,cnp->cmp", onehot, X),
        torch.einsum("nm,cn->cm", onehot, y),
        X.transpose(1, 2) @ X,
        torch.einsum("cnp,cn->cp", X, y),
        (y * y).sum(-1),
    )
    out = tuple(v[:, None].to(dev) for v in out)
    return out + (torch.tensor([float(n)], dtype=torch.float64, device=dev),)


def pin_margins(torch, mixedfit, args, cells) -> list:
    """dev_zero - dev_interior of the plain search at the given cells, to
    set beside the 1e-10 margin of the low pin when K4's flags differ."""
    n_j, s, t, xtx, xty, yty, ns = args
    p = xtx.shape[-1]
    pick = lambda v, k: v.reshape(-1, *v.shape[v.dim() - k:])[cells]  # noqa: E731
    nj_c, s_c, t_c, xtx_c, xty_c = pick(n_j, 1), pick(s, 2), pick(t, 1), pick(xtx, 2), pick(xty, 1)
    yty_c = yty.reshape(-1)[cells]
    n_c = ns.expand_as(yty).reshape(-1)[cells]

    def dev_at(lg):
        gamma = torch.exp(lg).to(yty_c.device).expand_as(yty_c)
        return mixedfit._reml_quantities(gamma, nj_c, s_c, t_c, xtx_c, xty_c, yty_c, n_c, p)[0]

    lg_hat, _, _ = mixedfit._brent_minimize(
        mixedfit.LOG_GAMMA_LO, mixedfit.LOG_GAMMA_HI, (),
        ((mixedfit.BRENT_ITERS, lambda lg, aux: (dev_at(lg), aux)),))
    zero = dev_at(torch.tensor(mixedfit.LOG_GAMMA_LO, dtype=torch.float64))
    return (zero - dev_at(lg_hat)).tolist()


def rel_err(a, b) -> float:
    a = a.double()
    b = b.double()
    scale = b.abs().max().item()
    return (a - b).abs().max().item() / (scale if scale > 0 else 1.0)


L2_BYTES = 50 * 2 ** 20  # H100 SXM
MAX_COPIES = 24


def input_copies(args) -> list:
    """``args`` and copies of it with its tensors cloned: enough copies
    (at most MAX_COPIES) that together they exceed twice the L2, so a call
    on the next copy finds its inputs in device memory, not in L2."""
    import torch

    size = nbytes(*(a for a in args if torch.is_tensor(a)))
    n = min(max(1, -(-2 * L2_BYTES // size)), MAX_COPIES) if size else 1
    clone = lambda: tuple(a.clone() if torch.is_tensor(a) else a for a in args)  # noqa: E731
    return [tuple(args)] + [clone() for _ in range(n - 1)]


def _warm_then_flush(fn, copies) -> None:
    """One warm-up call, then a write of twice the L2, so the timed calls
    start with none of their inputs in L2."""
    import torch

    fn(*copies[0])
    torch.empty(2 * L2_BYTES, dtype=torch.uint8, device="cuda").zero_()
    torch.cuda.synchronize()


def cuda_ms(fn, copies, reps: int) -> float:
    """Mean time of ``fn`` over ``reps`` calls, one copy of its inputs after
    another, by CUDA events around the calls (the host's launch overhead
    included)."""
    import torch

    _warm_then_flush(fn, copies)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(*copies[i % len(copies)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: Dict[str, float]) -> Tuple[float, str]:
    """(least ms, what binds): bytes over the memory rate against each
    operation count over its peak rate."""
    times = {"bytes": nbytes / HBM_BYTES_PER_S}
    rates = {"f64": F64_INSTR_PER_S, "f32": F32_OPS_PER_S, "int32": INT32_OPS_PER_S}
    for kind, n in ops.items():
        times[kind] = n / rates[kind]
    worst = max(times, key=times.get)
    return times[worst] * 1e3, "bytes" if worst == "bytes" else "operations"


def nbytes(*tensors) -> int:
    return sum(v.numel() * v.element_size() for v in tensors)


def k2_bound(spec, X, y, out) -> Tuple[float, str]:
    pf = len(spec.effective_fit_cols)
    sims, max_n, _ = X.shape
    fma = sims * max_n * (pf * (pf + 1) // 2 + pf + 2)
    if "n_j" in out:
        fma += sims * max_n * (pf + 1)
    if "G" in out:  # the slope mode's sums of z_k, z_k z_l, z_k x and z_k y
        qs = out["G"].shape[-1] - 1
        fma += sims * max_n * (qs * (pf + 2) + qs * (qs + 1) // 2)
    return bound(nbytes(X, y, *out.values()), {"f64": fma})


def k1_bound(plan, n_sims: int, out) -> Tuple[float, str]:
    """The work of the real rows: per sim one cipher for its key and one for
    each 4-row block below ceil(rows / 4) of each stream, and one ppf per
    real normal; bytes as written, padding included, and the int64 sim ids
    read."""
    ciphers = n_sims * (1 + sum((rows + 3) // 4 for _, _, rows in plan))
    normals = n_sims * sum(rows for _, _, rows in plan)
    return bound(nbytes(out) + 8 * n_sims, {"int32": ciphers * PHILOX_INT_OPS_PER_CIPHER,
                                            "f32": normals * PPF_F32_OPS_PER_NORMAL})


def k1_bound_padded(out) -> Tuple[float, str]:
    """K1's bound as first counted, kept for comparison: a quarter cipher
    and one ppf for every output word, padding included."""
    return bound(nbytes(out), {"int32": out.numel() * PHILOX_INT_OPS_PER_WORD,
                               "f32": out.numel() * PPF_F32_OPS_PER_NORMAL})


def k3_bound(args, outs) -> Tuple[float, str]:
    """Per cell: the p^3 / 3 of the factor, p^3 of the p + 1 solves and 3
    p^2 of the rest, in f64 instructions (an estimate); bytes of every
    input and output."""
    p = args[0].shape[-1]
    instr = args[2].numel() * (p ** 3 // 3 + p ** 3 + 3 * p * p)
    return bound(nbytes(*args, *outs), {"f64": instr})


def k4_bound(args, outs) -> Tuple[float, str]:
    """Per deviance evaluation of a cell: c_j and log1p(gamma n_j) once per
    run of equal n_j (the values repeat with n_j), the multiply-adds of
    every cluster, then exp(log gamma), the p x p Cholesky and solves, and
    p + 1 logs."""
    n_j, p = args[0], args[3].shape[-1]
    m, cells = n_j.shape[-1], n_j[..., 0].numel()
    runs = cells + int((n_j[..., 1:] != n_j[..., :-1]).sum())
    per_cluster = p * (p + 1) + 3 * p + 4
    per_cell = (F64_LOG_INSTR + p * F64_SQRT_INSTR + (3 * p + 1) * F64_DIV_INSTR
                + (p + 1) * F64_LOG_INSTR + p ** 3)
    instr = REML_EVALS * (runs * (F64_DIV_INSTR + F64_LOG_INSTR + 3)
                          + cells * (m * per_cluster + per_cell))
    return bound(nbytes(*args, *outs), {"f64": instr})


def k6_bound(args, iters, outs, first_count: bool = False, active=None) -> Tuple[float, str]:
    """The steps the cells ran (``iters (sims, G, 2)`` from the kernel's
    counter: f32 and f64 steps), each a pass over the cell's rows (eta, the
    link, X'WX and X'Wz) and a p x p solve, then per cell one final f64
    pass (X'WX, one link and one division per row, the deviance's logs: one
    per binomial row, two per Poisson row, log mu and the y log y term; the
    null deviance's logs once per cell) with two Cholesky factors and the
    inverse; bytes of X's fit columns and y up to the last grid point (each
    read once), beta0, the column mask and every output. ``first_count``
    counts the final pass as first counted: two divisions and two logs per
    row, the null deviance's logs per row. With ``active (sims, G)``, a
    launch over those cells alone: the final pass and the rows read count
    only them and their sims."""
    import torch

    from mcpower_tpu_torch.engine.glmfit import LINK_POISSON

    code, X, y, fit, grid, beta0, colmask = args
    p = len(fit)
    it = iters.reshape(-1, len(grid), 2).to("cpu").double()
    ns = it.new_tensor([float(n) for n in grid])
    act = (active.to("cpu").double() if active is not None
           else torch.ones(it.shape[:2], dtype=torch.float64))
    row_ops = 2 * p + p * (p + 1) + 3 * p + 6
    solve = p ** 3 // 3 + 2 * p * p
    f32 = float((it[..., 0] * ns).sum() * (row_ops + F32_EXP_OPS) + it[..., 0].sum() * solve)
    f64_row = row_ops + F64_EXP_INSTR + 2 * F64_DIV_INSTR
    f64 = float((it[..., 1] * ns).sum() * f64_row
                + it[..., 1].sum() * (solve + p * F64_SQRT_INSTR))
    cells = float(act.sum())
    rows = float((act * ns).sum())
    if first_count:
        final_row, final_cell = f64_row + 2 * F64_LOG_INSTR, 0
    else:
        poisson = code == LINK_POISSON
        final_row = (row_ops + F64_EXP_INSTR + F64_DIV_INSTR
                     + (2 if poisson else 1) * F64_LOG_INSTR)
        final_cell = (1 if poisson else 2) * F64_LOG_INSTR
    f64 += rows * final_row + cells * (final_cell + 2 * p ** 3 // 3 + p ** 3
                                       + 2 * p * F64_SQRT_INSTR)
    last = (act * ns).amax(-1)  # each sim's rows up to its largest active grid point
    read = float(last.sum()) * (p + 1) * 4
    written = nbytes(*outs) * float(act.mean())
    return bound(read + nbytes(beta0, colmask) + written, {"f32": f32, "f64": f64})


def k8_bound(u, eta, y) -> Tuple[float, str]:
    """Per row an f32 exp; per walk row (0 < lam <= 20) one f64 exp and the
    steps this run's rows took (y of them: a multiply, a division and an
    add each); per approximated row the ppf, a sqrt and a floor; bytes of u,
    eta and y."""
    lam = eta.double().exp()
    walk = (lam > 0) & (lam <= 20.0)
    steps = float(y.double()[walk].sum())
    f64 = float(walk.sum()) * F64_EXP_INSTR + steps * (F64_DIV_INSTR + 2)
    f32 = u.numel() * F32_EXP_OPS + float((lam > 20.0).sum()) * (PPF_F32_OPS_PER_NORMAL + 12)
    return bound(nbytes(u, eta, y), {"f32": f32, "f64": f64})


def k7_bound(args, outs) -> Tuple[float, str]:
    """Every cell's fit as K7 runs it: 48 f64 and 112 f32 PIRLS steps (the
    cold, optimum, probe and final fits; the Brent phases), each per row the
    linear predictor, the link's transcendental, two divisions, the cluster
    sums and X'WX and X'Wz, per cluster c_j, the Schur sums and the u update,
    per cell a p x p solve; 18 f64 deviance tails (a log and a division a
    row, a log1p a cluster); under AGQ the f64 nodes of three full
    deviances and the 14 hybrid ones (f64 centre, f32 node deltas); the
    final pass with two Cholesky factors and the inverse; under the Hessian
    the 1 + 2p + 2p(p - 1) profiled deviances of 21 passes each. Steps are
    counted in full (a cell stops early only on a step that is not finite).
    Bytes: each sim's fit columns and y up to the last grid point, beta0 and
    every output."""
    from mcpower_tpu_torch.engine import glmmfit

    code, X, y, fit, grid, layout, beta0, nagq, hessian = args
    p, m, sims = len(fit), layout[2], X.shape[0]
    rows = float(sims * sum(grid))
    cells = float(sims * len(grid))
    step_row = p * p + 7 * p + 6
    clus = p * (p + 1) + 4 * p + 2
    solve = p ** 3 // 3 + 2 * p * p
    it64 = 4 * glmmfit.N_PIRLS
    it32 = (glmmfit.BRENT_FULL_GLMM * glmmfit.N_PIRLS
            + (glmmfit.BRENT_ITERS_GLMM - glmmfit.BRENT_FULL_GLMM) * glmmfit.N_PIRLS_WARM)
    f32 = it32 * (rows * (step_row + 2 * F32_EXP_OPS) + cells * m * (clus + F32_EXP_OPS)
                  + cells * (solve + 2 * p * F32_EXP_OPS))
    f64 = it64 * (rows * (step_row + F64_EXP_INSTR + 2 * F64_DIV_INSTR)
                  + cells * m * (clus + F64_DIV_INSTR)
                  + cells * (solve + p * (F64_SQRT_INSTR + F64_DIV_INSTR)))
    tails = 1 + glmmfit.BRENT_ITERS_GLMM + 3
    ll_row = 2 * p + 2 + F64_EXP_INSTR + F64_LOG_INSTR
    f64 += tails * (rows * (ll_row + F64_DIV_INSTR) + cells * m * (F64_LOG_INSTR + 4))
    if nagq > 1:
        f64 += 3 * nagq * (rows * ll_row + cells * m * (F64_EXP_INSTR + 8))
        f64 += glmmfit.BRENT_ITERS_GLMM * rows * ll_row
        f32 += glmmfit.BRENT_ITERS_GLMM * ((nagq + 1) * rows * (2 * F32_EXP_OPS + 3)
                                           + cells * m * nagq * (F32_EXP_OPS + 8))
    f64 += rows * (step_row + F64_EXP_INSTR + F64_DIV_INSTR) + cells * (
        2 * p ** 3 // 3 + p ** 3 + 2 * p * F64_SQRT_INSTR)
    if hessian:
        evals = 1 + 2 * p + 2 * p * (p - 1)
        f64 += evals * (glmmfit.N_U_NEWTON + 1) * (
            rows * (2 * p + 4 + F64_EXP_INSTR + F64_DIV_INSTR) + cells * m * 2 * F64_DIV_INSTR)
    read = float(sims * max(grid) * (p + 1) * 4)
    return bound(read + nbytes(beta0, *outs), {"f32": f32, "f64": f64})


F32_DIV_OPS = 8  # an f32 division or square root (IEEE-rounded), in f32 operations


def k9_div_check(torch, kernels, dev, n: int = 1 << 22) -> None:
    """K9's f32 solves divide by ``div_by`` (the reciprocal of the pivot and
    two fma corrections, no branch) where numerator and pivot lie in
    [2^-40, 2^41) or the numerator is zero, and by the IEEE division
    elsewhere. On the card, ``mcp_k9_div_check`` holds ``div_by`` against
    ``__fdiv_rn`` bit for bit over ``n`` pairs: random exponents over that
    range, random mantissas and signs, every 16th numerator a signed zero,
    every 64th pair outside the range (which must be flagged)."""
    import ctypes

    g = torch.Generator(device=dev).manual_seed(SEED)

    def draw(lo, hi, signed):
        e = torch.randint(lo, hi + 1, (n,), generator=g, device=dev, dtype=torch.int32)
        m = torch.randint(0, 1 << 23, (n,), generator=g, device=dev, dtype=torch.int32)
        s = torch.randint(0, 2, (n,), generator=g, device=dev, dtype=torch.int32) if signed \
            else torch.zeros(n, dtype=torch.int32, device=dev)
        return ((s << 31) | (e << 23) | m).view(torch.float32)

    a, b = draw(87, 167, True), draw(87, 167, False)
    idx = torch.arange(n, device=dev)
    a = torch.where(idx % 16 == 3, torch.where(idx % 32 == 3, -0.0, 0.0), a)
    a = torch.where(idx % 64 == 5, draw(1, 86, True), a)   # numerators below the range
    b = torch.where(idx % 64 == 9, draw(168, 254, False), b)  # pivots above it
    got, want = torch.empty_like(a), torch.empty_like(a)
    bad = torch.empty(n, dtype=torch.uint8, device=dev)
    fn = kernels.KERNELS["slope_reml"].fn("mcp_k9_div_check", [ctypes.c_void_p] * 5
                                          + [ctypes.c_int, ctypes.c_void_p])
    kernels.KERNELS["slope_reml"].check(fn(kernels.ptr(a), kernels.ptr(b), kernels.ptr(got),
                                           kernels.ptr(want), kernels.ptr(bad), n,
                                           kernels.stream_of(a)))
    torch.cuda.synchronize()
    ok = bad == 0
    out_of_range = (idx % 64 == 5) | (idx % 64 == 9)
    differ = int((got.view(torch.int32) != want.view(torch.int32))[ok].sum())
    zeros = int((a == 0).sum())
    print(f"K9 div_by against the IEEE division: {n} pairs ({zeros} zero numerators, "
          f"{int(out_of_range.sum())} outside the range), {int(ok.sum())} in range, "
          f"{differ} quotients differ; flagged outside the range "
          f"{int((~ok & out_of_range).sum())} of {int(out_of_range.sum())}, "
          f"flagged inside {int((~ok & ~out_of_range).sum())}", flush=True)
    check(differ == 0, f"K9 div_by: {differ} quotients differ from the IEEE division's")
    check(bool((~ok)[out_of_range].all()), "K9 div_by: a pair outside its range not flagged")
    check(bool(ok[~out_of_range].all()), "K9 div_by: a pair inside its range flagged")


def k9_bound(args, outs) -> Tuple[float, str]:
    """Every cell's fit as its data needs it: the f32 deviance evaluations
    its search needed (``outs[6]``, the kernel's count: the initial simplex,
    then each iteration's reflection and at most the one candidate the
    selection reads; without it, the first version's fixed d + 1 + 4 x 140)
    and q + 2 f64 ones (the optimum, the q zero-column probes, the final fit),
    each per cluster the q x q products Lam' G Lam, the factor of C and its
    q logs, Lam' A and Lam' b, p + 1 solves and the p (p + 1) / 2 + p + 1
    terms, per cell the p x p factor, solve, rss and p + 1 logs (a multiply-
    add two operations: K9 is built without contraction); then the final
    inverse. Bytes: every input read once, every output written once."""
    from mcpower_tpu_torch.engine import mixedfit

    G, A, b, xtx, xty, yty = args[:6]
    q, p, m, cells = G.shape[-1], xtx.shape[-1], G.shape[-3], float(yty.numel())
    d = q * (q + 1) // 2
    mac = (q * q * (q + 1) // 2  # Lam' G
           + sum(q - k for j in range(q) for k in range(j + 1))  # C
           + q * (q * q - 1) // 6  # its factor
           + (p + 1) * (q * (q + 1) // 2 + q * q)  # Lam' A, Lam' b and their solves
           + q * (p * (p + 1) // 2 + p + 1))  # the terms
    per_cluster = {"f32": 2 * mac + 2 * q * F32_DIV_OPS + q * F32_EXP_OPS,
                   "f64": 2 * mac + 2 * q * F64_DIV_INSTR + q * F64_LOG_INSTR}
    pmac = p ** 3 // 6 + p * p + p + p * (p + 1) // 2
    per_cell = {"f32": 2 * pmac + 3 * p * F32_DIV_OPS + (p + 1) * F32_EXP_OPS,
                "f64": 2 * pmac + 3 * p * F64_DIV_INSTR + (p + 1) * F64_LOG_INSTR}
    f32_evals = (float(outs[6].double().sum()) if len(outs) > 6
                 else cells * (d + 1 + 4 * mixedfit.SLOPE_NM_ITERS))
    evals = {"f32": f32_evals, "f64": cells * (q + 2)}
    ops = {k: evals[k] * (m * per_cluster[k] + per_cell[k]) for k in evals}
    ops["f64"] += cells * (p ** 3 + p * p)
    return bound(nbytes(G, A, b, xtx, xty, yty, *(o for o in outs if hasattr(o, "numel"))), ops)


def k10_bound(args, outs) -> Tuple[float, str]:
    """Every cell's fit as K10 runs it: (d + 1) 8 + 12 x 4 x 8 + 33 x 4 x 3
    f32 PIRLS steps and d + 1 + 4 x 45 f32 deviance tails (the initial
    simplex and four candidates an iteration), then 12 + 3q f64 steps, the
    f64 mode pass and q f64 tails (the fit and the pin probes), under the
    Hessian 1 + 2p + 2p(p - 1) stencil points of 20 v-only passes and a tail
    each. A step, per row: X beta and Z u, the link's transcendental, two
    divisions and the (q + p)-term sums (a multiply-add two operations: K10
    is built without contraction); per cluster u = Lam v, C = I + Lam' G Lam,
    its factor, the solves of Lam' A and Lam' b, the Schur terms and the v
    update; per cell the p x p factor and solve. A tail: per row the link and
    the deviance's log, G; per cluster C, its factor and q logs. Steps are
    counted in full (a cell keeps its state on a step that is not finite).
    Bytes: each sim's fit and slope columns and y up to the last grid
    point, beta0 and every output."""
    from mcpower_tpu_torch.engine import glmmfit

    code, X, y, fit, zcols, grid, layout, beta0, theta0, lower_, hessian = args
    p, q, m, sims = len(fit), len(zcols) + 1, layout[2], X.shape[0]
    d = q * (q + 1) // 2
    rows = float(sims * sum(grid))
    cells = float(sims * len(grid))
    ng, nt = q * (q + 1) // 2, p * (p + 1) // 2
    row_step = 2 * (p + q) + 6 + 2 * ng + 2 * q * p + p + 2 * nt + 4 + 2 * q + 1 + 2 * p
    row_tail = 2 * (p + q) + 4 + 2 * ng + 4
    mac = (q * (q + 1) // 2 + q * q * (q + 1) // 2 + sum(q - k for j in range(q)
                                                         for k in range(j + 1))
           + q * (q * q - 1) // 6 + (p + 1) * (q * (q + 1) // 2 + q * q)
           + q * (nt + p) + q * p)
    clus_step = {"f32": 2 * mac + 2 * q * F32_DIV_OPS, "f64": 2 * mac + 2 * q * F64_DIV_INSTR}
    clus_tail = {"f32": 2 * (ng * q + q * q) + q * F32_DIV_OPS + q * F32_EXP_OPS,
                 "f64": 2 * (ng * q + q * q) + q * F64_DIV_INSTR + q * F64_LOG_INSTR}
    pmac = p ** 3 // 6 + p * p
    cell_step = {"f32": 2 * pmac + 3 * p * F32_DIV_OPS, "f64": 2 * pmac + 3 * p * F64_DIV_INSTR}
    per_row = {"f32": (row_step + F32_EXP_OPS + 2 * F32_DIV_OPS, row_tail + 2 * F32_EXP_OPS
                       + F32_DIV_OPS),
               "f64": (row_step + F64_EXP_INSTR + 2 * F64_DIV_INSTR, row_tail + F64_EXP_INSTR
                       + F64_LOG_INSTR + F64_DIV_INSTR)}
    steps = {"f32": (d + 1) * glmmfit.N_PIRLS_SLOPE + sum(4 * n * b for n, b in
                                                         glmmfit.SLOPE_PHASES),
             "f64": glmmfit.N_PIRLS + q * glmmfit.N_PIRLS_SLOPE_WARM + 1}
    tails = {"f32": d + 1 + 4 * glmmfit.NM_ITERS_GLMM, "f64": q}
    if hessian:
        v = 1 + 2 * p + 2 * p * (p - 1)
        steps["f64"] += v * glmmfit.N_V_PIRLS
        tails["f64"] += v
    ops = {k: steps[k] * (rows * per_row[k][0] + cells * (m * clus_step[k] + cell_step[k]))
           + tails[k] * (rows * per_row[k][1] + cells * m * clus_tail[k]) for k in steps}
    ops["f64"] += cells * (p ** 3 + 2 * p ** 3 // 3)
    read = float(sims * max(grid) * (p + q) * 4)
    return bound(read + nbytes(beta0, *(o for o in outs if hasattr(o, "numel"))), ops)


def k11_bound(args, outs) -> Tuple[float, str]:
    """Every cell's fit as K11 runs it: d + 1 + 4 x 140 f32 evaluations and
    one f64 refit, each evaluation's operations (a multiply-add two
    operations: K11 is built without contraction) counted by its form:
    structured (a, Cpe, Cpe / a, rp, rp / a, re; S over the m1 primary
    levels; the Me x Me factor and the solves of p + 1 columns; xp; the
    tail's (p + 1)^2 row sums; m1 + Me logs) or dense (C = I + Lam' ztz Lam
    entry by entry over each grouping's components, the M x M factor, the
    solves, the tail, M logs); then the p x p factor, solve and logs, and
    the final inverse. Bytes: every input read once, every output written
    once."""
    from mcpower_tpu_torch.engine import mixedfit

    ztz, ztx, zty, xtx, xty, yty, _, shape = args[:8]
    M, p, cells = ztz.shape[-1], xtx.shape[-1], float(yty.numel())
    r = p + 1
    d = sum(q * (q + 1) // 2 for _, q in shape)
    if all(q == 1 for _, q in shape):
        m1 = shape[0][0]
        n = M - m1
        mac = (m1 + m1 * n + m1 * r + n * r  # a, Cpe, rp, re
               + n * (n + 1) // 2 * (m1 + 1) + n * r * m1  # S, t
               + m1 * r * n + r * r * M)  # xp, the tail
        divs, logs = m1 * n + m1 * r + 2 * m1 * r, m1 + n
    else:
        # a column's terms: its grouping's components from its own on
        k = [q - c for m, q in shape for _ in range(m) for c in range(q)]
        mac = (sum(ka * kb + kb for i, ka in enumerate(k) for kb in k[:i + 1])  # C
               + r * sum(k) + r * r * M)  # [Lam' zty | Lam' ztx], the tail
        n, divs, logs = M, 0, M
    mac += n ** 3 // 6 + r * n * n  # the factor; forward and backward solves
    divs += n * (n + 1) // 2 + 2 * n * r
    pmac = p ** 3 // 6 + p * p + p
    per_eval = {"f32": 2 * (mac + pmac) + (divs + 3 * p + n) * F32_DIV_OPS
                + (logs + p + 1) * F32_EXP_OPS,
                "f64": 2 * (mac + pmac) + (divs + 3 * p) * F64_DIV_INSTR + n * F64_SQRT_INSTR
                + (logs + p + 1) * F64_LOG_INSTR}
    evals = {"f32": d + 1 + 4 * mixedfit.SLOPE_NM_ITERS, "f64": 1}
    ops = {k: cells * evals[k] * per_eval[k] for k in evals}
    ops["f64"] += cells * (p ** 3 + p * p)
    return bound(nbytes(*args[:6], *(o for o in outs if hasattr(o, "numel"))), ops)


def k12_bound(args, outs) -> Tuple[float, str]:
    """Every cell's fit as K12 runs it: (d + 1) 8 + 12 x 4 x 8 + (iters - 12)
    x 4 x 3 f32 PIRLS steps and d + 1 + 4 iters f32 deviance tails (30
    iterations for d <= 3, 45 beyond), then 12 f64 steps and the f64 mode
    pass, under the Hessian 1 + 2p + 2p(p - 1) stencil points of 20 v-only
    dense passes and a dense tail each. A pass, per row (a multiply-add two
    operations: K12 is built without contraction): X beta and z u, the
    link's transcendental, two divisions, Z'WZ's terms (the level's block and
    the blocks with later groupings, over each grouping), the right-hand
    sides wz_k zw and wz_k x_a, and X'WX, X'Wz and the deviance's log (a
    tail: the Z'WZ terms and the log alone); per cell the capacitance as
    k11_bound counts it (structured: a, Cpe, S over the primary levels, its
    factor, the p + 1 column solves; dense: C entry by entry, its blocked
    factor and solves), M logs, the p x p factor and solve and the v update.
    Passes are counted in full (a cell keeps its state on a step that is not
    finite). Bytes: each sim's fit and slope columns and y up to the last
    grid point, the row lists, beta0 and every output."""
    from mcpower_tpu_torch.engine import glmmfit

    code, X, y, fit, grid, groups, beta0, theta0, lower_, hessian = args
    p, sims = len(fit), X.shape[0]
    shape = [(int(m), 1 + len(c)) for _, m, c in groups]
    M = sum(m * q for m, q in shape)
    d = sum(q * (q + 1) // 2 for _, q in shape)
    nz = sum(q for _, q in shape)
    rows = float(sims * sum(grid))
    cells = float(sims * len(grid))
    r = p + 1
    nt = p * (p + 1) // 2
    # Z'WZ terms a row adds: each grouping's block (k >= l) and its blocks
    # with the later groupings
    zterms = sum(q * (q + 1) // 2 + q * sum(qh for _, qh in shape[g + 1:])
                 for g, (_, q) in enumerate(shape))
    row_step = 2 * p + 2 * nz + 6 + 2 * zterms + 2 * nz * r + 3 * nt + 3 * p
    row_tail = 2 * p + 2 * nz + 4 + 2 * zterms

    def cap(dense: bool, rr: int, solve: bool):
        if not dense:
            m1 = shape[0][0]
            n = M - m1
            mac = (m1 + m1 * n + n * (n + 1) // 2 * (m1 + 1))
            divs = m1 * n
            if solve:
                mac += m1 * rr + n * rr + n * rr * m1 + m1 * rr * n + rr * rr * M
                divs += m1 * rr + 2 * m1 * rr
            logs = m1 + n
        else:
            k = [q - c for m, q in shape for _ in range(m) for c in range(q)]
            mac = sum(ka * kb + kb for i, ka in enumerate(k) for kb in k[:i + 1])
            if solve:
                mac += rr * sum(k) + rr * rr * M
            n, divs, logs = M, 0, M
        mac += n ** 3 // 6 + (rr * n * n if solve else 0)
        divs += n * (n + 1) // 2 + (2 * n * rr if solve else 0)
        return mac, divs, logs, n

    structured = all(q == 1 for _, q in shape)
    pmac = p ** 3 // 6 + p * p + M * p

    def per_cell(kind, dense):
        mac, divs, logs, n = cap(dense, 1 if kind == "vstep" else r, kind != "tail")
        out = {}
        for t, div, trans in (("f32", F32_DIV_OPS, F32_EXP_OPS), ("f64", F64_DIV_INSTR,
                                                                  F64_LOG_INSTR)):
            o = 2 * mac + divs * div + logs * trans + 2 * M
            if kind in ("step", "mode"):
                o += 2 * pmac + 3 * p * div
            out[t] = o
        return out

    per_row = {"f32": (row_step + F32_EXP_OPS + 2 * F32_DIV_OPS,
                       row_tail + 2 * F32_EXP_OPS + F32_DIV_OPS),
               "f64": (row_step + F64_EXP_INSTR + 2 * F64_DIV_INSTR,
                       row_tail + F64_EXP_INSTR + F64_LOG_INSTR + F64_DIV_INSTR)}
    phases = glmmfit.extras_phases(d)
    steps32 = (d + 1) * glmmfit.N_PIRLS_SLOPE + sum(4 * n * b for n, b in phases)
    tails32 = d + 1 + 4 * glmmfit.extras_nm_iters(d)
    dense = not structured
    ops = {"f32": steps32 * (rows * per_row["f32"][0] + cells * per_cell("step", dense)["f32"])
           + tails32 * (rows * per_row["f32"][1] + cells * per_cell("tail", dense)["f32"]),
           "f64": (glmmfit.N_PIRLS + 1) * (rows * per_row["f64"][0]
                                           + cells * per_cell("step", dense)["f64"])}
    if hessian:
        v = 1 + 2 * p + 2 * p * (p - 1)
        ops["f64"] += v * (glmmfit.N_V_PIRLS * (rows * per_row["f64"][0]
                                                + cells * per_cell("vstep", True)["f64"])
                           + rows * per_row["f64"][1] + cells * per_cell("tail", True)["f64"])
    ops["f64"] += cells * (p ** 3 + 2 * p ** 3 // 3)
    read = float(sims * max(grid) * (p + nz - len(shape) + 1) * 4 + len(shape) * X.shape[1] * 12)
    return bound(read + nbytes(beta0, *(o for o in outs if hasattr(o, "numel"))), ops)


def k2_joint_bound(spec, X, y, out) -> Tuple[float, str]:
    """K2's joint mode: X and y read once, ztz, ztx and zty written once per
    grid point; Q^2 + Q p + Q f64 multiply-adds a row (Q components)."""
    from mcpower_tpu_torch.engine import olsfit

    groups, _ = olsfit.joint_layout(spec)
    Q = sum(1 + len(cols) for _, _, cols in groups)
    p = len(spec.effective_fit_cols)
    rows = float(X.shape[0] * X.shape[1])
    return bound(nbytes(X, y, out["ztz"], out["ztx"], out["zty"]),
                 {"f64": 2 * rows * (Q * Q + Q * p + Q)})


def rel_err_finite(name: str, a, b) -> float:
    """rel_err over the entries finite in both, after checking that the
    same entries are finite."""
    import torch

    fa, fb = torch.isfinite(a), torch.isfinite(b)
    check(torch.equal(fa, fb), f"{name}: non-finite entries differ")
    return rel_err(a[fa], b[fb]) if bool(fa.any()) else 0.0


PROFILER_ATTEMPTS = 3


def device_events(run, what: str, match: str = "", cpu: bool = False, before=None,
                  host: list = None) -> list:
    """The CUDA events of ``run()`` under torch.profiler whose name contains
    ``match`` (``cpu`` traces the host too, and its events go to ``host``
    where given). A window in which the profiler returned no such event
    (seen once on an H100, between two windows of the same run that had
    them) is profiled again, after ``before()``, up to PROFILER_ATTEMPTS
    times; then the phase fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    for attempt in range(1, PROFILER_ATTEMPTS + 1):
        if before is not None:
            before()
        with profile(activities=activities) as prof:
            run()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA and match in e.name]
        if events:
            if host is not None:
                host[:] = [e for e in prof.events() if e.device_type == DeviceType.CPU]
            return events
        print(f"the profiler saw no device time for {what} (attempt {attempt} of "
              f"{PROFILER_ATTEMPTS})", flush=True)
    raise SmokeFailure(f"the profiler saw no device time for {what}")


def device_ms(fn, copies, reps: int, kernel: str = "", launches: int = None) -> float:
    """Mean device time per call of ``fn``, one copy of its inputs after
    another: the CUDA kernels it launches (those whose name contains
    ``kernel``, or all), summed from torch.profiler's device events. Gaps
    between kernels, where the device waits for the host, are not counted.
    Where the call's ``launches`` of the wrapped kernel ``kernel`` are known,
    the wrapper's own launch count is read around each profiled window and
    must be ``reps * launches``; the time is then the mean event times
    ``launches``: the profiler has been seen on an H100 to drop some of a
    window's events (2 of 20 K6 launches, in three windows running) that
    the launch count shows were made, which a mean over the events seen
    does not feel."""
    from mcpower_tpu_torch.engine import kernels

    counted = []

    def launched(name):  # K2's joint mode is counted under its tag
        if name == "grid_suffstats_joint":
            return kernels.tagged_counts().get("grid_suffstats", {}).get("joint", 0)
        return kernels.counts()[name]

    def calls():
        name = kernel.removesuffix("_kernel")
        before = launched(name) if launches else 0
        for i in range(reps):
            fn(*copies[i % len(copies)])
        if launches:
            counted.append(launched(name) - before)

    events = device_events(calls, kernel or "the plain version", kernel,
                           before=lambda: _warm_then_flush(fn, copies))
    if launches:
        check(counted[-1] == reps * launches,
              f"{kernel}: {counted[-1]} launches counted in the profiled window, "
              f"{reps * launches} expected")
        if len(events) != reps * launches:
            print(f"the profiler saw {len(events)} events of {kernel} where its wrapper counted "
                  f"{counted[-1]} launches; its time is the events' mean", flush=True)
        return sum(e.time_range.elapsed_us() for e in events) / len(events) * launches / 1e3
    return sum(e.time_range.elapsed_us() for e in events) / reps / 1e3


class ClockSampler:
    """``nvidia-smi`` sampling the SM clock (MHz) and power draw (W) every
    100 ms while a ``with`` block runs."""

    def __enter__(self):
        self.samples = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
             "-lms", "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        for line in out.splitlines():
            try:
                self.samples.append(tuple(float(v) for v in line.split(",")))
            except ValueError:
                continue

    def summary(self) -> str:
        if not self.samples:
            return "not sampled"
        clk = sorted(c for c, _ in self.samples)
        return (f"SM clock min {clk[0]:.0f}, median {clk[len(clk) // 2]:.0f}, max {clk[-1]:.0f} "
                f"MHz; power draw max {max(w for _, w in self.samples):.1f} W "
                f"({len(clk)} samples, 100 ms apart)")


PROFILE_REPS = 3
# The extras flows and arms: K11 and K12 take tenths of a second a launch (a
# first version), so their walls are one call each, to keep the script
# within its time.
EXTRAS_PROFILE_REPS = 1
GLMM_EXTRAS_PROFILE_REPS = 1
# The rows of phase 5 where a heavy kernel's plain version is timed (its
# kernel's main row, the one the kernels line reports); its other rows'
# plain times are not measured, to keep the script in its time.
PLAIN_AT_MAIN_ROW = ("glm_irls", "glmm_intercept agq7", "slope_reml readme2",
                     "glmm_slope flow", "joint_reml crossed")


def profile_arm(run, after_each=None, reps: int = None, profiled: int = 2) -> Dict:
    """Wall of ``reps`` (PROFILE_REPS) calls of ``run`` (host clock; each call ends
    with the counts on the host), then ``profiled`` calls under
    torch.profiler, the one whose window holds the most kernels kept: the
    summed device time of its kernels, their count and the largest by
    name (ms). ``after_each()`` is called after each timed call, outside
    its wall."""
    import statistics
    from collections import defaultdict

    walls = []
    for _ in range(reps or PROFILE_REPS):
        t0 = time.perf_counter()
        run()
        walls.append((time.perf_counter() - t0) * 1e3)
        if after_each is not None:
            after_each()
    # two profiled calls, keeping the one whose window holds more kernels:
    # a window has been seen to drop part of a call's events (one for the
    # extras' flows and arms, whose calls take seconds)
    host: list = []
    events = []
    for _ in range(profiled):
        got_host: list = []
        got = device_events(run, "an arm", cpu=True, host=got_host)
        if len(got) > len(events):
            events, host = got, got_host
    by_name: Dict[str, float] = defaultdict(float)
    for e in events:
        name = re.split(r"[(<]", e.name.replace("(anonymous namespace)::", ""))[0]
        by_name[name[:48]] += e.time_range.elapsed_us() / 1e3
    # host time by operator: self time of the aten and other CPU ops
    by_host: Dict[str, float] = defaultdict(float)
    for e in host:
        by_host[e.name[:48]] += e.self_cpu_time_total / 1e3
    return dict(median_ms=statistics.median(walls), min_ms=min(walls), max_ms=max(walls), walls=walls,
                device_ms=sum(by_name.values()), launches=len(events),
                items=sorted(by_name.items(), key=lambda kv: -kv[1])[:6],
                host_items=sorted(by_host.items(), key=lambda kv: -kv[1])[:8])


def _ptxas_by_kernel(log: str) -> Dict[str, Dict[str, int]]:
    """Registers and spill-store bytes of each kernel instantiation, keyed
    by its mangled name."""
    found: Dict[str, Dict[str, int]] = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            found.setdefault(cur, {})["spill"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found.setdefault(cur, {})["regs"] = int(m.group(1))
            cur = None
    return {name: v for name, v in found.items() if "regs" in v}


def _ptxas_by_p(log: str) -> Dict[int, Dict[str, int]]:
    """The same, keyed by the template p (``...kernelILi<p>E...``); where
    several instantiations share p (K6's links), the most of each."""
    by_p: Dict[int, Dict[str, int]] = {}
    for name, v in _ptxas_by_kernel(log).items():
        m = re.search(r"kernelILi(\d+)E", name)
        if m:
            old = by_p.setdefault(int(m.group(1)), {})
            for key, n in v.items():
                old[key] = max(old.get(key, 0), n)
    return by_p


def _ptxas_lines(name: str, log: str) -> list:
    """Per-instantiation ptxas lines: by p for K2-K4 (K2's slope mode on a
    line of its own, ``...kernelILi<p>ELb1E``), by (mode, store) for K1
    (``philox_fill_kernelILi<mode>ELb<vec>E``), by (q, p) for K9
    (``slope_reml_kernelILi<q>ELi<p>E``, p = 8 and 16 its buckets)."""
    if name in ("slope_reml", "glmm_slope"):
        # K9's third template argument is its form (K10's, its blocks an SM)
        forms = {"1": " packed", "2": " pair", "3": " quad"} if name == "slope_reml" else {}
        rows = []
        for mangled, v in _ptxas_by_kernel(log).items():
            m = re.search(r"kernelILi(\d+)ELi(\d+)E(?:Li(\d)E)?", mangled)
            if m:
                rows.append((int(m.group(1)), int(m.group(2)), forms.get(m.group(3), ""), v))
        out = [f"  ptxas {name} by q and p (p = 8, 16: the p <= 8, p <= 16 buckets): " + ", ".join(
            f"q={q} p={pm}{form}: {v['regs']} registers, {v.get('spill', 0)} B spill stores"
            for q, pm, form, v in sorted(rows, key=lambda r: r[:3]))] if rows else []
        if name == "glmm_slope":  # its pass function, not inlined: a stack frame of its own
            passes = []
            cur = None
            for line in log.splitlines():
                m = re.search(r"Function properties for \S*slope_passILi(\d+)ELi(\d+)E(\w)", line)
                if m:
                    cur = (int(m.group(1)), int(m.group(2)), "f32" if m.group(3) == "f" else "f64")
                    continue
                m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
                if cur is not None and m:
                    passes.append((cur, int(m.group(1)), int(m.group(2))))
                    cur = None
            if passes:
                out.append(f"  ptxas {name} pass function by q, p and type: " + ", ".join(
                    f"q={q} p={pm} {t}: {fr} B stack, {sp} B spill stores"
                    for (q, pm, t), fr, sp in sorted(passes)))
        return out
    if name == "grid_suffstats":
        out = []
        for mode, tag in (("0", "by p"), ("1", "slope mode by p")):
            rows = []
            for mangled, v in _ptxas_by_kernel(log).items():
                m = re.search(rf"kernelILi(\d+)ELb{mode}E", mangled)
                if m:
                    rows.append((int(m.group(1)), v))
            if rows:
                out.append(f"  ptxas {name} {tag}: " + ", ".join(
                    f"p={q}: {v['regs']} registers, {v.get('spill', 0)} B spill stores"
                    for q, v in sorted(rows, key=lambda r: r[0])))
        out += [f"  ptxas {name} joint mode: {v['regs']} registers, {v.get('spill', 0)} B spill "
                f"stores" for mangled, v in _ptxas_by_kernel(log).items() if "joint" in mangled]
        return out
    if name == "joint_reml":
        return [f"  ptxas {name}: {v['regs']} registers, {v.get('spill', 0)} B spill stores"
                for v in _ptxas_by_kernel(log).values()]
    if name == "glmm_extras":  # one kernel; its pass function, not inlined, by type
        out = [f"  ptxas {name}: {v['regs']} registers, {v.get('spill', 0)} B spill stores"
               for v in _ptxas_by_kernel(log).values()]
        cur = None
        for line in log.splitlines():
            m = re.search(r"Function properties for \S*extras_passI(\w)E", line)
            if m:
                cur = "f32" if m.group(1) == "f" else "f64"
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
            if cur is not None and m:
                out.append(f"  ptxas {name} pass function {cur}: {m.group(1)} B stack, "
                           f"{m.group(2)} B spill stores")
                cur = None
        return out
    if name == "philox_fill":
        rows = []
        for mangled, v in sorted(_ptxas_by_kernel(log).items()):
            m = re.search(r"kernelILi(\d)ELb(\d)E", mangled)
            tag = f"mode {m.group(1)} {'uint4' if m.group(2) == '1' else 'scalar'}" if m else mangled
            rows.append(f"{tag}: {v['regs']} registers, {v.get('spill', 0)} B spill stores")
        return [f"  ptxas {name} by mode and store: " + ", ".join(rows)] if rows else []
    by_p = _ptxas_by_p(log)
    return [f"  ptxas {name} by p: " + ", ".join(
        f"p={q}: {v['regs']} registers, {v.get('spill', 0)} B spill stores"
        for q, v in sorted(by_p.items()))] if by_p else []


def sass_counts(lib: Path) -> Dict[str, int]:
    """Static SASS instruction count (NOPs left out) of each kernel in a
    built library, from ``cuobjdump -sass``; empty where the toolkit has no
    cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                             timeout=120).stdout
    except (OSError, subprocess.TimeoutExpired):
        return {}
    counts: Dict[str, int] = {}
    cur = None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            counts[cur] = 0
        elif cur is not None and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?!NOP)\S", line):
            counts[cur] += 1
    return counts


def short_kernel_name(mangled: str) -> str:
    """``ols_solve_kernel<7,8>`` from an Itanium-mangled kernel name."""
    m = re.search(r"\d+([a-z][a-z_]*_kernel)(I(?:L[ib]\d+E)+E)?", mangled)
    if not m:
        return mangled
    args = re.findall(r"L[ib](\d+)E", m.group(2) or "")
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


@contextmanager
def kernel_swapped(kernels_mod, name: str, k):
    """Inside the block, kernel ``name``'s wrapper launches ``k``'s library."""
    mine = kernels_mod.KERNELS[name]
    kernels_mod.KERNELS[name] = k
    try:
        yield
    finally:
        kernels_mod.KERNELS[name] = mine


# The launch entries of a kernel whose wrapper launches more than one
# (K2's joint mode has an entry of its own).
LAUNCH_ENTRIES = {"grid_suffstats": ("grid_suffstats", "grid_suffstats_joint")}


def _c_entry_points(source: Path, name: str) -> list:
    """The ``extern "C"`` declarations of kernel ``name``'s launch entries
    (``mcp_<name>``, and those of LAUNCH_ENTRIES) in a source, whitespace
    collapsed: the interfaces its wrappers launch."""
    text = source.read_text()
    return [" ".join(m.split()) for m in re.findall(r'extern "C"[^{]*', text)
            for entry in LAUNCH_ENTRIES.get(name, (name,)) if f" mcp_{entry}(" in m]


# The kernels ``--compare`` builds from another tree: their outputs are held
# to this tree's and timed beside them in phase 5.
COMPARED = ("philox_fill", "ols_solve", "glm_irls", "glmm_intercept", "grid_suffstats",
            "glmm_extras", "joint_reml", "glmm_slope", "slope_reml")
# Those compared on every timing row of their name; K2 is compared in its
# joint and slope modes and K9-K12 at their cases, each in a block of its own.
COMPARED_BY_ROW = ("philox_fill", "ols_solve", "glm_irls", "glmm_intercept")


def other_kernels(kernels_mod, csrc: Path, label: str, names) -> Dict[str, object]:
    """Kernels ``names`` built from another ``csrc`` directory (the parent
    commit's, say) under their own library names, with the same flags. A
    kernel whose C entry points differ from this tree's is left out (this
    tree's wrapper could not call it), and said so."""
    out = {}
    for n in names:
        k = kernels_mod.KERNELS[n]
        if _c_entry_points(csrc / k.source, n) != _c_entry_points(k.csrc / k.source, n):
            print(f"--compare {label}: {k.source} has another C interface than this tree's; "
                  f"not compared", flush=True)
            continue
        out[n] = kernels_mod.Kernel(f"{n}_{label}", k.source, k.flags, csrc=csrc)
    return out


# K6's launch shapes on the path, (sims, max_n, G): the GLM arm's and one
# launch of the logit sample-size flow.
K6_SHAPES = {"GLM arm": (N_SIMS, 300, 1), "logit sample-size flow launch": (N_SIMS // 8, 600, 13)}


def k6_occupancy(kernels_mod) -> list:
    """Lines of K6's launch geometry at p = 1..16 for each of K6_SHAPES, from
    its C launcher (``mcp_glm_irls_occupancy``): resident blocks per SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), threads and dynamic
    shared memory a block, sims a block and rows staged."""
    import ctypes

    fn = kernels_mod.KERNELS["glm_irls"].fn(
        "mcp_glm_irls_occupancy", [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)])
    lines = []
    for tag, (sims, max_n, G) in K6_SHAPES.items():
        row = []
        for p in range(1, kernels_mod.MAX_FIT_P + 1):
            out = (ctypes.c_int * 5)()
            err = fn(p, sims, max_n, G, out)
            check(err == 0, f"K6 occupancy at p = {p}, {tag}: CUDA error {err}")
            row.append(f"p={p}: {out[0]} blocks ({out[0] * out[1] // 32} warps) of {out[1]} "
                       f"threads, {out[2]} B shared, {out[3]} sims, {out[4]} rows staged")
        lines.append(f"  K6 residency per SM at the {tag} ({sims} sims, max_n {max_n}, G {G}): "
                     + "; ".join(row))
    return lines


# K7's launch shapes (sims, max_n, pf, G, m, nagq, hessian): its timed
# shapes, the p = 16 check and the streamed check.
K7_SHAPES = {
    "GLMM Laplace arm": (GLMM_SIMS, 200, 3, 1, 20, 1, 0),
    "GLMM AGQ arm": (GLMM_SIMS, 200, 3, 1, 20, 7, 0),
    "README flow 3 power launch": (N_SIMS // 8, 480, 2, 1, 24, 1, 0),
    "README flow 3 sample-size launch": (N_SIMS // 8, 720, 2, 11, 24, 1, 0),
    "README flow 3 Hessian launch": (N_SIMS // 8, 480, 2, 1, 24, 1, 1),
    "p = 16 check": (64, 400, 16, 1, 20, 1, 0),
    "1,024-cluster check": (64, 2048, 3, 1, 1024, 1, 0),
}


def k7_geometry_line(glmmfit_mod, tag: str, shape) -> str:
    """One line of K7's launch geometry at ``shape`` (K7_SHAPES' order),
    from its C launcher (``mcp_glmm_intercept_geometry``)."""
    g = glmmfit_mod.glmm_intercept_geometry(*shape)
    return (f"  K7 geometry at the {tag} ({shape[0]} sims, max_n {shape[1]}, p {shape[2]}, G "
            f"{shape[3]}, m {shape[4]}, nagq {shape[5]}{', hessian' if shape[6] else ''}): "
            f"{'staged' if g['staged'] else 'streamed'}, {g['warps_per_cell']} warps a cell, "
            f"{g['cells_per_block']} cells a block ({g['threads']} threads, {g['smem']} B shared), "
            f"{g['cells_per_sm']} cells resident per SM, {g['blocks']} blocks in {g['waves']} "
            f"wave(s), scratch {g['scratch']} B")


# K10's launch shapes (sims, max_n, pf, q, G, m) and K11's (cells, M, p,
# groupings (levels, components), dense): their timed shapes.
K10_SHAPES = {
    "glmm_slopes arm": (512, 200, 3, 2, 1, 20),
    "slope-GLMM flow launch": (N_SIMS // 8, 480, 2, 2, 1, 24),
    "slope-GLMM sample-size launch": (N_SIMS // 8, 720, 2, 2, 11, 24),
    "p = 16 check": (16, 240, 16, 4, 1, 24),
    "300-cluster check": (16, 2400, 3, 2, 1, 300),
}
K11_SHAPES = {
    "lmm_extras arm": (EXTRAS_SIMS, 30, 3, ((20, 1), (10, 1)), False),
    "crossed flow launch": (N_SIMS // 8, 65, 3, ((40, 1), (25, 1)), False),
    "nested flow launch": (N_SIMS // 8, 60, 2, ((12, 1), (48, 1)), False),
    "dense extras flow launch": (N_SIMS // 8, 70, 2, ((30, 2), (10, 1)), False),
}


def k10_k11_geometry_lines(glmmfit_mod, mixedfit_mod) -> list:
    """Lines of K10's and K11's launch geometry at their timed shapes, from
    their C launchers (``mcp_glmm_slope_geometry``, ``mcp_joint_reml_geometry``):
    the form, shared bytes, resident cells an SM, waves, and K10's
    registers and local bytes a thread."""
    import torch

    lines = []
    for tag, (sims, max_n, pf, q, G, m) in K10_SHAPES.items():
        X = torch.empty((sims, max_n, 1))
        g = glmmfit_mod.glmm_slope_geometry(0, X, None, list(range(pf)), list(range(q - 1)),
                                            [max_n] * G, (True, m, m))
        lines.append(f"  K10 geometry at the {tag} ({sims} sims, max_n {max_n}, p {pf}, q {q}, "
                     f"G {G}, m {m}): {'shared' if g['form'] == 1 else 'streamed'} form, "
                     f"{g['smem']} + {g['static_smem']} B shared, {g['cells_per_sm']} cells an SM "
                     f"(registers {g['registers']} a thread, held for {g['min_cells_per_sm']}; "
                     f"local {g['local_bytes']} B), {g['waves']} wave(s), p bucket {g['p_bucket']}")
    for tag, (cells, M, p, shape, dense) in K11_SHAPES.items():
        yty = torch.empty(cells)
        g = mixedfit_mod.joint_reml_geometry(torch.empty((1, M, M)), None, None,
                                             torch.empty((1, p, p)), None, yty, None, shape, None,
                                             None, dense=dense)
        lines.append(f"  K11 geometry at the {tag} ({cells} cells, M {M}, p {p}, groupings "
                     f"{list(shape)}): {'structured' if g['structured'] else 'dense'}, "
                     f"{g['warps_per_cell']} warps a cell, twin "
                     f"{'staged' if g['twin_staged'] else 'read from device memory'} "
                     f"({g['twin_bytes']} B), {g['smem']} + {g['static_smem']} B shared, "
                     f"{g['cells_per_sm']} cells an SM (registers {g['registers']} a thread, "
                     f"local {g['local_bytes']} B), {g['waves']} wave(s)")
    return lines


# K9's launch shapes (cells, m, q, p): its timed shapes.
K9_SHAPES = {
    "README flow 2 power launch": (N_SIMS // 8, 30, 2, 2),
    "README flow 2 sample-size launch": (N_SIMS // 8 * 11, 30, 2, 2),
    "lmm_slopes arm": (N_SIMS, 20, 2, 3),
    "lmm_multislope": (GOLDEN_SIMS, 20, 3, 5),
}


def k9_geometry_lines(mixedfit_mod) -> list:
    """Lines of K9's launch geometry at its timed shapes, from its C launcher
    (``mcp_slope_reml_geometry``): the form, shared bytes, resident cells an
    SM, waves, registers and local bytes a thread."""
    import torch

    lines = []
    for tag, (cells, m, q, p) in K9_SHAPES.items():
        g = mixedfit_mod.slope_reml_geometry(torch.empty((1, m, q, q)), None, None,
                                             torch.empty((1, p, p)), None, torch.empty(cells),
                                             None, None, None)
        lines.append(f"  K9 geometry at the {tag} ({cells} cells, m {m}, q {q}, p {p}): "
                     f"{mixedfit_mod.SLOPE_FORMS[g['form']]} form, {g['cells_per_block']} cells a "
                     f"block, {g['smem']} B shared a block "
                     f"({'staged' if g['staged'] else 'streamed'}), {g['cells_per_sm']} cells an "
                     f"SM (registers {g['registers']} a thread, local {g['local_bytes']} B), "
                     f"{g['waves']} wave(s)")
    return lines


def _ptxas_summary(log: str) -> str:
    regs = [int(v) for v in re.findall(r"Used (\d+) registers", log)]
    spills = [int(v) for v in re.findall(r"(\d+) bytes spill stores", log)]
    return (f"max registers {max(regs) if regs else 'n/a'}, "
            f"max spill-store bytes {max(spills) if spills else 0}")


# Flows of a GLM with factors: K6 runs twice a chunk, the second launch the
# separation fallback's over the cells whose first fit failed.
FALLBACK_FLOWS = ("model_logit_factor_sample_size",)

# Flows whose lowered design is (or is set beside) an arm of DESIGNS.
FLOW_DESIGNS = {"model_lmm_power": "lmm_headline", "model_logit_power": "glm_bonferroni_10k"}


def lowered_differences(got, want) -> list:
    """The spec fields and array keys in which two lowered designs differ
    (dtypes included); empty when they are equal."""
    import dataclasses

    (s1, a1), (s2, a2) = got, want
    d1, d2 = dataclasses.asdict(s1), dataclasses.asdict(s2)
    out = [f"spec.{k} ({d1.get(k)!r} vs {d2.get(k)!r})" for k in sorted(set(d1) | set(d2))
           if d1.get(k) != d2.get(k)]
    for k in sorted(set(a1) | set(a2)):
        if k not in a1 or k not in a2:
            out.append(f"array {k} (only in {'the flow' if k in a1 else 'the design'})")
        elif not (np.asarray(a1[k]).dtype == np.asarray(a2[k]).dtype
                  and np.array_equal(a1[k], a2[k], equal_nan=True)):
            out.append(f"array {k}")
    return out


def run_user_flows(smi: str, specs) -> Dict[str, Dict]:
    """Phase 6: each of MODEL_FLOWS through ``MCPower`` on the card. Per
    flow: a first call (the first lowering's scipy tables and the like; the
    kernels are built by then; one chunk's sims for the extras flows, whose
    calls take seconds), the counted call at N_SIMS with every launch
    count set to 0 before it (each kernel of the flow's path must launch),
    GOLDEN_SIMS sims against MODEL_GOLDEN, the whole result tree of
    TREE_SIMS sims against the plain path's on the CPU (``compare_trees``; a
    slope-GLMM flow's on the card, K10's plain version in K10's place), then
    PROFILE_REPS
    walls with the stage split, the chunk count and the busy share, beside
    one ``run_batch`` of the same lowered design in one chunk."""
    import statistics

    from mcpower_tpu_torch import MCPower
    from mcpower_tpu_torch import model as model_mod
    from mcpower_tpu_torch.engine import batch, datagen, kernels
    from mcpower_tpu_torch.orchestrator import runner

    dev = "cuda"
    flows = {}
    for name, (_, _, _, expect) in MODEL_FLOWS.items():
        def run(n=N_SIMS, device=dev, name=name):
            return run_flow(MCPower, name, n, device=device)

        t_flow = time.perf_counter()
        heavy = name in EXTRAS_FLOWS + GLMM_EXTRAS_FLOWS  # seconds a call: lighter profiles
        t0 = time.perf_counter()
        run(N_SIMS // 8 if heavy else N_SIMS)
        first_ms = (time.perf_counter() - t0) * 1e3
        kernels.reset_counts()
        with stage_clock(model_mod, runner, batch) as clock:
            res = run()
        launched, tagged = kernels.counts(), kernels.tagged_counts()
        launched["grid_suffstats_joint"] = tagged.get("grid_suffstats", {}).get("joint", 0)
        got = clock.take()
        lowered = got["lowered"]
        print(f"flow {name}: kernel launches {launched}"
              + (f", of them tagged {tagged}" if tagged else ""), flush=True)
        for k in expect:
            check(launched[k] > 0, f"flow {name}: kernel {k} was not launched")
        fallback = tagged.get("glm_irls", {}).get("fallback", 0)
        if name in FALLBACK_FLOWS:  # a second K6 launch per chunk, over the failed cells
            check(fallback == got["chunks"] and launched["glm_irls"] == 2 * got["chunks"],
                  f"flow {name}: {launched['glm_irls']} K6 launches, {fallback} of them the "
                  f"fallback's, in {got['chunks']} chunks")
        # K1 launches of each chunk, counted by scenario, against each
        # scenario's plan; the kernels line prints the counted values
        k1_per_chunk = k1_launches_per_chunk(name, got["k1_by_chunk"], lowered, datagen)
        check(launched["philox_fill"] == sum(map(sum, got["k1_by_chunk"].values())),
              f"flow {name}: {launched['philox_fill']} K1 launches, "
              f"{got['k1_by_chunk']} counted by chunk")
        for part in res["scenarios"].values() if "scenarios" in res else [res]:
            check(part["n_sims"] == N_SIMS, f"flow {name}: n_sims {part['n_sims']}")
            check(min(part["convergence_rate"]) > 0.9, f"flow {name}: {part['convergence_rate']}")
            powers = np.asarray(part["powers"]["corrected"], dtype=np.float64)
            check(powers.shape == (len(part["sample_sizes"]), len(part["target_labels"]))
                  and bool(np.isfinite(powers).all()), f"flow {name}: powers {powers.shape}")
        res.summary()  # the report renders
        if name in FLOW_DESIGNS:
            differ = lowered_differences(lowered[0], specs[FLOW_DESIGNS[name]])
            print(f"flow {name} lowers to DESIGNS['{FLOW_DESIGNS[name]}']'s spec and arrays: "
                  + ("yes, equal" if not differ else "no, they differ in " + ", ".join(differ)),
                  flush=True)

        card = run(GOLDEN_SIMS)
        pins = (SLOPE_PIN_FLIPS if name in SLOPE_FLOWS else
                SLOPE_GLMM_PIN_FLIPS if name in SLOPE_GLMM_FLOWS else
                EXTRAS_PIN_FLIPS if name in EXTRAS_FLOWS else
                GLMM_EXTRAS_PIN_FLIPS if name in GLMM_EXTRAS_FLOWS else None)
        tau_rel = (SLOPE_GLMM_TAU2_REL if name in SLOPE_GLMM_FLOWS else
                   GLMM_EXTRAS_TAU2_REL if name in GLMM_EXTRAS_FLOWS else
                   GLMM_TAU2_REL if name.startswith("model_glmm") else
                   EXTRAS_TAU2_REL if name in EXTRAS_FLOWS else None)
        if name in GLMM_EXTRAS_FLOWS:  # K12 once a chunk
            check(launched["glmm_extras"] == got["chunks"],
                  f"flow {name}: K12 {launched['glmm_extras']} launches in {got['chunks']} chunks")
        if name in EXTRAS_FLOWS:  # K2's joint mode once a chunk beside its main entry
            check(launched["grid_suffstats_joint"] == got["chunks"]
                  and launched["joint_reml"] == got["chunks"],
                  f"flow {name}: K2's joint mode {launched['grid_suffstats_joint']} and K11 "
                  f"{launched['joint_reml']} launches in {got['chunks']} chunks")
        counts_band = (EXTRAS_COUNT_FLIPS if name in EXTRAS_FLOWS else
                       GLMM_EXTRAS_COUNT_FLIPS if name in GLMM_EXTRAS_FLOWS else None)
        flips = compare_trees(name, flow_summary(card), MODEL_GOLDEN[name], tau_rel=tau_rel,
                              pin_flips=pins, max_flips=counts_band)
        tree_sims = TREE_SIMS_ON_CARD if name in PLAIN_ON_CARD_FLOWS else TREE_SIMS
        card = run(tree_sims)
        if name in SLOPE_GLMM_FLOWS:  # K10's plain version on the card: the CPU's takes minutes
            with k10_plain():
                plain_tree, where = run(tree_sims), "on the card (K10's plain version)"
        elif name in EXTRAS_FLOWS:  # likewise K11's and K2's joint mode's
            with k11_plain():
                plain_tree, where = run(tree_sims), ("on the card (K2's joint mode's and K11's "
                                                     "plain versions)")
        elif name in GLMM_EXTRAS_FLOWS:  # likewise K12's
            with k12_plain():
                plain_tree, where = run(tree_sims), "on the card (K12's plain version)"
        else:
            plain_tree, where = run(TREE_SIMS, "cpu"), "on the CPU"
        tree_flips = compare_trees(name, card, plain_tree, pin_flips=pins, max_flips=counts_band)
        print(f"golden {name} at {GOLDEN_SIMS} sims against the JAX MCPower: "
              f"{'identical' if not flips else 'flips ' + '; '.join(flips)}; whole result tree "
              f"at {tree_sims} sims ({len(tree_keys(card))} keys) against the plain path's "
              f"{where}: {'identical' if not tree_flips else 'flips ' + '; '.join(tree_flips)}",
              flush=True)

        splits = []
        reps = (EXTRAS_PROFILE_REPS if name in EXTRAS_FLOWS else
                GLMM_EXTRAS_PROFILE_REPS if name in GLMM_EXTRAS_FLOWS else PROFILE_REPS)
        with stage_clock(model_mod, runner, batch) as clock:
            prof = profile_arm(run, after_each=lambda: splits.append(clock.take()), reps=reps,
                               profiled=1 if heavy else 2)
        split = {st: statistics.median(s["ms"].get(st, 0.0) for s in splits)
                 for st in ("projection", "lowering", "runner", "run_batch", "packaging")}
        split["other"] = statistics.median(
            w - sum(s["ms"].get(st, 0.0) for st in ("projection", "lowering", "runner",
                                                    "packaging"))
            for w, s in zip(prof["walls"], splits))
        chunks = splits[0]["chunks"]
        one = profile_arm(lambda: [batch.run_batch(sp, ar, N_SIMS, SEED, chunk_size=N_SIMS,
                                                   device=dev) for sp, ar in lowered], reps=reps,
                          profiled=1 if heavy else 2)
        busy = prof["device_ms"] / prof["median_ms"]
        flows[name] = dict(
            wall_median_ms=prof["median_ms"], wall_min_ms=prof["min_ms"],
            wall_max_ms=prof["max_ms"], split_ms=split, chunks=chunks,
            device_ms=prof["device_ms"], device_kernels=prof["launches"], busy=busy,
            one_chunk_run_batch_ms=dict(median=one["median_ms"], min=one["min_ms"],
                                        max=one["max_ms"], busy=one["device_ms"] / one["median_ms"]),
            first_call_ms=first_ms, launches=launched, fallback_launches=fallback,
            golden_flips=flips, k1_launches_per_chunk=k1_per_chunk,
            host_items_ms=dict(prof["host_items"]))
        items = ", ".join(f"{k} {v:.3f}" for k, v in prof["items"])
        host = ", ".join(f"{k} {v:.3f}" for k, v in prof["host_items"])
        print(f"flow {name} ({N_SIMS} sims; {smi}): wall median {prof['median_ms']:.3f} ms "
              f"(range {prof['min_ms']:.3f}-{prof['max_ms']:.3f}, {reps} calls); split "
              f"(medians, ms): projection {split['projection']:.3f}, lowering "
              f"{split['lowering']:.3f}, runner {split['runner']:.3f} (run_batch inside it "
              f"{split['run_batch']:.3f}), packaging {split['packaging']:.3f}, other "
              f"{split['other']:.3f}; {chunks} chunks; device kernel time "
              f"{prof['device_ms']:.3f} ms in {prof['launches']} kernels, busy {busy:.1%} of the "
              f"median wall; K1 launches a chunk {k1_per_chunk}; the same design's run_batch "
              f"in one chunk (per scenario): median "
              f"{one['median_ms']:.3f} ms (range {one['min_ms']:.3f}-{one['max_ms']:.3f}), busy "
              f"{one['device_ms'] / one['median_ms']:.1%}; first call {first_ms:.1f} ms; largest "
              f"device items (ms): {items}; largest host items of the profiled call (self "
              f"time under the profiler, ms): {host}; the flow's phase took "
              f"{time.perf_counter() - t_flow:.1f} s", flush=True)
    return flows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--compare", action="append", default=[], metavar="LABEL=DIR",
                    help="a csrc directory of another tree (the parent commit's, say): build its "
                         "K1, K2, K3, K6, K7 and K9-K12 too, hold their outputs to this tree's "
                         "and time them beside this tree's, in turns; repeatable")
    ap.add_argument("--checks-only", action="store_true",
                    help="stop after phase 3 (build, ptxas, each kernel against its plain "
                         "version), print no result line")
    opts = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    from mcpower_tpu_torch import model as model_mod
    from mcpower_tpu_torch.engine import (
        batch, datagen, glmfit, glmmfit, kernels, lower, mixedfit, olsfit, rng, waldstats,
    )
    from mcpower_tpu_torch.engine.spec import ClusterStatic
    from mcpower_tpu_torch.orchestrator import runner

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # --- phase 1: the card ---
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # --- phase 2: build ---
    took = kernels.build_all()
    others = {}  # label -> K1, K2, K3, K6, K7, K10, K11 and K12 built from that csrc (phase 5's A/B)
    for spec in opts.compare:
        label, _, path = spec.partition("=")
        csrc = Path(path).resolve()
        check(label.isidentifier() and (csrc / "philox_fill.cu").exists(),
              f"--compare {spec}: want LABEL=DIR with DIR/philox_fill.cu")
        others[label] = other_kernels(kernels, csrc, label, COMPARED)
    procs = {(lb, n): k.start_build() for lb, ks in others.items() for n, k in ks.items()}
    for (lb, n), proc in procs.items():
        others[lb][n].finish_build(proc)
    for name, k in list(kernels.KERNELS.items()) + [
            (f"{n} ({lb})", k) for lb, ks in others.items() for n, k in ks.items()]:
        log = k.log_path.read_text() if k.log_path.exists() else ""
        print(f"built {name}: " + (f"{took[name]:.1f} s after start; " if name in took else "")
              + f"{_ptxas_summary(log) if log else 'cached'}", flush=True)
        if log:
            for line in _ptxas_lines(name.split()[0], log):
                print(line, flush=True)
        if name.split()[0] in ("philox_fill", "ols_solve"):
            sass = sorted((short_kernel_name(f), n) for f, n in sass_counts(k.lib_path).items())
            sass.sort(key=lambda kv: [int(a) for a in re.findall(r"\d+", kv[0])])
            print("  SASS instructions (static, cuobjdump): " + (", ".join(
                f"{f} {n}" for f, n in sass) if sass else "not available"), flush=True)

    for line in k6_occupancy(kernels):
        print(line, flush=True)
    for tag, shape in K7_SHAPES.items():
        print(k7_geometry_line(glmmfit, tag, shape), flush=True)
    for line in k10_k11_geometry_lines(glmmfit, mixedfit) + k9_geometry_lines(mixedfit):
        print(line, flush=True)

    # --- phase 3: each kernel against its plain version ---
    specs = {name: lower_design(lower, ClusterStatic, name) for name in DESIGNS}
    arrs = {name: datagen.to_device(a, dev) for name, (s, a) in specs.items()}
    lmm, lmm_arr = specs["lmm_headline"][0], arrs["lmm_headline"]
    curve, curve_arr = specs["curve_5pred_8grid"][0], arrs["curve_5pred_8grid"]
    ols, ols_arr = specs["ols_10k"][0], arrs["ols_10k"]
    sim_ids = torch.arange(N_SIMS, dtype=torch.int64, device=dev)
    records = {}

    k1_err = 0.0
    for name in K1_CHECKS:
        plan_, sim0, seed_hi = k1_table(lower, ClusterStatic, datagen, name)
        n = N_SIMS if name in DESIGNS else GOLDEN_SIMS
        ids = torch.arange(sim0, sim0 + n, dtype=torch.int64, device=dev)
        ulps, launched = [], set()
        for mode in (rng.MODE_WORDS, rng.MODE_OPEN_UNIFORM, rng.MODE_NORMAL):
            # a plan of more than 32 streams takes several K1 launches
            before = kernels.counts()["philox_fill"]
            got = rng.fill_streams_kernel(SEED, seed_hi, ids, plan_, mode)
            launched.add(kernels.counts()["philox_fill"] - before)
            want = rng.fill_streams_plain(SEED, seed_hi, ids, plan_, mode)
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"K1 {name} mode {mode}: {got.shape} {got.dtype} vs {want.shape} {want.dtype}")
            if mode == rng.MODE_WORDS:
                check(torch.equal(got, want), f"K1 {name}: words differ from the plain Philox")
                continue
            ulps.append((got.view(torch.int32).long() - want.view(torch.int32).long()).abs().max().item())
            if mode == rng.MODE_NORMAL:
                k1_err = max(k1_err, (got - want).abs().max().item())
            check(ulps[-1] <= NORMAL_MAX_ULP, f"K1 {name} mode {mode}: {ulps[-1]} ULP from the plain fill")
        launches = -(-len(plan_) // rng.MAX_STREAMS)
        check(launched == {launches}, f"K1 {name}: {launched} launches a fill, {launches} expected")
        print(f"K1 philox_fill {name} ({n} sims from id {sim0}, seed_hi {seed_hi}, plan {plan_}, "
              f"{launches} launch{'es' if launches > 1 else ''} a fill, counted): words identical; "
              f"uniforms and normals max ULP {ulps[0]} and {ulps[1]}", flush=True)
    records["philox_fill"] = {"max_abs_err": k1_err}

    X, y, _ = datagen.generate_batch(lmm, lmm_arr, SEED, 0, sim_ids, plain=True)
    Xo, yo, _ = datagen.generate_batch(ols, ols_arr, SEED, 0, sim_ids, plain=True)
    Xc, yc, _ = datagen.generate_batch(curve, curve_arr, SEED, 0, sim_ids, plain=True)
    lmm_cases = [("lmm", lmm, X, y)]
    for name in LAYOUT_CHECKS:
        spec_, arr_ = lower_design(lower, ClusterStatic, name)
        X_, y_, _ = datagen.generate_batch(spec_, datagen.to_device(arr_, dev), SEED, 0, sim_ids,
                                           plain=True)
        lmm_cases.append((name, spec_, X_, y_))
    k2_cases = [c + (True,) for c in lmm_cases]
    k2_cases += [("ols", ols, Xo, yo, False), ("curve", curve, Xc, yc, False)]
    for name in K2_CHECKS:  # off the path
        spec_, arr_ = lower_design(lower, ClusterStatic, name)
        X_, y_, _ = datagen.generate_batch(spec_, datagen.to_device(arr_, dev), SEED, 0,
                                           sim_ids[:GOLDEN_SIMS], plain=True)
        k2_cases.append((name, spec_, X_, y_, spec_.cluster is not None))
    k2_err = 0.0
    for tag, spec_, X_, y_, clus in k2_cases:
        got = olsfit.grid_suffstats_kernel(spec_, X_, y_, with_clusters=clus)
        want = olsfit.grid_suffstats_plain(spec_, X_, y_, with_clusters=clus)
        check(set(got) == set(want), f"K2 outputs {sorted(got)} != {sorted(want)}")
        rel = max(rel_err(got[k], want[k]) for k in want)
        k2_err = max(k2_err, max((got[k] - want[k]).abs().max().item() for k in want))
        print(f"K2 grid_suffstats {tag} X {tuple(X_.shape)}, G {spec_.n_grid}: max rel err "
              f"{rel:.3e}", flush=True)
        check(rel <= K2_REL, f"K2 {tag}: rel err {rel:.3e} > {K2_REL}")
    records["grid_suffstats"] = {"max_abs_err": k2_err}

    k3_err = 0.0
    k3_args = {}
    arm_xy = {"ols_10k": (ols, Xo, yo), "curve_5pred_8grid": (curve, Xc, yc)}
    for name, c in K3_CHECKS.items():
        if "design" in c:
            spec_, X_, y_ = arm_xy[name]
            suff = olsfit.grid_suffstats_plain(spec_, X_, y_)
            ns = torch.as_tensor(spec_.grid, dtype=torch.float64, device=dev)
            args = (suff["xtx"], suff["xty"], suff["yty"], suff["ysum"], ns)
        else:
            args = tuple(torch.as_tensor(v, device=dev)
                         for v in k3_stats(*k3_synthetic_xy(name, GOLDEN_SIMS)))
            if "mask" in c:  # each cell's reduced fit, with its p_eff
                cm = torch.as_tensor(k3_mask(name, GOLDEN_SIMS), device=dev)
                xtx_, xty_, p_eff = olsfit.reduced_stats(args[0], args[1], cm)
                args = (xtx_, xty_) + args[2:] + (p_eff,)
        k3_args[name] = args
        got = olsfit.ols_solve_kernel(*args)
        want = olsfit.ols_solve_plain(*args)
        check(torch.equal(got[3], want[3]), f"K3 {name}: converged flags differ")
        ok = want[3]
        n_ok, cells = int(ok.sum()), ok.numel()
        if c.get("last") == "dependent":
            check(n_ok == 0, f"K3 {name}: {n_ok} rank-deficient cells converged")
        elif c.get("last") in ("scaled", "collinear"):
            check(0 < n_ok < cells, f"K3 {name}: {n_ok} of {cells} converged, not on both sides")
        elif c.get("last") == "wide":  # fails only where a masked column's unit pivot is the least
            masked = args[5] < c["p"]
            check(0 < int((~ok & masked).sum()) and int((~ok & ~masked).sum()) == 0
                  and int((ok & masked).sum()) > 0,
                  f"K3 {name}: {int((~ok & masked).sum())} masked and {int((~ok & ~masked).sum())} "
                  f"unmasked cells failed, {int((ok & masked).sum())} masked converged")
        else:
            check(n_ok > 0.9 * cells, f"K3 {name}: only {n_ok} of {cells} converged")
        if "mask" in c:
            pinned = torch.as_tensor(k3_mask(name, GOLDEN_SIMS), device=dev) == 0
            check(bool((got[0][pinned & ok[..., None]] == 0).all()),
                  f"K3 {name}: a masked column's beta is not 0")
        rel = t2_rel = 0.0
        if n_ok:  # values where the plain solve converged
            def t2(out):
                return (out[0] ** 2 / torch.diagonal(out[1], dim1=-2, dim2=-1))[ok]
            pairs = [(g[ok], w[ok]) for g, w in zip(got[:3], want[:3])]
            rel = max(rel_err(g, w) for g, w in pairs)
            t2_rel = rel_err(t2(got), t2(want))
            k3_err = max(k3_err, max((g - w).abs().max().item() for g, w in pairs))
        peff = (f", p_eff {float(args[5].min()):.0f}..{float(args[5].max()):.0f} per cell"
                if len(args) > 5 else "")
        print(f"K3 ols_solve {name} cells {tuple(args[2].shape)} p {args[0].shape[-1]}{peff}: flags "
              f"identical ({n_ok} of {cells} converged); over the converged cells max rel err "
              f"{rel:.3e}, t2 {t2_rel:.3e}", flush=True)
        check(max(rel, t2_rel) <= K3_REL, f"K3 {name}: rel err {max(rel, t2_rel):.3e} > {K3_REL}")
    records["ols_solve"] = {"max_abs_err": k3_err}

    k4_cases = []
    for tag, spec_, X_, y_ in lmm_cases:
        suff = olsfit.grid_suffstats_plain(spec_, X_, y_, with_clusters=True)
        ns = torch.as_tensor(spec_.grid, dtype=torch.float64, device=dev)
        k4_cases.append((tag, spec_, (suff["n_j"], suff["s"], suff["t"], suff["xtx"],
                                      suff["xty"], suff["yty"], ns)))
    for i, m in enumerate(K4_SYNTHETIC_M):  # off the path
        k4_cases.append((f"synthetic m={m}", lmm, synthetic_reml_inputs(
            torch, GOLDEN_SIMS, m, 4 if m > 32 else 8, SEED + i, dev)))
    k4_err = 0.0
    for tag, spec_, args in k4_cases:
        got = mixedfit.reml_intercept_kernel(*args)
        want = mixedfit.reml_intercept_plain(*args)
        for i, flag in ((2, "converged"), (3, "boundary"), (5, "boundary_hi")):
            diff = (got[i] != want[i]).reshape(-1)
            n_diff = diff.sum().item()
            if n_diff:
                cells = diff.nonzero().reshape(-1)[:8]
                print(f"K4 {tag}: {flag} differs at cells {cells.tolist()}; plain dev_zero - "
                      f"dev_interior there {pin_margins(torch, mixedfit, args, cells)} "
                      f"against the 1e-10 pin margin", flush=True)
            check(n_diff == 0, f"K4 {tag}: {flag} flags differ in {n_diff} cells")
        beta_rel = rel_err(got[0], want[0])
        t2_rel = rel_err(waldstats.t2_targets(spec_, got[0], got[1]),
                         waldstats.t2_targets(spec_, want[0], want[1]))
        tau_rel = rel_err(got[4], want[4])
        k4_err = max(k4_err, max((got[i] - want[i]).abs().max().item() for i in (0, 1, 4)))
        print(f"K4 reml_intercept {tag} cells {tuple(args[5].shape)} m {args[0].shape[-1]}: "
              f"beta rel {beta_rel:.3e}, t2 rel {t2_rel:.3e}, tau2 rel {tau_rel:.3e}, flags "
              f"identical (boundary {int(got[3].sum())}, converged {int(got[2].sum())})", flush=True)
        check(max(beta_rel, t2_rel) <= K4_REL,
              f"K4 {tag}: rel err {max(beta_rel, t2_rel):.3e} > {K4_REL}")
        if tag == "lmm":
            args_l, cells_l = args, tuple(args[5].shape)  # the main path's, for the timings
    records["reml_intercept"] = {"max_abs_err": k4_err}

    k6_err = 0.0
    k6_args = {}  # name -> (args, keyword arguments)
    for name, c in K6_CHECKS.items():
        kw = {}
        if "design" in c:
            spec_, arr_ = lower_design(lower, ClusterStatic, c["design"])
            arr_d = datagen.to_device(arr_, dev)
            n = c.get("sims", GOLDEN_SIMS)
            X_, y_, _ = datagen.generate_batch(spec_, arr_d, SEED, 0, sim_ids[:n], plain=True)
            fit, grid = list(spec_.effective_fit_cols), list(spec_.grid)
            code = glmfit.link_code(spec_.outcome, spec_.link)
            if c.get("exclusion"):  # each cell's mask, as run_sims makes it
                mc = datagen.factor_min_counts(spec_, X_)
                cm, _ = batch._exclusion_colmask(spec_, mc < spec_.factor_min_level_count)
            else:
                cm = torch.ones((len(grid), len(fit)), dtype=torch.float64, device=dev)
            if "pin" in c:
                cm[:, c["pin"]] = 0.0
            beta0 = glmfit.start_values(spec_, arr_d, y_, cm)
            if c.get("fallback"):  # the second launch, over the cells the first left failed
                first = glmfit.glm_irls_plain(code, X_, y_, fit, grid, beta0, cm)
                beta0, cm = glmfit.fallback_inputs(spec_, y_, cm, mc)
                kw = dict(active=~first[2])
        else:
            X_, y_ = (torch.as_tensor(v, device=dev) for v in k6_synthetic(name, GOLDEN_SIMS))
            fit, grid = list(range(c["p"])), [K6_ROWS]
            cm = torch.ones((1, c["p"]), dtype=torch.float64, device=dev)
            beta0 = torch.zeros((GOLDEN_SIMS, 1, c["p"]), dtype=torch.float64, device=dev)
            beta0[..., 0] = glmfit.data_intercept("binary", "canonical", y_.double().mean(-1, keepdim=True))
            code = glmfit.LINK_LOGIT
        args = (code, X_, y_, fit, grid, beta0, cm)
        k6_args[name] = (args, kw)
        got = glmfit.glm_irls_kernel(*args, iters=True, **kw)
        want = glmfit.glm_irls_plain(*args, iters=True, **kw)
        n_diff = int((got[2] != want[2]).sum())
        check(n_diff == 0, f"K6 {name}: converged flags differ in {n_diff} cells")
        ok = want[2]
        act = kw.get("active", torch.ones_like(ok))
        n_ok, cells, total = int(ok.sum()), int(act.sum()), ok.numel()
        at_cap = int(((want[0].abs() >= glmfit.BETA_CAP - 1e-6).any(-1) & act).sum())
        if c.get("kind") == "dependent":
            check(n_ok == 0, f"K6 {name}: {n_ok} rank-deficient cells converged")
        elif c.get("kind") == "separated":
            check(at_cap > 0.5 * cells and n_ok < 0.5 * cells,
                  f"K6 {name}: {at_cap} of {cells} cells at the cap, {n_ok} converged")
        elif c.get("fallback"):  # the failed cells: few, or (separated) most; the refit rescues
            few = c["design"] != "separated_factor"
            check(0 < cells and (cells < 0.5 * total if few else cells > 0.5 * total)
                  and n_ok > 0.5 * cells,
                  f"K6 {name}: {cells} of {total} cells refit, {n_ok} of them converged")
        elif c.get("exclusion"):
            check(n_ok > 0.5 * cells, f"K6 {name}: only {n_ok} of {cells} converged")
        else:
            check(n_ok > 0.9 * cells, f"K6 {name}: only {n_ok} of {cells} converged")
        if "pin" in c:
            check(bool((got[0][..., c["pin"]] == 0).all() and (want[0][..., c["pin"]] == 0).all()),
                  f"K6 {name}: the pinned column's beta is not 0")
        masks = ""
        if cm.dim() == 3:
            check(bool((got[0][(cm == 0) & act[..., None]] == 0).all()),
                  f"K6 {name}: a masked column's beta is not 0")
            differ = bool((cm != cm[:1]).any())
            check(differ or name != "colmask_per_sim",
                  f"K6 {name}: the column masks do not differ between sims")
            masks = (f"; per-cell masks ({int((cm == 0).any(-1).sum())} cells with a masked "
                     f"column, {'differing' if differ else 'equal'} between sims)")
        rels = {k: rel_err_finite(f"K6 {name} {k}", g, w)
                for k, g, w in zip(("beta", "cov", "dev", "dev0", "ybar"), got[:2] + got[3:6],
                                   want[:2] + want[3:6])}
        it_diff = int((got[6] != want[6]).any(-1).sum())
        k6_err = max(k6_err, max(float((g - w)[torch.isfinite(w)].abs().max())
                                 for g, w in zip(got[:2] + got[3:6], want[:2] + want[3:6])))
        steps = got[6][act].double().mean(0).tolist()
        print(f"K6 glm_irls {name} cells {tuple(got[2].shape)} p {len(fit)} link {code}"
              + (f", {cells} active" if kw else "") + f"{masks}: flags "
              f"identical ({n_ok} of {cells} converged, {at_cap} at the cap); rel err "
              + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
              + f"; mean steps f32 {steps[0]:.2f}, f64 {steps[1]:.2f} (cells whose step counts "
              f"differ from the plain version's: {it_diff})", flush=True)
        check(max(rels.values()) <= K6_REL, f"K6 {name}: rel err {max(rels.values()):.3e} > {K6_REL}")
    records["glm_irls"] = {"max_abs_err": k6_err}

    # K8 on synthetic rows, then on the Poisson design's own rows
    u8, eta8 = k8_synthetic(torch, 1 << 20, dev=dev)
    spec_p, arr_p = lower_design(lower, ClusterStatic, "poisson")
    Xp, _, _ = datagen.generate_batch(spec_p, datagen.to_device(arr_p, dev), SEED, 0,
                                      sim_ids, plain=True)
    eta_p = torch.matmul(Xp, datagen.to_device(arr_p, dev)["effects"].float())
    u_p = rng.fill_streams_plain(SEED, 0, sim_ids, datagen.outcome_plan(spec_p)[1],
                                 rng.MODE_OPEN_UNIFORM)[:, 0]
    k8_err = 0.0
    for tag, u_, eta_ in (("synthetic", u8, eta8), ("poisson design", u_p, eta_p)):
        got = datagen.poisson_quantile_kernel(u_, eta_)
        want = datagen.poisson_quantile_plain(u_, eta_)
        lam = torch.exp(eta_)
        n_diff = int((got != want).sum())
        k8_err = max(k8_err, float((got - want).abs().max()))
        print(f"K8 poisson_quantile {tag} rows {tuple(u_.shape)}: {n_diff} counts differ; rows "
              f"with 0 < lam <= 20: {int(((lam > 0) & (lam <= 20)).sum())}, lam > 20: "
              f"{int((lam > 20).sum())}, lam == 0: {int((lam == 0).sum())}, u at the clamp: "
              f"{int((u_ >= datagen.U_TOP).sum())}; max count {float(want.max()):.0f}", flush=True)
        check(n_diff == 0, f"K8 {tag}: {n_diff} counts differ from the plain version's")
    check(bool(((torch.exp(eta8) == 0) & (u8 >= datagen.U_TOP)).any()
               and ((torch.exp(eta8) > 20) & (u8 >= datagen.U_TOP)).any()),
          "K8's synthetic rows miss a case")
    records["poisson_quantile"] = {"max_abs_err": k8_err}

    # K7 on generated GLMM rows; the Poisson design draws its counts
    # through K8 (generate_batch without plain=)
    k7_args_by = {}
    flow_cases = {name: flow_lowered(flow)[0] for name, (flow, _) in K7_FLOW_CASES.items()}
    k7_err = 0.0
    for name, n in K7_CHECKS.items():
        spec_, arr_ = flow_cases[name] if name in flow_cases else \
            lower_design(lower, ClusterStatic, name)
        arr_d = datagen.to_device(arr_, dev)
        X_, y_, _ = datagen.generate_batch(spec_, arr_d, SEED, 0, sim_ids[:n],
                                           plain=spec_.outcome != "count")
        args = k7_args(spec_, arr_d, X_, y_)
        k7_args_by[name] = args
        geo = glmmfit.glmm_intercept_geometry(X_.shape[0], X_.shape[1], len(args[3]),
                                              len(args[4]), args[5][2], args[7], args[8])
        check(bool(geo["staged"]) == (name not in K7_STREAMED),
              f"K7 {name}: took the {'staged' if geo['staged'] else 'streamed'} path")
        got = glmmfit.glmm_intercept_kernel(*args)
        want = glmmfit.glmm_intercept_plain(*args)
        cells = want[2].numel()
        n_conv, n_bnd = int(want[2].sum()), int(want[3].sum())
        check(n_conv > 0.9 * cells, f"K7 {name}: only {n_conv} of {cells} converged")
        if name == "glmm_boundary":
            check(n_bnd > 0.3 * cells, f"K7 {name}: only {n_bnd} of {cells} cells at the boundary")
        # every output bit for bit: the same entries finite, the rest equal
        diffs = {k: int((~((g == w) | (g.isnan() & w.isnan()))).sum())
                 for k, g, w in zip(("beta", "cov", "converged", "boundary", "tau2", "ybar"),
                                    got, want)}
        k7_err = max(k7_err, max(float((g - w)[torch.isfinite(w)].abs().max())
                                 for g, w in zip(got[:2] + got[4:], want[:2] + want[4:])))
        print(f"K7 glmm_intercept {name} cells {tuple(got[2].shape)} p {len(args[3])} m "
              f"{args[5][2]} ({'round robin' if args[5][0] else 'blocked'}) link {args[0]} nagq "
              f"{args[7]}{' hessian' if args[8] else ''}, "
              f"{'staged' if geo['staged'] else 'streamed'}, {geo['warps_per_cell']} warps a cell, "
              f"{geo['cells_per_sm']} cells per SM: "
              f"{n_conv} converged, {n_bnd} at the boundary; entries that differ from the plain "
              "version: " + ", ".join(f"{k} {v}" for k, v in diffs.items()), flush=True)
        check(not any(diffs.values()),
              f"K7 {name}: outputs differ from the plain version's {diffs}")
    records["glmm_intercept"] = {"max_abs_err": k7_err}

    # K2's slope mode on generated slope designs (p = 3, q = 2; p = 16, q = 4)
    k2s_rows = {}  # name -> (spec, X, y): the --compare A/B's cases
    for name in K2_SLOPE_CHECKS:
        spec_, arr_ = lower_design(lower, ClusterStatic, name)
        X_, y_, _ = datagen.generate_batch(spec_, datagen.to_device(arr_, dev), SEED, 0,
                                           sim_ids[:GOLDEN_SIMS], plain=True)
        k2s_rows[name] = (spec_, X_, y_)
        got = olsfit.grid_suffstats_kernel(spec_, X_, y_, with_slopes=True)
        want = olsfit.grid_suffstats_plain(spec_, X_, y_, with_slopes=True)
        check(set(got) == set(want), f"K2 slope mode outputs {sorted(got)} != {sorted(want)}")
        rel = max(rel_err(got[k], want[k]) for k in want)
        k2_err = max(k2_err, max((got[k] - want[k]).abs().max().item() for k in want))
        print(f"K2 grid_suffstats slope mode {name} X {tuple(X_.shape)}, p "
              f"{len(spec_.effective_fit_cols)}, q {spec_.cluster.q}, m "
              f"{spec_.cluster.n_clusters_at(spec_.max_n)}: max rel err {rel:.3e}", flush=True)
        check(rel <= K2_REL, f"K2 slope mode {name}: rel err {rel:.3e} > {K2_REL}")
    records["grid_suffstats"]["max_abs_err"] = k2_err

    # K9 on the K2 slope-mode statistics of generated rows, bit for bit, in
    # the form its launcher takes and forced into each of its forms
    k9_args_by, k9_out = {}, {}
    flow_cases9 = {name: flow_lowered(flow)[0] for name, (flow, _) in K9_FLOW_CASES.items()}
    k9_err = 0.0
    for name, n in K9_CHECKS.items():
        spec_, arr_ = flow_cases9[name] if name in flow_cases9 else \
            lower_design(lower, ClusterStatic, name)
        X_, y_, _ = datagen.generate_batch(spec_, datagen.to_device(arr_, dev), SEED, 0,
                                           sim_ids[:n], plain=True)
        if name in flow_cases9:
            k2s_rows[name] = (spec_, X_, y_)
        args = k9_args(spec_, olsfit.grid_suffstats_plain(spec_, X_, y_, with_slopes=True))
        k9_args_by[name] = args
        q_, p_, m_ = args[0].shape[-1], args[3].shape[-1], args[0].shape[-3]
        staged = mixedfit.slope_reml_staged(m_, q_, p_)
        check(staged == (name not in K9_STREAMED),
              f"K9 {name}: took the {'staged' if staged else 'streamed'} path")
        got = mixedfit.slope_reml_kernel(*args)
        geo = mixedfit.slope_reml_geometry(*args)
        want = mixedfit.slope_reml_plain(*args)
        k9_out[name] = got
        cells = want[2].numel()
        n_conv, n_bnd = int(want[2].sum()), int(want[3].sum())
        pins = want[5].reshape(-1, q_).sum(0).tolist()
        check(n_conv > 0.9 * cells, f"K9 {name}: only {n_conv} of {cells} converged")
        if name == "slopes_null":
            check(pins[1] > 0.2 * cells, f"K9 {name}: the null slope pinned in {pins[1]} cells")
        diffs = {k: int((~((g == w) | (g.isnan() & w.isnan()))).sum())
                 for k, g, w in zip(("beta", "cov", "converged", "boundary", "tau2", "pinned"),
                                    got, want)}
        k9_err = max(k9_err, max(float((g - w)[torch.isfinite(w)].abs().max())
                                 for g, w in zip(got[:2] + got[4:5], want[:2] + want[4:5])))
        forced = {}
        # every form, forced (the p <= 4 buckets have packed and pair, the p > 4 ones
        # quad only; a form a bucket lacks is not taken): the same bits
        try:
            for form in mixedfit.SLOPE_FORMS:
                mixedfit.slope_reml_set_form(form)
                taken = mixedfit.SLOPE_FORMS[mixedfit.slope_reml_geometry(*args)["form"]]
                again = mixedfit.slope_reml_kernel(*args)
                forced[taken] = sum(int((~((a == b) | (a.isnan() & b.isnan()))).sum())
                                    for a, b in zip(again, want))
        finally:
            mixedfit.slope_reml_set_form(0)
        print(f"K9 slope_reml {name} cells {tuple(got[2].shape)} p {p_} q {q_} m {m_}, "
              f"{'staged' if staged else 'streamed'}, {mixedfit.SLOPE_FORMS[geo['form']]} form: "
              f"{n_conv} converged, {n_bnd} with a pin "
              f"(per component {pins}); entries that differ from the plain version: "
              + ", ".join(f"{k} {v}" for k, v in diffs.items())
              + "; forced into each form: " + ", ".join(f"{k} {v}" for k, v in forced.items()),
              flush=True)
        check(not any(diffs.values()), f"K9 {name}: outputs differ from the plain version's {diffs}")
        check(not any(forced.values()), f"K9 {name}: a forced form differs from the plain "
                                        f"version's {forced}")
    records["slope_reml"] = {"max_abs_err": k9_err}
    k9_div_check(torch, kernels, dev)

    # K10 on generated slope-GLMM rows, bit for bit; the Poisson design
    # draws its counts through K8
    k10_args_by, k10_out = {}, {}
    flow_cases10 = {name: flow_lowered(flow)[0] for name, (flow, _) in K10_FLOW_CASES.items()}
    k10_err = 0.0
    for name, n in K10_CHECKS.items():
        t_case = time.perf_counter()
        spec_, arr_ = flow_cases10[name] if name in flow_cases10 else \
            lower_design(lower, ClusterStatic, name)
        arr_d = datagen.to_device(arr_, dev)
        X_, y_, _ = datagen.generate_batch(spec_, arr_d, SEED, 0, sim_ids[:n],
                                           plain=spec_.outcome != "count")
        args = k10_args(spec_, arr_d, X_, y_)
        k10_args_by[name] = args
        got = glmmfit.glmm_slope_kernel(*args)
        want = glmmfit.glmm_slope_plain(*args)
        k10_out[name] = got
        cells, q_ = want[2].numel(), want[6].shape[-1]
        n_conv, n_bnd = int(want[2].sum()), int(want[3].sum())
        pins = want[6].reshape(-1, q_).sum(0).tolist()
        check(n_conv > 0.9 * cells, f"K10 {name}: only {n_conv} of {cells} converged")
        diffs = {k: int((~((g == w) | (g.isnan() & w.isnan()))).sum())
                 for k, g, w in zip(("beta", "cov", "converged", "boundary", "tau2", "ybar",
                                     "pinned", "theta"), got, want)}
        k10_err = max(k10_err, max(float((g - w)[torch.isfinite(w)].abs().max())
                                   for g, w in zip(got[:2] + got[4:6] + got[7:],
                                                   want[:2] + want[4:6] + want[7:])))
        print(f"K10 glmm_slope {name} cells {tuple(got[2].shape)} p {len(args[3])} q {q_} m "
              f"{args[6][2]} ({'round robin' if args[6][0] else 'blocked'}) link {args[0]}"
              f"{' hessian' if args[10] else ''}: {n_conv} converged, {n_bnd} with a pin (per "
              f"component {pins}); entries that differ from the plain version: "
              + ", ".join(f"{k} {v}" for k, v in diffs.items())
              + f"; {time.perf_counter() - t_case:.1f} s", flush=True)
        check(not any(diffs.values()), f"K10 {name}: outputs differ from the plain version's {diffs}")
    # the cases whose rows and f32 state fit in shared memory, again in the
    # streamed form (state in device scratch, each cluster's rows through the
    # whole chain): the same bits
    glmmfit.glmm_slope_set_form(2)
    try:
        for name in K10_STREAMED_CHECKS:
            again = glmmfit.glmm_slope_kernel(*k10_args_by[name])
            n_diff = sum(int((~((a == b) | (a.isnan() & b.isnan()))).sum())
                         for a, b in zip(again, k10_out[name]))
            print(f"K10 glmm_slope {name} in the streamed form: {n_diff} entries differ from the "
                  f"shared form's", flush=True)
            check(n_diff == 0, f"K10 {name}: the streamed form differs in {n_diff} entries")
    finally:
        glmmfit.glmm_slope_set_form(0)
    records["glmm_slope"] = {"max_abs_err": k10_err}

    # K2's joint mode on generated extras designs: counts exact, the X sums
    # within K2_JOINT_REL
    k2j_err = 0.0
    for name in K2_JOINT_CHECKS:
        spec_, arr_ = lower_design(lower, ClusterStatic, name)
        X_, y_, _ = datagen.generate_batch(spec_, datagen.to_device(arr_, dev), SEED, 0,
                                           sim_ids[:GOLDEN_SIMS], plain=True)
        got = olsfit.joint_suffstats_kernel(spec_, X_, y_)
        want = olsfit.joint_suffstats_plain(spec_, X_, y_)
        check(set(got) == set(want), f"K2 joint mode outputs {sorted(got)} != {sorted(want)}")
        rel = max(rel_err(got[k], want[k]) for k in ("ztz", "ztx", "zty"))
        k2j_err = max(k2j_err, max((got[k] - want[k]).abs().max().item()
                                   for k in ("ztz", "ztx", "zty")))
        groups, M_ = olsfit.joint_layout(spec_)
        q1 = all(not cols for _, _, cols in groups)
        if q1:  # every ztz entry a count
            check(torch.equal(got["ztz"], want["ztz"]), f"K2 joint mode {name}: counts differ")
        print(f"K2 grid_suffstats joint mode {name} X {tuple(X_.shape)}, p "
              f"{len(spec_.effective_fit_cols)}, M {M_} ({len(groups)} groupings"
              f"{', counts exact' if q1 else ''}): max rel err {rel:.3e}", flush=True)
        check(rel <= K2_JOINT_REL, f"K2 joint mode {name}: rel err {rel:.3e} > {K2_JOINT_REL}")
    records["grid_suffstats_joint"] = {"max_abs_err": k2j_err}

    # K11 on K2's joint statistics of generated rows, bit for bit (theta too)
    k11_args_by, k11_out = {}, {}
    flow_cases11 = {name: flow_lowered(flow)[0] for name, (flow, _) in K11_FLOW_CASES.items()}
    k11_err = 0.0
    for name, n in K11_CHECKS.items():
        t_case = time.perf_counter()
        spec_, arr_ = flow_cases11[name] if name in flow_cases11 else \
            lower_design(lower, ClusterStatic, name)
        X_, y_, _ = datagen.generate_batch(spec_, datagen.to_device(arr_, dev), SEED, 0,
                                           sim_ids[:n], plain=True)
        args = k11_args(spec_, olsfit.joint_suffstats_plain(spec_, X_, y_))
        k11_args_by[name] = args
        got = mixedfit.joint_reml_kernel(*args, with_theta=True)
        want = mixedfit.joint_reml_plain(*args, with_theta=True)
        k11_out[name] = got
        cells, nq = want[2].numel(), want[5].shape[-1]
        n_conv, n_bnd = int(want[2].sum()), int(want[3].sum())
        pins = want[5].reshape(-1, nq).sum(0).tolist()
        plan_ = mixedfit.grouping_plan(spec_)
        form = "structured" if mixedfit.plan_all_q1(plan_) else "dense"
        check(n_conv > 0.9 * cells, f"K11 {name}: only {n_conv} of {cells} converged")
        diffs = {k: int((~((g == w) | (g.isnan() & w.isnan()))).sum())
                 for k, g, w in zip(("beta", "cov", "converged", "boundary", "tau2", "pinned",
                                     "theta"), got, want)}
        k11_err = max(k11_err, max(float((g - w)[torch.isfinite(w)].abs().max())
                                   for g, w in zip(got[:2] + got[4:5], want[:2] + want[4:5])))
        print(f"K11 joint_reml {name} cells {tuple(got[2].shape)} p {args[3].shape[-1]} M "
              f"{args[0].shape[-1]} ({form}, groupings {args[7]}): {n_conv} converged, {n_bnd} "
              f"with a pin (per component {pins}); entries that differ from the plain version: "
              + ", ".join(f"{k} {v}" for k, v in diffs.items())
              + f"; {time.perf_counter() - t_case:.1f} s", flush=True)
        check(not any(diffs.values()), f"K11 {name}: outputs differ from the plain version's {diffs}")
    # the structured arm forced through the dense capacitance: at the
    # structured fit's theta, then by its own search
    args, st = k11_args_by["lmm_extras"], k11_out["lmm_extras"]
    at = mixedfit.joint_reml_kernel(*args, theta=st[6], dense=True, with_theta=True)
    at_plain = mixedfit.joint_reml_plain(*args, theta=st[6], dense=True, with_theta=True)
    own = mixedfit.joint_reml_kernel(*args, dense=True, with_theta=True)
    own_plain = mixedfit.joint_reml_plain(*args, dense=True, with_theta=True)
    diffs = [int((a != b).sum()) for a, b in zip(at + own, at_plain + own_plain)]
    fit_rel = max(rel_err(a, b) for a, b in ((at[0], st[0]), (at[1], st[1]), (at[4], st[4])))
    theta_gap = float((own[6] - st[6]).abs().max())
    pin_diff = int((at[5] != st[5]).sum()) + int((own[5] != st[5]).sum())
    print(f"K11 forced-dense A/B of lmm_extras ({st[2].numel()} cells, M {args[0].shape[-1]}): "
          f"the dense form at the structured theta, beta, cov and tau^2 within {fit_rel:.2e} "
          f"relative; its own search's theta within {theta_gap:.2e}; pins that differ "
          f"{pin_diff}; entries that differ from the plain version {sum(diffs)}", flush=True)
    check(not any(diffs), f"K11 forced dense: outputs differ from the plain version's {diffs}")
    check(fit_rel <= EXTRAS_AB_FIT_REL and theta_gap <= EXTRAS_AB_THETA and pin_diff == 0,
          f"K11 forced dense against structured: fit {fit_rel:.2e}, theta {theta_gap:.2e}, pins "
          f"{pin_diff}")
    records["joint_reml"] = {"max_abs_err": k11_err, "forced_dense_ab": dict(
        fit_rel=fit_rel, theta_gap=theta_gap, pins_differ=pin_diff)}
    # K12 on generated rows of GLMM designs with extra groupings, bit for bit
    # (theta too); the Poisson design draws its counts through K8. The plain
    # version's one call is timed by CUDA events (phase 5 reports it beside
    # the kernel at the main path's shapes)
    k12_args_by, k12_out, k12_plain_ms = {}, {}, {}
    flow_cases12 = {name: flow_lowered(flow)[0] for name, (flow, _) in K12_FLOW_CASES.items()}
    k12_err = 0.0
    for name, n in K12_CHECKS.items():
        t_case = time.perf_counter()
        spec_, arr_ = flow_cases12[name] if name in flow_cases12 else \
            lower_design(lower, ClusterStatic, name)
        arr_d = datagen.to_device(arr_, dev)
        X_, y_, _ = datagen.generate_batch(spec_, arr_d, SEED, 0, sim_ids[:n],
                                           plain=spec_.outcome != "count")
        args = k12_args(spec_, arr_d, X_, y_)
        k12_args_by[name] = args
        got = glmmfit.glmm_extras_kernel(*args)
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        want = glmmfit.glmm_extras_plain(*args)
        ev1.record()
        torch.cuda.synchronize()
        k12_plain_ms[name] = ev0.elapsed_time(ev1)
        k12_out[name] = got
        cells, nq = want[2].numel(), want[6].shape[-1]
        n_conv, n_bnd = int(want[2].sum()), int(want[3].sum())
        pins = want[6].reshape(-1, nq).sum(0).tolist()
        plan_ = mixedfit.grouping_plan(spec_)
        form = "structured" if mixedfit.plan_all_q1(plan_) else "dense"
        check(n_conv > 0.9 * cells, f"K12 {name}: only {n_conv} of {cells} converged")
        diffs = {k: int((~((g == w) | (g.isnan() & w.isnan()))).sum())
                 for k, g, w in zip(("beta", "cov", "converged", "boundary", "tau2", "ybar",
                                     "pinned", "theta"), got, want)}
        k12_err = max(k12_err, max(float((g - w)[torch.isfinite(w)].abs().max())
                                   for g, w in zip(got[:2] + got[4:6] + got[7:],
                                                   want[:2] + want[4:6] + want[7:])))
        print(f"K12 glmm_extras {name} cells {tuple(got[2].shape)} p {len(args[3])} M "
              f"{mixedfit.joint_width(plan_)} ({form}, groupings "
              f"{[(int(m), 1 + len(c)) for _, m, c in args[5]]}) link {args[0]}"
              f"{' hessian' if args[9] else ''}: {n_conv} converged, {n_bnd} with a pin (per "
              f"component {pins}); entries that differ from the plain version: "
              + ", ".join(f"{k} {v}" for k, v in diffs.items())
              + f"; plain {k12_plain_ms[name]:.0f} ms; {time.perf_counter() - t_case:.1f} s",
              flush=True)
        check(not any(diffs.values()), f"K12 {name}: outputs differ from the plain version's {diffs}")
    # the structured arm forced through the dense capacitance at the
    # structured fit's theta
    args, st = k12_args_by["glmm_extras"], k12_out["glmm_extras"]
    at = glmmfit.glmm_extras_kernel(*args, theta=st[7], dense=True)
    at_plain = glmmfit.glmm_extras_plain(*args, theta=st[7], dense=True)
    diffs = [int((~((a == b) | (a.isnan() & b.isnan()))).sum()) for a, b in zip(at, at_plain)]
    fit_rel = max(rel_err(a, b) for a, b in ((at[0], st[0]), (at[1], st[1]), (at[4], st[4])))
    flag_diff = sum(int((a != b).sum()) for a, b in ((at[2], st[2]), (at[3], st[3]),
                                                      (at[6], st[6])))
    M_ = sum(int(m) * (1 + len(c)) for _, m, c in args[5])
    print(f"K12 forced-dense A/B of glmm_extras ({st[2].numel()} cells, M {M_}): "
          f"the dense form at the structured theta, beta, cov and tau^2 within {fit_rel:.2e} "
          f"relative; flags and pins that differ {flag_diff}; entries that differ from the plain "
          f"version {sum(diffs)}", flush=True)
    check(not any(diffs), f"K12 forced dense: outputs differ from the plain version's {diffs}")
    check(fit_rel <= GLMM_EXTRAS_AB_FIT_REL and flag_diff == 0,
          f"K12 forced dense against structured: fit {fit_rel:.2e}, flags {flag_diff}")
    records["glmm_extras"] = {"max_abs_err": k12_err, "forced_dense_ab": dict(
        fit_rel=fit_rel, flags_differing=flag_diff)}

    torch.cuda.synchronize()
    print(f"phase 3 done at {time.perf_counter() - t_start:.1f} s", flush=True)
    if opts.checks_only:
        return 0

    # --- phase 4: the main path through the kernels ---
    arm_s = {}
    for name in DESIGNS:  # warm-up at the timed shapes, before counting
        spec_, arr_ = specs[name]
        batch.run_batch(spec_, arr_, N_SIMS, 1, chunk_size=N_SIMS, device=dev)
    launches_by_arm = {}
    for name in DESIGNS:
        spec_, arr_ = specs[name]
        kernels.reset_counts()
        t0 = time.perf_counter()
        counts = batch.run_batch(spec_, arr_, N_SIMS, SEED, chunk_size=N_SIMS, device=dev)
        arm_s[name] = time.perf_counter() - t0
        launches_by_arm[name] = kernels.counts()
        check(int(counts["n_done"]) == N_SIMS, f"{name}: n_done {counts['n_done']}")
        conv = np.asarray(counts["converged"])
        check(bool((conv > 0.9 * N_SIMS).all()), f"{name}: converged {conv.tolist()}")
        for key, v in counts.items():
            check(bool(np.isfinite(np.asarray(v, dtype=np.float64)).all()), f"{name}: {key} not finite")
        power = np.asarray(counts["sig_unc"])[-1] / N_SIMS
        print(f"arm {name}: {arm_s[name] * 1e3:.1f} ms for {N_SIMS} sims through the kernels; "
              f"power at N={spec_.max_n}: {np.round(power, 4).tolist()}", flush=True)
    launches = {k: sum(v[k] for v in launches_by_arm.values()) for k in kernels.KERNELS}
    print(f"kernel launches on the main path, by arm: {launches_by_arm}", flush=True)
    for name in ARM_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched on the main path")
    glm_launches = launches_by_arm["glm_bonferroni_10k"]
    check(glm_launches["philox_fill"] == 2 and glm_launches["glm_irls"] == 1,
          f"glm_bonferroni_10k: K1 launched {glm_launches['philox_fill']} times (2 expected), "
          f"K6 {glm_launches['glm_irls']} (1 expected)")

    def check_golden(name, spec_, arr_):
        counts = batch.run_batch(spec_, arr_, GOLDEN_SIMS, SEED, chunk_size=GOLDEN_SIMS, device=dev)
        flips = []
        for key, want in GOLDEN[name].items():
            got = np.asarray(counts[key])
            want = np.asarray(want)
            check(got.shape == want.shape, f"{name} {key}: shape {got.shape} != {want.shape}")
            if key in ("tau2_hat", "glm_baseline"):
                band = (GLM_BASELINE_REL if key == "glm_baseline" else
                        GLMM_EXTRAS_TAU2_REL if name in GLMM_EXTRAS_DESIGNS else
                        GLMM_TAU2_REL if name in GLMM_DESIGNS else
                        SLOPE_GLMM_TAU2_REL if name in SLOPE_GLMM_DESIGNS else
                        EXTRAS_TAU2_REL if name in EXTRAS_DESIGNS else TAU2_REL)
                rel = float(np.abs(got - want).max() / np.abs(want).max())
                check(rel <= band, f"{name} {key} rel {rel:.2e} > {band}")
                continue
            diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
            if diff.max() > 0:
                flips.append(f"{key}: max {int(diff.max())} at {np.argwhere(diff > 0).tolist()}")
            band = (SLOPE_PIN_FLIPS if name in SLOPE_DESIGNS and key in ("pinned_comp",
                                                                        "boundary_hit")
                    else SLOPE_GLMM_PIN_FLIPS if name in SLOPE_GLMM_DESIGNS and key in (
                        "pinned_comp", "boundary_hit", "singular")
                    else EXTRAS_PIN_FLIPS if name in EXTRAS_DESIGNS and key in (
                        "pinned_comp", "boundary_hit")
                    else EXTRAS_COUNT_FLIPS if name in EXTRAS_DESIGNS
                    else GLMM_EXTRAS_PIN_FLIPS if name in GLMM_EXTRAS_DESIGNS and key in (
                        "pinned_comp", "boundary_hit", "singular")
                    else GLMM_EXTRAS_COUNT_FLIPS if name in GLMM_EXTRAS_DESIGNS
                    else MAX_FLIPS)
            check(int(diff.max()) <= band, f"{name} {key}: {got.tolist()} vs golden {want.tolist()}")
        extra = set(counts) - set(GOLDEN[name])
        check(not extra, f"{name}: counts {sorted(extra)} not in the golden set")
        print(f"golden {name} at {GOLDEN_SIMS} sims: "
              f"{'identical' if not flips else 'flips ' + '; '.join(flips)}", flush=True)

    for name in DESIGNS:
        check_golden(name, *specs[name])

    # The scenario arm: SCENARIO_SIMS sims through the kernels, counted on
    # their own; the rejection rate against the NumPy oracle; the
    # GOLDEN_SIMS counts against the reference's.
    scenario_arms = {}
    for name in SCENARIO_ARMS:
        spec_, arr_ = lower_design(lower, ClusterStatic, name)
        batch.run_batch(spec_, arr_, N_SIMS, 1, chunk_size=N_SIMS, device=dev)  # warm-up
        kernels.reset_counts()
        with stage_clock(model_mod, runner, batch) as clock:
            t0 = time.perf_counter()
            counts = batch.run_batch(spec_, arr_, SCENARIO_SIMS, SEED, chunk_size=N_SIMS,
                                     device=dev)
            wall = time.perf_counter() - t0
        launches_by_arm[name] = kernels.counts()
        for k in ("philox_fill", "grid_suffstats", "ols_solve"):
            check(launches_by_arm[name][k] > 0, f"{name}: kernel {k} was not launched")
        got = clock.take()
        chunks = got["chunks"]
        check(chunks == -(-SCENARIO_SIMS // N_SIMS), f"{name}: {chunks} chunks")
        k1_per_chunk = k1_launches_per_chunk(name, got["k1_by_chunk"], [(spec_, arr_)], datagen)
        k1_per_chunk = k1_per_chunk[spec_.scenario.label]
        check(int(counts["n_done"]) == SCENARIO_SIMS, f"{name}: n_done {counts['n_done']}")
        p_hat = float(counts["sig_unc"][0, 0]) / SCENARIO_SIMS
        t0 = time.perf_counter()
        oracle = composed_scenario_oracle()
        check(abs(p_hat - oracle) < SCENARIO_POWER_PP,
              f"{name}: power {p_hat:.4f} against the oracle's {oracle:.4f}")
        scenario_arms[name] = dict(power=p_hat, oracle=oracle, wall_ms=wall * 1e3,
                                   k1_launches_per_chunk=k1_per_chunk)
        print(f"arm {name}: {wall * 1e3:.1f} ms for {SCENARIO_SIMS} sims through the kernels "
              f"({chunks} chunks, K1 launches {k1_per_chunk} a chunk, counted: "
              f"{datagen.fill_plan(spec_)}); power {p_hat:.4f}, NumPy oracle "
              f"({ORACLE_DRAWS} draws, {time.perf_counter() - t0:.1f} s) {oracle:.4f}, "
              f"within {SCENARIO_POWER_PP:.0%}", flush=True)
        check_golden(name, spec_, arr_)
        for k in launches:
            launches[k] += launches_by_arm[name][k]

    # The GLMM arms: one chunk of GLMM_SIMS sims each, through K1 and K7
    glmm_specs = {name: lower_design(lower, ClusterStatic, name) for name in GLMM_DESIGNS}
    glmm_arm_s = {}
    for name, (spec_, arr_) in glmm_specs.items():
        batch.run_batch(spec_, arr_, GLMM_SIMS, 1, chunk_size=GLMM_SIMS, device=dev)  # warm-up
        kernels.reset_counts()
        t0 = time.perf_counter()
        counts = batch.run_batch(spec_, arr_, GLMM_SIMS, SEED, chunk_size=GLMM_SIMS, device=dev)
        glmm_arm_s[name] = time.perf_counter() - t0
        launches_by_arm[name] = kernels.counts()
        got_l = launches_by_arm[name]
        check(got_l["glmm_intercept"] == 1 and got_l["philox_fill"] == 2,
              f"{name}: K7 launched {got_l['glmm_intercept']} times (1 expected), K1 "
              f"{got_l['philox_fill']} (2 expected)")
        check(int(counts["n_done"]) == GLMM_SIMS, f"{name}: n_done {counts['n_done']}")
        conv = np.asarray(counts["converged"])
        check(bool((conv > 0.9 * GLMM_SIMS).all()), f"{name}: converged {conv.tolist()}")
        for key, v in counts.items():
            check(bool(np.isfinite(np.asarray(v, dtype=np.float64)).all()), f"{name}: {key} not finite")
        power = np.asarray(counts["sig_unc"])[-1] / GLMM_SIMS
        print(f"arm {name}: {glmm_arm_s[name] * 1e3:.1f} ms for {GLMM_SIMS} sims through the "
              f"kernels (one chunk; launches {got_l}); power at N={spec_.max_n}: "
              f"{np.round(power, 4).tolist()}, boundary fits "
              f"{int(np.asarray(counts['boundary_hit'])[-1])}", flush=True)
        check_golden(name, spec_, arr_)
        for k in launches:
            launches[k] += got_l[k]

    # The random-slope arm: one chunk of N_SIMS sims through K1, K2's slope
    # mode and K9
    slope_specs = {name: lower_design(lower, ClusterStatic, name) for name in SLOPE_DESIGNS}
    slope_arm_s = {}
    for name, (spec_, arr_) in slope_specs.items():
        batch.run_batch(spec_, arr_, N_SIMS, 1, chunk_size=N_SIMS, device=dev)  # warm-up
        kernels.reset_counts()
        t0 = time.perf_counter()
        counts = batch.run_batch(spec_, arr_, N_SIMS, SEED, chunk_size=N_SIMS, device=dev)
        slope_arm_s[name] = time.perf_counter() - t0
        launches_by_arm[name] = got_l = kernels.counts()
        check(got_l["slope_reml"] == 1 and got_l["grid_suffstats"] == 1
              and got_l["philox_fill"] == 1,
              f"{name}: K9 launched {got_l['slope_reml']} times, K2 {got_l['grid_suffstats']}, "
              f"K1 {got_l['philox_fill']} (1 each expected)")
        check(int(counts["n_done"]) == N_SIMS, f"{name}: n_done {counts['n_done']}")
        conv = np.asarray(counts["converged"])
        check(bool((conv > 0.9 * N_SIMS).all()), f"{name}: converged {conv.tolist()}")
        for key, v in counts.items():
            check(bool(np.isfinite(np.asarray(v, dtype=np.float64)).all()), f"{name}: {key} not finite")
        power = np.asarray(counts["sig_unc"])[-1] / N_SIMS
        print(f"arm {name}: {slope_arm_s[name] * 1e3:.1f} ms for {N_SIMS} sims through the "
              f"kernels (one chunk; launches {got_l}); power at N={spec_.max_n}: "
              f"{np.round(power, 4).tolist()}, pins per component "
              f"{np.asarray(counts['pinned_comp'])[-1].tolist()}", flush=True)
        check_golden(name, spec_, arr_)
        for k in launches:
            launches[k] += got_l[k]

    # The slope-GLMM arm: one chunk of SLOPE_GLMM_SIMS sims through K1 and
    # K10; at GOLDEN_SIMS the reference's counts and the plain path's on the
    # card (every kernel's plain version), count for count
    slope_glmm_specs = {name: lower_design(lower, ClusterStatic, name)
                        for name in SLOPE_GLMM_DESIGNS}
    slope_glmm_arm_s = {}
    for name, (spec_, arr_) in slope_glmm_specs.items():
        batch.run_batch(spec_, arr_, SLOPE_GLMM_SIMS, 1, chunk_size=SLOPE_GLMM_SIMS,
                        device=dev)  # warm-up
        kernels.reset_counts()
        t0 = time.perf_counter()
        counts = batch.run_batch(spec_, arr_, SLOPE_GLMM_SIMS, SEED, chunk_size=SLOPE_GLMM_SIMS,
                                 device=dev)
        slope_glmm_arm_s[name] = time.perf_counter() - t0
        launches_by_arm[name] = got_l = kernels.counts()
        check(got_l["glmm_slope"] == 1 and got_l["philox_fill"] == 2,
              f"{name}: K10 launched {got_l['glmm_slope']} times (1 expected), K1 "
              f"{got_l['philox_fill']} (2 expected)")
        check(int(counts["n_done"]) == SLOPE_GLMM_SIMS, f"{name}: n_done {counts['n_done']}")
        conv = np.asarray(counts["converged"])
        check(bool((conv > 0.9 * SLOPE_GLMM_SIMS).all()), f"{name}: converged {conv.tolist()}")
        for key, v in counts.items():
            check(bool(np.isfinite(np.asarray(v, dtype=np.float64)).all()), f"{name}: {key} not finite")
        power = np.asarray(counts["sig_unc"])[-1] / SLOPE_GLMM_SIMS
        print(f"arm {name}: {slope_glmm_arm_s[name] * 1e3:.1f} ms for {SLOPE_GLMM_SIMS} sims "
              f"through the kernels (one chunk; launches {got_l}); power at N={spec_.max_n}: "
              f"{np.round(power, 4).tolist()}, pins per component "
              f"{np.asarray(counts['pinned_comp'])[-1].tolist()}", flush=True)
        check_golden(name, spec_, arr_)
        card = batch.run_batch(spec_, arr_, TREE_SIMS_ON_CARD, SEED, chunk_size=TREE_SIMS_ON_CARD,
                               device=dev)
        plain_c = batch.run_batch(spec_, arr_, TREE_SIMS_ON_CARD, SEED,
                                  chunk_size=TREE_SIMS_ON_CARD, device=dev, plain=True)
        differ = [k for k in plain_c if not np.array_equal(np.asarray(card[k]),
                                                           np.asarray(plain_c[k]))]
        check(sorted(card) == sorted(plain_c) and not differ,
              f"{name}: the card's counts differ from the plain path's in {differ}")
        print(f"arm {name} at {TREE_SIMS_ON_CARD} sims: every count the plain path's on the "
              f"card", flush=True)
        for k in launches:
            launches[k] += got_l[k]

    # The extras arms: one chunk of EXTRAS_SIMS sims each through K1, K2
    # (twice: its main entry, then its joint mode) and K11; at GOLDEN_SIMS
    # the reference's counts and the plain path's on the card (K2's joint
    # statistics and the plain ones differ in the last bits of the X sums,
    # so the counts hold to the golden bands, and were equal at every run)
    extras_specs = {name: lower_design(lower, ClusterStatic, name) for name in EXTRAS_DESIGNS}
    extras_arm_s = {}
    launches["grid_suffstats_joint"] = 0
    for name, (spec_, arr_) in extras_specs.items():
        batch.run_batch(spec_, arr_, EXTRAS_SIMS, 1, chunk_size=EXTRAS_SIMS, device=dev)  # warm-up
        kernels.reset_counts()
        t0 = time.perf_counter()
        counts = batch.run_batch(spec_, arr_, EXTRAS_SIMS, SEED, chunk_size=EXTRAS_SIMS,
                                 device=dev)
        extras_arm_s[name] = time.perf_counter() - t0
        got_l = kernels.counts()
        got_l["grid_suffstats_joint"] = kernels.tagged_counts().get(
            "grid_suffstats", {}).get("joint", 0)
        launches_by_arm[name] = got_l
        check(got_l["joint_reml"] == 1 and got_l["grid_suffstats"] == 2
              and got_l["grid_suffstats_joint"] == 1 and got_l["philox_fill"] == 1,
              f"{name}: K11 launched {got_l['joint_reml']} times, K2 {got_l['grid_suffstats']} "
              f"(joint mode {got_l['grid_suffstats_joint']}), K1 {got_l['philox_fill']} (1, 2 "
              f"(1), 1 expected)")
        check(int(counts["n_done"]) == EXTRAS_SIMS, f"{name}: n_done {counts['n_done']}")
        conv = np.asarray(counts["converged"])
        check(bool((conv > 0.9 * EXTRAS_SIMS).all()), f"{name}: converged {conv.tolist()}")
        for key, v in counts.items():
            check(bool(np.isfinite(np.asarray(v, dtype=np.float64)).all()), f"{name}: {key} not finite")
        power = np.asarray(counts["sig_unc"])[-1] / EXTRAS_SIMS
        print(f"arm {name}: {extras_arm_s[name] * 1e3:.1f} ms for {EXTRAS_SIMS} sims through the "
              f"kernels (one chunk; launches {got_l}); power at N={spec_.max_n}: "
              f"{np.round(power, 4).tolist()}, pins per component "
              f"{np.asarray(counts['pinned_comp'])[-1].tolist()}", flush=True)
        check_golden(name, spec_, arr_)
        card = batch.run_batch(spec_, arr_, TREE_SIMS_ON_CARD, SEED, chunk_size=TREE_SIMS_ON_CARD,
                               device=dev)
        plain_c = batch.run_batch(spec_, arr_, TREE_SIMS_ON_CARD, SEED,
                                  chunk_size=TREE_SIMS_ON_CARD, device=dev, plain=True)
        check(sorted(card) == sorted(plain_c), f"{name}: count sets differ")
        differ = {}
        for k in plain_c:
            g, w = np.asarray(card[k], np.float64), np.asarray(plain_c[k], np.float64)
            if k == "tau2_hat":
                rel = float(np.abs(g - w).max() / np.abs(w).max())
                check(rel <= EXTRAS_TAU2_REL, f"{name}: tau2_hat rel {rel:.2e} to the plain path")
            elif not np.array_equal(g, w):
                differ[k] = int(np.abs(g - w).max())
                band = EXTRAS_PIN_FLIPS if k in ("pinned_comp", "boundary_hit") else \
                    EXTRAS_COUNT_FLIPS
                check(differ[k] <= band, f"{name}: {k} {g.tolist()} vs the plain path's {w.tolist()}")
        print(f"arm {name} at {TREE_SIMS_ON_CARD} sims against the plain path's on the card: "
              + (f"flips {differ}" if differ else "every count equal"), flush=True)
        for k in launches:
            launches[k] += got_l[k]

    # The GLMM extras arms: one chunk of GLMM_EXTRAS_SIMS sims each through
    # K1 (twice: the normals, then the outcome's words) and K12; at
    # GOLDEN_SIMS the reference's counts (phase 3 held K12 to its plain
    # version at the arm's own cells, phase 6 holds the flows' trees to the
    # plain path's)
    glmm_extras_specs = {name: lower_design(lower, ClusterStatic, name)
                         for name in GLMM_EXTRAS_DESIGNS}
    glmm_extras_arm_s = {}
    for name, (spec_, arr_) in glmm_extras_specs.items():
        batch.run_batch(spec_, arr_, GLMM_EXTRAS_SIMS, 1, chunk_size=GLMM_EXTRAS_SIMS,
                        device=dev)  # warm-up
        kernels.reset_counts()
        t0 = time.perf_counter()
        counts = batch.run_batch(spec_, arr_, GLMM_EXTRAS_SIMS, SEED,
                                 chunk_size=GLMM_EXTRAS_SIMS, device=dev)
        glmm_extras_arm_s[name] = time.perf_counter() - t0
        launches_by_arm[name] = got_l = kernels.counts()
        check(got_l["glmm_extras"] == 1 and got_l["philox_fill"] == 2,
              f"{name}: K12 launched {got_l['glmm_extras']} times (1 expected), K1 "
              f"{got_l['philox_fill']} (2 expected)")
        check(int(counts["n_done"]) == GLMM_EXTRAS_SIMS, f"{name}: n_done {counts['n_done']}")
        conv = np.asarray(counts["converged"])
        check(bool((conv > 0.9 * GLMM_EXTRAS_SIMS).all()), f"{name}: converged {conv.tolist()}")
        for key, v in counts.items():
            check(bool(np.isfinite(np.asarray(v, dtype=np.float64)).all()), f"{name}: {key} not finite")
        power = np.asarray(counts["sig_unc"])[-1] / GLMM_EXTRAS_SIMS
        print(f"arm {name}: {glmm_extras_arm_s[name] * 1e3:.1f} ms for {GLMM_EXTRAS_SIMS} sims "
              f"through the kernels (one chunk; launches {got_l}); power at N={spec_.max_n}: "
              f"{np.round(power, 4).tolist()}, pins per component "
              f"{np.asarray(counts['pinned_comp'])[-1].tolist()}", flush=True)
        check_golden(name, spec_, arr_)
        for k in launches:
            launches[k] += got_l.get(k, 0)

    print(f"phase 4 done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # --- phase 5: timings at the main path's shapes ---
    reps = 20
    # K2's yardstick: one batched Gram of the f64 [X | y] at the OLS shape,
    # whose column 0 is the intercept, so it holds xtx, xty, yty and ysum.
    # The upcast happens here, outside the timed window.
    A = torch.cat([Xo[..., list(ols.effective_fit_cols)], yo[..., None]], dim=-1).to(torch.float64)
    gram = torch.bmm(A.transpose(1, 2), A)
    ref = olsfit.grid_suffstats_plain(ols, Xo, yo)
    pf_o = len(ols.effective_fit_cols)
    lib_rel = max(rel_err(gram[:, :pf_o, :pf_o], ref["xtx"][:, 0]),
                  rel_err(gram[:, :pf_o, pf_o], ref["xty"][:, 0]),
                  rel_err(gram[:, pf_o, pf_o], ref["yty"][:, 0]),
                  rel_err(gram[:, 0, pf_o], ref["ysum"][:, 0]))
    print(f"library yardstick torch.bmm of [X | y] {tuple(A.shape)} f64: rel err {lib_rel:.3e} "
          f"against the plain statistics", flush=True)
    check(lib_rel <= K2_REL, f"the bmm yardstick differs from the plain K2 by {lib_rel:.3e}")

    def k2(spec_, clus):  # K2's kernel and plain version, taking (X, y)
        return (lambda X_, y_: olsfit.grid_suffstats_kernel(spec_, X_, y_, with_clusters=clus),
                lambda X_, y_: olsfit.grid_suffstats_plain(spec_, X_, y_, with_clusters=clus))

    def k1(plan_):  # K1's kernel and plain version at a plan, taking the sim ids
        return (lambda ids: rng.fill_streams_kernel(SEED, 0, ids, plan_, rng.MODE_NORMAL),
                lambda ids: rng.fill_streams_plain(SEED, 0, ids, plan_, rng.MODE_NORMAL))

    timing = []  # (record, shape, kernel, plain, inputs, (bound ms, bound by), library call)
    bound_lines = []
    # K1 at the arms' fills and at the realistic LMM's (model_lmm_scenarios):
    # its long normals, the largest of its fills, and its short normals
    fills_lr = datagen.fill_plan(lower_design(lower, ClusterStatic, "lmm_realistic")[0])
    k1_plans = [(arm, datagen.stream_plan(specs[name][0])) for arm, name in (
        ("lmm", "lmm_headline"), ("ols", "ols_10k"), ("curve", "curve_5pred_8grid"))]
    k1_plans += [("lmm_realistic", fills_lr[0][1]), ("short", fills_lr[1][1])]
    for arm, plan_ in k1_plans:
        z = k1(plan_)[0](sim_ids)
        new_b, old_b = k1_bound(plan_, N_SIMS, z), k1_bound_padded(z)
        bound_lines.append(f"{arm} {new_b[0]:.4f} ms ({new_b[1]}; padded {old_b[0]:.4f} ms)")
        timing.append((f"philox_fill {arm}", f"{N_SIMS} sims x {len(plan_)} streams x "
                       f"{z.shape[-1]} rows, {sum(r for _, _, r in plan_)} real rows a sim",
                       *k1(plan_), (sim_ids,), new_b, None))
    print("K1 bound, real rows (one cipher per sim key and per block below ceil(rows / 4), one "
          "ppf per real normal; the padded figure, every output word a quarter cipher and a ppf, "
          "beside it): " + ", ".join(bound_lines), flush=True)
    timing += [
        ("grid_suffstats lmm", f"LMM X {tuple(X.shape)}, m 20, G 1", *k2(lmm, True), (X, y),
         k2_bound(lmm, X, y, olsfit.grid_suffstats_kernel(lmm, X, y, with_clusters=True)), None),
        ("grid_suffstats ols", f"OLS X {tuple(Xo.shape)}, G 1", *k2(ols, False), (Xo, yo),
         k2_bound(ols, Xo, yo, ref), (lambda A_: torch.bmm(A_.transpose(1, 2), A_), (A,))),
        ("grid_suffstats curve", f"curve X {tuple(Xc.shape)}, G 8", *k2(curve, False), (Xc, yc),
         k2_bound(curve, Xc, yc, olsfit.grid_suffstats_kernel(curve, Xc, yc)), None),
    ]
    # K3 at a launch of the README model's find_sample_size: one chunk of
    # N_SIMS / 8 sims on its 12-point grid, p 6, each cell's p_eff
    spec_r, arr_r = lower_design(lower, ClusterStatic, "readme_sample_size")
    Xr, yr, _ = datagen.generate_batch(spec_r, datagen.to_device(arr_r, dev), SEED, 0,
                                       sim_ids[:N_SIMS // 8], plain=True)
    suff_r = olsfit.grid_suffstats_plain(spec_r, Xr, yr)
    cm_r, _ = batch._exclusion_colmask(
        spec_r, datagen.factor_min_counts(spec_r, Xr) < spec_r.factor_min_level_count)
    xtx_r, xty_r, peff_r = olsfit.reduced_stats(suff_r["xtx"], suff_r["xty"], cm_r)
    k3_args["readme"] = (xtx_r, xty_r, suff_r["yty"], suff_r["ysum"],
                         torch.as_tensor(spec_r.grid, dtype=torch.float64, device=dev), peff_r)
    for arm, name in (("ols", "ols_10k"), ("curve", "curve_5pred_8grid"), ("readme", "readme")):
        args_ = k3_args[name]
        shape = f"{arm} cells {tuple(args_[2].shape)}, p {args_[0].shape[-1]}"
        if arm == "readme":
            shape = f"README sample-size flow launch, cells {tuple(args_[2].shape)}, p 6, p_eff per cell"
        timing.append((f"ols_solve {arm}", shape, olsfit.ols_solve_kernel, olsfit.ols_solve_plain,
                       args_, k3_bound(args_, olsfit.ols_solve_kernel(*args_)), None))
    timing.append(("reml_intercept", f"LMM cells {cells_l}, p 3, m 20",
                   mixedfit.reml_intercept_kernel, mixedfit.reml_intercept_plain, args_l,
                   k4_bound(args_l, mixedfit.reml_intercept_kernel(*args_l)), None))
    # K6 at the GLM arm's cells, at a launch of the logit sample-size flow
    # and at the two launches of the logit factor flow (the fallback's over
    # its failed cells, whose mask rides as the last input); its bound
    # counts the steps the cells ran, read from the kernel's step counter (a
    # call made here, not on the path)
    def k6_call(fn):
        def call(*a, **k):
            return fn(*a[:7], active=a[7] if len(a) > 7 else None, **k)
        return call

    k6_lines = []
    for key, case, shape in (("glm_irls", "glm_bonferroni_10k", "GLM cells {}, N 300, p 4, logit"),
                             ("glm_irls flow", "logit_sample_size",
                              "logit sample-size flow launch, cells {}, N 100..600, p 4, logit"),
                             ("glm_irls factor", "logit_factor_flow",
                              "logit factor flow launch, cells {}, N 40..200, p 4, per-cell masks"),
                             ("glm_irls fallback", "logit_factor_flow_fallback",
                              "logit factor flow fallback launch, cells {}, {} failed")):
        args_, kw_ = k6_args[case]
        if kw_:
            args_ = args_ + (kw_["active"],)
        out_ = k6_call(glmfit.glm_irls_kernel)(*args_, iters=True)
        new_b = k6_bound(args_[:7], out_[6], out_[:6], active=kw_.get("active"))
        old_b = k6_bound(args_[:7], out_[6], out_[:6], True, active=kw_.get("active"))
        k6_lines.append(f"{key} {new_b[0]:.4f} ms ({new_b[1]}; PR 6's count {old_b[0]:.4f} ms)")
        n_act = int(kw_["active"].sum()) if kw_ else None
        timing.append((key, shape.format(tuple(out_[2].shape), n_act),
                       k6_call(glmfit.glm_irls_kernel), k6_call(glmfit.glm_irls_plain), args_,
                       new_b, None))
    print("K6 bound, the steps the cells ran and one fused final pass (PR 6's count of the final "
          "pass, two divisions and two logs a row, beside it): " + ", ".join(k6_lines), flush=True)
    # K8 at the Poisson flow's launches: MCPower's 10,000 sims in chunks of
    # FLOW_CHUNK sims, N = 150
    flow_chunk = N_SIMS // 8
    u_f, eta_f = u_p[:flow_chunk].contiguous(), eta_p[:flow_chunk].contiguous()
    timing.append(("poisson_quantile", f"Poisson flow rows ({flow_chunk} sims x 150)",
                   datagen.poisson_quantile_kernel, datagen.poisson_quantile_plain, (u_f, eta_f),
                   k8_bound(u_f, eta_f, datagen.poisson_quantile_kernel(u_f, eta_f)), None))
    # K7 at the GLMM arms' cells and at a launch of README flow 3
    for key, case, shape in (
            ("glmm_intercept agq7", "glmm_agq7", "GLMM AGQ arm cells {}, N 200, m 20, p 3, nagq 7"),
            ("glmm_intercept laplace", "glmm_laplace", "GLMM Laplace arm cells {}, N 200, m 20, p 3"),
            ("glmm_intercept readme", "readme_flow_launch",
             "README flow 3 launch, cells {}, N 480, m 24, p 2"),
            ("glmm_intercept sample_size", "readme_sample_size_launch",
             "README flow 3 sample-size launch, cells {}, N 240..720, m 24, p 2")):
        args_ = k7_args_by[case]
        out_ = glmmfit.glmm_intercept_kernel(*args_)
        timing.append((key, shape.format(tuple(out_[2].shape)), glmmfit.glmm_intercept_kernel,
                       glmmfit.glmm_intercept_plain, args_, k7_bound(args_, out_), None))
    # K9 at a launch of README flow 2's power and sample-size flows, at the
    # lmm_slopes arm's cells and at lmm_multislope's, each bound counted from
    # the f32 evaluations its cells needed (the kernel's count; beside it the
    # first version's fixed d + 1 + 4 x 140); K2's slope mode at the arm's rows
    # and both flow launches'
    for key, case, shape in (
            ("slope_reml readme2", "readme2_flow_launch",
             "README flow 2 launch, cells {}, N 600, m 30, p 2, q 2"),
            ("slope_reml sample_size", "readme2_sample_size_launch",
             "README flow 2 sample-size launch, cells {}, N 300..900, m 30, p 2, q 2"),
            ("slope_reml lmm_slopes", "lmm_slopes", "lmm_slopes arm cells {}, N 200, m 20, p 3, q 2"),
            ("slope_reml multislope", "lmm_multislope",
             "lmm_multislope cells {}, N 480, m 20, p 5, q 3")):
        args_ = k9_args_by[case]
        out_ = mixedfit.slope_reml_kernel(*args_, evals=True)
        fixed_ms, _ = k9_bound(args_, out_[:6])
        counted = k9_bound(args_, out_)
        print(f"K9 bound at the {key.split()[1]} row: {counted[0]:.4f} ms from the "
              f"{float(out_[6].double().mean()):.1f} f32 evaluations a cell its cells needed, "
              f"{fixed_ms:.4f} ms at the first version's fixed count", flush=True)
        timing.append((key, shape.format(tuple(out_[2].shape)), mixedfit.slope_reml_kernel,
                       mixedfit.slope_reml_plain, args_, counted, None))

    # K10 at a launch of the slope-GLMM flow (README flow 3's shape) and at
    # the glmm_slopes arm's cells of phase 3
    for key, case, shape in (
            ("glmm_slope flow", "glmm_slopes_flow_launch",
             "slope GLMM flow launch, cells {}, N 480, m 24, p 2, q 2"),
            ("glmm_slope arm", "glmm_slopes", "glmm_slopes arm cells {}, N 200, m 20, p 3, q 2")):
        args_ = k10_args_by[case]
        out_ = glmmfit.glmm_slope_kernel(*args_)
        timing.append((key, shape.format(tuple(out_[2].shape)), glmmfit.glmm_slope_kernel,
                       glmmfit.glmm_slope_plain, args_, k10_bound(args_, out_), None))
    # K10 at a launch of the slope-GLMM sample-size flow (1,250 sims x 11 grid
    # points, N 240..720)
    ss_spec, ss_arr = flow_lowered("model_glmm_slopes_sample_size")[0]
    ss_arr_d = datagen.to_device(ss_arr, dev)
    Xs_, ys_, _ = datagen.generate_batch(ss_spec, ss_arr_d, SEED, 0, sim_ids[:N_SIMS // 8],
                                         plain=True)
    k10_args_by["sample_size_flow_launch"] = k10_args(ss_spec, ss_arr_d, Xs_, ys_)
    args_ = k10_args_by["sample_size_flow_launch"]
    out_ = glmmfit.glmm_slope_kernel(*args_)
    timing.append(("glmm_slope sample_size",
                   f"slope GLMM sample-size flow launch, cells {tuple(out_[2].shape)}, N "
                   f"{ss_spec.grid[0]}..{ss_spec.grid[-1]}, m 24, p 2, q 2",
                   glmmfit.glmm_slope_kernel, glmmfit.glmm_slope_plain, args_,
                   k10_bound(args_, out_), None))

    def k2s(spec_):  # K2's slope mode and its plain version, taking (X, y)
        return (lambda X_, y_: olsfit.grid_suffstats_kernel(spec_, X_, y_, with_slopes=True),
                lambda X_, y_: olsfit.grid_suffstats_plain(spec_, X_, y_, with_slopes=True))

    for arm, (spec_, arr_), n, shape in (
            ("lmm_slopes", slope_specs["lmm_slopes"], N_SIMS, "lmm_slopes X {}, m 20, q 2"),
            ("readme2", flow_cases9["readme2_flow_launch"], N_SIMS // 8,
             "README flow 2 launch X {}, m 30, q 2"),
            ("readme2_ss", flow_cases9["readme2_sample_size_launch"], N_SIMS // 8,
             "README flow 2 sample-size launch X {}, m 30, q 2, G 11")):
        X_, y_, _ = datagen.generate_batch(spec_, datagen.to_device(arr_, dev), SEED, 0,
                                           sim_ids[:n], plain=True)
        out_ = olsfit.grid_suffstats_kernel(spec_, X_, y_, with_slopes=True)
        timing.append((f"grid_suffstats {arm}", shape.format(tuple(X_.shape)) + ", slope mode",
                       *k2s(spec_), (X_, y_), k2_bound(spec_, X_, y_, out_), None))
    # K11 at the lmm_extras arm's cells (structured, Me 10), at a launch of
    # the crossed flow (structured, Me 25) and of the dense extras flow (M
    # 70); K2's joint mode at the arm's rows and the crossed launch's, beside
    # one torch.bmm of the dense f64 one-hot Z against [Z | X | y] (built
    # here, outside the timed window), the one PyTorch call that computes the
    # same sums at a single grid point
    dense_case = flow_cases11["dense_flow_launch"]
    Xd, yd, _ = datagen.generate_batch(dense_case[0], datagen.to_device(dense_case[1], dev), SEED,
                                       0, sim_ids[:N_SIMS // 8], plain=True)
    k11_args_by["dense_flow_timed"] = k11_args(dense_case[0],
                                               olsfit.joint_suffstats_plain(dense_case[0], Xd, yd))
    for key, case, shape in (
            ("joint_reml arm", "lmm_extras",
             "lmm_extras arm cells {}, N 200, M 30 (m 20 + 10), p 3, structured"),
            ("joint_reml crossed", "crossed_flow_launch",
             "crossed flow launch, cells {}, N 1000, M 65 (m 40 + 25), p 3, structured"),
            ("joint_reml nested", "nested_flow_launch",
             "nested flow launch, cells {}, N 720, M 60 (m 12 + 48), p 2, structured"),
            ("joint_reml dense", "dense_flow_timed",
             "dense extras flow launch, cells {}, N 600, M 70 (30 x 2 + 10), p 2, dense")):
        args_ = k11_args_by[case]
        out_ = mixedfit.joint_reml_kernel(*args_)
        timing.append((key, shape.format(tuple(out_[2].shape)), mixedfit.joint_reml_kernel,
                       mixedfit.joint_reml_plain, args_, k11_bound(args_, out_), None))

    # K12 at the glmm_extras arm's cells (structured, Me 10), at a launch of
    # the crossed GLMM flow (structured, Me 10), of the nested one
    # (structured, Me 48) and of the dense one (M 58, d 4); the plain
    # version's time is its one call of phase 3 (CUDA events around it); the
    # form its launcher takes (work areas in shared memory or in scratch)
    known_plain, k12_geometry = {}, {}
    for key, case, shape in (
            ("glmm_extras arm", "glmm_extras",
             "glmm_extras arm cells {}, N 200, M 30 (m 20 + 10), p 3, structured"),
            ("glmm_extras crossed", "glmm_crossed_flow_launch",
             "crossed GLMM flow launch, cells {}, N 480, M 34 (m 24 + 10), p 2, structured"),
            ("glmm_extras nested", "glmm_nested_flow_launch",
             "nested GLMM flow launch, cells {}, N 480, M 72 (m 24 + 48), p 2, structured"),
            ("glmm_extras dense", "glmm_dense_flow_launch",
             "dense GLMM flow launch, cells {}, N 480, M 58 (24 x 2 + 10), p 2, dense")):
        args_, out_ = k12_args_by[case], k12_out[case]
        known_plain[key] = k12_plain_ms[case]
        k12_geometry[key.split()[1]] = glmmfit.glmm_extras_geometry(*args_)
        print(f"K12 launch form at the {key.split()[1]} row: {k12_geometry[key.split()[1]]}",
              flush=True)
        timing.append((key, shape.format(tuple(out_[2].shape)), glmmfit.glmm_extras_kernel,
                       glmmfit.glmm_extras_plain, args_, k12_bound(args_, out_), None))

    def k2j(spec_):  # K2's joint mode and its plain version, taking (X, y)
        return (lambda X_, y_: olsfit.joint_suffstats_kernel(spec_, X_, y_),
                lambda X_, y_: olsfit.joint_suffstats_plain(spec_, X_, y_))

    for arm, (spec_, arr_), n, shape in (
            ("arm", extras_specs["lmm_extras"], EXTRAS_SIMS, "lmm_extras X {}, M 30"),
            ("crossed", flow_cases11["crossed_flow_launch"], N_SIMS // 8,
             "crossed flow launch X {}, M 65")):
        X_, y_, _ = datagen.generate_batch(spec_, datagen.to_device(arr_, dev), SEED, 0,
                                           sim_ids[:n], plain=True)
        out_ = olsfit.joint_suffstats_kernel(spec_, X_, y_)
        Z_ = torch.zeros(X_.shape[:2] + (out_["ztz"].shape[-1],), dtype=torch.float64, device=dev)
        zcols, zvals, _ = olsfit._joint_z(spec_, X_)
        Z_.scatter_(2, zcols.expand(X_.shape[0], -1, -1), zvals)
        rhs_ = torch.cat([Z_, X_[..., list(spec_.effective_fit_cols)].double(), y_.double()[..., None]],
                         dim=-1)
        Zt_ = Z_.transpose(1, 2).contiguous()
        lib = (lambda a, b: torch.bmm(a, b), (Zt_, rhs_))
        got_lib = torch.bmm(Zt_, rhs_)
        M_ = Z_.shape[-1]
        lib_rel = max(rel_err(got_lib[..., :M_], out_["ztz"][:, -1]),
                      rel_err(got_lib[..., -1], out_["zty"][:, -1]))
        check(lib_rel <= K2_JOINT_REL, f"the joint bmm yardstick differs from K2 by {lib_rel:.3e}")
        timing.append((f"grid_suffstats_joint {arm}", shape.format(tuple(X_.shape)) + ", joint mode",
                       *k2j(spec_), (X_, y_), k2_joint_bound(spec_, X_, y_, out_), lib))
    timed = {}
    with ClockSampler() as clocks:  # a process; ended however the block exits
        for key, shape, fk, fp, inputs, (bound_ms, bound_by), lib in timing:
            kname = key.split()[0] + "_kernel"  # the CUDA function's name
            t_row = time.perf_counter()
            copies = input_copies(inputs)
            # K6's, K7's, K9's and K10's plain versions make thousands to
            # tens of thousands of small launches a call, whose profiler
            # events take tens of seconds to collect: one window of one call.
            # K11's makes hundreds of thousands: CUDA events around one call
            # (the device's gaps between its launches included)
            heavy = kname in ("glm_irls_kernel", "glmm_intercept_kernel", "slope_reml_kernel",
                              "glmm_slope_kernel", "joint_reml_kernel", "glmm_extras_kernel")
            # the heavy kernels' plain versions are timed at one shape each
            # (their kernels' main rows; PLAIN_AT_MAIN_ROW), K12's come from
            # phase 3
            if key in known_plain:
                plain_ms = known_plain[key]
            elif heavy and key not in PLAIN_AT_MAIN_ROW:
                plain_ms = None
            else:
                plain_ms = (cuda_ms(fp, copies, 1) if kname == "joint_reml_kernel"
                            else device_ms(fp, copies, 1 if heavy else 3))
            # K11 and K12 take tenths of a second a launch: 5 timed launches
            k_reps = 5 if kname in ("joint_reml_kernel", "glmm_extras_kernel") else reps
            ms = device_ms(fk, copies, k_reps, kname, launches=1)
            if not heavy:
                plain_ms = (plain_ms + device_ms(fp, copies, 3)) / 2.0
            call_ms = cuda_ms(fk, copies, k_reps)
            library_ms = device_ms(lib[0], input_copies(lib[1]), reps) if lib is not None else None
            timed[key] = dict(shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by, library_ms=library_ms, call_ms=call_ms)
            plain_txt = "not measured" if plain_ms is None else f"{plain_ms:.4f} ms"
            print(f"time {key} ({shape}): kernel {ms:.4f} ms on the device ({call_ms:.4f} ms per "
                  f"call with the wrapper), plain {plain_txt}, bound {bound_ms:.4f} ms "
                  f"({bound_by}), {bound_ms / ms:.1%} of bound"
                  + (f", library {library_ms:.4f} ms" if library_ms is not None else
                     ", library none (no one PyTorch call computes it)")
                  + f"; timed in {time.perf_counter() - t_row:.1f} s", flush=True)

    print(f"clocks during the kernel timings: {clocks.summary()}", flush=True)
    print(f"kernel timings done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # K1 by mode at the LMM plan: the cipher and the store alone (words),
    # with the uniform map, and with the ppf (normals), this tree's and each
    # compared build's, to show where K1's time goes.
    plan_l = datagen.stream_plan(lmm)
    by_mode = {}
    for mode, label in ((rng.MODE_WORDS, "words"), (rng.MODE_OPEN_UNIFORM, "uniforms"),
                        (rng.MODE_NORMAL, "normals")):
        def fill(ids, mode=mode):
            return rng.fill_streams_kernel(SEED, 0, ids, plan_l, mode)
        copies = input_copies((sim_ids,))
        by_mode[label] = {"ms": device_ms(fill, copies, reps, "philox_fill_kernel", launches=1)}
        for lb, ks in others.items():
            with kernel_swapped(kernels, "philox_fill", ks["philox_fill"]):
                by_mode[label][f"{lb}_ms"] = device_ms(fill, copies, reps, "philox_fill_kernel",
                                                       launches=1)
    z_l = rng.fill_streams_kernel(SEED, 0, sim_ids, plan_l, rng.MODE_NORMAL)
    fill_ms = device_ms(lambda t: t.fill_(0.0), input_copies((z_l,)), reps)
    by_mode["write_yardstick"] = {"ms": fill_ms, "bytes": nbytes(z_l)}
    print(f"write yardstick: torch fill_ of the LMM fill's {nbytes(z_l) / 1e6:.1f} MB "
          f"{fill_ms:.4f} ms on the device ({nbytes(z_l) / fill_ms / 1e9:.2f} TB/s)", flush=True)
    print("K1 by mode at the LMM plan, device ms: " + ", ".join(
        f"{k} {v['ms']:.4f}" + "".join(f" ({lb} {v[lb + '_ms']:.4f})" for lb in others)
        for k, v in by_mode.items() if k != "write_yardstick"), flush=True)

    # Each compared build's K1, K3, K6 and K7 beside this tree's, same inputs,
    # in turns (other, this, this, other), each on cold-L2 inputs. A K7 of
    # PR 10's is launched as PR 10's wrapper launched it.
    for key, shape, fk, fp, inputs, _, _ in timing:
        name = key.split()[0]
        if name not in COMPARED_BY_ROW:
            continue
        copies = input_copies(inputs)
        for lb, ks in others.items():
            if name not in ks:
                continue
            kw = dict(iters=True) if name == "glm_irls" else {}
            fo = fk
            if name == "glmm_intercept" and k7_is_pr10(ks[name]):
                fo = lambda *a, k=ks[name]: k7_pr10_call(k, *a)  # noqa: E731
            with kernel_swapped(kernels, name, ks[name]):
                theirs = fo(*copies[0], **kw)
            ours = fk(*copies[0], **kw)
            if name == "philox_fill":
                check(torch.equal(theirs, ours), f"A/B {key}: {lb}'s K1 gives other values")
            elif name == "glm_irls":
                rels = [rel_err_finite(f"A/B {key}", a, b)
                        for a, b in zip(theirs[:2] + theirs[3:6], ours[:2] + ours[3:6])]
                check(torch.equal(theirs[2], ours[2]) and torch.equal(theirs[6], ours[6])
                      and max(rels) <= K6_REL,
                      f"A/B {key}: {lb}'s K6 disagrees (flags, step counts or rel err "
                      f"{max(rels):.3e})")
                print(f"A/B {key}: {lb}'s K6 has the same flags and step counts, max rel err "
                      f"{max(rels):.3e}", flush=True)
            elif name == "glmm_intercept":
                n_diff = sum(int((~((a == b) | (a.isnan() & b.isnan()))).sum())
                             for a, b in zip(theirs, ours))
                check(n_diff == 0, f"A/B {key}: {lb}'s K7 differs in {n_diff} entries")
                print(f"A/B {key}: {lb}'s K7 gives the same bits in every output", flush=True)
            else:
                ok = ours[3]
                check(torch.equal(theirs[3], ok) and max(
                    rel_err(a[ok], b[ok]) for a, b in zip(theirs[:3], ours[:3])) <= K3_REL,
                    f"A/B {key}: {lb}'s K3 disagrees")
            turns = []
            for k, f in ((ks[name], fo), (kernels.KERNELS[name], fk), (kernels.KERNELS[name], fk),
                         (ks[name], fo)):
                with kernel_swapped(kernels, name, k):
                    turns.append(device_ms(f, copies, reps, name + "_kernel", launches=1))
            o1, n1, n2, o2 = turns
            timed[key].setdefault("compare", {})[lb] = dict(ms=(o1 + o2) / 2.0, turns=[o1, o2],
                                                             this_turns=[n1, n2])
            print(f"A/B {key} ({shape}) against {lb}, device ms in turns: {lb} {o1:.4f}, this "
                  f"{n1:.4f}, this {n2:.4f}, {lb} {o2:.4f}; speed-up {(o1 + o2) / (n1 + n2):.2f}x",
                  flush=True)

    # Each compared build's K11, K10, K12 and K2 joint mode: K11's seven,
    # K10's and K12's eight outputs bit for bit at every case of K11_CHECKS,
    # K10_CHECKS and K12_CHECKS, K2's joint ztz, ztx and zty at every
    # K2_JOINT_CHECKS case; then their timing rows in turns (other, this,
    # this, other)
    for lb, ks in others.items():
        if "joint_reml" in ks:  # K11's seven outputs at every K11_CHECKS case
            for case in K11_CHECKS:
                with kernel_swapped(kernels, "joint_reml", ks["joint_reml"]):
                    theirs = mixedfit.joint_reml_kernel(*k11_args_by[case], with_theta=True)
                n_diff = sum(int((~((a == b) | (a.isnan() & b.isnan()))).sum())
                             for a, b in zip(theirs, k11_out[case]))
                check(n_diff == 0, f"A/B K11 {case}: {lb}'s build differs in {n_diff} entries")
            print(f"A/B K11 against {lb}: the same bits in all seven outputs at the "
                  f"{len(K11_CHECKS)} cases of K11_CHECKS", flush=True)
        if "glmm_slope" in ks:  # K10's eight outputs at every K10_CHECKS case
            for case in K10_CHECKS:
                with kernel_swapped(kernels, "glmm_slope", ks["glmm_slope"]):
                    theirs = glmmfit.glmm_slope_kernel(*k10_args_by[case])
                n_diff = sum(int((~((a == b) | (a.isnan() & b.isnan()))).sum())
                             for a, b in zip(theirs, k10_out[case]))
                check(n_diff == 0, f"A/B K10 {case}: {lb}'s build differs in {n_diff} entries")
            print(f"A/B K10 against {lb}: the same bits in all eight outputs at the "
                  f"{len(K10_CHECKS)} cases of K10_CHECKS", flush=True)
        if "glmm_extras" in ks:
            for case, args_ in k12_args_by.items():
                with kernel_swapped(kernels, "glmm_extras", ks["glmm_extras"]):
                    theirs = glmmfit.glmm_extras_kernel(*args_)
                n_diff = sum(int((~((a == b) | (a.isnan() & b.isnan()))).sum())
                             for a, b in zip(theirs, k12_out[case]))
                check(n_diff == 0, f"A/B K12 {case}: {lb}'s build differs in {n_diff} entries")
            print(f"A/B K12 against {lb}: the same bits in all eight outputs at the "
                  f"{len(k12_args_by)} cases of K12_CHECKS", flush=True)
        if "slope_reml" in ks:  # K9's six outputs at every K9_CHECKS case
            for case in K9_CHECKS:
                with kernel_swapped(kernels, "slope_reml", ks["slope_reml"]):
                    theirs = mixedfit.slope_reml_kernel(*k9_args_by[case])
                n_diff = sum(int((~((a == b) | (a.isnan() & b.isnan()))).sum())
                             for a, b in zip(theirs, k9_out[case]))
                check(n_diff == 0, f"A/B K9 {case}: {lb}'s build differs in {n_diff} entries")
            print(f"A/B K9 against {lb}: the same bits in all six outputs at the "
                  f"{len(K9_CHECKS)} cases of K9_CHECKS", flush=True)
        if "grid_suffstats" in ks:  # K2's slope mode: every output at its cases
            for name, (spec_, X_, y_) in k2s_rows.items():
                ours = olsfit.grid_suffstats_kernel(spec_, X_, y_, with_slopes=True)
                with kernel_swapped(kernels, "grid_suffstats", ks["grid_suffstats"]):
                    theirs = olsfit.grid_suffstats_kernel(spec_, X_, y_, with_slopes=True)
                n_diff = sum(int((theirs[k] != ours[k]).sum()) for k in ours)
                check(n_diff == 0, f"A/B K2 slope {name}: {lb}'s build differs in {n_diff} "
                                   "entries")
            print(f"A/B K2 slope mode against {lb}: the same bits in every output (G, A, b and "
                  f"the prefix sums) at {', '.join(k2s_rows)}", flush=True)
        if "grid_suffstats" in ks:
            for name in K2_JOINT_CHECKS:
                spec_, arr_ = lower_design(lower, ClusterStatic, name)
                X_, y_, _ = datagen.generate_batch(spec_, datagen.to_device(arr_, dev), SEED, 0,
                                                   sim_ids[:GOLDEN_SIMS], plain=True)
                ours = olsfit.joint_suffstats_kernel(spec_, X_, y_)
                with kernel_swapped(kernels, "grid_suffstats", ks["grid_suffstats"]):
                    theirs = olsfit.joint_suffstats_kernel(spec_, X_, y_)
                n_diff = sum(int((theirs[k] != ours[k]).sum()) for k in ("ztz", "ztx", "zty"))
                check(n_diff == 0, f"A/B K2 joint {name}: {lb}'s build differs in {n_diff} entries")
            print(f"A/B K2 joint mode against {lb}: the same bits in ztz, ztx and zty at "
                  f"{', '.join(K2_JOINT_CHECKS)}", flush=True)
    for key, shape, fk, fp, inputs, _, _ in timing:
        kname = key.split()[0]
        if kname not in ("glmm_extras", "grid_suffstats_joint", "joint_reml", "glmm_slope",
                         "slope_reml", "grid_suffstats"):
            continue
        name = "grid_suffstats" if kname == "grid_suffstats_joint" else kname
        copies = input_copies(inputs)
        k_reps = 5 if name in ("glmm_extras", "joint_reml") else reps
        for lb, ks in others.items():
            if name not in ks:
                continue
            if kname == "grid_suffstats":  # every K2 row's outputs, bit for bit
                ours = fk(*copies[0])
                with kernel_swapped(kernels, name, ks[name]):
                    theirs = fk(*copies[0])
                n_diff = sum(int((theirs[k] != ours[k]).sum()) for k in ours)
                check(n_diff == 0, f"A/B {key}: {lb}'s K2 differs in {n_diff} entries")
            turns = []
            for k in (ks[name], kernels.KERNELS[name], kernels.KERNELS[name], ks[name]):
                with kernel_swapped(kernels, name, k):
                    turns.append(device_ms(fk, copies, k_reps, kname + "_kernel", launches=1))
            o1, n1, n2, o2 = turns
            timed[key].setdefault("compare", {})[lb] = dict(ms=(o1 + o2) / 2.0, turns=[o1, o2],
                                                             this_turns=[n1, n2])
            print(f"A/B {key} ({shape}) against {lb}, device ms in turns: {lb} {o1:.4f}, this "
                  f"{n1:.4f}, this {n2:.4f}, {lb} {o2:.4f}; speed-up {(o1 + o2) / (n1 + n2):.2f}x",
                  flush=True)

    for name in ("reml_intercept", "glm_irls", "poisson_quantile"):
        records[name].update(timed[name])
    records["glmm_intercept"].update(timed["glmm_intercept agq7"], by_shape={
        shape: timed[f"glmm_intercept {shape}"]
        for shape in ("agq7", "laplace", "readme", "sample_size")})
    records["slope_reml"].update(timed["slope_reml readme2"], by_shape={
        shape: timed[f"slope_reml {shape}"]
        for shape in ("readme2", "sample_size", "lmm_slopes", "multislope")})
    records["glmm_slope"].update(timed["glmm_slope flow"], by_shape={
        shape: timed[f"glmm_slope {shape}"] for shape in ("flow", "arm", "sample_size")})
    records["joint_reml"].update(timed["joint_reml crossed"], by_shape={
        shape: timed[f"joint_reml {shape}"] for shape in ("arm", "crossed", "nested", "dense")})
    records["glmm_extras"].update(timed["glmm_extras crossed"], by_shape={
        shape: timed[f"glmm_extras {shape}"] for shape in ("arm", "crossed", "nested", "dense")},
        geometry=k12_geometry)
    records["grid_suffstats_joint"].update(timed["grid_suffstats_joint crossed"], by_arm={
        arm: timed[f"grid_suffstats_joint {arm}"] for arm in ("arm", "crossed")})
    records["glm_irls"]["by_shape"] = {"arm": timed["glm_irls"], "flow": timed["glm_irls flow"],
                                       "factor_flow": timed["glm_irls factor"],
                                       "factor_flow_fallback": timed["glm_irls fallback"]}
    # K1's line is the LMM fill and K3's the curve, the shapes the earlier
    # tables report; K2's the OLS shape, the one where a single library call
    # computes the same function; by_arm holds every arm's shape
    for name, top, arms in (("philox_fill", "lmm", ("lmm", "ols", "curve", "lmm_realistic",
                                                    "short")),
                            ("grid_suffstats", "ols", ("lmm", "ols", "curve", "lmm_slopes",
                                                       "readme2", "readme2_ss")),
                            ("ols_solve", "curve", ("ols", "curve", "readme"))):
        records[name].update(timed[f"{name} {top}"],
                             by_arm={arm: timed[f"{name} {arm}"] for arm in arms})
    records["philox_fill"]["by_mode"] = by_mode

    for name in DESIGNS:
        spec_, arr_ = specs[name]
        t0 = time.perf_counter()
        batch.run_batch(spec_, arr_, N_SIMS, SEED, chunk_size=N_SIMS, device=dev, plain=True)
        plain_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        batch.run_batch(spec_, arr_, N_SIMS, SEED, chunk_size=N_SIMS, device=dev)
        again_s = time.perf_counter() - t0
        print(f"arm {name} ({N_SIMS} sims, wall): kernels {arm_s[name] * 1e3:.1f} ms and "
              f"{again_s * 1e3:.1f} ms, plain {plain_s * 1e3:.1f} ms", flush=True)

    for name in DESIGNS:  # where the time goes: wall spread, busy share, device items
        spec_, arr_ = specs[name]
        prof = profile_arm(lambda: batch.run_batch(spec_, arr_, N_SIMS, SEED, chunk_size=N_SIMS,
                                                   device=dev))
        items = ", ".join(f"{k} {v:.3f}" for k, v in prof["items"])
        print(f"profile {name} ({N_SIMS} sims): wall median {prof['median_ms']:.3f} ms (range "
              f"{prof['min_ms']:.3f}-{prof['max_ms']:.3f}, {PROFILE_REPS} calls), device kernel "
              f"time {prof['device_ms']:.3f} ms, busy {prof['device_ms'] / prof['median_ms']:.1%} "
              f"of the median wall, {prof['launches']} kernels; largest device items (ms): "
              f"{items}", flush=True)

    for name, (spec_, arr_) in glmm_specs.items():  # the GLMM arms' walls and profiles
        t0 = time.perf_counter()
        batch.run_batch(spec_, arr_, GLMM_SIMS, SEED, chunk_size=GLMM_SIMS, device=dev, plain=True)
        plain_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        batch.run_batch(spec_, arr_, GLMM_SIMS, SEED, chunk_size=GLMM_SIMS, device=dev)
        again_s = time.perf_counter() - t0
        print(f"arm {name} ({GLMM_SIMS} sims, wall): kernels {glmm_arm_s[name] * 1e3:.1f} ms and "
              f"{again_s * 1e3:.1f} ms, plain {plain_s * 1e3:.1f} ms", flush=True)
        prof = profile_arm(lambda: batch.run_batch(spec_, arr_, GLMM_SIMS, SEED,
                                                   chunk_size=GLMM_SIMS, device=dev))
        items = ", ".join(f"{k} {v:.3f}" for k, v in prof["items"])
        print(f"profile {name} ({GLMM_SIMS} sims): wall median {prof['median_ms']:.3f} ms (range "
              f"{prof['min_ms']:.3f}-{prof['max_ms']:.3f}, {PROFILE_REPS} calls), device kernel "
              f"time {prof['device_ms']:.3f} ms, busy {prof['device_ms'] / prof['median_ms']:.1%} "
              f"of the median wall, {prof['launches']} kernels; largest device items (ms): "
              f"{items}", flush=True)

    for name, (spec_, arr_) in slope_specs.items():  # the slope arm's wall and profile
        t0 = time.perf_counter()
        batch.run_batch(spec_, arr_, N_SIMS, SEED, chunk_size=N_SIMS, device=dev, plain=True)
        plain_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        batch.run_batch(spec_, arr_, N_SIMS, SEED, chunk_size=N_SIMS, device=dev)
        again_s = time.perf_counter() - t0
        print(f"arm {name} ({N_SIMS} sims, wall): kernels {slope_arm_s[name] * 1e3:.1f} ms and "
              f"{again_s * 1e3:.1f} ms, plain {plain_s * 1e3:.1f} ms", flush=True)
        prof = profile_arm(lambda: batch.run_batch(spec_, arr_, N_SIMS, SEED, chunk_size=N_SIMS,
                                                   device=dev))
        items = ", ".join(f"{k} {v:.3f}" for k, v in prof["items"])
        print(f"profile {name} ({N_SIMS} sims): wall median {prof['median_ms']:.3f} ms (range "
              f"{prof['min_ms']:.3f}-{prof['max_ms']:.3f}, {PROFILE_REPS} calls), device kernel "
              f"time {prof['device_ms']:.3f} ms, busy {prof['device_ms'] / prof['median_ms']:.1%} "
              f"of the median wall, {prof['launches']} kernels; largest device items (ms): "
              f"{items}", flush=True)

    for name, (spec_, arr_) in slope_glmm_specs.items():  # the slope-GLMM arm's wall, profile
        t0 = time.perf_counter()
        batch.run_batch(spec_, arr_, SLOPE_GLMM_SIMS, SEED, chunk_size=SLOPE_GLMM_SIMS,
                        device=dev)
        again_s = time.perf_counter() - t0
        print(f"arm {name} ({SLOPE_GLMM_SIMS} sims, wall): kernels "
              f"{slope_glmm_arm_s[name] * 1e3:.1f} ms and {again_s * 1e3:.1f} ms (the plain "
              f"path's at {TREE_SIMS_ON_CARD} sims is phase 4's check)", flush=True)
        prof = profile_arm(lambda: batch.run_batch(spec_, arr_, SLOPE_GLMM_SIMS, SEED,
                                                   chunk_size=SLOPE_GLMM_SIMS, device=dev))
        items = ", ".join(f"{k} {v:.3f}" for k, v in prof["items"])
        print(f"profile {name} ({SLOPE_GLMM_SIMS} sims): wall median {prof['median_ms']:.3f} ms "
              f"(range {prof['min_ms']:.3f}-{prof['max_ms']:.3f}, {PROFILE_REPS} calls), device "
              f"kernel time {prof['device_ms']:.3f} ms, busy "
              f"{prof['device_ms'] / prof['median_ms']:.1%} of the median wall, "
              f"{prof['launches']} kernels; largest device items (ms): {items}", flush=True)

    for name, (spec_, arr_) in extras_specs.items():  # the extras arms' walls and profiles
        t0 = time.perf_counter()
        batch.run_batch(spec_, arr_, EXTRAS_SIMS, SEED, chunk_size=EXTRAS_SIMS, device=dev)
        again_s = time.perf_counter() - t0
        print(f"arm {name} ({EXTRAS_SIMS} sims, wall): kernels {extras_arm_s[name] * 1e3:.1f} ms "
              f"and {again_s * 1e3:.1f} ms (the plain path's at {TREE_SIMS_ON_CARD} sims is phase 4's "
              f"check)", flush=True)
        prof = profile_arm(lambda: batch.run_batch(spec_, arr_, EXTRAS_SIMS, SEED,
                                                   chunk_size=EXTRAS_SIMS, device=dev),
                           reps=EXTRAS_PROFILE_REPS, profiled=1)
        items = ", ".join(f"{k} {v:.3f}" for k, v in prof["items"])
        print(f"profile {name} ({EXTRAS_SIMS} sims): wall median {prof['median_ms']:.3f} ms "
              f"(range {prof['min_ms']:.3f}-{prof['max_ms']:.3f}, {EXTRAS_PROFILE_REPS} calls), device "
              f"kernel time {prof['device_ms']:.3f} ms, busy "
              f"{prof['device_ms'] / prof['median_ms']:.1%} of the median wall, "
              f"{prof['launches']} kernels; largest device items (ms): {items}", flush=True)

    for name, (spec_, arr_) in glmm_extras_specs.items():  # the GLMM extras arms' walls
        t0 = time.perf_counter()
        batch.run_batch(spec_, arr_, GLMM_EXTRAS_SIMS, SEED, chunk_size=GLMM_EXTRAS_SIMS,
                        device=dev)
        again_s = time.perf_counter() - t0
        print(f"arm {name} ({GLMM_EXTRAS_SIMS} sims, wall): kernels "
              f"{glmm_extras_arm_s[name] * 1e3:.1f} ms and {again_s * 1e3:.1f} ms", flush=True)
        prof = profile_arm(lambda: batch.run_batch(spec_, arr_, GLMM_EXTRAS_SIMS, SEED,
                                                   chunk_size=GLMM_EXTRAS_SIMS, device=dev),
                           reps=GLMM_EXTRAS_PROFILE_REPS, profiled=1)
        items = ", ".join(f"{k} {v:.3f}" for k, v in prof["items"])
        print(f"profile {name} ({GLMM_EXTRAS_SIMS} sims): wall median {prof['median_ms']:.3f} ms "
              f"(range {prof['min_ms']:.3f}-{prof['max_ms']:.3f}, {GLMM_EXTRAS_PROFILE_REPS} "
              f"calls), device kernel time {prof['device_ms']:.3f} ms, busy "
              f"{prof['device_ms'] / prof['median_ms']:.1%} of the median wall, "
              f"{prof['launches']} kernels; largest device items (ms): {items}", flush=True)

    # --- phase 6: the user flows through MCPower ---
    print(f"phase 6 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    flows = run_user_flows(smi, specs)

    # --- phase 7: results ---
    out = []
    for name, (source, replaces) in KERNEL_META.items():
        r = records[name]
        # K8's path is the Poisson flow's; every other kernel's the arms'
        # (K7's the GLMM arms')
        path_launches = (flows["model_poisson_power"]["launches"][name]
                         if name == "poisson_quantile" else launches[name])
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": path_launches, **r,
            "launches_by_arm": {a: v.get(name, 0) for a, v in launches_by_arm.items()},
            "launches_by_flow": {f: v["launches"].get(name, 0) for f, v in flows.items()},
            **({"fallback_launches_by_flow": {f: v["fallback_launches"] for f, v in flows.items()
                                              if v["fallback_launches"]}}
               if name == "glm_irls" else {}),
            **({"launches_per_chunk_by_flow": {f: v["k1_launches_per_chunk"]
                                               for f, v in flows.items()},
                "scenario_arms": scenario_arms}
               if name == "philox_fill" else {}),
        })
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        code = 1
    sys.exit(code)
