"""The port's batch driver against ``mcpower_tpu.engine.batch.run_batch``.

On the CPU the port runs every stage through its plain versions; its counts
must equal the reference's on the headline LMM and the power-curve design.
The golden counts that ``chip_smoke.py`` holds for its check on the card
are recomputed here with the reference (1,024 sims in chunks of 64, the
compile of the 64-sim comparison), so they cannot go stale.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from mcpower_tpu.engine import batch as ref_batch
from mcpower_tpu.engine import lower as ref_lower
from mcpower_tpu.engine.spec import ClusterStatic as RefCluster
from mcpower_tpu_torch.engine import batch, lower, olsfit, rng
from mcpower_tpu_torch.engine.spec import (
    ClusterStatic,
    ExtraGroupingStatic,
    PosthocStatic,
    ScenarioStatic,
    SlopeStatic,
)

REPO = Path(__file__).resolve().parent.parent
SIMS = 64
# The tau^2 sum is a float: per sim it carries the generation's gap (the
# reference's FMA-contracted ppf, tests/test_torch_datagen.py) through a
# 20-step search. Measured rel 1.7e-6 at 64 sims.
TAU2_REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _first_cpu_math_call():
    """Take the process's first multi-threaded call of torch's CPU log,
    log1p and exp before any comparison: that call has been seen, in a
    loaded process, to return values ~1e-5 off on part of a tensor."""
    x = torch.rand(1 << 20) + 0.5
    for t in (x, x.double()):
        torch.log(t), torch.log1p(t), torch.exp(t), torch.sqrt(t)


@pytest.fixture(scope="module")
def designs():
    return {
        name: (chip_smoke.lower_design(ref_lower, RefCluster, name),
               chip_smoke.lower_design(lower, ClusterStatic, name))
        for name in chip_smoke.DESIGNS
    }


def _assert_counts_equal(got, want, tau2_rel=TAU2_REL):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g, w = np.asarray(got[key]), np.asarray(w)
        assert g.shape == w.shape, key
        if key == "tau2_hat":
            np.testing.assert_allclose(g, w, rtol=tau2_rel, err_msg=key)
        elif key == "glm_baseline":
            # f64 sums of the same per-sim outcome means in another order
            # (measured 1.4e-16 relative at 1,024 sims)
            np.testing.assert_allclose(g, w, rtol=1e-12, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


@pytest.mark.parametrize("name", ["lmm_headline", "curve_5pred_8grid"])
def test_run_batch_equals_the_reference(designs, name):
    (ref_spec, ref_arr), (spec, arr) = designs[name]
    want = ref_batch.run_batch(ref_spec, ref_arr, SIMS, chip_smoke.SEED, chunk_size=SIMS)
    got = batch.run_batch(spec, arr, SIMS, chip_smoke.SEED, chunk_size=SIMS, device="cpu")
    _assert_counts_equal(got, want)


@pytest.mark.parametrize("name", sorted(chip_smoke.DESIGNS))
def test_golden_counts_of_chip_smoke_are_the_references(designs, name):
    (ref_spec, ref_arr), (spec, arr) = designs[name]
    n = chip_smoke.GOLDEN_SIMS
    want = ref_batch.run_batch(ref_spec, ref_arr, n, chip_smoke.SEED, chunk_size=SIMS)
    _assert_counts_equal(chip_smoke.GOLDEN[name], want, tau2_rel=1e-12)
    # the port's plain path reproduces them on the CPU
    got = batch.run_batch(spec, arr, n, chip_smoke.SEED, chunk_size=4 * SIMS, device="cpu")
    _assert_counts_equal(got, want)


def test_chunking_progress_and_cancel(designs):
    _, (spec, arr) = designs["lmm_headline"]
    whole = batch.run_batch(spec, arr, SIMS, 7, chunk_size=SIMS, device="cpu")
    seen = []
    ragged = batch.run_batch(spec, arr, SIMS, 7, chunk_size=24, device="cpu",
                             progress=lambda done, total: seen.append((done, total)))
    _assert_counts_equal(ragged, whole, tau2_rel=1e-12)
    assert seen == [(24, SIMS), (48, SIMS), (64, SIMS)]
    # sim ids, not positions, address the draws: an offset batch is the tail
    head = batch.run_batch(spec, arr, 40, 7, chunk_size=40, device="cpu")
    tail = batch.run_batch(spec, arr, 24, 7, sim_id_offset=40, device="cpu")
    for key in whole:
        if key != "tau2_hat":
            np.testing.assert_array_equal(np.asarray(head[key]) + tail[key], whole[key])
    stopped = batch.run_batch(spec, arr, SIMS, 7, chunk_size=24, cancel=lambda: True,
                              device="cpu")
    assert int(stopped["n_done"]) == 24


def _lmm(**cluster):
    return dict(estimator="mle", cluster=ClusterStatic("fixed_clusters", 20, 0.25, **cluster))


# Factor designs and posthoc contrasts run (tests/test_torch_factors.py);
# here they are 16-level factors, too wide for the fit kernels (p = 18).
# Scenario knobs, skewed residuals and marginals run too
# (tests/test_torch_scenarios.py); here each sits on a design that still
# raises: a GLMM with extra groupings past K12's joint Z of M <= 128 (20 +
# 110 columns), more random slopes than kernels K9 and K10 take (q = 5),
# extra groupings past K11's joint Z of M <= 128, uploaded data, p = 19.
# Random-intercept GLMMs run (tests/test_torch_glmm.py) within kernel K7's
# limits on nodes and clusters; LMMs and GLMMs with up to three random
# slopes run (tests/test_torch_slopes_fit.py, tests/test_torch_glmm_slopes.py),
# and GLMMs with extra groupings within K12's (tests/test_torch_glmm_extras*.py).
_SLOPES_Q5 = tuple(SlopeStatic(1 + k % 2, 0.1, 0.0) for k in range(4))
_GLMM = dict(outcome="binary", estimator="glm")
UNSUPPORTED = {
    "glm": dict(outcome="continuous", estimator="glm"),
    "glmm": dict(_GLMM, cluster=ClusterStatic("fixed_clusters", 20, 0.25, slopes=_SLOPES_Q5)),
    "glmm_nodes": dict(_GLMM, cluster=ClusterStatic("fixed_clusters", 20, 0.25), nagq=27),
    "glmm_clusters": dict(_GLMM, grid=[2050],
                          cluster=ClusterStatic("fixed_clusters", 1025, 0.25)),
    "slopes": _lmm(slopes=_SLOPES_Q5),
    "extra_groupings": _lmm(extra_groupings=(ExtraGroupingStatic("crossed", 110, 0.15),)),
    "factors": dict(factor_levels=[16], effects=np.zeros(18)),
    "posthoc": dict(factor_levels=[16], effects=np.zeros(18),
                    posthoc=(PosthocStatic(0, 16, ((3, 4),)),)),
    "heterogeneity": dict(_GLMM, cluster=ClusterStatic(
        "fixed_clusters", 20, 0.25, extra_groupings=(ExtraGroupingStatic("crossed", 110, 0.15),)),
        scenario=ScenarioStatic(heterogeneity=0.2)),
    "heteroskedasticity": dict(_lmm(slopes=_SLOPES_Q5),
                               scenario=ScenarioStatic(heteroskedasticity_ratio=2.0)),
    "scenario_swaps": dict(_lmm(extra_groupings=(ExtraGroupingStatic("crossed", 110, 0.15),)),
                           scenario=ScenarioStatic(distribution_change_prob=0.5)),
    "residual": dict(residual="right_skewed", upload_frame=np.zeros((10, 2))),
    "marginal": dict(var_types=["normal", "right_skewed"], factor_levels=[16],
                     effects=np.zeros(18)),
    "upload": dict(upload_frame=np.zeros((10, 2))),
}


@pytest.mark.parametrize("name", sorted(UNSUPPORTED))
def test_specs_outside_the_slice_raise(name):
    kw = dict(grid=[100], var_types=["normal", "normal"], effects=np.zeros(3), target_cols=[1])
    kw.update(UNSUPPORTED[name])
    spec, arr = lower.lower(**kw)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        batch.run_batch(spec, arr, 8, 1)


def test_run_batch_defaults_to_the_card_and_raises_without_one(designs, monkeypatch):
    _, (spec, arr) = designs["ols_10k"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch.run_batch(spec, arr, 8, 1)


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    meta = torch.arange(4, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        rng.fill_streams(1, 0, meta, [(rng.CLASS_XNORM, 0, 8)])
    xtx = torch.eye(2, dtype=torch.float64, device="meta").expand(3, 1, 2, 2)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        olsfit.ols_solve(xtx, xtx[..., 0], xtx[..., 0, 0], xtx[..., 0, 0], xtx[0, :, 0, 0])


def test_the_port_imports_neither_jax_nor_the_reference():
    code = (
        "import sys, importlib, pkgutil\n"
        "import mcpower_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, 'mcpower_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "for part in ('model', 'orchestrator.runner', 'specbuilder.project', 'contract.wire',\n"
        "             'output.report', 'engine.adapter', 'engine.batch'):\n"
        "    assert 'mcpower_tpu_torch.' + part in names, part\n"
        "assert p.MCPower.__module__ == 'mcpower_tpu_torch.model'\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'mcpower_tpu'))\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
