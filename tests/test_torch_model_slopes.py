"""README flow 2 (the LMM with a random slope, K2's slope mode and kernel
K9's plain version on the CPU) through the port's ``MCPower`` against the
JAX reference's, and the gates of the slope path.

* ``find_power(600)`` as written, at GOLDEN_SIMS: one run of each package;
  the port's whole result tree against the reference's
  (``chip_smoke.compare_trees``: at most one flip per count and
  SLOPE_PIN_FLIPS per pin count, the mean tau^2 within TAU2_REL, every other
  value equal where the counts are), and the
  reference's summary against the chip run's golden values
  (``chip_smoke.MODEL_GOLDEN``). The reference's slope program takes most of
  its run to compile, so one run at the chip run's size costs less on the CPU than
  a small run beside a golden one;
* the per-component pin rates of tests/test_slopes.py:110-133's null-slope
  design through ``run_batch``, against the reference's (at most one flip
  per count);
* a GLMM with slopes runs on the CPU through K10's plain version
  (tests/test_torch_model_glmm_slopes.py holds it against the reference);
  q > 4 raises ``NotImplementedError`` naming kernel K9's limit before any
  run; ``agq=`` with slopes keeps the reference's warning; the fit goes
  through K9's dispatch; the default device is the card.

tests/test_torch_model_slopes_search.py has the sample-size search,
tests/test_torch_model_slopes_scenarios.py the scenarios."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mcpower_tpu  # noqa: F401  (x64 on, as the reference runs)
from mcpower_tpu import MCPower as RefMCPower
from mcpower_tpu.engine import batch as ref_batch
from mcpower_tpu.engine import lower as ref_lower
from mcpower_tpu.engine.spec import ClusterStatic as RefCluster
from mcpower_tpu.engine.spec import SlopeStatic as RefSlope
from mcpower_tpu_torch import MCPower
from mcpower_tpu_torch.engine import batch, glmmfit, lower, mixedfit
from mcpower_tpu_torch.engine.spec import ClusterStatic, SlopeStatic

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

PIN_SIMS = 64
THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def _first_cpu_math_call():
    """Take the process's first multi-threaded call of torch's CPU log
    before any comparison (it has been seen to return values ~1e-5 off in
    a loaded process); run the plain search on THREADS threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    x = torch.rand(1 << 20) + 0.5
    for t in (x, x.double()):
        torch.log(t), torch.sqrt(t)
    yield
    torch.set_num_threads(threads)


def check_flow(name, golden=None, **kw):
    """``name`` at GOLDEN_SIMS through both packages (``kw`` to both calls):
    the port's tree against the reference's, the reference's summary
    against ``golden`` (MODEL_GOLDEN[name] by default)."""
    got = chip_smoke.run_flow(MCPower, name, chip_smoke.GOLDEN_SIMS, device="cpu", **kw)
    want = chip_smoke.run_flow(RefMCPower, name, chip_smoke.GOLDEN_SIMS, **kw)
    flips = chip_smoke.compare_trees(name, got, want, pin_flips=chip_smoke.SLOPE_PIN_FLIPS)
    print(f"{name}: port against the reference at {chip_smoke.GOLDEN_SIMS} sims: "
          f"{flips or 'identical counts'}")
    chip_smoke.compare_trees(name, golden or chip_smoke.MODEL_GOLDEN[name],
                             chip_smoke.flow_summary(want), max_flips=0, tau_rel=1e-12)
    assert got.summary()
    return got


def test_readme_flow_2_against_the_reference_and_its_golden_values():
    got = check_flow("model_lmm_slopes_power")
    mle = got["estimator_extras"]["mle"]
    assert got["sample_sizes"] == [600] and len(mle["boundary_component_counts"][0]) == 2


def _null_slope(low, cluster_cls, slope_cls):
    """tests/test_slopes.py:110-126: a slope of variance 0 on x, tau^2 0.3,
    30 clusters, N = 240."""
    return low.lower(grid=[240], var_types=["normal"], effects=np.array([0.0, 0.4]),
                     target_cols=[1], estimator="mle",
                     cluster=cluster_cls(sizing_mode="fixed_clusters", sizing_value=30,
                                         tau_squared=0.3, slopes=(slope_cls(
                                             design_col=1, variance=0.0, intercept_corr=0.0),)))


def test_pin_rates_of_a_null_slope_match_the_reference():
    want = ref_batch.run_batch(*_null_slope(ref_lower, RefCluster, RefSlope), PIN_SIMS, 11)
    got = batch.run_batch(*_null_slope(lower, ClusterStatic, SlopeStatic), PIN_SIMS, 11,
                          device="cpu")
    pc, conv = np.asarray(got["pinned_comp"]), np.asarray(got["converged"])
    assert pc.shape == (1, 2)
    for key in ("pinned_comp", "boundary_hit", "converged", "sig_unc"):
        diff = np.abs(np.asarray(got[key]).astype(np.int64) - np.asarray(want[key]))
        assert diff.max() <= chip_smoke.MAX_FLIPS, (key, got[key], want[key])
    rates = pc[0] / conv[0]
    assert rates[1] > 0.3 and rates[0] < 0.05, rates  # the null slope pins often


def test_a_glmm_with_slopes_runs_on_the_cpu_through_the_plain_version(monkeypatch):
    seen = []
    real = glmmfit.glmm_slope_plain
    monkeypatch.setattr(glmmfit, "glmm_slope_plain",
                        lambda *a, **k: seen.append(a[1].shape) or real(*a, **k))
    m = MCPower("y ~ x1 + (1 + x1|site)", family="logit")
    m.set_baseline_probability(0.3)
    m.set_cluster("site", ICC=0.2, n_clusters=20, random_slopes=["x1"], slope_variance=0.1)
    m.set_effects("x1=0.3")
    res = m.find_power(200, n_sims=8, verbose=False, device="cpu")
    assert seen == [(8, 200, 2)]
    assert res["convergence_rate"][0] > 0.5
    assert len(res["estimator_extras"]["glm"]["boundary_component_counts"][0]) == 2


def test_q_above_4_raises_naming_k9_before_any_run(monkeypatch):
    spec, arr = lower.lower(
        grid=[200], var_types=["normal"] * 4, effects=np.array([0.0, 0.3, 0.2, 0.1, 0.1]),
        target_cols=[1], estimator="mle",
        cluster=ClusterStatic(sizing_mode="fixed_clusters", sizing_value=20, tau_squared=0.3,
                              slopes=tuple(SlopeStatic(design_col=c, variance=0.1,
                                                       intercept_corr=0.0) for c in range(1, 5))))
    assert spec.cluster.q == 5
    monkeypatch.setattr(batch, "run_sims", lambda *a, **k: pytest.fail("a run started"))
    with pytest.raises(NotImplementedError, match="K9"):
        batch.run_batch(spec, arr, 8, 1, device="cpu")


def test_agq_with_slopes_keeps_the_references_warning():
    m = chip_smoke.build_model(MCPower, "lmm_slopes")
    with pytest.warns(UserWarning, match="not eligible"):
        m.find_power(600, n_sims=4, verbose=False, device="cpu", agq=7)


def test_the_slope_fit_runs_through_k9s_dispatch(monkeypatch):
    seen = []
    real = mixedfit.slope_reml_plain
    monkeypatch.setattr(mixedfit, "slope_reml_plain",
                        lambda *a, **k: seen.append(a[0].shape) or real(*a, **k))
    chip_smoke.build_model(MCPower, "lmm_slopes").find_power(600, n_sims=4, verbose=False,
                                                             device="cpu")
    assert seen == [(4, 1, 30, 2, 2)]


@pytest.mark.parametrize("method", ["find_power", "find_sample_size"])
def test_the_default_device_is_the_card(monkeypatch, method):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = dict(sample_size=600) if method == "find_power" else dict(from_size=300, to_size=900)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(chip_smoke.build_model(MCPower, "lmm_slopes"), method)(**args, n_sims=4,
                                                                       verbose=False)
