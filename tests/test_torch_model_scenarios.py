"""The port's ``MCPower`` against the JAX reference's under robustness
scenarios (ROADMAP A10): the three scenario flows of ``chip_smoke.py``
(README flow 1's ``find_sample_size(from_size=50, to_size=500,
scenarios=True)`` as written, the random-intercept LMM's and the logit
model's ``find_power(..., scenarios=True)``), each run once per package at
the chip run's 1,024 sims: the whole result trees must be equal (at most one
flip per count, ``chip_smoke.compare_trees``), the golden values of the chip
run must be the reference's, and the scenarios must order optimistic >=
realistic >= doomer where the reference's do. Then a custom scenario of
``set_scenario_configs`` (a uniform residual swap and a heteroskedasticity
driver), and a GLMM with a nested grouping past kernel K12's limit under
``scenarios=True``, which raises naming K12 before any run (GLMMs, with or
without extra groupings, run under scenarios: tests/test_torch_model_glmm.py,
chip_smoke.py's model_glmm_crossed_scenarios)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mcpower_tpu  # noqa: F401  (x64 on, as the reference runs)
from mcpower_tpu import MCPower as RefMCPower
from mcpower_tpu_torch import MCPower
from mcpower_tpu_torch.orchestrator import runner

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

FLOWS = ["model_readme_ols_scenarios", "model_lmm_scenarios", "model_logit_scenarios"]
LABELS = ["optimistic", "realistic", "doomer"]


@pytest.fixture(scope="module", autouse=True)
def _first_cpu_math_call():
    """Take the process's first multi-threaded call of torch's CPU log,
    log1p and exp before any comparison: that call has been seen, in a
    loaded process, to return values ~1e-5 off on part of a tensor."""
    x = torch.rand(1 << 20) + 0.5
    for t in (x, x.double()):
        torch.log(t), torch.log1p(t), torch.exp(t), torch.sqrt(t)


@pytest.fixture(scope="module", params=FLOWS)
def flow(request):
    """(name, the port's result, the reference's result) at GOLDEN_SIMS."""
    name, n = request.param, chip_smoke.GOLDEN_SIMS
    return (name, chip_smoke.run_flow(MCPower, name, n, device="cpu"),
            chip_smoke.run_flow(RefMCPower, name, n))


def test_result_tree_matches_the_reference(flow):
    name, got, want = flow
    assert list(got["scenarios"]) == LABELS
    chip_smoke.compare_trees(name, got, want)
    assert got.summary()


def test_golden_values_of_chip_smoke_are_the_references(flow):
    name, got, want = flow
    want = chip_smoke.flow_summary(want)
    chip_smoke.compare_trees(name, chip_smoke.MODEL_GOLDEN[name], want, max_flips=0,
                             tau_rel=1e-12)
    chip_smoke.compare_trees(name, chip_smoke.flow_summary(got), want)


def test_scenarios_order_as_the_references(flow):
    """Power per N and test, summed over tests: optimistic >= realistic >=
    doomer holds at each N where it holds for the reference."""
    _, got, want = flow

    def total(res, label):
        return np.asarray(res["scenarios"][label]["powers"]["corrected"]).sum(-1)

    for a, b in zip(LABELS, LABELS[1:]):
        ref_holds = total(want, a) >= total(want, b)
        assert ref_holds.any()
        assert (total(got, a) >= total(got, b))[ref_holds].all()


def _custom(cls):
    """The OLS model of chip_smoke under a scenario of its own: residuals
    swapped to uniform or left-skewed, heteroskedasticity driven by x1,
    heterogeneity and correlation noise."""
    m = chip_smoke.build_model(cls, "ols")
    m.set_heteroskedasticity_driver("x1")
    m.set_scenario_configs({"lopsided": dict(
        heterogeneity=0.1, heteroskedasticity_ratio=3.0, correlation_noise_sd=0.1,
        residual_change_prob=0.6, residual_dists=["uniform", "left_skewed"], residual_df=6,
        distribution_change_prob=0.0, icc_noise_sd=0.0, random_effect_dist="normal")})
    return m


def test_a_custom_scenario_matches_the_reference():
    kw = dict(scenarios=["lopsided"], n_sims=64, seed=chip_smoke.SEED, verbose=False)
    got = _custom(MCPower).find_power(200, device="cpu", **kw)
    want = _custom(RefMCPower).find_power(200, **kw)
    chip_smoke.compare_trees("lopsided", got, want)
    assert got["powers"]["corrected"] != chip_smoke.run_flow(MCPower, "model_ols_power", 64,
                                                            device="cpu")["powers"]["corrected"]


def test_a_glmm_under_scenarios_raises_before_any_run(monkeypatch):
    """A GLMM with extra groupings runs under scenarios (kernel K12); one
    past K12's joint Z of M <= 128 (20 clusters, 140 wards nested in them)
    raises before any scenario runs."""
    calls = []
    monkeypatch.setattr(runner.batch, "run_batch", lambda *a, **k: calls.append(1))
    m = MCPower("y ~ x1 + x2 + (1|cluster/ward)", family="logit")
    m.set_cluster("cluster", ICC=0.2, n_clusters=20)
    m.set_cluster("cluster:ward", ICC=0.1, n_clusters=140, n_per_parent=7)
    m.set_baseline_probability(0.3)
    m.set_effects("x1=0.3, x2=0.2")
    with pytest.raises(NotImplementedError, match="a joint Z of 160 columns .*kernel K12"):
        m.find_power(280, scenarios=True, n_sims=8, verbose=False, device="cpu")
    assert calls == []
