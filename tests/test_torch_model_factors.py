"""The port's ``MCPower`` against the JAX reference's on the factor flows of
``chip_smoke.py``: README flow 1 as written (``model_readme_ols_power``,
``model_readme_ols_sample_size``), the Tukey ANOVA (``model_anova_tukey``)
and the logit model with a rare factor level (``model_logit_factor_sample_size``,
which excludes the factor at its smallest N and runs the separation
fallback above it). Each flow runs once per package at the chip run's
1,024 sims: the whole result trees must be equal (at most one flip per
count, ``chip_smoke.compare_trees``) and the golden values of the chip run
must be the reference's. Then the preflight: a factor design runs,
designs wider than p = 16 still raise, naming B10, and ``scenarios=True``
runs."""

import sys
from pathlib import Path

import pytest
import torch

import mcpower_tpu  # noqa: F401  (x64 on, as the reference runs)
from mcpower_tpu import MCPower as RefMCPower
from mcpower_tpu_torch import MCPower
from mcpower_tpu_torch.orchestrator import runner

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

FLOWS = ["model_readme_ols_power", "model_readme_ols_sample_size", "model_anova_tukey",
         "model_logit_factor_sample_size"]


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
    chip_smoke.compare_trees(name, got, want)
    assert got.summary()


def test_golden_values_of_chip_smoke_are_the_references(flow):
    name, got, want = flow
    want = chip_smoke.flow_summary(want)
    chip_smoke.compare_trees(name, chip_smoke.MODEL_GOLDEN[name], want, max_flips=0)
    chip_smoke.compare_trees(name, chip_smoke.flow_summary(got), want)
    if name == "model_logit_factor_sample_size":  # the flow runs exclusion and the fallback
        assert want["factor_exclusion_counts"][0] == [chip_smoke.GOLDEN_SIMS]
        assert sum(want["separation_fallback_counts"]) > 0


@pytest.fixture
def runs(monkeypatch):
    """The run_batch calls the runner makes."""
    calls = []
    real = runner.batch.run_batch
    monkeypatch.setattr(runner.batch, "run_batch",
                        lambda *a, **k: calls.append(k.get("device")) or real(*a, **k))
    return calls


def test_a_factor_design_passes_the_preflight_and_warns_as_the_reference(runs):
    def rare(cls, **kw):
        m = cls("y ~ g")
        m.set_variable_type("g=(factor,0.9,0.05,0.05)")
        m.set_effects("g[2]=0.4")
        return m.find_power(sample_size=40, n_sims=16, verbose=False, **kw)["warnings"]

    got = rare(MCPower, device="cpu")
    assert runs == ["cpu"]
    assert got == rare(RefMCPower) and any("rarest level" in w for w in got)


def test_wide_designs_and_scenarios_still_raise(runs):
    """A design wider than p = 16 raises B10 before any run; README flow 1's
    last line, ``scenarios=True``, now runs its three scenarios."""
    m = MCPower("y ~ x1 + g")
    m.set_variable_type("g=(factor,17)")  # p = 18
    m.set_effects(", ".join(f"{n}=0.1" for n in m.effect_names))
    with pytest.raises(NotImplementedError, match=r"p > 16 \(ROADMAP B10\)"):
        m.find_power(200, n_sims=8, verbose=False, device="cpu")
    assert runs == []
    readme = chip_smoke.build_model(MCPower, "readme")
    res = readme.find_sample_size(from_size=50, to_size=500, scenarios=True, n_sims=8,
                                  verbose=False, device="cpu")
    assert sorted(res["scenarios"]) == ["doomer", "optimistic", "realistic"]
    assert runs == ["cpu"] * 3
