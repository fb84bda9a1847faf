"""The port's ``MCPower`` against the JAX reference's on the GLM flows of
``chip_smoke.py`` (``model_logit_power``, ``model_logit_sample_size``,
``model_poisson_power``): whole result trees at 64 sims on the CPU, the
golden values of the chip run recomputed with the reference, every GLM
family on the CPU, and the GLM designs that must still raise."""

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

SIMS = 64
GLM_FLOWS = ["model_logit_power", "model_logit_sample_size", "model_poisson_power"]


@pytest.fixture(scope="module", autouse=True)
def _first_cpu_math_call():
    """Take the process's first multi-threaded call of torch's CPU log,
    log1p and exp before any comparison: that call has been seen, in a
    loaded process, to return values ~1e-5 off on part of a tensor."""
    x = torch.rand(1 << 20) + 0.5
    for t in (x, x.double()):
        torch.log(t), torch.log1p(t), torch.exp(t), torch.sqrt(t)


@pytest.mark.parametrize("name", ["model_logit_power", "model_poisson_power"])
def test_result_tree_matches_the_reference(name):
    got = chip_smoke.run_flow(MCPower, name, SIMS, device="cpu")
    want = chip_smoke.run_flow(RefMCPower, name, SIMS)
    chip_smoke.compare_trees(name, got, want)
    assert "GLM" in got.summary() and "glm.baseline" in got.summary()


@pytest.mark.parametrize("name", GLM_FLOWS)
def test_golden_values_of_chip_smoke_are_the_references(name):
    n = chip_smoke.GOLDEN_SIMS
    want = chip_smoke.flow_summary(chip_smoke.run_flow(RefMCPower, name, n))
    chip_smoke.compare_trees(name, chip_smoke.MODEL_GOLDEN[name], want, max_flips=0)
    got = chip_smoke.flow_summary(chip_smoke.run_flow(MCPower, name, n, device="cpu"))
    chip_smoke.compare_trees(name, got, want)


def _glm(family, formula="y ~ x1 + x2"):
    m = MCPower(formula, family=family)
    if family == "poisson":
        m.set_baseline_rate(2.0)
    else:
        m.set_baseline_probability(0.3)
    return m


@pytest.mark.parametrize("family", ["logit", "probit", "poisson"])
def test_every_glm_family_runs_on_the_cpu(family):
    m = _glm(family)
    m.set_effects("x1=0.3, x2=0.2")
    res = m.find_power(120, n_sims=16, verbose=False, device="cpu")
    assert res["n_sims"] == 16 and min(res["convergence_rate"]) > 0.9
    res = m.find_sample_size(from_size=60, to_size=120, by=30, n_sims=16, verbose=False,
                             device="cpu")
    assert len(res["sample_sizes"]) == 3


def test_the_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chip_smoke.build_model(MCPower, "logit").find_power(300, n_sims=8, verbose=False)


@pytest.fixture
def runs(monkeypatch):
    """The run_batch calls the runner makes."""
    calls = []
    real = runner.batch.run_batch
    monkeypatch.setattr(runner.batch, "run_batch",
                        lambda *a, **k: calls.append(k.get("device")) or real(*a, **k))
    return calls


def test_glm_designs_outside_the_slice_raise_before_any_run(runs):
    m = _glm("logit", "y ~ x1 + g")
    m.set_variable_type("g=(factor,16)")  # p = 17: factors run, this width does not
    m.set_effects(", ".join(f"{n}=0.2" for n in m.effect_names))
    with pytest.raises(NotImplementedError, match="ROADMAP B10"):
        m.find_power(200, n_sims=8, verbose=False, device="cpu")
    # a crossed GLMM runs (kernel K12); 110 raters beside 20 schools (M = 130)
    # is past K12's M <= 128
    m = _glm("logit", "y ~ x1 + (1|school) + (1|rater)")
    m.set_cluster("school", ICC=0.2, n_clusters=20)
    m.set_cluster("rater", ICC=0.1, n_clusters=110)
    m.set_effects("x1=0.3")
    with pytest.raises(NotImplementedError, match="kernel K12"):
        m.find_power(200, n_sims=8, verbose=False, device="cpu")
    assert runs == []
