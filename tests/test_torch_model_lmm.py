"""The port's ``MCPower`` against the JAX reference's on the
random-intercept LMM flows of ``chip_smoke.py`` (``model_lmm_power``,
``model_lmm_sample_size``, whose grid snaps to multiples of the 20
clusters): whole result trees at 64 sims on the CPU, the golden values of
the chip run recomputed with the reference, and the calls that must raise."""

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
FLOWS = ["model_lmm_power", "model_lmm_sample_size"]


@pytest.fixture(scope="module", autouse=True)
def _first_cpu_math_call():
    """Take the process's first multi-threaded call of torch's CPU log,
    log1p and exp before any comparison: that call has been seen, in a
    loaded process, to return values ~1e-5 off on part of a tensor."""
    x = torch.rand(1 << 20) + 0.5
    for t in (x, x.double()):
        torch.log(t), torch.log1p(t), torch.exp(t), torch.sqrt(t)


@pytest.mark.parametrize("name", FLOWS)
def test_result_tree_matches_the_reference(name):
    got = chip_smoke.run_flow(MCPower, name, SIMS, device="cpu")
    want = chip_smoke.run_flow(RefMCPower, name, SIMS)
    chip_smoke.compare_trees(name, got, want)
    assert "mle" in got["estimator_extras"] and got.summary()


def test_the_sample_size_grid_snaps_to_the_cluster_atom():
    got = chip_smoke.run_flow(MCPower, "model_lmm_sample_size", 8, device="cpu")
    assert got["cluster_atom"] == 20
    assert got["sample_sizes"] == list(range(100, 401, 20))


@pytest.mark.parametrize("name", FLOWS)
def test_golden_values_of_chip_smoke_are_the_references(name):
    n = chip_smoke.GOLDEN_SIMS
    want = chip_smoke.flow_summary(chip_smoke.run_flow(RefMCPower, name, n))
    chip_smoke.compare_trees(name, chip_smoke.MODEL_GOLDEN[name], want, max_flips=0,
                             tau_rel=1e-12)
    got = chip_smoke.flow_summary(chip_smoke.run_flow(MCPower, name, n, device="cpu"))
    chip_smoke.compare_trees(name, got, want)


def _lmm():
    return chip_smoke.build_model(MCPower, "lmm")


@pytest.mark.parametrize("method", ["find_power", "find_sample_size"])
def test_the_default_device_is_the_card(monkeypatch, method):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = dict(sample_size=200) if method == "find_power" else dict(from_size=100, to_size=200)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(_lmm(), method)(**args, n_sims=8, verbose=False)


@pytest.mark.parametrize("change,item", [
    ("scenarios", "A12"),
    ("slopes", "A12"),
])
def test_unported_lmm_designs_raise_before_any_run(monkeypatch, change, item):
    """The LMM's random slopes run (tests/test_torch_model_slopes.py), and so
    does the same model as a clustered logit with a random slope (a GLMM with
    slopes, tests/test_torch_model_glmm_slopes.py) and with a crossed second
    grouping beside the slope (A12, kernel K12); with 110 raters (a joint Z
    of 20 x 2 + 110 columns) it is past K12's M <= 128 and raises naming
    K12. The LMM's scenarios run (tests/test_torch_model_scenarios.py), and
    so does the same model as a clustered logit with a crossed second
    grouping (A12, K12); with 110 raters under ``scenarios=True`` it raises
    naming K12."""
    calls = []
    monkeypatch.setattr(runner.batch, "run_batch", lambda *a, **k: calls.append(1))
    m = _lmm()
    kw = {}
    if change == "scenarios":
        kw["scenarios"] = True
        m = MCPower("y ~ x1 + x2 + (1|cluster) + (1|rater)", family="logit")
        m.set_cluster("cluster", ICC=0.2, n_clusters=20)
        m.set_cluster("rater", ICC=0.1, n_clusters=110)
        m.set_baseline_probability(0.3)
        m.set_effects("x1=0.3, x2=0.2")
    else:
        m = MCPower("y ~ x1 + x2 + (1 + x1|cluster) + (1|rater)", family="logit")
        m.set_cluster("cluster", tau_squared=0.25, n_clusters=20, random_slopes=["x1"],
                      slope_variance=0.1)
        m.set_cluster("rater", ICC=0.1, n_clusters=110)
        m.set_baseline_probability(0.3)
        m.set_effects("x1=0.3, x2=0.2")
    with pytest.raises(NotImplementedError,
                       match="kernel K12" if item == "A12" else f"ROADMAP {item}"):
        m.find_power(200, n_sims=8, verbose=False, device="cpu", **kw)
    assert calls == []
