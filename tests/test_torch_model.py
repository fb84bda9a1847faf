"""The port's ``MCPower`` against the JAX reference's on the OLS flows of
``chip_smoke.py`` (``model_ols_power``, ``model_ols_sample_size``): whole
result trees at 64 sims on the CPU, the golden values of the chip run
recomputed with the reference, and the calls that must raise: the default
device without a card, scenarios of a design outside the port, uploaded
data, the debug report and designs outside the port."""

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
FLOWS = ["model_ols_power", "model_ols_sample_size"]


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
    assert got.summary() and "Overall" in got.summary()


@pytest.mark.parametrize("name", FLOWS)
def test_golden_values_of_chip_smoke_are_the_references(name):
    n = chip_smoke.GOLDEN_SIMS
    want = chip_smoke.flow_summary(chip_smoke.run_flow(RefMCPower, name, n))
    chip_smoke.compare_trees(name, chip_smoke.MODEL_GOLDEN[name], want, max_flips=0,
                             tau_rel=1e-12)
    got = chip_smoke.flow_summary(chip_smoke.run_flow(MCPower, name, n, device="cpu"))
    chip_smoke.compare_trees(name, got, want)


def _ols():
    return chip_smoke.build_model(MCPower, "ols")


@pytest.mark.parametrize("method", ["find_power", "find_sample_size"])
def test_the_default_device_is_the_card(monkeypatch, method):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = dict(sample_size=200) if method == "find_power" else dict(from_size=50, to_size=100)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(_ols(), method)(**args, n_sims=8, verbose=False)


@pytest.fixture
def runs(monkeypatch):
    """The run_batch calls the runner makes."""
    calls = []
    real = runner.batch.run_batch
    monkeypatch.setattr(runner.batch, "run_batch",
                        lambda *a, **k: calls.append(k.get("device")) or real(*a, **k))
    return calls


def _glmm():
    """A GLMM with a crossed second grouping (tests/test_glmm.py:417-430's
    design) of 120 raters: the GLMM with extra groupings runs (kernel K12),
    but its joint Z of 12 + 120 columns is past K12's M <= 128."""
    m = MCPower("y ~ x1 + x2 + (1|site) + (1|rater)", family="logit")
    m.set_cluster("site", ICC=0.12, n_clusters=12)
    m.set_cluster("rater", ICC=0.08, n_clusters=120)
    m.set_baseline_probability(0.35)
    m.set_effects("x1=0.3, x2=0.2")
    return m


def test_scenarios_raise_before_any_run(runs):
    """Scenarios run (tests/test_torch_model_scenarios.py); on a design
    outside the port, a GLMM with an extra grouping past kernel K12's
    limit, every scenario is checked before the first runs, so the call
    raises naming K12 with nothing run (the sample-size range on its
    1,440-row atom)."""
    with pytest.raises(NotImplementedError, match="kernel K12"):
        _glmm().find_power(192, scenarios=True, n_sims=8, verbose=False, device="cpu")
    with pytest.raises(NotImplementedError, match="kernel K12"):
        _glmm().find_sample_size(from_size=1440, to_size=4320, scenarios=True, n_sims=8,
                                 verbose=False, device="cpu")
    assert runs == []
    _ols().find_power(200, n_sims=8, verbose=False, device="cpu")
    assert runs == ["cpu"]


@pytest.mark.parametrize("formula,family,types,item", [
    ("y ~ x1 + g", "logit", "g=(factor,16)", "B10"),
    ("y ~ x1 + g", "ols", "g=(factor,16)", "B10"),
    ("y ~ x1 + x2 + (1 + x1|cluster) + (1|rater)", "logit", "x2=right_skewed", "A12"),
])
def test_designs_outside_the_port_raise_before_any_run(runs, formula, family, types, item):
    """Fits wider than p = 16 raise naming B10. A GLMM with extra groupings
    (A12) runs, through kernel K12, up to a joint Z of M <= 128 columns: with
    110 raters beside 20 clusters with a slope (M = 150) it raises naming
    K12."""
    m = MCPower(formula, family=family)
    if family == "logit":
        m.set_baseline_probability(0.3)
    if "|" in formula:  # a random slope on x1 and a crossed second grouping
        m.set_cluster("cluster", tau_squared=0.25, n_clusters=20, random_slopes=["x1"],
                      slope_variance=0.1)
        m.set_cluster("rater", ICC=0.08, n_clusters=110)
    if types:
        m.set_variable_type(types)
    m.set_effects(", ".join(f"{n}=0.2" for n in m.effect_names))
    with pytest.raises(NotImplementedError,
                       match="kernel K12" if item == "A12" else f"ROADMAP {item}"):
        m.find_power(200, n_sims=8, verbose=False, device="cpu")
    assert runs == []


def test_unported_lazy_imports_raise_naming_their_item():
    m = _ols()
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        m.upload_data({"x1": [0.1, 0.2, 0.3]})
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        m.get_effects_from_data("y")
    with pytest.raises(NotImplementedError, match="ROADMAP A15"):
        m.debug(200)


def test_progress_and_cancel_follow_the_reference():
    def drive(cls, **kw):
        seen = []

        def cb(done, total):
            seen.append((done, total))
            return False  # cancel

        with pytest.raises(KeyboardInterrupt):
            chip_smoke.build_model(cls, "ols").find_power(
                200, n_sims=SIMS, verbose=False, progress_callback=cb, **kw)
        return seen

    assert drive(MCPower, device="cpu") == drive(RefMCPower) == [(SIMS, SIMS)]
