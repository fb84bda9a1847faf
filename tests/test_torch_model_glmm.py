"""The port's ``MCPower`` against the JAX reference's on README flow 3 (the
random-intercept logistic GLMM, kernel K7's plain version on the CPU): whole
result trees at 64 sims (``chip_smoke.compare_trees``: at most one flip per
count, every other value equal where the counts are) for ``find_power(480)``
as written, ``find_power(480, agq=7)`` and ``find_power(480,
wald_se="hessian")``, the golden values of those three chip-run flows
recomputed with the reference, the estimation options reaching the fit, and
the default device. tests/test_torch_model_glmm_search.py has the
sample-size search, tests/test_torch_model_glmm_scenarios.py the
scenarios."""

import sys
from pathlib import Path

import pytest
import torch

import mcpower_tpu  # noqa: F401  (x64 on, as the reference runs)
from mcpower_tpu import MCPower as RefMCPower
from mcpower_tpu_torch import MCPower
from mcpower_tpu_torch.engine import glmmfit

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

SIMS = 64
FLOWS = ["model_glmm_power", "model_glmm_agq", "model_glmm_hessian"]


THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def _first_cpu_math_call():
    """Take the process's first multi-threaded call of torch's CPU log,
    log1p and exp before any comparison: that call has been seen, in a
    loaded process, to return values ~1e-5 off on part of a tensor. The
    plain GLMM is many small operations: run them on THREADS threads, so
    that parallel test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    x = torch.rand(1 << 20) + 0.5
    for t in (x, x.double()):
        torch.log(t), torch.log1p(t), torch.exp(t), torch.sqrt(t)
    yield
    torch.set_num_threads(threads)


def check_tree(name):
    got = chip_smoke.run_flow(MCPower, name, SIMS, device="cpu")
    want = chip_smoke.run_flow(RefMCPower, name, SIMS)
    chip_smoke.compare_trees(name, got, want, tau_rel=chip_smoke.GLMM_TAU2_REL)
    assert got.summary()
    return got


def check_golden(name):
    """The chip run's golden values are the reference's at GOLDEN_SIMS."""
    want = chip_smoke.flow_summary(chip_smoke.run_flow(RefMCPower, name, chip_smoke.GOLDEN_SIMS))
    chip_smoke.compare_trees(name, chip_smoke.MODEL_GOLDEN[name], want, max_flips=0,
                             tau_rel=1e-12)


@pytest.mark.parametrize("name", FLOWS)
def test_result_tree_matches_the_reference(name):
    got = check_tree(name)
    assert "glm" in got["estimator_extras"] and got["sample_sizes"] == [480]


@pytest.mark.parametrize("name", FLOWS)
def test_golden_values_of_chip_smoke_are_the_references(name):
    check_golden(name)


@pytest.mark.parametrize("kw,nagq,hessian", [
    ({}, 1, False), ({"agq": 7}, 7, False), ({"wald_se": "hessian"}, 1, True),
])
def test_the_estimation_options_reach_the_fit(monkeypatch, kw, nagq, hessian):
    seen = []
    real = glmmfit.glmm_intercept_plain
    monkeypatch.setattr(glmmfit, "glmm_intercept_plain",
                        lambda *a, **k: seen.append(a[7:9]) or real(*a, **k))
    chip_smoke.build_model(MCPower, "glmm").find_power(480, n_sims=8, verbose=False,
                                                       device="cpu", **kw)
    assert seen == [(nagq, hessian)]


@pytest.mark.parametrize("method", ["find_power", "find_sample_size"])
def test_the_default_device_is_the_card(monkeypatch, method):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = dict(sample_size=480) if method == "find_power" else dict(from_size=240, to_size=720)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(chip_smoke.build_model(MCPower, "glmm"), method)(**args, n_sims=8,
                                                                 verbose=False)
