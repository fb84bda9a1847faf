"""The GLMM with random slopes (kernel K10's plain version on the CPU)
through the port's ``MCPower`` against the JAX reference's: README flow 3's
model with a random slope on dose (``chip_smoke.MODELS["glmm_slopes"]``).

* ``find_power(480)`` at SIMS sims, base seed 2137, through both packages:
  the port's whole result tree against the reference's
  (``chip_smoke.compare_trees``: the pin counts within SLOPE_GLMM_PIN_FLIPS,
  the mean tau^2 within SLOPE_GLMM_TAU2_REL, every other count within one
  flip, every other value equal where the counts are). The bands were
  measured at 1,024 sims against the reference (ROADMAP C); the port's plain
  path takes ~90 s there on this CPU, so this file runs SIMS and
  ``chip_smoke.py`` holds the card at 1,024 against the golden values;
* the fit goes through K10's dispatch, whose plain version serves only CPU
  tensors; the default device is the card; a design beyond K10's q <= 4
  raises before any run, naming K10;
* a Poisson model with ``(1+x|g)`` runs ``find_power`` with
  ``scenarios=True`` and ``wald_se="hessian"``, and ``find_sample_size``.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mcpower_tpu  # noqa: F401  (x64 on, as the reference runs)
from mcpower_tpu import MCPower as RefMCPower
from mcpower_tpu_torch import MCPower
from mcpower_tpu_torch.engine import batch, glmmfit, lower
from mcpower_tpu_torch.engine.spec import ClusterStatic, SlopeStatic

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

SIMS = 256
THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def _first_cpu_math_call():
    """Take the process's first multi-threaded call of torch's CPU log,
    exp and sqrt before any comparison (it has been seen to return values
    ~1e-5 off in a loaded process), and run the plain fit on THREADS
    threads, so that parallel test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    x = torch.rand(1 << 20) + 0.5
    for t in (x, x.double()):
        torch.log(t), torch.log1p(t), torch.exp(t), torch.sqrt(t), torch.erf(t)
    yield
    torch.set_num_threads(threads)


def test_the_slope_glmm_power_flow_against_the_reference():
    name = "model_glmm_slopes_power"
    got = chip_smoke.run_flow(MCPower, name, SIMS, device="cpu")
    want = chip_smoke.run_flow(RefMCPower, name, SIMS)
    flips = chip_smoke.compare_trees(name, got, want, pin_flips=chip_smoke.SLOPE_GLMM_PIN_FLIPS,
                                     tau_rel=chip_smoke.SLOPE_GLMM_TAU2_REL)
    print(f"{name}: port against the reference at {SIMS} sims: {flips or 'identical counts'}")
    glm = got["estimator_extras"]["glm"]
    assert got["sample_sizes"] == [480] and len(glm["boundary_component_counts"][0]) == 2
    assert got.summary()


def test_the_slope_glmm_runs_through_k10s_dispatch(monkeypatch):
    seen = []
    real = glmmfit.glmm_slope_plain
    monkeypatch.setattr(glmmfit, "glmm_slope_plain",
                        lambda *a, **k: seen.append(a[1].shape) or real(*a, **k))
    chip_smoke.build_model(MCPower, "glmm_slopes").find_power(480, n_sims=4, verbose=False,
                                                              device="cpu")
    assert seen == [(4, 480, 2)]


@pytest.mark.parametrize("method", ["find_power", "find_sample_size"])
def test_the_default_device_is_the_card(monkeypatch, method):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = dict(sample_size=480) if method == "find_power" else dict(from_size=240, to_size=720)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(chip_smoke.build_model(MCPower, "glmm_slopes"), method)(**args, n_sims=4,
                                                                        verbose=False)


def test_a_design_beyond_k10s_limits_raises_before_any_run(monkeypatch):
    """Four slopes (q = 5, a search over d = 15) pass K10's q <= 4."""
    spec, arr = lower.lower(
        grid=[200], var_types=["normal"] * 4, effects=np.array([-0.3, 0.3, 0.2, 0.1, 0.1]),
        target_cols=[1], outcome="binary", estimator="glm",
        cluster=ClusterStatic(sizing_mode="fixed_clusters", sizing_value=20, tau_squared=0.3,
                              slopes=tuple(SlopeStatic(design_col=c, variance=0.1,
                                                       intercept_corr=0.0) for c in range(1, 5))))
    assert spec.cluster.q == 5
    monkeypatch.setattr(batch, "run_sims", lambda *a, **k: pytest.fail("a run started"))
    with pytest.raises(NotImplementedError, match="kernel K10 takes q <= 4"):
        batch.run_batch(spec, arr, 8, 1, device="cpu")


def test_a_poisson_slope_glmm_runs_every_call():
    def model():
        m = MCPower("y ~ x + (1+x|site)", family="poisson")
        m.set_baseline_rate(2.0)
        m.set_cluster("site", tau_squared=0.1, n_clusters=12, random_slopes=["x"],
                      slope_variance=0.05)
        m.set_effects("x=0.2")
        return m

    res = model().find_power(120, n_sims=4, scenarios=True, wald_se="hessian", verbose=False,
                             device="cpu")
    assert sorted(res["scenarios"]) == ["doomer", "optimistic", "realistic"]
    for part in res["scenarios"].values():
        assert part["n_sims"] == 4
        assert np.isfinite(np.asarray(part["powers"]["uncorrected"], dtype=float)).all()
    res = model().find_sample_size(from_size=60, to_size=180, n_sims=4, verbose=False,
                                   device="cpu")
    assert res["sample_sizes"] == sorted(res["sample_sizes"]) and len(res["sample_sizes"]) > 1


def test_the_wrapper_takes_the_plain_version_only_on_the_cpu():
    X = torch.zeros((2, 40, 2), device="meta")
    y = torch.zeros((2, 40), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        glmmfit.glmm_slope(0, X, y, [0, 1], [1], [40], (True, 20, 20),
                           torch.zeros(2, dtype=torch.float64), [0.5, 0.1, 0.3],
                           [0.0, -np.inf, 0.0])
