"""The GLMM with extra groupings through the port's ``MCPower`` on the CPU
(kernel K12's plain version): the host layers against the JAX reference's,
and the crossed flow at a few sims.

* README flow 3 with a crossed rater, with wards nested in its clinics
  (``n_per_parent`` and the ``clinic:ward`` child name) and with a slope on
  dose beside the rater (``chip_smoke.MODELS``: ``glmm_crossed``,
  ``glmm_nested``, ``glmm_dense_extras``), each sized by one ``set_cluster``
  per grouping: the contract equal to the reference's, and the reference's
  contract carried across lowers to the same spec and arrays (the extra
  groupings, their level counts and tau^2, the link and nagq 1);
* the crossed flow's ``find_power`` at SIMS sims through ``device="cpu"``:
  K12's dispatch taken once a chunk (its plain version on CPU tensors), a
  per-component boundary row of both groupings; its sample-size grid on the
  240-row atom (24 clinics x 10 raters): 240, 480 and 720; ``agq=7`` with
  extra groupings runs at Laplace with a warning in both packages (the
  contract's invariant 25 makes it ineligible).

The reference's compile of these programs takes minutes on the CPU, so its
results are held in chip_smoke.py's golden values (computed at GOLDEN_SIMS by
golden_values.py) and the fits in tests/test_torch_glmm_extras*.py.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mcpower_tpu  # noqa: F401  (x64 on, as the reference runs)
from mcpower_tpu import MCPower as RefMCPower
from mcpower_tpu.contract import types as ref_types
from mcpower_tpu.engine import adapter as ref_adapter
from mcpower_tpu_torch import MCPower
from mcpower_tpu_torch.contract import types
from mcpower_tpu_torch.engine import adapter, carry, glmmfit

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

SIMS = 8
THREADS = 2
MODELS = {"glmm_crossed": (480, 10, 1), "glmm_nested": (480, 48, 1),
          "glmm_dense_extras": (480, 10, 2)}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    x = torch.rand(1 << 20) + 0.5
    for t in (x, x.double()):
        torch.log(t), torch.exp(t), torch.sqrt(t)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_the_contract_and_its_lowering_are_the_references(model):
    n, levels, q = MODELS[model]
    want_c = chip_smoke.build_model(RefMCPower, model).to_simulation_spec()
    assert chip_smoke.build_model(MCPower, model).to_simulation_spec() == want_c
    ref_c = ref_types.SimulationContract.from_dict(want_c)
    (s1, a1) = adapter.contract_to_lowered(types.SimulationContract.from_json(ref_c.to_json()),
                                           [n])
    (s2, a2) = carry.from_reference(*ref_adapter.contract_to_lowered(ref_c, [n]))
    assert dataclasses.asdict(s1) == dataclasses.asdict(s2)
    assert set(a1) == set(a2)
    for k in a1:
        np.testing.assert_array_equal(np.asarray(a1[k]), np.asarray(a2[k]), err_msg=k)
    assert (s1.outcome, s1.nagq, s1.cluster.q) == ("binary", 1, q)
    (eg,) = s1.cluster.extra_groupings
    levels_of = eg.n_levels * (s1.cluster.sizing_value if eg.relation == "nested" else 1)
    assert levels_of == levels and not glmmfit.extras_unsupported(s1)


def test_find_power_on_the_cpu(monkeypatch):
    calls = []
    real = glmmfit.glmm_extras_plain
    monkeypatch.setattr(glmmfit, "glmm_extras_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    res = chip_smoke.run_flow(MCPower, "model_glmm_crossed_power", SIMS, device="cpu")
    glm = res["estimator_extras"]["glm"]
    assert len(glm["boundary_component_counts"][0]) == 2
    assert min(res["convergence_rate"]) == 1.0 and calls == [1]
    assert "boundary_rate_per_component" in res.summary()


def test_the_sample_size_grid_is_the_atoms():
    res = chip_smoke.run_flow(MCPower, "model_glmm_crossed_sample_size", 4, device="cpu")
    assert res["cluster_atom"] == 240 and res["sample_sizes"] == [240, 480, 720]


def test_agq_with_extra_groupings_runs_at_laplace_as_in_the_reference():
    """``agq=7`` on a design with extra groupings is not AGQ-eligible (the
    contract's invariant 25): both packages warn and run it at Laplace."""
    for cls in (MCPower, RefMCPower):
        m = chip_smoke.build_model(cls, "glmm_crossed")
        with pytest.warns(UserWarning, match="not eligible for this design"):
            assert m._resolve_estimation(None, 7)[1] == 1
