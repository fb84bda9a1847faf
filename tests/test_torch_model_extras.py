"""The LMM with extra groupings through the port's ``MCPower`` on the CPU
(K2's joint mode and kernel K11's plain versions): the host layers against
the JAX reference's, and the flows at a few sims.

* examples/13_crossed_random_effects.py (subjects x items, crossed),
  examples/15_advanced_mixed_models.py's nested school/classroom and README
  flow 2 with a crossed rater (``chip_smoke.MODELS``), each sized by one
  ``set_cluster`` per grouping (``n_per_parent`` and the ``school:classroom``
  child name for the nested one): the contract equal to the reference's,
  and the reference's contract carried across lowers to the same spec and
  arrays (the extra groupings, their level counts and tau^2);
* ``find_power`` at SIMS sims through ``device="cpu"``: a per-component
  boundary row of every grouping in the report, K11's dispatch taken once a
  chunk; the sample-size grid snaps to the crossed atom (40 x 25 = 1,000
  rows), and a range that holds one feasible point raises as the
  reference's does; the default device is the card.

The reference's compile of these programs takes one to two minutes on the
CPU, so its results are held in chip_smoke.py's golden values (computed at
GOLDEN_SIMS) and the fits in tests/test_torch_extras_*.py.
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
from mcpower_tpu_torch.engine import adapter, carry, mixedfit

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

SIMS = 8
THREADS = 2
MODELS = {"crossed": 1000, "nested": 720, "dense_extras": 600}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    x = torch.rand(1 << 20) + 0.5
    for t in (x, x.double()):
        torch.log(t), torch.sqrt(t)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_the_contract_and_its_lowering_are_the_references(model):
    want_c = chip_smoke.build_model(RefMCPower, model).to_simulation_spec()
    assert chip_smoke.build_model(MCPower, model).to_simulation_spec() == want_c
    ref_c = ref_types.SimulationContract.from_dict(want_c)
    (s1, a1) = adapter.contract_to_lowered(types.SimulationContract.from_json(ref_c.to_json()),
                                           [MODELS[model]])
    (s2, a2) = carry.from_reference(*ref_adapter.contract_to_lowered(ref_c, [MODELS[model]]))
    assert dataclasses.asdict(s1) == dataclasses.asdict(s2)
    assert set(a1) == set(a2)
    for k in a1:
        np.testing.assert_array_equal(np.asarray(a1[k]), np.asarray(a2[k]), err_msg=k)
    assert len(s1.cluster.extra_groupings) == 1
    if model == "nested":
        eg = s1.cluster.extra_groupings[0]
        assert (eg.relation, eg.n_levels) == ("nested", 4)  # n_per_parent


@pytest.mark.parametrize("name,components", [("model_crossed_power", 2),
                                             ("model_nested_power", 2)])
def test_find_power_on_the_cpu(name, components, monkeypatch):
    calls = []
    real = mixedfit.joint_reml_plain
    monkeypatch.setattr(mixedfit, "joint_reml_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    res = chip_smoke.run_flow(MCPower, name, SIMS, device="cpu")
    mle = res["estimator_extras"]["mle"]
    assert len(mle["boundary_component_counts"][0]) == components
    assert min(res["convergence_rate"]) == 1.0 and calls == [1]
    assert "boundary_rate_per_component" in res.summary()


def test_the_sample_size_grid_snaps_to_the_crossed_atom():
    m = chip_smoke.build_model(MCPower, "crossed")
    ref = chip_smoke.build_model(RefMCPower, "crossed")
    for model in (m, ref):
        with pytest.raises(ValueError, match="single feasible point"):
            model.find_sample_size(from_size=500, to_size=1500, by=100, n_sims=4, verbose=False,
                                   **({"device": "cpu"} if model is m else {}))
    res = chip_smoke.run_flow(MCPower, "model_crossed_sample_size", 4, device="cpu")
    assert res["cluster_atom"] == 1000 and res["sample_sizes"] == [1000, 2000, 3000]


def test_the_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chip_smoke.run_flow(MCPower, "model_nested_power", SIMS)


def test_a_nested_child_needs_n_per_parent_as_in_the_reference():
    for cls in (MCPower, RefMCPower):
        m = cls("score = method + (1|school/classroom)", family="lme")
        with pytest.raises(ValueError, match="requires n_per_parent="):
            m.set_cluster("school:classroom", ICC=0.1, n_clusters=48)
