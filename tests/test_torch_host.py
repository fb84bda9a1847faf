"""The port's copy of the host layers (spec builder, contract, orchestrator
helpers, adapter) against the JAX reference's on the same inputs, with no
simulation but one: formula parsing, sample-size grids, crossing fits,
contract validation, ``MCPower.to_simulation_spec`` and the lowering of a
reference contract carried across as JSON (OLS, LMM, logit and Poisson);
then the width limits of the kernels (ROADMAP C1): a 91-point grid runs, at
4 sims against the reference, and designs wider than the kernels fail in the
preflight."""

import copy
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest

import mcpower_tpu  # noqa: F401  (x64 on, as the reference runs)
from mcpower_tpu import MCPower as RefMCPower
from mcpower_tpu.contract import types as ref_types, validate as ref_validate
from mcpower_tpu.engine import adapter as ref_adapter
from mcpower_tpu.engine import batch as ref_batch
from mcpower_tpu.engine import lower as ref_lower
from mcpower_tpu.orchestrator import crossing as ref_crossing, grid as ref_grid
from mcpower_tpu.engine.spec import ClusterStatic as RefCluster
from mcpower_tpu.specbuilder import formula as ref_formula
from mcpower_tpu_torch import MCPower
from mcpower_tpu_torch.contract import types, validate
from mcpower_tpu_torch.engine import adapter, batch, carry, datagen, lower
from mcpower_tpu_torch.engine.spec import ClusterStatic, ExtraGroupingStatic
from mcpower_tpu_torch.orchestrator import crossing, grid
from mcpower_tpu_torch.specbuilder import formula

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

FIXTURES = REPO / "tests" / "fixtures" / "formula-fixtures"
FORMULAS = [c["formula"] for c in json.loads((FIXTURES / "cases.json").read_text())["cases"]]
FORMULAS += [c["formula"] for c in json.loads((FIXTURES / "canonical-suite.json").read_text())["cases"]]


def _parsed(mod, text):
    try:
        p = mod.parse_formula(text)
    except mod.FormulaError as e:
        return ("error", str(e))
    return (p.dependent, p.predictors, p.terms, [r.to_dict() for r in p.random_effects])


def test_parse_formula_matches_the_reference():
    assert len(FORMULAS) > 28
    for text in FORMULAS:
        assert _parsed(formula, text) == _parsed(ref_formula, text), text


@pytest.mark.parametrize("case", [
    dict(args=(30, 200, "auto", "linear"), cluster=None),
    dict(args=(50, 500, 25, "linear"), cluster=None),
    dict(args=(20, 2000, "auto", "log"), cluster=None),
    dict(args=(20, 2000, 6, "log"), cluster=None),
    dict(args=(100, 400, "auto", "linear"), cluster=("fixed_clusters", 20)),
    dict(args=(55, 333, "auto", "linear"), cluster=("fixed_size", 8)),
    dict(args=(60, 900, "auto", "log"), cluster=("fixed_clusters", 15)),
    dict(args=(10, 90, "auto", "linear"), cluster=("fixed_clusters", 30)),
], ids=["linear", "linear_by", "log", "log_by", "atom_clusters", "atom_size", "atom_log",
        "atom_collapsed"])
def test_build_grid_matches_the_reference(case):
    cl = ClusterStatic(*case["cluster"], 0.25) if case["cluster"] else None
    if case["cluster"] and case["cluster"][0] == "fixed_clusters" and case["args"][3] == "log":
        cl = ClusterStatic(*case["cluster"], 0.25, extra_groupings=(
            ExtraGroupingStatic("crossed", 2, 0.1),))

    def run(mod):
        atom, hard_min = mod.cluster_atom(cl), mod.hard_min_n(cl)
        try:
            return atom, hard_min, mod.build_grid(*case["args"], atom, hard_min)
        except ValueError as e:
            return atom, hard_min, str(e)

    assert run(grid) == run(ref_grid)
    for n in (37, 200, 219):
        try:
            want = ref_grid.snap_single_n(cl, n)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                grid.snap_single_n(cl, n)
            continue
        assert grid.snap_single_n(cl, n) == want


N_SIMS = 200
SERIES = {
    "monotone": [20, 60, 110, 150, 175, 190, 196],
    "non_monotone": [20, 150, 60, 160, 90, 190, 196],
    "flat_blocks": [40, 90, 90, 90, 170, 170, 199],
    "not_reached": [10, 30, 50, 70, 90, 110, 130],
    "at_or_below_min": [170, 180, 190, 195, 198, 199, 200],
}


@pytest.mark.parametrize("name", list(SERIES))
def test_fit_crossing_and_pava_match_the_reference(name):
    ns = [50, 100, 150, 200, 250, 300, 350]
    counts = SERIES[name]
    for atom in (1, 10):
        got = crossing.fit_crossing(ns, counts, N_SIMS, 80.0, atom).to_dict()
        assert got == ref_crossing.fit_crossing(ns, counts, N_SIMS, 80.0, atom).to_dict()
    rates = np.asarray(counts) / N_SIMS
    np.testing.assert_array_equal(crossing.pava(rates), ref_crossing.pava(rates))
    fitted = crossing.pava(rates)
    assert np.all(np.diff(fitted) >= 0)


def _model(mcpower_cls, model):
    return chip_smoke.build_model(mcpower_cls, model)


@pytest.mark.parametrize("model", ["lmm", "ols", "logit", "poisson"])
def test_to_simulation_spec_matches_the_reference(model):
    assert _model(MCPower, model).to_simulation_spec() == _model(
        RefMCPower, model).to_simulation_spec()


def _broken(d, how):
    d = copy.deepcopy(d)
    if how == "coefficients":
        d["outcome"]["coefficients"] = d["outcome"]["coefficients"][:-1]
    elif how == "target_range":
        d["test"]["targets"] = [["marginal", 99]]
    elif how == "intercept_target":
        d["test"]["targets"] = [["marginal", 0]]
    elif how == "alpha":
        d["test"]["alpha"] = 1.5
    elif how == "correction":
        d["test"]["correction"] = "bogus"
    elif how == "correlations":
        d["generation"]["correlations"] = [[1.0, 1.2], [1.2, 1.0]]
    elif how == "column":
        d["design"] = d["design"] + [["direct", 42]]
        d["outcome"]["coefficients"] = d["outcome"]["coefficients"] + [0.1]
    return d


@pytest.mark.parametrize("how", ["coefficients", "target_range", "intercept_target", "alpha",
                                 "correction", "correlations", "column"])
def test_validate_messages_match_the_reference(how):
    d = _broken(_model(RefMCPower, "lmm").to_simulation_spec(), how)
    with pytest.raises(ref_validate.ContractError) as want:
        ref_validate.validate(ref_types.SimulationContract.from_dict(d))
    with pytest.raises(validate.ContractError) as got:
        validate.validate(types.SimulationContract.from_dict(d))
    assert (got.value.invariant, str(got.value)) == (want.value.invariant, str(want.value))


def _assert_lowered_equal(got, want):
    (s1, a1), (s2, a2) = got, want
    assert dataclasses.asdict(s1) == dataclasses.asdict(s2)
    assert set(a1) == set(a2)
    for k in a1:
        x, y = np.asarray(a1[k]), np.asarray(a2[k])
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("model,grid_ns", [("lmm", [200]), ("ols", [200]),
                                           ("ols", [50, 100, 250, 500]),
                                           ("lmm", [100, 200, 400]),
                                           ("logit", [300]), ("logit", [100, 350, 600]),
                                           ("poisson", [150])])
def test_a_reference_contract_carried_across_lowers_the_same(model, grid_ns):
    ref_c = ref_types.SimulationContract.from_dict(_model(RefMCPower, model).to_simulation_spec())
    want = carry.from_reference(*ref_adapter.contract_to_lowered(ref_c, grid_ns))
    ours = types.SimulationContract.from_json(ref_c.to_json())
    _assert_lowered_equal(adapter.contract_to_lowered(ours, grid_ns), want)


def test_the_lmm_flow_lowers_to_the_headline_design():
    """``model_lmm_power`` of chip_smoke lowers to DESIGNS['lmm_headline'],
    in the port and, carried across, in the reference."""
    m = _model(MCPower, "lmm")
    c = types.SimulationContract.from_dict(m.to_simulation_spec())
    want = chip_smoke.lower_design(lower, ClusterStatic, "lmm_headline")
    _assert_lowered_equal(adapter.contract_to_lowered(c, [200]), want)
    ref_c = ref_types.SimulationContract.from_dict(_model(RefMCPower, "lmm").to_simulation_spec())
    _assert_lowered_equal(carry.from_reference(*ref_adapter.contract_to_lowered(ref_c, [200])),
                          want)


def test_the_logit_flow_lowers_to_the_glm_arm_but_for_the_overall_test():
    """``model_logit_power`` of chip_smoke lowers to DESIGNS['glm_bonferroni_10k']
    except that MCPower reports the LRT overall test (report_overall and its
    crit row), its intercept, log(p / (1 - p)) of the baseline probability
    1 / (1 + e^0.4), is -0.4 within one ULP (and het_lp_mean with it), and
    the correction is the call's, not the contract's."""
    m = _model(MCPower, "logit")
    got = adapter.contract_to_lowered(types.SimulationContract.from_dict(m.to_simulation_spec()),
                                      [300])
    want = chip_smoke.lower_design(lower, ClusterStatic, "glm_bonferroni_10k")
    assert chip_smoke.lowered_differences(got, want) == [
        "spec.correction ('none' vs 'bonferroni')", "spec.report_overall (True vs False)",
        "array effects", "array het_lp_mean", "array overall_crit", "array t2_corrected_ranks"]
    np.testing.assert_allclose(got[1]["effects"], want[1]["effects"], rtol=0, atol=1e-15)


def test_a_91_point_grid_passes_the_gate_and_matches_the_reference():
    """find_sample_size(from_size=50, to_size=500, by=5)'s grid, beyond the
    64 points K2 once took, on the curve design at 4 sims."""
    spec, arr = chip_smoke.lower_design(lower, ClusterStatic, "c1_grid91")
    assert spec.n_grid == 91 and datagen.unsupported(spec) == ""
    want = ref_batch.run_batch(*chip_smoke.lower_design(ref_lower, RefCluster, "c1_grid91"), 4, 2137)
    got = batch.run_batch(spec, arr, 4, 2137, device="cpu")
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("n_pred,item", [
    (16, r"wide fits, p > 16 \(ROADMAP B10\)"),
    # K1 fills at most 32 streams a launch and rng.fill_streams splits longer
    # plans: a residual swap of df 31 reads the residual normals and 31
    # chi-square planes, 34 long streams with the 2 predictors' normals
    pytest.param(2, None, id=r"32-more than 32 generated streams \(ROADMAP A10\)"),
])
def test_wide_designs_raise_in_the_preflight(monkeypatch, n_pred, item):
    """p = 17 (16 predictors and the intercept) fails before any run, not
    in a kernel. More than 32 generated streams no longer limit a design:
    the df-31 residual swap passes the gate, fills its long normals in two
    K1 launches, and its result tree at 8 sims equals the reference's."""
    names = [f"x{i}" for i in range(1, n_pred + 1)]

    def model(cls):
        m = cls("y ~ " + " + ".join(names))
        m.set_effects(", ".join(f"{n}=0.1" for n in names))
        m.set_scenario_configs({"df31": dict(residual_change_prob=0.5, residual_df=31,
                                             heterogeneity=0.0, heteroskedasticity_ratio=1.0,
                                             correlation_noise_sd=0.0, icc_noise_sd=0.0,
                                             distribution_change_prob=0.0,
                                             sampled_factor_proportions=False,
                                             random_effect_dist="normal")})
        return m

    if item is None:
        kw = dict(scenarios=["df31"], n_sims=8, seed=5, verbose=False)
        spec = adapter.contract_to_lowered(types.SimulationContract.from_dict(
            model(MCPower).to_simulation_spec("df31")), [200])[0]
        assert len(datagen.stream_plan(spec)) == 34 and datagen.k1_launches(spec) == 3
        got = model(MCPower).find_power(200, device="cpu", **kw)
        chip_smoke.compare_trees("34 streams", got, model(RefMCPower).find_power(200, **kw))
        return
    calls = []
    from mcpower_tpu_torch.orchestrator import runner
    monkeypatch.setattr(runner.batch, "run_batch", lambda *a, **k: calls.append(1))
    with pytest.raises(NotImplementedError, match=item):
        model(MCPower).find_power(200, n_sims=8, verbose=False, device="cpu")
    assert calls == []
