"""The port's scenario generation (ROADMAP A10) against ``mcpower_tpu``.

The reference's per-sim pieces (``_design_draw``, ``_unit_residual_draws``,
``_re_draw``, ``generate``, the marginals) run op by op, without ``jit``,
the form the port follows (tests/test_torch_datagen.py), on the same Philox
words as the port's fills:

* integer draws bit for bit: the marginal and residual swap codes and
  picks, and the factor levels a scenario samples;
* the per-sim mixing factor ``L`` (an f64 ``eigh`` and Cholesky on two
  LAPACKs, cast to f32) within a few f32 ULP;
* every residual family and every marginal, the heavy-tailed intercept and
  the jittered tau^2, the cluster-level broadcast and the heteroskedastic
  outcome, within the f32 bands measured and stated below;
* ``run_batch`` counts of three scenario designs against the reference's
  fused ``run_batch``, at most one flip per entry;
* a plan of more than 32 long streams, split over two K1 launches.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mcpower_tpu.engine import batch as ref_batch
from mcpower_tpu.engine import datagen as ref_datagen
from mcpower_tpu.engine import lower as ref_lower
from mcpower_tpu.engine import marginals as ref_marginals
from mcpower_tpu.engine import rng as ref_rng
from mcpower_tpu.engine.spec import ClusterStatic as RefCluster
from mcpower_tpu.engine.spec import ScenarioStatic as RefScenario
from mcpower_tpu_torch.config import SCENARIO_PRESETS
from mcpower_tpu_torch.engine import batch, datagen, lower, marginals, rng
from mcpower_tpu_torch.engine.spec import DIST_CODES, RESID_CODES, ClusterStatic, ScenarioStatic

SEED = chip_smoke.SEED
SIMS = 32


@pytest.fixture(scope="module", autouse=True)
def _first_cpu_math_call():
    """Take the process's first multi-threaded call of torch's CPU log,
    log1p and exp before any comparison: that call has been seen, in a
    loaded process, to return values ~1e-5 off on part of a tensor."""
    x = torch.rand(1 << 20) + 0.5
    for t in (x, x.double()):
        torch.log(t), torch.log1p(t), torch.exp(t), torch.sqrt(t)


def _ulp(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def _key(sid):
    k0, k1, _, _ = ref_rng.philox4x32(
        jnp.uint32(sid), jnp.uint32(0), jnp.uint32(ref_rng.CLASS_SIMKEY), jnp.uint32(0),
        jnp.uint32(SEED), jnp.uint32(0))
    return k0, k1


def _lowered(scenario, **kw):
    """``(reference spec, arrays), (port spec, arrays)`` of one design."""
    out = []
    for lower_mod, cluster_cls, sc_cls in ((ref_lower, RefCluster, RefScenario),
                                           (lower, ClusterStatic, ScenarioStatic)):
        args = dict(kw)
        if "cluster" in args:
            args["cluster"] = cluster_cls(**args["cluster"])
        sc = dict(SCENARIO_PRESETS.get(scenario, {}), **args.pop("knobs", {}))
        args["scenario"] = sc_cls.from_dict(scenario, sc)
        out.append(lower_mod.lower(**args))
    return out


def _draws(spec, sims=SIMS):
    ids = torch.arange(sims)
    return datagen.Draws([(p, rng.fill_streams(SEED, 0, ids, p[1], p[0]))
                          for p in datagen.fill_plan(spec)])


# A doomer LMM with three normal columns, one binary, one pinned and both
# swap pools widened to every family: every knob of _design_draw is on.
SWAP_DESIGN = dict(
    grid=[60], var_types=["normal", "normal", "binary", "normal"], var_pinned=[False] * 3 + [True],
    corr=np.array([[1.0, 0.3, 0.1, 0.0], [0.3, 1.0, 0.2, 0.1], [0.1, 0.2, 1.0, 0.0],
                   [0.0, 0.1, 0.0, 1.0]]),
    effects=np.array([0.0, 0.3, 0.2, 0.1, 0.1]), target_cols=[1, 2], estimator="mle",
    cluster=dict(sizing_mode="fixed_clusters", sizing_value=6, tau_squared=0.25),
    knobs=dict(new_distributions=["right_skewed", "left_skewed", "uniform", "high_kurtosis"],
               residual_dists=["high_kurtosis", "right_skewed", "left_skewed", "uniform"]),
)


@pytest.fixture(scope="module")
def swap_design():
    (rs, ra), (ps, pa) = _lowered("doomer", **SWAP_DESIGN)
    arr = datagen.to_device(pa, "cpu")
    draws = _draws(ps)
    got = datagen.design_draw(ps, arr, draws, SIMS, "cpu")
    want = [ref_datagen._design_draw(rs, ra, _key(s)) for s in range(SIMS)]
    return ps, arr, draws, got, want


def test_swap_codes_and_picks_are_bit_identical(swap_design):
    _, _, _, (_, var_codes, resid_code, _), want = swap_design
    np.testing.assert_array_equal(var_codes.numpy(), [np.asarray(w[1]) for w in want])
    np.testing.assert_array_equal(resid_code.numpy(), [int(w[2]) for w in want])
    # the draw reaches every family of both pools, and the pinned column
    # (index 3) and the binary one (index 2) keep their codes
    assert set(var_codes[:, :2].flatten().tolist()) == {0, 2, 3, 4, 5}
    assert set(resid_code.tolist()) == {0, 1, 2, 3, 4}
    assert (var_codes[:, 2] == 1).all() and (var_codes[:, 3] == 0).all()


# L from an f64 eigh and Cholesky (two LAPACKs, built apart) cast to f32:
# measured bit-identical at every entry of magnitude 1e-4 or more, and
# within 1.1e-11 below (entries ~1e-9 that the f64 rounding moves by a few
# f32 ULP).
L_SMALL = 1e-4
L_SMALL_ABS = 1e-10
# tau^2 + z * sd: the ICC normal's log may differ by an ULP between XLA and
# torch; measured 0 ULP here.
TAU2_MAX_ULP = 2


def test_mixing_factor_and_tau2_within_f32_ulps(swap_design):
    _, _, _, (L, _, _, tau2), want = swap_design
    L, want_l = L.numpy(), np.stack([np.asarray(w[0]) for w in want])
    big = np.abs(want_l) >= L_SMALL
    np.testing.assert_array_equal(L[big], want_l[big])
    small = np.abs(L[~big] - want_l[~big]).max()
    ulp_t = _ulp(tau2.numpy(), [np.asarray(w[3])[0] for w in want])
    print(f"L: {big.sum()} entries identical, the rest within {small:.1e}; tau2_eff max "
          f"{ulp_t} ULP")
    assert small <= L_SMALL_ABS and ulp_t <= TAU2_MAX_ULP
    # jittered per sim, floored at 0 (icc noise sd 0.3 about tau^2 0.25)
    assert (tau2 >= 0).all() and (tau2 == 0).any() and len(set(tau2.tolist())) > SIMS // 2


def test_a_static_design_draw_has_no_scenario_streams():
    (_, _), (ps, pa) = _lowered("optimistic", **SWAP_DESIGN)
    assert datagen.scenario_plans(ps) == [] and len(datagen.fill_plan(ps)) == 1
    L, codes, resid, tau2 = datagen.design_draw(ps, datagen.to_device(pa, "cpu"), _draws(ps),
                                                SIMS, "cpu")
    assert codes is None and resid is None and tau2 == np.float32(0.25)
    assert torch.equal(L, torch.as_tensor(pa["corr_chol"]))


# The residual families on the same words: z and the chi-square planes are
# the same f32 normals but for the log's ULP, and t and chi-square add a
# square root and a division (measured max abs: normal 2.4e-7, t 1.2e-7,
# right and left skew 1.2e-6, uniform 0).
RESID_ABS = 2e-6


@pytest.mark.parametrize("family", sorted(RESID_CODES))
def test_residual_families_on_the_same_words(family):
    (rs, ra), (ps, _) = _lowered("optimistic", grid=[40], var_types=["normal"],
                                 effects=np.array([0.0, 0.2]), target_cols=[1],
                                 residual=family, knobs=dict(residual_df=6.4))
    assert datagen.chi2_planes(ps) == (6 if family in ("right_skewed", "left_skewed",
                                                       "high_kurtosis") else 0)
    got = datagen.unit_residuals(ps, _draws(ps, 8), None).numpy()
    want = np.stack([np.asarray(ref_datagen._unit_residual_draws(
        _key(s), 0, 40, jnp.int32(RESID_CODES[family]), 6.4)) for s in range(8)])
    err = np.abs(got - want).max()
    print(f"{family}: max abs {err:.2e}")
    assert err <= RESID_ABS and np.isfinite(got).all()


def test_a_per_sim_residual_family_selects_the_static_ones(swap_design):
    spec, _, draws, (_, _, resid_code, _), _ = swap_design
    got = datagen.unit_residuals(spec, draws, resid_code)
    for code in range(5):
        sims = resid_code == code
        static = datagen.unit_residuals(spec, draws, torch.full((SIMS,), code))
        assert torch.equal(got[sims], static[sims])


# The marginals on the same z: Phi(z) is torch's erf against XLA's, which
# differ by an f32 ULP on ~29% of inputs; -ln Phi(-z) and -ln Phi(z) amplify
# that near |z| = 3 (measured max abs 6.3e-5 right, 8.5e-5 left); the
# uniform is linear in Phi (4.8e-7). The t(3) quantile's six Newton steps
# on a CDF that cancels at 0.5 +- 0.5 lose precision as |z| grows: measured
# relative 7.9e-6 for |z| < 2, 2.1e-4 for 2 <= |z| < 3.5 and 0.28 beyond (u
# near its clamp 1e-7), where the reference's jitted and op-by-op forms
# also differ from each other, by about a third as much.
MARGINAL_ABS = {"normal": 0.0, "binary": 0.0, "right_skewed": 2e-4, "left_skewed": 2e-4,
                "uniform": 1e-6}
KURTOSIS_REL = ((2.0, 1e-4), (3.5, 1e-3), (np.inf, 0.5))


@pytest.mark.parametrize("name", ["normal", "binary", "right_skewed", "left_skewed",
                                  "high_kurtosis", "uniform"])
def test_marginals_against_the_reference(name):
    rs = np.random.RandomState(3)
    z = np.concatenate([rs.standard_normal(40000), rs.uniform(-6, 6, 4000)]).astype(np.float32)
    code = DIST_CODES[name]
    want = np.asarray(ref_marginals.apply_marginal_static(jnp.asarray(z), code, jnp.float32(0.3)))
    got = marginals.apply_marginal_static(torch.as_tensor(z), code, np.float32(0.3)).numpy()
    # the per-sim form selects the static candidates exactly: two "sims",
    # one of this marginal and one normal
    half = len(z) // 2
    dyn = marginals.apply_marginal(torch.as_tensor(z).reshape(2, half), torch.tensor([code, 0]),
                                   np.float32(0.3), [0, code])
    np.testing.assert_array_equal(dyn.numpy(), np.stack([got[:half], z[half:]]))
    assert np.isfinite(got).all()
    if name != "high_kurtosis":
        err = np.abs(got - want).max()
        print(f"{name}: max abs {err:.2e}")
        assert err <= MARGINAL_ABS[name]
        return
    rel = np.abs(got - want) / np.abs(want)
    lo = 0.0
    for hi, band in KURTOSIS_REL:
        sel = (np.abs(z) >= lo) & (np.abs(z) < hi)
        print(f"high_kurtosis |z| in [{lo}, {hi}): max rel {rel[sel].max():.2e}")
        assert rel[sel].max() <= band
        lo = hi
    assert (np.sign(got) == np.sign(want)).all()


# The heavy-tailed t(df) intercept, u = z * chol(tau2_eff): a square root
# and a division on the same normals (measured max abs 0 at df 10, 1.2e-7
# at df 5).
RE_ABS = 1e-6


@pytest.mark.parametrize("scenario", ["realistic", "doomer"])
def test_heavy_tailed_intercept_against_the_reference(scenario):
    (rs, ra), (ps, pa) = _lowered(scenario, grid=[100], var_types=["normal"],
                                  effects=np.array([0.0, 0.2]), target_cols=[1], estimator="mle",
                                  cluster=dict(sizing_mode="fixed_size", sizing_value=10,
                                               tau_squared=0.3))
    planes = SCENARIO_PRESETS[scenario]["random_effect_df"]
    assert datagen.heavy_re_planes(ps) == planes
    draws = _draws(ps, 8)
    _, _, _, tau2 = datagen.design_draw(ps, datagen.to_device(pa, "cpu"), draws, 8, "cpu")
    got = (datagen.re_draws(ps, draws) * datagen.re_chol(tau2, ())[:, 0]).numpy()
    want = []
    for s in range(8):
        tau2_ref = ref_datagen._design_draw(rs, ra, _key(s))[3]
        z = ref_datagen._re_draw(rs, _key(s), 0, 10)
        want.append(np.asarray(z * ref_datagen._re_chol(tau2_ref[0], ())[0, 0]))
    err = np.abs(got - np.stack(want)).max()
    print(f"{scenario}: max abs {err:.2e}")
    assert err <= RE_ABS


def _ref_generate(rs, ra, sims):
    out = [ref_datagen.generate(rs, ra, _key(s)) for s in range(sims)]
    return [np.stack([np.asarray(o[i]) for o in out]) for i in range(2)]


# X and y of whole designs: the skewed marginals' band (above) plus the f32
# mix and X @ beta in another summation order.
GEN_ABS = 2e-4


def test_cluster_level_columns_are_broadcast_within_clusters():
    """x1 measured at cluster level (``between_cols``): every row takes the
    value of its cluster's first row, before the interaction x1:x2 is
    formed; blocked and round-robin clusters."""
    for mode, size in (("fixed_size", 8), ("fixed_clusters", 5)):
        (rs, ra), (ps, pa) = _lowered(
            "realistic", grid=[40], var_types=["normal", "binary"], interactions=[(1, 2)],
            effects=np.array([0.0, 0.3, 0.2, 0.1]), target_cols=[1, 2, 3], estimator="mle",
            cluster=dict(sizing_mode=mode, sizing_value=size, tau_squared=0.2,
                         between_cols=(1,)))
        X, y, ids = datagen.generate_batch(ps, datagen.to_device(pa, "cpu"), SEED, 0,
                                           torch.arange(4))
        rX, ry = _ref_generate(rs, ra, 4)
        first = {int(c): int(np.argmax(ids[0].numpy() == c)) for c in ids[0].unique()}
        rep = torch.tensor([first[int(c)] for c in ids[0]])
        assert torch.equal(X[:, :, 1], X[:, rep, 1]) and len(X[0, :, 1].unique()) == len(first)
        assert torch.equal(X[:, :, 3], X[:, :, 1] * X[:, :, 2])
        assert np.abs(X.numpy() - rX).max() <= GEN_ABS and np.abs(y.numpy() - ry).max() <= GEN_ABS


# Rows of y that differ from the reference at all: measured 11% (driver lp)
# and 10.5% (driver x2), from X @ beta summed in another order and the
# mix's rare ULP; in f32 throughout, 45% (both drivers). Largest difference
# measured 3.6e-7.
HET_ROWS_OFF = 0.2
HET_ABS = 1e-6


def test_sampled_factor_levels_under_a_scenario_are_bit_identical():
    """README flow 1's model under the realistic scenario draws its factor
    levels per row (``sampled_factor_proportions``) from the FACTOR words
    of the second fill: the dummies equal the reference's bit for bit, the
    binary column too, the rest within the generation band."""
    (rs, ra), (ps, pa) = _lowered(
        "realistic", grid=[40], var_types=["normal", "binary"], var_params=[0.5, 0.5],
        corr=np.array([[1.0, 0.3], [0.3, 1.0]]), factor_levels=[3],
        factor_props=[0.4, 0.3, 0.3], interactions=[(1, 2)],
        effects=np.array([0.0, 0.3, 0.25, 0.4, 0.2, 0.15]), target_cols=[1, 2, 3, 4, 5])
    assert datagen.sampled_factors(ps) == [0]
    X, y, _ = datagen.generate_batch(ps, datagen.to_device(pa, "cpu"), SEED, 0, torch.arange(4))
    rX, ry = _ref_generate(rs, ra, 4)
    np.testing.assert_array_equal(X[..., 2:5].numpy(), rX[..., 2:5])
    assert np.abs(X.numpy() - rX).max() <= GEN_ABS and np.abs(y.numpy() - ry).max() <= GEN_ABS


def test_heteroskedastic_outcome_is_promoted_to_f64():
    """The reference's f64 driver centre and sd promote the scaled residuals
    and y = eta + eps to f64 (x64 on), then round y to f32 once. The port's
    y agrees with it to the f32 tier; computed in f32 throughout, the same
    arithmetic lands farther away on most rows."""
    for driver in (None, 1):
        (rs, ra), (ps, pa) = _lowered(
            "optimistic", grid=[200], var_types=["normal", "normal"],
            corr=np.array([[1.0, 0.3], [0.3, 1.0]]), effects=np.array([0.5, 0.4, -0.3]),
            target_cols=[1, 2], het_driver=driver, knobs=dict(heteroskedasticity_ratio=4.0))
        arr = datagen.to_device(pa, "cpu")
        X, y, _ = datagen.generate_batch(ps, arr, SEED, 0, torch.arange(6))
        _, ry = _ref_generate(rs, ra, 6)
        # the same steps, every one in f32
        draws = _draws(ps, 6)
        eps = datagen.unit_residuals(ps, draws, None)
        lp = torch.matmul(X, arr["effects"].float())
        drv = lp if driver is None else X[..., driver]
        key = ("het_lp_mean", "het_lp_std") if driver is None else ("het_col_mean", "het_col_std")
        center, std = (arr[k].float() if driver is None else arr[k][driver].float() for k in key)
        gamma = np.log(4.0) / 4.0
        mult = torch.exp(marginals.f32(gamma) * ((drv - center) / std)) * marginals.f32(
            np.exp(-gamma * gamma / 2))
        y32 = lp + eps * torch.sqrt(mult)
        got_off, f32_off = (y.numpy() != ry).mean(), (y32.numpy() != ry).mean()
        err = np.abs(y.numpy() - ry).max()
        print(f"driver {driver}: port {got_off:.1%} of rows off the reference (max abs "
              f"{err:.1e}); f32 throughout {f32_off:.1%}")
        assert got_off <= HET_ROWS_OFF and err <= HET_ABS
        assert f32_off >= 2 * HET_ROWS_OFF


# run_batch counts against the reference's fused program at 64 sims: the
# composed OLS scenario of tests/test_ols_power.py:198 (heterogeneity 0.3,
# residual swap 0.5 over t(8) and chi-square(8), alpha 5e-7), a realistic
# LMM and a doomer logit.
RUN_DESIGNS = {
    "ols_composed_scenario": None,  # chip_smoke.SCENARIO_ARMS
    "lmm_realistic": dict(grid=[100, 200], var_types=["normal", "normal"],
                          corr=np.array([[1.0, 0.3], [0.3, 1.0]]),
                          effects=np.array([0.0, 0.3, 0.2]), target_cols=[1, 2],
                          estimator="mle",
                          cluster=dict(sizing_mode="fixed_clusters", sizing_value=20,
                                       tau_squared=0.25), scenario="realistic"),
    "logit_doomer": dict(grid=[300], var_types=["normal", "normal", "normal"],
                         effects=np.array([-0.4, 0.3, 0.2, 0.15]), target_cols=[1, 2, 3],
                         outcome="binary", estimator="glm", correction="bonferroni",
                         scenario="doomer"),
}


@pytest.mark.parametrize("name", sorted(RUN_DESIGNS))
def test_run_batch_counts_against_the_reference(name):
    """The scenario arm of chip_smoke.py runs GOLDEN_SIMS sims (in chunks
    of 64, the compile of the others), whose counts are its golden ones."""
    n = 64
    if RUN_DESIGNS[name] is None:
        want_in = chip_smoke.lower_design(ref_lower, RefCluster, name)
        got_in = chip_smoke.lower_design(lower, ClusterStatic, name)
        n = chip_smoke.GOLDEN_SIMS
    else:
        kw = dict(RUN_DESIGNS[name])
        (want_in, got_in) = _lowered(kw.pop("scenario"), **kw)
    want = ref_batch.run_batch(*want_in, n, SEED, chunk_size=64)
    got = batch.run_batch(*got_in, n, SEED, chunk_size=64, device="cpu")
    if name in chip_smoke.GOLDEN:
        assert {k: np.asarray(v).tolist() for k, v in want.items()} == chip_smoke.GOLDEN[name]
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g, w = np.asarray(got[key]), np.asarray(w)
        if key == "tau2_hat":
            np.testing.assert_allclose(g, w, rtol=chip_smoke.TAU2_REL)
        elif key == "glm_baseline":  # sums of realized outcome means: a flipped row moves it
            np.testing.assert_allclose(g, w, rtol=chip_smoke.GLM_BASELINE_REL)
        else:
            flips = np.abs(g.astype(np.int64) - w.astype(np.int64)).max()
            assert flips <= chip_smoke.MAX_FLIPS, key


def test_a_33_stream_plan_fills_in_two_k1_launches():
    """13 predictors in a realistic LMM fill 13 + 11 + 9 long normal streams
    (predictors, heavy-tailed intercept planes, residual and chi-square
    planes): two K1 launches, joined along the stream axis, each stream at
    the reference's addresses and 0 past its rows. ``fill_in_launches``
    splits K1's fills; here it splits the plain fill the same way, and the
    joined parts equal one plain fill of all 33 streams."""
    (_, _), (ps, _) = _lowered("realistic", grid=[200], var_types=["normal"] * 13,
                               effects=np.zeros(14), target_cols=[1], estimator="mle",
                               cluster=dict(sizing_mode="fixed_clusters", sizing_value=20,
                                            tau_squared=0.25))
    plan = datagen.stream_plan(ps)
    assert len(plan) == 33 and datagen.k1_launches(ps) == 4
    assert sum(len(streams) for _, streams in datagen.fill_plan(ps)) == 40
    ids = torch.arange(3)
    words = rng.fill_in_launches(rng.fill_streams_plain, SEED, 0, ids, plan,
                                 rng.MODE_WORDS).numpy()
    normals = rng.fill_in_launches(rng.fill_streams_plain, SEED, 0, ids, plan, rng.MODE_NORMAL)
    np.testing.assert_array_equal(words, rng.fill_streams(SEED, 0, ids, plan, rng.MODE_WORDS))
    np.testing.assert_array_equal(normals, rng.fill_streams(SEED, 0, ids, plan))
    for s in range(3):
        for i, (cls, col, rows) in enumerate(plan):
            want = np.asarray(ref_rng.fill_raw(_key(s), cls, col, 0, rows))
            np.testing.assert_array_equal(words[s, i, :rows], want)
            assert not words[s, i, rows:].any() and not normals[s, i, rows:].any()
    np.testing.assert_array_equal(
        normals, rng.norm_ppf_f32(rng.u32_to_open_uniform(torch.as_tensor(words)))
        * (torch.as_tensor(words) != 0))
