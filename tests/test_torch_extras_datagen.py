"""The port's extra-grouping generation against ``mcpower_tpu.engine.datagen``.

Designs (the primary grouping round-robin over 6 clusters unless named):
crossed (4 levels), nested (3 per parent), nested under a fixed cluster size
of 8 rows, and two extra groupings (crossed 4, then nested 2 per parent) under
a heavy-tailed t(5) random-effect distribution with ICC noise. Checks:

* ``extra_grouping_ids`` and the level counts are the reference's, bit for
  bit (integer iota math), and the reference rejects what the port rejects;
* the CLUSTER words of every extra grouping's component (column
  ``(g + 1) * 1024 + c * 32`` and, heavy-tailed, the chi-square planes after
  it, at the grouping's level count) are the reference's, bit for bit;
* each grouping's ``tau2_eff`` under ICC noise (one ICC draw per grouping,
  the primary's unchanged) within TAU2_MAX_ULP of the reference's
  ``_design_draw``;
* the whole ``generate_batch`` against the reference's jitted one within the
  band of tests/test_torch_datagen.py (WHOLE_ABS: the reference's
  FMA-contracted normals), cluster ids exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpower_tpu.engine import datagen as ref_datagen
from mcpower_tpu.engine import lower as ref_lower
from mcpower_tpu.engine import rng as ref_rng
from mcpower_tpu.engine.spec import ClusterStatic as RefCluster
from mcpower_tpu.engine.spec import ExtraGroupingStatic as RefExtra
from mcpower_tpu.engine.spec import ScenarioStatic as RefScenario
from mcpower_tpu_torch.engine import datagen, lower, rng
from mcpower_tpu_torch.engine.spec import ClusterStatic, ExtraGroupingStatic, ScenarioStatic

SEED_LO, SEED_HI = 2137, 5
SIMS = np.arange(16, dtype=np.uint32)
WHOLE_ABS = 1e-3  # tests/test_torch_datagen.py's band (the reference's FMA-contracted ppf)
TAU2_MAX_ULP = 2  # tau^2 + z sd: the ICC normal's log may differ by an ULP
DESIGNS = {  # sizing, extras (relation, levels, tau^2), heavy-tailed with ICC noise
    "crossed": (("fixed_clusters", 6), [("crossed", 4, 0.15)], False),
    "nested": (("fixed_clusters", 6), [("nested", 3, 0.1)], False),
    "nested_fixed_size": (("fixed_size", 8), [("nested", 3, 0.1)], False),
    "two_heavy_icc": (("fixed_clusters", 6), [("crossed", 4, 0.15), ("nested", 2, 0.1)], True),
}
GRID = [48, 96]


def _lowered(low, cluster_cls, extra_cls, scenario_cls, name):
    (mode, value), extras, heavy = DESIGNS[name]
    kw = {}
    if heavy:
        kw["scenario"] = scenario_cls(label="heavy", random_effect_dist="heavy_tailed",
                                      random_effect_df=5.0, icc_noise_sd=0.15)
    return low.lower(grid=GRID, var_types=["normal", "normal"],
                     corr=np.array([[1.0, 0.3], [0.3, 1.0]]), effects=np.array([0.0, 0.3, 0.2]),
                     target_cols=[1, 2], estimator="mle",
                     cluster=cluster_cls(mode, value, 0.25, extra_groupings=tuple(
                         extra_cls(rel, lv, tau2) for rel, lv, tau2 in extras)), **kw)


@pytest.fixture(scope="module", params=sorted(DESIGNS))
def design(request):
    name = request.param
    ref_spec, ref_arr = _lowered(ref_lower, RefCluster, RefExtra, RefScenario, name)
    spec, arr = _lowered(lower, ClusterStatic, ExtraGroupingStatic, ScenarioStatic, name)
    return dict(name=name, spec=spec, arr=arr, ref_spec=ref_spec, ref_arr=ref_arr)


def _ref_key(sid):
    k0, k1, _, _ = ref_rng.philox4x32(
        sid, jnp.uint32(0), jnp.uint32(ref_rng.CLASS_SIMKEY), jnp.uint32(0),
        jnp.uint32(SEED_LO), jnp.uint32(SEED_HI))
    return k0, k1


def test_level_ids_are_the_references(design):
    spec, ref_spec = design["spec"], design["ref_spec"]
    for g in range(len(spec.cluster.extra_groupings)):
        ids, n_lv = datagen.extra_grouping_ids(spec, g)
        want, want_lv = ref_datagen.extra_grouping_ids(ref_spec, g)
        assert ids.dtype == torch.int32 and n_lv == want_lv
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want))
        # every level is used within the first atom multiple that holds them all
        assert set(ids.tolist()) == set(range(n_lv))


def test_crossed_under_a_fixed_cluster_size_is_rejected_as_the_reference_does():
    for low, cl, ex, sc, mod in ((ref_lower, RefCluster, RefExtra, RefScenario, ref_datagen),
                                 (lower, ClusterStatic, ExtraGroupingStatic, ScenarioStatic,
                                  datagen)):
        spec, _ = low.lower(grid=[48], var_types=["normal"], corr=np.eye(1),
                            effects=np.array([0.0, 0.3]), target_cols=[1], estimator="mle",
                            cluster=cl("fixed_size", 8, 0.25,
                                       extra_groupings=(ex("crossed", 4, 0.1),)))
        with pytest.raises(ValueError, match="crossed extra groupings require fixed_clusters"):
            mod.extra_grouping_ids(spec, 0)


def test_cluster_words_of_every_extra_grouping_are_the_references(design):
    spec = design["spec"]
    planes = datagen.heavy_re_planes(spec)
    assert (planes > 0) == design["name"].startswith("two_heavy")
    extras = [s for s in datagen.stream_plan(spec)
              if s[0] == rng.CLASS_CLUSTER and s[1] >= datagen.GROUPING_COLUMNS]
    want_plan = [(rng.CLASS_CLUSTER, (g + 1) * 1024 + c, datagen.extra_grouping_ids(spec, g)[1])
                 for g in range(len(spec.cluster.extra_groupings)) for c in range(1 + planes)]
    assert extras == want_plan
    words = rng.fill_streams(SEED_LO, SEED_HI, torch.as_tensor(SIMS.astype(np.int64)), extras,
                             rng.MODE_WORDS).numpy()

    @jax.jit
    def ref_words(sids):
        return jax.vmap(lambda sid: [ref_rng.fill_raw(_ref_key(sid), c, col, 0, rows)
                                     for c, col, rows in extras])(sids)

    for i, (w, (_, _, rows)) in enumerate(zip(ref_words(jnp.asarray(SIMS)), extras)):
        np.testing.assert_array_equal(words[:, i, :rows], np.asarray(w).astype(np.int64))


def _ulp(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return int(np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32)).max())


def test_tau2_of_every_grouping_under_icc_noise():
    ref_spec, ref_arr = _lowered(ref_lower, RefCluster, RefExtra, RefScenario, "two_heavy_icc")
    spec, arr = _lowered(lower, ClusterStatic, ExtraGroupingStatic, ScenarioStatic,
                         "two_heavy_icc")
    plans = datagen.fill_plan(spec)
    sids = torch.as_tensor(SIMS.astype(np.int64))
    draws = datagen.Draws([(plan, rng.fill_streams(SEED_LO, SEED_HI, sids, plan[1], plan[0]))
                           for plan in plans])
    _, _, _, tau2 = datagen.design_draw(spec, datagen.to_device(arr, "cpu"), draws, len(SIMS),
                                        "cpu")
    got = np.stack([tau2.numpy()] + [t.numpy() for t in datagen.extra_tau2_eff(spec, draws)], -1)
    want = np.stack([np.asarray(ref_datagen._design_draw(ref_spec, ref_arr, _ref_key(s))[3])
                     for s in SIMS])
    assert got.shape == want.shape == (len(SIMS), 3)
    ulp = _ulp(got, want)
    print(f"tau2_eff per grouping: max {ulp} ULP; jittered values {len(set(got.ravel()))}")
    assert ulp <= TAU2_MAX_ULP and len(set(got[:, 1].tolist())) > len(SIMS) // 2


def test_generate_batch_matches_the_reference(design):
    X, y, ids = (v.numpy() for v in datagen.generate_batch(
        design["spec"], datagen.to_device(design["arr"], "cpu"), SEED_LO, SEED_HI,
        torch.as_tensor(SIMS.astype(np.int64))))
    rX, ry, rids = (np.asarray(v) for v in ref_datagen.generate_batch(
        design["ref_spec"], design["ref_arr"], jnp.uint32(SEED_LO), jnp.uint32(SEED_HI),
        jnp.asarray(SIMS)))
    np.testing.assert_array_equal(ids, rids)
    assert X.dtype == y.dtype == np.float32
    err = max(np.abs(X - rX).max(), np.abs(y - ry).max())
    print(f"{design['name']}: X and y within {err:.2e}")
    assert err <= WHOLE_ABS
