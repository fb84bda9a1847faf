"""The port's random-slope generation against ``mcpower_tpu.engine.datagen``.

Two designs of 120 rows in 12 round-robin clusters: two correlated normal
predictors with random slopes on both (q = 3, correlations 0.3 and 0.1 to
the intercept), and a q = 2 design under a heavy-tailed t(5) random-effect
distribution with ICC noise (a per-sim Cholesky of D, its intercept
variance jittered). Checks:

* the CLUSTER words of every random-effect component (columns ``comp * 32``
  and, heavy-tailed, the chi-square planes after them) are the reference's,
  bit for bit;
* ``re_chol`` against the reference's ``_re_chol`` (f32 LAPACK against the
  port's smallchol order): within 2 ULP-scale (4e-7 relative); at q = 1 bit
  for bit;
* the whole ``generate_batch`` against the reference's jitted one within the
  band of tests/test_torch_datagen.py (WHOLE_ABS: the reference's
  FMA-contracted normals), cluster ids exact;
* the generation body on the reference's own normals within BODY_ABS: the
  slope terms ``u[ids, 1 + k] X[:, col_k]`` add f32 roundings of the mix
  ``z @ L^T`` (XLA's dot may contract it) to the intercept path's.
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
from mcpower_tpu.engine.spec import ScenarioStatic as RefScenario
from mcpower_tpu.engine.spec import SlopeStatic as RefSlope
from mcpower_tpu_torch.engine import datagen, lower, rng
from mcpower_tpu_torch.engine.spec import ClusterStatic, ScenarioStatic, SlopeStatic

SEED_LO, SEED_HI = 2137, 3
SIMS = np.arange(24, dtype=np.uint32)
WHOLE_ABS = 1e-3  # tests/test_torch_datagen.py's band (the reference's FMA-contracted ppf)
BODY_ABS = 5e-6  # f32 rounding of the mix, the slope terms and y
CHOL_REL = 4e-7
SLOPES = {"q3": [(1, 0.2, 0.3), (2, 0.1, 0.1)], "heavy_icc": [(1, 0.2, 0.3)]}


def _lowered(low, cluster_cls, slope_cls, scenario_cls, name):
    slopes = tuple(slope_cls(design_col=c, variance=v, intercept_corr=r)
                   for c, v, r in SLOPES[name])
    kw = {}
    if name == "heavy_icc":
        kw["scenario"] = scenario_cls(label="heavy", random_effect_dist="heavy_tailed",
                                      random_effect_df=5.0, icc_noise_sd=0.15)
    return low.lower(grid=[60, 120], var_types=["normal", "normal"],
                     corr=np.array([[1.0, 0.3], [0.3, 1.0]]), effects=np.array([0.0, 0.3, 0.2]),
                     target_cols=[1, 2], estimator="mle",
                     cluster=cluster_cls("fixed_clusters", 12, 0.3, slopes=slopes), **kw)


@pytest.fixture(scope="module", params=sorted(SLOPES))
def design(request):
    name = request.param
    ref_spec, ref_arr = _lowered(ref_lower, RefCluster, RefSlope, RefScenario, name)
    spec, arr = _lowered(lower, ClusterStatic, SlopeStatic, ScenarioStatic, name)
    X, y, ids = ref_datagen.generate_batch(
        ref_spec, ref_arr, jnp.uint32(SEED_LO), jnp.uint32(SEED_HI), jnp.asarray(SIMS))
    return dict(name=name, spec=spec, arr=datagen.to_device(arr, "cpu"), ref_spec=ref_spec,
                ref=(np.asarray(X), np.asarray(y), np.asarray(ids)))


def _ref_key(sid):
    k0, k1, _, _ = ref_rng.philox4x32(
        sid, jnp.uint32(0), jnp.uint32(ref_rng.CLASS_SIMKEY), jnp.uint32(0),
        jnp.uint32(SEED_LO), jnp.uint32(SEED_HI))
    return k0, k1


def test_cluster_words_of_every_component_are_the_references(design):
    spec = design["spec"]
    plan = [s for s in datagen.stream_plan(spec) if s[0] == rng.CLASS_CLUSTER]
    planes = datagen.heavy_re_planes(spec)
    assert plan == [(rng.CLASS_CLUSTER, comp * 32 + c, 12)
                    for comp in range(spec.cluster.q) for c in range(1 + planes)]
    assert (planes > 0) == (design["name"] == "heavy_icc")
    words = rng.fill_streams(SEED_LO, SEED_HI, torch.as_tensor(SIMS.astype(np.int64)), plan,
                             rng.MODE_WORDS).numpy()

    @jax.jit
    def ref_words(sids):
        return jax.vmap(lambda sid: jnp.stack([
            ref_rng.fill_raw(_ref_key(sid), c, col, 0, rows) for c, col, rows in plan]))(sids)

    np.testing.assert_array_equal(words[..., :12], np.asarray(ref_words(jnp.asarray(SIMS)))
                                  .astype(np.int64))


@pytest.mark.parametrize("tau2", [0.0, 0.3, 1.7])
def test_re_chol_against_the_reference(tau2):
    for slopes in ((), ((1, 0.2, 0.3),), ((1, 0.2, 0.3), (2, 0.1, 0.1)),
                   ((1, 0.5, -0.4), (2, 0.0, 0.2), (1, 0.05, 0.6))):
        ref_sl = tuple(RefSlope(design_col=c, variance=v, intercept_corr=r) for c, v, r in slopes)
        sl = tuple(SlopeStatic(design_col=c, variance=v, intercept_corr=r) for c, v, r in slopes)
        want = np.asarray(ref_datagen._re_chol(jnp.float32(tau2), ref_sl))
        got = datagen.re_chol(tau2, sl).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        if not slopes:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=CHOL_REL, atol=1e-7)
        # per-sim values give per-sim factors
        per_sim = datagen.re_chol(torch.full((3,), tau2, dtype=torch.float32), sl).numpy()
        np.testing.assert_array_equal(per_sim, np.broadcast_to(got, per_sim.shape))


def test_generate_batch_matches_the_reference(design):
    X, y, ids = (v.numpy() for v in datagen.generate_batch(
        design["spec"], design["arr"], SEED_LO, SEED_HI, torch.as_tensor(SIMS.astype(np.int64))))
    rX, ry, rids = design["ref"]
    np.testing.assert_array_equal(ids, rids)
    assert X.dtype == y.dtype == np.float32
    assert np.abs(X - rX).max() <= WHOLE_ABS
    assert np.abs(y - ry).max() <= WHOLE_ABS


def test_generation_body_on_the_reference_normals(design):
    """The reference's own normals (every stream of the fill plan, its
    scenario's short streams included) through the port's generation body."""
    spec = design["spec"]
    fills = datagen.fill_plan(spec)
    assert all(mode == rng.MODE_NORMAL for mode, _ in fills)  # this design draws no words
    width = max(rows for _, streams in fills for _, _, rows in streams)

    @jax.jit
    def normals(sids):
        def one(sid):
            return [jnp.stack([jnp.pad(ref_rng.normal_fill(_ref_key(sid), c, col, 0, rows),
                                       (0, width - rows)) for c, col, rows in streams])
                    for _, streams in fills]
        return jax.vmap(one)(sids)

    Z = [torch.tensor(np.asarray(z)) for z in normals(jnp.asarray(SIMS))]
    draws = datagen.Draws(list(zip(fills, Z)))
    X, y, ids = (v.numpy() for v in
                 datagen.generate_from_draws(spec, design["arr"], draws, len(SIMS), "cpu"))
    rX, ry, rids = design["ref"]
    np.testing.assert_array_equal(ids, rids)
    assert np.abs(X - rX).max() <= WHOLE_ABS  # X: the reference's fused ppf, as above
    # y less its design part: the random effects and the residual
    beta = design["arr"]["effects"].numpy().astype(np.float32)
    assert np.abs((y - X @ beta) - (ry - rX @ beta)).max() <= BODY_ABS
