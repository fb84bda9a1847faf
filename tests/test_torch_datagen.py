"""The port's generation path against ``mcpower_tpu.engine.datagen``.

Two comparisons, on the headline LMM and the OLS design:

* the whole of ``generate_batch`` against the reference's jitted one. Cluster
  ids and binary columns must be exact. The continuous values differ by up
  to ~5e-4: XLA:CPU contracts the Horner steps of the reference's f32 Acklam
  ppf into fused multiply-adds inside its fused program, and the central
  rational cancels near |p - 0.5| = 0.47, which turns that one rounding into
  up to a few thousand ULP (measured: 4.6e-4 on X, 2.3e-4 on y). The port
  computes the ppf operation by operation, as ``rng.norm_ppf_f32`` is written
  (tests/test_torch_rng.py holds it to that form);
* the generation body alone (``generate_from_draws``) fed with the
  reference's own normals: mix, marginals, random intercept and residual
  agree to f32 rounding (measured max 4.8e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mcpower_tpu.engine import datagen as ref_datagen
from mcpower_tpu.engine import lower as ref_lower
from mcpower_tpu.engine import rng as ref_rng
from mcpower_tpu.engine.spec import ClusterStatic as RefCluster
from mcpower_tpu_torch.engine import datagen, lower, rng
from mcpower_tpu_torch.engine.spec import ClusterStatic

SEED_LO, SEED_HI = 2137, 5
SIMS = np.arange(32, dtype=np.uint32)
WHOLE_ABS = 1e-3  # the reference's FMA-contracted ppf (see module docstring)
BODY_ABS = 2e-6  # f32 rounding of the mix and of y = X beta + u + e
NAMES = ["lmm_headline", "ols_10k"]


@pytest.fixture(scope="module", params=NAMES)
def design(request):
    name = request.param
    ref_spec, ref_arr = chip_smoke.lower_design(ref_lower, RefCluster, name)
    spec, arr = chip_smoke.lower_design(lower, ClusterStatic, name)
    X, y, ids = ref_datagen.generate_batch(
        ref_spec, ref_arr, jnp.uint32(SEED_LO), jnp.uint32(SEED_HI), jnp.asarray(SIMS)
    )
    return dict(name=name, spec=spec, arr=datagen.to_device(arr, "cpu"), ref_spec=ref_spec,
                ref=(np.asarray(X), np.asarray(y), np.asarray(ids)))


def _port(design, sims=SIMS):
    out = datagen.generate_batch(
        design["spec"], design["arr"], SEED_LO, SEED_HI, torch.as_tensor(sims.astype(np.int64))
    )
    return [v.numpy() for v in out]


def test_generate_batch_matches_the_reference(design):
    X, y, ids = _port(design)
    rX, ry, rids = design["ref"]
    assert X.shape == rX.shape and y.shape == ry.shape and X.dtype == y.dtype == np.float32
    np.testing.assert_array_equal(ids, rids)
    spec = design["spec"]
    binary = [1 + j for j, v in enumerate(spec.var_types) if v == 1]  # DIST_BINARY
    np.testing.assert_array_equal(X[..., 0], 1.0)
    for c in binary:
        np.testing.assert_array_equal(X[..., c], rX[..., c])
    assert np.abs(X - rX).max() <= WHOLE_ABS
    assert np.abs(y - ry).max() <= WHOLE_ABS


def test_generation_body_on_the_reference_normals(design):
    """The reference's normals (its own fused fill, under run_one_sim's
    key) through the port's mix, marginals, intercept and residual."""
    spec = design["spec"]
    plan = datagen.stream_plan(spec)

    @jax.jit
    def normals(sids):
        def one(sid):
            k0, k1, _, _ = ref_rng.philox4x32(
                sid, jnp.uint32(0), jnp.uint32(ref_rng.CLASS_SIMKEY), jnp.uint32(0),
                jnp.uint32(SEED_LO), jnp.uint32(SEED_HI),
            )
            return jnp.stack([
                jnp.pad(ref_rng.normal_fill((k0, k1), c, col, 0, rows), (0, spec.max_n - rows))
                for c, col, rows in plan
            ])
        return jax.vmap(one)(sids)

    Z = torch.tensor(np.asarray(normals(jnp.asarray(SIMS))))
    draws = datagen.Draws([((rng.MODE_NORMAL, plan), Z)])
    X, y, ids = [v.numpy() for v in
                 datagen.generate_from_draws(spec, design["arr"], draws, len(SIMS), "cpu")]
    rX, ry, rids = design["ref"]
    np.testing.assert_array_equal(ids, rids)
    assert np.abs(X - rX).max() <= BODY_ABS
    assert np.abs(y - ry).max() <= BODY_ABS


def test_values_depend_only_on_sim_ids(design):
    X, y, _ = _port(design)
    pick = np.array([31, 3, 17, 4], dtype=np.uint32)
    Xs, ys, _ = _port(design, pick)
    np.testing.assert_array_equal(Xs, X[pick])
    np.testing.assert_array_equal(ys, y[pick])


@pytest.mark.parametrize("mode,value,n", [("fixed_clusters", 20, 200), ("fixed_size", 10, 200),
                                          ("fixed_clusters", 7, 21)])
def test_cluster_ids_and_intercept_scale_match_the_reference(mode, value, n):
    ref_spec, _ = ref_lower.lower(grid=[n], var_types=["normal"], effects=np.zeros(2),
                                  target_cols=[1], estimator="mle",
                                  cluster=RefCluster(mode, value, 0.3))
    spec, _ = lower.lower(grid=[n], var_types=["normal"], effects=np.zeros(2), target_cols=[1],
                          estimator="mle", cluster=ClusterStatic(mode, value, 0.3))
    np.testing.assert_array_equal(
        datagen.cluster_ids(spec).numpy(), np.asarray(ref_datagen._cluster_ids(ref_spec))
    )
    for tau2 in (0.0, 0.25, 0.3, 4.0):
        want = np.asarray(ref_datagen._re_chol(jnp.float32(tau2), ()))
        assert datagen.re_chol(tau2, ()).item() == want.item()
    assert datagen.stream_plan(spec) == [
        (rng.CLASS_XNORM, 0, n), (rng.CLASS_CLUSTER, 0, spec.cluster.n_clusters_at(n)),
        (rng.CLASS_RESID, 0, n),
    ]
