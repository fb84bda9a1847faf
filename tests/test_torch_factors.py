"""The port's factor predictors against ``mcpower_tpu`` on the CPU.

One OLS design carries the file: x1 (normal), a 3-level factor with fixed
allocation and two rare levels (10% each, so at N = 40 it is excluded in
every sim), a 3-level factor drawn per row (a rare level of 10%, so its
exclusion at N = 40 differs between sims), the interaction of x1 with the
first factor's level 2, and the Tukey pairwise contrasts of the second
factor. On its reference bytes (the reference's ``generate_batch``):

* the level codes and dummies of the port's ``generate_batch``, bit for bit,
  for the fixed and the sampled factor;
* ``factor_min_counts``, the exclusion colmask and ``dropped``, exactly;
* the OLS reduced fit with posthoc contrasts, and the GLM reduced fit with
  the separation fallback on a binary outcome made here from the same X
  (the sampled factor's level 3 has y = 1 in every row, a separation the
  fallback can resolve only where that factor is the sparsest);
* ``waldstats.posthoc_t2`` on random beta and cov.

Then ``run_batch(device="cpu")`` counts at 64 sims against the reference's
``run_batch`` for that OLS design, a random-intercept LMM and a logit model
on the same columns (the logit against the reference's fused program, to
which its separation gate is bit-identical), and one OLS design of p = 13
(ROADMAP C2: the reference switches to its blocked Cholesky at p >= 13, the
port does not).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpower_tpu.engine import batch as ref_batch
from mcpower_tpu.engine import datagen as ref_datagen
from mcpower_tpu.engine import glmfit as ref_glmfit
from mcpower_tpu.engine import lower as ref_lower
from mcpower_tpu.engine import olsfit as ref_olsfit
from mcpower_tpu.engine import waldstats as ref_waldstats
from mcpower_tpu.engine.spec import ClusterStatic as RefCluster
from mcpower_tpu.engine.spec import PosthocStatic as RefPosthoc
from mcpower_tpu_torch.engine import batch, carry, datagen, glmfit, olsfit, waldstats

SIMS = 32
SEED = 2137
# Columns: 0 intercept, 1 x1, 2-3 factor 0's dummies, 4-5 factor 1's, 6 x1
# times factor 0's level 2.
DESIGN = dict(
    grid=[40, 120], var_types=["normal"], factor_levels=[3, 3],
    factor_props=[0.8, 0.1, 0.1, 0.6, 0.3, 0.1], factor_sampled=[None, True],
    interactions=[(1, 2)], effects=np.asarray([0.1, 0.3, 0.3, 0.2, 0.25, 0.2, 0.15]),
    target_cols=[1, 2, 4, 6], correction="holm",
)
PAIRS = ((-1, 4), (-1, 5), (4, 5))
FACTOR_COLS = list(range(2, 6))
# f64 fits on the same bytes, at tests/test_reduced_refit.py's bands: 1e-8
# for the OLS reduced fit (the solves agree to rounding; measured 8.8e-16,
# and 3.1e-15 in t^2 at p = 13 against the reference's blocked Cholesky) and
# 1e-6 for the GLM and its fallback (the f32 phase sums rows in another
# order, which the f64 polish removes; measured 3.5e-15). Flags are exact.
OLS_REL = 1e-8
GLM_REL = 1e-6
# tau^2 sums carry the generation's f32 gap through the REML search
# (tests/test_torch_batch.py).
TAU2_REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _first_cpu_math_call():
    """Take the process's first multi-threaded call of torch's CPU log,
    log1p and exp before any comparison: that call has been seen, in a
    loaded process, to return values ~1e-5 off on part of a tensor."""
    x = torch.rand(1 << 20) + 0.5
    for t in (x, x.double()):
        torch.log(t), torch.log1p(t), torch.exp(t), torch.sqrt(t), torch.erf(t)


def _lowered(**over):
    kw = dict(DESIGN, posthoc=(RefPosthoc(1, 3, PAIRS),), **over)
    return ref_lower.lower(**kw)


@pytest.fixture(scope="module")
def ols():
    """The OLS design, both packages' lowering, and the reference's bytes."""
    ref_spec, ref_arr = _lowered()
    spec, arr = carry.from_reference(ref_spec, ref_arr)
    X, y, _ = ref_datagen.generate_batch(ref_spec, ref_arr, SEED, 0,
                                         jnp.arange(SIMS, dtype=jnp.uint32))
    return ref_spec, ref_arr, spec, arr, np.asarray(X), np.asarray(y)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def test_factor_codes_and_dummies_are_the_references(ols):
    ref_spec, _, spec, arr, X, _ = ols
    assert datagen.sampled_factors(spec) == [1]
    assert datagen.outcome_plan(spec) == (0, [(2, 1, spec.max_n)])  # FACTOR words, column 1
    got, _, _ = datagen.generate_batch(spec, datagen.to_device(arr, "cpu"), SEED, 0,
                                       torch.arange(SIMS))
    got = got.numpy()
    np.testing.assert_array_equal(got[..., FACTOR_COLS], X[..., FACTOR_COLS])
    assert (got[..., 2:4].sum(-1) <= 1).all() and (got[..., 4:6].sum(-1) <= 1).all()
    # fixed: the same codes in every sim; sampled: codes that differ
    assert (X[:, :, 2:4] == X[:1, :, 2:4]).all()
    assert not (X[:, :, 4:6] == X[:1, :, 4:6]).all()


def test_min_counts_colmask_and_dropped_are_exact(ols):
    ref_spec, _, spec, _, X, _ = ols
    Xt = torch.as_tensor(X.copy())
    mc = datagen.factor_min_counts(spec, Xt)
    ref_mc = jax.vmap(lambda x: ref_datagen.factor_min_counts(ref_spec, x))(jnp.asarray(X))
    np.testing.assert_array_equal(mc.numpy(), np.asarray(ref_mc))
    excluded = mc < spec.factor_min_level_count
    cm, dropped = batch._exclusion_colmask(spec, excluded)
    ref_cm, ref_dropped = jax.vmap(lambda e: ref_batch._exclusion_colmask(ref_spec, e))(
        jnp.asarray(excluded.numpy()))
    np.testing.assert_array_equal(cm.numpy(), np.asarray(ref_cm))
    np.testing.assert_array_equal(dropped.numpy(), np.asarray(ref_dropped))
    # factor 0 is excluded at N = 40 in every sim; factor 1 in some
    assert excluded[:, 0, 0].all() and not excluded[:, 1].any()
    assert 0 < int(excluded[:, 0, 1].sum()) < SIMS


def _with_beta_cov(monkeypatch, module):
    """Make an arm's output carry its final beta and cov (its add_posthoc
    receives them)."""
    real = module.waldstats.add_posthoc
    monkeypatch.setattr(module.waldstats, "add_posthoc",
                        lambda out, spec, beta, cov: {**real(out, spec, beta, cov),
                                                      "beta": beta, "cov": cov})


def _ref_stats(ref_spec, fit, X, y):
    """The reference arm on every sim with run_one_sim's exclusion mask."""
    def one(Xs, ys):
        excl = ref_datagen.factor_min_counts(ref_spec, Xs) < ref_spec.factor_min_level_count
        cm, _ = ref_batch._exclusion_colmask(ref_spec, excl)
        return fit(Xs, ys, cm)

    return {k: np.asarray(v) for k, v in jax.jit(jax.vmap(one))(jnp.asarray(X), jnp.asarray(y)).items()}


def _port_colmask(spec, Xt):
    mc = datagen.factor_min_counts(spec, Xt)
    cm, _ = batch._exclusion_colmask(spec, mc < spec.factor_min_level_count)
    return cm, mc


def test_ols_reduced_fit_on_reference_bytes(ols, monkeypatch):
    ref_spec, ref_arr, spec, _, X, y = ols
    _with_beta_cov(monkeypatch, ref_olsfit)
    want = _ref_stats(ref_spec, lambda Xs, ys, cm: ref_olsfit.ols_grid_stats(
        ref_spec, ref_arr, Xs, ys, colmask=cm), X, y)
    Xt, yt = torch.as_tensor(X.copy()), torch.as_tensor(y.copy())
    cm, _ = _port_colmask(spec, Xt)
    got = olsfit.ols_grid_stats(spec, Xt, yt, colmask=cm)
    np.testing.assert_array_equal(got["converged"].numpy(), want["converged"])
    assert want["converged"].all()
    for key in ("t2", "overall", "posthoc_t2"):
        assert _rel(got[key], want[key]) <= OLS_REL, key
    # the excluded factor's betas are pinned at 0: their t^2 is 0
    assert (got["t2"][:, 0, 1].numpy() == 0).all()


def _separated_y(X):
    """A binary outcome on X: y = 1 wherever factor 1 is at level 3
    (column 5), else a logit draw on x1, from a fixed numpy seed."""
    rs = np.random.RandomState(SEED)
    p = 1.0 / (1.0 + np.exp(-(-0.5 + 0.5 * X[..., 1].astype(np.float64))))
    y = (rs.uniform(size=p.shape) < p) | (X[..., 5] == 1)
    return y.astype(np.float32)


def test_glm_reduced_fit_and_separation_fallback_on_reference_bytes(ols, monkeypatch):
    ref_spec, ref_arr = _lowered(outcome="binary", estimator="glm")
    spec, arr = carry.from_reference(ref_spec, ref_arr)
    X = ols[4]
    y = _separated_y(X)
    _with_beta_cov(monkeypatch, ref_glmfit)
    _with_beta_cov(monkeypatch, glmfit)
    ids = jnp.zeros(spec.max_n, jnp.int32)
    want = _ref_stats(ref_spec, lambda Xs, ys, cm: ref_glmfit.glm_grid_stats(
        ref_spec, ref_arr, Xs, ys, ids, colmask=cm), X, y)
    Xt, yt = torch.as_tensor(X.copy()), torch.as_tensor(y)
    cm, mc = _port_colmask(spec, Xt)
    got = glmfit.glm_grid_stats(spec, datagen.to_device(arr, "cpu"), Xt, yt, colmask=cm,
                                min_counts=mc)
    for key in ("converged", "singular", "separation_fallback"):
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
    fb = want["separation_fallback"]
    # the fallback both rescued cells and left some unconverged
    assert fb.any() and not want["converged"].all()
    ok = want["converged"]
    for key in ("beta", "cov", "t2", "posthoc_t2"):
        assert _rel(got[key].numpy()[ok], want[key][ok]) <= GLM_REL, key
    assert _rel(got["overall"].numpy()[ok], want["overall"][ok]) <= GLM_REL
    np.testing.assert_allclose(got["glm_baseline"].numpy(), want["glm_baseline"], rtol=1e-15)
    # a rescued cell has one factor's columns pinned at 0
    beta = got["beta"].numpy()[fb]
    assert ((beta[:, 2:4] == 0).all(-1) | (beta[:, 4:6] == 0).all(-1)).all()


def test_posthoc_t2_equals_the_references(ols):
    ref_spec, _, spec, _, _, _ = ols
    rs = np.random.RandomState(SEED)
    beta = rs.standard_normal((4, 2, 7))
    a = rs.standard_normal((4, 2, 7, 7))
    cov = a @ a.transpose(0, 1, 3, 2) + 7 * np.eye(7)
    got = waldstats.posthoc_t2(spec, torch.as_tensor(beta), torch.as_tensor(cov)).numpy()
    want = np.stack([np.asarray(ref_waldstats.posthoc_t2(ref_spec, jnp.asarray(b), jnp.asarray(c)))
                     for b, c in zip(beta, cov)])
    assert got.shape == (4, 2, len(PAIRS))
    np.testing.assert_array_equal(got, want)


def _assert_counts_equal(got, want):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g, w = np.asarray(got[key]), np.asarray(w)
        assert g.shape == w.shape, key
        if key == "tau2_hat":
            np.testing.assert_allclose(g, w, rtol=TAU2_REL, err_msg=key)
        elif key == "glm_baseline":
            np.testing.assert_allclose(g, w, rtol=1e-12, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


# x1 and one factor: the first factor with its posthoc contrasts (LMM), the
# second, drawn per row, with a large effect on its rare level (logit).
SMALL = dict(grid=[40, 120], var_types=["normal"], factor_levels=[3])
RUNS = {
    "ols": dict(DESIGN, posthoc=(RefPosthoc(1, 3, PAIRS),)),
    "lmm": dict(SMALL, factor_props=[0.8, 0.1, 0.1], effects=np.asarray([0.1, 0.3, 0.3, 0.2]),
                target_cols=[1, 2], estimator="mle", cluster=RefCluster("fixed_clusters", 20, 0.25),
                posthoc=(RefPosthoc(0, 3, ((-1, 2), (-1, 3), (2, 3))),)),
    "logit": dict(SMALL, factor_props=[0.6, 0.3, 0.1], factor_sampled=[True],
                  effects=np.asarray([-1.0, 0.3, 0.4, 1.5]), target_cols=[1, 2, 3],
                  outcome="binary", estimator="glm"),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_batch_counts_equal_the_references(name, monkeypatch):
    ref_spec, ref_arr = ref_lower.lower(**RUNS[name])
    spec, arr = carry.from_reference(ref_spec, ref_arr)
    monkeypatch.setattr(ref_batch, "SEPARATION_GATE", False)  # the fused program
    want = ref_batch.run_batch(ref_spec, ref_arr, 64, SEED)
    got = batch.run_batch(spec, arr, 64, SEED, device="cpu")
    assert "factor_excluded" in got and ("posthoc_sig" in got) == (name != "logit")
    assert ("separation_fallback" in got) == (name == "logit")
    _assert_counts_equal(got, want)


def test_a_p13_ols_fit_against_the_blocked_reference():
    """ROADMAP C2: x1, x2, x3, a 5-level factor, x1 times the factor and
    x1:x2 (p = 13), where the reference factors with its blocked Cholesky.
    t^2 on the reference's bytes at rounding, the flags exact."""
    ref_spec, ref_arr = ref_lower.lower(
        grid=[60, 150], var_types=["normal"] * 3, factor_levels=[5],
        factor_props=[0.2] * 5, interactions=[(1, 4), (1, 5), (1, 6), (1, 7), (1, 2)],
        effects=np.asarray([0.1, 0.3, 0.2, 0.1, 0.2, 0.2, 0.3, 0.1, 0.1, 0.1, 0.1, 0.1, 0.15]),
        target_cols=list(range(1, 13)))
    spec, _ = carry.from_reference(ref_spec, ref_arr)
    assert len(spec.effective_fit_cols) == 13 and datagen.unsupported(spec) == ""
    X, y, _ = ref_datagen.generate_batch(ref_spec, ref_arr, SEED, 0,
                                         jnp.arange(SIMS, dtype=jnp.uint32))
    X, y = np.asarray(X), np.asarray(y)
    want = _ref_stats(ref_spec, lambda Xs, ys, cm: ref_olsfit.ols_grid_stats(
        ref_spec, ref_arr, Xs, ys, colmask=cm), X, y)
    Xt, yt = torch.as_tensor(X.copy()), torch.as_tensor(y.copy())
    cm, _ = _port_colmask(spec, Xt)
    got = olsfit.ols_grid_stats(spec, Xt, yt, colmask=cm)
    np.testing.assert_array_equal(got["converged"].numpy(), want["converged"])
    assert want["converged"].all()
    assert _rel(got["t2"], want["t2"]) <= OLS_REL
    assert _rel(got["overall"], want["overall"]) <= OLS_REL
    crit = ref_arr["t2_uncorrected"]
    np.testing.assert_array_equal(got["t2"].numpy() > crit, want["t2"] > crit)


# ROADMAP C2's remaining holds, now that the port has the blocked forms: the
# reference factors p >= 13 in its blocked order, the port's K3 and K4 (and
# their plain versions) in the scalar order. benchmarks/throughput.py's
# ols_wide (:197-208: 15 independent normals, p = 16, N 200) and the
# random-intercept LMM with 13 normals (p = 14, 16 round-robin clusters, N
# 240), each on the reference's bytes: every flag equal, t^2 (and the LMM's
# tau^2) within C2_REL: the OLS solve to rounding (measured 9.3e-16); the
# LMM's 20-step Brent search over log gamma follows its deviances' last
# digits, so its optimum moves within the search's own tolerance (measured:
# t^2 8.2e-9, tau^2 9.3e-8).
C2_DESIGNS = {
    "ols_wide_p16": dict(grid=[100, 200], var_types=["normal"] * 15, corr=np.eye(15),
                         effects=np.array([0.0, 0.2, 0.2] + [0.0] * 13), target_cols=[1, 2]),
    "lmm_p14": dict(grid=[128, 240], var_types=["normal"] * 13,
                    effects=np.asarray([0.0, 0.3, 0.2] + [0.05] * 11),
                    target_cols=list(range(1, 14)), estimator="mle",
                    cluster=RefCluster("fixed_clusters", 16, 0.25)),
}
C2_REL = {"ols_wide_p16": 1e-12, "lmm_p14": 1e-6}


@pytest.mark.parametrize("name", sorted(C2_DESIGNS))
def test_c2_holds_against_the_blocked_reference(name):
    from mcpower_tpu.engine import mixedfit as ref_mixedfit
    from mcpower_tpu_torch.engine import mixedfit

    ref_spec, ref_arr = ref_lower.lower(**C2_DESIGNS[name])
    spec, _ = carry.from_reference(ref_spec, ref_arr)
    assert len(spec.effective_fit_cols) >= 13 and datagen.unsupported(spec) == ""
    X, y, ids = ref_datagen.generate_batch(ref_spec, ref_arr, SEED, 0,
                                           jnp.arange(SIMS, dtype=jnp.uint32))
    if spec.cluster is None:
        want = jax.jit(jax.vmap(lambda a, b: ref_olsfit.ols_grid_stats(ref_spec, ref_arr, a, b)))(
            X, y)
    else:
        want = jax.jit(jax.vmap(lambda a, b, c: ref_mixedfit.mixed_grid_stats(
            ref_spec, ref_arr, a, b, c)))(X, y, ids)
    want = {k: np.asarray(v) for k, v in want.items()}
    Xt, yt = torch.as_tensor(np.array(X)), torch.as_tensor(np.array(y))
    got = (olsfit.ols_grid_stats(spec, Xt, yt) if spec.cluster is None
           else mixedfit.mixed_grid_stats(spec, Xt, yt))
    flags = [k for k in ("converged", "boundary_hit", "boundary_hi", "pinned_comp") if k in want]
    for k in flags:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    errs = {k: _rel(got[k], want[k]) for k in ("t2", "overall", "tau2_hat") if k in got}
    print(f"{name}: flags {flags} equal; relative errors {errs}")
    assert want["converged"].all() and max(errs.values()) <= C2_REL[name]
    crit = ref_arr["t2_uncorrected"]
    np.testing.assert_array_equal(got["t2"].numpy() > crit, want["t2"] > crit)
