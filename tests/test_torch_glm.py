"""The port's unclustered GLM arm against ``mcpower_tpu`` on the CPU.

* The plain IRLS (``glmfit.glm_irls_plain``) and ``glm_grid_stats`` on the
  reference's own bytes (``datagen.generate_batch``), for logit, probit and
  Poisson with ``truth_start`` True and False, on a two-point grid.
* The outcome draws against the reference's y, and the Poisson quantile
  against the reference's ``_poisson_quantile``.
* ``run_batch`` counts of ``chip_smoke.DESIGNS["glm_bonferroni_10k"]``
  against the reference's (its golden counts are recomputed with the
  other designs' in tests/test_torch_batch.py).

One generation compile per link; the truth-start and cold-start fits share
its bytes (``truth_start`` does not enter generation).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mcpower_tpu.engine import batch as ref_batch
from mcpower_tpu.engine import datagen as ref_datagen
from mcpower_tpu.engine import glmfit as ref_glmfit
from mcpower_tpu.engine import lower as ref_lower
from mcpower_tpu.engine import smallchol as ref_smallchol
from mcpower_tpu.engine.spec import ClusterStatic as RefCluster
from mcpower_tpu.engine.spec import ScenarioStatic as RefScenario
from mcpower_tpu_torch.engine import batch, carry, datagen, glmfit, lower, rng, smallchol
from mcpower_tpu_torch.engine.spec import ClusterStatic

SIMS = 32
GRID = [60, 120]
CASES = {
    "logit": dict(outcome="binary", link="canonical", effects=[-0.4, 0.5, 0.3]),
    "probit": dict(outcome="binary", link="probit", effects=[-0.2, 0.3, 0.2]),
    "poisson": dict(outcome="count", link="canonical", effects=[0.7, 0.2, 0.15]),
}
# f64 fits on the same bytes. The f32 phase sums rows in another order than
# the reference and the f64 polish removes most of that: measured at most
# 6.4e-15 relative on the canonical links (Newton converges quadratically)
# and 6.9e-10 on probit, whose Fisher scoring converges linearly, so its last
# step's residual stays in beta. The outcome mean and null deviance are sums
# of the same values in another order (measured at most 6.9e-16).
BAND = {"logit": 1e-12, "probit": 2e-9, "poisson": 1e-12}
SUM_BAND = 1e-12
# The reference's jitted normals are FMA-contracted (tests/test_torch_datagen.py),
# so eta, and a probit's latent normal, differ by up to ~5e-4: a draw within
# that of its threshold may flip. Measured 0 flips of 3,840 rows per link.
MAX_Y_FLIPS = 3


@pytest.fixture(scope="module", autouse=True)
def _first_cpu_math_call():
    """Take the process's first multi-threaded call of torch's CPU log,
    log1p and exp before any comparison: that call has been seen, in a
    loaded process, to return values ~1e-5 off on part of a tensor."""
    x = torch.rand(1 << 20) + 0.5
    for t in (x, x.double()):
        torch.log(t), torch.log1p(t), torch.exp(t), torch.sqrt(t), torch.erf(t)


def _lowered(case, truth_start=True):
    c = CASES[case]
    return ref_lower.lower(
        grid=GRID, var_types=["normal", "binary"], effects=np.asarray(c["effects"]),
        target_cols=[1, 2], outcome=c["outcome"], link=c["link"], estimator="glm",
        report_overall=True, scenario=RefScenario(truth_start=truth_start))


@pytest.fixture(scope="module")
def reference_bytes():
    """Per link: the reference's (X, y) for SIMS sims, base seed 2137."""
    out = {}
    for case in CASES:
        spec, arr = _lowered(case)
        X, y, _ = ref_datagen.generate_batch(spec, arr, 2137, 0, jnp.arange(SIMS, dtype=jnp.uint32))
        out[case] = (np.asarray(X), np.asarray(y))
    return out


def _ref_irls(spec, X, y, beta0):
    """The reference's _irls on every (sim, grid) cell: beta, cov,
    converged, dev; with its null deviance and outcome mean."""
    fit = list(spec.effective_fit_cols)
    Xf = jnp.asarray(X[..., fit], jnp.float64)
    yf = jnp.asarray(y, jnp.float64)
    rows = jnp.arange(spec.max_n)
    pin = jnp.zeros(len(fit))
    outs = []
    for g, n in enumerate(spec.grid):
        mask = (rows < n).astype(jnp.float64)
        fit_g = jax.vmap(lambda Xs, ys, b0: ref_glmfit._irls(
            spec.outcome, spec.link, Xs, ys, mask, b0, pin))
        beta, cov, conv, dev = fit_g(Xf, yf, jnp.asarray(beta0[:, g]))
        dev0 = jax.vmap(lambda ys: ref_glmfit._null_deviance(spec.outcome, ys, mask, float(n)))(yf)
        outs.append((beta, cov, conv, dev, dev0, (yf * mask).sum(-1) / n))
    return tuple(np.stack([np.asarray(o[i]) for o in outs], axis=1) for i in range(6))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("truth_start", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_glm_fits_on_reference_bytes(reference_bytes, case, truth_start):
    ref_spec, ref_arr = _lowered(case, truth_start)
    spec, arr = carry.from_reference(ref_spec, ref_arr)
    X, y = reference_bytes[case]
    Xt, yt = torch.as_tensor(X.copy()), torch.as_tensor(y.copy())
    arr_t = datagen.to_device(arr, "cpu")

    # the IRLS itself, both from the port's start values
    cm = torch.ones((spec.n_grid, len(spec.effective_fit_cols)), dtype=torch.float64)
    beta0 = glmfit.start_values(spec, arr_t, yt, cm)
    got = glmfit.glm_irls_plain(glmfit.link_code(spec.outcome, spec.link), Xt, yt,
                                spec.effective_fit_cols, spec.grid, beta0, cm)
    want = _ref_irls(ref_spec, X, y, beta0.numpy())
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    assert want[2].mean() > 0.9
    for i, name in ((0, "beta"), (1, "cov"), (3, "dev")):
        assert _rel(got[i], want[i]) <= BAND[case], name
    for i, name in ((4, "dev0"), (5, "ybar")):
        assert _rel(got[i], want[i]) <= SUM_BAND, name

    # the whole arm: start values, statistics and flags
    got = glmfit.glm_grid_stats(spec, arr_t, Xt, yt)
    want = jax.vmap(lambda X_, y_: ref_glmfit.glm_grid_stats(ref_spec, ref_arr, X_, y_, None))(
        jnp.asarray(X), jnp.asarray(y))
    assert sorted(got) == sorted(want)
    for key in ("converged", "singular"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    assert _rel(got["t2"], want["t2"]) <= 2 * BAND[case]
    assert _rel(got["overall"], want["overall"]) <= BAND[case]
    assert _rel(got["glm_baseline"], want["glm_baseline"]) <= SUM_BAND


@pytest.mark.parametrize("case", sorted(CASES))
def test_outcome_draws_match_the_reference(reference_bytes, case):
    spec, arr = carry.from_reference(*_lowered(case))
    X, y = reference_bytes[case]
    got_X, got_y, _ = datagen.generate_batch(spec, datagen.to_device(arr, "cpu"), 2137, 0,
                                             torch.arange(SIMS))
    assert got_y.dtype == torch.float32
    np.testing.assert_allclose(got_X.numpy(), X, atol=5e-4)
    flips = int((got_y.numpy() != y).sum())
    print(f"{case}: {flips} flipped outcome rows of {y.size}")
    assert flips <= MAX_Y_FLIPS
    if spec.outcome == "binary":
        assert set(np.unique(got_y.numpy())) <= {0.0, 1.0}


def test_outcome_fills_follow_the_reference_streams():
    """Logit reads the RESID words (top 24 bits), Poisson their open
    uniforms, probit the RESID normals of the first fill."""
    for case, mode in (("logit", rng.MODE_WORDS), ("poisson", rng.MODE_OPEN_UNIFORM),
                       ("probit", None)):
        spec, _ = carry.from_reference(*_lowered(case))
        second = datagen.outcome_plan(spec)
        plan = datagen.stream_plan(spec)
        if mode is None:
            assert second is None and plan[-1] == (rng.CLASS_RESID, 0, spec.max_n)
        else:
            assert second == (mode, [(rng.CLASS_RESID, 0, spec.max_n)])
            assert all(cls == rng.CLASS_XNORM for cls, _, _ in plan)
        assert sum(len(streams) for _, streams in datagen.fill_plan(spec)) == 3


def test_poisson_quantile_matches_the_reference():
    rs = np.random.RandomState(7)
    eta = np.concatenate([rs.uniform(-6.0, np.log(20.0), 3000), rs.uniform(np.log(20.0), 9.0, 1000),
                          rs.uniform(-120.0, -104.0, 200), [np.log(20.0), 0.0]]).astype(np.float32)
    u = ((rs.randint(0, 2 ** 32, size=eta.size).astype(np.float64) + 0.5) / 2 ** 32).astype(np.float32)
    u[::50] = 1.0  # open uniforms of the top words round to 1.0 in f32
    u[1::50] = np.float32(1.0 - 6e-8)
    got = datagen.poisson_quantile_plain(torch.as_tensor(u), torch.as_tensor(eta))
    # the reference's caller: clamp, ppf of the clamped u, rate exp(eta)
    u_c = torch.clamp(torch.as_tensor(u), max=datagen.U_TOP)
    z = rng.norm_ppf_f32(u_c).numpy()
    lam = torch.exp(torch.as_tensor(eta)).numpy()
    want = np.asarray(ref_datagen._poisson_quantile(jnp.asarray(u_c.numpy()), jnp.asarray(z),
                                                    jnp.asarray(lam)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (lam == 0).sum() >= 200 and (lam > 20).sum() >= 1000
    assert got.numpy()[lam == 0].max() == 0.0 and got.numpy()[lam > 20].min() > 0


@pytest.fixture(scope="module")
def glm_design():
    name = "glm_bonferroni_10k"
    return (chip_smoke.lower_design(ref_lower, RefCluster, name),
            chip_smoke.lower_design(lower, ClusterStatic, name))


def _assert_counts_equal(got, want):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g, w = np.asarray(got[key]), np.asarray(w)
        if key == "glm_baseline":  # f64 sums of the same means in another order
            np.testing.assert_allclose(g, w, rtol=1e-12, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


def test_run_batch_equals_the_reference(glm_design):
    (rs, ra), (spec, arr) = glm_design
    got = batch.run_batch(spec, arr, 64, 2137, device="cpu")
    _assert_counts_equal(got, ref_batch.run_batch(rs, ra, 64, 2137))


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    meta = torch.zeros((2, 32, 2), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        glmfit.glm_irls(0, meta, meta[..., 0], [0, 1], [32], meta[:, :1].double(),
                        torch.ones((1, 2), dtype=torch.float64))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        datagen.poisson_quantile(meta[..., 0], meta[..., 0])


def test_row_contractions_and_f32_solves_match_the_reference():
    """rowmv and crossprod in K6's summation order against the reference's
    reductions (f64: the orders differ by rounding), and the Cholesky
    algebra in f32, the IRLS's first phase, against the reference's f32."""
    rs = np.random.RandomState(3)
    X, w = rs.standard_normal((4, 64, 3)), rs.random_sample((4, 64))
    b = rs.standard_normal((4, 3))
    for name, args in (("rowmv", (X, b)), ("crossprod", (X, w))):
        got = getattr(smallchol, name)(*map(torch.tensor, args)).numpy()
        want = np.asarray(getattr(ref_smallchol, name)(*map(jnp.asarray, args)))
        np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13, err_msg=name)
    A = np.asarray(ref_smallchol.crossprod(jnp.asarray(X), jnp.asarray(w))) + np.eye(3)
    A32, b32 = torch.tensor(A, dtype=torch.float32), torch.tensor(b, dtype=torch.float32)
    L = smallchol.chol(A32)
    RL = ref_smallchol.chol(jnp.asarray(A, jnp.float32))
    outs = (L, smallchol.cho_solve(L, b32), smallchol.cho_inverse(L))
    wants = (RL, ref_smallchol.cho_solve(RL, jnp.asarray(b, jnp.float32)), ref_smallchol.cho_inverse(RL))
    for got, want in zip(outs, wants):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


# ROADMAP C2 for the GLM: at p >= 13 the reference's factor and solves take
# the blocked order, the port's IRLS (kernel K6 and its plain version) the
# scalar one. A logit GLM with 13 normals and the intercept (p = 14), SIMS
# sims at N 150 and 300 on the reference's bytes: every flag equal, t^2 and
# the overall statistic within WIDE_BAND (measured 9.7e-16 and 9.2e-15).
WIDE_BAND = 1e-12


def test_a_p14_glm_fit_against_the_blocked_reference():
    effects = np.array([-0.4] + [0.1, -0.1, 0.05] * 4 + [0.1])
    ref_spec, ref_arr = ref_lower.lower(
        grid=[150, 300], var_types=["normal"] * 13, effects=effects,
        target_cols=list(range(1, 14)), outcome="binary", estimator="glm", report_overall=True)
    spec, arr = carry.from_reference(ref_spec, ref_arr)
    assert len(spec.effective_fit_cols) == 14
    X, y, _ = ref_datagen.generate_batch(ref_spec, ref_arr, 2137, 0,
                                         jnp.arange(SIMS, dtype=jnp.uint32))
    got = glmfit.glm_grid_stats(spec, datagen.to_device(arr, "cpu"), torch.as_tensor(np.array(X)),
                                torch.as_tensor(np.array(y)))
    arm = jax.jit(jax.vmap(lambda X_, y_: ref_glmfit.glm_grid_stats(ref_spec, ref_arr, X_, y_,
                                                                    None)))
    # compiled without LLVM's expensive passes: a third of the compile
    want = arm.lower(X, y).compile(
        compiler_options={"xla_llvm_disable_expensive_passes": True})(X, y)
    assert sorted(got) == sorted(want)
    for key in ("converged", "singular"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    assert np.asarray(want["converged"]).mean() > 0.9
    t2, overall = _rel(got["t2"], want["t2"]), _rel(got["overall"], want["overall"])
    print(f"p = 14 logit GLM against the blocked reference: t^2 {t2:.2e}, overall {overall:.2e}")
    assert t2 <= WIDE_BAND and overall <= WIDE_BAND
