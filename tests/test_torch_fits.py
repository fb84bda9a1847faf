"""The port's plain fits on the reference's own bytes.

The same numpy-seeded X, y and cluster ids go through the JAX reference's
fit (vmapped over sims) and through the port's plain versions of kernels K2,
K3 and K4, so the comparison sees only the fits. Both are f64 with the same
operation order; XLA:CPU contracts some multiply-adds into FMAs, so results
agree to rounding rather than bit for bit:

* OLS: t^2 and the overall F to rel <= 1e-10, element by element
  (measured max 2.6e-12);
* LMM: t^2 and the Wald chi^2 to rel <= 1e-7 and tau^2 to rel <= 1e-6, each
  relative to the largest reference value of its output (measured max 8.7e-9
  and 3.3e-7), and converged, boundary_hit, boundary_hi and pinned_comp
  identical. The 20-step Brent search positions log gamma to ~1e-8, and its
  last steps turn on deviance differences near rounding (log1p, exp and log
  round differently in XLA:CPU and torch), hence the looser band; element by
  element a t^2 near 0 shows up to 7e-7.

Plus twins of tests/test_brent.py for the port's lane-batched Brent.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mcpower_tpu.engine import lower as ref_lower
from mcpower_tpu.engine import mixedfit as ref_mixedfit
from mcpower_tpu.engine import olsfit as ref_olsfit
from mcpower_tpu.engine import smallchol as ref_smallchol
from mcpower_tpu.engine.spec import ClusterStatic as RefCluster
from mcpower_tpu_torch.engine import lower, mixedfit, olsfit, smallchol
from mcpower_tpu_torch.engine.spec import ClusterStatic

OLS_T2_REL = 1e-10
LMM_T2_REL = 1e-7
LMM_TAU2_REL = 1e-6
SIMS = 48


@pytest.fixture(scope="module", autouse=True)
def _first_cpu_math_call():
    """Take the process's first multi-threaded call of torch's CPU log,
    log1p and exp before any comparison: that call has been seen, in a
    loaded process, to return values ~1e-5 off on part of a tensor."""
    x = torch.rand(1 << 20) + 0.5
    for t in (x, x.double()):
        torch.log(t), torch.log1p(t), torch.exp(t), torch.sqrt(t)


def _rel(got, want):
    """Largest element-by-element relative error."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / np.maximum(np.abs(want), 1e-300)).max())


def _scaled(got, want):
    """Largest error relative to the largest reference value."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _design(n_rows, p, rs, tau=0.0, m=0):
    """f32 X (SIMS, n, p) with an intercept column and y with a cluster
    intercept of SD ``tau`` on the round-robin layout over ``m`` clusters."""
    X = rs.standard_normal((SIMS, n_rows, p)).astype(np.float32)
    X[..., 0] = 1.0
    beta = np.linspace(0.3, -0.1, p)
    y = X.astype(np.float64) @ beta + rs.standard_normal((SIMS, n_rows))
    ids = np.zeros(n_rows, np.int32)
    if m:
        ids = (np.arange(n_rows) % m).astype(np.int32)
        y = y + tau * rs.standard_normal((SIMS, m))[:, ids]
    return X, y.astype(np.float32), np.broadcast_to(ids, (SIMS, n_rows)).copy()


# ---------------------------------------------------------------------------
# OLS: K2 + K3 plain versions against olsfit.ols_grid_stats
# ---------------------------------------------------------------------------

OLS_DESIGNS = {
    "ols_10k": chip_smoke.DESIGNS["ols_10k"],
    # the curve design cut to a 3-point grid (max_n 200)
    "curve_3grid": dict(chip_smoke.DESIGNS["curve_5pred_8grid"], grid=[50, 100, 200]),
}


@pytest.mark.parametrize("name", sorted(OLS_DESIGNS))
def test_ols_on_reference_bytes(name):
    kw = dict(OLS_DESIGNS[name], effects=np.asarray(OLS_DESIGNS[name]["effects"]))
    if "corr" in kw:
        kw["corr"] = np.asarray(kw["corr"])
    ref_spec, ref_arr = ref_lower.lower(**kw)
    spec, _ = lower.lower(**kw)
    rs = np.random.RandomState(7)
    X, y, ids = _design(spec.max_n, spec.n_predictors, rs)
    if spec.n_predictors > 2:
        X[0, :, 2] = X[0, :, 1]  # one rank-deficient sim: converged False
    want = jax.jit(jax.vmap(lambda a, b: ref_olsfit.ols_grid_stats(ref_spec, ref_arr, a, b)))(
        jnp.asarray(X), jnp.asarray(y)
    )
    got = olsfit.ols_grid_stats(spec, torch.tensor(X), torch.tensor(y))
    conv = np.asarray(want["converged"])
    np.testing.assert_array_equal(got["converged"].numpy(), conv)
    assert conv.sum() >= conv.size - spec.n_grid
    assert _rel(got["t2"].numpy()[conv], np.asarray(want["t2"])[conv]) <= OLS_T2_REL
    assert _rel(got["overall"].numpy()[conv], np.asarray(want["overall"])[conv]) <= OLS_T2_REL


@pytest.fixture(scope="module")
def curve_k3_grid():
    kw = dict(chip_smoke.DESIGNS["curve_5pred_8grid"], grid=list(chip_smoke.K3_GRID))
    kw.update(corr=np.asarray(kw["corr"]), effects=np.asarray(kw["effects"]))
    ref_spec, ref_arr = ref_lower.lower(**kw)
    spec, _ = lower.lower(**kw)
    return spec, jax.jit(jax.vmap(lambda a, b: ref_olsfit.ols_grid_stats(ref_spec, ref_arr, a, b)))


@pytest.mark.parametrize("case", ["straddle_scaled", "straddle_collinear"])
def test_ols_on_pivot_ratios_either_side_of_eps_rank(curve_k3_grid, case):
    """The plain K2 + K3 against the reference on the X that chip_smoke.py's
    K3_CHECKS straddle EPS_RANK with (p = 7, the curve design on the grid
    [100, 200]): the last column delta (x1 + w) ("scaled") or x1 + delta w
    ("collinear"), delta log-uniform over [10^-6.6, 10^-5.6], so the pivot
    ratio falls on either side of 1e-6. Flags are identical in both. Where
    the column is small, the solve is well-conditioned in relative terms and
    t^2 agrees within OLS_T2_REL. Where it is nearly collinear in direction,
    the condition number is ~1/delta^2 ~ 1e12: XLA:CPU's contracted
    multiply-adds and the port's separate ones give t^2 that differ by up to
    ~1e-3 on the converged cells (measured), so only the flags are held."""
    spec, ref_fn = curve_k3_grid
    X, y = chip_smoke.k3_synthetic_xy(case, SIMS)
    assert X.shape == (SIMS, spec.max_n, spec.n_predictors)
    want = ref_fn(jnp.asarray(X), jnp.asarray(y))
    got = olsfit.ols_grid_stats(spec, torch.tensor(X), torch.tensor(y))
    conv = np.asarray(want["converged"])
    np.testing.assert_array_equal(got["converged"].numpy(), conv)
    assert 0.2 < conv.mean() < 0.8, conv.mean()
    if case == "straddle_scaled":
        assert _rel(got["t2"].numpy()[conv], np.asarray(want["t2"])[conv]) <= OLS_T2_REL
        assert _rel(got["overall"].numpy()[conv], np.asarray(want["overall"])[conv]) <= OLS_T2_REL


# ---------------------------------------------------------------------------
# LMM: K2 + K4 plain versions against mixedfit.mixed_grid_stats
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lmm():
    kw = dict(chip_smoke.DESIGNS["lmm_headline"])
    kw = dict(kw, grid=[100, 200], corr=np.asarray(kw["corr"]), effects=np.asarray(kw["effects"]),
              report_overall=True)
    ref_spec, ref_arr = ref_lower.lower(**dict(kw, cluster=RefCluster(**kw["cluster"])))
    spec, _ = lower.lower(**dict(kw, cluster=ClusterStatic(**kw["cluster"])))
    fn = jax.jit(jax.vmap(
        lambda a, b, c: ref_mixedfit.mixed_grid_stats(ref_spec, ref_arr, a, b, c)
    ))
    return spec, fn


# tau = 0: many low pins; tau = 0.5: interior fits; tau = 60: high pins
@pytest.mark.parametrize("tau", [0.0, 0.5, 60.0])
def test_lmm_on_reference_bytes(lmm, tau):
    spec, ref_fn = lmm
    rs = np.random.RandomState(int(tau * 10) + 3)
    X, y, ids = _design(spec.max_n, spec.n_predictors, rs, tau=tau, m=20)
    want = ref_fn(jnp.asarray(X), jnp.asarray(y), jnp.asarray(ids))
    got = mixedfit.mixed_grid_stats(spec, torch.tensor(X), torch.tensor(y))
    for flag in ("converged", "boundary_hit", "boundary_hi", "pinned_comp"):
        np.testing.assert_array_equal(got[flag].numpy(), np.asarray(want[flag]), err_msg=flag)
    assert _scaled(got["t2"].numpy(), np.asarray(want["t2"])) <= LMM_T2_REL
    assert _scaled(got["overall"].numpy(), np.asarray(want["overall"])) <= LMM_T2_REL
    tau2, ref_tau2 = got["tau2_hat"].numpy(), np.asarray(want["tau2_hat"])
    np.testing.assert_array_equal(tau2 == 0.0, ref_tau2 == 0.0)
    assert _scaled(tau2, ref_tau2) <= LMM_TAU2_REL
    if tau == 0.0:
        assert np.asarray(want["boundary_hit"]).mean() > 0.2
    if tau == 60.0:
        assert np.asarray(want["boundary_hi"]).mean() > 0.5


# ---------------------------------------------------------------------------
# B2: the plain small Cholesky against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p", [1, 3, 7, 12])
def test_smallchol_matches_the_reference(p):
    rs = np.random.RandomState(p)
    M = rs.standard_normal((16, p + 3, p))
    A = M.transpose(0, 2, 1) @ M
    A[0] = 0.0  # a singular matrix: non-finite factor, rank test fails
    b = rs.standard_normal((16, p))
    L = smallchol.chol(torch.tensor(A))
    RL = ref_smallchol.chol(jnp.asarray(A))
    ok = slice(1, None)
    np.testing.assert_allclose(L.numpy()[ok], np.asarray(RL)[ok], rtol=1e-13, atol=1e-14)
    np.testing.assert_allclose(smallchol.cho_solve(L, torch.tensor(b)).numpy()[ok],
                               np.asarray(ref_smallchol.cho_solve(RL, jnp.asarray(b)))[ok], rtol=1e-11)
    np.testing.assert_allclose(smallchol.cho_inverse(L).numpy()[ok],
                               np.asarray(ref_smallchol.cho_inverse(RL))[ok], rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(smallchol.logdet_from_chol(L).numpy()[ok],
                               np.asarray(ref_smallchol.logdet_from_chol(RL))[ok], rtol=1e-13)
    np.testing.assert_array_equal(smallchol.chol_rank_ok(L).numpy(),
                                  np.asarray(ref_smallchol.chol_rank_ok(RL)))
    assert not smallchol.chol_rank_ok(L)[0]
    # the weighted reductions of the REML deviance and the row contraction
    c, s, t = rs.random_sample((16, 5)), rs.standard_normal((16, 5, p)), rs.standard_normal((16, 5))
    for name, args in (("wouter", (c, s)), ("wvec", (c, s, t)), ("colsum", (s, t))):
        got = getattr(smallchol, name)(*map(torch.tensor, args)).numpy()
        want = np.asarray(getattr(ref_smallchol, name)(*map(jnp.asarray, args)))
        np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-14, err_msg=name)


# ---------------------------------------------------------------------------
# B3: the static-layout cluster sums K2 is held against, and K2's plain
# version on the designs chip_smoke.py checks the kernel at
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,value", [("fixed_clusters", 4), ("fixed_size", 5)])
def test_clusterops_match_the_reference(mode, value):
    from mcpower_tpu.engine import clusterops as ref_clusterops
    from mcpower_tpu_torch.engine import clusterops

    kw = dict(grid=[20, 40], var_types=["normal"], effects=np.zeros(2), target_cols=[1],
              estimator="mle")
    ref_spec, _ = ref_lower.lower(**kw, cluster=RefCluster(mode, value, 0.3))
    spec, _ = lower.lower(**kw, cluster=ClusterStatic(mode, value, 0.3))
    m = spec.cluster.n_clusters_at(spec.max_n)
    x = np.random.RandomState(1).standard_normal((3, 40))
    np.testing.assert_allclose(clusterops.seg_sum(spec, torch.tensor(x)).numpy(),
                               np.asarray(ref_clusterops.seg_sum(ref_spec, jnp.asarray(x))),
                               rtol=1e-14)
    seg = x[:, 20:40]
    np.testing.assert_allclose(
        clusterops.seg_segment(spec, torch.tensor(seg), 20, m).numpy(),
        np.asarray(ref_clusterops.seg_segment(ref_spec, jnp.asarray(seg), 20, m)), rtol=1e-14,
    )
    v = x[:, :m]
    np.testing.assert_array_equal(clusterops.per_row(spec, torch.tensor(v), 40).numpy(),
                                  np.asarray(ref_clusterops.per_row(ref_spec, jnp.asarray(v), 40)))


K2_CHECKED = sorted({**chip_smoke.DESIGNS, **chip_smoke.LAYOUT_CHECKS, **chip_smoke.K2_CHECKS})


@pytest.mark.parametrize("name", K2_CHECKED)
def test_grid_suffstats_plain_on_the_designs_k2_is_checked_at(name):
    """K2's plain version, which chip_smoke.py holds the kernel against on
    the card, equals prefix sums written out in numpy on every design of
    that check: each grid point's sums over its first n rows, and the
    cluster sums over the layout's ids (round robin i % m, blocked i // cs)."""
    spec, _ = chip_smoke.lower_design(lower, ClusterStatic, name)
    rs = np.random.RandomState(5)
    X = rs.standard_normal((3, spec.max_n, spec.n_predictors)).astype(np.float32)
    y = rs.standard_normal((3, spec.max_n)).astype(np.float32)
    c = spec.cluster
    got = olsfit.grid_suffstats_plain(spec, torch.tensor(X), torch.tensor(y),
                                      with_clusters=c is not None)
    Xf, yf = X[..., list(spec.effective_fit_cols)].astype(np.float64), y.astype(np.float64)
    for g, n in enumerate(spec.grid):
        Xn, yn = Xf[:, :n], yf[:, :n]
        want = {"xtx": np.einsum("bnp,bnq->bpq", Xn, Xn), "xty": np.einsum("bnp,bn->bp", Xn, yn),
                "yty": (yn * yn).sum(-1), "ysum": yn.sum(-1)}
        if c is not None:
            m, size = c.n_clusters_at(spec.max_n), int(c.sizing_value)
            ids = np.arange(n) % m if c.sizing_mode == "fixed_clusters" else np.arange(n) // size
            onehot = (ids[:, None] == np.arange(m)).astype(np.float64)
            want.update(n_j=np.broadcast_to(onehot.sum(0), (3, m)),
                        s=np.einsum("bnp,nm->bmp", Xn, onehot), t=yn @ onehot)
        assert set(got) == set(want)
        for key, v in want.items():
            np.testing.assert_allclose(got[key][:, g].numpy(), v, rtol=1e-12, atol=1e-12,
                                       err_msg=f"{key} at n={n}")


# ---------------------------------------------------------------------------
# Twins of tests/test_brent.py
# ---------------------------------------------------------------------------

LO, HI = mixedfit.LOG_GAMMA_LO, mixedfit.LOG_GAMMA_HI
CS = np.linspace(-13.5, 6.5, 41)


def _run(f, cs):
    c = torch.tensor(cs, dtype=torch.float64)
    x, _, _ = mixedfit._brent_minimize(LO, HI, (), ((mixedfit.BRENT_ITERS, lambda x, aux: (f(x, c), aux)),))
    return x.numpy()


def test_quadratic_interior_optima_to_machine_precision():
    err = np.abs(_run(lambda x, c: (x - c) ** 2, CS) - CS)
    assert err.max() < 1e-9


def test_boundary_monotone_lanes_reach_the_wall_region():
    up = _run(lambda x, c: x + 0.0 * c, CS[:3])
    dn = _run(lambda x, c: -x + 0.0 * c, CS[:3])
    assert np.all(up < LO + 0.01)
    assert np.all(dn > HI - 0.01)


def test_brent_steps_like_the_reference_on_a_reml_shaped_curve():
    def ref_one(c):
        f = lambda x: 3.0 * jnp.log1p(jnp.exp(x) * 5.0) + 100.0 * jnp.log1p((x - c) ** 2 / 50.0)
        return ref_mixedfit._brent_minimize(LO, HI, (), ((mixedfit.BRENT_ITERS, lambda x, aux: (f(x), aux)),))[0]

    want = np.asarray(jax.jit(jax.vmap(ref_one))(jnp.asarray(CS)))
    got = _run(lambda x, c: 3.0 * torch.log1p(torch.exp(x) * 5.0)
               + 100.0 * torch.log1p((x - c) ** 2 / 50.0), CS)
    # the parity band of tests/test_brent.py; measured max 2.8e-8, from
    # log1p and exp rounding differently in the two libraries
    assert np.abs(got - want).max() < 1e-6
