"""The port's random-slope LMM fit (K2's slope mode and kernel K9's plain
version) against ``mcpower_tpu.engine.mixedfit`` on the CPU, on the
reference's own bytes.

X and y come from the reference's ``generate_batch`` (SIMS sims, a two-point
grid, 12 round-robin clusters). Designs: q = 2 (slope variance 0.2, corr
0.3), a null slope variance (tests/test_slopes.py:110-126's design, cut to
this size: the slope pins often) and q = 3; tests/test_torch_slopes_wide.py
runs p = 14 (ROADMAP C2) through the same checks. Checks:

* the slope-mode statistics G, A, b (and X'X, X'y, y'y) against the
  reference's ``_slope_cluster_suffstats`` to 1e-12 relative;
* the fit at the reference's own theta: :func:`reference_fit` runs the
  reference's ``_slope_grid_stats.per_grid`` (:385-459) with the
  reference's own ``_vech_to_lower``, ``_reml_quantities_q``,
  ``optim.nelder_mead`` and ``smallchol``, and returns its optimum beside
  its results (q = 2 holds that replica to the reference's
  ``mixed_grid_stats``: t^2, tau^2 and flags equal). The port fitted at
  that theta (``slope_reml_plain(theta=)``) must give beta, cov = sigma^2
  (X'V^-1X)^-1, tau^2 = Gamma[0, 0] sigma^2 and t^2 within FIT_REL (1e-8)
  and every flag (converged, boundary, pinned per component) equal;
* the search: the reference ranks its candidates on f32 deviances of a few
  hundred, which carry ~1e-4 of rounding, so its simplex follows their
  rounding; the port's f32 sums round differently and its search ends
  elsewhere once two candidates differ by less than that, and where the
  objective is flat (a slope variance near 0) the two simplices stall
  further apart. At each cell's two optima the f64 deviance (the
  reference's, at each theta) must agree within DEV_BAND (measured: 9.9e-5
  at q = 2, 4.8e-3 for the null slope, 2.3e-3 at q = 3), and the pins must
  agree in every cell but those at a flat optimum: where a pin differs, the
  deviance the component's removal costs is below FLAT at both optima
  (measured: no pin differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpower_tpu.engine import datagen as ref_datagen
from mcpower_tpu.engine import lower as ref_lower
from mcpower_tpu.engine import mixedfit as ref_mixedfit
from mcpower_tpu.engine import optim as ref_optim
from mcpower_tpu.engine import smallchol as ref_smallchol
from mcpower_tpu.engine.spec import ClusterStatic as RefCluster
from mcpower_tpu.engine.spec import SlopeStatic as RefSlope
from mcpower_tpu_torch.engine import lower, mixedfit, olsfit, waldstats
from mcpower_tpu_torch.engine.spec import ClusterStatic, SlopeStatic

SIMS = 32
GRID = [60, 120]
SUFF_REL = 1e-12
FIT_REL = 1e-8
DEV_BAND = 1e-2
FLAT = 1e-3
THREADS = 2
DESIGNS = {  # slopes (design column, variance, intercept corr); predictors
    "q2": ([(1, 0.2, 0.3)], 2),
    "q2_null": ([(1, 0.0, 0.0)], 2),
    "q3": ([(1, 0.2, 0.3), (2, 0.1, 0.1)], 2),
}


@pytest.fixture(scope="module", autouse=True)
def _first_cpu_math_call():
    """Take the process's first multi-threaded call of torch's CPU log
    before any comparison (it has been seen to return values ~1e-5 off in a
    loaded process), and run the plain search on THREADS threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    x = torch.rand(1 << 20) + 0.5
    for t in (x, x.double()):
        torch.log(t), torch.sqrt(t)
    yield
    torch.set_num_threads(threads)


def _lowered(low, cluster_cls, slope_cls, name):
    slopes, k = DESIGNS[name]
    corr = np.eye(k)
    corr[0, 1] = corr[1, 0] = 0.3
    return low.lower(
        grid=GRID, var_types=["normal"] * k, corr=corr,
        effects=np.array([0.0, 0.3, 0.2] + [0.1] * (k - 2)), target_cols=list(range(1, k + 1)),
        estimator="mle",
        cluster=cluster_cls("fixed_clusters", 12, 0.3, slopes=tuple(
            slope_cls(design_col=c, variance=v, intercept_corr=r) for c, v, r in slopes)))


def reference_fit(spec, ss, theta0, lower_):
    """The reference's ``_slope_grid_stats.per_grid`` over (sims, grid), on
    its statistics ``ss``, with its own functions: returns its optimum
    ``theta``, ``beta``, ``cov``, ``tau2_hat``, ``converged``, ``pinned``,
    and ``dev_at(theta)``, its f64 deviance at any theta (sims, grid, d)."""
    q, pf = spec.cluster.q, len(spec.effective_fit_cols)
    d = q * (q + 1) // 2
    ns = jnp.asarray(spec.grid, dtype=jnp.float64)
    th0, lo = jnp.asarray(theta0), jnp.asarray(lower_)
    keys = ("G", "A", "b", "xtx", "xty", "yty")
    col_zero = []
    for j in range(q):
        mask = np.ones(d)
        off = sum(q - c for c in range(j))
        mask[off:off + (q - j)] = 0.0
        col_zero.append(jnp.asarray(mask))

    def dev64(G, A, b, xtx, xty, yty, n, theta):
        dev, *_ = ref_mixedfit._reml_quantities_q(
            ref_mixedfit._vech_to_lower(theta, q), G, A, b, xtx, xty, yty, n, pf, q)
        return jnp.where(jnp.isfinite(dev), dev, jnp.float64(1e30))

    def per_grid(G, A, b, xtx, xty, yty, n):
        ss32 = tuple(v.astype(jnp.float32) for v in (G, A, b, xtx, xty, yty))

        def dev32(theta):
            Lam = ref_mixedfit._vech_to_lower(theta.astype(jnp.float32), q)
            dev, *_ = ref_mixedfit._reml_quantities_q(Lam, *ss32, n.astype(jnp.float32), pf, q)
            return jnp.where(jnp.isfinite(dev), dev, jnp.float32(1e30)).astype(jnp.float64)

        theta_hat, _ = ref_optim.nelder_mead(dev32, th0, iters=140, init_step=0.3, lower=lo)
        dev_hat = dev64(G, A, b, xtx, xty, yty, n, theta_hat)
        probes = jnp.stack([dev64(G, A, b, xtx, xty, yty, n, theta_hat * cz) for cz in col_zero])
        pinned = probes <= dev_hat + 1e-10
        keep = jnp.ones(d)
        for j in range(q):
            keep = keep * jnp.where(pinned[j], col_zero[j], 1.0)
        Lam = ref_mixedfit._vech_to_lower(theta_hat * keep, q)
        dev, beta, chol, sigma2 = ref_mixedfit._reml_quantities_q(
            Lam, G, A, b, xtx, xty, yty, n, pf, q)
        cov = sigma2 * ref_smallchol.cho_inverse(chol)
        converged = (jnp.isfinite(dev) & jnp.all(jnp.isfinite(beta)) & (sigma2 > 0)
                     & ref_smallchol.chol_rank_ok(chol))
        return dict(theta=theta_hat, beta=beta, cov=cov, tau2_hat=(Lam @ Lam.T)[0, 0] * sigma2,
                    converged=converged, pinned=pinned)

    grid_axes = (0,) * 6 + (0,)
    out = jax.jit(jax.vmap(lambda *a: jax.vmap(per_grid, in_axes=grid_axes)(*a, ns)))(
        *(ss[k] for k in keys))
    dev_fn = jax.jit(jax.vmap(jax.vmap(dev64, in_axes=(0,) * 6 + (0, 0)),
                              in_axes=(0,) * 6 + (None, 0)))
    out = {k: np.asarray(v) for k, v in out.items()}
    out["dev_at"] = lambda th: np.asarray(dev_fn(*(ss[k] for k in keys), ns, jnp.asarray(th)))
    return out


def port_search(spec, suff, theta0, lower_):
    """The port's f32 search alone (the optimum is not an output of the
    fit): ``theta`` (sims, grid, d)."""
    flat = [suff[k].reshape((-1,) + suff[k].shape[2:]) for k in ("G", "A", "b", "xtx", "xty",
                                                                  "yty")]
    sims, gn = suff["yty"].shape
    n = torch.as_tensor(spec.grid, dtype=torch.float64).expand(sims, gn).reshape(-1)
    st32 = [v.float() for v in flat] + [n.float()]

    def dev32(th):
        dv = mixedfit.slope_deviance(th.float(), *st32)
        return torch.where(torch.isfinite(dv), dv, torch.full_like(dv, mixedfit.SENTINEL32)).double()

    theta, _ = mixedfit.optim.nelder_mead(
        dev32, torch.as_tensor(theta0).expand(n.shape[0], -1), iters=mixedfit.SLOPE_NM_ITERS,
        init_step=mixedfit.SLOPE_NM_STEP, lower=torch.as_tensor(lower_))
    return theta.numpy().reshape(sims, gn, -1)


def port_fit(spec, suff, theta0, lower_, theta=None):
    ns = torch.as_tensor(spec.grid, dtype=torch.float64)
    out = mixedfit.slope_reml_plain(suff["G"], suff["A"], suff["b"], suff["xtx"], suff["xty"],
                                    suff["yty"], ns, theta0, lower_, theta=theta)
    return out, mixedfit._assemble_outputs(spec, *out)


def check_fit_at_reference_theta(spec, suff, ref, theta0, lower_):
    (beta, cov, conv, bnd, tau2, pinned), got = port_fit(
        spec, suff, theta0, lower_, torch.as_tensor(ref["theta"]))
    np.testing.assert_array_equal(conv.numpy(), ref["converged"])
    np.testing.assert_array_equal(pinned.numpy(), ref["pinned"])
    np.testing.assert_array_equal(bnd.numpy(), ref["pinned"].any(-1))
    t2_ref = waldstats.t2_targets(spec, torch.as_tensor(ref["beta"]), torch.as_tensor(ref["cov"]))
    for g, w in ((beta, ref["beta"]), (cov, ref["cov"]), (tau2, ref["tau2_hat"]),
                 (got["t2"], t2_ref.numpy())):
        g = g.numpy()
        assert np.abs(g - w).max() <= FIT_REL * np.abs(w).max(), np.abs(g - w).max()
    return pinned


def check_search(name, spec, suff, ref, theta0, lower_):
    theta_port = port_search(spec, suff, theta0, lower_)
    # the fit from the search's optimum: what slope_reml_plain's own search gives
    (_, _, conv, _, _, pinned), _ = port_fit(spec, suff, theta0, lower_,
                                             torch.as_tensor(theta_port))
    q = spec.cluster.q
    dev_at = ref["dev_at"]
    d_port, d_ref = dev_at(theta_port), dev_at(ref["theta"])
    gap = np.abs(d_port - d_ref)
    print(f"{name}: port - reference f64 deviance at the two optima, extremes "
          f"{np.sort((d_port - d_ref).ravel())[[0, -1]]}; "
          f"{int((theta_port != ref['theta']).any(-1).sum())} of {gap.size} cells end at "
          f"another theta; pins per component port {pinned.numpy().sum((0, 1))}, reference "
          f"{ref['pinned'].sum((0, 1))}")
    assert gap.max() <= DEV_BAND
    differ = np.argwhere(pinned.numpy() != ref["pinned"])
    for sim, g, j in differ:  # the removal's f64 cost at each optimum
        mask = np.ones(theta_port.shape[-1])
        off = sum(q - c for c in range(j))
        mask[off:off + q - j] = 0.0
        costs = [dev_at(th * mask)[sim, g] - dev_at(th)[sim, g]
                 for th in (theta_port, ref["theta"])]
        assert max(abs(c) for c in costs) <= FLAT, (sim, g, j, costs)
    assert len(differ) <= 0.05 * pinned.numel()
    assert int(conv.sum()) == int(ref["converged"].sum())


@pytest.fixture(scope="module", params=sorted(DESIGNS))
def case(request):
    name = request.param
    ref_spec, ref_arr = _lowered(ref_lower, RefCluster, RefSlope, name)
    spec, _ = _lowered(lower, ClusterStatic, SlopeStatic, name)
    sids = jnp.arange(SIMS, dtype=jnp.uint32)
    X, y, ids = ref_datagen.generate_batch(ref_spec, ref_arr, jnp.uint32(2137), jnp.uint32(0), sids)
    m = ref_spec.cluster.n_clusters_at(ref_spec.max_n)
    q = ref_spec.cluster.q
    fit = jnp.asarray(ref_spec.effective_fit_cols)

    def ref_suff(X1, y1, ids1):
        Zf = jnp.concatenate([jnp.ones((ref_spec.max_n, 1)), X1[:, jnp.asarray(
            [s.design_col for s in ref_spec.cluster.slopes])].astype(jnp.float64)], axis=1)
        return ref_mixedfit._slope_cluster_suffstats(
            ref_spec, X1[:, fit].astype(jnp.float64), y1.astype(jnp.float64), ids1, m, q, Zf)

    ss = jax.jit(jax.vmap(ref_suff))(X, y, ids)
    theta0, lower_ = mixedfit.slope_start(spec)
    ref = reference_fit(ref_spec, ss, theta0, lower_)
    if name == "q2":  # the replica against the reference's own arm
        stats = jax.jit(jax.vmap(lambda a, b_, c: ref_mixedfit.mixed_grid_stats(
            ref_spec, ref_arr, a, b_, c)))(X, y, ids)
        ref["mixed_grid_stats"] = {k: np.asarray(v) for k, v in stats.items()}
    Xt, yt = torch.as_tensor(np.array(X)), torch.as_tensor(np.array(y))
    return dict(name=name, spec=spec, ss={k: np.asarray(v) for k, v in ss.items()}, ref=ref,
                theta0=theta0, lower=lower_,
                suff=olsfit.grid_suffstats(spec, Xt, yt, with_slopes=True))


def test_slope_statistics_match_the_reference(case):
    ss, got = case["ss"], case["suff"]
    for k in ("G", "A", "b", "xtx", "xty", "yty"):
        g = got[k].numpy()
        assert g.shape == ss[k].shape, k
        assert np.abs(g - ss[k]).max() <= SUFF_REL * np.abs(ss[k]).max(), k
    np.testing.assert_array_equal(got["G"][..., 0, 0].numpy(), got["n_j"].numpy())


def test_fit_at_the_reference_theta(case):
    pinned = check_fit_at_reference_theta(case["spec"], case["suff"], case["ref"], case["theta0"],
                                          case["lower"])
    if case["name"] == "q2_null":
        assert pinned[..., 1].sum() > 0.2 * SIMS * len(GRID)  # the null slope pins often
    if "mixed_grid_stats" in case["ref"]:  # the replica is the reference's arm
        ref, mgs = case["ref"], case["ref"]["mixed_grid_stats"]
        t2 = waldstats.t2_targets(case["spec"], torch.as_tensor(ref["beta"]),
                                  torch.as_tensor(ref["cov"])).numpy()
        np.testing.assert_array_equal(t2, mgs["t2"])
        np.testing.assert_array_equal(ref["tau2_hat"] * ref["converged"],
                                      mgs["tau2_hat"] * mgs["converged"])
        np.testing.assert_array_equal(ref["pinned"] & ref["converged"][..., None],
                                      mgs["pinned_comp"])


def test_search_against_the_reference(case):
    check_search(case["name"], case["spec"], case["suff"], case["ref"], case["theta0"],
                 case["lower"])
