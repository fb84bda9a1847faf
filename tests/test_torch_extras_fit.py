"""The port's joint-Z LMM fit of extra groupings (K2's joint mode and kernel
K11's plain version) against ``mcpower_tpu.engine.mixedfit`` on the CPU, on
the reference's own bytes: the structured capacitance (every grouping
intercept-only). tests/test_torch_extras_dense.py runs the dense branch
through the same checks.

X and y come from the reference's ``generate_batch`` (SIMS sims, a two-point
grid, 6 round-robin clusters crossed with 4 levels). Checks:

* the joint statistics ztz, ztx, zty (and X'X, X'y, y'y) against the
  reference's ``_joint_suffstats`` over its dense ``_build_joint_z``, to
  SUFF_REL relative (counts exact);
* the fit at the reference's own theta: :func:`reference_fit` runs the
  reference's ``_joint_grid_stats.per_grid`` (:719-817) with its own
  ``_reml_quantities_joint(_q1)``, ``_lam_all``, ``optim.nelder_mead`` and
  ``smallchol``, and returns its optimum beside its results, held to the
  reference's ``mixed_grid_stats`` (t^2, tau^2 and every flag equal). The
  port fitted at that theta (``joint_reml_plain(theta=)``) must give beta,
  cov, sigma^2, tau^2 and t^2 within FIT_REL (1e-8) and every flag
  (converged, boundary, the pin of each component) equal;
* the search: both rank candidates on f32 deviances, whose rounding differs
  between XLA and torch, so a cell's two searches may stop at different
  simplex points; at each cell's two optima the reference's f64 deviance
  must agree within DEV_BAND, and a pin may differ only where the
  component's Cholesky diagonal is below FLAT_DIAG at one optimum (the
  deviance is flat there).
"""

import time

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
from mcpower_tpu.engine.spec import ExtraGroupingStatic as RefExtra
from mcpower_tpu.engine.spec import SlopeStatic as RefSlope
from mcpower_tpu_torch.engine import lower, mixedfit, olsfit, optim, waldstats
from mcpower_tpu_torch.engine.spec import ClusterStatic, ExtraGroupingStatic, SlopeStatic

SIMS = 32
SUFF_REL = 1e-12
FIT_REL = 1e-8
DEV_BAND = 1e-2
FLAT_DIAG = 5e-2
THREADS = 2
STRUCTURED = dict(grid=[48, 96], var_types=["normal", "normal"],
                  corr=[[1.0, 0.3], [0.3, 1.0]], effects=[0.0, 0.3, 0.2], target_cols=[1, 2],
                  primary=(6, 0.25, []), extras=[("crossed", 4, 0.15, [])])


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


def lowered(low, cluster_cls, extra_cls, slope_cls, design):
    m, tau2, slopes = design["primary"]

    def sl(spec):
        return tuple(slope_cls(design_col=c, variance=v, intercept_corr=r) for c, v, r in spec)

    return low.lower(
        grid=design["grid"], var_types=design["var_types"], corr=np.asarray(design["corr"]),
        effects=np.asarray(design["effects"]), target_cols=design["target_cols"],
        estimator="mle",
        cluster=cluster_cls("fixed_clusters", m, tau2, slopes=sl(slopes), extra_groupings=tuple(
            extra_cls(rel, lv, t2, slopes=sl(s)) for rel, lv, t2, s in design["extras"])))


def reference_fit(rs, ss):
    """The reference's ``_joint_grid_stats.per_grid`` over (sims, grid) on
    its statistics ``ss``, with its own functions: returns its optimum
    ``theta`` and ``beta``, ``cov``, ``sigma2``, ``tau2_hat``,
    ``converged``, ``pinned``, and ``dev_at(theta)``, its f64 deviance at
    any theta (sims, grid, d)."""
    plan = ref_mixedfit._grouping_plan(rs)
    M = sum(n_lv * q for n_lv, q, _, _, _ in plan)
    sizes, theta0, lower_ = ref_mixedfit._theta_layout(plan)
    pf = len(rs.effective_fit_cols)
    all_q1 = ref_mixedfit._plan_all_q1(plan)
    q1 = plan[0][1]
    ns = jnp.asarray(rs.grid, dtype=jnp.float64)
    keys = ("ztz", "ztx", "zty", "xtx", "xty", "yty")

    def quantities(theta, st, n):
        if all_q1:
            return ref_mixedfit._reml_quantities_joint_q1(theta, plan, *st, n, pf)
        Lam = ref_mixedfit._lam_all(theta, plan, sizes, M)
        return ref_mixedfit._reml_quantities_joint(Lam, *st, n, pf)

    def dev64(ztz, ztx, zty, xtx, xty, yty, n, theta):
        dev, *_ = quantities(theta, (ztz, ztx, zty, xtx, xty, yty), n)
        return jnp.where(jnp.isfinite(dev), dev, jnp.float64(1e30))

    def per_grid(ztz, ztx, zty, xtx, xty, yty, n):
        st = (ztz, ztx, zty, xtx, xty, yty)
        st32 = tuple(a.astype(jnp.float32) for a in st)

        def dev_at32(theta):
            dev, *_ = quantities(theta.astype(jnp.float32), st32, n.astype(jnp.float32))
            return jnp.where(jnp.isfinite(dev), dev, jnp.float32(1e30)).astype(jnp.float64)

        theta_hat, _ = ref_optim.nelder_mead(dev_at32, theta0, iters=140, init_step=0.3,
                                             lower=lower_)
        dev, beta, chol, sigma2 = quantities(theta_hat, st, n)
        cov = sigma2 * ref_smallchol.cho_inverse(chol)
        Lam1 = ref_mixedfit._vech_to_lower(theta_hat[: sizes[0]], q1)
        diag, off = [], 0
        for (_, q, _, _, _), sz in zip(plan, sizes):
            diag.append(jnp.diagonal(ref_mixedfit._vech_to_lower(theta_hat[off:off + sz], q)))
            off += sz
        converged = (jnp.isfinite(dev) & jnp.all(jnp.isfinite(beta)) & (sigma2 > 0)
                     & ref_smallchol.chol_rank_ok(chol))
        return dict(theta=theta_hat, beta=beta, cov=cov, sigma2=sigma2,
                    tau2_hat=(Lam1 @ Lam1.T)[0, 0] * sigma2, converged=converged,
                    pinned=jnp.concatenate(diag) < 1e-4)

    out = jax.jit(jax.vmap(lambda *a: jax.vmap(per_grid)(*a, ns)))(*(ss[k] for k in keys))
    dev_fn = jax.jit(jax.vmap(jax.vmap(dev64, in_axes=(0,) * 6 + (0, 0)),
                              in_axes=(0,) * 6 + (None, 0)))
    out = {k: np.asarray(v) for k, v in out.items()}
    out["dev_at"] = lambda th: np.asarray(dev_fn(*(ss[k] for k in keys), ns, jnp.asarray(th)))
    return out


def _args(spec, suff):
    plan = mixedfit.grouping_plan(spec)
    _, theta0, lower_ = mixedfit.theta_layout(plan)
    ns = torch.as_tensor(spec.grid, dtype=torch.float64)
    return ([suff[k] for k in ("ztz", "ztx", "zty", "xtx", "xty", "yty")] + [ns],
            [(m, q) for m, q, _, _, _ in plan], theta0, lower_)


def port_search(spec, suff):
    """The port's f32 search alone: ``theta`` (sims, grid, d)."""
    stats, shape, theta0, lower_ = _args(spec, suff)
    sims, gn = suff["yty"].shape
    flat = [v.reshape((-1,) + v.shape[2:]) for v in stats[:6]]
    n = stats[6].expand(sims, gn).reshape(-1)
    st32 = [v.float() for v in flat] + [n.float()]

    def dev32(th):
        dv = mixedfit.joint_deviance(th.float(), shape, *st32)
        return torch.where(torch.isfinite(dv), dv, torch.full_like(dv, mixedfit.SENTINEL32)).double()

    theta, _ = optim.nelder_mead(dev32, torch.as_tensor(theta0).expand(n.shape[0], -1),
                                 iters=mixedfit.SLOPE_NM_ITERS, init_step=mixedfit.SLOPE_NM_STEP,
                                 lower=torch.as_tensor(lower_))
    return theta.numpy().reshape(sims, gn, -1)


def build_case(design, with_arm=True):
    rs, ra = lowered(ref_lower, RefCluster, RefExtra, RefSlope, design)
    spec, _ = lowered(lower, ClusterStatic, ExtraGroupingStatic, SlopeStatic, design)
    X, y, ids = ref_datagen.generate_batch(rs, ra, jnp.uint32(2137), jnp.uint32(0),
                                           jnp.arange(SIMS, dtype=jnp.uint32))
    fit = jnp.asarray(rs.effective_fit_cols)

    def ref_suff(X1, y1, ids1):
        Z = ref_mixedfit._build_joint_z(rs, X1, ids1)
        return ref_mixedfit._joint_suffstats(rs, X1[:, fit].astype(jnp.float64),
                                             y1.astype(jnp.float64), Z)

    ss = jax.jit(jax.vmap(ref_suff))(X, y, ids)
    t0 = time.perf_counter()
    ref = reference_fit(rs, ss)
    print(f"the reference's search and fit, compiled and run: {time.perf_counter() - t0:.1f} s")
    if with_arm:
        stats = jax.jit(jax.vmap(lambda a, b_, c: ref_mixedfit.mixed_grid_stats(rs, ra, a, b_,
                                                                                c)))(X, y, ids)
        ref["mixed_grid_stats"] = {k: np.asarray(v) for k, v in stats.items()}
    Xt, yt = torch.as_tensor(np.array(X)), torch.as_tensor(np.array(y))
    return dict(spec=spec, ss={k: np.asarray(v) for k, v in ss.items()}, ref=ref,
                suff=olsfit.joint_suffstats_plain(spec, Xt, yt))


def check_statistics(case):
    ss, got = case["ss"], case["suff"]
    for k in ("ztz", "ztx", "zty", "xtx", "xty", "yty"):
        g = got[k].numpy()
        assert g.shape == ss[k].shape, k
        assert np.abs(g - ss[k]).max() <= SUFF_REL * np.abs(ss[k]).max(), k


def check_replica(case):
    """The replica returns what the reference's own arm returns."""
    ref, mgs, spec = case["ref"], case["ref"]["mixed_grid_stats"], case["spec"]
    t2 = waldstats.t2_targets(spec, torch.as_tensor(ref["beta"]), torch.as_tensor(ref["cov"]))
    np.testing.assert_array_equal(t2.numpy(), mgs["t2"])
    np.testing.assert_array_equal(ref["tau2_hat"], mgs["tau2_hat"])
    np.testing.assert_array_equal(ref["converged"], mgs["converged"])
    np.testing.assert_array_equal(ref["pinned"] & ref["converged"][..., None], mgs["pinned_comp"])
    np.testing.assert_array_equal(ref["pinned"].any(-1), mgs["boundary_hit"])


def check_fit_at_reference_theta(case):
    spec, suff, ref = case["spec"], case["suff"], case["ref"]
    stats, shape, theta0, lower_ = _args(spec, suff)
    theta = torch.as_tensor(ref["theta"])
    beta, cov, conv, bnd, tau2, pinned = mixedfit.joint_reml_plain(
        *stats, shape, theta0, lower_, theta=theta)
    np.testing.assert_array_equal(conv.numpy(), ref["converged"])
    np.testing.assert_array_equal(pinned.numpy(), ref["pinned"])
    np.testing.assert_array_equal(bnd.numpy(), ref["pinned"].any(-1))
    sims, gn = suff["yty"].shape
    flat = [v.reshape((-1,) + v.shape[2:]) for v in stats[:6]]
    _, _, _, sigma2 = mixedfit.joint_deviance(theta.reshape(-1, 1, theta.shape[-1]), shape, *flat,
                                              stats[6].expand(sims, gn).reshape(-1), full=True)
    t2 = waldstats.t2_targets(spec, beta, cov)
    t2_ref = waldstats.t2_targets(spec, torch.as_tensor(ref["beta"]), torch.as_tensor(ref["cov"]))
    for name, g, w in (("beta", beta, ref["beta"]), ("cov", cov, ref["cov"]),
                       ("sigma2", sigma2.reshape(sims, gn), ref["sigma2"]),
                       ("tau2", tau2, ref["tau2_hat"]), ("t2", t2, t2_ref.numpy())):
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= FIT_REL, (name, err)
    return pinned


def check_search(name, case):
    spec, suff, ref = case["spec"], case["suff"], case["ref"]
    theta_port = port_search(spec, suff)
    stats, shape, theta0, lower_ = _args(spec, suff)
    _, _, conv, _, _, pinned = mixedfit.joint_reml_plain(*stats, shape, theta0, lower_,
                                                         theta=torch.as_tensor(theta_port))
    d_port, d_ref = ref["dev_at"](theta_port), ref["dev_at"](ref["theta"])
    gap = np.abs(d_port - d_ref)
    differ = np.argwhere(pinned.numpy() != ref["pinned"])
    print(f"{name}: port - reference f64 deviance at the two optima, extremes "
          f"{np.sort((d_port - d_ref).ravel())[[0, -1]]}; "
          f"{int((theta_port != ref['theta']).any(-1).sum())} of {gap.size} cells end at "
          f"another theta; pins per component port {pinned.numpy().sum((0, 1))}, reference "
          f"{ref['pinned'].sum((0, 1))}")
    assert gap.max() <= DEV_BAND
    diag = []
    off = 0
    for _, q in shape:
        diag += [off + k for k in mixedfit.vech_diagonal(q)]
        off += q * (q + 1) // 2
    for sim, g, j in differ:  # a pin differs only where the component is flat at ~0
        assert min(theta_port[sim, g, diag[j]], ref["theta"][sim, g, diag[j]]) <= FLAT_DIAG
    assert int(conv.sum()) == int(ref["converged"].sum())


@pytest.fixture(scope="module")
def case():
    return build_case(STRUCTURED)


def test_joint_statistics_match_the_reference(case):
    check_statistics(case)
    assert mixedfit.plan_all_q1(mixedfit.grouping_plan(case["spec"]))
    np.testing.assert_array_equal(case["suff"]["ztz"][..., 0, 0].numpy(),
                                  case["ss"]["ztz"][..., 0, 0])  # counts: exact


def test_the_replica_is_the_references_arm(case):
    check_replica(case)


def test_fit_at_the_reference_theta(case):
    check_fit_at_reference_theta(case)


def test_the_search_against_the_reference(case):
    check_search("structured", case)
