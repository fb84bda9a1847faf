"""The port's GLMM with random slopes (kernel K10's plain version,
``glmmfit.glmm_slope_plain``) against ``mcpower_tpu`` on the CPU, on the
reference's own bytes.

A logit design of q = 2 (a random intercept and a slope on x1: tau^2 0.25,
slope variance 0.2, corr 0.3), SIMS sims, the grid [60, 120], 12
round-robin clusters; X and y come from the reference's ``generate_batch``.
Checks:

* the port's generator gives the reference's X and y (the slope design's
  random effects feed a binary outcome's linear predictor);
* :func:`reference_replica` is the reference's ``_slope_glmm_grid_stats.
  per_grid`` (:594-891) written out with the reference's own functions and
  the closure bodies of its ``make_pirls`` and ``dev_tail`` copied, so that
  it returns its optimum theta beside its results; it is held to the
  reference's ``glmm_grid_stats``: t^2, tau^2 and the flags equal;
* the fit at the reference's theta (``glmm_slope_plain(theta=)``): beta,
  cov, tau^2 and t^2 within FIT_REL (1e-8), and converged, boundary and
  each component's pin equal;
* the search: the reference ranks its candidates on f32 Laplace
  deviances of a few hundred from f32 PIRLS modes, and its Nelder-Mead
  follows their rounding; the port's f32 sums round otherwise, so its
  simplex parts from the reference's once two candidates differ by less
  than that, and where the slope variance's optimum is flat (near 0) the
  two stall further apart. At each cell's two optima the f64 deviance (the
  reference's, at each theta) must agree within DEV_BAND (measured 4.2e-3
  here, 52 of the 64 cells ending at another theta), and a pin may differ
  only where the removal costs less than FLAT at both optima (measured:
  one pin of 128, its removal costing 4.4e-5 at the port's optimum and
  -1.6e-5 at the reference's; ROADMAP C).

tests/test_torch_glmm_slopes_links.py runs probit, Poisson, q = 3 and the
Hessian covariance through the same checks; tests/test_torch_glmm_slopes_wide.py
p = 14. Kernel K10 itself runs only on the card, where ``chip_smoke.py``
holds it against this plain version bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpower_tpu.engine import clusterops as ref_clusterops
from mcpower_tpu.engine import datagen as ref_datagen
from mcpower_tpu.engine import glmmfit as ref_glmmfit
from mcpower_tpu.engine import lower as ref_lower
from mcpower_tpu.engine import optim as ref_optim
from mcpower_tpu.engine import smallchol as ref_sc
from mcpower_tpu.engine.glmfit import MU_EPS, _deviance, _link_funcs
from mcpower_tpu.engine.mixedfit import _vech_to_lower
from mcpower_tpu.engine.spec import ClusterStatic as RefCluster
from mcpower_tpu.engine.spec import SlopeStatic as RefSlope
from mcpower_tpu_torch.engine import datagen, glmfit, glmmfit, lower, mixedfit, waldstats
from mcpower_tpu_torch.engine.spec import ClusterStatic, SlopeStatic

SIMS = 32
GRID = [60, 120]
FIT_REL = 1e-8
DEV_BAND = 1e-2
FLAT = 1e-3
THREADS = 2
BASE = dict(outcome="binary", link="canonical", effects=[-0.3, 0.4, 0.25], tau2=0.25,
            slopes=[(1, 0.2, 0.3)], k=2, wald_se="rx")


@pytest.fixture(scope="module", autouse=True)
def _first_cpu_math_call():
    """Take the process's first multi-threaded call of torch's CPU log,
    exp and sqrt before any comparison (it has been seen to return values
    ~1e-5 off in a loaded process), and run the plain fit on THREADS
    threads, so that parallel test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    x = torch.rand(1 << 20) + 0.5
    for t in (x, x.double()):
        torch.log(t), torch.log1p(t), torch.exp(t), torch.sqrt(t), torch.erf(t)
    yield
    torch.set_num_threads(threads)


def lowered(low, cluster_cls, slope_cls, d):
    return low.lower(
        grid=d.get("grid", GRID), var_types=["normal"] * d["k"], effects=np.asarray(d["effects"]),
        target_cols=list(range(1, d["k"] + 1)), outcome=d["outcome"], link=d["link"],
        estimator="glm", wald_se=d["wald_se"], report_overall=True,
        cluster=cluster_cls("fixed_clusters", d.get("clusters", 12), d["tau2"], slopes=tuple(
            slope_cls(design_col=c, variance=v, intercept_corr=r) for c, v, r in d["slopes"])))


def reference_replica(spec, arr, theta_given: bool):
    """The reference's ``_slope_glmm_grid_stats.per_grid`` for one sim,
    vmapped over the grid: ``f(X, y[, theta (G, d)])`` returns its optimum
    ``theta`` (or the given one), ``beta``, ``cov``, ``converged``,
    ``pinned``, ``tau2_hat``, ``ybar``, the f64 fit's Laplace deviance
    ``lap`` and the pin ``probes``."""
    c = spec.cluster
    m = c.n_clusters_at(spec.max_n)
    q = c.q
    fit_cols = spec.effective_fit_cols
    pf = len(fit_cols)
    rows = jnp.arange(spec.max_n)
    mu_var_dmu = _link_funcs(spec.outcome, spec.link)
    eye_p = 1e-10 * jnp.eye(pf, dtype=jnp.float64)
    eye_q = jnp.eye(q, dtype=jnp.float64)
    if spec.scenario.truth_start:
        beta0 = arr["effects"].astype(jnp.float64)[jnp.asarray(fit_cols)]
    else:
        beta0 = jnp.zeros(pf, jnp.float64)
    theta0, lower_ = mixedfit.slope_start(spec)
    theta0, lower_ = jnp.asarray(theta0), jnp.asarray(lower_)

    def seg_rows(x):
        return jnp.moveaxis(ref_clusterops.seg_sum(spec, jnp.moveaxis(x, 0, -1)), -1, 0)

    def rows_of(v):
        return jnp.moveaxis(ref_clusterops.per_row(spec, jnp.moveaxis(v, 0, -1), spec.max_n),
                            -1, 0)

    def per_grid(Xf, yf, Zf, n, theta_in):
        mask = (rows < n).astype(jnp.float64)

        def make_loop(dtype):  # make_pirls's loop (:666-745), copied
            Xd, yd, Zd, md = (a.astype(dtype) for a in (Xf, yf, Zf, mask))
            eye_pd = (1e-10 if dtype == jnp.float64 else 1e-6) * jnp.eye(pf, dtype=dtype)
            eye_qd = jnp.eye(q, dtype=dtype)

            def loop(Ld, beta, v, iters):
                def body(_, carry):
                    beta, v = carry
                    u = (v[:, None, :] * Ld[None, :, :]).sum(-1)
                    eta = ref_sc.rowmv(Xd, beta) + jnp.einsum("nq,nq->n", Zd, rows_of(u))
                    mu, var, dmu = mu_var_dmu(eta)
                    w = (dmu * dmu / jnp.maximum(var, MU_EPS)) * md
                    z = eta + (yd - mu) / dmu
                    wZ = Zd * w[:, None]
                    G = seg_rows(wZ[:, :, None] * Zd[:, None, :])
                    A = seg_rows(wZ[:, :, None] * Xd[:, None, :])
                    b = seg_rows(wZ * z[:, None])
                    LtG = (Ld[None, :, :, None] * G[:, :, None, :]).sum(1)
                    C = eye_qd[None] + (LtG[:, :, :, None] * Ld[None, None, :, :]).sum(2)
                    cholC = ref_sc.chol(C)
                    At = (Ld[None, :, :, None] * A[:, :, None, :]).sum(1)
                    bt = (Ld[None, :, :] * b[:, :, None]).sum(1)
                    sol_b = ref_sc.cho_solve(cholC, bt)
                    sol_A = jax.vmap(lambda ch, aa: jax.vmap(
                        lambda col: ref_sc.cho_solve(ch, col))(aa.T).T)(cholC, At)
                    a_xx = (ref_sc.crossprod(Xd, w)
                            - (At[:, :, :, None] * sol_A[:, :, None, :]).sum((0, 1)) + eye_pd)
                    a_xy = ref_sc.colsum(Xd, w * z) - (At * sol_b[:, :, None]).sum((0, 1))
                    beta_new = ref_sc.cho_solve(ref_sc.chol(a_xx), a_xy)
                    v_new = sol_b - (sol_A * beta_new[None, None, :]).sum(-1)
                    ok = jnp.all(jnp.isfinite(beta_new)) & jnp.all(jnp.isfinite(v_new))
                    return jnp.where(ok, beta_new, beta), jnp.where(ok, v_new, v)

                return jax.lax.fori_loop(0, iters, body, (beta, v))

            return loop

        def make_tail(dtype):  # dev_tail (:753-781), copied
            Xd, yd, Zd, md = (a.astype(dtype) for a in (Xf, yf, Zf, mask))
            eye_qd = jnp.eye(q, dtype=dtype)

            def tail(Lam, beta, v):
                u = (v[:, None, :] * Lam[None, :, :]).sum(-1)
                eta = ref_sc.rowmv(Xd, beta) + jnp.einsum("nq,nq->n", Zd, rows_of(u))
                mu, var, dmu = mu_var_dmu(eta)
                w = (dmu * dmu / jnp.maximum(var, MU_EPS)) * md
                wZ = Zd * w[:, None]
                G = seg_rows(wZ[:, :, None] * Zd[:, None, :])
                LtG = (Lam[None, :, :, None] * G[:, :, None, :]).sum(1)
                C = eye_qd[None] + (LtG[:, :, :, None] * Lam[None, None, :, :]).sum(2)
                return (_deviance(spec.outcome, yd, mu, md) + jnp.sum(v * v)
                        + jnp.sum(ref_sc.logdet_from_chol(ref_sc.chol(C))))

            return tail

        loop64, loop32 = make_loop(jnp.float64), make_loop(jnp.float32)
        tail64, tail32 = make_tail(jnp.float64), make_tail(jnp.float32)

        def pirls(Lam, beta, v, iters):  # make_pirls's pirls (:704-745), copied
            beta, v = loop64(Lam, beta, v, iters)
            u = (v[:, None, :] * Lam[None, :, :]).sum(-1)
            eta = ref_sc.rowmv(Xf, beta) + jnp.einsum("nq,nq->n", Zf, rows_of(u))
            mu, var, dmu = mu_var_dmu(eta)
            w = (dmu * dmu / jnp.maximum(var, MU_EPS)) * mask
            wZ = Zf * w[:, None]
            G = seg_rows(wZ[:, :, None] * Zf[:, None, :])
            A = seg_rows(wZ[:, :, None] * Xf[:, None, :])
            LtG = (Lam[None, :, :, None] * G[:, :, None, :]).sum(1)
            C = eye_q[None] + (LtG[:, :, :, None] * Lam[None, None, :, :]).sum(2)
            cholC = ref_sc.chol(C)
            At = (Lam[None, :, :, None] * A[:, :, None, :]).sum(1)
            sol_A = jax.vmap(lambda ch, aa: jax.vmap(
                lambda col: ref_sc.cho_solve(ch, col))(aa.T).T)(cholC, At)
            a_xx = (ref_sc.crossprod(Xf, w)
                    - (At[:, :, :, None] * sol_A[:, :, None, :]).sum((0, 1)) + eye_p)
            lap = (_deviance(spec.outcome, yf, mu, mask) + jnp.sum(v * v)
                   + jnp.sum(ref_sc.logdet_from_chol(cholC)))
            return beta, v, lap, a_xx

        v0 = jnp.zeros((m, q), jnp.float64)
        if theta_in is None:
            def search_eval(theta, carry, iters):
                Lam32 = _vech_to_lower(theta, q).astype(jnp.float32)
                beta, v = loop32(Lam32, carry[0], carry[1], iters)
                lap = tail32(Lam32, beta, v).astype(jnp.float64)
                return jnp.where(jnp.isfinite(lap), lap, jnp.float64(1e30)), (beta, v)

            theta_hat, _, _ = ref_optim.nelder_mead_carry(
                search_eval, theta0, (beta0.astype(jnp.float32), v0.astype(jnp.float32)),
                phases=((ref_glmmfit.NM_FULL_SLOPE, ref_glmmfit.N_PIRLS_SLOPE),
                        (ref_glmmfit.NM_ITERS_GLMM - ref_glmmfit.NM_FULL_SLOPE,
                         ref_glmmfit.N_PIRLS_SLOPE_WARM)),
                init_step=0.2, lower=lower_)
        else:
            theta_hat = theta_in
        Lam = _vech_to_lower(theta_hat, q)
        beta, v, lap, a_xx = pirls(Lam, beta0, v0, ref_glmmfit.N_PIRLS)
        cholP = ref_sc.chol(a_xx)
        cov = ref_sc.cho_inverse(cholP)
        if spec.wald_se == "hessian":  # dev_beta (:821-858), copied
            def dev_beta(beta_q):
                fixed = ref_sc.rowmv(Xf, beta_q)

                def vbody(_, v_q):
                    u = (v_q[:, None, :] * Lam[None, :, :]).sum(-1)
                    eta = fixed + jnp.einsum("nq,nq->n", Zf, rows_of(u))
                    mu, var, dmu = mu_var_dmu(eta)
                    w = (dmu * dmu / jnp.maximum(var, MU_EPS)) * mask
                    z = eta + (yf - mu) / dmu
                    wZ = Zf * w[:, None]
                    G = seg_rows(wZ[:, :, None] * Zf[:, None, :])
                    r = seg_rows(wZ * (z - fixed)[:, None])
                    LtG = (Lam[None, :, :, None] * G[:, :, None, :]).sum(1)
                    C = eye_q[None] + (LtG[:, :, :, None] * Lam[None, None, :, :]).sum(2)
                    rhs = jnp.einsum("ab,ma->mb", Lam, r)
                    v_new = ref_sc.cho_solve(ref_sc.chol(C), rhs)
                    return jnp.where(jnp.all(jnp.isfinite(v_new)), v_new, v_q)

                v_q = jax.lax.fori_loop(0, 20, vbody, v)
                u = (v_q[:, None, :] * Lam[None, :, :]).sum(-1)
                eta = fixed + jnp.einsum("nq,nq->n", Zf, rows_of(u))
                mu, var, dmu = mu_var_dmu(eta)
                w = (dmu * dmu / jnp.maximum(var, MU_EPS)) * mask
                wZ = Zf * w[:, None]
                G = seg_rows(wZ[:, :, None] * Zf[:, None, :])
                LtG = (Lam[None, :, :, None] * G[:, :, None, :]).sum(1)
                C = eye_q[None] + (LtG[:, :, :, None] * Lam[None, None, :, :]).sum(2)
                return (_deviance(spec.outcome, yf, mu, mask) + jnp.sum(v_q * v_q)
                        + jnp.sum(ref_sc.logdet_from_chol(ref_sc.chol(C))))

            cov = ref_glmmfit._fd_hessian_cov(dev_beta, beta, cov)
        d_theta = q * (q + 1) // 2
        probes = []
        for j in range(q):
            cz = np.ones(d_theta)
            off = sum(q - cc for cc in range(j))
            cz[off:off + (q - j)] = 0.0
            Lam_j = _vech_to_lower(theta_hat * jnp.asarray(cz, jnp.float64), q)
            bj, vj = loop64(Lam_j, beta, v, ref_glmmfit.N_PIRLS_SLOPE_WARM)
            probes.append(tail64(Lam_j, bj, vj))
        probes = jnp.stack(probes)
        pinned = probes <= lap + 1e-10
        converged = (jnp.all(jnp.isfinite(beta)) & ref_sc.chol_ok(cholP)
                     & ref_sc.rank_ok(a_xx - eye_p) & jnp.isfinite(lap))
        ybar = jnp.sum(yf * (rows < n)) / jnp.asarray(n, jnp.float64)
        return dict(theta=theta_hat, beta=beta, cov=cov, converged=converged, pinned=pinned,
                    tau2_hat=(Lam @ Lam.T)[0, 0], ybar=ybar, lap=lap, probes=probes)

    ns = jnp.asarray(spec.grid, jnp.int32)

    def one_sim(X, y, theta=None):
        Xf = X[:, jnp.asarray(fit_cols)].astype(jnp.float64)
        Zf = jnp.concatenate([jnp.ones((spec.max_n, 1), jnp.float64), X[:, jnp.asarray(
            [s.design_col for s in c.slopes])].astype(jnp.float64)], axis=1)
        yf = y.astype(jnp.float64)
        if theta is None:
            return jax.vmap(lambda n: per_grid(Xf, yf, Zf, n, None))(ns)
        return jax.vmap(lambda n, th: per_grid(Xf, yf, Zf, n, th))(ns, theta)

    if theta_given:
        return jax.jit(jax.vmap(one_sim))
    return jax.jit(jax.vmap(lambda X, y: one_sim(X, y)))


def build_case(d, Xy=None):
    """Both packages' specs, the bytes (the reference's generator's, or
    ``Xy``) and the reference's outputs, and the port's arguments of
    ``glmm_slope_plain``."""
    ref_spec, ref_arr = lowered(ref_lower, RefCluster, RefSlope, d)
    spec, arr = lowered(lower, ClusterStatic, SlopeStatic, d)
    if Xy is None:
        X, y, ids = ref_datagen.generate_batch(ref_spec, ref_arr, 2137, 0,
                                               jnp.arange(SIMS, dtype=jnp.uint32))
    else:
        (X, y), ids = (jnp.asarray(v) for v in Xy), None
    ref = {k: np.asarray(v) for k, v in reference_replica(ref_spec, ref_arr, False)(X, y).items()}
    at = reference_replica(ref_spec, ref_arr, True)
    arr = datagen.to_device(arr, "cpu")
    Xt, yt = torch.as_tensor(np.array(X)), torch.as_tensor(np.array(y))
    fit = list(spec.effective_fit_cols)
    theta0, lower_ = mixedfit.slope_start(spec)
    args = (glmfit.link_code(spec.outcome, spec.link), Xt, yt, fit,
            [s.design_col for s in spec.cluster.slopes], spec.grid, glmmfit.layout_of(spec),
            arr["effects"].to(torch.float64)[fit], theta0, lower_, spec.wald_se == "hessian")
    return dict(spec=spec, arr=arr, ref_spec=ref_spec, ref_arr=ref_arr, X=X, y=y, ids=ids,
                ref=ref, at=lambda th: {k: np.asarray(v) for k, v in at(X, y, th).items()},
                args=args)


def check_fit_at_reference_theta(case, t2_rel=FIT_REL, cov_rel=FIT_REL):
    spec, ref = case["spec"], case["ref"]
    beta, cov, conv, bnd, tau2, ybar, pinned, theta = glmmfit.glmm_slope_plain(
        *case["args"], theta=torch.as_tensor(ref["theta"]))
    np.testing.assert_array_equal(theta.numpy(), ref["theta"])
    np.testing.assert_array_equal(conv.numpy(), ref["converged"])
    np.testing.assert_array_equal(pinned.numpy(), ref["pinned"])
    np.testing.assert_array_equal(bnd.numpy(), ref["pinned"].any(-1))
    t2_ref = waldstats.t2_targets(spec, torch.as_tensor(ref["beta"]), torch.as_tensor(ref["cov"]))
    for name, g, w, rel in (("beta", beta, ref["beta"], FIT_REL), ("cov", cov, ref["cov"], cov_rel),
                            ("tau2", tau2, ref["tau2_hat"], FIT_REL),
                            ("t2", waldstats.t2_targets(spec, beta, cov), t2_ref.numpy(), t2_rel),
                            ("ybar", ybar, ref["ybar"], FIT_REL)):
        g = g.numpy()
        assert np.abs(g - w).max() <= rel * np.abs(w).max(), (name, np.abs(g - w).max())
    return pinned


def check_search(case, name, dev_band=DEV_BAND):
    """The port's optimum against the reference's, judged by the
    reference's own f64 deviance at each."""
    ref = case["ref"]
    *_, pinned, theta = glmmfit.glmm_slope_plain(*case["args"])
    at_port = case["at"](theta.numpy())
    d_port, d_ref = at_port["lap"], ref["lap"]
    gap = np.abs(d_port - d_ref)
    print(f"{name}: port - reference f64 deviance at the two optima, extremes "
          f"{np.sort((d_port - d_ref).ravel())[[0, -1]]}; "
          f"{int((theta.numpy() != ref['theta']).any(-1).sum())} of {gap.size} cells end at "
          f"another theta; pins per component port {pinned.numpy().sum((0, 1))}, reference "
          f"{ref['pinned'].sum((0, 1))}")
    assert gap.max() <= dev_band, gap.max()
    differ = np.argwhere(pinned.numpy() != ref["pinned"])
    for sim, g, j in differ:  # the removal's f64 cost at each optimum
        costs = [r["probes"][sim, g, j] - r["lap"][sim, g] for r in (at_port, ref)]
        print(f"{name}: pin of component {j} differs in cell ({sim}, {g}): removal costs {costs}")
        assert max(abs(c) for c in costs) <= FLAT, (sim, g, j, costs)
    # the port's own flags at its own optimum are the reference's at that optimum
    np.testing.assert_array_equal(pinned.numpy(), at_port["pinned"])


@pytest.fixture(scope="module")
def case():
    return build_case(BASE)


def test_the_generator_gives_the_references_bytes(case):
    spec, arr = case["spec"], case["arr"]
    X, y, _ = datagen.generate_batch(spec, arr, 2137, 0, torch.arange(SIMS, dtype=torch.int64),
                                     plain=True)
    np.testing.assert_allclose(X.numpy(), np.asarray(case["X"]), atol=4e-4)
    assert (y.numpy() != np.asarray(case["y"])).mean() < 2e-3


def test_the_replica_is_the_references_arm(case):
    """The replica that gives the reference's optimum is the reference's
    own slope GLMM arm: the same t^2, tau^2 and flags."""
    ref = case["ref"]
    want = jax.jit(jax.vmap(lambda a, b, c: ref_glmmfit.glmm_grid_stats(
        case["ref_spec"], case["ref_arr"], a, b, c)))(case["X"], case["y"], case["ids"])
    want = {k: np.asarray(v) for k, v in want.items()}
    t2 = waldstats.t2_targets(case["spec"], torch.as_tensor(ref["beta"]),
                              torch.as_tensor(ref["cov"])).numpy()
    np.testing.assert_array_equal(t2, want["t2"])
    np.testing.assert_array_equal(ref["tau2_hat"], want["tau2_hat"])
    np.testing.assert_array_equal(ref["converged"], want["converged"])
    np.testing.assert_array_equal(ref["pinned"].any(-1), want["boundary_hit"])
    np.testing.assert_array_equal(ref["pinned"] & ref["converged"][..., None],
                                  want["pinned_comp"])
    assert 0 < want["pinned_comp"][..., 1].sum() < want["pinned_comp"][..., 1].size


def test_the_fit_at_the_reference_theta(case):
    check_fit_at_reference_theta(case)


def test_the_search_against_the_reference(case):
    check_search(case, "logit q=2")


def test_the_arm_is_the_plain_fit(case):
    """glmm_grid_stats(plain=True) on a slope spec: K10's plain version,
    its per-component pins gated by convergence."""
    spec, arr = case["spec"], case["arr"]
    X, y = (torch.as_tensor(np.array(case[k])) for k in ("X", "y"))
    out = glmmfit.glmm_grid_stats(spec, arr, X, y, plain=True)
    beta, cov, conv, bnd, tau2, ybar, pinned, _ = glmmfit.glmm_slope_plain(*case["args"])
    np.testing.assert_array_equal(out["t2"].numpy(), waldstats.t2_targets(spec, beta, cov).numpy())
    np.testing.assert_array_equal(out["pinned_comp"].numpy(), (pinned & conv[..., None]).numpy())
    np.testing.assert_array_equal(out["singular"].numpy(), bnd.numpy())
    assert out["pinned_comp"].shape == (SIMS, len(GRID), 2)
