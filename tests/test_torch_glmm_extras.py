"""The port's GLMM with extra groupings (kernel K12's plain version,
``glmmfit.glmm_extras_plain``) against ``mcpower_tpu`` on the CPU, on the
reference's own bytes: the structured capacitance (every grouping
intercept-only), a logit design with a crossed grouping (6 primary clusters
crossed with 4 levels, M = 10), SIMS sims at one grid point, cut to N 96 so
that the reference's XLA:CPU programs compile in seconds (``XLA_FAST``).
Checks:

* the port's generator gives the reference's X and y (the extras' CLUSTER
  streams feed a binary and a count outcome's linear predictor) and its
  level ids bit for bit;
* :func:`reference_replica` is the reference's ``_extras_glmm_grid_stats.
  per_grid`` (:155-553) written out with the reference's own functions and
  the closure bodies of its ``_pirls_q1_arrs``, ``pirls``, ``pirls_loop32``,
  ``dev32_at`` and ``dev_beta`` copied, so that it returns its optimum theta
  beside its results, and fits at a given theta too; it is held to the
  reference's ``glmm_grid_stats``: tau^2 and the flags equal, t^2 within
  REPLICA_REL (XLA fuses the replica's fit, vmapped over two thetas, into
  another program: measured 2.1e-15 relative);
* the fit at the reference's theta (``glmm_extras_plain(theta=)``): beta,
  cov, tau^2, ybar and t^2 within FIT_REL (1e-8) (cov under the Hessian
  within HESSIAN_REL, 1e-5), and converged, boundary and each component's
  pin equal;
* the search: both rank candidates on f32 Laplace deviances from f32 PIRLS
  modes, whose sums round otherwise in XLA and torch, so a cell's two
  searches may stop at different simplex points; at each cell's two optima
  the reference's f64 Laplace deviance must agree within DEV_BAND, and a
  pin may differ only where the component's Cholesky diagonal is below
  FLAT_DIAG at one optimum (the deviance is flat there).

tests/test_torch_glmm_extras_nested.py runs a Poisson design with a nested
grouping, tests/test_torch_glmm_extras_dense.py the dense capacitance (a
slope on the primary grouping) and the Hessian, through the same checks but
the replica's against the reference's arm (its compile would take either file
past its time). Kernel K12
itself runs only on the card, where ``chip_smoke.py`` holds it against this
plain version bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mcpower_tpu.engine import datagen as ref_datagen
from mcpower_tpu.engine import glmmfit as ref_glmmfit
from mcpower_tpu.engine import lower as ref_lower
from mcpower_tpu.engine import mixedfit as ref_mixedfit
from mcpower_tpu.engine import optim as ref_optim
from mcpower_tpu.engine import smallchol as ref_sc
from mcpower_tpu.engine.glmfit import MU_EPS, _deviance, _link_funcs
from mcpower_tpu.engine.spec import ClusterStatic as RefCluster
from mcpower_tpu.engine.spec import ExtraGroupingStatic as RefExtra
from mcpower_tpu.engine.spec import SlopeStatic as RefSlope
from mcpower_tpu_torch.engine import datagen, glmmfit, lower, mixedfit, olsfit, waldstats
from mcpower_tpu_torch.engine.spec import ClusterStatic, ExtraGroupingStatic, SlopeStatic

SIMS = 8
FIT_REL = 1e-8
HESSIAN_REL = 1e-5
DEV_BAND = 1e-2
REPLICA_REL = 1e-12
FLAT_DIAG = 5e-2
THREADS = 2
# The reference's programs compile without LLVM's expensive passes: the same
# results here (measured: the same optimum, beta bit for bit), in a third of
# the compile (7.5 s against 22.7 s for the replica).
XLA_FAST = {"xla_llvm_disable_expensive_passes": True}
CROSSED = dict(grid=[96], outcome="binary", effects=[-0.3, 0.3, 0.2], k=2,
               primary=(6, 0.25, []), extras=[("crossed", 4, 0.15, [])], wald_se="rx")


@pytest.fixture(scope="module", autouse=True)
def _first_cpu_math_call():
    """Take the process's first multi-threaded call of torch's CPU log, exp,
    erf and sqrt before any comparison (it has been seen to return values
    ~1e-5 off in a loaded process), and run the plain fit on THREADS
    threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    x = torch.rand(1 << 20) + 0.5
    for t in (x, x.double()):
        torch.log(t), torch.log1p(t), torch.exp(t), torch.sqrt(t), torch.erf(t)
    yield
    torch.set_num_threads(threads)


def lowered(low, cluster_cls, extra_cls, slope_cls, d):
    m, tau2, slopes = d["primary"]

    def sl(spec):
        return tuple(slope_cls(design_col=c, variance=v, intercept_corr=r) for c, v, r in spec)

    k = d["k"]
    corr = np.eye(k) * 0.7 + 0.3
    return low.lower(
        grid=d["grid"], var_types=["normal"] * k, corr=corr, effects=np.asarray(d["effects"]),
        target_cols=list(range(1, k + 1)), outcome=d["outcome"], link=d.get("link", "canonical"),
        estimator="glm", wald_se=d["wald_se"], report_overall=True,
        cluster=cluster_cls("fixed_clusters", m, tau2, slopes=sl(slopes), extra_groupings=tuple(
            extra_cls(rel, lv, t2, slopes=sl(s)) for rel, lv, t2, s in d["extras"])))


def reference_replica(spec, arr, like_arm: bool = True):
    """The reference's ``_extras_glmm_grid_stats.per_grid`` for one sim,
    vmapped over the grid as the reference's arm is (``like_arm``; else at
    the one grid point, which takes a third less to trace, its f32 search
    rounding as XLA fuses that program): ``f(X, y, ids, theta (G, d))``
    returns its
    optimum ``theta`` and, stacked on a leading axis of 2, the f64 fit at
    that optimum and at the given theta: ``beta``, ``cov``, ``converged``,
    ``pinned``, ``tau2_hat``, ``ybar`` and the Laplace deviance ``lap``."""
    plan = ref_mixedfit._grouping_plan(spec)
    M = sum(n_lv * q for n_lv, q, _, _, _ in plan)
    sizes, theta0, lower_ = ref_mixedfit._theta_layout(plan)
    fit_cols = spec.effective_fit_cols
    pf = len(fit_cols)
    rows = jnp.arange(spec.max_n)
    mu_var_dmu = _link_funcs(spec.outcome, spec.link)
    eye_p = 1e-10 * jnp.eye(pf, dtype=jnp.float64)
    eye_M = jnp.eye(M, dtype=jnp.float64)
    q1 = plan[0][1]
    m1 = plan[0][0]
    all_q1 = ref_mixedfit._plan_all_q1(plan)
    if spec.scenario.truth_start:
        beta0 = arr["effects"].astype(jnp.float64)[jnp.asarray(fit_cols)]
    else:
        beta0 = jnp.zeros(pf, jnp.float64)
    v0 = jnp.zeros(M, jnp.float64)
    f32 = jnp.float32

    def per_grid(Xf, yf, Z, n, theta_in):
        mask = (rows < n).astype(jnp.float64)

        def q1_arrs(Xq, yq, Zq, maskq, eyepq):  # _pirls_q1_arrs (:216-298), copied
            dt = Xq.dtype

            def parts_of(lvec):
                l1 = lvec[0]
                dE = ref_mixedfit._extras_scale_q1(lvec, plan)
                return l1, dE, jnp.concatenate([jnp.full((m1,), l1, dt), dE])

            def step_quants(l1, dE, dfull, beta, v):
                eta = ref_sc.rowmv(Xq, beta) + Zq @ (dfull * v)
                mu, var, dmu = mu_var_dmu(eta)
                w = (dmu * dmu / jnp.maximum(var, MU_EPS)) * maskq
                wZ = Zq * w[:, None]
                G = Zq.T @ wZ
                fac = ref_mixedfit._cap_factor_q1(l1, dE, jnp.diagonal(G[:m1, :m1]),
                                                  G[:m1, m1:], G[m1:, m1:])
                return eta, mu, dmu, w, wZ, fac

            def loop(lvec, beta, v, iters):
                l1, dE, dfull = parts_of(lvec.astype(dt))

                def body(_, carry):
                    beta, v = carry
                    eta, mu, dmu, w, wZ, (a, Cpe, cholS) = step_quants(l1, dE, dfull, beta, v)
                    z = eta + (yq - mu) / dmu
                    At = dfull[:, None] * (wZ.T @ Xq)
                    bt = dfull * (wZ.T @ z)
                    xp, xe = ref_mixedfit._cap_solve_cols_q1(
                        a, Cpe, cholS, jnp.concatenate([bt[:m1, None], At[:m1]], axis=1),
                        jnp.concatenate([bt[m1:, None], At[m1:]], axis=1), pf + 1)
                    sol_b = jnp.concatenate([xp[..., 0], xe[..., 0]])
                    sol_A = jnp.concatenate([xp[..., 1:], xe[..., 1:]], axis=0)
                    a_xx = ref_sc.crossprod(Xq, w) - At.T @ sol_A + eyepq
                    a_xy = ref_sc.colsum(Xq, w * z) - At.T @ sol_b
                    beta_new = ref_sc.cho_solve(ref_sc.chol(a_xx), a_xy)
                    v_new = sol_b - sol_A @ beta_new
                    ok = jnp.all(jnp.isfinite(beta_new)) & jnp.all(jnp.isfinite(v_new))
                    return jnp.where(ok, beta_new, beta), jnp.where(ok, v_new, v)

                return jax.lax.fori_loop(0, iters, body, (beta, v))

            def mode(lvec, beta, v):
                l1, dE, dfull = parts_of(lvec.astype(dt))
                eta, mu, dmu, w, wZ, (a, Cpe, cholS) = step_quants(l1, dE, dfull, beta, v)
                lap = (_deviance(spec.outcome, yq, mu, maskq) + jnp.sum(v * v)
                       + ref_mixedfit._cap_logdet_q1(a, cholS))
                At = dfull[:, None] * (wZ.T @ Xq)
                xpA, xeA = ref_mixedfit._cap_solve_cols_q1(a, Cpe, cholS, At[:m1], At[m1:], pf)
                sol_A = jnp.concatenate([xpA, xeA], axis=0)
                return lap, ref_sc.crossprod(Xq, w) - At.T @ sol_A + eyepq

            return loop, mode

        def dense_loop(Lam, beta, v, iters, Xq, yq, Zq, maskq, eyepq):  # pirls / pirls_loop32
            eyeMq = jnp.eye(M, dtype=Xq.dtype)

            def body(_, carry):
                beta, v = carry
                eta = ref_sc.rowmv(Xq, beta) + Zq @ (Lam @ v)
                mu, var, dmu = mu_var_dmu(eta)
                w = (dmu * dmu / jnp.maximum(var, MU_EPS)) * maskq
                z = eta + (yq - mu) / dmu
                wZ = Zq * w[:, None]
                C = eyeMq + Lam.T @ (Zq.T @ wZ) @ Lam
                At = Lam.T @ (wZ.T @ Xq)
                bt = Lam.T @ (wZ.T @ z)
                cholC = ref_sc.chol_vec(C)
                sol = ref_sc.cho_solve_mat_vec(cholC, jnp.concatenate([bt[:, None], At], axis=-1))
                sol_b, sol_A = sol[..., 0], sol[..., 1:]
                a_xx = ref_sc.crossprod(Xq, w) - At.T @ sol_A + eyepq
                a_xy = ref_sc.colsum(Xq, w * z) - At.T @ sol_b
                beta_new = ref_sc.cho_solve(ref_sc.chol(a_xx), a_xy)
                v_new = sol_b - sol_A @ beta_new
                ok = jnp.all(jnp.isfinite(beta_new)) & jnp.all(jnp.isfinite(v_new))
                return jnp.where(ok, beta_new, beta), jnp.where(ok, v_new, v)

            return jax.lax.fori_loop(0, iters, body, (beta, v))

        def dense_mode(Lam, beta, v, Xq, yq, Zq, maskq, eyepq, want_schur=True):
            eta = ref_sc.rowmv(Xq, beta) + Zq @ (Lam @ v)
            mu, var, dmu = mu_var_dmu(eta)
            w = (dmu * dmu / jnp.maximum(var, MU_EPS)) * maskq
            wZ = Zq * w[:, None]
            C = jnp.eye(M, dtype=Xq.dtype) + Lam.T @ (Zq.T @ wZ) @ Lam
            cholC = ref_sc.chol_vec(C)
            lap = (_deviance(spec.outcome, yq, mu, maskq) + jnp.sum(v * v)
                   + ref_sc.logdet_from_chol(cholC))
            if not want_schur:
                return lap, None
            At = Lam.T @ (wZ.T @ Xq)
            sol_A = ref_sc.cho_solve_mat_vec(cholC, At)
            return lap, ref_sc.crossprod(Xq, w) - At.T @ sol_A + eyepq

        Xf32, yf32, Z32, mask32 = Xf.astype(f32), yf.astype(f32), Z.astype(f32), mask.astype(f32)
        eye_p32 = 1e-6 * jnp.eye(pf, dtype=f32)
        if all_q1:
            loop64, mode64 = q1_arrs(Xf, yf, Z, mask, eye_p)
            loop32, mode32 = q1_arrs(Xf32, yf32, Z32, mask32, eye_p32)

            def search_eval(theta, carry, iters):
                th = theta.astype(f32)
                beta32, v32 = loop32(th, carry[0], carry[1], iters)
                lap = mode32(th, beta32, v32)[0].astype(jnp.float64)
                return jnp.where(jnp.isfinite(lap), lap, jnp.float64(1e30)), (beta32, v32)
        else:
            def search_eval(theta, carry, iters):
                Lam32 = ref_mixedfit._lam_all(theta, plan, sizes, M).astype(f32)
                beta32, v32 = dense_loop(Lam32, carry[0], carry[1], iters, Xf32, yf32, Z32,
                                         mask32, eye_p32)
                lap = dense_mode(Lam32, beta32, v32, Xf32, yf32, Z32, mask32, eye_p32,
                                 False)[0].astype(jnp.float64)
                return jnp.where(jnp.isfinite(lap), lap, jnp.float64(1e30)), (beta32, v32)

        nm_total = 30 if int(theta0.shape[0]) <= 3 else ref_glmmfit.NM_ITERS_GLMM
        theta_hat, _, _ = ref_optim.nelder_mead_carry(
            search_eval, theta0, (beta0.astype(f32), v0.astype(f32)),
            phases=((ref_glmmfit.NM_FULL_SLOPE, ref_glmmfit.N_PIRLS_SLOPE),
                    (nm_total - ref_glmmfit.NM_FULL_SLOPE, ref_glmmfit.N_PIRLS_SLOPE_WARM)),
            init_step=0.2, lower=lower_, dynamic_budget=True)

        def fit(theta):
            Lam = ref_mixedfit._lam_all(theta, plan, sizes, M)
            if all_q1:
                beta, v = loop64(theta, beta0, v0, ref_glmmfit.N_PIRLS)
                lap, a_xx = mode64(theta, beta, v)
            else:
                beta, v = dense_loop(Lam, beta0, v0, ref_glmmfit.N_PIRLS, Xf, yf, Z, mask, eye_p)
                lap, a_xx = dense_mode(Lam, beta, v, Xf, yf, Z, mask, eye_p)
            cholP = ref_sc.chol(a_xx)
            cov = ref_sc.cho_inverse(cholP)
            if spec.wald_se == "hessian":  # dev_beta (:486-517), copied
                def dev_beta(beta_q):
                    fixed = ref_sc.rowmv(Xf, beta_q)

                    def vbody(_, v_q):
                        eta = fixed + Z @ (Lam @ v_q)
                        mu, var, dmu = mu_var_dmu(eta)
                        w = (dmu * dmu / jnp.maximum(var, MU_EPS)) * mask
                        z = eta + (yf - mu) / dmu
                        wZ = Z * w[:, None]
                        C = eye_M + Lam.T @ (Z.T @ wZ) @ Lam
                        rhs = Lam.T @ (wZ.T @ (z - fixed))
                        v_new = ref_sc.cho_solve_vec(ref_sc.chol_vec(C), rhs)
                        return jnp.where(jnp.all(jnp.isfinite(v_new)), v_new, v_q)

                    v_q = jax.lax.fori_loop(0, 20, vbody, v)
                    eta = fixed + Z @ (Lam @ v_q)
                    mu, var, dmu = mu_var_dmu(eta)
                    w = (dmu * dmu / jnp.maximum(var, MU_EPS)) * mask
                    wZ = Z * w[:, None]
                    C = eye_M + Lam.T @ (Z.T @ wZ) @ Lam
                    return (_deviance(spec.outcome, yf, mu, mask) + jnp.sum(v_q * v_q)
                            + ref_sc.logdet_from_chol(ref_sc.chol_vec(C)))

                cov = ref_glmmfit._fd_hessian_cov(dev_beta, beta, cov)
            Lg1 = ref_mixedfit._vech_to_lower(theta[: sizes[0]], q1)
            diag, off = [], 0
            for (_, q, _, _, _), sz in zip(plan, sizes):
                diag.append(jnp.diagonal(ref_mixedfit._vech_to_lower(theta[off:off + sz], q)))
                off += sz
            converged = (jnp.all(jnp.isfinite(beta)) & ref_sc.chol_ok(cholP)
                         & ref_sc.rank_ok(a_xx - eye_p) & jnp.isfinite(lap))
            ybar = jnp.sum(yf * (rows < n)) / jnp.asarray(n, jnp.float64)
            return dict(beta=beta, cov=cov, converged=converged,
                        pinned=jnp.concatenate(diag) < 1e-3, tau2_hat=(Lg1 @ Lg1.T)[0, 0],
                        ybar=ybar, lap=lap)

        fits = jax.vmap(fit)(jnp.stack([theta_hat, theta_in]))
        return dict(fits, theta=theta_hat)

    ns = jnp.asarray(spec.grid, jnp.int32)

    def one_sim(X, y, ids, theta):
        Xf = X[:, jnp.asarray(fit_cols)].astype(jnp.float64)
        Z = ref_mixedfit._build_joint_z(spec, X, ids)
        if like_arm:  # the arm's vmap over the grid, so that XLA rounds as in the arm
            return jax.vmap(lambda n, th: per_grid(Xf, y.astype(jnp.float64), Z, n, th))(
                ns, theta)
        out = per_grid(Xf, y.astype(jnp.float64), Z, ns[0], theta[0])
        return jax.tree_util.tree_map(lambda a: a[None], out)

    return jax.jit(jax.vmap(one_sim))


def build_case(d, with_arm=True):
    """Both packages' specs, the reference's bytes and outputs, and the
    port's arguments of ``glmm_extras_plain``."""
    rs, ra = lowered(ref_lower, RefCluster, RefExtra, RefSlope, d)
    spec, arr = lowered(lower, ClusterStatic, ExtraGroupingStatic, SlopeStatic, d)
    X, y, ids = ref_datagen.generate_batch(rs, ra, jnp.uint32(2137), jnp.uint32(0),
                                           jnp.arange(SIMS, dtype=jnp.uint32))
    d_theta = int(mixedfit.theta_layout(mixedfit.grouping_plan(spec))[1].shape[0])
    G = len(spec.grid)
    theta0 = jnp.asarray(np.broadcast_to(mixedfit.theta_layout(mixedfit.grouping_plan(spec))[1],
                                         (SIMS, G, d_theta)))
    replica = reference_replica(rs, ra, with_arm).lower(X, y, ids, theta0).compile(
        compiler_options=XLA_FAST)

    def at(theta):
        return {k: np.asarray(v) for k, v in replica(X, y, ids, jnp.asarray(theta)).items()}

    ref = at(theta0)
    case = dict(spec=spec, arr=datagen.to_device(arr, "cpu"), ref_spec=rs, ref_arr=ra, X=X, y=y,
                ids=ids, ref=ref, at=at)
    if with_arm:
        arm = jax.jit(jax.vmap(lambda a, b, c: ref_glmmfit.glmm_grid_stats(rs, ra, a, b, c)))
        want = arm.lower(X, y, ids).compile(compiler_options=XLA_FAST)(X, y, ids)
        case["arm"] = {k: np.asarray(v) for k, v in want.items()}
    Xt, yt = torch.as_tensor(np.array(X)), torch.as_tensor(np.array(y))
    case["args"] = chip_smoke.k12_args(spec, case["arr"], Xt, yt)
    return case


def check_replica(case):
    """The replica that gives the reference's optimum is the reference's
    own arm: the same t^2, tau^2 and flags."""
    ref, want, spec = case["ref"], case["arm"], case["spec"]
    t2 = waldstats.t2_targets(spec, torch.as_tensor(ref["beta"][:, :, 0]),
                              torch.as_tensor(ref["cov"][:, :, 0])).numpy()
    # the same search (tau^2 equal), its fit in another XLA program: t^2 to rounding
    np.testing.assert_allclose(t2, want["t2"], rtol=REPLICA_REL)
    np.testing.assert_array_equal(ref["tau2_hat"][:, :, 0], want["tau2_hat"])
    np.testing.assert_array_equal(ref["converged"][:, :, 0], want["converged"])
    np.testing.assert_array_equal(ref["pinned"][:, :, 0].any(-1), want["boundary_hit"])
    np.testing.assert_array_equal(ref["pinned"][:, :, 0] & ref["converged"][:, :, 0, None],
                                  want["pinned_comp"])
    np.testing.assert_array_equal(ref["ybar"][:, :, 0], want["glm_baseline"])


def check_fit_at_reference_theta(case, cov_rel=FIT_REL):
    spec, ref = case["spec"], case["ref"]
    beta, cov, conv, bnd, tau2, ybar, pinned, theta = glmmfit.glmm_extras_plain(
        *case["args"], theta=torch.as_tensor(ref["theta"]))
    r = {k: v[:, :, 0] for k, v in ref.items() if k != "theta"}
    np.testing.assert_array_equal(theta.numpy(), ref["theta"])
    np.testing.assert_array_equal(conv.numpy(), r["converged"])
    np.testing.assert_array_equal(pinned.numpy(), r["pinned"])
    np.testing.assert_array_equal(bnd.numpy(), r["pinned"].any(-1))
    t2_ref = waldstats.t2_targets(spec, torch.as_tensor(r["beta"]), torch.as_tensor(r["cov"]))
    for name, g, w, rel in (("beta", beta, r["beta"], FIT_REL), ("cov", cov, r["cov"], cov_rel),
                            ("tau2", tau2, r["tau2_hat"], FIT_REL),
                            ("t2", waldstats.t2_targets(spec, beta, cov), t2_ref.numpy(), cov_rel),
                            ("ybar", ybar, r["ybar"], FIT_REL)):
        g = g.numpy()
        assert np.abs(g - w).max() <= rel * np.abs(w).max(), (name, np.abs(g - w).max())
    return pinned


def plain_fit(case):
    """``glmm_extras_plain`` on the case's arguments, run once a case."""
    if "plain" not in case:
        case["plain"] = glmmfit.glmm_extras_plain(*case["args"])
    return case["plain"]


def check_search(case, name):
    """The port's optimum against the reference's, judged by the
    reference's own f64 Laplace deviance at each."""
    ref = case["ref"]
    *_, pinned, theta = plain_fit(case)
    at_port = case["at"](theta.numpy())
    d_port, d_ref = at_port["lap"][:, :, 1], ref["lap"][:, :, 0]
    gap = np.abs(d_port - d_ref)
    print(f"{name}: port - reference f64 deviance at the two optima, extremes "
          f"{np.sort((d_port - d_ref).ravel())[[0, -1]]}; "
          f"{int((theta.numpy() != ref['theta']).any(-1).sum())} of {gap.size} cells end at "
          f"another theta; pins per component port {pinned.numpy().sum((0, 1))}, reference "
          f"{ref['pinned'][:, :, 0].sum((0, 1))}")
    assert gap.max() <= DEV_BAND, gap.max()
    plan = mixedfit.grouping_plan(case["spec"])
    diag, off = [], 0
    for _, q, _, _, _ in plan:
        diag += [off + k for k in mixedfit.vech_diagonal(q)]
        off += q * (q + 1) // 2
    th_ref = ref["theta"]
    for sim, g, j in np.argwhere(pinned.numpy() != ref["pinned"][:, :, 0]):
        assert min(theta.numpy()[sim, g, diag[j]], th_ref[sim, g, diag[j]]) <= FLAT_DIAG
    # the port's own flags at its own optimum are the reference's there
    np.testing.assert_array_equal(pinned.numpy(), at_port["pinned"][:, :, 1])


def check_generation(case):
    """X and y from the port's generator against the reference's (X within
    the standing f32 band of the reference's FMA-contracted normals, ROADMAP
    C; y a flip where such a normal moves an outcome across its threshold)
    and the level ids bit for bit."""
    spec, arr = case["spec"], case["arr"]
    X, y, _ = datagen.generate_batch(spec, arr, 2137, 0, torch.arange(SIMS, dtype=torch.int64),
                                     plain=True)
    np.testing.assert_allclose(X.numpy(), np.asarray(case["X"]), atol=4e-4)
    assert (y.numpy() != np.asarray(case["y"])).mean() < 2e-3
    groups, _ = olsfit.joint_layout(spec)
    np.testing.assert_array_equal(groups[0][0].numpy(), np.asarray(case["ids"])[0])
    for g in range(len(groups) - 1):
        ref_ids, ref_m = ref_datagen.extra_grouping_ids(case["ref_spec"], g)
        np.testing.assert_array_equal(groups[g + 1][0].numpy(), np.asarray(ref_ids))
        assert groups[g + 1][1] == ref_m


@pytest.fixture(scope="module")
def case():
    return build_case(CROSSED)


def test_the_generator_gives_the_references_bytes(case):
    check_generation(case)


def test_the_replica_is_the_references_arm(case):
    check_replica(case)


def test_the_fit_at_the_reference_theta(case):
    assert mixedfit.plan_all_q1(mixedfit.grouping_plan(case["spec"]))
    check_fit_at_reference_theta(case)


def test_the_search_against_the_reference(case):
    check_search(case, "structured")


def test_the_arm_is_the_plain_fit(case):
    """glmm_grid_stats(plain=True) on an extras spec: K12's plain version,
    its per-component pins gated by convergence."""
    spec, arr = case["spec"], case["arr"]
    X, y = case["args"][1], case["args"][2]
    out = glmmfit.glmm_grid_stats(spec, arr, X, y, plain=True)
    beta, cov, conv, bnd, tau2, ybar, pinned, _ = plain_fit(case)
    np.testing.assert_array_equal(out["t2"].numpy(), waldstats.t2_targets(spec, beta, cov).numpy())
    np.testing.assert_array_equal(out["pinned_comp"].numpy(), (pinned & conv[..., None]).numpy())
    np.testing.assert_array_equal(out["tau2_hat"].numpy(), tau2.numpy())
    np.testing.assert_array_equal(out["glm_baseline"].numpy(), ybar.numpy())
    comps = sum(q for _, q, _, _, _ in mixedfit.grouping_plan(spec))
    assert out["pinned_comp"].shape == (SIMS, len(spec.grid), comps)
