"""The port's random-intercept GLMM (kernel K7's plain version) against
``mcpower_tpu`` on the CPU, on the reference's own bytes.

X, y and the cluster ids come from the reference's ``generate_batch`` (32
sims, a two-point grid, 12 clusters); each design goes through the
reference's ``glmm_grid_stats`` (vmapped over sims, as ``run_batch_capture``
runs it) and through ``glmmfit.glmm_grid_stats(plain=True)``. Designs here:
logit, probit, Poisson and a tau^2 = 0.02 design whose cells hit the
boundary; tests/test_torch_glmm_agq.py runs AGQ at 7 nodes, the FD Hessian
covariance, the blocked layout and the cold start of ``truth_start=False``
through the same checks.

Two parts are held apart:

* the fit at a given tau^2 (the f64 PIRLS, the Schur or Hessian covariance,
  t^2 and the Wald omnibus, the pins): the port fitted at the reference's
  own optimum must give the reference's t^2 and overall to 1e-8 relative
  (1e-5 under the Hessian, whose central differences divide rounding by
  h^2 = 1e-8), and the same flags;
* the search: the reference positions log tau^2 by 14 Brent steps on a
  deviance read off f32 PIRLS modes, which resolves the deviance to ~2e-6
  (the f32 mode's rounding) and so tau^2 only to where the deviance is
  that flat. The port's f32 arithmetic rounds differently (its exp, its
  sums), so its steps part from the reference's once two deviances differ
  by less than that. Each cell's tau^2 must lie within rtol 1e-3 and atol
  1e-5 of the reference's, or, where it does not, the f64 objective at the
  two optima must agree to DEV_RES: the two searches stopped at points the
  objective cannot tell apart. Those cells are counted and printed.

Flags (``converged``, ``boundary_hit``, ``pinned_comp``) are equal in every
cell. Kernel K7 itself runs only on the card, where ``chip_smoke.py`` holds
it against this plain version bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpower_tpu.engine import datagen as ref_datagen
from mcpower_tpu.engine import glmmfit as ref_glmmfit
from mcpower_tpu.engine import lower as ref_lower
from mcpower_tpu.engine.spec import ClusterStatic as RefCluster
from mcpower_tpu.engine.spec import ScenarioStatic as RefScenario
from mcpower_tpu_torch.engine import batch, datagen, glmfit, glmmfit, lower, waldstats
from mcpower_tpu_torch.engine.spec import (
    ClusterStatic,
    ExtraGroupingStatic,
    ScenarioStatic,
    SlopeStatic,
)

SIMS = 32
GRID = [48, 96]
BASE = dict(outcome="binary", link="canonical", effects=[-0.3, 0.4, 0.25], tau2=0.25,
            mode="fixed_clusters", value=12, nagq=1, wald_se="rx", truth_start=True)
# This file's designs; tests/test_torch_glmm_agq.py runs the others through
# the same checks (one reference compile each, so each file stays short).
ALL_DESIGNS = {
    "logit": {},
    "probit": dict(link="probit", effects=[-0.2, 0.3, 0.2]),
    "poisson": dict(outcome="count", effects=[0.5, 0.2, 0.1], tau2=0.2),
    "boundary": dict(tau2=0.02),
    "agq7": dict(nagq=7),
    "hessian": dict(wald_se="hessian"),
    "blocked": dict(mode="fixed_size", value=8),
    "cold_start": dict(truth_start=False),
}
DESIGNS = ["logit", "probit", "poisson", "boundary"]
TAU2_RTOL, TAU2_ATOL = 1e-3, 1e-5
# The search's deviance resolution: the f64 deviance read off an f32 mode
# (and under AGQ its f32 node deltas) against the f64 mode's, measured up to
# 2.2e-6 on these designs; the objective at the port's and the reference's
# optima differed by at most 8.2e-7 where tau^2 left the band.
DEV_RES = 2e-6
T2_REL = {"hessian": 1e-5}
T2_REL_FIT = 1e-8


THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def _first_cpu_math_call():
    """Take the process's first multi-threaded call of torch's CPU log,
    log1p and exp before any comparison: that call has been seen, in a
    loaded process, to return values ~1e-5 off on part of a tensor. The
    plain GLMM is many small operations: run them on THREADS threads, so
    that parallel test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    x = torch.rand(1 << 20) + 0.5
    for t in (x, x.double()):
        torch.log(t), torch.log1p(t), torch.exp(t), torch.sqrt(t), torch.erf(t)
    yield
    torch.set_num_threads(threads)


def _kw(name):
    d = dict(BASE, **ALL_DESIGNS[name])
    return d, dict(grid=GRID, var_types=["normal", "normal"], effects=np.asarray(d["effects"]),
                   target_cols=[1, 2], outcome=d["outcome"], link=d["link"], estimator="glm",
                   nagq=d["nagq"], wald_se=d["wald_se"], report_overall=True)


def build_runs(names):
    """Per design: the port's spec, arrays, X, y and both packages' outputs."""
    out = {}
    for name in names:
        d, kw = _kw(name)
        ref_spec, ref_arr = ref_lower.lower(
            **kw, cluster=RefCluster(sizing_mode=d["mode"], sizing_value=d["value"],
                                     tau_squared=d["tau2"]),
            scenario=RefScenario(truth_start=d["truth_start"]))
        spec, arr = lower.lower(
            **kw, cluster=ClusterStatic(sizing_mode=d["mode"], sizing_value=d["value"],
                                        tau_squared=d["tau2"]),
            scenario=ScenarioStatic(truth_start=d["truth_start"]))
        X, y, ids = ref_datagen.generate_batch(ref_spec, ref_arr, 2137, 0,
                                               jnp.arange(SIMS, dtype=jnp.uint32))
        want = jax.jit(jax.vmap(
            lambda a, b, c: ref_glmmfit.glmm_grid_stats(ref_spec, ref_arr, a, b, c)))(X, y, ids)
        arr = datagen.to_device(arr, "cpu")
        Xt, yt = torch.as_tensor(np.array(X)), torch.as_tensor(np.array(y))
        got = glmmfit.glmm_grid_stats(spec, arr, Xt, yt, plain=True)
        out[name] = (spec, arr, Xt, yt, {k: v.numpy() for k, v in got.items()},
                     {k: np.asarray(v) for k, v in want.items()})
    return out


@pytest.fixture(scope="module")
def runs():
    return build_runs(DESIGNS)


def _args(spec, arr, X, y):
    fit = list(spec.effective_fit_cols)
    beta0 = (arr["effects"].to(torch.float64)[fit] if spec.scenario.truth_start
             else torch.zeros(len(fit), dtype=torch.float64))
    return (glmfit.link_code(spec.outcome, spec.link), X, y, fit, spec.grid,
            glmmfit.layout_of(spec), beta0, max(int(spec.nagq), 1), spec.wald_se == "hessian")


def _objective(spec, arr, X, y, log_tau2):
    """The f64 objective (Laplace, or AGQ at the spec's nodes) of every cell
    at ``log_tau2 (sims, G)``, at a mode converged by 40 f64 PIRLS steps."""
    code, X, y, fit, grid, layout, _, nagq, _ = _args(spec, arr, X, y)
    cells = glmmfit._Cells(code, X, y, fit, grid, layout)
    tau2 = torch.exp(log_tau2)
    beta = torch.zeros(tuple(log_tau2.shape) + (len(fit),), dtype=torch.float64)
    u = torch.zeros(tuple(log_tau2.shape) + (cells.m,), dtype=torch.float64)
    beta, u, W, lap = glmmfit._pirls(cells, torch.float64, tau2, beta, u, 40)
    if nagq > 1:
        x, lw, _, _ = glmmfit.gh_nodes(nagq)
        lap = glmmfit._agq_deviance(cells, (torch.as_tensor(x), torch.as_tensor(lw)), tau2, beta,
                                    u, W)
    return lap.numpy()


def check_fit(run, name):
    """The port fitted at the reference's optimum: the reference's t^2,
    overall, outcome mean and flags."""
    spec, arr, X, y, got, want = run
    tw = want["tau2_hat"]
    log_tau2 = torch.as_tensor(np.log(np.where(tw > 0, tw, 1.0)))
    beta, cov, conv, bnd, _, ybar = glmmfit.glmm_intercept_plain(*_args(spec, arr, X, y),
                                                                 log_tau2=log_tau2)
    np.testing.assert_array_equal(bnd.numpy(), want["boundary_hit"])
    np.testing.assert_array_equal(conv.numpy(), want["converged"])
    band = T2_REL.get(name, T2_REL_FIT)
    t2 = waldstats.t2_targets(spec, beta, cov).numpy()
    np.testing.assert_allclose(t2, want["t2"], rtol=band)
    overall = waldstats.overall_wald_chi2(spec, beta, cov).numpy()
    np.testing.assert_allclose(overall, want["overall"], rtol=band)
    np.testing.assert_allclose(ybar.numpy(), want["glm_baseline"], rtol=1e-14)


def check_flags(run, name):
    _, _, _, _, got, want = run
    for key in ("converged", "boundary_hit", "singular", "pinned_comp"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    if name == "boundary":
        assert want["boundary_hit"].mean() > 0.5
    assert sorted(got) == sorted(want)


def check_search(run, name):
    """tau^2 within the band, or at a point the objective cannot tell from
    the reference's."""
    spec, arr, X, y, got, want = run
    tg, tw = got["tau2_hat"], want["tau2_hat"]
    out = np.abs(tg - tw) > TAU2_ATOL + TAU2_RTOL * np.abs(tw)
    t2_rel = np.abs(got["t2"] - want["t2"]) / np.abs(want["t2"])
    print(f"{name}: tau^2 max rel diff {np.max(np.abs(tg - tw) / np.maximum(tw, 1e-12)):.2e}, "
          f"t^2 {t2_rel.max():.2e} (the search's resolution; at the reference's optimum the "
          f"fit test holds t^2 to {T2_REL.get(name, T2_REL_FIT)})")
    if out.any():
        assert ((tg > 0) & (tw > 0))[out].all()  # a pin decides both the same way
        lt = lambda t: torch.as_tensor(np.log(np.where(out, t, 1.0)))  # noqa: E731
        gap = np.abs(_objective(spec, arr, X, y, lt(tg)) - _objective(spec, arr, X, y, lt(tw)))[out]
        print(f"{name}: {int(out.sum())} of {out.size} cells outside the tau^2 band, their "
              f"objectives {gap.max():.2e} apart at most (tau^2 {tg[out][:4]} against the "
              f"reference's {tw[out][:4]})")
        assert gap.max() < DEV_RES


@pytest.mark.parametrize("name", DESIGNS)
def test_the_fit_at_the_reference_optimum_is_the_references(runs, name):
    check_fit(runs[name], name)


@pytest.mark.parametrize("name", DESIGNS)
def test_the_flags_are_the_references(runs, name):
    check_flags(runs[name], name)


@pytest.mark.parametrize("name", DESIGNS)
def test_the_search_finds_the_references_optimum(runs, name):
    check_search(runs[name], name)


def test_hessian_offsets_are_the_references_stencil():
    offs = glmmfit.hessian_offsets(3)
    assert offs.shape == (1 + 2 * 3 + 4 * 3, 3)
    assert (offs[0] == 0).all() and (offs[1] == [1, 0, 0]).all() and (offs[2] == [-1, 0, 0]).all()
    assert (offs[7] == [1, 1, 0]).all() and (offs[10] == [-1, -1, 0]).all()
    assert (offs[-1] == [0, -1, -1]).all()


# Random-intercept GLMMs, GLMMs with up to three slopes and GLMMs with extra
# groupings run; more slopes (kernel K10's q <= 4), extra groupings past
# K12's joint Z of M <= 128 (20 + 110 columns) and K7's limits raise before
# any run.
_GLMM = dict(grid=[100], var_types=["normal"], effects=np.array([-0.3, 0.3]), target_cols=[1],
             outcome="binary", estimator="glm")
GATED = {
    "slopes": (dict(_GLMM, var_types=["normal"] * 4, effects=np.array([-0.3, 0.3, 0.2, 0.1, 0.1]),
                    target_cols=[1, 2, 3, 4],
                    cluster=ClusterStatic("fixed_clusters", 20, 0.25, slopes=tuple(
                        SlopeStatic(c, 0.1, 0.0) for c in range(1, 5)))), "K10 takes q <= 4"),
    "crossed": (dict(_GLMM, cluster=ClusterStatic(
        "fixed_clusters", 20, 0.25, extra_groupings=(ExtraGroupingStatic("crossed", 110, 0.15),))),
        "K12 takes M <= 128"),
    "nodes": (dict(_GLMM, nagq=27, cluster=ClusterStatic("fixed_clusters", 20, 0.25)),
              "K7 takes 1..25 nodes"),
    "clusters": (dict(_GLMM, grid=[2050], cluster=ClusterStatic("fixed_clusters", 1025, 0.25)),
                 "K7 takes at most 1024"),
    "width": (dict(_GLMM, var_types=["normal"] * 16, effects=np.full(17, 0.1),
                   cluster=ClusterStatic("fixed_clusters", 20, 0.25)), "B10"),
}


@pytest.mark.parametrize("name", sorted(GATED))
def test_glmm_designs_outside_the_port_raise_before_any_run(monkeypatch, name):
    kw, item = GATED[name]
    spec, arr = lower.lower(**kw)
    calls = []
    monkeypatch.setattr(batch, "run_sims", lambda *a, **k: calls.append(1))
    with pytest.raises(NotImplementedError, match=item):
        batch.run_batch(spec, arr, 8, 1, device="cpu")
    assert calls == []


def test_the_wrapper_takes_the_plain_version_only_on_the_cpu():
    X = torch.zeros((2, 40, 2), device="meta")
    y = torch.zeros((2, 40), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        glmmfit.glmm_intercept(0, X, y, [0, 1], [40], (True, 20, 20),
                               torch.zeros(2, dtype=torch.float64))
