"""The port's random-slope LMM at p = 14 against ``mcpower_tpu`` on the CPU:
13 normal predictors and the intercept, inside the reference's vectorised
Cholesky range (``smallchol.VEC_FROM_P`` = 13), where the reference factors
X'V^-1X by rows and the port by its scalar unroll (ROADMAP C2). Both
packages get the same bytes, made with numpy from a seed (16 round-robin
clusters, a random intercept and a slope on x1, tau^2 0.3, slope variance
0.2, corr 0.3): the reference's own generator would add a compile this
file's time budget has no room for. The checks and bands are
tests/test_torch_slopes_fit.py's: the statistics and the fit at the
reference's own theta (beta, cov, tau^2 and t^2 within 1e-8, every flag
equal). The search's band is held at p = 2 and 3 there; here its f64
deviance check would add a second p = 14 compile (measured once: the two
optima within 9.5e-5, the same pins)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpower_tpu.engine import lower as ref_lower
from mcpower_tpu.engine import mixedfit as ref_mixedfit
from mcpower_tpu.engine.spec import ClusterStatic as RefCluster
from mcpower_tpu.engine.spec import SlopeStatic as RefSlope
from mcpower_tpu_torch.engine import lower, mixedfit, olsfit
from mcpower_tpu_torch.engine.spec import ClusterStatic, SlopeStatic

from test_torch_slopes_fit import SUFF_REL, THREADS, check_fit_at_reference_theta, reference_fit

SIMS = 8
N = 240
M = 16
P = 14
TAU2, SLOPE_VAR, CORR = 0.3, 0.2, 0.3
EFFECTS = [0.0, 0.3, -0.25, 0.2, 0.2, -0.15, 0.15, 0.1, -0.1, 0.1, 0.05, -0.05, 0.05, 0.0]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    x = torch.rand(1 << 20) + 0.5
    for t in (x, x.double()):
        torch.log(t), torch.sqrt(t)
    yield
    torch.set_num_threads(threads)


def _lowered(low, cluster_cls, slope_cls):
    return low.lower(grid=[N], var_types=["normal"] * (P - 1), effects=np.asarray(EFFECTS),
                     target_cols=list(range(1, P)), estimator="mle",
                     cluster=cluster_cls("fixed_clusters", M, TAU2, slopes=(
                         slope_cls(design_col=1, variance=SLOPE_VAR, intercept_corr=CORR),)))


def _rows(seed: int = 2137):
    """f32 X (SIMS, N, P) with the intercept, y and the cluster ids."""
    rs = np.random.RandomState(seed)
    X = rs.standard_normal((SIMS, N, P)).astype(np.float32)
    X[..., 0] = 1.0
    ids = np.broadcast_to(np.arange(N) % M, (SIMS, N)).astype(np.int32)
    D = np.array([[TAU2, CORR * np.sqrt(TAU2 * SLOPE_VAR)],
                  [CORR * np.sqrt(TAU2 * SLOPE_VAR), SLOPE_VAR]])
    u = rs.standard_normal((SIMS, M, 2)) @ np.linalg.cholesky(D).T
    rows = np.arange(SIMS)[:, None]
    y = (X.astype(np.float64) @ np.asarray(EFFECTS) + u[rows, ids, 0]
         + u[rows, ids, 1] * X[..., 1] + rs.standard_normal((SIMS, N)))
    return X, y.astype(np.float32), ids


@pytest.fixture(scope="module")
def case():
    ref_spec, _ = _lowered(ref_lower, RefCluster, RefSlope)
    spec, _ = _lowered(lower, ClusterStatic, SlopeStatic)
    assert len(spec.effective_fit_cols) == P
    X, y, ids = _rows()
    Xj = jnp.asarray(X)

    def ref_suff(X1, y1, ids1):
        Zf = jnp.concatenate([jnp.ones((N, 1)), X1[:, 1:2].astype(jnp.float64)], axis=1)
        return ref_mixedfit._slope_cluster_suffstats(
            ref_spec, X1.astype(jnp.float64), y1.astype(jnp.float64), ids1, M, 2, Zf)

    ss = jax.jit(jax.vmap(ref_suff))(Xj, jnp.asarray(y), jnp.asarray(ids))
    theta0, lower_ = mixedfit.slope_start(spec)
    return dict(spec=spec, ss={k: np.asarray(v) for k, v in ss.items()},
                ref=reference_fit(ref_spec, ss, theta0, lower_), theta0=theta0, lower=lower_,
                suff=olsfit.grid_suffstats(spec, torch.as_tensor(X), torch.as_tensor(y),
                                           with_slopes=True))


def test_slope_statistics_at_p14(case):
    for k in ("G", "A", "b", "xtx", "xty", "yty"):
        g, w = case["suff"][k].numpy(), case["ss"][k]
        assert g.shape == w.shape and np.abs(g - w).max() <= SUFF_REL * np.abs(w).max(), k


def test_fit_at_the_reference_theta_at_p14(case):
    pinned = check_fit_at_reference_theta(case["spec"], case["suff"], case["ref"],
                                          case["theta0"], case["lower"])
    assert case["ref"]["converged"].all()
    print(f"p14: pins per component {pinned.numpy().sum((0, 1))}")
