"""The port's random-intercept GLMM at p = 14 against ``mcpower_tpu`` on the
CPU: 13 normal predictors and the intercept,
inside the reference's vectorised Cholesky range (``smallchol.VEC_FROM_P``
= 13), where the reference factors by rows and the port by its scalar
unroll (ROADMAP C2). Both packages get the same bytes, made with numpy
from a seed (a logit GLMM with 16 round-robin clusters, tau^2 0.25): the
reference's own generator would add a compile that this file's time
budget has no room for. The checks and their bands are
tests/test_torch_glmm.py's: the fit at the reference's optimum, every flag,
and the search's tau^2 within the band or at an objective the two optima
cannot tell apart. Kernel K7 itself runs only on the card, where
``chip_smoke.py``'s ``glmm_p16`` case holds it against the plain version
bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpower_tpu.engine import glmmfit as ref_glmmfit
from mcpower_tpu.engine import lower as ref_lower
from mcpower_tpu.engine import smallchol as ref_smallchol
from mcpower_tpu.engine.spec import ClusterStatic as RefCluster
from mcpower_tpu_torch.engine import datagen, glmmfit, lower
from mcpower_tpu_torch.engine.spec import ClusterStatic

from test_torch_glmm import check_fit, check_flags, check_search

SIMS = 8
N = 240
GRID = [N]
P = 14
THREADS = 2
KW = dict(grid=GRID, var_types=["normal"] * (P - 1),
          effects=np.asarray([-0.3, 0.35, -0.3, 0.25, 0.2, -0.2, 0.15, 0.15, -0.1, 0.1, 0.1,
                              -0.05, 0.05, 0.0]),
          target_cols=list(range(1, P)), outcome="binary", link="canonical", estimator="glm",
          nagq=1, wald_se="rx", report_overall=True)
CLUSTER = dict(sizing_mode="fixed_clusters", sizing_value=16, tau_squared=0.25)


def _rows(seed: int = 2137):
    """f32 X (SIMS, N, P) with the intercept, 0/1 y and the cluster ids."""
    rs = np.random.RandomState(seed)
    m = CLUSTER["sizing_value"]
    X = rs.standard_normal((SIMS, N, P)).astype(np.float32)
    X[..., 0] = 1.0
    ids = np.broadcast_to(np.arange(N) % m, (SIMS, N)).astype(np.int32)
    u = rs.normal(0.0, np.sqrt(CLUSTER["tau_squared"]), (SIMS, m))
    eta = X.astype(np.float64) @ KW["effects"] + np.take_along_axis(u, ids, axis=1)
    y = (rs.uniform(size=eta.shape) < 1.0 / (1.0 + np.exp(-eta))).astype(np.float32)
    return X, y, ids


@pytest.fixture(scope="module", autouse=True)
def _first_cpu_math_call():
    """As tests/test_torch_glmm.py's: the first multi-threaded call of
    torch's CPU log, log1p and exp taken before any comparison, and the
    plain GLMM on THREADS threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    x = torch.rand(1 << 20) + 0.5
    for t in (x, x.double()):
        torch.log(t), torch.log1p(t), torch.exp(t), torch.sqrt(t), torch.erf(t)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def run():
    ref_spec, ref_arr = ref_lower.lower(**KW, cluster=RefCluster(**CLUSTER))
    spec, arr = lower.lower(**KW, cluster=ClusterStatic(**CLUSTER))
    assert len(spec.effective_fit_cols) == P >= ref_smallchol.VEC_FROM_P
    X, y, ids = _rows()
    want = jax.jit(jax.vmap(
        lambda a, b, c: ref_glmmfit.glmm_grid_stats(ref_spec, ref_arr, a, b, c)))(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(ids))
    arr = datagen.to_device(arr, "cpu")
    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
    got = glmmfit.glmm_grid_stats(spec, arr, Xt, yt, plain=True)
    return (spec, arr, Xt, yt, {k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()})


def test_the_fit_at_the_reference_optimum_is_the_references(run):
    check_fit(run, "wide")


def test_the_flags_are_the_references(run):
    check_flags(run, "wide")
    assert run[5]["converged"].mean() > 0.9


def test_the_search_finds_the_references_optimum(run):
    check_search(run, "wide")
