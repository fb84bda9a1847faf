"""The port's GLMM with random slopes at p = 14 against ``mcpower_tpu`` on
the CPU: 13 normal predictors and the intercept, inside the reference's
vectorised Cholesky range (``smallchol.VEC_FROM_P`` = 13), where the
reference factors its p x p Schur matrix by rows and the port by its scalar
unroll (ROADMAP C2). Both packages get the same bytes, made with numpy from
a seed (8 sims, N 240, 16 round-robin clusters, a logit outcome of a
random intercept (tau^2 0.25) and a slope on x1 (variance 0.2, corr 0.3)):
the reference's own generator would add a compile this file's time budget
has no room for. Fitted at the reference's own theta, beta, cov, tau^2 and
t^2 are within 1e-8 and every flag (converged, boundary, each component's
pin) is equal: tests/test_torch_glmm_slopes.py's check. The search's band
is held at p = 3 there."""

import numpy as np
import pytest
import torch

from test_torch_glmm_slopes import BASE, THREADS, build_case, check_fit_at_reference_theta

SIMS = 8
N = 240
M = 16
P = 14
EFFECTS = [-0.3, 0.3, -0.25, 0.2, 0.2, -0.15, 0.15, 0.1, -0.1, 0.1, 0.05, -0.05, 0.05, 0.0]
TAU2, SLOPE_VAR, CORR = 0.25, 0.2, 0.3


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    x = torch.rand(1 << 20) + 0.5
    for t in (x, x.double()):
        torch.log(t), torch.log1p(t), torch.exp(t), torch.sqrt(t)
    yield
    torch.set_num_threads(threads)


def _rows(seed: int = 2137):
    """f32 X (SIMS, N, P) with the intercept, and a 0/1 outcome from the
    design's random intercept and slope."""
    rs = np.random.RandomState(seed)
    X = rs.standard_normal((SIMS, N, P)).astype(np.float32)
    X[..., 0] = 1.0
    ids = np.arange(N) % M
    L = np.linalg.cholesky(np.array([[TAU2, CORR * np.sqrt(TAU2 * SLOPE_VAR)],
                                     [CORR * np.sqrt(TAU2 * SLOPE_VAR), SLOPE_VAR]]))
    u = rs.standard_normal((SIMS, M, 2)) @ L.T
    eta = X.astype(np.float64) @ np.asarray(EFFECTS) + u[:, ids, 0] + u[:, ids, 1] * X[..., 1]
    y = (rs.uniform(size=eta.shape) < 1.0 / (1.0 + np.exp(-eta))).astype(np.float32)
    return X, y


def test_the_fit_at_the_reference_theta_at_p14():
    case = build_case(dict(BASE, k=P - 1, effects=EFFECTS, tau2=TAU2, grid=[N], clusters=M,
                           slopes=[(1, SLOPE_VAR, CORR)]), _rows())
    assert len(case["spec"].effective_fit_cols) == P
    check_fit_at_reference_theta(case)
    assert np.asarray(case["ref"]["converged"]).all()
