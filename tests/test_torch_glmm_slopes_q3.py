"""The port's GLMM with random slopes at q = 3 (slopes on x1 and x2: the
search runs over d = 6) and under ``wald_se="hessian"``, through
tests/test_torch_glmm_slopes.py's checks on the reference's own bytes. The
Hessian covariance comes from central differences of the v-profiled
Laplace deviance (20 v-only f64 PIRLS passes a stencil point) and is held
within 1e-5 (the differences divide rounding by h^2 = 1e-8), as K7's is;
its search is the logit q = 2 design's, held there, so here only the fit at
the reference's theta is. The measured gaps are printed (and recorded in
ROADMAP C)."""

import numpy as np
import pytest
import torch

from mcpower_tpu_torch.engine import glmmfit
from test_torch_glmm_slopes import (
    BASE,
    THREADS,
    build_case,
    check_fit_at_reference_theta,
    check_search,
)

DESIGNS = {
    "q3": dict(slopes=[(1, 0.2, 0.3), (2, 0.1, 0.1)]),
    "hessian": dict(wald_se="hessian"),
}
HESSIAN_REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    x = torch.rand(1 << 20) + 0.5
    for t in (x, x.double()):
        torch.log(t), torch.log1p(t), torch.exp(t), torch.sqrt(t), torch.erf(t)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=sorted(DESIGNS))
def case(request):
    c = build_case(dict(BASE, **DESIGNS[request.param]))
    c["name"] = request.param
    return c


def test_the_fit_at_the_reference_theta(case):
    rel = HESSIAN_REL if case["name"] == "hessian" else 1e-8
    pinned = check_fit_at_reference_theta(case, t2_rel=rel, cov_rel=rel)
    assert pinned.shape[-1] == (3 if case["name"] == "q3" else 2)
    assert np.asarray(case["ref"]["converged"]).mean() > 0.9


def test_the_search_or_the_hessians_reach(case):
    """q = 3: the search against the reference's. The Hessian: it changes
    the covariance alone (beta, tau^2 and the flags are the rx fit's), and
    its variances lie near the rx ones."""
    if case["name"] == "q3":
        check_search(case, "q3")
        return
    theta = torch.as_tensor(case["ref"]["theta"])
    hess = glmmfit.glmm_slope_plain(*case["args"], theta=theta)
    rx = glmmfit.glmm_slope_plain(*case["args"][:-1], False, theta=theta)
    for i in (0, 2, 3, 4, 6):
        np.testing.assert_array_equal(hess[i].numpy(), rx[i].numpy())
    ok = rx[2].numpy()
    ratio = np.diagonal(hess[1].numpy(), axis1=-2, axis2=-1) / np.diagonal(
        rx[1].numpy(), axis1=-2, axis2=-1)
    assert not np.array_equal(hess[1].numpy(), rx[1].numpy())
    assert np.all(np.abs(ratio[ok] - 1.0) < 0.5), ratio[ok]
