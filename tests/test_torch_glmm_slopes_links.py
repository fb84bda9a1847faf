"""The port's GLMM with random slopes on the other links than
tests/test_torch_glmm_slopes.py's logit, through the same checks on the
reference's own bytes: the fit at the reference's theta (beta, cov, tau^2
and t^2 within 1e-8, every flag equal) and the search (the f64 deviance at
the two optima within DEV_BAND, a pin apart only where its removal costs
less than FLAT at both). Designs, one small case each: a probit outcome and
a Poisson outcome (the slope on x1 at variance 0.1, corr 0.2).
tests/test_torch_glmm_slopes_q3.py runs q = 3 and the Hessian covariance.
The measured gaps are printed (and recorded in ROADMAP C)."""

import numpy as np
import pytest
import torch

from test_torch_glmm_slopes import (
    BASE,
    THREADS,
    build_case,
    check_fit_at_reference_theta,
    check_search,
)

DESIGNS = {
    "probit": dict(link="probit", effects=[-0.2, 0.3, 0.2]),
    "poisson": dict(outcome="count", effects=[0.5, 0.2, 0.1], tau2=0.2, slopes=[(1, 0.1, 0.2)]),
}


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
    check_fit_at_reference_theta(case)
    assert np.asarray(case["ref"]["converged"]).mean() > 0.9


def test_the_search_against_the_reference(case):
    check_search(case, case["name"])
