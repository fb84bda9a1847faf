"""The port's random-intercept GLMM against ``mcpower_tpu`` on the
reference's bytes, continued (tests/test_torch_glmm.py has the checks and
their bands): AGQ at 7 nodes, the FD Hessian Wald covariance, blocked
clusters and the cold start of ``truth_start=False``."""

import pytest
import torch

from test_torch_glmm import build_runs, check_fit, check_flags, check_search

DESIGNS = ["agq7", "hessian", "blocked", "cold_start"]


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


@pytest.fixture(scope="module")
def runs():
    return build_runs(DESIGNS)


@pytest.mark.parametrize("name", DESIGNS)
def test_the_fit_at_the_reference_optimum_is_the_references(runs, name):
    check_fit(runs[name], name)


@pytest.mark.parametrize("name", DESIGNS)
def test_the_flags_are_the_references(runs, name):
    check_flags(runs[name], name)


@pytest.mark.parametrize("name", DESIGNS)
def test_the_search_finds_the_references_optimum(runs, name):
    check_search(runs[name], name)
