"""README flow 3 (the random-intercept logistic GLMM) through the port's
``MCPower`` against the JAX reference's, continued from
tests/test_torch_model_glmm.py: ``find_power(480, scenarios=True)``
(optimistic, realistic, doomer), its whole result tree at 64 sims and the
golden values of the chip run recomputed with the reference."""

import pytest
import torch

from test_torch_model_glmm import check_golden, check_tree

FLOWS = ["model_glmm_scenarios"]


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
        torch.log(t), torch.log1p(t), torch.exp(t), torch.sqrt(t)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", FLOWS)
def test_result_tree_matches_the_reference(name):
    got = check_tree(name)
    assert sorted(got["scenarios"]) == ["doomer", "optimistic", "realistic"]


@pytest.mark.parametrize("name", FLOWS)
def test_golden_values_of_chip_smoke_are_the_references(name):
    check_golden(name)
