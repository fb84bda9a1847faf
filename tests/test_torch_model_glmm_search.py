"""README flow 3 (the random-intercept logistic GLMM) through the port's
``MCPower`` against the JAX reference's, continued from
tests/test_torch_model_glmm.py: ``find_sample_size(from_size=240,
to_size=720)``, its whole result tree at 64 sims and the golden values of
the chip run recomputed with the reference."""

import pytest
import torch

from test_torch_model_glmm import check_golden, check_tree

FLOWS = ["model_glmm_sample_size"]


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
    assert got["sample_sizes"][0] == 240 and got["sample_sizes"][-1] == 720


@pytest.mark.parametrize("name", FLOWS)
def test_golden_values_of_chip_smoke_are_the_references(name):
    check_golden(name)
