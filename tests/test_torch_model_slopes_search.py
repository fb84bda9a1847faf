"""README flow 2 through the port's ``MCPower`` against the JAX reference's,
continued from tests/test_torch_model_slopes.py:
``find_sample_size(from_size=300, to_size=900)`` on the 30-site atom (11
grid points). Its whole result tree against the reference's at SIMS sims,
and the golden values of the chip run recomputed with the reference at
GOLDEN_SIMS (the port's plain search over 11 grid points at that size would
not fit this file's time)."""

import pytest
import torch

from test_torch_model_slopes import RefMCPower, chip_smoke, MCPower

NAME = "model_lmm_slopes_sample_size"
SIMS = 32
THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def _first_cpu_math_call():
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    x = torch.rand(1 << 20) + 0.5
    for t in (x, x.double()):
        torch.log(t), torch.sqrt(t)
    yield
    torch.set_num_threads(threads)


def test_sample_size_tree_matches_the_reference():
    got = chip_smoke.run_flow(MCPower, NAME, SIMS, device="cpu")
    want = chip_smoke.run_flow(RefMCPower, NAME, SIMS)
    chip_smoke.compare_trees(NAME, got, want, pin_flips=chip_smoke.SLOPE_PIN_FLIPS)
    assert got["sample_sizes"][0] == 300 and got["sample_sizes"][-1] == 900
    assert len(got["sample_sizes"]) == 11 and got.summary()


def test_golden_values_of_the_sample_size_flow_are_the_references():
    want = chip_smoke.flow_summary(chip_smoke.run_flow(RefMCPower, NAME, chip_smoke.GOLDEN_SIMS))
    chip_smoke.compare_trees(NAME, chip_smoke.MODEL_GOLDEN[NAME], want, max_flips=0,
                             tau_rel=1e-12)
