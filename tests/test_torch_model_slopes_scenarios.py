"""README flow 2 through the port's ``MCPower``, continued from
tests/test_torch_model_slopes.py: ``find_power(600, scenarios=True)``
(optimistic, realistic, doomer: a heavy-tailed random effect with ICC noise
in the last two) at GOLDEN_SIMS sims on the CPU, against the golden values
the JAX reference gave for the chip run (``chip_smoke.MODEL_GOLDEN``), at
the chip run's bands: one flip per count, SLOPE_PIN_FLIPS per pin count,
the mean tau^2 within TAU2_REL. The reference's three scenario programs take
about a minute to compile on the CPU, more than this file's time: the optimistic
scenario's values are the power flow's, which
tests/test_torch_model_slopes.py recomputes with the reference; the
realistic and doomer values were computed with the reference once, as
the chip run's golden values were."""

import pytest
import torch

from test_torch_model_slopes import THREADS, MCPower, chip_smoke

NAME = "model_lmm_slopes_scenarios"


@pytest.fixture(scope="module", autouse=True)
def _first_cpu_math_call():
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    x = torch.rand(1 << 20) + 0.5
    for t in (x, x.double()):
        torch.log(t), torch.sqrt(t)
    yield
    torch.set_num_threads(threads)


def test_scenarios_against_the_references_golden_values():
    got = chip_smoke.run_flow(MCPower, NAME, chip_smoke.GOLDEN_SIMS, device="cpu")
    assert list(got["scenarios"]) == ["optimistic", "realistic", "doomer"]
    flips = chip_smoke.compare_trees(NAME, chip_smoke.flow_summary(got),
                                     chip_smoke.MODEL_GOLDEN[NAME],
                                     pin_flips=chip_smoke.SLOPE_PIN_FLIPS)
    print(f"{NAME}: against the reference's golden values: {flips or 'identical'}")
    assert got.summary()
    assert chip_smoke.MODEL_GOLDEN[NAME]["optimistic"] == \
        chip_smoke.MODEL_GOLDEN["model_lmm_slopes_power"]
