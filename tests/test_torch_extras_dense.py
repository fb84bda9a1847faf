"""The port's dense joint-Z branch (an extra grouping beside a primary
grouping with a random slope) against ``mcpower_tpu.engine.mixedfit`` on
the CPU, on the reference's own bytes: README flow 2's design with a crossed
rater, ``y ~ treatment + (1 + treatment | site) + (1 | rater)``, cut to 6
sites and 4 raters (M = 6 x 2 + 4 = 16). The reference has no test of this
branch of its own; this is its live run. The checks are
tests/test_torch_extras_fit.py's: the joint statistics, the replica held to
the reference's ``mixed_grid_stats``, the fit at the reference's own theta
within FIT_REL with every flag equal, and the search within DEV_BAND. The
reference's XLA:CPU compile of the dense program dominates the file
(measured: 8.3 s to compile and run the search and fit; compiling its arm
as well took the file from 23 s to 52 s), so the replica is held to the arm
in tests/test_torch_extras_fit.py's structured case alone.
"""

import pytest

from mcpower_tpu_torch.engine import mixedfit

from test_torch_extras_fit import (  # noqa: F401 (a fixture)
    _first_cpu_math_call, build_case, check_fit_at_reference_theta, check_search,
    check_statistics)

DENSE = dict(grid=[48, 96], var_types=["binary"], corr=[[1.0]], effects=[0.0, 0.4],
             target_cols=[1], primary=(6, 0.25, [(1, 0.1, 0.3)]),
             extras=[("crossed", 4, 0.1, [])])


@pytest.fixture(scope="module")
def case():
    return build_case(DENSE, with_arm=False)


def test_joint_statistics_match_the_reference(case):
    check_statistics(case)
    plan = mixedfit.grouping_plan(case["spec"])
    assert not mixedfit.plan_all_q1(plan) and mixedfit.joint_width(plan) == 16


def test_fit_at_the_reference_theta(case):
    check_fit_at_reference_theta(case)


def test_the_search_against_the_reference(case):
    check_search("dense", case)
