"""The port's GLMM with extra groupings (kernel K12's plain version) on a
Poisson design with a nested grouping, against ``mcpower_tpu`` on the CPU,
on the reference's own bytes: 4 primary clusters, 2 nested levels a parent
(the nested level ids (i % S) * 2 + (i / S) % 2, M = 4 + 8 = 12), the
structured capacitance and the log link (its counts through the Poisson
quantile, its weights at Poisson's MU_EPS floor). The checks are
tests/test_torch_glmm_extras.py's: the generator's X, y and level ids, the
fit at the reference's own theta within FIT_REL with every flag equal, the
search within DEV_BAND and the arm's plain fit; the replica is held to the
reference's arm in that file alone.
"""

import pytest

from mcpower_tpu_torch.engine import mixedfit

from test_torch_glmm_extras import (  # noqa: F401 (a fixture)
    _first_cpu_math_call, build_case, check_fit_at_reference_theta, check_generation,
    check_search, test_the_arm_is_the_plain_fit)

NESTED = dict(grid=[96], outcome="count", effects=[0.5, 0.2, 0.1], k=2,
              primary=(4, 0.2, []), extras=[("nested", 2, 0.1, [])], wald_se="rx")


@pytest.fixture(scope="module")
def case():
    return build_case(NESTED, with_arm=False)


def test_the_generator_gives_the_references_bytes(case):
    check_generation(case)


def test_the_fit_at_the_reference_theta(case):
    assert mixedfit.plan_all_q1(mixedfit.grouping_plan(case["spec"]))
    assert case["spec"].cluster.extra_groupings[0].relation == "nested"
    check_fit_at_reference_theta(case)


def test_the_search_against_the_reference(case):
    check_search(case, "nested poisson")
