"""The port's GLMM with extra groupings through the dense capacitance
(kernel K12's plain version) against ``mcpower_tpu`` on the CPU, on the
reference's own bytes: a logit ``(1 + x1 | site) + (1 | rater)``, 4 sites
with a slope on x1 (variance 0.2, corr 0.3) crossed with 3 raters (M = 4 x 2
+ 3 = 11, d = 3 + 1 = 4, 45 Nelder-Mead iterations), under
``wald_se="hessian"``. The reference has no test of its dense GLMM branch;
this is its first live run. The checks are tests/test_torch_glmm_extras.py's:
the generator's X, y and level ids, the fit at the reference's own theta
(beta, tau^2, ybar within FIT_REL; the Hessian's cov and t^2 within
HESSIAN_REL, its FD stencil dividing deviance differences by 1e-8) with every
flag equal, the search within DEV_BAND and the arm's plain fit.
"""

import pytest

from mcpower_tpu_torch.engine import mixedfit

from test_torch_glmm_extras import (  # noqa: F401 (a fixture)
    HESSIAN_REL, _first_cpu_math_call, build_case, check_fit_at_reference_theta,
    check_generation, check_search, test_the_arm_is_the_plain_fit)

DENSE = dict(grid=[96], outcome="binary", effects=[-0.3, 0.3, 0.2], k=2,
             primary=(4, 0.25, [(1, 0.2, 0.3)]), extras=[("crossed", 3, 0.15, [])],
             wald_se="hessian")


@pytest.fixture(scope="module")
def case():
    return build_case(DENSE, with_arm=False)


def test_the_generator_gives_the_references_bytes(case):
    check_generation(case)


def test_the_fit_at_the_reference_theta(case):
    assert not mixedfit.plan_all_q1(mixedfit.grouping_plan(case["spec"]))
    assert mixedfit.joint_width(mixedfit.grouping_plan(case["spec"])) == 11
    check_fit_at_reference_theta(case, cov_rel=HESSIAN_REL)


def test_the_search_against_the_reference(case):
    check_search(case, "dense logit")
