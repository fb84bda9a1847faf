"""The port's ``run_batch`` on the random-intercept GLMM arms of
``chip_smoke.py`` (bench.py's ``glmm_agq7`` and its Laplace twin) against
``mcpower_tpu.engine.batch.run_batch`` on the CPU: counts at 64 sims within
one flip per entry (an f32 search step can move tau^2 within the search's
resolution, tests/test_torch_glmm.py, and with it a statistic sitting on
its threshold), and the 1,024-sim golden counts that ``chip_smoke.py``
holds on the card recomputed with the reference, so they cannot go stale,
and reproduced by the port's plain path within the same flips."""

import numpy as np
import pytest
import torch

import chip_smoke
from mcpower_tpu.engine import batch as ref_batch
from mcpower_tpu.engine import lower as ref_lower
from mcpower_tpu.engine.spec import ClusterStatic as RefCluster
from mcpower_tpu_torch.engine import batch, lower
from mcpower_tpu_torch.engine.spec import ClusterStatic

SIMS = 64
ARMS = sorted(chip_smoke.GLMM_DESIGNS)


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


def _designs(name):
    return (chip_smoke.lower_design(ref_lower, RefCluster, name),
            chip_smoke.lower_design(lower, ClusterStatic, name))


def _assert_counts_close(got, want, max_flips, tau2_rel):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g, w = np.asarray(got[key]), np.asarray(w)
        assert g.shape == w.shape, key
        if key == "tau2_hat":  # a sum of the per-sim estimates
            np.testing.assert_allclose(g, w, rtol=tau2_rel, err_msg=key)
        elif key == "glm_baseline":  # the same outcome means, summed in another order
            np.testing.assert_allclose(g, w, rtol=1e-12, err_msg=key)
        else:
            assert np.abs(g.astype(np.int64) - w.astype(np.int64)).max() <= max_flips, \
                (key, g.tolist(), w.tolist())


@pytest.mark.parametrize("name", ARMS)
def test_run_batch_counts_match_the_reference(name):
    (ref_spec, ref_arr), (spec, arr) = _designs(name)
    want = ref_batch.run_batch(ref_spec, ref_arr, SIMS, chip_smoke.SEED, chunk_size=SIMS)
    got = batch.run_batch(spec, arr, SIMS, chip_smoke.SEED, chunk_size=SIMS, device="cpu")
    _assert_counts_close(got, want, chip_smoke.MAX_FLIPS, chip_smoke.GLMM_TAU2_REL)


@pytest.mark.parametrize("name", ARMS)
def test_golden_counts_of_chip_smoke_are_the_references(name):
    (ref_spec, ref_arr), (spec, arr) = _designs(name)
    n = chip_smoke.GOLDEN_SIMS
    want = ref_batch.run_batch(ref_spec, ref_arr, n, chip_smoke.SEED, chunk_size=SIMS)
    _assert_counts_close(chip_smoke.GOLDEN[name], want, 0, 1e-12)
    # the port's plain path, within the flips the card is allowed
    got = batch.run_batch(spec, arr, n, chip_smoke.SEED, chunk_size=4 * SIMS, device="cpu")
    _assert_counts_close(got, want, chip_smoke.MAX_FLIPS, chip_smoke.GLMM_TAU2_REL)
