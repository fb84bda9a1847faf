"""The LMM with extra groupings end to end through ``engine.batch.run_batch``
on the CPU (K2's joint mode and kernel K11's plain versions), against the
reference's ``run_batch``, and the gates of the path.

* The counts of a small crossed design (6 round-robin clusters crossed with
  4 levels, a two-point grid, SIMS sims) against the reference's: at most
  MAX_FLIPS per count and PIN_FLIPS per pin count (the two searches rank on
  f32 deviances that round differently; tests/test_torch_extras_fit.py
  holds the fit itself at the reference's theta), the tau^2 sum within
  TAU2_REL;
* chunking is invisible: the same counts at two chunk sizes, and where the
  memory rule caps the chunk (``batch.joint_chunk_cap``); the tau^2 sum,
  added chunk by chunk, to rounding;
* a GLMM with extra groupings at nagq 7 raises ``NotImplementedError``
  naming kernel K12 (it takes the Laplace deviance alone; the GLMM itself
  runs, tests/test_torch_glmm_extras*.py), and plans past kernel K11's
  limits (a joint Z of more than 128 columns, a joint theta of more than 10
  entries) name K11, before any run.
"""

import numpy as np
import pytest
import torch

import mcpower_tpu  # noqa: F401  (x64 on, as the reference runs)
from mcpower_tpu.engine import batch as ref_batch
from mcpower_tpu.engine import lower as ref_lower
from mcpower_tpu.engine.spec import ClusterStatic as RefCluster
from mcpower_tpu.engine.spec import ExtraGroupingStatic as RefExtra
from mcpower_tpu_torch.engine import batch, datagen, lower
from mcpower_tpu_torch.engine.spec import ClusterStatic, ExtraGroupingStatic, SlopeStatic

SIMS = 48
SEED = 2137
MAX_FLIPS = 1
PIN_FLIPS = 2
TAU2_REL = 2e-3
THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    x = torch.rand(1 << 20) + 0.5
    for t in (x, x.double()):
        torch.log(t), torch.sqrt(t)
    yield
    torch.set_num_threads(threads)


def _lowered(low, cluster_cls, extra_cls, **kw):
    return low.lower(**{**dict(
        grid=[48, 96], var_types=["normal", "normal"], corr=np.array([[1.0, 0.3], [0.3, 1.0]]),
        effects=np.array([0.0, 0.3, 0.2]), target_cols=[1, 2], estimator="mle",
        cluster=cluster_cls("fixed_clusters", 6, 0.25,
                            extra_groupings=(extra_cls("crossed", 4, 0.15),))), **kw})


@pytest.fixture(scope="module")
def counts():
    rs, ra = _lowered(ref_lower, RefCluster, RefExtra)
    ps, pa = _lowered(lower, ClusterStatic, ExtraGroupingStatic)
    want = ref_batch.run_batch(rs, ra, SIMS, SEED, chunk_size=SIMS)
    got = batch.run_batch(ps, pa, SIMS, SEED, chunk_size=SIMS, device="cpu")
    return ps, pa, {k: np.asarray(v) for k, v in got.items()}, \
        {k: np.asarray(v) for k, v in want.items()}


def test_counts_against_the_reference(counts):
    _, _, got, want = counts
    assert sorted(got) == sorted(want)
    flips = {}
    for k in want:
        if k == "tau2_hat":
            assert np.abs(got[k] - want[k]).max() <= TAU2_REL * np.abs(want[k]).max()
            continue
        diff = int(np.abs(got[k].astype(np.int64) - want[k].astype(np.int64)).max())
        flips[k] = diff
        assert diff <= (PIN_FLIPS if k in ("pinned_comp", "boundary_hit") else MAX_FLIPS), k
    print(f"count differences against the reference: { {k: v for k, v in flips.items() if v} }")
    assert got["pinned_comp"].shape == (2, 2) and got["converged"].tolist() == [SIMS, SIMS]


def _same(got, want):
    """Counts equal; the tau^2 sum, added chunk by chunk, to rounding."""
    for k in want:
        if k == "tau2_hat":
            np.testing.assert_allclose(np.asarray(got[k]), want[k], rtol=1e-13, err_msg=k)
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)


def test_chunking_is_invisible(counts, monkeypatch):
    spec, arr, whole, _ = counts
    _same(batch.run_batch(spec, arr, SIMS, SEED, chunk_size=SIMS // 3, device="cpu"), whole)
    # the memory rule: a budget of 20 sims' ztz caps the chunk at 20
    per_sim = spec.n_grid * 10 ** 2 * 8
    monkeypatch.setattr(batch, "JOINT_CPU_BYTES", 20 * per_sim)
    assert batch.joint_chunk_cap(spec, "cpu") == 20
    with pytest.warns(UserWarning, match="chunk capped at 20 sims by memory"):
        capped = batch.run_batch(spec, arr, SIMS, SEED, chunk_size=SIMS, device="cpu")
    _same(capped, whole)


@pytest.mark.parametrize("case,match", [
    ("glmm", "a GLMM with extra groupings at nagq 7; kernel K12 takes the Laplace deviance"),
    ("wide", "a joint Z of 136 columns; kernels K2 \\(joint mode\\) and K11 take M <= 128"),
    ("theta", "a joint theta of 11 entries; kernel K11 takes d <= 10"),
])
def test_outside_k11_raises_before_any_run(case, match, monkeypatch):
    kw = {}
    if case == "glmm":  # the GLMM runs (K12) at the Laplace deviance alone
        kw = dict(outcome="binary", estimator="glm", effects=np.array([-0.3, 0.3, 0.2]), nagq=7)
    elif case == "wide":  # 8 clusters + 128 crossed levels
        kw = dict(grid=[1024], cluster=ClusterStatic(
            "fixed_clusters", 8, 0.25, extra_groupings=(ExtraGroupingStatic("crossed", 128, 0.1),)))
    else:  # q = 4 on the primary (d = 10) and a crossed intercept (d = 1)
        slopes = tuple(SlopeStatic(1 + k % 2, 0.1, 0.0) for k in range(3))
        kw = dict(cluster=ClusterStatic("fixed_clusters", 6, 0.25, slopes=slopes,
                                        extra_groupings=(ExtraGroupingStatic("crossed", 4, 0.1),)))
    spec, arr = _lowered(lower, ClusterStatic, ExtraGroupingStatic, **kw)
    assert datagen.unsupported(spec)
    calls = []
    monkeypatch.setattr(datagen, "generate_batch", lambda *a, **k: calls.append(1))
    with pytest.raises(NotImplementedError, match=match):
        batch.run_batch(spec, arr, 8, 1, device="cpu")
    assert calls == []
