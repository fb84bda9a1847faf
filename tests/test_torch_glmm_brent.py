"""How often the GLMM's tau^2 search leaves the reference's optimum by more
than its resolution, on ``chip_smoke.py``'s ``glmm_laplace`` arm at its
1,024 golden sims (the reference's bytes, the port's plain version).

The reference's Brent (``mixedfit._brent_minimize``) fits the same parabola
again after a parabolic step it rejected without moving w or v; that step
lands on the bracket edge b, and the safeguard ``p < q (b - x)`` then
compares two roundings of one number. A cell whose f32 deviances differ
from the reference's in the 7th digit can take the other branch there and
end at another optimum (ROADMAP C). This test bounds how many cells do
(at most 1%), prints them with the f64 objective at both optima, and prints
how far they move the tau^2 sum that ``chip_smoke.GLMM_TAU2_REL`` bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mcpower_tpu.engine import datagen as ref_datagen
from mcpower_tpu.engine import glmmfit as ref_glmmfit
from mcpower_tpu.engine import lower as ref_lower
from mcpower_tpu.engine.spec import ClusterStatic as RefCluster
from mcpower_tpu_torch.engine import datagen, glmmfit, lower
from mcpower_tpu_torch.engine.spec import ClusterStatic
from test_torch_glmm import _objective

THREADS = 2
FAR = 0.1  # relative tau^2 gap that no rounding-level path difference explains
MAX_FAR_SHARE = 0.01


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


def test_few_cells_leave_the_references_optimum():
    name, n = "glmm_laplace", chip_smoke.GOLDEN_SIMS
    ref_spec, ref_arr = chip_smoke.lower_design(ref_lower, RefCluster, name)
    spec, arr = chip_smoke.lower_design(lower, ClusterStatic, name)
    fit = jax.jit(jax.vmap(lambda a, b, c: ref_glmmfit.glmm_grid_stats(ref_spec, ref_arr, a, b, c)))
    tw, tg, far = [], [], []
    arr = datagen.to_device(arr, "cpu")
    for s0 in range(0, n, 256):
        X, y, ids = ref_datagen.generate_batch(ref_spec, ref_arr, chip_smoke.SEED, 0,
                                               jnp.arange(s0, s0 + 256, dtype=jnp.uint32))
        w = np.asarray(fit(X, y, ids)["tau2_hat"])[:, 0]
        Xt, yt = torch.as_tensor(np.array(X)), torch.as_tensor(np.array(y))
        g = glmmfit.glmm_grid_stats(spec, arr, Xt, yt, plain=True)["tau2_hat"].numpy()[:, 0]
        idx = np.nonzero(np.abs(g - w) > FAR * np.maximum(np.abs(w), 1e-3))[0]
        if idx.size:
            both = lambda t: torch.as_tensor(np.log(np.maximum(t[idx], 1e-12)))[:, None]  # noqa: E731
            ow = _objective(spec, arr, Xt[idx], yt[idx], both(w))[:, 0]
            og = _objective(spec, arr, Xt[idx], yt[idx], both(g))[:, 0]
            far += [(s0 + i, w[i], g[i], a, b) for i, a, b in zip(idx, ow, og)]
        tw.append(w)
        tg.append(g)
    tw, tg = np.concatenate(tw), np.concatenate(tg)
    print(f"{len(far)} of {n} cells with tau^2 more than {FAR:.0%} from the reference's; the "
          f"tau^2 sum {tg.sum():.6f} against {tw.sum():.6f} (rel {(tg.sum() - tw.sum()) / tw.sum():.2e})")
    for sim, w, g, ow, og in far:
        print(f"  sim {sim}: tau^2 {w:.5f} (reference) against {g:.5f} (port); f64 objective "
              f"{ow:.6f} against {og:.6f}")
    assert len(far) <= MAX_FAR_SHARE * n
