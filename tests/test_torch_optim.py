"""The port's batched Nelder-Mead (``engine/optim.py``, the plain version of
kernel K9's search) against ``mcpower_tpu.engine.optim.nelder_mead``.

The objective is evaluated in the same operations by both (absolute
differences added left to right: no product that XLA could contract into a
fused multiply-add), so the two searches see the same values and must end at
the same vertex with the same value, bit for bit. Cases: d = 3, 6 and 10
(q = 2, 3, 4) with Cholesky-diagonal lower bounds that clip (the optimum of
some coordinates lies below 0), a sentinel region whose values all equal
1e30 (ties the stable sort must keep in vertex order), and the selection
rule on its own against ``_select_candidate``. ``nelder_mead_carry`` (the
plain version of kernel K10's search) against the reference's, on the same
objective read off a warm-started fixed-point iterate that the search
carries, at two phase schedules and with clipping: the same vertex, value
and final carry, bit for bit; and the reference's ``dynamic_budget=True``
(one traced body, the budget looked up by iteration) against the port's
phased loop on the extras' schedules, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpower_tpu.engine import optim as ref_optim
from mcpower_tpu_torch.engine import optim
from mcpower_tpu_torch.engine.mixedfit import vech_diagonal

CELLS = 24
ITERS = 140
STEP = 0.3
SENTINEL = 1e30


def _targets(d: int, seed: int) -> np.ndarray:
    c = np.random.default_rng(seed).normal(0.0, 0.8, size=(CELLS, d))
    c[::2, 0] = -1.5  # below the first diagonal's bound of 0 in every other cell
    return c


def _lower(q: int) -> np.ndarray:
    lo = np.full(q * (q + 1) // 2, -np.inf)
    lo[vech_diagonal(q)] = 0.0
    return lo


def _objective(xp, x, c, sentinel_at):
    """sum_k |x_k - c_k| left to right; SENTINEL where x_0 > sentinel_at."""
    acc = xp.abs(x[..., 0] - c[..., 0])
    for k in range(1, x.shape[-1]):
        acc = acc + xp.abs(x[..., k] - c[..., k])
    return xp.where(x[..., 0] > sentinel_at, SENTINEL, acc)


@pytest.mark.parametrize("q,sentinel_at", [(2, np.inf), (3, np.inf), (4, np.inf), (2, 0.35),
                                           (3, 0.2)])
def test_nelder_mead_matches_the_reference_bit_for_bit(q, sentinel_at):
    d = q * (q + 1) // 2
    c = _targets(d, 10 * q + int(np.isfinite(sentinel_at)))
    x0 = np.abs(np.random.default_rng(q).normal(0.5, 0.2, size=(CELLS, d)))
    lower = _lower(q)

    @jax.jit
    def ref(x0, c):
        def one(x0_, c_):
            return ref_optim.nelder_mead(lambda x: _objective(jnp, x, c_, sentinel_at), x0_,
                                         iters=ITERS, init_step=STEP, lower=jnp.asarray(lower))
        return jax.vmap(one)(x0, c)

    want_x, want_f = (np.asarray(v) for v in ref(jnp.asarray(x0), jnp.asarray(c)))
    ct = torch.as_tensor(c)
    got_x, got_f = optim.nelder_mead(
        lambda x: _objective(torch, x, ct[:, None, :], sentinel_at), torch.as_tensor(x0),
        iters=ITERS, init_step=STEP, lower=torch.as_tensor(lower))
    np.testing.assert_array_equal(got_x.numpy(), want_x)
    np.testing.assert_array_equal(got_f.numpy(), want_f)
    assert np.all(want_f <= _objective(np, x0, c, sentinel_at))
    if np.isinf(sentinel_at):  # the lower bound binds where the target lies below it
        assert (got_x.numpy()[::2, 0] == 0.0).sum() > 0
    else:  # some vertices sat in the tied sentinel region
        start = np.concatenate([x0[:, None], x0[:, None] + STEP * np.eye(d)], axis=1)
        assert (start[..., 0] > sentinel_at).any()


def test_select_candidate_matches_the_reference():
    rs = np.random.default_rng(7)
    # values from a small set, so that ties and every branch occur
    v = rs.integers(0, 5, size=(7, 4096)).astype(np.float64)
    v[:3].sort(axis=0)  # f_best <= second <= f_worst
    f_best, second, f_worst = v[0], v[1], v[2]
    args = (f_best, second, f_worst, v[3], v[4], v[5], v[6])
    want = np.asarray(jax.vmap(ref_optim._select_candidate)(*map(jnp.asarray, args)))
    got = optim.select_candidate(*map(torch.as_tensor, args)).numpy()
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) == {0, 1, 2, 3}


def _fixed_point(xp, x, a, budget):
    """``budget`` steps of a <- (a + x) / 2 from the carried ``a``: a solver
    state that a warm start brings closer to x."""
    for _ in range(budget):
        a = (a + x) * 0.5
    return a


@pytest.mark.parametrize("q,phases", [(2, ((12, 8), (33, 3))), (3, ((4, 5), (9, 1), (6, 2)))])
def test_nelder_mead_carry_matches_the_reference_bit_for_bit(q, phases):
    """The warm-carried search: every candidate starts its fixed-point
    iterate from the carry, the accepted one's iterate is carried on, and
    the objective reads the iterate (so a stale carry costs value). Both
    searches must end at the same vertex, value and carry."""
    d = q * (q + 1) // 2
    c = _targets(d, 7 * q)
    x0 = np.abs(np.random.default_rng(q + 1).normal(0.5, 0.2, size=(CELLS, d)))
    a0 = np.random.default_rng(q + 2).normal(0.0, 1.0, size=(CELLS, d))
    lower = _lower(q)

    @jax.jit
    def ref(x0, a0, c):
        def one(x0_, a0_, c_):
            def f(x, a, budget):
                a = _fixed_point(jnp, x, a, budget)
                return _objective(jnp, a, c_, np.inf), a
            return ref_optim.nelder_mead_carry(f, x0_, a0_, phases=phases, init_step=STEP,
                                               lower=jnp.asarray(lower))
        return jax.vmap(one)(x0, a0, c)

    want = [np.asarray(v) for v in ref(jnp.asarray(x0), jnp.asarray(a0), jnp.asarray(c))]
    ct = torch.as_tensor(c)

    def f(points, aux, budget):
        a = _fixed_point(torch, points, aux[0][:, None, :], budget)
        return _objective(torch, a, ct[:, None, :], np.inf), (a,)

    got_x, got_f, (got_a,) = optim.nelder_mead_carry(
        f, torch.as_tensor(x0), (torch.as_tensor(a0),), phases=phases, init_step=STEP,
        lower=torch.as_tensor(lower))
    np.testing.assert_array_equal(got_x.numpy(), want[0])
    np.testing.assert_array_equal(got_f.numpy(), want[1])
    np.testing.assert_array_equal(got_a.numpy(), want[2])
    assert (got_x.numpy()[::2, 0] == 0.0).sum() > 0  # the lower bound binds
    assert not np.array_equal(got_a.numpy(), a0)


@pytest.mark.parametrize("q,phases", [(1, ((12, 8), (18, 3))), (2, ((12, 8), (33, 3)))])
def test_the_dynamic_budget_is_the_phased_loop(q, phases):
    """The reference's extra-groupings search passes ``dynamic_budget=True``
    (glmmfit.py:466-477): one traced body whose budget is ``budgets[
    searchsorted(bounds, i, side="right")]`` over the phases' cumulative
    iteration counts. That is the schedule of the port's phased loop, which
    has no such flag: on the extras' schedules (30 iterations for d <= 3,
    45 beyond, 12 of them at 8 steps) the two searches end at the same
    vertex, value and carry, bit for bit."""
    d = q * (q + 1) // 2
    c = _targets(d, 11 * q)
    x0 = np.abs(np.random.default_rng(q + 5).normal(0.5, 0.2, size=(CELLS, d)))
    a0 = np.random.default_rng(q + 6).normal(0.0, 1.0, size=(CELLS, d))
    lower = _lower(q)

    @jax.jit
    def ref(x0, a0, c):
        def one(x0_, a0_, c_):
            def f(x, a, budget):  # a traced budget: the fixed point as a loop
                a = jax.lax.fori_loop(0, budget, lambda _, a_: (a_ + x) * 0.5, a)
                return _objective(jnp, a, c_, np.inf), a
            return ref_optim.nelder_mead_carry(f, x0_, a0_, phases=phases, init_step=STEP,
                                               lower=jnp.asarray(lower), dynamic_budget=True)
        return jax.vmap(one)(x0, a0, c)

    want = [np.asarray(v) for v in ref(jnp.asarray(x0), jnp.asarray(a0), jnp.asarray(c))]
    ct = torch.as_tensor(c)

    def f(points, aux, budget):
        a = _fixed_point(torch, points, aux[0][:, None, :], budget)
        return _objective(torch, a, ct[:, None, :], np.inf), (a,)

    got_x, got_f, (got_a,) = optim.nelder_mead_carry(
        f, torch.as_tensor(x0), (torch.as_tensor(a0),), phases=phases, init_step=STEP,
        lower=torch.as_tensor(lower))
    np.testing.assert_array_equal(got_x.numpy(), want[0])
    np.testing.assert_array_equal(got_f.numpy(), want[1])
    np.testing.assert_array_equal(got_a.numpy(), want[2])
