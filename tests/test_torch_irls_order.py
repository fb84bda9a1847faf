"""The arithmetic facts kernel K6 (``csrc/glm_irls.cu``) relies on to stay
bit-identical to ``glmfit.glm_irls_plain``, checked on the CPU without JAX.

* K6 combines its lanes' sums by a recursive-halving reduce-scatter, then
  every lane reads each sum from its owner. A model of that, written the way
  the kernel indexes its slots, gives the bits of ``smallchol.lane_sum``.
* K6 masks the f32 phase's columns by an f32 multiply; for a 0/1 mask that
  equals the reference's f32 copy of ``x * mask`` formed in f64.
* K6's final pass computes the deviance and the null deviance in one walk,
  with ``log(mu0)`` and ``log(1 - mu0)`` taken once per cell and one log per
  binomial row; written in the plain version's terms, that gives its bits.
"""

import numpy as np
import pytest
import torch

from mcpower_tpu_torch.engine import glmfit, smallchol

LANES = smallchol.LANES


@pytest.fixture(scope="module", autouse=True)
def _first_cpu_math_call():
    """Take the process's first multi-threaded call of torch's CPU log,
    log1p and exp before any comparison: that call has been seen, in a
    loaded process, to return values ~1e-5 off on part of a tensor."""
    x = torch.rand(1 << 20) + 0.5
    for t in (x, x.double()):
        torch.log(t), torch.log1p(t), torch.exp(t), torch.sqrt(t), torch.erf(t)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def assert_same_bits(got: torch.Tensor, want: torch.Tensor):
    """Equal bit for bit, signed zeros included; NaN compared by position,
    not by payload."""
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(_bits(got)[~nan], _bits(want)[~nan])


def reduce_scatter_sums(acc: torch.Tensor) -> torch.Tensor:
    """K6's ``lane_sums`` on ``acc (LANES, V)``, lane l's partial sums:
    levels at distances 16, 8, 4, 2, 1; at each a lane keeps half of its N
    slots (the lower lane the first ceil(N / 2), the upper lane the rest
    and, for odd N, a dummy) and adds its partner's copy of them; once one
    slot is left a level adds both copies. Then each lane writes the slots
    that hold values (its first ``real``), values base, base + 1, ..., to
    the shared sums, which every lane reads. Returns the V sums, after
    checking that every value was written and that lanes writing the same
    value wrote the same bits."""
    lanes = torch.arange(LANES)
    V = acc.shape[1]
    a = acc.clone()
    base = torch.zeros(LANES, dtype=torch.int64)
    real = torch.full((LANES,), V, dtype=torch.int64)  # slots of a lane that hold values
    off = LANES // 2
    while off:
        N = a.shape[1]
        partner = lanes ^ off
        if N == 1:
            a = a + a[partner]
        else:
            H = (N + 1) // 2
            upper = ((lanes & off) != 0)[:, None]
            lo = a[:, :H]
            hi = torch.cat([a[:, H:], torch.zeros(LANES, 2 * H - N, dtype=a.dtype)], dim=1)
            keep, send = torch.where(upper, hi, lo), torch.where(upper, lo, hi)
            a = keep + send[partner]
            base = base + torch.where(upper[:, 0], H, 0)
            real = torch.where(upper[:, 0], (real - H).clamp(min=0), real.clamp(max=H))
        off //= 2
    out = torch.full((V,), float("nan"), dtype=a.dtype)
    written = [None] * V
    for lane in range(LANES):
        for s in range(int(real[lane])):
            v = int(base[lane]) + s
            if written[v] is not None:
                assert_same_bits(a[lane, s:s + 1], written[v])
            written[v] = a[lane, s:s + 1]
            out[v] = a[lane, s]
    assert all(w is not None for w in written), "a value has no owner lane"
    return out


def _partials(rs, dtype, V: int, rows: int) -> torch.Tensor:
    """``(V, rows * LANES)`` values of mixed magnitude and sign, with signed
    zeros, infinities of both signs (some sums become NaN) and exact
    cancellations."""
    x = rs.standard_normal((V, rows * LANES)) * 10.0 ** rs.uniform(-8, 8, (V, rows * LANES))
    pick = rs.uniform(size=x.shape)
    x[pick < 0.05] = 0.0
    x[(pick >= 0.05) & (pick < 0.1)] = -0.0
    x[(pick >= 0.1) & (pick < 0.11)] = np.inf
    x[(pick >= 0.11) & (pick < 0.12)] = -np.inf
    x[:, 1::LANES] = -x[:, 0::LANES]
    return torch.as_tensor(x, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_reduce_scatter_has_the_bits_of_lane_sum(dtype):
    rs = np.random.RandomState(7 if dtype == torch.float32 else 8)
    for V in range(1, 153):
        t = _partials(rs, dtype, V, rows=2)
        # each lane adds its rows to a zero in turn, as K6 and lane_sum do
        acc = torch.zeros(LANES, V, dtype=dtype)
        for r in range(t.shape[1] // LANES):
            acc = acc + t[:, r * LANES:(r + 1) * LANES].T
        assert_same_bits(reduce_scatter_sums(acc), smallchol.lane_sum(t))


def test_reduce_scatter_keeps_signed_zeros_and_infinities_of_the_partials():
    """Partials as they reach the tree (no zero start): the model adds
    exactly the pairs of lane_sum's tree."""
    for dtype in (torch.float32, torch.float64):
        specials = torch.tensor([0.0, -0.0, float("inf"), float("-inf"), 1.0, -1.0, 3e-300],
                                dtype=torch.float64).to(dtype)
        rs = np.random.RandomState(11)
        for V in (1, 2, 3, 7, 14, 33, 152):
            acc = specials[torch.as_tensor(rs.randint(0, len(specials), (LANES, V)))]
            want = acc.clone()
            half = LANES // 2
            while half:
                want = want[:half] + want[half:2 * half]
                half //= 2
            assert_same_bits(reduce_scatter_sums(acc), want[0])


def test_f32_mask_multiply_equals_the_f64_mask_in_f32():
    rs = np.random.RandomState(3)
    x = rs.standard_normal(4096) * 10.0 ** rs.uniform(-40, 38, 4096)
    x = np.concatenate([x, -x, [0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45, 3.4e38, -3.4e38]])
    x32 = torch.as_tensor(x, dtype=torch.float64).to(torch.float32)
    for m in (0.0, 1.0):
        got = x32 * torch.tensor(m, dtype=torch.float32)
        want = (x32.double() * torch.tensor(m, dtype=torch.float64)).to(torch.float32)
        assert_same_bits(got, want)


def _fused_deviances(code, X, y, fit, grid, beta, colmask, ybar):
    """K6's final pass in the plain version's terms: per row one link
    evaluation and (binomial) one log, the null model's logs once per cell,
    summed in the lane order."""
    Xf = X[..., list(fit)].to(torch.float64)
    yf = y.to(torch.float64)
    devs, dev0s = [], []
    for g, n in enumerate(grid):
        rows = -(-n // LANES) * LANES
        Xg = torch.nn.functional.pad(Xf[:, :n] * colmask[g], (0, 0, 0, rows - n))
        yg = torch.nn.functional.pad(yf[:, :n], (0, rows - n))
        mask = torch.nn.functional.pad(torch.ones_like(yf[:, :n]), (0, rows - n))
        mu = glmfit._mu_var_dmu(code, smallchol.rowmv(Xg, beta[:, g]))[0]
        mu0 = torch.clamp(ybar[:, g], min=glmfit.MU_EPS)
        if code != glmfit.LINK_POISSON:
            mu0 = torch.clamp(mu0, max=1.0 - glmfit.MU_EPS)
            l1, l0 = (-torch.log(mu0))[:, None], (-torch.log(1.0 - mu0))[:, None]
            pos, neg = yg > 0.5, yg < 0.5
            t = torch.where(pos | neg, -torch.log(torch.where(pos, mu, 1.0 - mu)), 0.0)
            dt = t + 0.0
            dt0 = torch.where(pos, l1, torch.where(neg, l0, 0.0)) + 0.0
        else:
            lmu0 = torch.log(mu0)[:, None]
            ylogy = torch.where(yg > 0, yg * torch.log(torch.clamp(yg, min=glmfit.MU_EPS)), 0.0)
            dt = ylogy - yg * torch.log(mu) - (yg - mu)
            dt0 = ylogy - yg * lmu0 - (yg - mu0[:, None])
        devs.append(2.0 * smallchol.lane_sum(dt * mask))
        dev0s.append(2.0 * smallchol.lane_sum(dt0 * mask))
    return torch.stack(devs, dim=1), torch.stack(dev0s, dim=1)


@pytest.mark.parametrize("code", [glmfit.LINK_LOGIT, glmfit.LINK_PROBIT, glmfit.LINK_POISSON])
def test_fused_final_pass_has_the_bits_of_the_plain_deviances(code):
    rs = np.random.RandomState(20 + code)
    sims, max_n, p = 6, 90, 3
    X = rs.standard_normal((sims, max_n, p + 1))
    X[..., 0] = 1.0
    eta = X[..., :p] @ np.array([0.3, 0.5, -0.4])
    if code == glmfit.LINK_POISSON:
        y = rs.poisson(np.exp(eta))
    else:
        y = rs.uniform(size=eta.shape) < 1.0 / (1.0 + np.exp(-eta))
    X32 = torch.as_tensor(X, dtype=torch.float32)
    y32 = torch.as_tensor(y, dtype=torch.float32)
    fit, grid = [0, 1, 2], [33, 64, 90]
    colmask = torch.ones((len(grid), p), dtype=torch.float64)
    colmask[1, 2] = 0.0
    beta0 = torch.zeros((sims, len(grid), p), dtype=torch.float64)
    beta, _, _, dev, dev0, ybar = glmfit.glm_irls_plain(code, X32, y32, fit, grid, beta0, colmask)
    got_dev, got_dev0 = _fused_deviances(code, X32, y32, fit, grid, beta, colmask, ybar)
    assert_same_bits(got_dev, dev)
    assert_same_bits(got_dev0, dev0)
