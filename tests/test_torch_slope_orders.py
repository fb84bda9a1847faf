"""Kernel K9's orders of operations (``csrc/slope_reml.cu``, the random-slope
REML fit), restated in torch and held to the plain version's, bit for bit.
No card and no JAX: each restatement is compared with the port's own plain
functions on the CPU.

1. The lazy candidate schedule: an iteration evaluates the reflection,
   then only the one candidate the selection reads (``nm_need``, the
   expansion, the outside or the inside contraction, or none), then picks
   (``nm_pick``). Against ``optim.nelder_mead`` with all four candidates, on
   the f32 ``slope_deviance`` of 64 cells at q = 2 and 3: the same theta,
   bit for bit (the packed form's schedule). The schedule is handed no
   other value (its second value is NaN where it needs none). Among the
   cells: a null slope, which the
   f64 probes then pin, and a cell whose deviance is not finite anywhere
   (every point SENTINEL32: ties the stable sort keeps in order).
2. The pair form's fold: 16 lanes each take a cluster, then lanes 0-7 add
   their own term and lane l + 8's in turn to a zero, round after round of
   16 clusters, then the 4, 2, 1 tree (the kernel's fold is written for any
   multiple of 8 lanes: 32 too); and the packed and quad forms' 8-lane walk.
   Against ``mixedfit._cluster_lane_sum`` with -0.0 terms, at m = 7, 20, 30
   and 33.
3. The centroid and the candidates one coordinate at a time from an
   insertion-sorted order (``nm_sort``, ``nm_candidate_at``) against
   ``optim._candidates``, ties included.
4. The f32 solves' division ``div_by``: q = a r (r = 1 / b rounded), then
   two fma corrections by the remainder a - b q, a zero a taking a r; each
   rounding restated in exact rationals and held to the IEEE division's
   quotient over random pairs in [2^-40, 2^41), signed zeros included.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from mcpower_tpu_torch.engine import mixedfit, optim

CELLS = 64
SENTINEL32 = mixedfit.SENTINEL32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # The tensors here are small: one thread is faster and steadier than
    # many on a loaded machine, and keeps torch's CPU log off the
    # multi-threaded first call that has returned values off in the last
    # digits. The worker's setting is restored afterwards.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _slope_stats(q: int, seed: int):
    """K2's slope-mode statistics of CELLS cells, 20 clusters of 12 rows, p =
    q (an intercept and q - 1 normal predictors, each with a random slope),
    in f64: the first quarter of the cells with a null slope on the first
    predictor, the last cell's y'y 0 (its rss negative: no finite deviance)."""
    rng = np.random.default_rng(seed)
    m, rows, p = 20, 12, q
    X = np.concatenate([np.ones((CELLS, m, rows, 1)),
                        rng.normal(size=(CELLS, m, rows, p - 1))], axis=-1)
    sd = np.array([0.5] + [0.3] * (q - 1))
    sd = np.broadcast_to(sd, (CELLS, q)).copy()
    sd[: CELLS // 4, 1] = 0.0
    u = rng.normal(size=(CELLS, m, q)) * sd[:, None, :]
    y = (X @ np.linspace(0.2, 0.5, p)[:, None])[..., 0] + np.einsum("cmrq,cmq->cmr", X, u)
    y = y + rng.normal(size=y.shape)
    G = np.einsum("cmri,cmrj->cmij", X, X)
    A = G.copy()  # Z = X here
    b = np.einsum("cmri,cmr->cmi", X, y)
    Xf, yf = X.reshape(CELLS, m * rows, p), y.reshape(CELLS, m * rows)
    xtx = np.einsum("cri,crj->cij", Xf, Xf)
    xty = np.einsum("cri,cr->ci", Xf, yf)
    yty = np.einsum("cr,cr->c", yf, yf)
    yty[-1] = 0.0
    n = np.full(CELLS, float(m * rows))
    return [torch.as_tensor(v) for v in (G, A, b, xtx, xty, yty, n)]


def _start(q: int):
    taus = np.array([0.5] + [0.3] * (q - 1))
    D = np.outer(taus, taus) * (0.7 * np.eye(q) + 0.3)
    L0 = np.linalg.cholesky(D + 1e-10 * np.eye(q))
    theta0 = np.concatenate([L0[j:, j] for j in range(q)])
    lower = np.full(theta0.shape, -np.inf)
    lower[mixedfit.vech_diagonal(q)] = 0.0
    return torch.as_tensor(theta0), torch.as_tensor(lower)


def _dev32(stats):
    st32 = [v.to(torch.float32) for v in stats]

    def f(th):
        dv = mixedfit.slope_deviance(th.to(torch.float32), *st32)
        return torch.where(torch.isfinite(dv), dv, torch.full_like(dv, SENTINEL32)).double()
    return f


def _need(fr, fvals):
    """nm_need: 1 expansion, 0 none, 2 outside, 3 inside contraction."""
    return torch.where(fr < fvals[:, 0], 1, torch.where(
        fr < fvals[:, -2], 0, torch.where(fr < fvals[:, -1], 2, 3)))


def _pick(need, fr, f2):
    """nm_pick: the index nm_select_and_replace takes once the needed
    candidate's value f2 is known (f2 unread where need is 0 or 3)."""
    return torch.where(need == 1, torch.where(f2 < fr, 1, 0),
                       torch.where(need == 2, torch.where(f2 <= fr, 2, 0),
                                   torch.where(need == 3, 3, 0)))


def _lazy_nelder_mead(f, x0, iters, init_step, lower):
    """optim.nelder_mead as K9's packed form runs it. Every candidate is
    evaluated in one call, as the plain version's are (so both see the same
    f32 values whatever the batch), but the schedule is handed only the
    reflection's value and the one it needs (NaN where it needs none).
    Returns (theta, evaluations a cell)."""
    cells, d = x0.shape
    rows = torch.arange(cells)
    verts = optim._initial(x0, init_step, lower)
    fvals = f(verts)
    evals = torch.full((cells,), d + 1)
    for _ in range(iters):
        verts, fvals, cands = optim._candidates(verts, fvals, lower)
        fc = f(cands)
        fr = fc[:, 0]
        need = _need(fr, fvals)
        f2 = torch.where(need == 0, torch.nan, fc[rows, need])
        idx = _pick(need, fr, f2)
        evals = evals + torch.where(need == 0, 1, 2)
        verts, fvals = verts.clone(), fvals.clone()
        verts[:, -1] = cands[rows, idx]
        fvals[:, -1] = torch.where(idx == 0, fr, f2)
    return optim._best(verts, fvals)[0], evals


@pytest.mark.parametrize("q,seed", [(2, 9), (3, 12)])  # seeds whose null slope pins
def test_lazy_schedule_gives_the_four_candidate_search_bit_for_bit(q, seed):
    stats = _slope_stats(q, seed)
    theta0, lower = _start(q)
    f = _dev32(stats)
    x0 = theta0.expand(CELLS, -1)
    want, _ = optim.nelder_mead(f, x0, iters=mixedfit.SLOPE_NM_ITERS,
                                init_step=mixedfit.SLOPE_NM_STEP, lower=lower)
    got, evals = _lazy_nelder_mead(f, x0, mixedfit.SLOPE_NM_ITERS, mixedfit.SLOPE_NM_STEP, lower)
    assert torch.equal(got, want)
    d = q * (q + 1) // 2
    assert bool((evals < d + 1 + 4 * mixedfit.SLOPE_NM_ITERS).all())
    assert bool((evals >= d + 1 + mixedfit.SLOPE_NM_ITERS).all())
    # the cases the test is for: a cell with no finite deviance, and a null
    # slope that the f64 probes pin at the search's theta
    assert bool((f(want[:, None])[-1] == SENTINEL32).all())
    G, A, b, xtx, xty, yty, n = stats
    out = mixedfit.slope_reml_plain(G[:, None], A[:, None], b[:, None], xtx[:, None],
                                    xty[:, None], yty[:, None], n[:1], theta0, lower,
                                    theta=got[:, None])
    pinned = out[5][:, 0]
    assert bool(pinned[: CELLS // 4, 1].any())


def _fold(v, lanes):
    """The sums over the last axis (clusters) on ``lanes`` lanes: rounds of
    ``lanes`` clusters, lane l < 8 adding its own term, then lanes l + 8,
    l + 16, ...'s, to an accumulator that starts at zero; then the 4, 2, 1
    tree."""
    m = v.shape[-1]
    acc = [torch.zeros_like(v[..., 0]) for _ in range(8)]
    for c0 in range(0, m, lanes):
        lane = [v[..., c0 + j] if c0 + j < m else torch.zeros_like(v[..., 0])
                for j in range(lanes)]
        for l in range(8):
            for k in range(lanes // 8):
                acc[l] = acc[l] + lane[l + 8 * k]
    return _tree(acc)


def _walk8(v):
    """The packed form's sums: lane l adds clusters l, l + 8, ... below m to
    a zero in turn, then the 4, 2, 1 tree."""
    m = v.shape[-1]
    acc = [torch.zeros_like(v[..., 0]) for _ in range(8)]
    for l in range(8):
        for c in range(l, m, 8):
            acc[l] = acc[l] + v[..., c]
    return _tree(acc)


def _tree(acc):
    half = 4
    while half:
        acc = [acc[i] + acc[i + half] for i in range(half)]
        half //= 2
    return acc[0]


@pytest.mark.parametrize("m", [7, 20, 30, 33])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lane_folds_match_the_plain_cluster_sum(m, dtype):
    rng = np.random.default_rng(m)
    v = torch.as_tensor(rng.normal(size=(256, m)) * 10.0 ** rng.integers(-3, 4, size=(256, m)),
                        dtype=dtype)
    v[:32] = -0.0  # all terms -0.0: the sums are +0.0
    v[32:64, ::3] = -0.0
    v[64:96] = torch.where(v[64:96] > 0, v[64:96], -0.0)
    v[96:128, 1:] = -v[96:128, :-1].clone()  # cancellation to exact zeros
    want = mixedfit._cluster_lane_sum(v, 1)
    for got in (_fold(v, 16), _fold(v, 32), _walk8(v)):
        assert torch.equal(got.view(torch.int64 if dtype == torch.float64 else torch.int32),
                           want.view(torch.int64 if dtype == torch.float64 else torch.int32))
    assert not bool(torch.signbit(want[:32]).any())


def _insertion_sort(fvals, ord_):
    """nm_sort: the stable insertion sort of the previous order."""
    ord_ = list(ord_)
    for i in range(1, len(ord_)):
        v, f = ord_[i], fvals[ord_[i]]
        j = i - 1
        while j >= 0 and fvals[ord_[j]] > f:
            ord_[j + 1] = ord_[j]
            j -= 1
        ord_[j + 1] = v
    return ord_


def _candidate_at(verts, ord_, lower, k):
    """nm_candidate_at: coordinate k of the four candidates."""
    d = len(ord_) - 1
    acc = verts[ord_[0], k]
    for i in range(1, d):
        acc = acc + verts[ord_[i], k]
    c = acc * (1.0 / d)
    w = verts[ord_[d], k]
    lo = lower[k]
    xr = c + 1.0 * (c - w)
    xr = torch.where(xr < lo, lo, xr)
    xe, xo, xi = c + 2.0 * (xr - c), c + 0.5 * (xr - c), c - 0.5 * (c - w)
    return [xr] + [torch.where(x < lo, lo, x) for x in (xe, xo, xi)]


@pytest.mark.parametrize("q", [2, 3, 4])
def test_candidates_one_coordinate_at_a_time(q):
    d = q * (q + 1) // 2
    rng = np.random.default_rng(100 + q)
    _, lower = _start(q)
    verts = torch.as_tensor(rng.normal(0.0, 0.5, size=(32, d + 1, d)))
    fvals = torch.as_tensor(rng.integers(0, 4, size=(32, d + 1)).astype(np.float64))
    fvals[::4] = SENTINEL32  # every value tied
    got_verts, _, got = optim._candidates(verts, fvals, lower)
    for cell in range(verts.shape[0]):
        ord_ = _insertion_sort(fvals[cell].tolist(), range(d + 1))
        assert torch.equal(got_verts[cell], verts[cell, ord_])
        for k in range(d):
            cands = _candidate_at(verts[cell], ord_, lower, k)
            for j in range(4):
                assert torch.equal(got[cell, j, k], cands[j])


def _rn32(x: Fraction, zero_sign: float = 1.0) -> np.float32:
    """x rounded to the nearest f32, ties to even (x normal in f32, or an
    exact zero, which takes ``zero_sign``'s sign)."""
    if x == 0:
        return np.float32(np.copysign(0.0, zero_sign))
    mag = abs(x)
    e = mag.numerator.bit_length() - mag.denominator.bit_length()
    while mag >= Fraction(2) ** (e + 1):
        e += 1
    while mag < Fraction(2) ** e:
        e -= 1
    scaled = mag / Fraction(2) ** (e - 23)  # in [2^23, 2^24)
    n, rem = divmod(scaled.numerator, scaled.denominator)
    if 2 * rem > scaled.denominator or (2 * rem == scaled.denominator and n % 2):
        n += 1
    return np.float32(np.copysign(float(Fraction(n) * Fraction(2) ** (e - 23)), float(x)))


def _fma32(a, b, c) -> np.float32:
    """fma(a, b, c) in f32: a b + c exact, rounded once; an exact zero sum is
    +0 unless both a b and c are -0."""
    prod_sign = np.copysign(1.0, a) * np.copysign(1.0, b)
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    neg_zero = prod_sign < 0 and a * b == 0 and c == 0 and np.signbit(c)
    return _rn32(exact, -1.0 if neg_zero else 1.0)


def _div_by(a, b, r) -> np.float32:
    """slope_reml.cu's div_by, each rounding restated."""
    if a == 0:
        return np.float32(a * r)
    q = np.float32(a * r)
    q = _fma32(r, _fma32(-b, q, a), q)
    return _fma32(r, _fma32(-b, q, a), q)


@pytest.mark.parametrize("seed", [0, 1])
def test_div_by_gives_the_ieee_quotient(seed):
    rng = np.random.default_rng(seed)
    n = 400

    def draw(signed):
        e = rng.integers(87, 168, n).astype(np.uint32)
        m = rng.integers(0, 1 << 23, n).astype(np.uint32)
        s = rng.integers(0, 2, n).astype(np.uint32) if signed else np.zeros(n, np.uint32)
        return ((s << 31) | (e << 23) | m).view(np.float32)

    a, b = draw(True), draw(False)
    a[:8] = [0.0, -0.0, 0.0, -0.0, 1.0, -1.0, 2.0 ** -40, -(2.0 ** 41 - 2.0 ** 17)]
    b[:8] = [1.0, 1.0, 3.0, 2.0 ** -40, 3.0, 3.0, 2.0 ** 40, 2.0 ** -40]
    with np.errstate(over="ignore", under="ignore"):
        for x, y in zip(a, b):
            r = np.float32(1.0) / y
            got, want = _div_by(x, y, r), x / y
            assert got.view(np.uint32) == want.view(np.uint32), (x, y, got, want)
