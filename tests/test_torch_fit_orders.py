"""The operation orders kernels K10 and K11 (and K12, through the shared
capacitance) follow on the card, restated in torch and held bit for bit
against the plain versions' orders on the CPU.

Kernels K10 (``csrc/glmm_slope.cu``) and K11 (``csrc/joint_reml.cu``, with
``csrc/joint_cap.cuh``) must give their plain versions' bits, so each of
their schedules must give every entry the plain version's operations in the
plain version's order. This file restates those schedules with elementwise
torch operations (one rounding each, as ``--fmad=false`` builds the kernels):

* ``joint_cap.cuh``'s factors, two columns a step: every lane reads the
  step's two pivot entries and forms the second pivot itself, each row's
  two entries follow, then the trailing (scalar) or panel (blocked)
  triangle takes both rank-1 updates, the first column's before the
  second's; held against ``smallchol.chol`` and ``smallchol.chol_vec`` on
  f32 and f64 matrices of n in 5..72;
* its forward solves, two rows a step (both rows' entries first, then the
  later rows' two updates in turn), with the backward solves as before;
  held against ``smallchol.cho_solve`` (scalar) and
  ``smallchol.cho_solve_mat_vec`` (blocked);
* K10's pass: each cluster's rows below the grid point added in row order
  (the rows past it skipped, where the plain version adds zeros), K7's
  lanes over the clusters and one butterfly whose levels take every sum
  at once; held against the sums over clusters of ``glmmfit._slope_pass``
  (its ``_Cells.seg`` and ``_Cells.lanes``) for every pass kind,
  round-robin and blocked clusters, 40 clusters (two on some lanes), f32
  and f64, q = 2 and 3. (A row phase into a row buffer was tried on the
  card and taken back; its order gave the same bits.)

No card and no JAX: the plain versions are the port's.
"""

import numpy as np
import pytest
import torch

from mcpower_tpu_torch.engine import glmmfit, smallchol
from mcpower_tpu_torch.engine.glmfit import MU_EPS, _deviance_terms, _mu_var_dmu
from mcpower_tpu_torch.engine.mixedfit import _ordered_sum

THREADS = 2
BLOCK = smallchol.CHOL_BLOCK
SIZES = (5, 6, 12, 13, 17, 25, 48, 72)
DTYPES = (torch.float32, torch.float64)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    """Run on THREADS threads, so that parallel test workers do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(threads)


def spd(n: int, dtype, batch: int = 6, seed: int = 0) -> torch.Tensor:
    """``batch`` well-conditioned SPD matrices of order n, made with numpy."""
    rng = np.random.default_rng(seed + n)
    B = rng.standard_normal((batch, n, n))
    A = B @ B.transpose(0, 2, 1) / n + np.eye(n)
    return torch.as_tensor(A, dtype=dtype)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))


# ---------------------------------------------------------------------------
# joint_cap.cuh's factors and forward solves
# ---------------------------------------------------------------------------


def chol_scalar_two(A: torch.Tensor) -> torch.Tensor:
    """chol_scalar: right-looking, multiplying by the reciprocal pivot, two
    columns a step."""
    A = A.clone()
    n = A.shape[-1]
    j = 0
    while j + 1 < n:
        k = j + 1
        piv = torch.sqrt(A[:, j, j])
        inv = 1.0 / piv
        lkj = A[:, k, j] * inv
        piv1 = torch.sqrt(A[:, k, k] - lkj * lkj)
        inv1 = 1.0 / piv1
        lij = A[:, k:, j] * inv[:, None]  # rows i >= k
        A[:, j, j], A[:, k, k] = piv, piv1
        A[:, k:, j] = lij
        A[:, k + 1:, k] = (A[:, k + 1:, k] - lij[:, 1:] * lkj[:, None]) * inv1[:, None]
        lj, lk = A[:, k + 1:, j], A[:, k + 1:, k]  # the trailing triangle's two updates
        A[:, k + 1:, k + 1:] = ((A[:, k + 1:, k + 1:] - lj[:, :, None] * lj[:, None, :])
                                - lk[:, :, None] * lk[:, None, :])
        j += 2
    if j < n:
        A[:, j, j] = torch.sqrt(A[:, j, j])
    return torch.tril(A)


def chol_blocked_two(A: torch.Tensor) -> torch.Tensor:
    """chol_blocked: each 8-column panel less its contraction with the
    columns before it (ascending, from a zero), then its columns two a step,
    dividing by the pivot."""
    A = A.clone()
    n = A.shape[-1]
    for j0 in range(0, n, BLOCK):
        j1 = min(j0 + BLOCK, n)
        if j0 > 0:
            acc = torch.zeros_like(A[:, :, j0:j1])
            for k in range(j0):
                acc = acc + A[:, :, k, None] * A[:, None, j0:j1, k]
            A[:, :, j0:j1] = A[:, :, j0:j1] - acc
        g = j0
        while g + 1 < j1:
            h = g + 1
            piv = torch.sqrt(A[:, g, g])
            lhg = A[:, h, g] / piv
            piv1 = torch.sqrt(A[:, h, h] - lhg * lhg)
            lig = A[:, g:, g] / piv[:, None]
            A[:, g:, g] = lig
            A[:, h:, h] = (A[:, h:, h] - lig[:, 1:] * lhg[:, None]) / piv1[:, None]
            if h + 1 < j1:
                lg, lh = A[:, h + 1:, g], A[:, h + 1:, h]
                A[:, h + 1:, h + 1:j1] = ((A[:, h + 1:, h + 1:j1] - lg[:, :, None] * lg[:, None, :j1 - h - 1])
                                          - lh[:, :, None] * lh[:, None, :j1 - h - 1])
            g += 2
        if g < j1:
            A[:, g:, g] = A[:, g:, g] / torch.sqrt(A[:, g, g])[:, None]
    return torch.tril(A)


def forward_two(L: torch.Tensor, B: torch.Tensor, blocked: bool) -> torch.Tensor:
    """cho_solve_auto's forward solve, two rows a step (the blocked one
    within each 8-row block, after the block's contraction with the rows
    before it)."""
    B = B.clone()
    n = L.shape[-1]
    for j0, j1 in ([(j0, min(j0 + BLOCK, n)) for j0 in range(0, n, BLOCK)] if blocked
                   else [(0, n)]):
        if blocked and j0 > 0:
            acc = torch.zeros_like(B[:, j0:j1])
            for k in range(j0):
                acc = acc + L[:, j0:j1, k, None] * B[:, None, k]
            B[:, j0:j1] = B[:, j0:j1] - acc
        g = j0
        while g + 1 < j1:
            h = g + 1
            x = B[:, g] / L[:, g, g, None]
            B[:, g] = x
            B[:, h] = (B[:, h] - L[:, h, g, None] * x) / L[:, h, h, None]
            B[:, h + 1:j1] = ((B[:, h + 1:j1] - L[:, h + 1:j1, g, None] * B[:, None, g])
                              - L[:, h + 1:j1, h, None] * B[:, None, h])
            g += 2
        if g < j1:
            B[:, g] = B[:, g] / L[:, g, g, None]
    return B


def backward(L: torch.Tensor, Y: torch.Tensor, blocked: bool) -> torch.Tensor:
    """cho_solve_auto's backward solve (unchanged): a row at a time, its
    later rows ascending; blocked, each block's contraction with the rows
    after it first."""
    X = Y.clone()
    n = L.shape[-1]
    if not blocked:
        for i in range(n - 1, -1, -1):
            s = X[:, i]
            for k in range(i + 1, n):
                s = s - L[:, k, i, None] * X[:, k]
            X[:, i] = s / L[:, i, i, None]
        return X
    for j0 in reversed(range(0, n, BLOCK)):
        j1 = min(j0 + BLOCK, n)
        acc = torch.zeros_like(X[:, j0:j1])
        for k in range(j1, n):
            acc = acc + L[:, k, j0:j1, None] * X[:, None, k]
        X[:, j0:j1] = X[:, j0:j1] - acc
        for g in range(j1 - 1, j0 - 1, -1):
            s = X[:, g]
            for k in range(g + 1, j1):
                s = s - L[:, k, g, None] * X[:, k]
            X[:, g] = s / L[:, g, g, None]
    return X


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", ("scalar", "blocked"))
def test_factor_two_columns_a_step(form, dtype, n):
    A = spd(n, dtype)
    got = (chol_scalar_two if form == "scalar" else chol_blocked_two)(A)
    want = (smallchol.chol if form == "scalar" else smallchol.chol_vec)(A)
    assert same_bits(got, want)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", ("scalar", "blocked"))
def test_solves_two_rows_a_step(form, dtype, n):
    blocked = form == "blocked"
    A = spd(n, dtype, seed=1)
    L = (smallchol.chol_vec if blocked else smallchol.chol)(A)
    rng = np.random.default_rng(n)
    B = torch.as_tensor(rng.standard_normal((A.shape[0], n, 4)), dtype=dtype)
    got = backward(L, forward_two(L, B, blocked), blocked)
    if blocked:
        want = smallchol.cho_solve_mat_vec(L, B)
    else:  # the plain version's r scalar solves
        want = smallchol.cho_solve(L[:, None], B.transpose(-1, -2)).transpose(-1, -2)
    assert same_bits(got, want)


# ---------------------------------------------------------------------------
# K10's pass: each cluster's rows in row order, then K7's lanes and one
# butterfly for every sum
# ---------------------------------------------------------------------------

SLOPE_SIMS, SLOPE_M, SLOPE_P, PERIOD = 2, 40, 2, 3
KINDS = ("step", "vstep", "tail", "mode")


def slope_case(q: int, rr: bool, dtype, seed: int = 3):
    """A small slope-GLMM launch: X (sims, max_n, P) with an intercept and
    q - 1 slope columns among P = 3, 0/1 y, 40 clusters (lanes 0-7 take two
    each), a grid point below max_n, and random Lam, beta and modes v in
    ``dtype``."""
    rng = np.random.default_rng(seed + q + 2 * rr)
    max_n = SLOPE_M * PERIOD
    X = rng.standard_normal((SLOPE_SIMS, max_n, 3))
    X[..., 0] = 1.0
    y = (rng.random((SLOPE_SIMS, max_n)) < 0.4).astype(np.float64)
    grid = [max_n - 5, max_n]
    layout = (True, SLOPE_M, SLOPE_M) if rr else (False, PERIOD, SLOPE_M)
    zcols = [1, 2][:q - 1]
    cells = glmmfit._Cells(0, torch.as_tensor(X, dtype=torch.float32),
                           torch.as_tensor(y, dtype=torch.float32), [0, 1], grid, layout, zcols)
    G = len(grid)
    lam = np.tril(rng.uniform(0.2, 0.8, (SLOPE_SIMS, G, 1, q, q)))
    Lam = torch.as_tensor(lam, dtype=dtype)
    beta = torch.as_tensor(rng.normal(0, 0.3, (SLOPE_SIMS, G, 1, SLOPE_P)), dtype=dtype)
    v = torch.as_tensor(rng.normal(0, 0.5, (SLOPE_SIMS, G, 1, SLOPE_M, q)), dtype=dtype)
    return cells, grid, Lam, beta, v


def plain_lane_sums(cells, dtype, Lam, beta, v, kind):
    """The sums over clusters ``glmmfit._slope_pass`` forms from its
    per-cluster sums (its last ``_Cells.seg``, every row added, masked ones
    as zeros), in K7's lane order (``_Cells.lanes``): (S, G, 1, terms)."""
    seen = []
    seg = cells.seg

    def spy(t):
        out = seg(t)
        seen.append(out)
        return out

    cells.seg = spy
    try:
        glmmfit._slope_pass(cells, dtype, Lam, beta, v, kind)
    finally:
        cells.seg = seg
    return cells.lanes(seen[-1])


def walk_lane_sums(cells, grid, dtype, Lam, beta, v, kind):
    """K10's order: each row's terms formed as the plain version forms them;
    each cluster's rows below the grid point added in row order to a zero
    (rows at or past it skipped, not added as zeros); lane l adds clusters l,
    l + 32, ... to a zero; then one butterfly whose levels (distances 16, 8,
    4, 2, 1) take every sum at once, each lane adding its partner's value to
    its own. Returns the same (S, G, 1, terms) as :func:`plain_lane_sums`."""
    rr, period, m = cells.rr, cells.period, cells.m
    q, p = v.shape[-1], cells.p
    X, Z, y = cells.X[dtype][:, :, None], cells.Z[dtype][:, :, None], cells.y[dtype][:, :, None]
    lam = lambda i, k: Lam[..., i, k, None]  # noqa: E731
    u = [_ordered_sum([v[..., k] * lam(i, k) for k in range(i + 1)]) for i in range(q)]
    xb = smallchol.rowmv(X, beta)
    zu = cells.per_row(u[0])
    for k in range(1, q):
        zu = zu + Z[..., k] * cells.per_row(u[k])
    eta = xb + zu
    mu, var, dmu = _mu_var_dmu(0, eta)
    w = dmu * dmu / torch.clamp(var, min=MU_EPS)
    wz = [w] + [Z[..., r] * w for r in range(1, q)]
    xs = [X[..., a].expand_as(w) for a in range(p)]
    terms = [wz[r] * Z[..., c] for r in range(q) for c in range(r + 1)]
    if kind in ("step", "mode"):
        terms += [wz[r] * xs[a] for r in range(q) for a in range(p)]
        terms += [(xs[a] * w) * xs[b] for a in range(p) for b in range(a + 1)]
    if kind in ("step", "vstep"):
        zw = eta + (y - mu) / dmu
        rz = zw if kind == "step" else zw - xb
        terms += [wz[r] * rz for r in range(q)]
    if kind == "step":
        terms += [xa * (w * zw) for xa in xs]
    if kind in ("tail", "mode"):
        terms.append(_deviance_terms(0, y.expand_as(mu), mu))
    t = torch.stack(terms, dim=-2)  # (S, G, 1, T, n)
    n_row = torch.arange(t.shape[-1])
    below = n_row < torch.as_tensor(grid)[:, None]  # (G, n)
    # each cluster's rows in row order, from a zero, skipping rows past n
    if rr:
        t, below = t.reshape(*t.shape[:-1], -1, m), below.reshape(len(grid), -1, m)
    else:
        t = t.reshape(*t.shape[:-1], m, period).transpose(-1, -2)
        below = below.reshape(len(grid), m, period).transpose(-1, -2)
    acc = torch.zeros_like(t[..., 0, :])
    for k in range(t.shape[-2]):
        acc = torch.where(below[:, None, None, k], acc + t[..., k, :], acc)
    # lane l: clusters l, l + 32, ... in turn from a zero
    lanes = torch.nn.functional.pad(acc, (0, -m % 32)).reshape(*acc.shape[:-1], -1, 32)
    part = torch.zeros_like(lanes[..., 0, :])
    for k in range(lanes.shape[-2]):
        part = part + lanes[..., k, :]
    # the butterfly's levels, every sum at once
    lane = torch.arange(32)
    for dist in (16, 8, 4, 2, 1):
        part = part + part[..., lane ^ dist]
    return part[..., 0]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("q", (2, 3))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rr", (True, False), ids=("round_robin", "blocked"))
def test_slope_walk_lane_sums(rr, dtype, q, kind):
    cells, grid, Lam, beta, v = slope_case(q, rr, dtype)
    want = plain_lane_sums(cells, dtype, Lam, beta, v, kind)
    got = walk_lane_sums(cells, grid, dtype, Lam, beta, v, kind)
    assert same_bits(got, want)
