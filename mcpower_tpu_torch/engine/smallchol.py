"""Small batched Cholesky algebra, unrolled over a static p.

The plain PyTorch versions of the reference's ``smallchol`` scalar unroll
(``mcpower_tpu/engine/smallchol.py:34-393``): every function takes
``(..., p, p)`` / ``(..., p)`` tensors with any leading batch axes and
performs the same operations in the same order (the factor multiplies by
the reciprocal pivot; the solves divide by it). Each works in its inputs'
dtype, so the GLM's f32 phase runs in f32. On the card these run inside
kernels K3, K4 and K6, whose device twins live in ``csrc/smallchol.cuh``;
here they serve CPU tensors, the tests and the plain timings.
"""

from __future__ import annotations

import torch

# Pivot-ratio rank rule min(diag L) >= EPS_RANK * max(diag L) (the
# reference's value and rationale, smallchol.py:328-336).
EPS_RANK = 1e-6


def chol(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky of (..., p, p); a zero or negative pivot gives
    inf/nan, which callers detect through finiteness checks."""
    p = A.shape[-1]
    L = [[None] * p for _ in range(p)]
    for j in range(p):
        d = A[..., j, j]
        for k in range(j):
            d = d - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(d)
        inv_d = 1.0 / L[j][j]
        for i in range(j + 1, p):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    zero = torch.zeros_like(A[..., 0, 0])
    return torch.stack(
        [torch.stack([L[i][j] if j <= i else zero for j in range(p)], dim=-1) for i in range(p)],
        dim=-2,
    )


def solve_lower(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L y = b (forward substitution), b (..., p)."""
    p = L.shape[-1]
    y = []
    for i in range(p):
        s = b[..., i]
        for k in range(i):
            s = s - L[..., i, k] * y[k]
        y.append(s / L[..., i, i])
    return torch.stack(y, dim=-1)


def solve_upper_t(L: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Solve L^T x = y (back substitution with the lower factor)."""
    p = L.shape[-1]
    x = [None] * p
    for i in reversed(range(p)):
        s = y[..., i]
        for k in range(i + 1, p):
            s = s - L[..., k, i] * x[k]
        x[i] = s / L[..., i, i]
    return torch.stack(x, dim=-1)


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given A = L L^T."""
    return solve_upper_t(L, solve_lower(L, b))


def cho_inverse(L: torch.Tensor) -> torch.Tensor:
    """Full inverse of A = L L^T: p solves against the identity's columns."""
    p = L.shape[-1]
    eye = torch.eye(p, dtype=L.dtype, device=L.device)
    cols = [cho_solve(L, eye[j].expand(*L.shape[:-2], p)) for j in range(p)]
    return torch.stack(cols, dim=-1)


def logdet_from_chol(L: torch.Tensor) -> torch.Tensor:
    """log|A| = 2 sum log diag(L)."""
    return 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)


def chol_ok(L: torch.Tensor) -> torch.Tensor:
    """True where the factorization succeeded: finite, positive pivots (the
    reference's ``chol_ok``, :322)."""
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    return (torch.isfinite(d) & (d > 0.0)).all(-1)


def rank_ok(A: torch.Tensor, eps_rank: float = EPS_RANK) -> torch.Tensor:
    """Numerically full rank by the pivot ratio of chol(A) (the reference's
    ``rank_ok``, :349). Pass the UNRIDGED matrix: a 1e-10 ridge lifts an
    exactly singular pivot to ~1e-5 relative and hides it."""
    return chol_rank_ok(chol(A), eps_rank)


def chol_rank_ok(L: torch.Tensor, eps_rank: float = EPS_RANK) -> torch.Tensor:
    """Finite positive pivots and min(diag) >= eps_rank * max(diag)."""
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    return (
        (torch.isfinite(d) & (d > 0.0)).all(-1)
        & (d.amin(-1) >= eps_rank * d.amax(-1))
    )


# The row contractions of the GLM IRLS (the reference's rowmv and crossprod,
# smallchol.py:365-380) in kernel K6's order, so that K6 and its plain
# version agree bit for bit: 32 lanes each add every 32nd row to a zero in
# turn, then the lanes combine pairwise at distances 16, 8, 4, 2, 1 (K6 by
# a recursive-halving reduce-scatter over the same pairs).
LANES = 32


def lane_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, a multiple of LANES rows, in K6's order."""
    v = t.reshape(*t.shape[:-1], -1, LANES)
    acc = torch.zeros_like(v[..., 0, :])
    for r in range(v.shape[-2]):
        acc = acc + v[..., r, :]
    half = LANES // 2
    while half:
        acc = acc[..., :half] + acc[..., half:2 * half]
        half //= 2
    return acc[..., 0]


def rowmv(X: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., n, p) x (..., p) -> (..., n): per-row dot, the columns added in
    turn to a zero."""
    out = torch.zeros_like(X[..., 0])
    for k in range(X.shape[-1]):
        out = out + X[..., k] * b[..., k:k + 1]
    return out


def crossprod(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., n, p) with row weights (..., n) -> (..., p, p): X' diag(w) X,
    entry (i, j), i >= j, the lane_sum of (x_i w) x_j over rows, mirrored
    (the Cholesky reads the lower triangle). n is a multiple of LANES."""
    p = X.shape[-1]
    xw = X * w[..., None]
    A = X.new_zeros(X.shape[:-2] + (p, p))
    for i in range(p):
        for j in range(i + 1):
            A[..., i, j] = A[..., j, i] = lane_sum(xw[..., i] * X[..., j])
    return A


def colsum(X: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., n, p) x (..., n) -> (..., p): contraction over rows."""
    return (X * v[..., :, None]).sum(-2)


def wouter(c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(..., m) weights x (..., m, p) -> (..., p, p): sum_m (c_m s_m) s_m'."""
    return ((c[..., :, None, None] * s[..., :, :, None]) * s[..., :, None, :]).sum(-3)


def wvec(c: torch.Tensor, s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., m), (..., m, p), (..., m) -> (..., p): sum_m (c_m s_m) t_m."""
    return (c[..., :, None] * s * t[..., :, None]).sum(-2)


# ---------------------------------------------------------------------------
# The blocked-column family (the reference's ``*_vec`` forms, smallchol.py
# :149-305), which the reference uses from p = VEC_FROM_P and for the joint-Z
# capacitance of extra groupings at any width. Column panels of CHOL_BLOCK:
# the factor subtracts each panel's contraction with the columns before it
# once (the products added to a zero in ascending column order), then the
# rank-1 tail inside the panel in ascending column order, dividing by the
# pivot; the solves subtract one contraction a panel (ascending) and then the
# scalar tail. Each step below is vectorized over rows (and right-hand
# sides) where the reference's order allows it: every entry sees the same
# operations in the same order as the reference's sequential form, and
# kernel K11 (csrc/joint_reml.cu) repeats them entry by entry. Orders of a
# contraction differ from XLA's einsum, so the two agree to rounding.
# ---------------------------------------------------------------------------

VEC_FROM_P = 13
CHOL_BLOCK = 8


def chol_vec(A: torch.Tensor, block: int = CHOL_BLOCK) -> torch.Tensor:
    """Lower Cholesky of (..., p, p), blocked-column order."""
    p = A.shape[-1]
    L = torch.zeros_like(A)
    acc = torch.zeros_like(A)  # the panel contractions of later columns
    below = torch.arange(p, device=A.device)
    for j0 in range(0, p, block):
        j1 = min(j0 + block, p)
        S = A[..., :, j0:j1] - acc[..., :, j0:j1]
        for jj in range(j1 - j0):
            g = j0 + jj
            col = S[..., :, jj] / torch.sqrt(S[..., g, jj])[..., None]
            col = torch.where(below >= g, col, torch.zeros_like(col))
            L[..., :, g] = col
            if g + 1 < j1:  # the rank-1 tail on the panel's later columns
                S = torch.cat([S[..., :, :jj + 1], S[..., :, jj + 1:]
                               - col[..., :, None] * col[..., None, g + 1:j1]], dim=-1)
        for k in range(j0, j1):
            if j1 < p:
                acc[..., :, j1:] = acc[..., :, j1:] + L[..., :, k, None] * L[..., None, j1:, k]
    return L


def _forward_vec(L: torch.Tensor, B: torch.Tensor, block: int) -> torch.Tensor:
    """Solve L Y = B, B (..., p, r), blocked."""
    p = L.shape[-1]
    Y = torch.zeros_like(B)
    acc = torch.zeros_like(B)
    for j0 in range(0, p, block):
        j1 = min(j0 + block, p)
        R = B[..., j0:j1, :] - acc[..., j0:j1, :]
        for ii in range(j1 - j0):
            g = j0 + ii
            y = R[..., ii, :] / L[..., g, g, None]
            Y[..., g, :] = y
            if g + 1 < j1:
                R = torch.cat([R[..., :ii + 1, :], R[..., ii + 1:, :]
                               - L[..., g + 1:j1, g, None] * y[..., None, :]], dim=-2)
        for k in range(j0, j1):
            if j1 < p:
                acc[..., j1:, :] = acc[..., j1:, :] + L[..., j1:, k, None] * Y[..., k, None, :]
    return Y


def _backward_vec(L: torch.Tensor, Y: torch.Tensor, block: int) -> torch.Tensor:
    """Solve L^T X = Y, Y (..., p, r), blocked."""
    p = L.shape[-1]
    X = torch.zeros_like(Y)
    for j0 in reversed(range(0, p, block)):
        j1 = min(j0 + block, p)
        acc = torch.zeros_like(Y[..., j0:j1, :])
        for k in range(j1, p):
            acc = acc + L[..., k, j0:j1, None] * X[..., k, None, :]
        R = Y[..., j0:j1, :] - acc
        for ii in reversed(range(j1 - j0)):
            g = j0 + ii
            s = R[..., ii, :]
            for k in range(g + 1, j1):
                s = s - L[..., k, g, None] * X[..., k, :]
            X[..., g, :] = s / L[..., g, g, None]
    return X


def solve_lower_vec(L: torch.Tensor, b: torch.Tensor, block: int = CHOL_BLOCK) -> torch.Tensor:
    """Forward substitution, blocked: b (..., p)."""
    return _forward_vec(L, b[..., None], block)[..., 0]


def solve_upper_t_vec(L: torch.Tensor, y: torch.Tensor, block: int = CHOL_BLOCK) -> torch.Tensor:
    """Back substitution with the lower factor, blocked: y (..., p)."""
    return _backward_vec(L, y[..., None], block)[..., 0]


def cho_solve_vec(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given A = L L^T (blocked forms)."""
    return solve_upper_t_vec(L, solve_lower_vec(L, b))


def cho_solve_mat_vec(L: torch.Tensor, B: torch.Tensor, block: int = CHOL_BLOCK) -> torch.Tensor:
    """Solve A X = B for (..., p, r) right-hand sides (blocked forms)."""
    return _backward_vec(L, _forward_vec(L, B, block), block)


def chol_auto(A: torch.Tensor) -> torch.Tensor:
    """The reference's ``chol`` rule: the scalar order below VEC_FROM_P,
    the blocked order from it (the reference hands p > 128 to the library
    Cholesky; the port keeps the blocked order there)."""
    return chol_vec(A) if A.shape[-1] >= VEC_FROM_P else chol(A)


def cho_solve_mat_auto(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve A X = B, B (..., p, r), by the width rule of :func:`chol_auto`:
    r scalar solves below VEC_FROM_P, the blocked solves from it."""
    if L.shape[-1] >= VEC_FROM_P:
        return cho_solve_mat_vec(L, B)
    return cho_solve(L[..., None, :, :], B.transpose(-1, -2)).transpose(-1, -2)


def cho_solve_auto(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b, b (..., p), by the width rule of :func:`chol_auto`."""
    return cho_solve_vec(L, b) if L.shape[-1] >= VEC_FROM_P else cho_solve(L, b)


def cho_inverse_auto(L: torch.Tensor) -> torch.Tensor:
    """(L L^T)^-1 by the width rule: p solves against the identity."""
    p = L.shape[-1]
    eye = torch.eye(p, dtype=L.dtype, device=L.device).expand(*L.shape[:-2], p, p)
    return cho_solve_mat_auto(L, eye.contiguous())


def logdet_ordered(L: torch.Tensor) -> torch.Tensor:
    """2 sum log diag(L), the logs added in ascending order."""
    d = torch.log(torch.diagonal(L, dim1=-2, dim2=-1))
    acc = d[..., 0]
    for i in range(1, d.shape[-1]):
        acc = acc + d[..., i]
    return 2.0 * acc
