"""The port's blocked-column Cholesky family (``smallchol.chol_vec``,
``solve_lower_vec``, ``solve_upper_t_vec``, ``cho_solve_vec``,
``cho_solve_mat_vec``) against the reference's ``*_vec`` forms
(``mcpower_tpu/engine/smallchol.py:149-305``), and the width rule of
``chol_auto``.

The same well-conditioned f64 and f32 matrices (p = 13, 30, 70) go to both
packages. The orders agree but for the contractions inside a panel (the
port adds its products in ascending order, XLA's einsum in its own), so the
two agree to rounding: RTOL_64 (measured 3.1e-16) and RTOL_32 (measured
1.8e-7), relative to each output's largest entry. Below VEC_FROM_P ``chol_auto`` is the scalar ``chol`` bit for bit,
from it ``chol_vec``.
"""

import jax
import numpy as np
import pytest
import torch

from mcpower_tpu.engine import smallchol as ref_smallchol
from mcpower_tpu_torch.engine import smallchol

RTOL_64 = 1e-14
RTOL_32 = 1e-6
BATCH = 6


def _inputs(p, dtype, seed=0):
    rng = np.random.default_rng(seed + p)
    A = rng.standard_normal((BATCH, p, p + 3))
    A = (A @ A.transpose(0, 2, 1) / p + np.eye(p)).astype(dtype)
    return A, rng.standard_normal((BATCH, p)).astype(dtype), \
        rng.standard_normal((BATCH, p, 5)).astype(dtype)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("p", [13, 30, 70])
def test_the_blocked_family_against_the_reference(p, dtype):
    A, b, B = _inputs(p, dtype)

    @jax.jit
    def ref(A, b, B):
        L = ref_smallchol.chol_vec(A)
        return (L, ref_smallchol.solve_lower_vec(L, b), ref_smallchol.solve_upper_t_vec(L, b),
                ref_smallchol.cho_solve_vec(L, b), ref_smallchol.cho_solve_mat_vec(L, B))

    want = [np.asarray(v) for v in ref(A, b, B)]
    # every solve on the reference's own factor, so each function is held alone
    Lr = torch.as_tensor(want[0].copy())
    bt, Bt = torch.as_tensor(b), torch.as_tensor(B)
    got = [smallchol.chol_vec(torch.as_tensor(A)), smallchol.solve_lower_vec(Lr, bt),
           smallchol.solve_upper_t_vec(Lr, bt), smallchol.cho_solve_vec(Lr, bt),
           smallchol.cho_solve_mat_vec(Lr, Bt)]
    tol = RTOL_64 if dtype == np.float64 else RTOL_32
    errs = [_rel(g.numpy(), w) for g, w in zip(got, want)]
    print(f"p {p} {np.dtype(dtype).name}: relative errors {['%.1e' % e for e in errs]}")
    assert all(g.numpy().dtype == w.dtype for g, w in zip(got, want))
    assert max(errs) <= tol
    assert (np.triu(got[0].numpy(), 1) == 0).all()


@pytest.mark.parametrize("p", [4, 12, 13, 16])
def test_the_width_rule(p):
    A, b, B = _inputs(p, np.float64)
    A = torch.as_tensor(A)
    L = smallchol.chol_auto(A)
    want = smallchol.chol_vec(A) if p >= smallchol.VEC_FROM_P else smallchol.chol(A)
    assert torch.equal(L, want)
    x = smallchol.cho_solve_auto(L, torch.as_tensor(b))
    want_x = (smallchol.cho_solve_vec(L, torch.as_tensor(b)) if p >= smallchol.VEC_FROM_P
              else smallchol.cho_solve(L, torch.as_tensor(b)))
    assert torch.equal(x, want_x)
    # the column solves of cho_solve_mat_auto are the vector solves, column by column
    X = smallchol.cho_solve_mat_auto(L, torch.as_tensor(B))
    for c in range(B.shape[-1]):
        assert torch.equal(X[..., c], smallchol.cho_solve_auto(L, torch.as_tensor(B[..., c])))
    inv = smallchol.cho_inverse_auto(L)
    assert np.abs((inv @ A).numpy() - np.eye(p)).max() <= 1e-12
