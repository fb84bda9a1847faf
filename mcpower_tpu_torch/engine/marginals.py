"""Gaussian-copula marginal transforms, elementwise f32.

The port of ``mcpower_tpu.engine.marginals``: a correlated standard normal
z is pushed through u = Phi(z) and the target marginal's quantile function.

* binary: 1 in the high-z tail (u >= 1 - p), so the marginal is monotone in
  the latent z; the column is 0/1, not centered;
* right/left skewed: tail-censored standardized Exp(1), e = min(-ln Phi(-z),
  CAP) (left: -ln Phi(z), sign flipped), standardized by the censored
  moments;
* high kurtosis: the standardized t(3) quantile, by six Newton steps on the
  closed-form t(3) CDF from a seeded start;
* uniform: U(-sqrt 3, sqrt 3).

Every operation is the reference's, in its order and in f32, as the
reference computes it op by op. Where the reference divides by a constant,
the port divides by a 0-dim tensor (:func:`const`): torch turns a division
by a Python number on the card, and ``number / tensor`` everywhere, into a
product with a reciprocal, which rounds differently.
"""

from __future__ import annotations

import numpy as np
import torch

from . import rng
from .spec import (
    DIST_BINARY,
    DIST_HIGH_KURTOSIS,
    DIST_LEFT_SKEWED,
    DIST_NORMAL,
    DIST_RIGHT_SKEWED,
    DIST_UNIFORM,
)

SQRT3 = 1.7320508075688772

# Censored-Exp(1) standardization constants (the reference's).
EXP_CAP = 6.95925599364711
EXP_CENSORED_MEAN = 0.9990501970288289
EXP_CENSORED_STD = 0.9933676327697134

_INV_SQRT3 = 1.0 / SQRT3
_PI = 3.141592653589793


def f32(x) -> float:
    """A Python number rounded to f32, as JAX rounds a weakly typed one."""
    return float(np.float32(x))


def const(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-dim tensor of ``like``'s dtype and device."""
    return torch.full((), x, dtype=like.dtype, device=like.device)


def t3_cdf(t: torch.Tensor) -> torch.Tensor:
    """Student-t CDF with 3 df: x = t / sqrt 3, F = 1/2 + (x / (1 + x^2) +
    atan x) / pi."""
    x = t * f32(_INV_SQRT3)
    return 0.5 + (x / (1.0 + x * x) + torch.atan(x)) / const(_PI, t)


def t3_pdf(t: torch.Tensor) -> torch.Tensor:
    x2 = (t * t) / const(3.0, t)
    d = 1.0 + x2
    return const(2.0 / (_PI * SQRT3), t) / (d * d)


def t3_ppf(u: torch.Tensor) -> torch.Tensor:
    """t(3) quantile: the normal quantile inflated by the t correction in
    the centre, the power-law tail inversion 1 - F(t) ~ (2 sqrt 3 / pi)
    t^-3 where |z| > 2.2, then six Newton steps on :func:`t3_cdf`."""
    z = rng.norm_ppf_f32(u)
    central = z * (1.0 + (z * z + 1.0) / const(12.0, z))
    lo = torch.clamp(torch.minimum(u, 1.0 - u), f32(1e-30), 1.0)
    tail_mag = torch.pow(const(2.0 * SQRT3 / _PI, u) / lo, const(1.0 / 3.0, u))
    t = torch.where(torch.abs(z) > 2.2, torch.sign(z) * tail_mag, central)
    for _ in range(6):
        err = t3_cdf(t) - u
        t = t - err / torch.clamp(t3_pdf(t), min=f32(1e-30))
    return t


def _candidates(z: torch.Tensor, codes, param) -> dict:
    """``{code: transformed column}`` for each marginal code in ``codes``."""
    out = {}
    u = rng.norm_cdf(z) if set(codes) - {DIST_NORMAL, DIST_RIGHT_SKEWED} else None
    cap, m, s = f32(EXP_CAP), f32(EXP_CENSORED_MEAN), const(EXP_CENSORED_STD, z)
    for code in codes:
        if code == DIST_NORMAL:
            out[code] = z
        elif code == DIST_BINARY:
            # 1.0 - p in f32, as the reference subtracts from an f32 scalar
            threshold = float(np.float32(1.0) - np.float32(param))
            out[code] = (u >= threshold).to(torch.float32)
        elif code == DIST_RIGHT_SKEWED:
            # -ln Phi(-z), through Phi(-z) for accuracy in the tail
            e = torch.clamp(-torch.log(torch.clamp(rng.norm_cdf(-z), min=f32(1e-30))), max=cap)
            out[code] = (e - m) / s
        elif code == DIST_LEFT_SKEWED:
            e = torch.clamp(-torch.log(torch.clamp(u, min=f32(1e-30))), max=cap)
            out[code] = (m - e) / s
        elif code == DIST_HIGH_KURTOSIS:
            uc = torch.clamp(u, f32(1e-7), f32(1.0 - 1e-7))
            out[code] = t3_ppf(uc) * f32(_INV_SQRT3)
        elif code == DIST_UNIFORM:
            out[code] = (2.0 * u - 1.0) * f32(SQRT3)
        else:
            raise ValueError(f"unknown marginal code {code}")
    return out


def apply_marginal_static(z: torch.Tensor, code: int, param) -> torch.Tensor:
    """Transform a latent-normal f32 column by the static marginal ``code``;
    ``param`` is the column's f32 parameter (binary p)."""
    z = z.to(torch.float32)
    return _candidates(z, (code,), param)[code]


def apply_marginal(z: torch.Tensor, code: torch.Tensor, param, codes) -> torch.Tensor:
    """Transform a latent-normal f32 column ``z (sims, rows)`` by a marginal
    code per sim, ``code (sims,)``, as the reference's ``apply_marginal``
    selects among every candidate. ``codes`` lists the codes ``code`` can
    hold; only their candidates are computed, which selects the same
    values. A code outside the reference's six keeps z."""
    z = z.to(torch.float32)
    out = z
    six = (DIST_NORMAL, DIST_BINARY, DIST_RIGHT_SKEWED, DIST_LEFT_SKEWED, DIST_HIGH_KURTOSIS,
           DIST_UNIFORM)
    for c, v in _candidates(z, sorted(set(codes) & set(six)), param).items():
        out = torch.where((code == c)[:, None], v, out)
    return out
