"""Gaussian-copula marginal transforms, elementwise f32.

The slice ports the static-code path for the normal and binary marginals
(``mcpower_tpu.engine.marginals.apply_marginal_static``). A binary column is
1 in the high-z tail (u >= 1 - p) so the marginal is monotone in the latent
z; the column is 0/1, not centered.
"""

from __future__ import annotations

import numpy as np
import torch

from . import rng
from .spec import DIST_BINARY, DIST_NORMAL


def apply_marginal_static(z: torch.Tensor, code: int, param) -> torch.Tensor:
    """Transform a latent-normal f32 column by the static marginal ``code``.

    ``param`` is the column's f32 parameter (binary p).
    """
    z = z.to(torch.float32)
    if code == DIST_NORMAL:
        return z
    if code == DIST_BINARY:
        u = rng.norm_cdf(z)
        # 1.0 - p in f32, as the reference subtracts from an f32 scalar
        threshold = float(np.float32(1.0) - np.float32(param))
        return (u >= threshold).to(torch.float32)
    raise NotImplementedError(
        f"marginal code {code} is not ported yet (ROADMAP A10: the skewed, "
        "high-kurtosis and uniform marginals)"
    )
