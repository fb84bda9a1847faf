"""Counter-addressed Philox4x32-10, the port's explicit generator.

The reproducibility contract of ``mcpower_tpu.engine.rng``, bit for bit:
every value is addressed by ``(base_seed, sim_id, stream_class, column,
row)``. The word at ``(class, column, row)`` is output word ``row & 3`` of the
cipher at counter ``(row >> 2, column, class, 0xA5A5A5A5)`` under the per-sim
key; a normal is the one-tail f32 Acklam inverse CDF of the open uniform
``(w + 0.5) * 2^-32``. ``torch.Generator`` gives other bits and appears
nowhere on the path.

Two forms of the same streams:

* the plain PyTorch functions (``philox4x32`` ... ``normal_fill``) on int64
  lanes holding uint32 values. PyTorch's CPU ``uint32`` tensors have no add
  or right shift, and an int64 product of two 32-bit words overflows, so
  ``_mul_hilo`` splits one factor into 16-bit halves and every sum is masked
  back to 32 bits;
* :func:`fill_streams`, the batched fill the generation path calls: for a
  CUDA tensor it launches kernel K1 (``csrc/philox_fill.cu``), one launch
  per MAX_STREAMS streams; for a CPU tensor it runs :func:`fill_streams_plain`.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from . import kernels

_MASK = 0xFFFFFFFF
_M0 = 0xD2511F53
_M1 = 0xCD9E8D57
_W0 = 0x9E3779B9  # golden ratio
_W1 = 0xBB67AE85  # sqrt(3) - 1

CLASS_XNORM = 0
CLASS_RESID = 1
CLASS_FACTOR = 2
CLASS_CLUSTER = 3
CLASS_HET = 4
CLASS_SCENARIO = 5
CLASS_BOOT = 6
CLASS_SIMKEY = 7

TAG = 0xA5A5A5A5  # fourth counter word of every planar stream


def _u32(x, like: torch.Tensor = None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _MASK
    device = like.device if like is not None else None
    return torch.as_tensor(int(x) & _MASK, dtype=torch.int64, device=device)


def _mul_hilo(m: int, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of the 64-bit product m * c, on int64 lanes.

    With m = mh * 2^16 + ml: t = c * ml and u = c * mh stay below 2^48, and
    the product is u * 2^16 + t.
    """
    t = c * (m & 0xFFFF)
    u = c * (m >> 16)
    hi = (u + (t >> 16)) >> 16
    lo = ((u << 16) + t) & _MASK
    return hi, lo


def philox4x32(c0, c1, c2, c3, k0, k1, rounds: int = 10):
    """Philox4x32 block cipher on int64 lanes holding uint32 values.

    Arguments are tensors or Python ints of one broadcastable shape; returns
    four int64 tensors with values in [0, 2^32).
    """
    like = next((v for v in (c0, c1, c2, c3, k0, k1) if isinstance(v, torch.Tensor)), None)
    c0, c1, c2, c3, k0, k1 = (_u32(v, like) for v in (c0, c1, c2, c3, k0, k1))
    for r in range(rounds):
        if r > 0:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mul_hilo(_M0, c0)
        hi1, lo1 = _mul_hilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def batch_key(seed_lo: int, seed_hi: int, sim_ids: torch.Tensor):
    """The key ``run_one_sim`` derives: counter ``(sim_id, 0, CLASS_SIMKEY,
    0)`` under the 64-bit base seed split into ``(seed_lo, seed_hi)``."""
    k0, k1, _, _ = philox4x32(sim_ids, 0, CLASS_SIMKEY, 0, seed_lo, seed_hi)
    return k0, k1


def sim_key(base_seed, sim_id):
    """Per-sim key ``philox((sim_lo, sim_hi, CLASS_SIMKEY, 0), (seed_lo,
    seed_hi))[:2]``. As in the reference, both inputs are taken as uint32,
    so the high words are 0."""
    return batch_key(base_seed, 0, sim_id)


def _block_words(key, stream_class: int, column: int, blocks: torch.Tensor):
    k0, k1 = key
    return philox4x32(blocks, column, stream_class, TAG, k0, k1)


def raw_words(key, stream_class: int, column: int, rows: torch.Tensor):
    """One word per row (any row tensor); the lane-select twin of fill_raw."""
    rows = _u32(rows)
    w = _block_words(key, stream_class, column, rows >> 2)
    lane = (rows & 3).expand(w[0].shape).unsqueeze(-1)
    return torch.stack(w, dim=-1).gather(-1, lane).squeeze(-1)


def fill_raw(key, stream_class: int, column: int, start: int, stop: int):
    """Words for rows ``[start, stop)``, one cipher call per 4-row block.

    ``key`` is a ``(k0, k1)`` pair of tensors of shape ``(...)``; returns
    ``(..., stop - start)`` int64.
    """
    k0, k1 = key
    b0 = start >> 2
    b1 = ((stop - 1) >> 2) + 1 if stop > start else b0
    blocks = torch.arange(b0, b1, dtype=torch.int64, device=k0.device)
    key_b = (k0.unsqueeze(-1), k1.unsqueeze(-1))
    w = _block_words(key_b, stream_class, column, blocks)
    words = torch.stack(w, dim=-1).reshape(*w[0].shape[:-1], -1)
    off = start - 4 * b0
    return words[..., off : off + (stop - start)]


_INV_2POW24 = float(np.float32(1.0 / (1 << 24)))
_INV_2POW32 = float(np.float32(1.0 / 4294967296.0))


def u32_to_uniform(w: torch.Tensor) -> torch.Tensor:
    """uint32 -> float32 uniform in [0, 1): top 24 bits scaled by 2^-24."""
    return (w >> 8).to(torch.float32) * _INV_2POW24


def u32_to_open_uniform(w: torch.Tensor) -> torch.Tensor:
    """uint32 -> float32 uniform in (0, 1): (w + 0.5) / 2^32.

    int64 -> float32 rounds to nearest even, as XLA's u32 -> f32 convert.
    """
    return (w.to(torch.float32) + 0.5) * _INV_2POW32


# Acklam's inverse normal CDF coefficients (the reference's doubles). Each is
# rounded to f32 once here, as ``jnp.asarray(v, float32)`` rounds it, so the
# arithmetic below is f32 throughout.
def _f32(vals):
    return [float(np.float32(v)) for v in vals]


_ACKLAM_A = _f32((
    -3.969683028665376e01,
    2.209460984245205e02,
    -2.759285104469687e02,
    1.383577518672690e02,
    -3.066479806614716e01,
    2.506628277459239e00,
))
_ACKLAM_B = _f32((
    -5.447609879822406e01,
    1.615858368580409e02,
    -1.556989798598866e02,
    6.680131188771972e01,
    -1.328068155288572e01,
))
_ACKLAM_C = _f32((
    -7.784894002430293e-03,
    -3.223964580411365e-01,
    -2.400758277161838e00,
    -2.549732539343734e00,
    4.374664141464968e00,
    2.938163982698783e00,
))
_ACKLAM_D = _f32((
    7.784695709041462e-03,
    3.224671290700398e-01,
    2.445134137142996e00,
    3.754408661907416e00,
))
# The reference compares f32 lanes against the Python floats 0.02425 and
# 1.0 - 0.02425, which JAX rounds to f32 as weak types.
_P_LOW = float(np.float32(0.02425))
_P_HIGH = float(np.float32(1.0 - 0.02425))
_TINY = float(np.float32(1e-38))
_TOP = float(np.float32(1.0 - 6e-8))


def norm_ppf_f32(p: torch.Tensor) -> torch.Tensor:
    """One-tail f32 Acklam inverse normal CDF, operation for operation as
    ``mcpower_tpu.engine.rng.norm_ppf(p, float32)``."""
    a, b, c, d = _ACKLAM_A, _ACKLAM_B, _ACKLAM_C, _ACKLAM_D
    pc = p.to(torch.float32).clamp(_TINY, _TOP)
    lower = pc < 0.5
    q = torch.where(lower, pc, 1.0 - pc)
    s = torch.sqrt(-2.0 * torch.log(q))
    num_t = ((((c[0] * s + c[1]) * s + c[2]) * s + c[3]) * s + c[4]) * s + c[5]
    den_t = (((d[0] * s + d[1]) * s + d[2]) * s + d[3]) * s + 1.0
    t = num_t / den_t
    tail = torch.where(lower, t, -t)
    qq = pc - 0.5
    r = qq * qq
    num_c = ((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]
    den_c = (((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]
    mid = qq * num_c / (den_c * r + 1.0)
    in_tail = (pc < _P_LOW) | (pc > _P_HIGH)
    return torch.where(in_tail, tail, mid)


def normal_fill(key, stream_class: int, column: int, start: int, stop: int):
    """f32 standard normals for rows ``[start, stop)`` of one stream."""
    return norm_ppf_f32(u32_to_open_uniform(fill_raw(key, stream_class, column, start, stop)))


_INV_SQRT2 = 0.7071067811865476


def norm_cdf(z: torch.Tensor) -> torch.Tensor:
    """Standard normal CDF, 0.5 * (1 + erf(z / sqrt 2)), in z's dtype."""
    return 0.5 * (1.0 + torch.erf(z * _INV_SQRT2))


# ---------------------------------------------------------------------------
# Batched stream fill: kernel K1 and its plain version.
# ---------------------------------------------------------------------------

MODE_WORDS, MODE_OPEN_UNIFORM, MODE_NORMAL = 0, 1, 2
MAX_STREAMS = 32


def _check_streams(streams: Sequence[Tuple[int, int, int]], limit: int = None) -> int:
    if not streams or (limit and len(streams) > limit):
        raise ValueError(f"fill_streams takes 1..{limit or 'any'} streams, got {len(streams)}")
    for cls, col, rows in streams:
        if not (0 <= cls and 0 <= col <= _MASK and 0 < rows < 2**31):
            raise ValueError(f"bad stream (class, column, rows) = {(cls, col, rows)}")
    return max(r for _, _, r in streams)


def fill_streams_plain(seed_lo: int, seed_hi: int, sim_ids: torch.Tensor, streams, mode: int):
    """Rows ``[0, rows)`` of each ``(class, column, rows)`` stream for each
    sim, as ``(n_sims, n_streams, max_rows)``; rows past a stream's own
    length are 0. ``mode`` picks raw words (int64), open uniforms or
    normals (f32)."""
    max_rows = _check_streams(streams)
    key = batch_key(seed_lo, seed_hi, sim_ids)
    planes = []
    for cls, col, rows in streams:
        w = fill_raw(key, cls, col, 0, rows)
        if mode == MODE_OPEN_UNIFORM:
            w = u32_to_open_uniform(w)
        elif mode == MODE_NORMAL:
            w = norm_ppf_f32(u32_to_open_uniform(w))
        elif mode != MODE_WORDS:
            raise ValueError(f"unknown fill mode {mode}")
        planes.append(torch.nn.functional.pad(w, (0, max_rows - rows)))
    return torch.stack(planes, dim=1)


_FILL_ARGS = [
    ctypes.c_void_p,  # out (n_sims, n_streams, max_rows) 4-byte words
    ctypes.c_void_p,  # sim ids, int64 (n_sims,)
    ctypes.c_int,  # n_sims
    ctypes.c_uint32,  # seed_lo
    ctypes.c_uint32,  # seed_hi
    ctypes.POINTER(ctypes.c_int),  # stream table: class, column, rows per stream
    ctypes.c_int,  # n_streams
    ctypes.c_int,  # max_rows
    ctypes.c_int,  # mode
    ctypes.c_void_p,  # cudaStream_t
]


def fill_in_launches(fill, seed_lo: int, seed_hi: int, sim_ids: torch.Tensor, streams,
                     mode: int):
    """``fill`` of the streams in parts of at most MAX_STREAMS, joined along
    the stream axis with every part's rows padded to the longest stream:
    the same tensor as one fill of them all."""
    streams = list(streams)
    _check_streams(streams)
    if len(streams) <= MAX_STREAMS:
        return fill(seed_lo, seed_hi, sim_ids, streams, mode)
    max_rows = max(r for _, _, r in streams)
    parts = [fill(seed_lo, seed_hi, sim_ids, streams[i : i + MAX_STREAMS], mode)
             for i in range(0, len(streams), MAX_STREAMS)]
    return torch.cat([torch.nn.functional.pad(z, (0, max_rows - z.shape[-1])) for z in parts],
                     dim=1)


def fill_streams_kernel(seed_lo: int, seed_hi: int, sim_ids: torch.Tensor, streams, mode: int):
    """Kernel K1 (``csrc/philox_fill.cu``): the same fill on the card, one
    launch per MAX_STREAMS streams (the stream table K1 holds)."""
    return fill_in_launches(_k1_launch, seed_lo, seed_hi, sim_ids, streams, mode)


def _k1_launch(seed_lo: int, seed_hi: int, sim_ids: torch.Tensor, streams, mode: int):
    max_rows = _check_streams(streams, MAX_STREAMS)
    if mode not in (MODE_WORDS, MODE_OPEN_UNIFORM, MODE_NORMAL):
        raise ValueError(f"unknown fill mode {mode}")
    sim_ids = sim_ids.to(torch.int64).contiguous()
    n_sims = sim_ids.shape[0]
    dtype = torch.int32 if mode == MODE_WORDS else torch.float32
    out = torch.empty((n_sims, len(streams), max_rows), dtype=dtype, device=sim_ids.device)
    kernels.require_cuda("philox_fill", sim_ids, out)
    if n_sims == 0:
        return out.to(torch.int64) if mode == MODE_WORDS else out
    table = (ctypes.c_int * (3 * len(streams)))(
        *[int(np.uint32(v).view(np.int32)) for s in streams for v in s]
    )
    k = kernels.KERNELS["philox_fill"]
    fn = k.fn("mcp_philox_fill", _FILL_ARGS)
    k.check(
        fn(
            kernels.ptr(out), kernels.ptr(sim_ids), n_sims,
            seed_lo & _MASK, seed_hi & _MASK, table, len(streams), max_rows,
            mode, kernels.stream_of(out),
        )
    )
    if mode == MODE_WORDS:
        return out.to(torch.int64) & _MASK
    return out


def fill_streams(seed_lo: int, seed_hi: int, sim_ids: torch.Tensor, streams, mode: int = MODE_NORMAL):
    """K1 for a CUDA ``sim_ids``, the plain version for a CPU one."""
    if sim_ids.is_cuda:
        return fill_streams_kernel(seed_lo, seed_hi, sim_ids, streams, mode)
    if sim_ids.device.type != "cpu":
        raise ValueError(f"fill_streams: no kernel for device {sim_ids.device}")
    return fill_streams_plain(seed_lo, seed_hi, sim_ids, streams, mode)
