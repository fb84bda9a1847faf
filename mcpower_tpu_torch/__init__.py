"""mcpower_tpu_torch: the Monte Carlo power engine on PyTorch and CUDA.

A second package beside ``mcpower_tpu`` (the JAX reference). It mirrors the
reference's layout (``engine/<module>.py``) and computes the same counts from
the same counter-addressed Philox streams. Plain tensor code is PyTorch; each
piece of device code the reference schedules by hand is a CUDA kernel for
Hopper under ``csrc/``, built with ``nvcc`` on first use and loaded with
``ctypes`` (see :mod:`mcpower_tpu_torch.engine.kernels`). The user surface
is the reference's: ``from mcpower_tpu_torch import MCPower``, with the host
layers (spec builder, contract, orchestrator, reports) copied beside the
engine.

This package never imports ``jax`` or ``mcpower_tpu``: importing the reference
turns on JAX's x64 mode and needs JAX installed, and the port has to run where
JAX is not installed.
"""

import torch

# The generation path mixes correlated predictors with an f32 product
# ``z @ L.T``; the reference computes it in full f32. TF32 would keep ~10
# mantissa bits and move every draw, so both TF32 switches stay off.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["MCPower", "engine"]


def __getattr__(name):
    # Lazy, as in the reference: ``import mcpower_tpu_torch.engine.rng``
    # stays light for kernel-only users.
    if name == "MCPower":
        from .model import MCPower

        return MCPower
    raise AttributeError(name)
