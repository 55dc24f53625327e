"""Parameter factories of the port (counterpart of ``repro.models.layers``).

Parameters are plain nested dicts of tensors.  A factory lets the same
model-construction code produce initialised tensors (``InitFactory``) or
shape-only ``meta`` tensors (``ShapeFactory``), so the two trees can never
drift apart.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


class InitFactory:
    """Creates initialised parameter tensors: the JAX package's scales and
    zero biases, drawn from an explicit CPU ``torch.Generator`` and then
    moved to ``device``, so one seed gives the same weights on every
    device.  The numbers differ from ``jax.random``'s; tests that compare
    the two packages carry the JAX weights across (``repro_torch.bridge``)."""

    def __init__(self, generator: torch.Generator, dtype: torch.dtype,
                 device):
        self.generator = generator
        self.dtype = dtype
        self.device = torch.device(device)

    def array(self, shape, *, scale: Optional[float] = None,
              mode: str = "normal"):
        if mode == "zeros":
            return torch.zeros(shape, dtype=self.dtype, device=self.device)
        if mode == "ones":
            return torch.ones(shape, dtype=self.dtype, device=self.device)
        if scale is None:
            fan_in = shape[0] if len(shape) >= 2 else max(shape[-1], 1)
            scale = 1.0 / math.sqrt(fan_in)
        t = torch.randn(shape, generator=self.generator, dtype=torch.float32)
        return (t * scale).to(dtype=self.dtype, device=self.device)


class ShapeFactory:
    """Creates ``meta`` tensors: shapes and dtypes with no storage."""

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype

    def array(self, shape, **kw):
        del kw
        return torch.empty(shape, dtype=self.dtype, device="meta")
