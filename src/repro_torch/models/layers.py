"""Shared neural building blocks (the port of ``repro.models.layers``)."""

from __future__ import annotations

import math

import torch
from torch import Tensor


def trunc_normal(generator: torch.Generator, shape: tuple, fan_in: int, dtype,
                 device=None) -> Tensor:
    """Truncated-normal init with 1/sqrt(fan_in) scale, cut at ±3 std.

    Inverse-CDF draw: uniforms between Φ(-3) and Φ(3), through erfinv. The
    numbers differ from ``jax.random.truncated_normal``'s; the distribution
    is the same.
    """
    std = fan_in ** -0.5
    lo = 0.5 * (1.0 + math.erf(-3.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    z = torch.erfinv(u.mul_(2.0 * (1.0 - 2.0 * lo)).add_(2.0 * lo - 1.0))
    z.mul_(math.sqrt(2.0)).clamp_(-3.0, 3.0)
    return z.mul_(std).to(dtype)


def rms_norm(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    """RMSNorm in fp32 statistics (bf16-safe), cast back to input dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)
