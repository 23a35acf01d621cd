"""Shared neural building blocks (the port of ``repro.models.layers``):
norms, MLPs, RoPE and the truncated-normal init."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import Tensor


def trunc_normal(generator: torch.Generator, shape: tuple, fan_in: int, dtype,
                 device=None) -> Tensor:
    """Truncated-normal init with 1/sqrt(fan_in) scale, cut at ±3 std.

    Inverse-CDF draw: uniforms between Φ(-3) and Φ(3), through erfinv. The
    numbers differ from ``jax.random.truncated_normal``'s; the distribution
    is the same. Every step after the draw runs in place, so an fp32 leaf
    costs one buffer of its size (a stacked expert leaf is ~19 GiB).
    """
    std = fan_in ** -0.5
    lo = 0.5 * (1.0 + math.erf(-3.0 / math.sqrt(2.0)))
    z = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    z.mul_(2.0 * (1.0 - 2.0 * lo)).add_(2.0 * lo - 1.0).erfinv_()
    z.mul_(math.sqrt(2.0)).clamp_(-3.0, 3.0)
    return z.mul_(std).to(dtype)


def rms_norm(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    """RMSNorm in fp32 statistics (bf16-safe), cast back to input dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def layer_norm(x: Tensor, scale: Tensor, bias: Tensor, eps: float) -> Tensor:
    """LayerNorm in fp32 statistics (population variance, as ``jnp.var``),
    cast back to the input dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def swiglu(x: Tensor, w_gate: Tensor, w_up: Tensor, w_down: Tensor) -> Tensor:
    """SwiGLU MLP: down( silu(x@gate) * (x@up) )."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x: Tensor, w_up: Tensor, b_up: Tensor, w_down: Tensor, b_down: Tensor) -> Tensor:
    """GELU MLP with biases; the tanh approximation, ``jax.nn.gelu``'s default."""
    return F.gelu(x @ w_up + b_up, approximate="tanh") @ w_down + b_down


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_table(positions: Tensor, head_dim: int, theta: float) -> tuple[Tensor, Tensor]:
    """(sin, cos) tables for integer ``positions`` (...,): each of shape
    positions.shape + (head_dim // 2,), fp32 angles from fp32 positions."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=positions.device),
                           exps)
    angles = positions.float()[..., None] * freq
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: Tensor, sin: Tensor, cos: Tensor) -> Tensor:
    """Rotate pairs, split-half convention (not interleaved).
    x: (..., S, H, hd); sin/cos: (..., S, half), broadcast over the heads."""
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    sin_b, cos_b = sin[..., None, :], cos[..., None, :]
    out = torch.cat([xf1 * cos_b - xf2 * sin_b, xf2 * cos_b + xf1 * sin_b], dim=-1)
    return out.to(x.dtype)
