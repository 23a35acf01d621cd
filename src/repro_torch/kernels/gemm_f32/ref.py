"""The plain PyTorch version of the ``gemm_f32`` kernel: 3xTF32 emulated.

Each operand v is split as the kernel splits it: big = v rounded to TF32
(10 explicit mantissa bits) to nearest, ties away from zero
(``cvt.rna.tf32.f32``), and small = v - big, exact in fp32, rounded the same
way. A product of two TF32 values is exact in fp32, so three fp32 matmuls
(TF32 off) give small·big + big·small + big·big with fp32 sums, in another
order than the tensor cores add them. The term small·small (≈ 2^-22 of
each product) is left out, as the kernel leaves it out.
"""

from __future__ import annotations

import torch
from torch import Tensor


def tf32_rna(v: Tensor) -> Tensor:
    """fp32 ``v`` rounded to TF32, to nearest with ties away from zero: the
    bit pattern plus half a TF32 ulp, its low 13 bits cleared."""
    bits = v.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    return ((bits + 0x1000) & ~0x1FFF).to(torch.int32).view(torch.float32)


def split_tf32(v: Tensor) -> tuple[Tensor, Tensor]:
    """(big, small) with big + small = v (fp32), each a TF32 value."""
    big = tf32_rna(v)
    return big, tf32_rna(v.to(torch.float32) - big)


def gemm_f32_ref(x: Tensor, w: Tensor) -> Tensor:
    """x (..., K) @ w (K, N) as 3xTF32: fp32 out."""
    xb, xs = split_tf32(x)
    wb, ws = split_tf32(w)
    return xb @ wb + (xb @ ws + xs @ wb)
