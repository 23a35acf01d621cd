"""Plain PyTorch version of the fused GMSA dispatch score + argmin.

score[..., k, i] = a[..., k] * ( q[..., k, i] - mu[..., k, i]
                                 + vp[..., k] * sum_j r[k, i, j] * wpue[j] )
best[..., k]     = argmin_i score[..., k, i]      (lowest index on ties)

``q``/``mu`` arrive (..., K, N) — the kernel's orientation — with optional
leading Monte-Carlo run dimensions that ``a`` (and ``vp``) share; ``r`` and
``wpue`` are shared by every run. ``vp`` = V * P^k, ``wpue`` = omega ⊙ PUE.
"""

from __future__ import annotations

import torch
from torch import Tensor


def gmsa_score_ref(
    q: Tensor, mu: Tensor, a: Tensor, vp: Tensor, r: Tensor, wpue: Tensor
) -> tuple[Tensor, Tensor]:
    """Returns (scores (..., K, N) fp32, best (..., K) int32)."""
    f32 = torch.float32
    cost = torch.einsum("kij,j->ki", r.to(f32), wpue.to(f32))        # (K, N)
    scores = a.to(f32).unsqueeze(-1) * (
        q.to(f32) - mu.to(f32) + vp.to(f32).unsqueeze(-1) * cost
    )
    return scores, torch.argmin(scores, dim=-1).to(torch.int32)
