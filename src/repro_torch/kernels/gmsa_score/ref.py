"""Plain PyTorch version of the fused GMSA dispatch score + argmin.

score[..., k, i] = a[..., k] * ( q[..., k, i] - mu[..., k, i]
                                 + vp[..., k] * sum_j r[k, i, j] * wpue[j] )
best[..., k]     = argmin_i score[..., k, i]      (lowest index on ties)

``q``/``mu`` arrive (..., K, N) — the kernel's orientation — with optional
leading Monte-Carlo run dimensions that ``a`` (and ``vp``) share; ``r`` is
(K, N, N), shared by every run, or (..., K, N, N) with q's run dimensions
(the placement controller's per-run ratios); ``wpue`` is shared. ``vp`` =
V * P^k, ``wpue`` = omega ⊙ PUE.

:func:`gmsa_score_ref` serves CPU tensors, the CPU tests and
``chip_smoke.py``'s comparisons on the card. :func:`gmsa_score_phases_ref`
is the CUDA chain's own two-phase algorithm, returning its (K, N) cost
workspace too, so that a fault on the card shows in the phase it is in. The
main path never calls it.
"""

from __future__ import annotations

import torch
from torch import Tensor


def gmsa_score_ref(
    q: Tensor, mu: Tensor, a: Tensor, vp: Tensor, r: Tensor, wpue: Tensor
) -> tuple[Tensor, Tensor]:
    """Returns (scores (..., K, N) fp32, best (..., K) int32)."""
    f32 = torch.float32
    cost = torch.einsum("...kij,j->...ki", r.to(f32), wpue.to(f32))  # ([...,] K, N)
    scores = a.to(f32).unsqueeze(-1) * (
        q.to(f32) - mu.to(f32) + vp.to(f32).unsqueeze(-1) * cost
    )
    return scores, torch.argmin(scores, dim=-1).to(torch.int32)


def gmsa_score_phases_ref(
    q: Tensor, mu: Tensor, a: Tensor, vp: Tensor, r: Tensor, wpue: Tensor
) -> tuple[Tensor, Tensor, Tensor]:
    """The chain's phases in plain PyTorch. Returns (cost fp32, scores
    (..., K, N) fp32, best (..., K) int32), the cost workspace (K, N) for a
    shared r and (runs, K, N) for a per-run r, as the chain lays it out:

    - cost = r · wpue summed in fp64 and rounded once to fp32, as the cost
      kernel accumulates it;
    - scores = a · fma(vp, cost, q − mu) and their argmin, lowest index on
      ties, as the pick kernel forms them (the fma in fp64, rounded to fp32
      once as ``fmaf`` rounds it, but for rare double roundings)."""
    f32, f64 = torch.float32, torch.float64
    cost = torch.einsum("...kij,j->...ki", r.to(f64), wpue.to(f64)).to(f32)
    d = q.to(f32) - mu.to(f32)
    inner = (vp.to(f64).unsqueeze(-1) * cost.to(f64) + d.to(f64)).to(f32)
    scores = a.to(f32).unsqueeze(-1) * inner
    if r.ndim > 3:
        cost = cost.reshape((-1,) + tuple(cost.shape[-2:]))
    return cost, scores, torch.argmin(scores, dim=-1).to(torch.int32)
