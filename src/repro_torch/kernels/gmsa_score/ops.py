"""Public wrapper of the ``gmsa_score`` kernel.

Same signature and (K, N) orientation as the JAX package's
``repro.kernels.gmsa_score.ops.gmsa_score``, plus optional leading run
dimensions on q, mu, a (and vp) that share wpue and either share r or carry
one r per run. Inputs are cast to
fp32 as the JAX wrapper does. CUDA tensors go to the hand-written kernel —
which launches or raises; there is no fallback — and CPU tensors to the
plain PyTorch version.
"""

from __future__ import annotations

import torch
from torch import Tensor

from repro_torch.kernels.gmsa_score.kernel import gmsa_score_cuda
from repro_torch.kernels.gmsa_score.ref import gmsa_score_ref


def gmsa_score(
    q: Tensor,       # (*B, K, N) backlogs (kernel orientation)
    mu: Tensor,      # (*B, K, N) service rates
    a: Tensor,       # (*B, K)   arrivals
    vp: Tensor,      # (K,) or (*B, K)   V * P^k
    r: Tensor,       # (K, N, N) or (*B, K, N, N) task-allocation ratios
    wpue: Tensor,    # (N,)      omega ⊙ PUE
) -> tuple[Tensor, Tensor]:
    """Fused dispatch scores + argmin. Returns (scores (*B, K, N) fp32,
    best (*B, K) int32), ties to the lowest index."""
    devices = {t.device for t in (q, mu, a, vp, r, wpue)}
    if len(devices) != 1:
        raise ValueError(f"gmsa_score operands span devices {sorted(map(str, devices))}")
    f32 = torch.float32
    q, mu, a, vp, r, wpue = (t.to(f32) for t in (q, mu, a, vp, r, wpue))
    if q.is_cuda:
        return gmsa_score_cuda(q, mu, a, vp, r, wpue)
    if q.device.type != "cpu":
        raise ValueError(f"gmsa_score runs on CUDA or the CPU, not {q.device}")
    return gmsa_score_ref(q, mu, a, vp, r, wpue)
