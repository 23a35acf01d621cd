"""Plain PyTorch version of the ``ssd_scan`` kernel: the O(S) sequential
recurrence, (B, H) vectorised, state in fp32.

    h_t = exp(a_h * dt_t) * h_{t-1} + dt_t * (x_t ⊗ B_t)
    y_t = h_t @ C_t

Deliberately the *sequential* form (not the chunked algebra of the kernel or
of :func:`repro_torch.models.ssm.ssd_chunked`), so the kernel is held
against an independent formulation. It serves CPU tensors, the CPU tests and
``chip_smoke.py``'s comparisons on the card.
"""

from __future__ import annotations

import torch
from torch import Tensor


def ssd_scan_ref(
    x: Tensor,      # (B, S, H, P)
    dt: Tensor,     # (B, S, H)
    a: Tensor,      # (H,)
    b_mat: Tensor,  # (B, S, N)
    c_mat: Tensor,  # (B, S, N)
) -> tuple[Tensor, Tensor]:
    """Returns (y (B,S,H,P) in x's dtype, final_state (B,H,P,N) fp32)."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    f32 = torch.float32
    af = a.to(f32)
    state = torch.zeros(bsz, h, p, n, dtype=f32, device=x.device)
    ys = []
    for t in range(s):
        dtt = dt[:, t].to(f32)                                    # (B, H)
        decay = torch.exp(dtt * af)
        xw = dtt[:, :, None] * x[:, t].to(f32)                    # (B, H, P)
        state = decay[:, :, None, None] * state + xw[..., None] * b_mat[:, t, None, None, :].to(f32)
        ys.append(torch.einsum("bhpn,bn->bhp", state, c_mat[:, t].to(f32)))
    y = torch.stack(ys, dim=1) if ys else torch.zeros(bsz, 0, h, p, dtype=f32, device=x.device)
    return y.to(x.dtype), state
