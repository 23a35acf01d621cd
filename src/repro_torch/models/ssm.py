"""Mamba-2 SSD (state-space duality) layer — chunked scan + one-step decode.

The port of ``repro.models.ssm``. Per head h with state (P, N):

    h_t = exp(A_h * dt_t) * h_{t-1} + dt_t * (x_t  outer  B_t)
    y_t = h_t @ C_t + D_h * x_t

:func:`ssd_chunked` is the plain chunked form (Mamba-2 paper, Sec. 6): a
dense intra-chunk term, per-chunk states, an inter-chunk recurrence and the
state broadcast back into each chunk, all in fp32. The model's prefill does
not call it: it runs the same function through the hand-written CUDA kernel
(:mod:`repro_torch.kernels.ssd_scan`); this form stays as its counterpart
(with ``h0``) and as a second plain check on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor


def ssd_chunked(
    x: Tensor,       # (B, S, H, P)  inputs per head
    dt: Tensor,      # (B, S, H)     softplus'd step sizes
    a: Tensor,       # (H,)          negative decay rates (A = -exp(A_log))
    b_mat: Tensor,   # (B, S, N)     input projections (G=1 group)
    c_mat: Tensor,   # (B, S, N)     output projections
    chunk: int,
    h0: Tensor | None = None,   # (B, H, P, N) initial state
) -> tuple[Tensor, Tensor]:
    """Chunked SSD scan. Returns (y (B,S,H,P), final_state (B,H,P,N))."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    pad = (-s) % chunk
    if pad:
        # Zero-dt padding steps are exact no-ops for the recurrence
        # (decay exp(0)=1, zero state update, outputs discarded).
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, pad))
    s_padded = s + pad
    nc = s_padded // chunk
    f32 = torch.float32

    xc = x.reshape(bsz, nc, chunk, h, p).to(f32)
    dtc = dt.reshape(bsz, nc, chunk, h).to(f32)
    bc = b_mat.reshape(bsz, nc, chunk, n).to(f32)
    cc = c_mat.reshape(bsz, nc, chunk, n).to(f32)

    adt = dtc * a.to(f32)                                 # (B,NC,Q,H) (negative)
    cum = torch.cumsum(adt, dim=2)                        # inclusive cumsum
    # Intra-chunk weights L[t, s_] = exp(cum_t - cum_s) for t >= s_. Mask
    # BEFORE exp: the upper triangle has positive exponents that overflow.
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,NC,Q,Q,H)
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    l_mat = torch.exp(seg.masked_fill(~tri[None, None, :, :, None], float("-inf")))
    cb = torch.einsum("bcqn,bcsn->bcqs", cc, bc)
    w_intra = cb[..., None] * l_mat * dtc[:, :, None, :, :]      # (B,NC,Q,S=Q,H)
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", w_intra, xc)

    # Per-chunk state contribution: sum_s exp(cum_Q - cum_s) * dt_s * x_s ⊗ B_s.
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)        # (B,NC,Q,H)
    states = torch.einsum("bcqh,bcqhp,bcqn->bchpn", decay_out * dtc, xc, bc)
    chunk_decay = torch.exp(cum[:, :, -1, :])             # (B,NC,H)

    # Inter-chunk recurrence; keep the state *entering* each chunk.
    hcur = torch.zeros(bsz, h, p, n, dtype=f32, device=x.device) if h0 is None else h0.to(f32)
    h_in = []
    for c in range(nc):
        h_in.append(hcur)
        hcur = chunk_decay[:, c, :, None, None] * hcur + states[:, c]
    h_in = torch.stack(h_in, dim=1)                       # (B,NC,H,P,N)

    # Inter-chunk output: y_t += exp(cum_t) * C_t @ h_in.
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", cc, h_in) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(bsz, s_padded, h, p)[:, :s].to(x.dtype)
    return y, hcur


def ssd_step(
    x: Tensor,       # (B, H, P)
    dt: Tensor,      # (B, H)
    a: Tensor,       # (H,)
    b_vec: Tensor,   # (B, N)
    c_vec: Tensor,   # (B, N)
    state: Tensor,   # (B, H, P, N) fp32
) -> tuple[Tensor, Tensor]:
    """One decode step of the SSD recurrence. Returns (y (B,H,P), new_state)."""
    f32 = torch.float32
    dtf = dt.to(f32)
    decay = torch.exp(dtf * a.to(f32))                    # (B, H)
    upd = torch.einsum("bh,bhp,bn->bhpn", dtf, x.to(f32), b_vec.to(f32))
    new_state = decay[:, :, None, None] * state + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, c_vec.to(f32))
    return y.to(x.dtype), new_state


def causal_conv_update(
    conv_state: Tensor,   # (B, W-1, C) previous inputs
    new: Tensor,          # (B, C) current input
    w: Tensor,            # (W, C) depthwise filter
    b: Tensor,            # (C,)
) -> tuple[Tensor, Tensor]:
    """Depthwise causal conv, single step. Returns (out (B,C), new_state)."""
    window = torch.cat([conv_state, new[:, None, :]], dim=1)   # (B, W, C)
    out = torch.einsum("bwc,wc->bc", window, w) + b
    return out, window[:, 1:, :]


def causal_conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv over (B, S, C) with filter (W, C): the W shifted
    windows of the left-padded input, weighted and summed (no cuDNN, so no
    TF32 on the card)."""
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = xp[:, 0:s, :] * w[0]
    for i in range(1, width):
        out = out + xp[:, i:i + s, :] * w[i]
    return out + b
