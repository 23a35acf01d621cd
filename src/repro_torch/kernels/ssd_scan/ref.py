"""Plain PyTorch versions of the ``ssd_scan`` kernel.

:func:`ssd_scan_ref` is the O(S) sequential recurrence, (B, H) vectorised,
state in fp32:

    h_t = exp(a_h * dt_t) * h_{t-1} + dt_t * (x_t ⊗ B_t)
    y_t = h_t @ C_t

Deliberately the *sequential* form (not the chunked algebra of the kernel or
of :func:`repro_torch.models.ssm.ssd_chunked`), so the kernel is held
against an independent formulation. It serves CPU tensors, the CPU tests and
``chip_smoke.py``'s comparisons on the card.

:func:`ssd_scan_phases_ref` is the CUDA chain's own algorithm, phase by
phase, returning its workspaces in the chain's layouts, so that a fault on
the card shows in the first phase whose workspace differs. The main path
never calls it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
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


def ssd_scan_phases_ref(
    x: Tensor,      # (B, S, H, P)
    dt: Tensor,     # (B, S, H)
    a: Tensor,      # (H,)
    b_mat: Tensor,  # (B, S, N)
    c_mat: Tensor,  # (B, S, N)
    chunk: int,
) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """The chain's phases in plain PyTorch. S is padded to a chunk multiple
    with dt = 0 steps, as the wrapper pads it; with Sp the padded length and
    nc = Sp / chunk, returns

    - y (B, S, H, P) in x's dtype and h_final (B, H, P, N) fp32;
    - cum (B, H, Sp) fp64: per chunk, the inclusive cumsum of a_h·dt;
    - G (B, nc, Q, Q) fp32: C_c B_cᵀ, once per (b, chunk) for all heads,
      zero above the diagonal (the kernel leaves that part unspecified);
    - h_in (B, nc, H, P, N) fp32: the state entering each chunk.

    Every exponent is an fp64 difference of cum values rounded once to
    fp32 before ``exp``, as in the kernels."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    q = chunk
    pad = (-s) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, pad))
    nc = (s + pad) // q
    f32, f64 = torch.float32, torch.float64
    xc = x.reshape(bsz, nc, q, h, p).to(f32)
    dtc = dt.reshape(bsz, nc, q, h).to(f32)
    bc = b_mat.reshape(bsz, nc, q, n).to(f32)
    cc = c_mat.reshape(bsz, nc, q, n).to(f32)

    # Phase 0, cumsum: fp64, restarting at every chunk.
    cum = torch.cumsum(dtc.to(f64) * a.to(f64), dim=2)                 # (B,NC,Q,H)
    cum_last = cum[:, :, -1, :]                                        # (B,NC,H)
    # Phase 1, chunk_cb: one (Q, Q) product per (b, chunk).
    tri = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    g = torch.einsum("bctn,bcun->bctu", cc, bc) * tri
    # Phase 2, chunk_state: s_c = sum_u x_u exp(cum_Q - cum_u) dt_u ⊗ B_u.
    w_out = torch.exp((cum_last[:, :, None, :] - cum).to(f32)) * dtc   # (B,NC,Q,H)
    states = torch.einsum("bcuh,bcuhp,bcun->bchpn", w_out, xc, bc)
    # Phase 3, state_pass: the state entering each chunk, and the last one.
    decay = torch.exp(cum_last.to(f32))                                # (B,NC,H)
    hcur = torch.zeros(bsz, h, p, n, dtype=f32, device=x.device)
    h_in = []
    for c in range(nc):
        h_in.append(hcur)
        hcur = decay[:, c, :, None, None] * hcur + states[:, c]
    h_in = torch.stack(h_in, dim=1)
    # Phase 4, chunk_scan: y_t = exp(cum_t) C_t h_inᵀ + sum_{u<=t} W[t,u] x_u,
    # W[t,u] = G[t,u] exp(cum_t - cum_u) dt_u, masked before exp.
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]                # (B,NC,Q,Q,H)
    seg = seg.masked_fill(~tri[None, None, :, :, None], float("-inf"))
    w = g[..., None] * torch.exp(seg.to(f32)) * dtc[:, :, None, :, :]
    y = torch.einsum("bctuh,bcuhp->bcthp", w, xc)
    y = y + torch.einsum("bctn,bchpn->bcthp", cc, h_in) * torch.exp(cum.to(f32))[..., None]
    y = y.reshape(bsz, nc * q, h, p)[:, :s].to(x.dtype)
    cum = cum.permute(0, 3, 1, 2).reshape(bsz, h, nc * q)
    return y, hcur, cum, g, h_in
