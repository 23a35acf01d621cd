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
calls it only on the CPU under autograd, where it is the forward of
:class:`~repro_torch.kernels.ssd_scan.ops.SsdScanFn` (it keeps the
workspaces the backward reads).

:func:`ssd_scan_bwd_phases_ref` is the CUDA backward chain's algorithm
(``csrc/ssd_scan_bwd.cu``), phase by phase: the gradient of
:func:`ssd_scan_phases_ref` from the forward's workspaces. It serves CPU
tensors under autograd and ``chip_smoke.py``'s comparisons on the card;
:func:`ssd_scan_bwd_ref` returns its five gradients.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor

#: Heads per partial of dB's and dC's state terms in the backward chain's
#: chunk_dbc (``csrc/ssd_scan_bwd.cu``'s kHeadGroup): the H·P depth is split
#: so that enough blocks fill the card, then summed in a fixed order.
DBC_HEAD_GROUP = 16
#: Heads per partial of R in the backward chain's chunk_dstate
#: (``csrc/ssd_scan_bwd.cu``'s kRHeadGroup): the walk over the heads is split
#: so that enough blocks fill the card; dstate_pass sums the partials in order.
DSTATE_HEAD_GROUP = 16


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


def ssd_scan_bwd_phases_ref(
    x: Tensor, dt: Tensor, a: Tensor, b_mat: Tensor, c_mat: Tensor,
    dy: Tensor,        # (B, S, H, P)  upstream gradient of y
    dh_final: Tensor,  # (B, H, P, N)  upstream gradient of the final state
    cum: Tensor, g: Tensor, h_in: Tensor,   # the forward's workspaces (G read on and below the diagonal)
    chunk: int,
) -> tuple[Tensor, ...]:
    """The backward chain's phases in plain PyTorch, S a multiple of
    ``chunk`` (the wrapper pads before the forward). With nc = S / Q,
    per (b, h) and chunk c, ``cum`` local to the chunk, A_c = cum_Q,
    L_ts = exp(cum_t - cum_s) for t >= s, CB_ts = C_t·B_s, M_ts = dy_t·x_s
    and G_c the gradient of the state leaving chunk c:

    - chunk_dstate: D_c = Σ_t exp(cum_t) dy_t ⊗ C_t, and the partials of
      R_ts = Σ_h dt_s L_ts M_ts (t >= s) over the heads [g·DSTATE_HEAD_GROUP,
      (g + 1)·DSTATE_HEAD_GROUP) (the last group ragged where H is no
      multiple), once per (b, chunk, group);
    - dstate_pass: G_{nc-1} = dh_final, G_{c-1} = exp(A_c) G_c + D_c; R the
      partials summed in group order;
    - chunk_bwd, per head: dx_s = dt_s [Σ_{t>=s} L_ts CB_ts dy_t +
      exp(A_c - cum_s) G_c B_s]; the direct ddt_s = Σ_t L_ts CB_ts M_ts +
      exp(A_c - cum_s) x_s·(G_c B_s); ∂cum from W_ts = L_ts CB_ts dt_s M_ts
      (+ on t, − on s), the inter-chunk term exp(cum_t) dy_t·(h_in C_t),
      V_s = exp(A_c - cum_s) dt_s x_s·(G_c B_s) (− on s, + on Q) and
      exp(A_c) <G_c, h_in> on Q; the reverse cumsum of ∂cum adds a·(…) to
      ddt and Σ dt·(…) to da;
    - chunk_bwd also writes the per-(b, step, head) scales scale_out_s =
      dt_s exp(A_c - cum_s) and scale_in_t = exp(cum_t) that chunk_dbc reads;
    - chunk_dbc: dB_s = Σ_t R_ts C_t + Σ_h scale_out_s G_cᵀ x_s, dC_t = Σ_s
      R_ts B_s + Σ_h scale_in_t h_inᵀ dy_t, each as partials: slot 0 the R
      term, slot 1 + g the heads [g·DBC_HEAD_GROUP, (g + 1)·DBC_HEAD_GROUP)
      (the last group ragged where H is no multiple);
    - dbc_sum: dB, dC the partials summed in slot order; da the chunks' da
      partials summed over (b, c).

    x, b_mat, c_mat and dy are fp32 or bf16 (widened to fp32 here, as the
    chain widens them). Returns (dx (B,S,H,P), ddt (B,S,H), da (H,), dB, dC
    (B,S,N)): dx, dB and dC rounded once to their operands' dtype, as the
    chain and the reference's ``astype`` round them, ddt and da fp32; then
    the workspaces G (B, nc, H, P, N), R (B, nc, Q, Q) (zero above the
    diagonal), scale_out and scale_in (B, S, H), the partials (B, nc, 2,
    1 + ceil(H / DBC_HEAD_GROUP), Q, N) (dB's, then dC's), da_part (B, nc,
    H) and R's partials (B, nc, ceil(H / DSTATE_HEAD_GROUP), Q, Q) (zero
    above the diagonal). Every exponent is an fp64 difference of cum values
    rounded once to fp32, as in the forward."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    q = chunk
    if s % q:
        raise ValueError(f"S={s} is not a multiple of chunk {q}: the wrapper pads first")
    nc = s // q
    f32 = torch.float32
    xc = x.reshape(bsz, nc, q, h, p).to(f32)
    dyc = dy.reshape(bsz, nc, q, h, p).to(f32)
    dtc = dt.reshape(bsz, nc, q, h).to(f32)
    bc = b_mat.reshape(bsz, nc, q, n).to(f32)
    cc = c_mat.reshape(bsz, nc, q, n).to(f32)
    cumc = cum.reshape(bsz, h, nc, q).permute(0, 2, 3, 1)             # (B,NC,Q,H) fp64
    last = cumc[:, :, -1, :]                                           # (B,NC,H)
    tri = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    # The forward chain leaves G above the diagonal unspecified (possibly
    # inf or NaN): select, never multiply by a mask.
    g = torch.where(tri, g, 0.0)
    e_in = torch.exp(cumc.to(f32))                                     # exp(cum_t)
    e_out = torch.exp((last[:, :, None, :] - cumc).to(f32))            # exp(A_c - cum_s)

    # Phase 1, chunk_dstate: D_c per head, and R's partials per head group.
    dstate = torch.einsum("bcth,bcthp,bctn->bchpn", e_in, dyc, cc)
    seg = cumc[:, :, :, None, :] - cumc[:, :, None, :, :]             # (B,NC,Q,Q,H) [t, s]
    seg = seg.masked_fill(~tri[None, None, :, :, None], float("-inf"))
    lmat = torch.exp(seg.to(f32))
    mmat = torch.einsum("bcthp,bcshp->bctsh", dyc, xc)
    lm = lmat * mmat
    r_part = torch.stack([torch.einsum("bctsh,bcsh->bcts", lm[..., hs], dtc[..., hs])
                          for hs in _groups(h, DSTATE_HEAD_GROUP)], dim=2)   # (B,NC,G,Q,Q)
    # Phase 2, dstate_pass: R the partials in group order; the gradient of
    # the state leaving each chunk.
    r = _ordered_sum(r_part, 2)
    decay = torch.exp(last.to(f32))
    gcur = dh_final.to(f32)
    gs = []
    for c in reversed(range(nc)):
        gs.append(gcur)
        gcur = decay[:, c, :, None, None] * gcur + dstate[:, c]
    gst = torch.stack(gs[::-1], dim=1)                                 # (B,NC,H,P,N)
    # Phase 3, chunk_bwd: dx, ddt and the da partials, per head.
    wt = g[..., None] * lmat                                           # L ⊙ CB, [t, s]
    inter = torch.einsum("bcsn,bchpn->bcshp", bc, gst)                 # G_c B_s
    dx = dtc[..., None] * (torch.einsum("bctsh,bcthp->bcshp", wt, dyc) + e_out[..., None] * inter)
    p1 = wt * mmat
    col = p1.sum(dim=2)                                                # Σ_t, (B,NC,Q,H) on s
    row = torch.einsum("bctsh,bcsh->bcth", p1, dtc)                    # Σ_s W_ts
    xi = (xc * inter).sum(-1)
    v = e_out * dtc * xi
    yi = torch.einsum("bctn,bchpn->bcthp", cc, h_in)                   # h_in C_t
    dcum = row - dtc * col - v + e_in * (dyc * yi).sum(-1)
    dcum[:, :, -1, :] += decay * (gst * h_in).sum((-1, -2)) + v.sum(2)
    rev = dcum.flip(2).cumsum(2).flip(2)
    ddt = col + e_out * xi + a.to(f32) * rev
    da_part = (dtc * rev).sum(2)                                       # (B,NC,H)
    scale_out = dtc * e_out
    # Phase 4, chunk_dbc: the R terms, then each head group's state terms.
    groups = _groups(h, DBC_HEAD_GROUP)
    part = torch.stack([
        torch.stack([torch.einsum("bcts,bctn->bcsn", r, cc)] + [torch.einsum(
            "bcsh,bcshp,bchpn->bcsn", scale_out[..., hs], xc[..., hs, :], gst[:, :, hs])
            for hs in groups], dim=2),
        torch.stack([torch.einsum("bcts,bcsn->bctn", r, bc)] + [torch.einsum(
            "bcth,bcthp,bchpn->bctn", e_in[..., hs], dyc[..., hs, :], h_in[:, :, hs])
            for hs in groups], dim=2),
    ], dim=2)                                                          # (B,NC,2,slots,Q,N)
    # Phase 5, dbc_sum: the slots in order; da over (b, c) in order.
    dbc = _ordered_sum(part, 3)
    da = da_part.reshape(-1, h).sum(0)
    return (dx.reshape(bsz, s, h, p).to(x.dtype), ddt.reshape(bsz, s, h), da,
            dbc[:, :, 0].reshape(bsz, s, n).to(b_mat.dtype),
            dbc[:, :, 1].reshape(bsz, s, n).to(c_mat.dtype), gst, r, scale_out.reshape(bsz, s, h),
            e_in.reshape(bsz, s, h), part, da_part, r_part)


def _groups(h: int, size: int) -> list[slice]:
    """The heads in groups of ``size``, the last one ragged."""
    return [slice(g0, g0 + size) for g0 in range(0, h, size)]


def _ordered_sum(parts: Tensor, dim: int) -> Tensor:
    """parts summed over ``dim`` in index order, as the chain's kernels sum
    their partials (so launches repeat bitwise)."""
    total = parts.select(dim, 0)
    for k in range(1, parts.shape[dim]):
        total = total + parts.select(dim, k)
    return total


def ssd_scan_bwd_ref(
    x: Tensor, dt: Tensor, a: Tensor, b_mat: Tensor, c_mat: Tensor, dy: Tensor,
    dh_final: Tensor, cum: Tensor, g: Tensor, h_in: Tensor, chunk: int,
) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """(dx, ddt, da, dB, dC) of :func:`ssd_scan_bwd_phases_ref`."""
    return ssd_scan_bwd_phases_ref(x, dt, a, b_mat, c_mat, dy, dh_final, cum, g, h_in,
                                   chunk)[:5]
