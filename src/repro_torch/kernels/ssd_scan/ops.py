"""Public wrapper of the ``ssd_scan`` kernel (padding + dtype policy).

Same signature as the JAX package's ``repro.kernels.ssd_scan.ops.ssd_scan``,
less ``interpret=``. S is padded to a chunk multiple with dt = 0 steps
(exp(0) = 1, zero update: exact no-ops) and y is sliced back. dt and a are
cast to fp32. CUDA tensors go to the hand-written kernel — which launches
or raises; there is no fallback — and CPU tensors to the plain sequential
version. ``meta`` tensors (the dry-run's shapes, no data) take
``ssd_scan_phases_ref``, the CUDA chain's own algorithm, so that a count
of their ops is the kernel's work. Off the card each plain call runs
through :func:`repro_torch.launch.cost.as_kernel`: under a cost count it
counts as the kernel would (its FLOPs; its arguments and outputs as its
bytes and memory), and otherwise it is the plain call.

Under autograd (grad enabled and an operand requiring grad) the call goes
through :class:`SsdScanFn`: on CUDA the forward chain, keeping its three
workspaces, and the hand-written backward chain; on the CPU (and on
``meta``) their plain phase-by-phase versions. x, b_mat and c_mat are fp32
or bf16, one dtype (the JAX package trains in bf16): dx, dB and dC come
back in it, ddt and da in fp32, as ``jax.vjp`` of ``ssd_chunked`` gives
them; a bf16 call on CUDA runs the bf16 chains. The padding stays outside
the Function, so the gradients of padded steps are dropped by ``F.pad``'s
backward. Without grad the paths above are unchanged.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor

from torch.autograd.function import once_differentiable

from repro_torch.kernels.ssd_scan.kernel import (
    _DTYPES,
    _ssd_scan_cuda_phases,
    ssd_scan_bwd_cuda,
    ssd_scan_cuda,
)
from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_ref, ssd_scan_phases_ref, ssd_scan_ref
from repro_torch.launch.cost import as_kernel


class SsdScanFn(torch.autograd.Function):
    """The SSD scan with its gradient: (x, dt, a, b_mat, c_mat, chunk) ->
    (y, h_final), S a multiple of ``chunk``, x / b_mat / c_mat in one
    dtype, fp32 or bf16.

    CUDA: the forward chain (one ``ssd_scan_cuda`` launch, its workspaces
    cum, G, h_in saved) and the backward chain (one ``ssd_scan_bwd_cuda``
    launch). CPU: ``ssd_scan_phases_ref`` and ``ssd_scan_bwd_ref``, the same
    algorithms in plain PyTorch. A ``None`` gradient of y or h_final is
    zeros (h_final's fp32, as the state is)."""

    @staticmethod
    def forward(ctx, x, dt, a, b_mat, c_mat, chunk):
        if x.is_cuda:
            y, h_final, cum, g, h_in = _ssd_scan_cuda_phases(x, dt, a, b_mat, c_mat, chunk)
        else:
            y, h_final, cum, g, h_in = as_kernel(ssd_scan_phases_ref, x, dt, a, b_mat, c_mat,
                                                 chunk)
        ctx.save_for_backward(x, dt, a, b_mat, c_mat, cum, g, h_in)
        ctx.chunk = chunk
        return y, h_final

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, dh_final):
        x, dt, a, b_mat, c_mat, cum, g, h_in = ctx.saved_tensors
        bsz, _, h, p = x.shape
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        if dh_final is None:
            dh_final = torch.zeros((bsz, h, p, b_mat.shape[-1]), dtype=torch.float32,
                                   device=x.device)
        args = (x, dt, a, b_mat, c_mat, dy, dh_final.contiguous(), cum, g, h_in, ctx.chunk)
        if x.is_cuda:
            dx, ddt, da, db, dc = ssd_scan_bwd_cuda(*args)
        else:
            dx, ddt, da, db, dc = as_kernel(ssd_scan_bwd_ref, *args)
        return dx, ddt, da, db, dc, None


def ssd_scan(
    x: Tensor,      # (B, S, H, P)
    dt: Tensor,     # (B, S, H)
    a: Tensor,      # (H,)
    b_mat: Tensor,  # (B, S, N)
    c_mat: Tensor,  # (B, S, N)
    *,
    chunk: int = 128,
) -> tuple[Tensor, Tensor]:
    """Chunked SSD forward from a zero state. Returns (y (B,S,H,P) in x's
    dtype, final_state (B,H,P,N) fp32)."""
    devices = {t.device for t in (x, dt, a, b_mat, c_mat)}
    if len(devices) != 1:
        raise ValueError(f"ssd_scan operands span devices {sorted(map(str, devices))}")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if x.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"ssd_scan runs on CUDA, the CPU or meta, not {x.device}")
    dt, a = dt.float(), a.float()
    s = x.shape[1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, pad))
    ops = (x, dt, a, b_mat, c_mat)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ops):
        if x.dtype not in _DTYPES or b_mat.dtype != x.dtype or c_mat.dtype != x.dtype:
            raise TypeError(
                "ssd_scan's gradient takes x, b_mat, c_mat in one dtype, fp32 or bf16, got "
                f"{x.dtype}, {b_mat.dtype}, {c_mat.dtype}")
        y, h_final = SsdScanFn.apply(*(t.contiguous() for t in ops), chunk)
    elif x.is_cuda:
        y, h_final = ssd_scan_cuda(
            x.contiguous(), dt.contiguous(), a.contiguous(), b_mat.contiguous(),
            c_mat.contiguous(), chunk,
        )
    elif x.is_meta:
        y, h_final = as_kernel(ssd_scan_phases_ref, *ops, chunk)[:2]
    else:
        y, h_final = as_kernel(ssd_scan_ref, *ops)
    return y[:, :s], h_final
