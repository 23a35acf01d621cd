"""Plain PyTorch building blocks of the references, fp32, with the products
in a chosen precision.

``Products(mode)`` computes every product of matrices a reference makes:

* ``"fp32"``: fp32 operands, TF32 off (:func:`fp32_matmuls` sets the
  flags); the reference itself.
* ``"tf32"``: every operand rounded to TF32 (10 bits of mantissa, round to
  nearest) before an fp32 product, as the tensor cores read fp32 operands
  when TF32 is allowed: the control of an fp32 cell.
* ``"fp8"``: the projections and the head (``linear``) with e4m3 operands
  scaled per tensor in the forward and an e5m2 gradient in the backward,
  the usual fp8 training recipe; the SSD's and attention's own products
  stay fp32: the control of a bf16 cell.

The SSD is the chunked dual form (Mamba-2, Sec. 6), a frozen copy of
``repro_torch.models.ssm.ssd_chunked`` written with two-operand products,
its cumulative decay in fp64: the difference of two large cumulative sums
loses digits in fp32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import Tensor

MODES = ("fp32", "tf32", "fp8")
_E4M3_MAX, _E5M2_MAX = 448.0, 57344.0


@contextlib.contextmanager
def fp32_matmuls():
    """TF32 off for cuBLAS and cuDNN inside the block."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def round_tf32(x: Tensor) -> Tensor:
    """fp32 ``x`` rounded to TF32 (the low 13 mantissa bits, to nearest)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _fp8(x: Tensor, dtype, top: float) -> Tensor:
    """``x`` through an fp8 format with one scale for the tensor."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = top / amax
    return (x * scale).to(dtype).float() / scale


class _Fp8Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        qx, qw = _fp8(x, torch.float8_e4m3fn, _E4M3_MAX), _fp8(w, torch.float8_e4m3fn, _E4M3_MAX)
        ctx.save_for_backward(qx, qw)
        return qx @ qw

    @staticmethod
    def backward(ctx, g):
        qx, qw = ctx.saved_tensors
        qg = _fp8(g, torch.float8_e5m2, _E5M2_MAX)
        dx = qg @ qw.T
        dw = qx.reshape(-1, qx.shape[-1]).T @ qg.reshape(-1, qg.shape[-1])
        return dx, dw


class Products:
    """The products of a reference, in one of :data:`MODES`."""

    def __init__(self, mode: str = "fp32"):
        if mode not in MODES:
            raise ValueError(f"precision must be one of {MODES}, got {mode!r}")
        self.mode = mode

    def linear(self, x: Tensor, w: Tensor) -> Tensor:
        if self.mode == "fp8":
            return _Fp8Linear.apply(x, w)
        if self.mode == "tf32":
            return round_tf32(x) @ round_tf32(w)
        return x @ w

    def ein(self, eq: str, a: Tensor, b: Tensor) -> Tensor:
        if self.mode == "tf32":
            a, b = round_tf32(a), round_tf32(b)
        return torch.einsum(eq, a, b)


def rms_norm(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * scale


def causal_conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv over (B, S, C) with taps (W, C)."""
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    return sum(xp[:, i:i + s] * w[i] for i in range(width)) + b


def rope(x: Tensor, theta: float) -> Tensor:
    """Rotary embedding over (B, S, H, hd), split-half pairs, positions 0..,
    the angles in fp32 as the published implementations compute them."""
    s, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freq = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freq
    sin, cos = ang.sin()[:, None, :], ang.cos()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: Tensor, k: Tensor, v: Tensor, window: int, prod: Products,
              q_tile: int = 512, scale: float | None = None) -> Tensor:
    """Causal attention over (B, S, H, hd) queries and (B, S, Hkv, hd) keys
    and values, each query seeing itself and the ``window`` - 1 positions
    before it (all before it when ``window`` is 0); query head h reads KV
    head h // (H / Hkv); scores scaled by ``scale`` (hd^-0.5 where None).
    Tiled over queries."""
    b, s, h, hd = q.shape
    groups = h // k.shape[2]
    k, v = k.repeat_interleave(groups, dim=2), v.repeat_interleave(groups, dim=2)
    pos = torch.arange(s, device=q.device)
    outs = []
    for t0 in range(0, s, q_tile):
        qt = q[:, t0:t0 + q_tile]
        diff = pos[t0:t0 + q_tile, None] - pos[None, :]
        ok = diff >= 0
        if window:
            ok &= diff < window
        scores = prod.ein("bqhd,bkhd->bhqk", qt, k) * (hd ** -0.5 if scale is None else scale)
        scores = scores.masked_fill(~ok, float("-inf"))
        outs.append(prod.ein("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v))
    return torch.cat(outs, dim=1)


def ssd(x: Tensor, dt: Tensor, a: Tensor, b_mat: Tensor, c_mat: Tensor, chunk: int,
        prod: Products) -> tuple[Tensor, Tensor]:
    """The SSD scan from a zero state: x (B,S,H,P), dt (B,S,H), a (H,), B and
    C (B,S,N). Returns (y (B,S,H,P), final state (B,H,P,N))."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    pad = (-s) % chunk
    if pad:     # zero-dt steps: decay 1, no update
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        b_mat, c_mat = F.pad(b_mat, (0, 0, 0, pad)), F.pad(c_mat, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    xc = x.reshape(bsz, nc, chunk, h, p)
    dtc = dt.reshape(bsz, nc, chunk, h)
    bc = b_mat.reshape(bsz, nc, chunk, n)
    cc = c_mat.reshape(bsz, nc, chunk, n)
    cum = torch.cumsum((dtc * a).double(), dim=2)                     # (B,C,Q,H)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]                # (B,C,Q,Q,H)
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~tri[None, None, :, :, None], float("-inf"))).float()
    w = prod.ein("bcqn,bcsn->bcqs", cc, bc)[..., None] * decay * dtc[:, :, None, :, :]
    y = prod.ein("bcqsh,bcshp->bcqhp", w, xc)
    to_end = torch.exp(cum[:, :, -1:, :] - cum).float()               # (B,C,Q,H)
    states = prod.ein("bcqhp,bcqn->bchpn", xc * (to_end * dtc)[..., None], bc)
    chunk_decay = torch.exp(cum[:, :, -1, :]).float()                 # (B,C,H)
    hcur = torch.zeros(bsz, h, p, n, dtype=torch.float32, device=x.device)
    h_in = []
    for c in range(nc):
        h_in.append(hcur)
        hcur = chunk_decay[:, c, :, None, None] * hcur + states[:, c]
    h_in = torch.stack(h_in, dim=1)                                   # (B,C,H,P,N)
    y = y + prod.ein("bcqn,bchpn->bcqhp", cc, h_in) * torch.exp(cum).float()[..., None]
    return y.reshape(bsz, nc * chunk, h, p)[:, :s], hcur
