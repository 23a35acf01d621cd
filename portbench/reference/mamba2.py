"""Mamba-2, plain: one layer of the SSD mixer (the published Mamba2 block)
and its decode state.

Per layer, from the residual stream h: RMSNorm, the in-projection to z, x,
B, C and dt, a depthwise causal conv of width W over x, B and C with SiLU,
dt = softplus(dt + dt_bias), A = -exp(A_log), the SSD scan, the skip D·x,
the gate RMSNorm(y · SiLU(z)), the out-projection, added to h. The decode
state of a layer is the scan's final state and the last W - 1 raw x, B, C
projections (the conv's tail).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.ops import Products, causal_conv, rms_norm, ssd

#: The chunk of the reference's dual form (the algebra is exact for any).
CHUNK = 128


def mixer(lp: dict, h, model: dict, prod: Products):
    """The SSD mixer on (B, S, D): (out (B, S, D), final state (B, H, P, N),
    conv tail (B, W - 1, d_inner + 2N))."""
    b, s, _ = h.shape
    eps = model["norm_eps"]
    hd = model["ssm_head_dim"]
    di = model["ssm_expand"] * model["d_model"]
    x_norm = rms_norm(h, lp["ln_ssm"], eps)
    z = prod.linear(x_norm, lp["w_z"])
    x_raw = prod.linear(x_norm, lp["w_x"])
    b_raw = prod.linear(x_norm, lp["w_b"])
    c_raw = prod.linear(x_norm, lp["w_c"])
    dt_raw = prod.linear(x_norm, lp["w_dt"])
    tail = model["ssm_conv_width"] - 1
    conv_tail = torch.cat([x_raw[:, -tail:], b_raw[:, -tail:], c_raw[:, -tail:]], dim=-1)
    x_in = F.silu(causal_conv(x_raw, lp["conv_x_w"], lp["conv_x_b"])).reshape(b, s, di // hd, hd)
    b_mat = F.silu(causal_conv(b_raw, lp["conv_b_w"], lp["conv_b_b"]))
    c_mat = F.silu(causal_conv(c_raw, lp["conv_c_w"], lp["conv_c_b"]))
    dt = F.softplus(dt_raw + lp["dt_bias"])
    y, state = ssd(x_in, dt, -torch.exp(lp["a_log"]), b_mat, c_mat, CHUNK, prod)
    y = (y + lp["d_skip"][:, None] * x_in).reshape(b, s, di)
    y = rms_norm(y * F.silu(z), lp["ssm_norm"], eps)
    return prod.linear(y, lp["ssm_out"]), state, conv_tail


def layer(lp: dict, h, model: dict, prod: Products, cache_slots: int | None = None):
    """One Mamba-2 layer: (h', decode state {"ssm_state", "conv_state"})."""
    out, state, conv_tail = mixer(lp, h, model, prod)
    return h + out, {"ssm_state": state, "conv_state": conv_tail}
