"""The hybrid (Hymba-style) layer, plain: attention and an SSD mixer side
by side on the same input, each branch RMS-normed, the two averaged into
the residual stream, then a SwiGLU FFN.

Attention: RMSNorm, Q, K, V projections (25 query heads and 5 KV heads of
64), rotary embedding on Q and K, causal attention inside the sliding
window, the out-projection. The SSM branch is :func:`portbench.reference
.mamba2.mixer`. The decode state of a layer: the KV ring of the last
``cache_slots`` positions (slot j holds the position p with p % slots == j,
K after its rotation), the SSM's final state and conv tail. Where this
departs from the published model is listed in the configuration file.
"""

from __future__ import annotations

import torch.nn.functional as F

from portbench.reference.mamba2 import mixer
from portbench.reference.ops import Products, attention, rms_norm, rope


def ring(kv, slots: int):
    """(B, S, ...) -> (B, slots, ...): slot j holds the last position p < S
    with p % slots == j (the first position where none is)."""
    s = kv.shape[1]
    order = [max((s - 1) - (((s - 1) - j) % slots), 0) for j in range(slots)]
    return kv[:, order]


def layer(lp: dict, h, model: dict, prod: Products, cache_slots: int | None = None):
    b, s, _ = h.shape
    eps = model["norm_eps"]
    hd = model["head_dim"]
    x_norm = rms_norm(h, lp["ln1"], eps)
    q = prod.linear(x_norm, lp["wq"]).reshape(b, s, model["num_heads"], hd)
    k = prod.linear(x_norm, lp["wk"]).reshape(b, s, model["num_kv_heads"], hd)
    v = prod.linear(x_norm, lp["wv"]).reshape(b, s, model["num_kv_heads"], hd)
    q, k = rope(q, model["rope_theta"]), rope(k, model["rope_theta"])
    att = attention(q, k, v, model["sliding_window"], prod).reshape(b, s, -1)
    attn_out = prod.linear(att, lp["wo"])
    ssm_out, state, conv_tail = mixer(lp, h, model, prod)
    h = h + 0.5 * (rms_norm(attn_out, lp["branch_attn_norm"], eps)
                   + rms_norm(ssm_out, lp["branch_ssm_norm"], eps))
    x_norm = rms_norm(h, lp["ln2"], eps)
    ffn = prod.linear(F.silu(prod.linear(x_norm, lp["w_gate"])) * prod.linear(x_norm, lp["w_up"]),
                      lp["w_down"])
    cache = {"ssm_state": state, "conv_state": conv_tail}
    if cache_slots is not None:
        cache["k"], cache["v"] = ring(k, cache_slots), ring(v, cache_slots)
    return h + ffn, cache
