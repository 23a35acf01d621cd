"""A toy family that goes through every hook a family's reference module
may define (``layout``, ``prefill_row``, ``loss_sum``, ``forward_flops``),
for the benchmark's tests, which import it by its
name, ``portbench.tests.toy_family``; no other file names it.

Layer i is of the kind ``model["layer_types"][i]``: ``"mamba"``, the
Mamba-2 mixer of :mod:`portbench.reference.mamba2`, or ``"attention"``,
GQA with no positional embedding and scores scaled by
``attention_multiplier``. Each mixer is followed by an FFN of routed
experts and a shared expert: the router scores all ``num_experts``
published experts and keeps the ``top_k`` best of each token; the first
``experts_held`` experts are held here and add their gated part for the
tokens routed to them, and the others' part is left out, as on one chip of
an expert-parallel deployment. The embedding is scaled by
``embedding_multiplier``, each residual term by ``residual_multiplier``,
and the logits divided by ``logits_scaling``; the head is the tied
embedding.

Weights: the top leaves of the default layout, the mixers' leaves stacked
over the layers of their kind (groups ``"mamba"`` and ``"attention"``),
the FFN's over every layer (``"ffn"``). Decode state: the SSD state and
conv tail of each Mamba layer, the KV ring of each attention layer.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.inputs import default_layout, layer_leaves
from portbench.reference.hymba import ring
from portbench.reference.lm import head_logits, token_loss_sum
from portbench.reference.mamba2 import mixer
from portbench.reference.ops import Products, attention, rms_norm
from portbench.work import attention_products_per_layer, head_flops, ssd_products_per_layer

KINDS = ("attention", "mamba")


def kind_layers(model: dict) -> dict:
    """{kind: the indices of its layers}."""
    return {kind: [i for i, t in enumerate(model["layer_types"]) if t == kind] for kind in KINDS}


def layout(model: dict) -> tuple[dict, dict]:
    d, e, f = model["d_model"], model["experts_held"], model["expert_d_ff"]
    fs = model["shared_d_ff"]
    top, _ = default_layout(model)
    only = {"attention": dict(model, ssm_state=0, d_ff=0),
            "mamba": dict(model, num_heads=0, d_ff=0)}
    groups = {kind: (layers, default_layout(only[kind])[1]["blocks"][1])
              for kind, layers in kind_layers(model).items()}
    groups["ffn"] = (list(range(model["num_layers"])), {
        "ln2": ((d,), 0, "ones"), "router": ((d, model["num_experts"]), d, "normal"),
        "we_gate": ((e, d, f), d, "normal"), "we_up": ((e, d, f), d, "normal"),
        "we_down": ((e, f, d), f, "normal"), "ws_gate": ((d, fs), d, "normal"),
        "ws_up": ((d, fs), d, "normal"), "ws_down": ((fs, d), fs, "normal")})
    return top, groups


def _swiglu(x, gate, up, down, prod: Products):
    return prod.linear(F.silu(prod.linear(x, gate)) * prod.linear(x, up), down)


def moe_ffn(lp: dict, x, model: dict, prod: Products):
    """The shared expert and the held experts' gated part on normed (B, S, D)
    ``x``. Counts its calls in ``moe_ffn.launches``, as the program's
    kernels count theirs."""
    moe_ffn.launches += 1
    probs = torch.softmax(prod.linear(x, lp["router"]), dim=-1)
    gates, idx = probs.topk(model["top_k"], dim=-1)
    out = _swiglu(x, lp["ws_gate"], lp["ws_up"], lp["ws_down"], prod)
    for e in range(model["experts_held"]):
        gate = (gates * (idx == e)).sum(dim=-1, keepdim=True)     # 0 where not routed to e
        out = out + gate * _swiglu(x, lp["we_gate"][e], lp["we_up"][e], lp["we_down"][e], prod)
    return out


moe_ffn.launches = 0


def _layer(lp: dict, kind: str, h, model: dict, prod: Products, cache_slots: int | None):
    """One layer: (h', its decode state)."""
    eps, res = model["norm_eps"], model["residual_multiplier"]
    if kind == "mamba":
        out, state, tail = mixer(lp, h, model, prod)
        cache = {"ssm_state": state, "conv_state": tail}
    else:
        b, s, _ = h.shape
        hd = model["head_dim"]
        x = rms_norm(h, lp["ln1"], eps)
        q = prod.linear(x, lp["wq"]).reshape(b, s, model["num_heads"], hd)
        k = prod.linear(x, lp["wk"]).reshape(b, s, model["num_kv_heads"], hd)
        v = prod.linear(x, lp["wv"]).reshape(b, s, model["num_kv_heads"], hd)
        att = attention(q, k, v, 0, prod, scale=model["attention_multiplier"])
        out = prod.linear(att.reshape(b, s, -1), lp["wo"])
        cache = {} if cache_slots is None else {"k": ring(k, cache_slots),
                                                "v": ring(v, cache_slots)}
    h = h + res * out
    return h + res * moe_ffn(lp, rms_norm(h, lp["ln2"], eps), model, prod), cache


@torch.no_grad()
def prefill_row(weights: dict, model: dict, tokens, cache_slots: int | None, prod: Products):
    layers = layer_leaves(weights, layout(model)[1], model["num_layers"])
    h = weights["embed"][tokens] * model["embedding_multiplier"]
    states: dict[str, list] = {}
    for lp, kind in zip(layers, model["layer_types"]):
        h, state = _layer(lp, kind, h, model, prod, cache_slots)
        for name, leaf in state.items():
            states.setdefault(name, []).append(leaf)
    logits = head_logits(weights, model, h[:, -1:], prod) / model["logits_scaling"]
    return logits, {name: torch.stack(leaves) for name, leaves in states.items()}


def loss_sum(weights: dict, model: dict, tokens, labels, prod: Products):
    layers = layer_leaves(weights, layout(model)[1], model["num_layers"])
    h = F.embedding(tokens, weights["embed"]) * model["embedding_multiplier"]
    for lp, kind in zip(layers, model["layer_types"]):
        names = sorted(lp)

        def run(h, *leaves, kind=kind, names=names):
            return _layer(dict(zip(names, leaves)), kind, h, model, prod, None)[0]

        h = checkpoint(run, h, *(lp[n] for n in names), use_reentrant=False)
    return token_loss_sum(head_logits(weights, model, h, prod) / model["logits_scaling"], labels)


def forward_flops(model: dict, rows: int, seq: int, head_positions: int) -> int:
    """Every held parameter as one multiply-add per token, a routed expert's
    at the share of tokens routed to it (``top_k`` of ``num_experts``), the
    SSD's products in the Mamba layers, attention's in the attention layers,
    the head."""
    tokens = rows * seq
    f = head_flops(model, rows, head_positions)
    for layers, leaves in layout(model)[1].values():
        for name, (shape, _, _) in leaves.items():
            n = 2 * len(layers) * math.prod(shape) * tokens
            f += n * model["top_k"] // model["num_experts"] if name.startswith("we_") else n
    kinds = kind_layers(model)
    f += len(kinds["mamba"]) * ssd_products_per_layer(model, rows, seq)
    f += len(kinds["attention"]) * attention_products_per_layer(model, rows, seq)
    return f
