"""What the benchmark makes from ``--seed``: the weights and the tokens.

Both sides get the same: the program takes them as its inputs and the
plain reference makes them again from the same seed (a seeded generator
on the same device gives the same numbers). Weights come in the program's
layout, drawn on the device, one call per stacked leaf, in the dtype the
cell serves or trains in.

A layout is the top leaves and any number of stacked groups: a group is a
name, the ordered layer indices that hold it, and its leaves, each stacked
on a leading axis over those layers (a leaf's name is its own across
groups: a layer's leaves meet in one dict). A family's reference module
(``portbench.reference.<name>``) may define ``layout(model)``; where it
does not, :func:`default_layout` holds: a frozen copy of
``repro_torch.models.lm``'s parameter specs for the families configured
so far, every layer leaf in one group ``"blocks"`` over every layer.
"""

from __future__ import annotations

import math

import torch

from portbench.work import padded_vocab

#: Leaves the program keeps in fp32 whatever the cell's dtype (the SSD's
#: decay and step-size parameters).
FP32_KINDS = ("a_log", "dt_bias")


def default_layout(model: dict) -> tuple[dict, dict]:
    """(top leaves, {"blocks": (every layer, one layer's leaves)}), leaves
    name -> (shape, fan_in, kind), kind one of normal, ones, zeros, a_log,
    dt_bias."""
    d, vp = model["d_model"], padded_vocab(model)
    top = {"embed": ((vp, d), d, "normal"), "final_norm": ((d,), 0, "ones")}
    if not model["tie_embeddings"]:
        top["lm_head"] = ((d, vp), d, "normal")
    layer: dict = {}
    if model["num_heads"]:
        hd = model["head_dim"] or d // model["num_heads"]
        q, kv = model["num_heads"] * hd, model["num_kv_heads"] * hd
        layer.update(ln1=((d,), 0, "ones"), wq=((d, q), d, "normal"), wk=((d, kv), d, "normal"),
                     wv=((d, kv), d, "normal"), wo=((q, d), q, "normal"))
    if model["ssm_state"]:
        n = model["ssm_state"]
        di = model["ssm_expand"] * d
        h = di // model["ssm_head_dim"]
        w = model["ssm_conv_width"]
        layer.update(
            ln_ssm=((d,), 0, "ones"), w_z=((d, di), d, "normal"), w_x=((d, di), d, "normal"),
            w_b=((d, n), d, "normal"), w_c=((d, n), d, "normal"), w_dt=((d, h), d, "normal"),
            conv_x_w=((w, di), w, "normal"), conv_x_b=((di,), 0, "zeros"),
            conv_b_w=((w, n), w, "normal"), conv_b_b=((n,), 0, "zeros"),
            conv_c_w=((w, n), w, "normal"), conv_c_b=((n,), 0, "zeros"),
            a_log=((h,), 0, "a_log"), d_skip=((h,), 0, "ones"), dt_bias=((h,), 0, "dt_bias"),
            ssm_norm=((di,), 0, "ones"), ssm_out=((di, d), di, "normal"))
    if model.get("hybrid"):
        layer.update(branch_attn_norm=((d,), 0, "ones"), branch_ssm_norm=((d,), 0, "ones"))
    if model["d_ff"]:
        f = model["d_ff"]
        layer.update(ln2=((d,), 0, "ones"), w_gate=((d, f), d, "normal"),
                     w_up=((d, f), d, "normal"), w_down=((f, d), f, "normal"))
    return top, {"blocks": (list(range(model["num_layers"])), layer)}


def layout(model: dict, family) -> tuple[dict, dict]:
    """(top leaves, groups {name: (layer indices, leaves)}): the family
    module's ``layout(model)`` where it defines one, else the default."""
    if hasattr(family, "layout"):
        return family.layout(model)
    return default_layout(model)


def _leaf(gen: torch.Generator, shape: tuple, fan_in: int, kind: str, dtype, device):
    if kind in FP32_KINDS:
        u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
        if kind == "a_log":                     # A = -exp(a_log), A ~ U[1, 16]
            return u.mul_(15.0).add_(1.0).log_()
        lo, hi = math.log(1e-3), math.log(1e-1)  # dt log-uniform in [1e-3, 1e-1]
        return u.mul_(hi - lo).add_(lo).exp_().expm1_().log_()   # softplus⁻¹(dt)
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if kind == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    return torch.randn(shape, generator=gen, device=device, dtype=dtype).mul_(fan_in ** -0.5)


def make_weights(model: dict, seed: int, dtype, device, family) -> dict:
    """The weights for ``seed`` in ``family``'s layout: one generator on
    ``device``; the top leaves in name order, then each group in name order,
    its leaves in name order, each stacked over the group's layers."""
    gen = torch.Generator(device=device).manual_seed(seed)
    top, groups = layout(model, family)
    out = {name: _leaf(gen, *spec, dtype, device) for name, spec in sorted(top.items())}
    for group, (layers, leaves) in sorted(groups.items()):
        out[group] = {name: _leaf(gen, (len(layers),) + shape, fan, kind, dtype, device)
                      for name, (shape, fan, kind) in sorted(leaves.items())}
    return out


def layer_leaves(weights: dict, groups: dict, num_layers: int) -> list[dict]:
    """Each layer's leaves, {name: view}: of every group that holds the
    layer, each leaf's slice at the group's position of that layer (views
    by ``unbind``, so a gradient through them lands in the stacked leaf)."""
    out: list[dict] = [{} for _ in range(num_layers)]
    for group, (layers, _) in groups.items():
        for name, leaf in weights[group].items():
            for i, view in zip(layers, leaf.unbind(0)):
                out[i][name] = view
    return out


def leaf_items(tree: dict, prefix: str = ""):
    """(path, tensor) of a weight tree in name order, a group's leaves as
    ``<group>/<name>``."""
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            yield from leaf_items(val, f"{prefix}{key}/")
        else:
            yield prefix + key, val


def token_seed(seed: int) -> int:
    """The tokens' generator seed, apart from the weights' stream."""
    return (seed * 6364136223846793005 + 1442695040888963407) % 2**63


def make_tokens(model: dict, seed: int, units: int, rows: int, seq: int, zipf: float,
                device) -> torch.Tensor:
    """(units, rows, seq) int64 token ids drawn from the seed: a Zipf law of
    exponent ``zipf`` over the real vocabulary, its ranks spread over the ids
    by a random permutation. One draw for every unit the window may run."""
    gen = torch.Generator(device=device).manual_seed(token_seed(seed))
    v = model["vocab_size"]
    ranks = torch.arange(1, v + 1, dtype=torch.float64, device=device)
    cdf = ranks.pow_(-zipf).cumsum_(0)
    cdf /= cdf[-1].clone()
    perm = torch.randperm(v, generator=gen, device=device)
    u = torch.rand(units * rows * seq, generator=gen, device=device, dtype=torch.float64)
    ids = torch.searchsorted(cdf, u).clamp_(max=v - 1)
    return perm[ids].view(units, rows, seq)
