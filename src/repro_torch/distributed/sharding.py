"""Logical-axis sharding rules with semantic divisibility fallback — the
port of ``repro.distributed.sharding``.

Every parameter name of :func:`repro_torch.models.lm.layer_param_specs` /
``top_param_specs`` maps to a tuple of *logical axes*; logical axes resolve
to mesh axes through :data:`RULES`; and each (logical axis, config) pair has
a semantic divisibility condition (``q_out`` shards by *head count*, not by
the flat fused dim). Failing the condition falls back to replication and
is reported, never fatal: qwen2's 14 heads on a 16-way model axis.

These are pure rules: they read only ``mesh.shape`` (a mapping of axis name
to size, :class:`repro_torch.distributed.mesh.Mesh`'s or anything shaped
so) and answer for any axis sizes. A spec is the port's own type, a tuple
with one entry per dimension, entry by entry the reference's
``PartitionSpec``: ``None`` (replicated), an axis name, or a tuple of
names. The port runs at world size 1, so nothing is moved by them; the
serving steps return them as the reference's do.
"""

from __future__ import annotations

import math
from typing import Any

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import layer_param_specs, padded_vocab, top_param_specs

__all__ = ["RULES", "axis_size", "batch_pspecs", "cache_pspecs", "logits_pspec",
           "param_pspecs", "resolve_kv_shard"]

#: A sharding spec: one entry per dimension (None, an axis name or a tuple
#: of names), as ``tuple(jax.sharding.PartitionSpec(...))``.
Spec = tuple

#: logical axis -> mesh axes (None = always replicated)
RULES: dict[str, tuple[str, ...] | None] = {
    "embed": None,            # d_model activations/params replicated on model
    "layers": None,           # stacked-layer axis
    "vocab": ("model",),
    "q_out": ("model",),      # attention heads × head_dim (shard by heads)
    "kv_out": ("model",),     # kv heads × head_dim
    "mlp": ("model",),        # FFN hidden
    "experts": None,          # TP-in-expert design: E replicated
    "ssm_inner": ("model",),  # d_inner, shard by SSD heads
    "ssm_heads": ("model",),
    "ssm_state": None,        # B/C projections shared across heads
    "conv_w": None,
    "stub": None,
    "batch": ("pod", "data"),
    "seq": None,
}


def axis_size(mesh, names: tuple[str, ...] | None) -> int:
    if not names:
        return 1
    return math.prod(mesh.shape[n] for n in names if n in mesh.shape)


def _shardable(logical: str, cfg: ModelConfig, size: int) -> bool:
    """Semantic divisibility of logical axis ``logical`` by ``size`` devices."""
    if size == 1:
        return True
    checks = {
        "vocab": lambda: padded_vocab(cfg) % size == 0,
        "q_out": lambda: cfg.num_heads % size == 0,
        "kv_out": lambda: cfg.num_kv_heads % size == 0,
        "mlp": lambda: (cfg.moe_d_ff or cfg.d_ff) % size == 0,
        "ssm_inner": lambda: cfg.ssm_heads % size == 0,
        "ssm_heads": lambda: cfg.ssm_heads % size == 0,
    }
    fn = checks.get(logical)
    return True if fn is None else fn()


#: parameter name -> logical axes (excluding the stacked "layers" dim).
_LAYER_LOGICAL: dict[str, tuple[str, ...]] = {
    "ln1": ("embed",), "ln1_bias": ("embed",), "ln2": ("embed",),
    "ln2_bias": ("embed",), "ln_ssm": ("embed",),
    "branch_attn_norm": ("embed",), "branch_ssm_norm": ("embed",),
    "wq": ("embed", "q_out"), "wk": ("embed", "kv_out"), "wv": ("embed", "kv_out"),
    "wo": ("q_out", "embed"),
    "bq": ("q_out",), "bk": ("kv_out",), "bv": ("kv_out",),
    "w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"), "w_down": ("mlp", "embed"),
    "b_up": ("mlp",), "b_down": ("embed",),
    "router": ("embed", "experts"),
    "we_gate": ("experts", "embed", "mlp"),
    "we_up": ("experts", "embed", "mlp"),
    "we_down": ("experts", "mlp", "embed"),
    "ws_gate": ("embed", "mlp"), "ws_up": ("embed", "mlp"), "ws_down": ("mlp", "embed"),
    "w_z": ("embed", "ssm_inner"), "w_x": ("embed", "ssm_inner"),
    "w_b": ("embed", "ssm_state"), "w_c": ("embed", "ssm_state"),
    "w_dt": ("embed", "ssm_heads"),
    "conv_x_w": ("conv_w", "ssm_inner"), "conv_x_b": ("ssm_inner",),
    "conv_b_w": ("conv_w", "ssm_state"), "conv_b_b": ("ssm_state",),
    "conv_c_w": ("conv_w", "ssm_state"), "conv_c_b": ("ssm_state",),
    "a_log": ("ssm_heads",), "d_skip": ("ssm_heads",), "dt_bias": ("ssm_heads",),
    "ssm_norm": ("ssm_inner",), "ssm_out": ("ssm_inner", "embed"),
}

_TOP_LOGICAL: dict[str, tuple[str, ...]] = {
    "embed": ("vocab", "embed"),
    "lm_head": ("embed", "vocab"),
    "final_norm": ("embed",), "final_norm_bias": ("embed",),
    "frontend_proj": ("stub", "embed"), "frontend_norm": ("embed",),
}


def _resolve(logical: tuple[str, ...], cfg: ModelConfig, mesh, log: dict | None) -> Spec:
    parts: list[Any] = []
    for lax in logical:
        mesh_axes = RULES.get(lax)
        if mesh_axes is None:
            parts.append(None)
            continue
        present = tuple(a for a in mesh_axes if a in mesh.shape)
        size = axis_size(mesh, present)
        if present and _shardable(lax, cfg, size):
            parts.append(present if len(present) > 1 else present[0])
        else:
            parts.append(None)
            if log is not None and size > 1:
                log.setdefault("replicated_fallbacks", []).append(lax)
    return tuple(parts)


def param_pspecs(cfg: ModelConfig, mesh, log: dict | None = None) -> dict:
    """Spec tree exactly matching ``init_params``' structure; ``log``
    gathers the logical axes that fell back to replication under
    ``"replicated_fallbacks"``."""
    specs: dict[str, Any] = {"blocks": {}}
    for name in top_param_specs(cfg):
        specs[name] = _resolve(_TOP_LOGICAL[name], cfg, mesh, log)
    for name in layer_param_specs(cfg):
        inner = _resolve(_LAYER_LOGICAL[name], cfg, mesh, log)
        specs["blocks"][name] = (None,) + inner       # leading stacked-layer axis
    return specs


def _batch_axes(mesh, batch: int) -> Any:
    present = tuple(a for a in ("pod", "data") if a in mesh.shape)
    if not present:
        return None
    size = axis_size(mesh, present)
    if batch % size == 0:
        return present if len(present) > 1 else present[0]
    # partial fallback: shard over the largest prefix that divides
    for cut in range(len(present) - 1, 0, -1):
        sub = present[:cut]
        if batch % axis_size(mesh, sub) == 0:
            return sub if len(sub) > 1 else sub[0]
    return None


def _tree_specs(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _tree_specs(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def batch_pspecs(batch_tree: dict, mesh, batch_size: int) -> dict:
    """Shard every batch leaf on its leading (batch) axis. Leaves are
    anything with a ``shape``."""
    ax = _batch_axes(mesh, batch_size)
    return _tree_specs(batch_tree, lambda _, x: (ax,) + (None,) * (len(x.shape) - 1))


def cache_pspecs(cache_tree: dict, cfg: ModelConfig, mesh, batch_size: int,
                 kv_shard: str = "auto") -> dict:
    """Decode-cache specs: batch over ("pod", "data") plus one model-axis
    strategy for the KV cache:

      * "heads" — shard KV heads over "model" when divisible, else replicate;
      * "seq"   — shard the cache's sequence dim over "model" (split-KV
        decode, partial softmax statistics combined across shards);
      * "auto"  — "heads" when the KV heads divide the axis, else "seq".
    """
    if kv_shard == "auto":
        kv_shard = resolve_kv_shard(cfg, mesh)
    ax = _batch_axes(mesh, batch_size)
    msize = axis_size(mesh, ("model",))
    kv_ok = cfg.num_kv_heads % msize == 0 if msize > 1 else True
    ssm_ok = cfg.ssm_heads % msize == 0 if (msize > 1 and cfg.has_ssm) else True

    def kv_spec(x):
        # (L, B, S, Hkv, hd)
        if kv_shard == "seq" and msize > 1 and x.shape[2] % msize == 0:
            return (None, ax, "model", None, None)
        return (None, ax, None, "model" if kv_ok else None, None)

    def leaf_spec(path, x):
        name = path[-1]
        if name == "pos":
            return (ax,)
        if name in ("k", "v"):
            return kv_spec(x)
        if name == "ssm_state":      # (L, B, H, P, N)
            return (None, ax, "model" if ssm_ok else None, None, None)
        if name == "conv_state":     # (L, B, W-1, conv_dim)
            return (None, ax, None, None)
        return (None,) * len(x.shape)

    return _tree_specs(cache_tree, leaf_spec)


def resolve_kv_shard(cfg: ModelConfig, mesh) -> str:
    """'heads' when kv heads divide the model axis, else 'seq' (split-KV)."""
    msize = axis_size(mesh, ("model",))
    if msize <= 1 or not cfg.has_attention:
        return "heads"
    return "heads" if cfg.num_kv_heads % msize == 0 else "seq"


def logits_pspec(cfg: ModelConfig, mesh, batch_size: int) -> Spec:
    ax = _batch_axes(mesh, batch_size)
    msize = axis_size(mesh, ("model",))
    vocab_ok = padded_vocab(cfg) % msize == 0 if msize > 1 else True
    return (ax, None, "model" if vocab_ok else None)
