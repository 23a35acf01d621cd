"""Model assembly for the port: init / forward / prefill / decode / param
counting — the dense attention, SSM (Mamba-2), MoE and hybrid families of
``repro.models.lm``.

The params are a dict of tensors under the JAX package's names and layouts:
``(in, out)`` weights, each block's leaves stacked on a leading L axis, the
layers looped over in Python. So :mod:`repro_torch.bridge` carries a JAX
pytree over leaf for leaf, and the tests compare like with like.

A layer's mixer is attention (GQA with RoPE,
:mod:`repro_torch.models.attention`), a Mamba-2 SSD mixer, or — hybrid
(Hymba) — both in parallel, each branch RMS-normed and the two averaged.
Its FFN is a top-k MoE (:mod:`repro_torch.models.moe`, plus shared
experts) when the config has experts, else a dense FFN (SwiGLU with
RMSNorm, or GELU with LayerNorm) when ``d_ff > 0``. Each prefill layer's
SSD scan goes through the hand-written CUDA kernel
(:func:`repro_torch.kernels.ssd_scan.ssd_scan`) on a CUDA device, and
through its plain sequential version on the CPU. Attention and the MoE
are plain PyTorch, as the JAX package's are plain ``jnp``. The
projections, the FFN and the LM head are plain matmuls (``torch.matmul``).

The decode cache holds, per attention layer, a KV ring of ``sc`` slots
(slot ``j`` holds the position ``p`` with ``p % sc == j``), and per SSM
layer the recurrent state and the conv tail; ``pos`` (int32) counts the
positions done.

Frontend configs raise ``NotImplementedError``: that family comes with
the next slice of the port.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import Tensor

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.attention import attend_blockwise, attend_decode, attend_naive
from repro_torch.models.layers import (
    apply_rope,
    gelu_mlp,
    layer_norm,
    rms_norm,
    rope_table,
    swiglu,
    trunc_normal,
)
from repro_torch.models.moe import moe_ffn, shared_expert_ffn
from repro_torch.models.ssm import causal_conv, causal_conv_update, ssd_step

VOCAB_PAD_MULTIPLE = 128

Params = dict[str, Any]


def padded_vocab(cfg: ModelConfig) -> int:
    return math.ceil(cfg.vocab_size / VOCAB_PAD_MULTIPLE) * VOCAB_PAD_MULTIPLE


def check_family(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for the family the port does not run
    yet: modality frontends. Dense attention (SwiGLU or GELU, causal or
    not, QKV bias, sliding window, tied or untied head), Mamba-2 SSM, MoE
    and hybrid attention + SSM models pass."""
    if cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: the port runs the dense attention, SSM (Mamba-2), MoE and hybrid "
            f"families; the {cfg.frontend} frontend comes with the next slice of the port "
            "(ROADMAP.md §1, slice 7b)"
        )


# ---------------------------------------------------------------------------
# Param specs (single source of truth for init + counting)
# ---------------------------------------------------------------------------

def _ssm_dims(cfg: ModelConfig) -> dict[str, int]:
    d_inner = cfg.d_inner
    n = cfg.ssm_state
    heads = cfg.ssm_heads
    conv_dim = d_inner + 2 * n                  # the conv runs over [x | B | C]
    return dict(d_inner=d_inner, n=n, heads=heads, conv_dim=conv_dim)


def layer_param_specs(cfg: ModelConfig) -> dict[str, tuple[tuple, int, str]]:
    """name -> (shape, fan_in, kind) for one layer. kind: normal|zeros|ones|a_log|dt_bias."""
    check_family(cfg)
    d = cfg.d_model
    specs: dict[str, tuple[tuple, int, str]] = {}
    if cfg.has_attention:
        hd = cfg.resolved_head_dim
        specs["ln1"] = ((d,), 0, "ones")
        if cfg.act == "gelu":
            specs["ln1_bias"] = ((d,), 0, "zeros")
        specs["wq"] = ((d, cfg.num_heads * hd), d, "normal")
        specs["wk"] = ((d, cfg.num_kv_heads * hd), d, "normal")
        specs["wv"] = ((d, cfg.num_kv_heads * hd), d, "normal")
        specs["wo"] = ((cfg.num_heads * hd, d), cfg.num_heads * hd, "normal")
        if cfg.qkv_bias:
            specs["bq"] = ((cfg.num_heads * hd,), 0, "zeros")
            specs["bk"] = ((cfg.num_kv_heads * hd,), 0, "zeros")
            specs["bv"] = ((cfg.num_kv_heads * hd,), 0, "zeros")
    if cfg.has_ssm:
        s = _ssm_dims(cfg)
        di, n, heads = s["d_inner"], s["n"], s["heads"]
        w = cfg.ssm_conv_width
        # The Mamba-2 in_proj/conv are split per component (z, x, B, C, dt), as
        # in the JAX package; mathematically identical to the fused layout.
        specs.update({
            "ln_ssm": ((d,), 0, "ones"),
            "w_z": ((d, di), d, "normal"),
            "w_x": ((d, di), d, "normal"),
            "w_b": ((d, n), d, "normal"),
            "w_c": ((d, n), d, "normal"),
            "w_dt": ((d, heads), d, "normal"),
            "conv_x_w": ((w, di), w, "normal"),
            "conv_x_b": ((di,), 0, "zeros"),
            "conv_b_w": ((w, n), w, "normal"),
            "conv_b_b": ((n,), 0, "zeros"),
            "conv_c_w": ((w, n), w, "normal"),
            "conv_c_b": ((n,), 0, "zeros"),
            "a_log": ((heads,), 0, "a_log"),
            "d_skip": ((heads,), 0, "ones"),
            "dt_bias": ((heads,), 0, "dt_bias"),
            "ssm_norm": ((di,), 0, "ones"),
            "ssm_out": ((di, d), di, "normal"),
        })
    if cfg.hybrid:
        specs["branch_attn_norm"] = ((d,), 0, "ones")
        specs["branch_ssm_norm"] = ((d,), 0, "ones")
    if cfg.is_moe:
        f = cfg.moe_d_ff or cfg.d_ff
        specs["ln2"] = ((d,), 0, "ones")
        specs["router"] = ((d, cfg.num_experts), d, "normal")
        specs["we_gate"] = ((cfg.num_experts, d, f), d, "normal")
        specs["we_up"] = ((cfg.num_experts, d, f), d, "normal")
        specs["we_down"] = ((cfg.num_experts, f, d), f, "normal")
        if cfg.num_shared_experts:
            fs = cfg.num_shared_experts * f
            specs["ws_gate"] = ((d, fs), d, "normal")
            specs["ws_up"] = ((d, fs), d, "normal")
            specs["ws_down"] = ((fs, d), fs, "normal")
    elif cfg.d_ff > 0:
        f = cfg.d_ff
        specs["ln2"] = ((d,), 0, "ones")
        if cfg.act == "gelu":
            specs["ln2_bias"] = ((d,), 0, "zeros")
            specs["w_up"] = ((d, f), d, "normal")
            specs["b_up"] = ((f,), 0, "zeros")
            specs["w_down"] = ((f, d), f, "normal")
            specs["b_down"] = ((d,), 0, "zeros")
        else:
            specs["w_gate"] = ((d, f), d, "normal")
            specs["w_up"] = ((d, f), d, "normal")
            specs["w_down"] = ((f, d), f, "normal")
    return specs


def top_param_specs(cfg: ModelConfig) -> dict[str, tuple[tuple, int, str]]:
    check_family(cfg)
    d, vp = cfg.d_model, padded_vocab(cfg)
    specs = {"embed": ((vp, d), d, "normal"), "final_norm": ((d,), 0, "ones")}
    if cfg.act == "gelu":
        specs["final_norm_bias"] = ((d,), 0, "zeros")
    if not cfg.tie_embeddings:
        specs["lm_head"] = ((d, vp), d, "normal")
    return specs


def _init_one(gen: torch.Generator, shape: tuple, fan_in: int, kind: str, dtype,
              device) -> Tensor:
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if kind == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if kind == "a_log":
        # Mamba-2 init: A ~ uniform[1, 16]  =>  store log A (kept fp32: state math).
        u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
        return torch.log(u * 15.0 + 1.0)
    if kind == "dt_bias":
        # dt ~ loguniform[1e-3, 1e-1]; store softplus^{-1}(dt) (kept fp32).
        u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        return torch.log(torch.expm1(dt))
    return trunc_normal(gen, shape, fan_in, dtype, device=device)


def init_params(cfg: ModelConfig, generator: torch.Generator, dtype=torch.float32,
                device=None) -> Params:
    """Initialize the parameter dict (blocks stacked on L) on ``device``
    (``None``: CUDA), from ``generator`` (which must live on that device).
    The draws differ from JAX's threefry ones; the distributions match."""
    dev = resolve_device(device)
    lspecs, tspecs = layer_param_specs(cfg), top_param_specs(cfg)
    params: Params = {"blocks": {}}
    for name, (shape, fan, kind) in tspecs.items():
        params[name] = _init_one(generator, shape, fan, kind, dtype, dev)
    for name, (shape, fan, kind) in lspecs.items():
        params["blocks"][name] = _init_one(
            generator, (cfg.num_layers,) + shape, fan, kind, dtype, dev
        )
    return params


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact parameter count implied by the specs (== leaves of init_params).

    ``active_only`` counts the parameters one token activates: routed
    expert leaves (``we_*``) scale by ``top_k / num_experts``.
    """
    total = sum(math.prod(s) for s, _, _ in top_param_specs(cfg).values())
    for name, (shape, _, _) in layer_param_specs(cfg).items():
        n = math.prod(shape)
        if active_only and name.startswith("we_"):
            n = n * cfg.top_k // cfg.num_experts
        total += n * cfg.num_layers
    return total


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _norm(h: Tensor, scale: Tensor, bias: Tensor | None, cfg: ModelConfig) -> Tensor:
    """LayerNorm for the GELU family, RMSNorm otherwise."""
    if cfg.act == "gelu":
        return layer_norm(h, scale, bias, cfg.norm_eps)
    return rms_norm(h, scale, cfg.norm_eps)


def _qkv(lp: Params, h: Tensor, cfg: ModelConfig, sin: Tensor, cos: Tensor, rope: bool):
    """Norm, the Q/K/V projections (with biases), heads split, RoPE when
    ``rope``. Returns q (B,S,H,hd), k and v (B,S,Hkv,hd)."""
    b, s, _ = h.shape
    hd = cfg.resolved_head_dim
    norm = _norm(h, lp["ln1"], lp.get("ln1_bias"), cfg)
    q, k, v = norm @ lp["wq"], norm @ lp["wk"], norm @ lp["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = q.reshape(b, s, cfg.num_heads, hd)
    k = k.reshape(b, s, cfg.num_kv_heads, hd)
    v = v.reshape(b, s, cfg.num_kv_heads, hd)
    if rope:
        q, k = apply_rope(q, sin, cos), apply_rope(k, sin, cos)
    return q, k, v


def _attn_block(lp: Params, h: Tensor, cfg: ModelConfig, sin: Tensor, cos: Tensor,
                attn_impl: str, positions: Tensor):
    """Attention half-block (prefill form). Returns (out, (k, v))."""
    b, s, _ = h.shape
    # RoPE for decoder LMs; the encoder backbone uses none.
    q, k, v = _qkv(lp, h, cfg, sin, cos, rope=cfg.causal)
    attend = attend_blockwise if attn_impl == "blockwise" else attend_naive
    out = attend(q, k, v, positions, positions, causal=cfg.causal, window=cfg.sliding_window)
    return out.reshape(b, s, cfg.num_heads * cfg.resolved_head_dim) @ lp["wo"], (k, v)


def ssd_layer_inputs(lp: Params, h: Tensor, cfg: ModelConfig):
    """One Mamba-2 layer up to its SSD scan: norm, projections, causal convs.

    Returns (z, x_in (B,S,H,P), dt (B,S,H) fp32, a (H,), b_mat, c_mat,
    conv_tail) — the scan's operands, the gate, and the conv ring state.
    """
    b, s, _ = h.shape
    norm = rms_norm(h, lp["ln_ssm"], cfg.norm_eps)
    z = norm @ lp["w_z"]
    x_raw = norm @ lp["w_x"]
    b_raw = norm @ lp["w_b"]
    c_raw = norm @ lp["w_c"]
    dt_raw = norm @ lp["w_dt"]                          # (B,S,H)
    tail = cfg.ssm_conv_width - 1
    conv_tail = torch.cat([x_raw[:, -tail:], b_raw[:, -tail:], c_raw[:, -tail:]], dim=-1)
    x_c = F.silu(causal_conv(x_raw, lp["conv_x_w"], lp["conv_x_b"]))
    b_mat = F.silu(causal_conv(b_raw, lp["conv_b_w"], lp["conv_b_b"]))
    c_mat = F.silu(causal_conv(c_raw, lp["conv_c_w"], lp["conv_c_b"]))
    x_in = x_c.reshape(b, s, cfg.ssm_heads, cfg.ssm_head_dim)
    dt = F.softplus(dt_raw.float() + lp["dt_bias"])
    a = -torch.exp(lp["a_log"])
    return z, x_in, dt, a, b_mat, c_mat, conv_tail


def _ssm_block(lp: Params, h: Tensor, cfg: ModelConfig):
    """Mamba-2 layer body (prefill form).

    Returns (out, final_state, conv_tail) — conv_tail is the last (W-1) raw
    [x|B|C] projections, i.e. exactly the conv ring state decode_step carries.
    """
    b, s, _ = h.shape
    z, x_in, dt, a, b_mat, c_mat, conv_tail = ssd_layer_inputs(lp, h, cfg)
    y, state = ssd_scan(x_in, dt, a, b_mat, c_mat, chunk=min(cfg.ssm_chunk, s))
    y = y + lp["d_skip"][None, None, :, None].to(y.dtype) * x_in
    y = y.reshape(b, s, cfg.d_inner)
    y = rms_norm(y * F.silu(z), lp["ssm_norm"], cfg.norm_eps)
    return y @ lp["ssm_out"], state, conv_tail


def _mlp_block(lp: Params, h: Tensor, cfg: ModelConfig) -> tuple[Tensor, Tensor | None]:
    """FFN half-block: (out, aux). MoE (routed experts plus any shared
    ones) with its router's aux loss; else GELU with LayerNorm, or SwiGLU
    with RMSNorm, and aux ``None`` (no router)."""
    if cfg.is_moe:
        norm = rms_norm(h, lp["ln2"], cfg.norm_eps)
        out, aux = moe_ffn(norm, lp["router"], lp["we_gate"], lp["we_up"], lp["we_down"], cfg)
        if cfg.num_shared_experts:
            out = out + shared_expert_ffn(norm, lp["ws_gate"], lp["ws_up"], lp["ws_down"])
        return out, aux
    if cfg.act == "gelu":
        norm = layer_norm(h, lp["ln2"], lp["ln2_bias"], cfg.norm_eps)
        return gelu_mlp(norm, lp["w_up"], lp["b_up"], lp["w_down"], lp["b_down"]), None
    norm = rms_norm(h, lp["ln2"], cfg.norm_eps)
    return swiglu(norm, lp["w_gate"], lp["w_up"], lp["w_down"]), None


def _mix(lp: Params, cfg: ModelConfig, attn_out: Tensor | None, ssm_out: Tensor | None) -> Tensor:
    """The mixer's residual term: the hybrid's mean of the two RMS-normed
    branches; else attention where the config has it (the JAX model's
    choice when a non-hybrid config has both), else the SSM."""
    if cfg.hybrid:
        return 0.5 * (rms_norm(attn_out, lp["branch_attn_norm"], cfg.norm_eps)
                      + rms_norm(ssm_out, lp["branch_ssm_norm"], cfg.norm_eps))
    return attn_out if cfg.has_attention else ssm_out


def _ring_gather(kv: Tensor, sc: int) -> Tensor:
    """(B, S, ...) -> (B, sc, ...) arranged so slot j holds the position p
    with p % sc == j (the ring layout decode_step expects).

    Slots with no matching position (sc > S: headroom for generation) hold
    clamped garbage — decode_step masks them out via ``_ring_positions``.
    """
    s = kv.shape[1]
    j = torch.arange(sc, device=kv.device)
    p = (s - 1) - torch.remainder((s - 1) - j, sc)
    return kv.index_select(1, p.clamp(0, s - 1))


def _layer(params: Params, i: int) -> Params:
    return {name: leaf[i] for name, leaf in params["blocks"].items()}


def _logits(params: Params, cfg: ModelConfig, h: Tensor) -> Tensor:
    h = _norm(h, params["final_norm"], params.get("final_norm_bias"), cfg)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (h @ head.to(h.dtype)).float()


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def _trunk(params: Params, cfg: ModelConfig, tokens: Tensor, attn_impl: str,
           collect_cache: bool, cache_dtype, cache_len: int | None):
    """Embed and every layer: (final hidden state (B,S,D), the layers'
    summed router aux (fp32 scalar, 0 without experts), cache or None)."""
    check_family(cfg)
    h = params["embed"][tokens]
    s = h.shape[1]
    positions = torch.arange(s, device=h.device)
    sin = cos = None
    if cfg.has_attention:
        sin, cos = rope_table(positions, cfg.resolved_head_dim, cfg.rope_theta)
        sc = cache_len_for(cfg, cache_len or s)
    caches: dict[str, list[Tensor]] = {}
    auxes: list[Tensor] = []
    attn_out = ssm_out = None
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        # A non-hybrid config with both still runs its SSM layer, for its
        # cache leaves (_mix takes attention).
        if cfg.has_attention:
            attn_out, (k, v) = _attn_block(lp, h, cfg, sin, cos, attn_impl, positions)
        if cfg.has_ssm:
            ssm_out, state, conv_tail = _ssm_block(lp, h, cfg)
        if cfg.has_attention or cfg.has_ssm:
            h = h + _mix(lp, cfg, attn_out, ssm_out)
        if collect_cache:
            if cfg.has_attention:
                caches.setdefault("k", []).append(_ring_gather(k, sc).to(cache_dtype))
                caches.setdefault("v", []).append(_ring_gather(v, sc).to(cache_dtype))
            if cfg.has_ssm:
                caches.setdefault("ssm_state", []).append(state)
                caches.setdefault("conv_state", []).append(conv_tail.to(cache_dtype))
        if cfg.d_ff > 0 or cfg.is_moe:
            mlp_out, aux = _mlp_block(lp, h, cfg)
            h = h + mlp_out
            if aux is not None:
                auxes.append(aux)
    aux = (torch.stack(auxes).sum() if auxes
           else torch.zeros((), dtype=torch.float32, device=h.device))
    if not collect_cache:
        return h, aux, None
    cache = {name: torch.stack(leaves) for name, leaves in caches.items()}
    cache["pos"] = torch.full((h.shape[0],), s, dtype=torch.int32, device=h.device)
    return h, aux, cache


def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: Tensor,
    attn_impl: str = "blockwise",
    collect_cache: bool = False,
    cache_dtype=torch.bfloat16,
    cache_len: int | None = None,
) -> tuple[Tensor, Tensor] | tuple[Tensor, Tensor, Params]:
    """Full-sequence forward. Returns (logits fp32 (B,S,Vp), aux_loss) — plus
    the assembled decode cache when ``collect_cache`` (prefill). aux_loss
    sums the MoE layers' router losses (each the mean over rows of the
    Switch loss); models without experts give 0. ``attn_impl``:
    ``"blockwise"`` or ``"naive"``."""
    h, aux, cache = _trunk(params, cfg, tokens, attn_impl, collect_cache, cache_dtype,
                           cache_len)
    logits = _logits(params, cfg, h)
    if collect_cache:
        return logits, aux, cache
    return logits, aux


def prefill_step(
    params: Params,
    cfg: ModelConfig,
    tokens: Tensor,
    attn_impl: str = "blockwise",
    cache_dtype=torch.bfloat16,
    cache_len: int | None = None,
) -> tuple[Tensor, Params]:
    """Serving prefill: run the prompt, return (last-token logits (B,1,Vp),
    cache). Only the last position goes through the LM head.

    ``cache_len``: total KV capacity (prompt + generation headroom);
    defaults to the prompt length (ring eviction starts immediately). An
    SSM cache is O(1) in length and ignores it.
    """
    h, _, cache = _trunk(params, cfg, tokens, attn_impl, True, cache_dtype, cache_len)
    return _logits(params, cfg, h[:, -1:]), cache


# ---------------------------------------------------------------------------
# Decode (serving)
# ---------------------------------------------------------------------------

def cache_len_for(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.sliding_window > 0 and cfg.has_attention:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def init_cache(
    cfg: ModelConfig, batch: int, seq_len: int, dtype=torch.bfloat16,
    prefilled: int = 0, device=None,
) -> Params:
    """Decode-state dict on ``device`` (``None``: CUDA). ``prefilled``
    marks how many positions are done; ``seq_len`` sizes the KV ring."""
    check_family(cfg)
    dev = resolve_device(device)
    cache: Params = {"pos": torch.full((batch,), prefilled, dtype=torch.int32, device=dev)}
    if cfg.has_attention:
        kv_shape = (cfg.num_layers, batch, cache_len_for(cfg, seq_len), cfg.num_kv_heads,
                    cfg.resolved_head_dim)
        cache["k"] = torch.zeros(kv_shape, dtype=dtype, device=dev)
        cache["v"] = torch.zeros(kv_shape, dtype=dtype, device=dev)
    if cfg.has_ssm:
        dims = _ssm_dims(cfg)
        cache["ssm_state"] = torch.zeros(
            (cfg.num_layers, batch, dims["heads"], cfg.ssm_head_dim, dims["n"]),
            dtype=torch.float32, device=dev,
        )
        cache["conv_state"] = torch.zeros(
            (cfg.num_layers, batch, cfg.ssm_conv_width - 1, dims["conv_dim"]),
            dtype=dtype, device=dev,
        )
    return cache


def _ring_positions(pos: Tensor, sc: int) -> Tensor:
    """(B, sc) absolute position held by each ring slot, −1 if unwritten."""
    j = torch.arange(sc, device=pos.device)
    last = pos[:, None].long() - 1
    p = last - torch.remainder(last - j[None, :], sc)
    return torch.where(p >= 0, p, torch.full_like(p, -1))


def _bits(x: Tensor) -> Tensor:
    """``x`` itself, or a uint8 view of a float8 tensor."""
    return x.view(torch.uint8) if x.element_size() == 1 and x.is_floating_point() else x


def _attn_decode(lp: Params, h: Tensor, cfg: ModelConfig, k_cache: Tensor, v_cache: Tensor,
                 pos: Tensor, sin: Tensor, cos: Tensor, uniform_pos: bool) -> Tensor:
    """One attention layer's decode step. Writes the new token's K/V into
    its ring slot of ``k_cache``/``v_cache`` (this layer's (B, sc, Hkv, hd)
    views, updated in place) and returns the layer's output (B, 1, D)."""
    b = h.shape[0]
    sc = k_cache.shape[1]
    # Decode rotates q and k whatever ``causal`` says, as the JAX model does.
    q, k, v = _qkv(lp, h, cfg, sin, cos, rope=True)
    for cache, new in ((k_cache, k), (v_cache, v)):
        # Written through a same-width integer view: torch has no index
        # copies for float8; the bits are the cast's either way.
        dst, src = _bits(cache), _bits(new.to(cache.dtype))
        if uniform_pos:
            # Every row is at one position: one slot for the whole batch.
            dst.index_copy_(1, torch.remainder(pos[:1].long(), sc), src)
        else:
            dst[torch.arange(b, device=pos.device), torch.remainder(pos.long(), sc)] = src[:, 0]
    out = attend_decode(q, k_cache, v_cache, pos, _ring_positions(pos + 1, sc),
                        window=cfg.sliding_window)
    return out.reshape(b, 1, cfg.num_heads * cfg.resolved_head_dim) @ lp["wo"]


def _ssm_decode(lp: Params, h: Tensor, cfg: ModelConfig, conv_state: Tensor,
                ssm_state: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """One Mamba-2 layer's decode step: (out (B,1,D), new state, new conv tail)."""
    b = h.shape[0]
    dims = _ssm_dims(cfg)
    di, n, heads = dims["d_inner"], dims["n"], dims["heads"]
    ns = rms_norm(h, lp["ln_ssm"], cfg.norm_eps)[:, 0]  # (B, D)
    z = ns @ lp["w_z"]
    x_raw = ns @ lp["w_x"]
    b_raw = ns @ lp["w_b"]
    c_raw = ns @ lp["w_c"]
    dt_raw = ns @ lp["w_dt"]
    xbc = torch.cat([x_raw, b_raw, c_raw], dim=-1)
    conv_w = torch.cat([lp["conv_x_w"], lp["conv_b_w"], lp["conv_c_w"]], dim=-1)
    conv_b = torch.cat([lp["conv_x_b"], lp["conv_b_b"], lp["conv_c_b"]], dim=-1)
    conv_out, conv_state = causal_conv_update(conv_state, xbc, conv_w, conv_b)
    xbc = F.silu(conv_out)
    x_in = xbc[:, :di].reshape(b, heads, cfg.ssm_head_dim)
    b_vec = xbc[:, di:di + n]
    c_vec = xbc[:, di + n:]
    dt = F.softplus(dt_raw.float() + lp["dt_bias"])
    a = -torch.exp(lp["a_log"])
    y, state = ssd_step(x_in, dt, a, b_vec, c_vec, ssm_state)
    y = y + lp["d_skip"][None, :, None].to(y.dtype) * x_in
    y = y.reshape(b, 1, di)
    y = rms_norm(y * F.silu(z[:, None, :]), lp["ssm_norm"], cfg.norm_eps)
    return y @ lp["ssm_out"], state, conv_state


def decode_step(params: Params, cfg: ModelConfig, cache: Params, tokens: Tensor,
                uniform_pos: bool = True) -> tuple[Tensor, Params]:
    """One serving step: (B, 1) new tokens -> (B, 1, Vp) fp32 logits + a new
    cache (the old one is not modified).

    ``uniform_pos``: every row is at the same position (``pos[0]``), so the
    new K/V go to one ring slot for the whole batch; ``False`` writes one
    slot per row (ragged batches).
    """
    check_family(cfg)
    pos = cache["pos"]                                     # (B,)
    h = params["embed"][tokens]                            # (B,1,D)
    new: Params = {}
    if cfg.has_attention:
        sin, cos = rope_table(pos[:, None], cfg.resolved_head_dim, cfg.rope_theta)  # (B,1,half)
        new["k"], new["v"] = cache["k"].clone(), cache["v"].clone()
    states, convs = [], []
    attn_out = ssm_out = None
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        if cfg.has_attention:
            attn_out = _attn_decode(lp, h, cfg, new["k"][i], new["v"][i], pos, sin, cos,
                                    uniform_pos)
        if cfg.has_ssm:
            ssm_out, state, conv_state = _ssm_decode(lp, h, cfg, cache["conv_state"][i],
                                                     cache["ssm_state"][i])
            states.append(state)
            convs.append(conv_state)
        if cfg.has_attention or cfg.has_ssm:
            h = h + _mix(lp, cfg, attn_out, ssm_out)
        if cfg.d_ff > 0 or cfg.is_moe:
            # One token per row: capacity 1, so no MoE pair is dropped.
            h = h + _mlp_block(lp, h, cfg)[0]
    if cfg.has_ssm:
        new["ssm_state"], new["conv_state"] = torch.stack(states), torch.stack(convs)
    new["pos"] = pos + 1
    return _logits(params, cfg, h), new
