"""Model assembly for the port: init / forward / prefill / decode / param
counting — the SSM (Mamba-2) family of ``repro.models.lm``.

The params are a dict of tensors under the JAX package's names and layouts:
``(in, out)`` weights, each block's leaves stacked on a leading L axis, the
layers looped over in Python. So :mod:`repro_torch.bridge` carries a JAX
pytree over leaf for leaf, and the tests compare like with like.

Each prefill layer's SSD scan goes through the hand-written CUDA kernel
(:func:`repro_torch.kernels.ssd_scan.ssd_scan`) on a CUDA device, and
through its plain sequential version on the CPU. Decode is plain PyTorch
around :func:`repro_torch.models.ssm.ssd_step`. The dense projections and
the tied LM head are plain large matmuls (``torch.matmul``).

Attention, MoE, hybrid and frontend configs raise ``NotImplementedError``:
those families come with later slices of the port.
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
from repro_torch.models.layers import rms_norm, trunc_normal
from repro_torch.models.ssm import causal_conv, causal_conv_update, ssd_step

VOCAB_PAD_MULTIPLE = 128

Params = dict[str, Any]


def padded_vocab(cfg: ModelConfig) -> int:
    return math.ceil(cfg.vocab_size / VOCAB_PAD_MULTIPLE) * VOCAB_PAD_MULTIPLE


def check_family(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` is a pure-SSM model,
    the only family the port runs so far."""
    missing = [what for what, on in (
        ("attention", cfg.has_attention), ("MoE", cfg.is_moe),
        ("hybrid attention+SSM", cfg.hybrid), ("dense FFN", cfg.d_ff > 0),
        (f"{cfg.frontend} frontend", bool(cfg.frontend)),
        ("layer norm (act='gelu')", cfg.act == "gelu"),
    ) if on]
    if missing or not cfg.has_ssm:
        raise NotImplementedError(
            f"{cfg.name}: the port runs attention-free SSM (Mamba-2) models only; "
            f"{', '.join(missing) or 'a model without SSM layers'} comes with a later "
            "slice of the port (ROADMAP.md §1, slice 7)"
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
    s = _ssm_dims(cfg)
    di, n, heads = s["d_inner"], s["n"], s["heads"]
    w = cfg.ssm_conv_width
    # The Mamba-2 in_proj/conv are split per component (z, x, B, C, dt), as in
    # the JAX package; mathematically identical to the fused checkpoint layout.
    return {
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
    }


def top_param_specs(cfg: ModelConfig) -> dict[str, tuple[tuple, int, str]]:
    check_family(cfg)
    d, vp = cfg.d_model, padded_vocab(cfg)
    specs = {"embed": ((vp, d), d, "normal"), "final_norm": ((d,), 0, "ones")}
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


def _layer(params: Params, i: int) -> Params:
    return {name: leaf[i] for name, leaf in params["blocks"].items()}


def _logits(params: Params, cfg: ModelConfig, h: Tensor) -> Tensor:
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (h @ head.to(h.dtype)).float()


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: Tensor,
    collect_cache: bool = False,
    cache_dtype=torch.bfloat16,
) -> tuple[Tensor, Tensor] | tuple[Tensor, Tensor, Params]:
    """Full-sequence forward. Returns (logits fp32 (B,S,Vp), aux_loss) — plus
    the assembled decode cache when ``collect_cache`` (prefill). The SSM
    family has no router, so aux_loss is 0."""
    check_family(cfg)
    h = params["embed"][tokens]
    states, tails = [], []
    for i in range(cfg.num_layers):
        out, state, conv_tail = _ssm_block(_layer(params, i), h, cfg)
        h = h + out
        if collect_cache:
            states.append(state)
            tails.append(conv_tail.to(cache_dtype))
    logits = _logits(params, cfg, h)
    aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    if collect_cache:
        cache = {
            "ssm_state": torch.stack(states),
            "conv_state": torch.stack(tails),
            "pos": torch.full((logits.shape[0],), h.shape[1], dtype=torch.int32,
                              device=logits.device),
        }
        return logits, aux, cache
    return logits, aux


def prefill_step(
    params: Params,
    cfg: ModelConfig,
    tokens: Tensor,
    cache_dtype=torch.bfloat16,
    cache_len: int | None = None,
) -> tuple[Tensor, Params]:
    """Serving prefill: run the prompt, return (last-token logits, cache).

    ``cache_len`` (prompt + generation headroom) sizes an attention KV ring
    in the JAX package; an SSM cache is O(1) in length and ignores it.
    """
    logits, _, cache = forward(params, cfg, tokens, collect_cache=True,
                               cache_dtype=cache_dtype)
    return logits[:, -1:, :], cache


# ---------------------------------------------------------------------------
# Decode (serving)
# ---------------------------------------------------------------------------

def init_cache(
    cfg: ModelConfig, batch: int, seq_len: int, dtype=torch.bfloat16,
    prefilled: int = 0, device=None,
) -> Params:
    """Decode-state dict. ``prefilled`` marks how many positions are done;
    ``seq_len`` sizes an attention KV ring, which the SSM family has not."""
    check_family(cfg)
    dev = resolve_device(device)
    dims = _ssm_dims(cfg)
    return {
        "pos": torch.full((batch,), prefilled, dtype=torch.int32, device=dev),
        "ssm_state": torch.zeros(
            (cfg.num_layers, batch, dims["heads"], cfg.ssm_head_dim, dims["n"]),
            dtype=torch.float32, device=dev,
        ),
        "conv_state": torch.zeros(
            (cfg.num_layers, batch, cfg.ssm_conv_width - 1, dims["conv_dim"]),
            dtype=dtype, device=dev,
        ),
    }


def decode_step(params: Params, cfg: ModelConfig, cache: Params,
                tokens: Tensor) -> tuple[Tensor, Params]:
    """One serving step: (B, 1) new tokens -> (B, 1, Vp) fp32 logits + a new
    cache (the old one is not modified)."""
    check_family(cfg)
    b = tokens.shape[0]
    dims = _ssm_dims(cfg)
    di, n, heads = dims["d_inner"], dims["n"], dims["heads"]
    h = params["embed"][tokens]                            # (B,1,D)
    states, convs = [], []
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        ns = rms_norm(h, lp["ln_ssm"], cfg.norm_eps)[:, 0]  # (B, D)
        z = ns @ lp["w_z"]
        x_raw = ns @ lp["w_x"]
        b_raw = ns @ lp["w_b"]
        c_raw = ns @ lp["w_c"]
        dt_raw = ns @ lp["w_dt"]
        xbc = torch.cat([x_raw, b_raw, c_raw], dim=-1)
        conv_w = torch.cat([lp["conv_x_w"], lp["conv_b_w"], lp["conv_c_w"]], dim=-1)
        conv_b = torch.cat([lp["conv_x_b"], lp["conv_b_b"], lp["conv_c_b"]], dim=-1)
        conv_out, conv_state = causal_conv_update(cache["conv_state"][i], xbc, conv_w, conv_b)
        xbc = F.silu(conv_out)
        x_in = xbc[:, :di].reshape(b, heads, cfg.ssm_head_dim)
        b_vec = xbc[:, di:di + n]
        c_vec = xbc[:, di + n:]
        dt = F.softplus(dt_raw.float() + lp["dt_bias"])
        a = -torch.exp(lp["a_log"])
        y, state = ssd_step(x_in, dt, a, b_vec, c_vec, cache["ssm_state"][i])
        y = y + lp["d_skip"][None, :, None].to(y.dtype) * x_in
        y = y.reshape(b, 1, di)
        y = rms_norm(y * F.silu(z[:, None, :]), lp["ssm_norm"], cfg.norm_eps)
        h = h + y @ lp["ssm_out"]
        states.append(state)
        convs.append(conv_state)
    logits = _logits(params, cfg, h)
    return logits, {
        "ssm_state": torch.stack(states),
        "conv_state": torch.stack(convs),
        "pos": cache["pos"] + 1,
    }
