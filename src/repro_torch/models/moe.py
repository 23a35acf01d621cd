"""Mixture-of-Experts FFN: top-k routing with sort-based dispatch.

The port of ``repro.models.moe``'s local path, as plain PyTorch (the JAX
package's expert products are ``jnp.einsum`` outside any Pallas kernel):

* routing in fp32: softmax over the experts, top-k with ties to the lower
  expert index (``jax.lax.top_k``'s rule, pinned by a stable sort), gates
  renormalised, the Switch load-balance aux loss;
* per-sequence dispatch: each row's (token, choice) pairs are stably sorted
  by expert and packed into capacity-``C`` buffers; a pair past its
  expert's capacity is dropped (standard capacity-factor semantics);
* the expert SwiGLU on every row at once: buffers laid out (E, B·C, D) so
  each projection is one ``torch.bmm`` over the E experts, reading each
  expert's weights once per call whatever the batch;
* the combine gathers each token's k expert outputs back into (B, S, k, D)
  and sums over k in a fixed order. The reference scatter-adds into the
  token; the sums differ by fp32 rounding only, and no atomics make the
  port's logits vary from run to run.

Buffers are built and read by gathers only (no scatter into a buffer, so
no out-of-range index to drop): a buffer slot (e, b, c) is filled iff
``c < counts[b, e]``, from the pair at sorted position ``offsets[b, e] + c``.

The reference picks a ``shard_map`` branch over the batch and model axes
from the ambient mesh (``get_abstract_mesh``); with those axes of size 1,
or no mesh, it takes ``_moe_local``, the path computed here. The port runs
at world size 1 and has no ambient mesh, so ``moe_ffn`` takes no mesh
argument and is that path on every call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import swiglu


def expert_capacity(seq_len: int, cfg: ModelConfig, capacity_factor: float) -> int:
    """Static per-sequence expert capacity C: ``ceil`` of the factor's share
    as the reference rounds it (``int(raw + 0.999)``), >= 1, rounded up to a
    multiple of 8 from S = 64 on."""
    raw = capacity_factor * seq_len * cfg.top_k / cfg.num_experts
    c = max(int(raw + 0.999), 1)
    return max((c + 7) // 8 * 8, 8) if seq_len >= 64 else c


def route_topk(x: Tensor, w_router: Tensor, top_k: int) -> tuple[Tensor, Tensor, Tensor]:
    """fp32 router over (..., S, D) tokens: (gates (..., S, k), expert_idx
    (..., S, k) int64, aux (...)) — one aux per sequence, a scalar for a
    single (S, D) sequence."""
    probs = torch.softmax(x.float() @ w_router.float(), dim=-1)      # (..., S, E)
    # A stable descending sort puts equal probabilities in index order, as
    # jax.lax.top_k does; torch.topk promises no order on ties.
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :top_k], idx[..., :top_k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch load-balance loss: E * sum_e fraction_e * mean_prob_e.
    e = probs.shape[-1]
    flat = idx.flatten(-2)                                           # (..., S*k)
    occupancy = torch.zeros(flat.shape[:-1] + (e,), dtype=torch.float32, device=x.device)
    occupancy.scatter_add_(-1, flat, torch.ones_like(flat, dtype=torch.float32))
    frac = occupancy / occupancy.sum(-1, keepdim=True).clamp_min(1.0)
    aux = e * (frac * probs.mean(dim=-2)).sum(-1)
    return gates, idx, aux


def dispatch_plan(idx: Tensor, num_experts: int, cap: int) -> dict[str, Tensor]:
    """Each row's stable sort of its (token, choice) pairs by expert.

    ``idx``: (B, S, k) expert ids. Returns, per row, with pairs flat over
    (S·k,) in the original order (token-major): ``sort_i`` (the stable
    argsort), ``counts`` and ``offsets`` (B, E) (pairs per expert and their
    first sorted position), and ``pos`` (each pair's slot in its expert's
    buffer; kept iff ``pos < cap``).
    """
    b, s, k = idx.shape
    flat_e = idx.reshape(b, s * k)
    sort_i = torch.argsort(flat_e, dim=-1, stable=True)
    counts = torch.zeros((b, num_experts), dtype=torch.int64, device=idx.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    offsets = counts.cumsum(1) - counts
    pos_sorted = torch.arange(s * k, device=idx.device) - offsets.gather(
        1, flat_e.gather(1, sort_i))
    pos = torch.empty_like(pos_sorted).scatter_(1, sort_i, pos_sorted)
    return {"sort_i": sort_i, "counts": counts, "offsets": offsets, "pos": pos}


def _gather_buffers(x: Tensor, plan: dict[str, Tensor], k: int, cap: int) -> Tensor:
    """Pack (B, S, D) tokens into (E, B·C, D) expert buffers; unfilled
    slots are 0."""
    b, s, d = x.shape
    offsets, counts = plan["offsets"], plan["counts"]               # (B, E)
    slot = torch.arange(cap, device=x.device)
    src = (offsets[:, :, None] + slot).clamp_max(s * k - 1)          # (B, E, C) sorted positions
    tok = plan["sort_i"].gather(1, src.reshape(b, -1)).reshape(src.shape) // k
    rows = tok + s * torch.arange(b, device=x.device)[:, None, None]
    filled = slot < counts[:, :, None]                               # (B, E, C)
    e = offsets.shape[1]
    buf = x.reshape(b * s, d).index_select(0, rows.transpose(0, 1).reshape(-1))
    buf = buf.view(e, b * cap, d)
    return torch.where(filled.transpose(0, 1).reshape(e, b * cap, 1), buf, 0.0)


def _dispatch_one_row(x: Tensor, gates: Tensor, idx: Tensor, num_experts: int, cap: int):
    """One sequence's dispatch in the reference's terms: (buffers (E, C, D),
    dest, token_src, weight), the last three flat over (S·k,) in sorted
    order; ``dest`` is out of range (>= E·C) for dropped pairs."""
    s, k = idx.shape
    plan = dispatch_plan(idx[None], num_experts, cap)
    buf = _gather_buffers(x[None], plan, k, cap)
    sort_i = plan["sort_i"][0]
    sorted_e, pos = idx.reshape(-1)[sort_i], plan["pos"][0][sort_i]
    dest = torch.where(pos < cap, sorted_e * cap + pos,
                       torch.full_like(pos, s * k + num_experts * cap))
    return buf, dest, sort_i // k, gates.reshape(-1)[sort_i]


def _moe_local(x, w_router, we_gate, we_up, we_down, cfg: ModelConfig, cap: int):
    """MoE over (B, S, D) rows, each row routed and packed on its own, the
    experts run on every row's buffers at once. Returns (y, mean aux)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    gates, idx, aux = route_topk(x, w_router, k)                   # (B,S,k), (B,S,k), (B,)
    plan = dispatch_plan(idx, e, cap)
    buf = _gather_buffers(x, plan, k, cap)                          # (E, B·C, D)
    h = F.silu(torch.bmm(buf, we_gate)) * torch.bmm(buf, we_up)
    out = torch.bmm(h, we_down).reshape(e * b * cap, d)             # rows (e, b, c)
    pos = plan["pos"].reshape(b, s, k)
    row = (idx * b + torch.arange(b, device=x.device)[:, None, None]) * cap + pos.clamp_max(cap - 1)
    got = out.index_select(0, row.reshape(-1)).view(b, s, k, d)
    got = torch.where((pos < cap)[..., None], got, 0.0)
    y = (got * gates[..., None]).to(x.dtype).sum(dim=2)
    return y, aux.mean()


def moe_ffn(
    x: Tensor,
    w_router: Tensor,
    we_gate: Tensor,
    we_up: Tensor,
    we_down: Tensor,
    cfg: ModelConfig,
    capacity_factor: float = 1.25,
) -> tuple[Tensor, Tensor]:
    """Top-k MoE over (B, S, D) activations.

    Expert weights: we_gate/we_up (E, D, F), we_down (E, F, D).
    Returns (output (B, S, D), aux_loss scalar: the rows' mean).
    """
    cap = expert_capacity(x.shape[1], cfg, capacity_factor)
    return _moe_local(x, w_router, we_gate, we_up, we_down, cfg, cap)


def shared_expert_ffn(x: Tensor, ws_gate: Tensor, ws_up: Tensor, ws_down: Tensor) -> Tensor:
    """DeepSeekMoE shared experts — a fused dense SwiGLU over all tokens."""
    return swiglu(x, ws_gate, ws_up, ws_down)
