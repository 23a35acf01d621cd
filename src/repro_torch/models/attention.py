"""GQA attention: naive, blockwise (flash-style, non-materializing), decode —
the port of ``repro.models.attention``, in plain PyTorch.

Three execution paths share one set of weights:

* ``attend_naive``     — materializes the (Sq, Sk) score matrix; the oracle
  for the blockwise path.
* ``attend_blockwise`` — online softmax over KV chunks, tiled over Q, so the
  live score block is (B, H, q_chunk, chunk) instead of (B, H, Sq, Sk). The
  JAX package's ``lax.scan`` over chunks is a Python loop here, its
  ``lax.map`` over Q tiles another.
* ``attend_decode``    — one query token against a (possibly ring-buffered)
  KV cache, grouped-query form.

Masks come from absolute positions: causal, bidirectional (encoder) and
sliding-window, in every path. Keys at a position below ``_PAD_LIMIT`` are
padding and excluded by every mask mode. Query head ``h`` reads KV head
``h // groups`` (``_repeat_kv``'s order, the JAX package's).
"""

from __future__ import annotations

import torch
from torch import Tensor

_NEG_INF = -1e30
#: Sentinel position for padded KV slots; any k_pos below _PAD_LIMIT is
#: excluded by every mask mode, bidirectional included.
_PAD_POS = -(10 ** 9)
_PAD_LIMIT = -(10 ** 8)

_FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)


def _mask_bias(q_pos: Tensor, k_pos: Tensor, causal: bool, window: int) -> Tensor:
    """(Sq, Sk) fp32 additive mask bias from absolute positions."""
    diff = q_pos[:, None] - k_pos[None, :]
    ok = (k_pos[None, :] > _PAD_LIMIT).expand(diff.shape)
    if causal:
        ok = ok & (diff >= 0)
    if window > 0:
        ok = ok & (diff < window)
    zero = torch.zeros((), dtype=torch.float32, device=diff.device)
    return torch.where(ok, zero, torch.full_like(zero, _NEG_INF))


def _repeat_kv(k: Tensor, groups: int) -> Tensor:
    """(B, S, Hkv, d) -> (B, S, Hkv*groups, d): KV head j serves query heads
    j*groups .. j*groups + groups - 1."""
    if groups == 1:
        return k
    return k.repeat_interleave(groups, dim=2)


def attend_naive(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor, k_pos: Tensor,
                 causal: bool = True, window: int = 0) -> Tensor:
    """Reference attention. q: (B,Sq,H,d); k/v: (B,Sk,Hkv,d). Returns (B,Sq,H,d)."""
    groups = q.shape[2] // k.shape[2]
    k = _repeat_kv(k, groups)
    v = _repeat_kv(v, groups)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    logits = logits + _mask_bias(q_pos, k_pos, causal, window)[None, None]
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attend_blockwise(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor, k_pos: Tensor,
                     causal: bool = True, window: int = 0, chunk: int = 1024,
                     q_chunk: int = 1024) -> Tensor:
    """Flash-style online-softmax attention, blocked over both Q and KV.

    Sq above ``q_chunk`` is cut into Q tiles (the last padded with
    ``q_pos[-1]`` and cropped), each run against every KV chunk; Sk is
    padded to a multiple of ``chunk`` with ``_PAD_POS`` keys, whose weight
    is exactly 0. Matches ``attend_naive`` to fp32 rounding.
    """
    b, sq, h, d = q.shape
    if sq <= q_chunk:
        return _attend_blockwise_inner(q, k, v, q_pos, k_pos, causal, window, chunk)
    if sq % q_chunk:
        pad_q = q_chunk - sq % q_chunk
        q = torch.cat([q, q.new_zeros((b, pad_q, h, d))], dim=1)
        q_pos = torch.cat([q_pos, q_pos[-1:].expand(pad_q)])
    # Pad and repeat the keys once for every tile (the tiles then see groups 1).
    k, v, k_pos = _pad_keys(k, v, k_pos, chunk)
    k, v = _repeat_kv(k, h // k.shape[2]), _repeat_kv(v, h // v.shape[2])
    tiles = [
        _attend_blockwise_inner(q[:, i:i + q_chunk], k, v, q_pos[i:i + q_chunk], k_pos,
                                causal, window, chunk)
        for i in range(0, q.shape[1], q_chunk)
    ]
    return torch.cat(tiles, dim=1)[:, :sq]


def _pad_keys(k: Tensor, v: Tensor, k_pos: Tensor, chunk: int):
    """Pad Sk to a multiple of ``chunk``: zero keys and values at ``_PAD_POS``."""
    sk = k.shape[1]
    if sk % chunk == 0:
        return k, v, k_pos
    pad = chunk - sk % chunk
    zeros = k.new_zeros((k.shape[0], pad) + tuple(k.shape[2:]))
    return (torch.cat([k, zeros], dim=1), torch.cat([v, zeros.to(v.dtype)], dim=1),
            torch.cat([k_pos, k_pos.new_full((pad,), _PAD_POS)]))


def _attend_blockwise_inner(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor, k_pos: Tensor,
                            causal: bool, window: int, chunk: int) -> Tensor:
    b, sq, h, d = q.shape
    k, v, k_pos = _pad_keys(k, v, k_pos, chunk)
    groups = h // k.shape[2]
    k = _repeat_kv(k, groups)
    v = _repeat_kv(v, groups)
    scale = d ** -0.5
    m = torch.full((b, h, sq), -torch.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    for c in range(0, k.shape[1], chunk):
        kc, vc = k[:, c:c + chunk], v[:, c:c + chunk]
        logits = torch.einsum("bqhd,bkhd->bhqk", q, kc).float() * scale
        logits = logits + _mask_bias(q_pos, k_pos[c:c + chunk], causal, window)[None, None]
        m_new = torch.maximum(m, logits.amax(dim=-1))
        # Guard fully-masked rows: keep m finite so exp() stays 0, not NaN.
        m_safe = m_new.clamp_min(-1e29)
        p = torch.exp(logits - m_safe[..., None])
        alpha = torch.exp((m - m_new).clamp_max(0.0))
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(q.dtype), vc).float()
        m = m_new
    out = acc / l[..., None].clamp_min(1e-30)
    return out.transpose(1, 2).to(q.dtype)     # (B,Sq,H,d)


def attend_decode(q: Tensor, k_cache: Tensor, v_cache: Tensor, q_pos: Tensor,
                  cache_pos: Tensor, window: int = 0, seq_sharded: bool = False) -> Tensor:
    """Single-token attention against a KV cache, grouped-query form (the KV
    heads are never repeated).

    ``seq_sharded``: the reference pins the scores' and probabilities' cache
    dim to a mesh's model axis there (split-KV decode). That is a layout
    constraint only; on one device it changes nothing, and the same
    attention is computed either way.

    Args:
        q: (B, 1, H, d) query for the new token.
        k_cache/v_cache: (B, S_cache, Hkv, d); a ring buffer of size
            ``window`` for sliding-window layers. A float8 cache is upcast
            (exactly) before the products; any cache is computed in q's dtype.
        q_pos: (B,) absolute position of the query token.
        cache_pos: (B, S_cache) absolute position per cache slot (−1 for
            unwritten slots).
    Returns: (B, 1, H, d).
    """
    b, _, h, d = q.shape
    if k_cache.dtype in _FP8:
        k_cache, v_cache = k_cache.to(torch.bfloat16), v_cache.to(torch.bfloat16)
    k_cache, v_cache = k_cache.to(q.dtype), v_cache.to(q.dtype)
    hkv = k_cache.shape[2]
    qg = q.reshape(b, 1, hkv, h // hkv, d)
    scale = d ** -0.5
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_cache).float() * scale
    diff = q_pos[:, None] - cache_pos                  # (B, S_cache)
    ok = (cache_pos >= 0) & (diff >= 0)
    if window > 0:
        ok = ok & (diff < window)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    bias = torch.where(ok, zero, torch.full_like(zero, _NEG_INF))[:, None, None, None, :]
    probs = torch.softmax(logits + bias, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v_cache)
    return out.reshape(b, 1, h, d)
