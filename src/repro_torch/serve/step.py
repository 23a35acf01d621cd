"""Serving steps: the local (single-device) prefill + decode pair.

The counterpart of ``repro.serve.step.make_local_exec``, which the JAX
``FleetEngine`` builds once per request class and runs in ``_execute_jobs``:
a batch's prompt prefill, then greedy decode one token at a time. PyTorch
runs eagerly, so there is nothing to jit; both functions run under
``torch.inference_mode()``. The sharded ``make_prefill_step`` /
``make_decode_step`` come with the distributed slice.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.lm import decode_step, prefill_step


def make_local_exec(cfg: ModelConfig, gen_len: int, device=None):
    """(prefill_fn, decode_fn) on ``device`` (``None``: CUDA).

    ``prefill_fn(params, tokens)`` returns ``(logits (B,1,Vp), cache)`` with
    an fp32 cache sized for ``gen_len`` extra tokens (the KV ring holds
    ``S + gen_len`` slots), attention blockwise;
    ``decode_fn(params, cache, tok)`` advances one token, every row at one
    position (``uniform_pos``). A frontend model's prompt is tokens only
    (no ``prefix_embeds``), as the reference's ``make_local_exec`` feeds it.
    """
    dev = resolve_device(device)

    def prefill_fn(params, tokens):
        with torch.inference_mode():
            return prefill_step(params, cfg, tokens.to(dev), attn_impl="blockwise",
                                cache_dtype=torch.float32,
                                cache_len=tokens.shape[1] + gen_len)

    def decode_fn(params, cache, tok):
        with torch.inference_mode():
            return decode_step(params, cfg, cache, tok.to(dev), uniform_pos=True)

    return prefill_fn, decode_fn
