"""Serving steps: the local prefill + decode pair, and the sharded
prefill and decode steps at world size 1.

``make_local_exec`` is the counterpart of ``repro.serve.step.make_local_exec``,
which the JAX ``FleetEngine`` builds once per request class and runs in
``_execute_jobs``: a batch's prompt prefill, then greedy decode one token at
a time. PyTorch runs eagerly, so there is nothing to jit; both functions run
under ``torch.inference_mode()``.

``make_prefill_step`` / ``make_decode_step`` are the reference's sharded
steps for any (arch × mesh). They return ``(fn, pspecs, shardings_for)`` as
the reference does; the specs are the port's (tuples per leaf,
:mod:`repro_torch.distributed.sharding`) and nothing is moved by them: one
card is a world of size 1, so ``fn`` computes the whole batch on the device.
Both take the reference's ``unroll_layers``, which changes nothing (the
port's layers are a Python loop).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (
    batch_pspecs,
    cache_pspecs,
    logits_pspec,
    param_pspecs,
    resolve_kv_shard,
)
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


def make_decode_step(cfg: ModelConfig, mesh, unroll_layers: bool = False,
                     uniform_pos: bool = True, kv_shard: str = "auto", device=None):
    """``(fn, pspecs, shardings_for)`` for the single-token decode step on
    ``device`` (``None``: CUDA).

    ``fn(params, cache, tokens)`` is :func:`repro_torch.models.lm.decode_step`
    with ``kv_shard`` resolved against ``mesh`` ("auto": "heads" when the KV
    heads divide the model axis, else "seq"). ``shardings_for(cache_tree,
    batch_size)`` returns ``((param, cache, token) specs, (logits, cache)
    specs)``.
    """
    dev = resolve_device(device)
    pspecs = param_pspecs(cfg, mesh)
    if kv_shard == "auto":
        kv_shard = resolve_kv_shard(cfg, mesh)

    def fn(params, cache, tokens):
        with torch.inference_mode():
            return decode_step(params, cfg, cache, tokens.to(dev), unroll_layers=unroll_layers,
                               uniform_pos=uniform_pos, kv_shard=kv_shard)

    def shardings_for(cache_tree, batch_size: int):
        cspecs = cache_pspecs(cache_tree, cfg, mesh, batch_size, kv_shard=kv_shard)
        tok_spec = batch_pspecs({"t": torch.empty((batch_size, 1))}, mesh, batch_size)["t"]
        return (pspecs, cspecs, tok_spec), (logits_pspec(cfg, mesh, batch_size), cspecs)

    return fn, pspecs, shardings_for


def make_prefill_step(cfg: ModelConfig, mesh, attn_impl: str = "blockwise",
                      unroll_layers: bool = False, device=None):
    """``(fn, pspecs, shardings_for)`` for the prompt-prefill step on
    ``device`` (``None``: CUDA).

    ``fn(params, **batch)`` is :func:`repro_torch.models.lm.prefill_step` on
    ``batch["tokens"]`` (and a frontend's ``prefix_embeds``) with the
    reference's defaults: a bf16 cache as long as the prompt.
    ``shardings_for(batch_tree, batch_size)`` returns ``(param specs, batch
    specs)``.
    """
    dev = resolve_device(device)
    pspecs = param_pspecs(cfg, mesh)

    def fn(params, **batch):
        on_dev = lambda x: None if x is None else x.to(dev)
        with torch.inference_mode():
            return prefill_step(params, cfg, on_dev(batch.get("tokens")),
                                prefix_embeds=on_dev(batch.get("prefix_embeds")),
                                attn_impl=attn_impl, unroll_layers=unroll_layers)

    def shardings_for(batch_tree, batch_size: int):
        return pspecs, batch_pspecs(batch_tree, mesh, batch_size)

    return fn, pspecs, shardings_for
