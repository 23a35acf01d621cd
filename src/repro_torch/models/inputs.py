"""Token batches and cache specs per (architecture × shape) cell — the
token-only part of ``repro.models.inputs`` (frontend stubs come with the
frontend slice)."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device


def make_batch(cfg: ModelConfig, shape: ShapeConfig, generator: torch.Generator,
               device=None) -> dict:
    """Inputs for train/prefill kinds: random token ids in [0, vocab_size)
    (int64, torch's index type); train cells add labels and a loss mask."""
    if cfg.frontend:
        raise NotImplementedError(f"{cfg.name}: frontend batches come with the frontend slice")
    dev = resolve_device(device)
    b, s = shape.global_batch, shape.seq_len
    tokens = lambda: torch.randint(0, cfg.vocab_size, (b, s), generator=generator, device=dev)
    batch = {"tokens": tokens()}
    if shape.kind == "train":
        batch["labels"] = tokens()
        batch["loss_mask"] = torch.ones((b, s), dtype=torch.float32, device=dev)
    return batch


def make_decode_tokens(cfg: ModelConfig, shape: ShapeConfig, generator: torch.Generator,
                       device=None) -> torch.Tensor:
    """(B, 1) next-token ids for a decode cell."""
    dev = resolve_device(device)
    return torch.randint(0, cfg.vocab_size, (shape.global_batch, 1), generator=generator,
                         device=dev)


def cache_spec(cfg: ModelConfig, shape: ShapeConfig, dtype=torch.bfloat16) -> dict:
    """``init_cache``'s tree for the cell, on the ``meta`` device: shapes and
    dtypes, no storage. ``dtype`` may be ``torch.float8_e4m3fn`` for the
    quantized-KV variant (``attend_decode`` upcasts it)."""
    from repro_torch.models.lm import init_cache

    return init_cache(cfg, shape.global_batch, shape.seq_len, dtype,
                      prefilled=shape.seq_len, device="meta")
