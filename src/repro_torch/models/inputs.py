"""Batches and cache specs per (architecture × shape) cell — the port of
``repro.models.inputs``, drawn from an explicit torch generator.

Frontend stubs: a vision (VLM) batch carries 256 precomputed 1024-dim patch
embeddings per sample beside its text tokens; an audio batch carries one
512-dim embedding per frame *instead of* tokens
(:mod:`repro_torch.models.frontends`).

``as_spec=True`` returns the same trees on the ``meta`` device: shapes and
dtypes, no storage and no draw (the dry-run's inputs, as the reference's
``as_spec`` gives ``jax.ShapeDtypeStruct`` stand-ins).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models.frontends import AUDIO_STUB_DIM, VISION_STUB_DIM, VISION_TOKENS


def _draw_device(generator: torch.Generator | None, device) -> torch.device:
    if generator is None:
        raise ValueError("the batch is drawn from a generator: pass one, or as_spec=True")
    return resolve_device(device)


def make_batch(cfg: ModelConfig, shape: ShapeConfig, generator: torch.Generator | None = None,
               device=None, embed_dtype=torch.bfloat16, as_spec: bool = False) -> dict:
    """Inputs for train/prefill kinds on ``device`` (``None``: CUDA): random
    token ids in [0, vocab_size) (int64, torch's index type); stub
    embeddings ``0.02 · N(0, 1)`` cast to ``embed_dtype``. Audio: frames
    (B, S, 512), no tokens. Vision: ``min(256, S // 2)`` patches (B, n_img,
    1024) and B x (S − n_img) tokens. Train cells add labels and a loss mask
    over the text span (the frames, for audio). ``as_spec``: the same tree
    on ``meta`` (``generator`` and ``device`` unused)."""
    b, s = shape.global_batch, shape.seq_len
    if as_spec:
        dev = torch.device("meta")
        tokens = lambda n: torch.empty((b, n), dtype=torch.int64, device=dev)
        stubs = lambda n, dim: torch.empty((b, n, dim), dtype=embed_dtype, device=dev)
    else:
        dev = _draw_device(generator, device)
        tokens = lambda n: torch.randint(0, cfg.vocab_size, (b, n), generator=generator,
                                         device=dev)
        stubs = lambda n, dim: (0.02 * torch.randn((b, n, dim), generator=generator,
                                                   device=dev)).to(embed_dtype)
    batch: dict = {}
    if cfg.frontend == "audio":
        s_text = s
        batch["prefix_embeds"] = stubs(s, AUDIO_STUB_DIM)
    elif cfg.frontend == "vision":
        # 256 image tokens at the assigned shapes; fewer for tiny smoke
        # sequences, so that the text span stays non-empty.
        n_img = min(VISION_TOKENS, s // 2)
        s_text = s - n_img
        batch["prefix_embeds"] = stubs(n_img, VISION_STUB_DIM)
        batch["tokens"] = tokens(s_text)
    else:
        s_text = s
        batch["tokens"] = tokens(s)
    if shape.kind == "train":
        batch["labels"] = tokens(s_text)
        batch["loss_mask"] = torch.ones((b, s_text), dtype=torch.float32, device=dev)
    return batch


def make_decode_tokens(cfg: ModelConfig, shape: ShapeConfig,
                       generator: torch.Generator | None = None, device=None,
                       as_spec: bool = False) -> torch.Tensor:
    """(B, 1) next-token ids for a decode cell (``as_spec``: on ``meta``)."""
    size = (shape.global_batch, 1)
    if as_spec:
        return torch.empty(size, dtype=torch.int64, device="meta")
    return torch.randint(0, cfg.vocab_size, size, generator=generator,
                         device=_draw_device(generator, device))


def cache_spec(cfg: ModelConfig, shape: ShapeConfig, dtype=torch.bfloat16) -> dict:
    """``init_cache``'s tree for the cell, on the ``meta`` device: shapes and
    dtypes, no storage. ``dtype`` may be ``torch.float8_e4m3fn`` for the
    quantized-KV variant (``attend_decode`` upcasts it)."""
    from repro_torch.models.lm import init_cache

    return init_cache(cfg, shape.global_batch, shape.seq_len, dtype,
                      prefilled=shape.seq_len, device="meta")
