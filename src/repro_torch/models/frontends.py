"""Modality-frontend stubs: the port's copy of ``repro.models.frontends``.

``[audio]`` / ``[vlm]`` architecture entries specify the transformer
backbone only; the modality frontend supplies *precomputed* frame or patch
embeddings (``repro_torch.models.inputs.make_batch``), which the model
projects through its ``frontend_proj`` / ``frontend_norm`` leaves.

* vision (InternVL2): 256 image tokens per sample, 1024-dim patch
  embeddings (the pixel-shuffled InternViT output's width), prepended to the
  text tokens;
* audio (HuBERT): 50 frames/s from the conv feature extractor, 512-dim (the
  wav2vec2 conv stack's channel width); the frames replace the tokens (the
  backbone sees one embedding per frame).
"""

from __future__ import annotations

import dataclasses

VISION_STUB_DIM = 1024
VISION_TOKENS = 256
AUDIO_STUB_DIM = 512


@dataclasses.dataclass(frozen=True)
class FrontendSpec:
    kind: str           # "vision" | "audio"
    stub_dim: int
    prefix_tokens: int  # embeddings prepended per sample (0 = replaces tokens)


def frontend_spec(kind: str, seq_len: int) -> FrontendSpec | None:
    """The stub geometry of a frontend kind (``None`` for a text-only model)."""
    if kind == "vision":
        return FrontendSpec("vision", VISION_STUB_DIM, VISION_TOKENS)
    if kind == "audio":
        # The encoder consumes frame embeddings only; no token prefix.
        return FrontendSpec("audio", AUDIO_STUB_DIM, 0)
    return None
