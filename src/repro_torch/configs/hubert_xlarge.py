"""hubert-xlarge — 48L d_model=1280 16H (MHA, kv=16) d_ff=5120 vocab=504.
Encoder-only (same backbone as wav2vec2). [arXiv:2106.07447; unverified]

The audio frontend (the 7-layer strided conv feature extractor) is a STUB:
``repro_torch.models.inputs.make_batch`` supplies precomputed frame
embeddings. Encoder-only, so no autoregressive decode: the decode_32k and
long_500k cells are skipped (``configs.base.shape_applicable``). "vocab" is
the HuBERT codebook (504 clusters), the masked-prediction targets.
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register_arch

ARCH_ID = "hubert-xlarge"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="audio",
        num_layers=48,
        d_model=1280,
        num_heads=16,
        num_kv_heads=16,
        d_ff=5120,
        vocab_size=504,
        causal=False,
        act="gelu",
        frontend="audio",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="audio",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=64,
        causal=False,
        act="gelu",
        frontend="audio",
    )


register_arch(ARCH_ID, full, smoke)
