"""phi4-mini-3.8b — 32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.
RoPE, SwiGLU, GQA. [arXiv:2412.08905; hf]
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register_arch

ARCH_ID = "phi4-mini-3.8b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=32,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=200064,
        act="swiglu",
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        num_layers=2,
        d_model=96,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        act="swiglu",
        tie_embeddings=True,
    )


register_arch(ARCH_ID, full, smoke)
