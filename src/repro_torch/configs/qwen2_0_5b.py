"""qwen2-0.5b — 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936.
GQA with QKV bias; tied embeddings. [arXiv:2407.10671; hf]
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register_arch

ARCH_ID = "qwen2-0.5b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=24,
        d_model=896,
        num_heads=14,
        num_kv_heads=2,
        d_ff=4864,
        vocab_size=151936,
        qkv_bias=True,
        act="swiglu",
        tie_embeddings=True,
        rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=320,
        vocab_size=512,
        qkv_bias=True,
        act="swiglu",
        tie_embeddings=True,
    )


register_arch(ARCH_ID, full, smoke)
