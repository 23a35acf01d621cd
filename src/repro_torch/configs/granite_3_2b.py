"""granite-3-2b — 40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155.
[hf:ibm-granite/granite-3.0-2b-base; hf]
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register_arch

ARCH_ID = "granite-3-2b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=40,
        d_model=2048,
        num_heads=32,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=49155,
        act="swiglu",
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        act="swiglu",
        tie_embeddings=True,
    )


register_arch(ARCH_ID, full, smoke)
