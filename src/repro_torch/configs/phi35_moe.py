"""phi3.5-moe-42b-a6.6b — 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16 experts top-2. [hf:microsoft/Phi-3.5-MoE-instruct; hf]
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register_arch

ARCH_ID = "phi3.5-moe-42b-a6.6b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=6400,
        vocab_size=32064,
        num_experts=16,
        top_k=2,
        moe_d_ff=6400,
        act="swiglu",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="moe",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=192,
        vocab_size=512,
        num_experts=4,
        top_k=2,
        moe_d_ff=192,
        act="swiglu",
    )


register_arch(ARCH_ID, full, smoke)
