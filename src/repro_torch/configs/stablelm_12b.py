"""stablelm-12b — 40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.
[hf:stabilityai/stablelm-2-12b; hf]
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register_arch

ARCH_ID = "stablelm-12b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        d_ff=13824,
        vocab_size=100352,
        act="swiglu",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        num_layers=2,
        d_model=160,
        num_heads=4,
        num_kv_heads=2,
        d_ff=432,
        vocab_size=512,
        act="swiglu",
    )


register_arch(ARCH_ID, full, smoke)
