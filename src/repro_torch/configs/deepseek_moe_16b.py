"""deepseek-moe-16b — 28L d_model=2048 16H (GQA kv=16, i.e. MHA) d_ff=1408
vocab=102400, MoE: 2 shared + 64 routed experts, top-6, fine-grained
(expert hidden = 1408). [arXiv:2401.06066; hf]

Simplification vs. HF checkpoint: the released model's first layer is a
dense FFN (d_ff=10944); we apply the MoE block uniformly to all layers —
the paper's Table 1 architecture, noted here per DESIGN.md.
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register_arch

ARCH_ID = "deepseek-moe-16b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1408,
        vocab_size=102400,
        num_experts=64,
        num_shared_experts=2,
        top_k=6,
        moe_d_ff=1408,
        act="swiglu",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="moe",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=96,
        vocab_size=512,
        num_experts=8,
        num_shared_experts=2,
        top_k=3,
        moe_d_ff=96,
        act="swiglu",
    )


register_arch(ARCH_ID, full, smoke)
