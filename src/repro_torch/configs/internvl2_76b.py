"""internvl2-76b — 80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
InternViT-6B vision frontend + LLaMA-3-70B-class language backbone.
[arXiv:2404.16821; unverified]

The vision tower is a STUB: ``repro_torch.models.inputs.make_batch``
supplies precomputed patch embeddings, which the model projects
(``frontend_proj``, ``frontend_norm``) and prepends to the token stream.
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register_arch

ARCH_ID = "internvl2-76b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="vlm",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=28672,
        vocab_size=128256,
        act="swiglu",
        rope_theta=500_000.0,
        frontend="vision",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="vlm",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        act="swiglu",
        frontend="vision",
    )


register_arch(ARCH_ID, full, smoke)
