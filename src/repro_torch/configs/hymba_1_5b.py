"""hymba-1.5b — 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16; parallel attention + Mamba heads in each layer, sliding-window
attention in most layers. [arXiv:2411.13676; hf]

``long_500k`` runs for this arch: attention is sliding-window (bounded KV)
and the SSM path carries long-range state — sub-quadratic end to end.
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register_arch

ARCH_ID = "hymba-1.5b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="hybrid",
        num_layers=32,
        d_model=1600,
        num_heads=25,
        num_kv_heads=5,
        d_ff=5504,
        vocab_size=32001,
        head_dim=64,
        ssm_state=16,
        ssm_head_dim=64,
        ssm_expand=2,
        hybrid=True,
        sliding_window=1024,
        act="swiglu",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="hybrid",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        head_dim=32,
        ssm_state=16,
        ssm_head_dim=32,
        ssm_expand=2,
        hybrid=True,
        sliding_window=64,
        act="swiglu",
    )


register_arch(ARCH_ID, full, smoke)
