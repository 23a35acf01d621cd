"""mamba2-2.7b — 64L d_model=2560, attention-free, vocab=50280,
ssm_state=128, SSD (state-space duality). [arXiv:2405.21060; unverified]

d_inner = 2*d_model = 5120, head_dim = 64 -> 80 SSD heads.
``long_500k`` runs for this arch (O(1) decode state).
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register_arch

ARCH_ID = "mamba2-2.7b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="ssm",
        num_layers=64,
        d_model=2560,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_conv_width=4,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="ssm",
        num_layers=2,
        d_model=128,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=512,
        ssm_state=16,
        ssm_head_dim=32,
        ssm_expand=2,
        ssm_conv_width=4,
        ssm_chunk=32,
        tie_embeddings=True,
    )


register_arch(ARCH_ID, full, smoke)
