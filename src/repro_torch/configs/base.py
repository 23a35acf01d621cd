"""Model and workload-shape configuration: the port's own copy of the JAX
package's ``configs/base.py`` (the dataclasses, ``SHAPES`` and the cell
policy ``shape_applicable``), kept here so the port imports nothing of that
package."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture's hyperparameters (LM backbone view).

    ``[audio]``/``[vlm]`` entries describe the transformer backbone only; the
    modality frontend is a stub supplying precomputed frame/patch embeddings
    (``repro_torch.models.frontends``).
    """

    name: str
    family: str                   # dense | moe | hybrid | vlm | ssm | audio
    num_layers: int
    d_model: int
    num_heads: int                # 0 for attention-free (ssm)
    num_kv_heads: int
    d_ff: int                     # dense FFN hidden (or 0 for pure ssm)
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    # --- MoE ---
    num_experts: int = 0          # routed experts
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0             # expert hidden size (0 -> d_ff)
    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256          # SSD chunk length
    # --- attention details ---
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    causal: bool = True           # False for encoder-only backbones
    sliding_window: int = 0       # >0 -> sliding-window attention (hybrid)
    norm_eps: float = 1e-5
    act: str = "swiglu"           # swiglu | gelu
    tie_embeddings: bool = False
    # --- hybrid (Hymba): parallel attention + SSM heads in each layer ---
    hybrid: bool = False
    # --- modality frontend stub ---
    frontend: str = ""            # "" | "vision" | "audio"

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def has_attention(self) -> bool:
        return self.num_heads > 0

    @property
    def has_ssm(self) -> bool:
        return self.ssm_state > 0

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Total parameter count N (embedding + blocks), exact to the layer
        definitions in repro_torch.models (used for MODEL_FLOPS = 6·N·D)."""
        from repro_torch.models.lm import count_params  # local import: avoid cycle

        return count_params(self)

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE: top_k + shared experts only)."""
        from repro_torch.models.lm import count_params

        return count_params(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch          # one new token per sequence
        return self.global_batch * self.seq_len


#: The four assigned LM-family shapes (identical across the 10 archs).
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether (arch, shape) is a runnable cell; else the documented reason.

    * encoder-only backbones have no autoregressive step, so no decode
      shapes;
    * ``long_500k`` needs sub-quadratic attention: SSM or sliding-window
      models only; pure full-attention archs skip it.
    """
    if shape.kind == "decode" and not model.causal:
        return False, "encoder-only: no autoregressive decode step"
    if shape.name == "long_500k":
        subquadratic = (not model.has_attention) or model.sliding_window > 0
        if not subquadratic:
            return False, "full quadratic attention: 500k context inapplicable"
    return True, ""


def applicable_shapes(model: ModelConfig) -> list[ShapeConfig]:
    return [s for s in SHAPES.values() if shape_applicable(model, s)[0]]
