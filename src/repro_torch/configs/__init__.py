"""repro_torch.configs — scenarios and model configurations.

* ``facebook_4dc`` — the paper's 4-DC scenario; ``fleet_256`` — the N = 256
  fleet the ``gmsa_score`` kernel serves;
* ``base`` / ``registry`` — the port's copies of the model-config dataclasses
  (with ``param_count`` / ``active_param_count``, which price a serving
  class's energy) and the ``--arch`` registry. Registered: the four dense
  GQA decoders (``qwen2-0.5b``, ``granite-3-2b``, ``phi4-mini-3.8b``,
  ``stablelm-12b``) and ``mamba2-2.7b``; the MoE, hybrid and frontend
  configs come with their families (ROADMAP.md §1, slice 7).
"""

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs.registry import get_arch, list_archs, register_arch
from repro_torch.configs import (  # noqa: F401  (each self-registers)
    granite_3_2b,
    mamba2_2_7b,
    phi4_mini,
    qwen2_0_5b,
    stablelm_12b,
)

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "register_arch", "get_arch", "list_archs"]
