"""repro_torch.configs — scenarios and model configurations.

* ``facebook_4dc`` — the paper's 4-DC scenario; ``fleet_256`` — the N = 256
  fleet the ``gmsa_score`` kernel serves;
* ``base`` / ``registry`` — the port's copies of the model-config dataclasses
  and the ``--arch`` registry. Only ``mamba2-2.7b`` is registered: the other
  model families (attention, MoE, hybrid, frontends) come with later slices
  of the port.
"""

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs.registry import get_arch, list_archs, register_arch
from repro_torch.configs import mamba2_2_7b  # noqa: F401  (self-registers)

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "register_arch", "get_arch", "list_archs"]
