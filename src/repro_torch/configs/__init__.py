"""repro_torch.configs — scenarios and model configurations.

* ``facebook_4dc`` — the paper's 4-DC scenario; ``fleet_256`` — the N = 256
  fleet the ``gmsa_score`` kernel serves;
* ``base`` / ``registry`` — the port's copies of the model-config dataclasses
  (with ``param_count`` / ``active_param_count``, which price a serving
  class's energy) and the ``--arch`` registry. Only ``mamba2-2.7b`` is
  registered, so the serving launcher's classes are ``mamba2-2.7b`` ones: the
  other model families (attention, MoE, hybrid, frontends) and their configs
  come with slice 7 of the port (ROADMAP.md §1).
"""

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs.registry import get_arch, list_archs, register_arch
from repro_torch.configs import mamba2_2_7b  # noqa: F401  (self-registers)

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "register_arch", "get_arch", "list_archs"]
