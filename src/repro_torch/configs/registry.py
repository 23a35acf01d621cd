"""Architecture registry: ``--arch <id>`` resolution (the port's copy of the
JAX package's ``configs/registry.py``)."""

from __future__ import annotations

from typing import Callable

from repro_torch.configs.base import ModelConfig

_ARCHS: dict[str, dict[str, Callable[[], ModelConfig]]] = {}


def register_arch(
    arch_id: str,
    full: Callable[[], ModelConfig],
    smoke: Callable[[], ModelConfig],
) -> None:
    """Register an architecture id with its full and smoke config builders."""
    if arch_id in _ARCHS:
        raise ValueError(f"duplicate arch id {arch_id!r}")
    _ARCHS[arch_id] = {"full": full, "smoke": smoke}


def get_arch(arch_id: str, variant: str = "full") -> ModelConfig:
    """Resolve an ``--arch`` id to its ModelConfig (variant: full|smoke)."""
    try:
        entry = _ARCHS[arch_id]
    except KeyError:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(_ARCHS)}"
        ) from None
    return entry[variant]()


def list_archs() -> list[str]:
    return sorted(_ARCHS)
