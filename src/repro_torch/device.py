"""The port's device rule: ``device=None`` means CUDA, never a silent CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """Resolve an entry point's ``device=`` argument.

    ``None`` means ``"cuda"``. A CUDA device on a machine without one
    raises instead of quietly falling back to the CPU; the CPU is used
    only when the caller names it.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch entry points run on CUDA by default and no CUDA "
            "device is available here; pass device='cpu' to run on the CPU"
        )
    return dev
