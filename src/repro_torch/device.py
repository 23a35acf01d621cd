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


def as_float32(x, device=None) -> torch.Tensor:
    """``x`` as an fp32 tensor: a tensor stays on its device unless
    ``device`` is named; anything else (numbers, nested lists) is made on
    ``device`` (``None``: CUDA, as :func:`resolve_device` rules)."""
    if isinstance(x, torch.Tensor) and device is None:
        return x.to(torch.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=resolve_device(device))
