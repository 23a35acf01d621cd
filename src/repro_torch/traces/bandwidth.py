"""Inter-site bandwidths (paper Sec. V-A: 100 Mb/s – 2 Gb/s per access link)."""

from __future__ import annotations

import torch
from torch import Tensor

from repro_torch.device import resolve_device

#: Paper's bandwidth range, in Gb/s.
BW_MIN_GBPS = 0.1
BW_MAX_GBPS = 2.0


def bandwidth_draw(
    generator: torch.Generator,
    n_sites: int,
    lo: float = BW_MIN_GBPS,
    hi: float = BW_MAX_GBPS,
    device=None,
) -> tuple[Tensor, Tensor]:
    """Draw static (up, down) bandwidths per site, uniform in [lo, hi] Gb/s."""
    dev = resolve_device(device)
    u = torch.rand((2, n_sites), generator=generator, device=dev)
    up, down = lo + (hi - lo) * u
    return up, down
