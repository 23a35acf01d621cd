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


def bandwidth_trace(
    generator: torch.Generator,
    t_slots: int,
    n_sites: int,
    lo: float = BW_MIN_GBPS,
    hi: float = BW_MAX_GBPS,
    wobble: float = 0.15,
    device=None,
) -> tuple[Tensor, Tensor]:
    """(T, N) time-varying (up, down) bandwidths: the static draw of
    :func:`bandwidth_draw` times a uniform factor in [1 - wobble, 1 + wobble]
    per slot — "other applications sharing the same links" (paper Sec. II)."""
    dev = resolve_device(device)
    up0, down0 = bandwidth_draw(generator, n_sites, lo, hi, device=dev)
    u = 1.0 + wobble * (2.0 * torch.rand((t_slots, n_sites), generator=generator, device=dev) - 1.0)
    d = 1.0 + wobble * (2.0 * torch.rand((t_slots, n_sites), generator=generator, device=dev) - 1.0)
    return up0[None, :] * u, down0[None, :] * d
