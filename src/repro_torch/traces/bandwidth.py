"""Inter-site bandwidths (paper Sec. V-A: 100 Mb/s – 2 Gb/s per access link)
and the degraded-mode link-health traces of the WAN between sites."""

from __future__ import annotations

import numpy as np
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


def link_fault_trace(
    generator: torch.Generator,
    t_slots: int,
    n_sites: int,
    degrade_prob: float = 0.01,
    recover_prob: float = 0.25,
    sever_frac: float = 0.25,
    min_factor: float = 0.1,
    device=None,
) -> Tensor:
    """(T, N, N) seeded link-health factor: Markov degrade/recover per link.

    Each nominal directed link i→j independently degrades with
    ``degrade_prob`` per slot; a degrade event severs the link entirely
    (factor 0) with conditional probability ``sever_frac``, otherwise it
    drops to a factor drawn uniform in ``[min_factor, 1)``. A faulted link
    recovers to nominal with ``recover_prob``. The diagonal is pinned to 1
    (local "transfers" are free and never fault). An all-nominal draw is
    exactly 1.0 everywhere. Draws come from ``generator``, one (4, N, N)
    batch of uniforms per slot, on ``device`` (``None``: CUDA).
    """
    if not 0.0 < min_factor <= 1.0:
        raise ValueError(f"min_factor={min_factor} must be in (0, 1]")
    dev = resolve_device(device)
    eye = torch.eye(n_sites, dtype=torch.bool, device=dev)
    factor = torch.ones((n_sites, n_sites), dtype=torch.float32, device=dev)
    rows = []
    for _ in range(t_slots):
        u = torch.rand((4, n_sites, n_sites), generator=generator, device=dev)
        nominal = factor >= 1.0
        faults = nominal & (u[0] < degrade_prob)
        sev = min_factor + (1.0 - min_factor) * u[1]
        sev = torch.where(faults & (u[2] < sever_frac), 0.0, sev)
        recovers = ~nominal & (u[3] < recover_prob)
        factor = torch.where(faults, sev, torch.where(recovers, 1.0, factor))
        factor = torch.where(eye, 1.0, factor)
        rows.append(factor)
    if not rows:
        return torch.ones((0, n_sites, n_sites), device=dev)
    return torch.stack(rows)


def scheduled_link_fault_trace(
    t_slots: int,
    n_sites: int,
    events: list[tuple[int, int, int, int | None, float]],
    symmetric: bool = True,
    device=None,
) -> Tensor:
    """(T, N, N) link health from (src, dst, start, end, factor) events, on
    ``device`` (``None``: CUDA).

    ``end=None`` means the fault never clears; windows are half-open and
    overlapping windows take the minimum factor. ``symmetric=True``
    (default) applies each event to both directions of the link.
    Out-of-range sites, self-links, negative ``start``, empty windows and
    factors outside ``[0, 1]`` raise.
    """
    health = np.ones((t_slots, n_sites, n_sites), np.float32)
    for src, dst, start, end, factor in events:
        for site in (src, dst):
            if not 0 <= site < n_sites:
                raise ValueError(f"site {site} out of range for N={n_sites}")
        if src == dst:
            raise ValueError(f"self-link {src}->{dst} cannot fault")
        if start < 0:
            raise ValueError(f"start={start} must be >= 0")
        if end is not None and end <= start:
            raise ValueError(f"end={end} must be > start={start} (or None)")
        if not 0.0 <= factor <= 1.0:
            raise ValueError(f"factor={factor} must be in [0, 1]")
        stop = t_slots if end is None else min(end, t_slots)
        pairs = [(src, dst), (dst, src)] if symmetric else [(src, dst)]
        for i, j in pairs:
            health[start:stop, i, j] = np.minimum(
                health[start:stop, i, j], np.float32(factor))
    return torch.from_numpy(health).to(resolve_device(device))
