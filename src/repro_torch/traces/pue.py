"""PUE traces (paper Sec. III & V-A): a site-specific base, a diurnal
cooling swing peaking in local mid-afternoon, and small measurement noise."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import Tensor

from repro_torch.device import resolve_device
from repro_torch.traces.price import FACEBOOK_SITES, SiteSpec, _site_column, slot_hours


def pue_trace(
    generator: torch.Generator,
    t_slots: int,
    slot_minutes: float,
    sites: tuple[SiteSpec, ...] = FACEBOOK_SITES,
    start_hour_utc: float = 0.0,
    device=None,
) -> Tensor:
    """(T, N) synthetic PUE traces (dimensionless, >= 1)."""
    dev = resolve_device(device)
    hours = slot_hours(t_slots, slot_minutes, start_hour_utc, dev)
    base = _site_column(sites, "base_pue", dev)
    amp = _site_column(sites, "pue_amp", dev)
    off = _site_column(sites, "utc_offset_h", dev)
    diurnal = torch.cos(2.0 * math.pi * (hours[:, None] + off[None, :] - 15.0) / 24.0)
    noise = 0.004 * torch.randn((t_slots, len(sites)), generator=generator, device=dev)
    trace = base[None, :] + amp[None, :] * diurnal + noise
    return torch.clamp_min(trace, 1.0)  # PUE >= 1 by definition


def load_pue_csv(path, n_sites: int, device=None) -> Tensor:
    """Load a real (T, N) PUE trace from a CSV the caller names (slot rows
    x site columns) onto ``device`` (``None``: CUDA)."""
    data = np.loadtxt(path, delimiter=",", dtype=np.float32)
    if data.ndim == 1:
        data = data[:, None]
    if data.shape[1] != n_sites:
        raise ValueError(f"expected {n_sites} columns, got {data.shape[1]}")
    return torch.from_numpy(data).to(resolve_device(device))
