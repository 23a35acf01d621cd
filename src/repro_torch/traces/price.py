"""Electricity-price traces (paper Sec. V-A).

A calibrated synthesizer: per-site diurnal price curves with realistic base
levels, timezone-shifted diurnal swing, weekly modulation and AR(1) noise.
Prices are in $/MWh.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import Tensor

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SiteSpec:
    """Static description of one DC site's price/PUE climate."""

    name: str
    region: str
    utc_offset_h: float       # local-time shift for the diurnal component
    base_price: float         # $/MWh mean industrial price
    diurnal_amp: float        # peak-to-mean diurnal swing ($/MWh)
    noise_std: float          # AR(1) innovation std ($/MWh)
    base_pue: float           # site mean PUE
    pue_amp: float            # diurnal PUE swing (cooling load)


#: The four Facebook DCs of the paper's evaluation (Luleå cheapest,
#: ForestCity priciest; PUE levels from Facebook's public dashboards).
FACEBOOK_SITES: tuple[SiteSpec, ...] = (
    SiteSpec("Prineville", "Oregon, US", -8.0, 15.98, 3.76, 0.8, 1.078, 0.02),
    SiteSpec("ForestCity", "North Carolina, US", -5.0, 24.44, 5.64, 1.0, 1.082, 0.03),
    SiteSpec("Lulea", "Sweden (SE1)", 1.0, 9.87, 3.29, 1.2, 1.046, 0.01),
    SiteSpec("Altoona", "Iowa, US", -6.0, 18.33, 4.70, 0.9, 1.071, 0.025),
)


def _diurnal(hours_utc: Tensor, utc_offset: Tensor | float, phase_peak_h: float = 17.0) -> Tensor:
    """Unit diurnal curve peaking at local ``phase_peak_h`` (evening peak)."""
    local = hours_utc + utc_offset
    return torch.cos(2.0 * math.pi * (local - phase_peak_h) / 24.0)


def _site_column(sites, attr: str, device) -> Tensor:
    return torch.tensor([getattr(s, attr) for s in sites], dtype=torch.float32, device=device)


def slot_hours(t_slots: int, slot_minutes: float, start_hour_utc: float, device) -> Tensor:
    """(T,) UTC hour of every slot start."""
    return start_hour_utc + torch.arange(t_slots, device=device) * (slot_minutes / 60.0)


def price_trace(
    generator: torch.Generator,
    t_slots: int,
    slot_minutes: float,
    sites: tuple[SiteSpec, ...] = FACEBOOK_SITES,
    start_hour_utc: float = 0.0,
    device=None,
) -> Tensor:
    """(T, N) synthetic electricity-price traces ($/MWh).

    The diurnal/weekly structure is shared; the AR(1) noise (phi = 0.9,
    stationary start) gives each site realistic short-term wiggle.
    """
    dev = resolve_device(device)
    n = len(sites)
    hours = slot_hours(t_slots, slot_minutes, start_hour_utc, dev)            # (T,)
    base = _site_column(sites, "base_price", dev)
    amp = _site_column(sites, "diurnal_amp", dev)
    noise_std = _site_column(sites, "noise_std", dev)
    off = _site_column(sites, "utc_offset_h", dev)

    diurnal = _diurnal(hours[:, None], off[None, :])                          # (T, N)
    weekly = 1.0 + 0.03 * torch.sin(2.0 * math.pi * hours[:, None] / (24.0 * 7.0))

    phi = 0.9
    innov = torch.randn((t_slots, n), generator=generator, device=dev) * noise_std
    noise = torch.empty_like(innov)
    prev = innov[0] / math.sqrt(1.0 - phi * phi)
    for t in range(t_slots):          # the AR(1) recursion, one slot at a time
        prev = phi * prev + innov[t]
        noise[t] = prev

    trace = base[None, :] * weekly + amp[None, :] * diurnal + noise
    return torch.clamp_min(trace, 1.0)  # prices stay positive


def load_price_csv(path, n_sites: int, device=None) -> Tensor:
    """Load a real (T, N) electricity-price ($/MWh) trace from a CSV the caller names (slot rows
    x site columns) onto ``device`` (``None``: CUDA)."""
    data = np.loadtxt(path, delimiter=",", dtype=np.float32)
    if data.ndim == 1:
        data = data[:, None]
    if data.shape[1] != n_sites:
        raise ValueError(f"expected {n_sites} columns, got {data.shape[1]}")
    return torch.from_numpy(data).to(resolve_device(device))
