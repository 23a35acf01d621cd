"""Seeded site-failure / recovery traces (the chaos scenario class).

The reliability gap of geo-distributed analytics (Zhang et al., reliable
geo-distributed executions) is site loss: a whole DC drops out of the fleet
— power event, WAN partition, regional outage — and the control plane must
re-place data and re-dispatch the lost backlog over the survivors. These
generators produce the per-slot **alive mask** consumed by
:func:`repro_torch.placement.controller.simulate_placed`:

* :func:`site_failure_trace` — a seeded Markov on/off process per site:
  alive sites die with ``failure_prob`` per slot, dead sites come back after
  ``repair_slots`` (``None`` = permanent loss). Never kills below
  ``min_alive`` survivors, so the control plane always has somewhere to
  evacuate to.
* :func:`scheduled_failure_trace` — deterministic (site, down_at, up_at)
  events for regression tests and benchmarks.

Masks are (T, N) float32 in {0, 1}; 1 = alive. An all-ones mask is the
no-fault scenario, and the controller's fault path reproduces its no-fault
path on it bit for bit.

Beyond binary death, the *degraded-mode* generators produce a **health
factor** in ``[0, 1]`` — 0 = dead, 1 = nominal, interior = straggler:

* :func:`health_trace` — seeded Markov straggler onset/recovery per site;
* :func:`region_assignment` / :func:`regional_health_trace` — contiguous
  region blocks and shared-fate regional outages;
* :func:`compose_health` — elementwise-min composition of hazard traces;
* :func:`scheduled_health_trace` — deterministic degradation windows;
* :func:`health_to_alive` — project a health trace to the alive mask.

Random draws come from an explicit ``torch.Generator``, one batch of
uniforms per slot in the order the chain consumes them; tensors are made on
``device`` (``None``: CUDA), which must be the generator's. The JAX package
draws from threefry keys, so the two agree by distribution, and exactly in
shapes, value sets and validation errors.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from repro_torch.device import resolve_device

#: Slots a permanently lost site stays down (never reached in a horizon).
_FOREVER = 2**31 - 1


def site_failure_trace(
    generator: torch.Generator,
    t_slots: int,
    n_sites: int,
    failure_prob: float = 0.002,
    repair_slots: int | None = None,
    min_alive: int = 1,
    device=None,
) -> Tensor:
    """(T, N) seeded alive mask: per-slot death coins + timed repair.

    Each alive site dies independently with ``failure_prob`` per slot; a
    dead site stays down for ``repair_slots`` slots and then revives
    (``None`` = it never comes back). Any slot whose deaths would leave
    fewer than ``min_alive`` survivors suppresses that slot's deaths
    entirely — the fleet never loses its last evacuation target.
    """
    if not 0 <= min_alive <= n_sites:
        raise ValueError(f"min_alive={min_alive} out of range for N={n_sites}")
    dev = resolve_device(device)
    # repair_slots=0 would revive in the same slot the site died (no-op
    # failures): a 1-slot floor.
    repair = _FOREVER if repair_slots is None else max(int(repair_slots), 1)
    down_left = torch.zeros((n_sites,), dtype=torch.int64, device=dev)
    rows = []
    for _ in range(t_slots):
        alive = down_left == 0
        coins = torch.rand((n_sites,), generator=generator, device=dev)
        dies = alive & (coins < failure_prob)
        survivors_after = alive.sum() - dies.sum()
        dies = dies & (survivors_after >= min_alive)
        down_left = torch.where(dies, repair, torch.clamp_min(down_left - 1, 0))
        rows.append((down_left == 0).to(torch.float32))
    return torch.stack(rows) if rows else torch.ones((0, n_sites), device=dev)


def scheduled_failure_trace(
    t_slots: int,
    n_sites: int,
    events: list[tuple[int, int, int | None]],
    device=None,
) -> Tensor:
    """(T, N) alive mask from explicit (site, down_at, up_at) events, on
    ``device`` (``None``: CUDA).

    ``up_at=None`` means the site never recovers. Slots are half-open:
    site is dead for ``down_at <= t < up_at``.
    """
    mask = np.ones((t_slots, n_sites), np.float32)
    for site, down_at, up_at in events:
        if not 0 <= site < n_sites:
            raise ValueError(f"site {site} out of range for N={n_sites}")
        if down_at < 0:
            # A negative down_at would silently wrap via Python slice
            # semantics and kill the *tail* of the trace instead.
            raise ValueError(f"down_at={down_at} must be >= 0")
        if up_at is not None and up_at <= down_at:
            # An empty/inverted window silently no-ops; reject it loudly.
            raise ValueError(
                f"up_at={up_at} must be > down_at={down_at} (or None)"
            )
        end = t_slots if up_at is None else min(up_at, t_slots)
        mask[down_at:end, site] = 0.0
    return torch.from_numpy(mask).to(resolve_device(device))


def _previous(alive: Tensor) -> Tensor:
    """Each slot's predecessor mask; slot 0 follows an all-alive fleet."""
    return torch.cat([torch.ones_like(alive[:1]), alive[:-1]], dim=0)


def failure_edges(alive: Tensor) -> Tensor:
    """(T, N) mask of death edges: 1 where a site is newly dead this slot.

    Slot 0 compares against an all-alive fleet, so a trace that starts with
    a dead site fires its edge at t=0 — the controller's recovery epoch
    triggers exactly on these edges.
    """
    alive = torch.as_tensor(alive, dtype=torch.float32)
    return _previous(alive) * (1.0 - alive)


def repair_edges(alive: Tensor) -> Tensor:
    """(T, N) mask of repair edges: 1 where a site revives this slot.

    The companion of :func:`failure_edges`. A trace can never open with a
    revival, so a repair edge always pairs with an earlier death edge.
    """
    alive = torch.as_tensor(alive, dtype=torch.float32)
    return (1.0 - _previous(alive)) * alive


# ---------------------------------------------------------------------------
# Degraded-mode health: stragglers, regions, shared fate.
# ---------------------------------------------------------------------------


def health_trace(
    generator: torch.Generator,
    t_slots: int,
    n_sites: int,
    straggle_prob: float = 0.02,
    recover_prob: float = 0.25,
    severity: tuple[float, float] = (0.2, 0.7),
    death_prob: float = 0.0,
    device=None,
) -> Tensor:
    """(T, N) seeded health factor: Markov straggler onset/recovery.

    Each healthy site starts straggling with ``straggle_prob`` per slot,
    drawing a severity factor uniform in ``severity`` (the fraction of
    nominal service rate it retains); a straggling site recovers with
    ``recover_prob``. With ``death_prob > 0`` an onset event is instead a
    full death (factor 0) with that conditional probability — dead sites
    rejoin the same recovery chain. An all-healthy draw is exactly 1.0
    everywhere, so downstream ``mu * health`` stays the nominal path.
    """
    lo, hi = severity
    if not 0.0 <= lo <= hi <= 1.0:
        raise ValueError(f"severity bounds {severity} must satisfy "
                         "0 <= lo <= hi <= 1")
    dev = resolve_device(device)
    factor = torch.ones((n_sites,), dtype=torch.float32, device=dev)
    rows = []
    for _ in range(t_slots):
        u = torch.rand((4, n_sites), generator=generator, device=dev)
        healthy = factor >= 1.0
        onsets = healthy & (u[0] < straggle_prob)
        sev = lo + (hi - lo) * u[1]
        sev = torch.where(onsets & (u[2] < death_prob), 0.0, sev)
        recovers = ~healthy & (u[3] < recover_prob)
        factor = torch.where(onsets, sev, torch.where(recovers, 1.0, factor))
        rows.append(factor)
    return torch.stack(rows) if rows else torch.ones((0, n_sites), device=dev)


def region_assignment(n_sites: int, n_regions: int, device=None) -> Tensor:
    """(N,) int32 region ids: contiguous, balanced blocks of sites, on
    ``device`` (``None``: CUDA).

    Site ``i`` lands in region ``i * n_regions // n_sites``.
    """
    if not 1 <= n_regions <= n_sites:
        raise ValueError(
            f"n_regions={n_regions} out of range for N={n_sites}")
    dev = resolve_device(device)
    return (torch.arange(n_sites, dtype=torch.int32, device=dev) * n_regions) // n_sites


def regional_health_trace(
    generator: torch.Generator,
    t_slots: int,
    regions: Tensor,
    outage_prob: float = 0.01,
    repair_slots: int = 6,
    outage_factor: float = 0.0,
    min_regions_up: int = 1,
) -> Tensor:
    """(T, N) shared-fate health: whole regions degrade or die together.

    A healthy region suffers an outage with ``outage_prob`` per slot;
    every site in it drops to ``outage_factor`` (0 = regional blackout,
    interior = brownout) for ``repair_slots`` slots. Outages that would
    leave fewer than ``min_regions_up`` healthy regions are suppressed.
    Made on the device of ``regions``, which must be the generator's.
    """
    regions = torch.as_tensor(regions).to(torch.int64)
    dev = regions.device
    n_regions = int(regions.max()) + 1
    if not 1 <= min_regions_up <= n_regions:
        raise ValueError(f"min_regions_up={min_regions_up} out of range "
                         f"for {n_regions} regions")
    repair = max(int(repair_slots), 1)
    down_left = torch.zeros((n_regions,), dtype=torch.int64, device=dev)
    rows = []
    for _ in range(t_slots):
        healthy = down_left == 0
        coins = torch.rand((n_regions,), generator=generator, device=dev)
        fails = healthy & (coins < outage_prob)
        up_after = healthy.sum() - fails.sum()
        fails = fails & (up_after >= min_regions_up)
        down_left = torch.where(fails, repair, torch.clamp_min(down_left - 1, 0))
        factor = torch.where(down_left == 0, 1.0, outage_factor).to(torch.float32)
        rows.append(factor[regions])
    return torch.stack(rows) if rows else torch.ones((0, regions.shape[0]), device=dev)


def compose_health(*traces: Tensor) -> Tensor:
    """Elementwise-min composition of independent (T, N) hazard traces:
    the binding constraint wins, and any dead factor (0) dominates."""
    if not traces:
        raise ValueError("compose_health needs at least one trace")
    health = torch.as_tensor(traces[0], dtype=torch.float32)
    for t in traces[1:]:
        health = torch.minimum(health, torch.as_tensor(t, dtype=torch.float32))
    return health


def scheduled_health_trace(
    t_slots: int,
    n_sites: int,
    events: list[tuple[int, int, int | None, float]],
    device=None,
) -> Tensor:
    """(T, N) health factor from explicit (site, start, end, factor) events,
    on ``device`` (``None``: CUDA).

    ``end=None`` means the degradation never lifts. Windows are half-open
    (``start <= t < end``); overlapping windows take the minimum factor.
    Negative ``start``, empty windows, out-of-range sites and factors
    outside ``[0, 1]`` raise.
    """
    health = np.ones((t_slots, n_sites), np.float32)
    for site, start, end, factor in events:
        if not 0 <= site < n_sites:
            raise ValueError(f"site {site} out of range for N={n_sites}")
        if start < 0:
            raise ValueError(f"start={start} must be >= 0")
        if end is not None and end <= start:
            raise ValueError(f"end={end} must be > start={start} (or None)")
        if not 0.0 <= factor <= 1.0:
            raise ValueError(f"factor={factor} must be in [0, 1]")
        stop = t_slots if end is None else min(end, t_slots)
        health[start:stop, site] = np.minimum(
            health[start:stop, site], np.float32(factor))
    return torch.from_numpy(health).to(resolve_device(device))


def health_to_alive(health: Tensor) -> Tensor:
    """Project a (T, N) health factor to the binary alive mask: only factor
    0 is death; every straggler is alive."""
    return (torch.as_tensor(health, dtype=torch.float32) > 0.0).to(torch.float32)
