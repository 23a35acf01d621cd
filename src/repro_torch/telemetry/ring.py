"""Fixed-capacity, mask-compacted event ring — flight recording on the device.

A static-shape circular buffer carried through a slot loop, written with
masked updates (``do`` is a boolean tensor: no host round trip, no shape
change), so recording an event costs a handful of elementwise kernels and
recording *nothing* costs the same handful with the mask low. The ring
keeps a monotone push count; host-side :func:`ring_events` reorders the
buffer into push order and reports how many events fell off the back
(capacity overflow is detected, never silent).

Event payloads are ``N_FIELDS`` float32 lanes whose meaning depends on the
event code — the schema lives with the codes below.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch import Tensor

from repro_torch.device import resolve_device

#: Payload lanes per event (fixed so the ring's shape is static).
N_FIELDS = 6

# -- event codes ------------------------------------------------------------
#: Off-schedule recovery epoch fired on a site-death edge (placed engine).
#: fields: [recovery_gb, recovery_cost, n_died, first_dead_site, 0, 0]
EV_RECOVERY = 1
#: Slow-loop epoch boundary (placed engine).
#: fields: [wan_gb, wan_cost, sync_cost, churn, budget_use, epoch]
EV_EPOCH = 2
#: GMSA manager-switch edge (derived after the loop from f_trace).
#: fields: [k, from_site, to_site, stage, 0, 0]
EV_SWITCH = 3
#: Ingest aimed at dead sites redirected to survivors (placed engine).
#: fields: [redirected_mass, n_dead, 0, 0, 0, 0]
EV_INGEST_REDIRECT = 4
#: Site revival edge (placed engine) — the companion of EV_RECOVERY; the
#: SLO clock measures recovery from this slot, not the death slot.
#: fields: [n_revived, site, 0, 0, 0, 0]
EV_REPAIR = 5
#: Speculative re-execution fired (staged/serve engines; derived after the
#: loop from the hedge trace). fields: [hedged_jobs, hedge_cost]
EV_HEDGE = 6
#: A WAN link severed (derived from the link-health trace).
#: fields: [src, dst, 0/1 down-edge vs up-edge]
EV_LINK_DOWN = 7

CODE_NAMES = {
    EV_RECOVERY: "recovery",
    EV_EPOCH: "epoch",
    EV_SWITCH: "switch",
    EV_INGEST_REDIRECT: "ingest_redirect",
    EV_REPAIR: "repair",
    EV_HEDGE: "hedge",
    EV_LINK_DOWN: "link_down",
}


class EventRing(NamedTuple):
    """The carried recorder state: (count, t, code, val) — all static shape."""

    count: Tensor   # ()  int32  total pushes attempted (drops = count - C)
    t: Tensor       # (C,) int32  slot index of each buffered event
    code: Tensor    # (C,) int32  event code
    val: Tensor     # (C, N_FIELDS) float32 payload


class TelemetryFrame(NamedTuple):
    """What an engine returns next to its outputs when telemetry is on.

    ``ring`` holds the events recorded in the loop (empty when the engine
    records none or the level is SUMMARY); ``metrics`` maps stream names to
    per-slot (or per-epoch) tensors.
    """

    ring: EventRing
    metrics: dict


def ring_init(capacity: int, device=None) -> EventRing:
    """An empty ring of ``capacity`` slots on ``device`` (``None``: CUDA)."""
    dev = resolve_device(device)
    return EventRing(
        count=torch.zeros((), dtype=torch.int32, device=dev),
        t=torch.full((capacity,), -1, dtype=torch.int32, device=dev),
        code=torch.zeros((capacity,), dtype=torch.int32, device=dev),
        val=torch.zeros((capacity, N_FIELDS), dtype=torch.float32, device=dev),
    )


def ring_push(
    ring: EventRing,
    do: Tensor | bool,
    t: Tensor | int,
    code: int,
    fields: Sequence[Tensor | float],
) -> EventRing:
    """Record one event iff ``do`` — a masked write, no host round trip.

    When ``do`` is low every buffer row keeps its old value and the count
    does not advance, so the no-event path leaves the ring bitwise as it
    was. ``fields`` is up to ``N_FIELDS`` scalars (zero-padded).

    A ring stacked over leading run dimensions (``count`` of shape (*B,))
    records one event per run: ``do``, ``t`` and each field are scalars
    or (*B,) tensors.
    """
    cap = ring.t.shape[-1]
    if len(fields) > N_FIELDS:
        raise ValueError(f"at most {N_FIELDS} payload fields, got {len(fields)}")
    dev = ring.t.device
    batch = tuple(ring.count.shape)
    zero = torch.zeros(batch, dtype=torch.float32, device=dev)
    row = torch.stack(
        [torch.as_tensor(f, dtype=torch.float32, device=dev).broadcast_to(batch) for f in fields]
        + [zero] * (N_FIELDS - len(fields)), dim=-1)                                  # (*B, F)
    do = torch.as_tensor(do, dtype=torch.bool, device=dev).broadcast_to(batch)
    slot = torch.remainder(ring.count, cap).unsqueeze(-1)
    hit = do.unsqueeze(-1) & (torch.arange(cap, device=dev) == slot)                  # (*B, C)
    t = torch.as_tensor(t, dtype=torch.int32, device=dev)
    return EventRing(
        count=ring.count + do.to(torch.int32),
        t=torch.where(hit, t.unsqueeze(-1) if t.ndim else t, ring.t),
        code=torch.where(hit, torch.tensor(code, dtype=torch.int32, device=dev), ring.code),
        val=torch.where(hit.unsqueeze(-1), row.unsqueeze(-2), ring.val),
    )


def empty_frame(device=None) -> TelemetryFrame:
    """A frame with a one-slot empty ring and no metrics — engines that
    derive all their events after the loop."""
    return TelemetryFrame(ring=ring_init(1, device=device), metrics={})


def ring_events(ring: EventRing) -> tuple[list[dict], int]:
    """Host-side decode: buffered events in push order + dropped count.

    Returns ``(events, dropped)`` where each event is
    ``{"t": int, "code": int, "val": np.ndarray(N_FIELDS,)}`` and
    ``dropped`` counts pushes that fell off the back of the ring.
    """
    host = lambda x: x.detach().cpu().numpy() if isinstance(x, Tensor) else np.asarray(x)
    count = int(host(ring.count))
    cap = ring.t.shape[0]
    n = min(count, cap)
    dropped = count - n
    idx = (count - n + np.arange(n)) % cap
    t = host(ring.t)[idx]
    code = host(ring.code)[idx]
    val = host(ring.val)[idx]
    return (
        [{"t": int(t[i]), "code": int(code[i]), "val": val[i]} for i in range(n)],
        dropped,
    )
