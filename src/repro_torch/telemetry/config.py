"""Telemetry levels and the config every engine threads through.

``OFF`` — the default — runs exactly the operations the engines ran
without telemetry: no extra per-slot outputs, no ring, no cost.
``SUMMARY`` adds per-slot metric streams as extra stacked outputs;
``TRACE`` adds the fixed-capacity, mask-compacted event ring recorded in
the slot loop (:mod:`repro_torch.telemetry.ring`).

Engines that enable telemetry return ``(outputs, TelemetryFrame)`` instead
of bare ``outputs``; the frame holds device tensors.
"""

from __future__ import annotations

import dataclasses
import enum

from repro_torch.telemetry.metrics import HistogramSpec


class Level(enum.IntEnum):
    """Telemetry verbosity."""

    OFF = 0       # the engines' operations without telemetry, exactly
    SUMMARY = 1   # per-slot metric streams (extra stacked outputs)
    TRACE = 2     # SUMMARY + the event ring in the slot loop


OFF = Level.OFF
SUMMARY = Level.SUMMARY
TRACE = Level.TRACE


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Flight-recorder knobs (frozen and hashable).

    Attributes:
        level: :class:`Level`. ``OFF`` is bit-exact with no telemetry.
        capacity: event-ring slots. Events beyond capacity overwrite the
            oldest (the ring keeps a total count, so
            :func:`~repro_torch.telemetry.ring.ring_events` reports exactly
            how many were dropped).
        slo_backlog: absolute backlog-per-queue SLO used for the
            recovery-time-to-SLO metric. ``None`` derives the threshold
            per event from the pre-fault backlog window
            (``slo_factor`` × the mean over the ``slo_window`` slots
            before the death edge).
        slo_factor / slo_window: the derived-threshold parameters.
        hist: optional :class:`repro_torch.telemetry.metrics.HistogramSpec`
            enabling the distribution layer at SUMMARY+ — per-site
            energy-cost histograms in ``simulate``. ``None`` (default) adds
            nothing; OFF ignores it entirely.
    """

    level: Level = Level.OFF
    capacity: int = 256
    slo_backlog: float | None = None
    slo_factor: float = 1.5
    slo_window: int = 12
    hist: HistogramSpec | None = None

    @property
    def histograms(self) -> bool:
        return self.enabled and self.hist is not None

    @property
    def enabled(self) -> bool:
        return self.level >= Level.SUMMARY

    @property
    def tracing(self) -> bool:
        return self.level >= Level.TRACE


def enabled(cfg: TelemetryConfig | None) -> bool:
    """True when ``cfg`` asks for any telemetry (None counts as OFF)."""
    return cfg is not None and cfg.enabled


def tracing(cfg: TelemetryConfig | None) -> bool:
    """True when ``cfg`` asks for the event ring."""
    return cfg is not None and cfg.tracing


def histograms(cfg: TelemetryConfig | None) -> bool:
    """True when ``cfg`` asks for the histogram metrics layer."""
    return cfg is not None and cfg.histograms
