"""repro_torch.telemetry — the flight recorder's device side.

* :mod:`~repro_torch.telemetry.config`: the :class:`TelemetryConfig` level
  (``OFF`` runs the engines' own operations exactly; ``SUMMARY`` adds
  per-slot metric streams; ``TRACE`` adds the event ring). Engines return
  ``(outputs, TelemetryFrame)`` when a level is on.
* :mod:`~repro_torch.telemetry.ring`: the fixed-capacity, mask-compacted
  :class:`EventRing` and its host-side decode.
* :mod:`~repro_torch.telemetry.metrics`: log-bucket histograms on the
  device, the FIFO sojourn clock, and their numpy decode to p50/p95/p99
  with error bounds.
* :mod:`~repro_torch.telemetry.slo`: percentile SLOs with multi-window
  burn-rate alerts (numpy).
"""

from repro_torch.telemetry.config import (
    OFF,
    SUMMARY,
    TRACE,
    Level,
    TelemetryConfig,
    enabled,
    histograms,
    tracing,
)
from repro_torch.telemetry.metrics import (
    HistogramSpec,
    fifo_sojourn_replay,
    hist_add,
    hist_init,
    hist_quantiles,
    hist_series,
    percentile_table,
    sojourn_init,
    sojourn_step,
    weighted_percentile,
)
from repro_torch.telemetry.ring import (
    EV_EPOCH,
    EV_HEDGE,
    EV_INGEST_REDIRECT,
    EV_LINK_DOWN,
    EV_RECOVERY,
    EV_REPAIR,
    EV_SWITCH,
    EventRing,
    TelemetryFrame,
    empty_frame,
    ring_events,
    ring_init,
    ring_push,
)
from repro_torch.telemetry.slo import SloSpec, burn_events, evaluate_slo

__all__ = [
    "Level", "TelemetryConfig", "OFF", "SUMMARY", "TRACE",
    "enabled", "tracing", "histograms",
    "EventRing", "TelemetryFrame", "empty_frame",
    "ring_init", "ring_push", "ring_events",
    "EV_RECOVERY", "EV_EPOCH", "EV_SWITCH", "EV_INGEST_REDIRECT",
    "EV_REPAIR", "EV_HEDGE", "EV_LINK_DOWN",
    "HistogramSpec", "hist_init", "hist_add", "hist_series",
    "hist_quantiles", "percentile_table", "sojourn_init", "sojourn_step",
    "fifo_sojourn_replay", "weighted_percentile",
    "SloSpec", "burn_events", "evaluate_slo",
]
