"""repro_torch.telemetry — the flight recorder: device side and host side.

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

Host side (numpy; engine outputs may be tensors on any device):

* :mod:`~repro_torch.telemetry.collect`: :func:`collect_records` turns one
  run's outputs + frame into a flat JSON-ready record stream — ring events,
  derived events (manager switches, hedges, link-down edges), per-slot
  metrics, histograms, the embedded summary.
* :mod:`~repro_torch.telemetry.export`: :func:`write_jsonl` /
  :func:`read_jsonl`, :func:`render_timeline` and :func:`cross_check`, with
  the CLI ``python -m repro_torch.telemetry.report run.jsonl --check``.
* :mod:`~repro_torch.telemetry.spans`: record streams folded into lifecycle
  spans, exported as Chrome trace-event JSON.
* ``python -m repro_torch.telemetry.bench_check RECORDS.json``: the
  perf-regression sentinel over a bench trajectory.
* :mod:`~repro_torch.telemetry.ranges`: :func:`span`, the program's named
  ranges (train step phases, layer kinds) for ``torch.profiler``; nothing
  is entered when no profiler is on.
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
from repro_torch.telemetry.spans import (
    controller_spans,
    request_spans,
    spans_from_records,
    straggler_spans,
    to_chrome_trace,
    write_chrome_trace,
)
from repro_torch.telemetry.collect import (
    collect_records,
    engine_kind,
    fleet_records,
    hedge_events,
    link_down_events,
    switch_events,
    time_to_slo,
)
from repro_torch.telemetry.export import (
    cross_check,
    read_jsonl,
    render_timeline,
    sparkline,
    write_jsonl,
)

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
    "collect_records", "engine_kind", "fleet_records", "switch_events",
    "hedge_events", "link_down_events", "time_to_slo",
    "write_jsonl", "read_jsonl", "render_timeline", "sparkline",
    "cross_check",
    "request_spans", "controller_spans", "spans_from_records",
    "straggler_spans", "to_chrome_trace", "write_chrome_trace",
]
