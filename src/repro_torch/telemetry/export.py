"""Exporters: JSONL event logs, text timelines, and the summary cross-check.

The cross-check is the telemetry layer's own regression: the event/metric
stream must carry enough information to rebuild the engine's
``summarize_*`` totals — dispatch/compute cost from the per-slot metric
stream, WAN + sync from the epoch events, recovery cost/GB from the
recovery events — to float tolerance. A stream that dropped ring events
(capacity overflow) is refused outright: a flight recorder that lost
frames cannot certify anything.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

_BLOCKS = " ▁▂▃▄▅▆▇█"


def write_jsonl(records: list[dict], path) -> pathlib.Path:
    """Write one record per line; parents created; returns the path."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w") as fh:
        for rec in records:
            fh.write(json.dumps(rec) + "\n")
    return path


def read_jsonl(path) -> list[dict]:
    """Read a JSONL record stream back into a list of dicts."""
    with pathlib.Path(path).open() as fh:
        return [json.loads(line) for line in fh if line.strip()]


def _by_type(records: list[dict]) -> dict[str, list[dict]]:
    out: dict[str, list[dict]] = {}
    for rec in records:
        out.setdefault(rec.get("type", "?"), []).append(rec)
    return out


def sparkline(values, width: int = 60) -> str:
    """Downsampled unicode sparkline of a 1-D series.

    When downsampling leaves a bin empty (integer edges can collide for
    ``size`` barely above ``width``), the bin carries the PREVIOUS bin's
    mean — a flat continuation — rather than duplicating whatever sample
    sits at the collision index, which would invent a spike out of a
    value the bin never contained. An all-constant series renders as the
    lowest visible block (never blank).
    """
    v = np.asarray(values, np.float64)
    if v.size == 0:
        return ""
    if v.size > width:
        edge = np.linspace(0, v.size, width + 1).astype(int)
        bins, prev = [], float(v[0])
        for a, b in zip(edge[:-1], edge[1:]):
            if b > a:
                prev = float(v[a:b].mean())
            bins.append(prev)
        v = np.asarray(bins)
    lo, hi = float(v.min()), float(v.max())
    if hi == lo:
        return _BLOCKS[1] * v.size
    idx = ((v - lo) / (hi - lo) * (len(_BLOCKS) - 1)).round().astype(int)
    return "".join(_BLOCKS[i] for i in idx)


def _fmt_event(ev: dict) -> str:
    code = ev.get("code", "?")
    if code == "recovery":
        tts = ev.get("time_to_slo")
        tts_s = f"{tts} slots" if tts is not None else "never (horizon)"
        return (f"death edge ▸ site {ev.get('site', ev.get('pod'))} "
                f"({ev.get('n_died')} died)  evacuated "
                f"{ev.get('recovery_gb', 0.0):.1f} GB  "
                f"${ev.get('recovery_cost', 0.0):.2f}  time-to-SLO {tts_s}")
    if code == "epoch":
        return (f"epoch {ev.get('epoch')}  moved {ev.get('wan_gb', 0.0):.1f} GB "
                f"(${ev.get('wan_cost', 0.0):.2f})  sync "
                f"${ev.get('sync_cost', 0.0):.2f}  churn "
                f"{ev.get('churn', 0.0):.3f} "
                f"(budget use {100 * ev.get('budget_use', 0.0):.0f}%)")
    if code == "switch":
        stage = f" s{ev['stage']}" if "stage" in ev else ""
        return (f"manager switch k{ev.get('k')}{stage}: "
                f"site {ev.get('src')} → {ev.get('dst')}")
    if code == "ingest_redirect":
        return (f"ingest redirect: {ev.get('redirected_mass', 0.0):.3f} mass "
                f"off {ev.get('n_dead')} dead site(s)")
    return json.dumps(ev)


def render_timeline(
    records: list[dict],
    *,
    codes: set[str] | None = None,
    max_events: int = 200,
    width: int = 60,
) -> str:
    """Human-readable flight-record timeline.

    ``codes`` filters the event stream (e.g. ``{"recovery", "epoch"}``);
    the backlog/cost sparklines come from the metric stream when present.
    """
    by = _by_type(records)
    meta = by.get("meta", [{}])[0]
    lines = [
        f"flight record · engine={meta.get('kind', '?')} "
        f"T={meta.get('t_slots', '?')} level={meta.get('level', '?')} "
        f"dropped_events={meta.get('events_dropped', 0)}"
    ]
    metrics = by.get("metric", [])
    if metrics:
        lines.append(
            "  cost    " + sparkline([m["cost"] for m in metrics], width)
        )
        lines.append(
            "  backlog " + sparkline([m["backlog"] for m in metrics], width)
        )
    events = by.get("event", [])
    if codes is not None:
        events = [e for e in events if e.get("code") in codes]
    shown = events[:max_events]
    for ev in shown:
        lines.append(f"  t={ev.get('t', -1):>5}  {_fmt_event(ev)}")
    if len(events) > len(shown):
        lines.append(f"  … {len(events) - len(shown)} more events")
    summ = by.get("summary", [])
    if summ:
        s = summ[0]
        keys = [k for k in s if k.startswith(("time_avg_", "total_"))]
        lines.append("  summary: " + "  ".join(
            f"{k}={s[k]:.4g}" for k in sorted(keys)
        ))
    return "\n".join(lines)


def cross_check(records: list[dict], rtol: float = 1e-5) -> dict:
    """Rebuild the ``summarize_*`` totals from the stream and compare.

    Returns ``{"ok": bool, "kind": ..., "checks": {name: {"stream": x,
    "summary": y, "ok": bool}}, "events_dropped": int}``. Requires the
    stream to contain a ``summary`` record and per-slot metrics. Dropped
    ring events fail the check unconditionally.
    """
    by = _by_type(records)
    meta = by.get("meta", [{}])[0]
    kind = meta.get("kind", "sim")
    t_slots = meta.get("t_slots")
    summary = (by.get("summary") or [None])[0]
    metrics = by.get("metric", [])
    events = by.get("event", [])
    out = {"ok": True, "kind": kind,
           "events_dropped": int(meta.get("events_dropped", 0)),
           "checks": {}}
    if summary is None or not metrics or t_slots is None:
        out["ok"] = False
        out["error"] = "stream lacks summary/metric records"
        return out
    if out["events_dropped"]:
        out["ok"] = False
        out["error"] = f"{out['events_dropped']} ring events dropped"

    def check(name: str, stream_val: float, summary_key: str):
        ref = summary.get(summary_key)
        if ref is None:
            return
        ok = bool(np.isclose(stream_val, ref, rtol=rtol, atol=1e-6))
        out["checks"][name] = {
            "stream": float(stream_val), "summary": float(ref), "ok": ok,
        }
        out["ok"] = out["ok"] and ok

    cost = float(np.sum([m["cost"] for m in metrics])) / t_slots
    if kind == "placed":
        wan = sum(e.get("wan_cost", 0.0) for e in events
                  if e.get("code") == "epoch") / t_slots
        sync = sum(e.get("sync_cost", 0.0) for e in events
                   if e.get("code") == "epoch") / t_slots
        rec = sum(e.get("recovery_cost", 0.0) for e in events
                  if e.get("code") == "recovery") / t_slots
        rec_gb = sum(e.get("recovery_gb", 0.0) for e in events
                     if e.get("code") == "recovery")
        check("dispatch_cost", cost, "time_avg_dispatch_cost")
        check("wan_cost", wan, "time_avg_wan_cost")
        check("sync_cost", sync, "time_avg_sync_cost")
        check("recovery_cost", rec, "time_avg_recovery_cost")
        check("recovery_gb", rec_gb, "total_recovery_gb")
        check("total_cost", cost + wan + sync + rec, "time_avg_total_cost")
    elif kind == "staged":
        wan = float(np.sum([m.get("wan_cost", 0.0) for m in metrics])) / t_slots
        wan_gb = float(np.sum([m.get("wan_gb", 0.0) for m in metrics]))
        hedge = sum(e.get("hedge_cost", 0.0) for e in events
                    if e.get("code") == "hedge") / t_slots
        check("compute_cost", cost, "time_avg_compute_cost")
        check("wan_cost", wan, "time_avg_wan_cost")
        check("wan_gb", wan_gb, "total_wan_gb")
        check("hedge_cost", hedge, "time_avg_hedge_cost")
        check("total_cost", cost + wan + hedge, "time_avg_total_cost")
    else:
        check("cost", cost, "time_avg_cost")
    return out
