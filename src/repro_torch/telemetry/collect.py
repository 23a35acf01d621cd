"""Host-side decoding: engine outputs + TelemetryFrame -> JSON-ready records.

One flat record stream per run, newline-delimited when written to disk
(:mod:`repro_torch.telemetry.export`). Record types:

* ``{"type": "meta", ...}`` — engine kind, horizon, level, schema version.
* ``{"type": "event", "t": ..., "code": "recovery" | "epoch" | "switch" |
  "ingest_redirect", ...}`` — the in-loop ring decoded by code schema,
  plus the post-loop *derived* events (GMSA manager-switch edges from
  ``f_trace``); recovery events carry ``time_to_slo`` (slots from the
  death edge until the backlog stream re-enters the SLO band; ``null`` if
  it never does within the horizon).
* ``{"type": "metric", "t": ..., ...}`` — per-slot streams (dispatch /
  compute cost, backlog, per-slot WAN for staged runs, the SUMMARY-level
  extra stacked outputs).
* ``{"type": "summary", ...}`` — the engine's ``summarize_*`` dict,
  embedded so the report tool can cross-check the stream standalone.

This module never imports the engines (duck-typing on output fields keeps
``repro_torch.telemetry`` dependency-free and cycle-free); engines import only
:mod:`repro_torch.telemetry.config` / :mod:`repro_torch.telemetry.ring`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from torch import Tensor

from repro_torch.telemetry.config import TelemetryConfig
from repro_torch.telemetry.metrics import percentile_table
from repro_torch.telemetry.ring import (
    CODE_NAMES,
    EV_EPOCH,
    EV_INGEST_REDIRECT,
    EV_RECOVERY,
    EV_REPAIR,
    TelemetryFrame,
    ring_events,
)

SCHEMA_VERSION = 1

#: Per-code payload field names, in ring lane order.
FIELDS_BY_CODE = {
    EV_RECOVERY: ("recovery_gb", "recovery_cost", "n_died", "site"),
    EV_EPOCH: ("wan_gb", "wan_cost", "sync_cost", "churn", "budget_use",
               "epoch"),
    EV_INGEST_REDIRECT: ("redirected_mass", "n_dead"),
    EV_REPAIR: ("n_revived", "site"),
}
_INT_FIELDS = {"n_died", "site", "epoch", "n_dead", "k", "src", "dst",
               "stage", "n_revived"}


def _np(x):
    """A tensor (on any device) or array-like as a host numpy array."""
    if isinstance(x, Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def engine_kind(outs) -> str:
    """Duck-typed engine identification from the outputs NamedTuple."""
    if hasattr(outs, "recovery_cost"):
        return "placed"
    if hasattr(outs, "completed"):
        return "staged"
    return "sim"


def switch_events(f_trace: np.ndarray) -> list[dict]:
    """GMSA manager-switch edges derived from the dispatch trace.

    ``f_trace`` is (T, N, K) or (T, N, K, S); a switch fires at slot t for
    type k (stage s) when the argmax site differs from slot t-1's. One-hot
    dispatch makes the argmax the manager choice; fractional policies
    (DATA/RANDOM) report their modal site, which is still the natural
    "where is the mass going" edge.
    """
    f = _np(f_trace)
    staged = f.ndim == 4
    if not staged:
        f = f[..., None]                                    # (T, N, K, 1)
    site = f.argmax(axis=1)                                 # (T, K, S)
    events: list[dict] = []
    prev = site[0]
    for t in range(1, site.shape[0]):
        cur = site[t]
        moved = np.argwhere(cur != prev)
        for k, s in moved:
            ev = {
                "type": "event", "t": int(t), "code": "switch",
                "k": int(k), "src": int(prev[k, s]), "dst": int(cur[k, s]),
            }
            if staged:
                ev["stage"] = int(s)
            events.append(ev)
        prev = cur
    return events


def hedge_events(hedged_jobs, hedge_cost=None) -> list[dict]:
    """Speculation events derived from the per-slot hedge trace.

    The staged/serve engines bill hedging after the loop, so there is no
    in-ring record; one ``hedge`` event per slot where speculative clones
    actually completed work, carrying the re-executed job-units (and the
    $ bill when the cost series is given).
    """
    hj = _np(hedged_jobs)
    hc = _np(hedge_cost) if hedge_cost is not None else None
    events = []
    for t in np.nonzero(hj > 0.0)[0]:
        ev = {"type": "event", "t": int(t), "code": "hedge",
              "hedged_jobs": float(hj[t])}
        if hc is not None:
            ev["hedge_cost"] = float(hc[t])
        events.append(ev)
    return events


def link_down_events(link_health) -> list[dict]:
    """Severed-link edges derived from a (T, N, N) link-health trace.

    One ``link_down`` event per directed off-diagonal link transition:
    ``edge="down"`` the slot the factor first hits zero, ``edge="up"``
    the slot it recovers. Degraded-but-alive links emit nothing — they
    are priced, not partitioned.
    """
    lh = _np(link_health)
    severed = lh <= 0.0
    n = lh.shape[1]
    prev = np.zeros((n, n), bool)
    events = []
    for t in range(lh.shape[0]):
        cur = severed[t]
        for i, j in np.argwhere(cur & ~prev):
            if i != j:
                events.append({"type": "event", "t": int(t),
                               "code": "link_down", "src": int(i),
                               "dst": int(j), "edge": "down"})
        for i, j in np.argwhere(prev & ~cur):
            if i != j:
                events.append({"type": "event", "t": int(t),
                               "code": "link_down", "src": int(i),
                               "dst": int(j), "edge": "up"})
        prev = cur
    return events


def time_to_slo(
    backlog: np.ndarray, t_edge: int, cfg: TelemetryConfig
) -> tuple[int | None, float]:
    """Slots from a death edge until backlog re-enters the SLO band.

    The threshold is ``cfg.slo_backlog`` when set, else ``cfg.slo_factor``
    times the mean backlog over the ``cfg.slo_window`` slots before the
    edge (the pre-fault operating level). Returns ``(slots_or_None, thr)``.
    """
    backlog = _np(backlog)
    if cfg.slo_backlog is not None:
        thr = float(cfg.slo_backlog)
    else:
        lo = max(0, t_edge - cfg.slo_window)
        pre = backlog[lo:t_edge]
        thr = cfg.slo_factor * (float(pre.mean()) if pre.size else 0.0)
    after = backlog[t_edge:]
    ok = np.nonzero(after <= thr)[0]
    return (int(ok[0]) if ok.size else None), thr


def _decoded_ring(frame: TelemetryFrame) -> tuple[list[dict], int]:
    events, dropped = ring_events(frame.ring)
    out = []
    for ev in events:
        code = ev["code"]
        rec = {"type": "event", "t": ev["t"],
               "code": CODE_NAMES.get(code, str(code))}
        for i, name in enumerate(FIELDS_BY_CODE.get(code, ())):
            v = float(ev["val"][i])
            rec[name] = int(v) if name in _INT_FIELDS else v
        out.append(rec)
    return out, dropped


def collect_records(
    outs,
    frame: TelemetryFrame | None = None,
    *,
    cfg: TelemetryConfig | None = None,
    summary: dict | None = None,
    meta: dict | None = None,
    include_switches: bool = True,
    include_metrics: bool = True,
    link_health=None,
) -> list[dict]:
    """Build the full record stream for one run.

    ``outs`` must be a single run (no Monte-Carlo axis) — flight recording
    is per-run by construction; index one run of a batched call first.

    Recovery events pair with the next ``repair`` event (the revival edge
    the controller records): ``time_to_slo`` measures from the TRUE
    revival slot — a dead site cannot re-enter the SLO band before it is
    back — with the repair slot surfaced as ``repair_t``; an unpaired
    recovery falls back to its own death slot. Staged/serve runs with a
    nonzero hedge trace add derived ``hedge`` events; passing the run's
    ``link_health`` trace adds derived ``link_down`` edges.
    """
    cfg = cfg or TelemetryConfig()
    kind = engine_kind(outs)
    cost = _np(outs.cost)
    if cost.ndim != 1:
        raise ValueError(
            "collect_records decodes ONE run; index the Monte-Carlo axis "
            f"first (got cost shape {cost.shape})"
        )
    t_slots = cost.shape[0]
    backlog = _np(outs.backlog_avg)

    records: list[dict] = [{
        "type": "meta", "schema": SCHEMA_VERSION, "kind": kind,
        "t_slots": int(t_slots),
        "level": int(cfg.level), **(meta or {}),
    }]

    events: list[dict] = []
    dropped = 0
    if frame is not None:
        events, dropped = _decoded_ring(frame)
        repair_ts = sorted(e["t"] for e in events if e["code"] == "repair")
        for ev in events:
            if ev["code"] == "recovery":
                t0 = next((rt for rt in repair_ts if rt >= ev["t"]), ev["t"])
                tts, thr = time_to_slo(backlog, t0, cfg)
                ev["time_to_slo"] = tts
                ev["slo_backlog"] = thr
                if t0 != ev["t"]:
                    ev["repair_t"] = t0
    records[0]["events_dropped"] = dropped
    hedged = getattr(outs, "hedged_jobs", None)
    if hedged is not None and float(_np(hedged).sum()) > 0.0:
        events.extend(hedge_events(hedged, getattr(outs, "hedge_cost", None)))
    if link_health is not None:
        events.extend(link_down_events(link_health))
    if include_switches:
        events.extend(switch_events(outs.f_trace))
    events.sort(key=lambda e: (e["t"], e["code"]))
    records.extend(events)

    if include_metrics:
        metrics = dict(frame.metrics) if frame is not None else {}
        q_site = metrics.get("q_site")
        stage_wan = metrics.get("stage_wan_cost")
        stage_gb = metrics.get("stage_wan_gb")
        wan_slot = _np(outs.wan_cost) if kind == "staged" else None
        wan_gb_slot = _np(outs.wan_gb) if kind == "staged" else None
        rec_slot = _np(outs.recovery_cost) if kind == "placed" else None
        rec_gb_slot = _np(outs.recovery_gb) if kind == "placed" else None
        for t in range(t_slots):
            rec = {"type": "metric", "t": t,
                   "cost": float(cost[t]), "backlog": float(backlog[t])}
            if q_site is not None:
                rec["q_site"] = [float(x) for x in _np(q_site)[t]]
            if wan_slot is not None:
                rec["wan_cost"] = float(wan_slot[t])
                rec["wan_gb"] = float(wan_gb_slot[t])
            if stage_wan is not None:
                rec["stage_wan_cost"] = [float(x) for x in _np(stage_wan)[t]]
                rec["stage_wan_gb"] = [float(x) for x in _np(stage_gb)[t]]
            if rec_slot is not None and rec_slot[t] != 0.0:
                rec["recovery_cost"] = float(rec_slot[t])
                rec["recovery_gb"] = float(rec_gb_slot[t])
            records.append(rec)

    if frame is not None and cfg.histograms:
        # The distribution layer: per-row bucket counts plus the decoded
        # percentile table (with error bounds), one record per family.
        dims = {"site_cost_hist": "site", "queue_delay_hist": "stage",
                "sojourn_hist": "class"}
        for name, h in frame.metrics.items():
            if not name.endswith("_hist"):
                continue
            counts = _np(h)
            records.append({
                "type": "hist", "name": name[:-5],
                "dim": dims.get(name, "row"),
                "spec": dataclasses.asdict(cfg.hist),
                "counts": counts.tolist(),
                "percentiles": percentile_table(counts, cfg.hist),
            })

    if summary is not None:
        records.append({"type": "summary", "kind": kind, **summary})
    return records


def fleet_records(out: dict, *, meta: dict | None = None,
                  slo=None) -> list[dict]:
    """Record stream for one serving-engine run (the dict
    :meth:`repro_torch.serve.engine.FleetEngine.run` returns, or the JAX
    package's ``FleetEngine.run`` dict).

    The serving engine returns a plain dict (its history carries host-side
    per-slot records already), so this is a thin re-shaping into the same
    meta / event / metric / summary stream ``collect_records`` emits for
    the simulator engines — one writer (:func:`repro_torch.telemetry.export.write_jsonl`)
    and one report tool serve all engines. Recovery events carry
    ``time_to_slo`` against the run's total-backlog series, thresholded at
    the engine's own ``slo_backlog`` (summed over classes).

    Metric rows carry per-class ``admitted_k`` / ``completed_k`` /
    ``choice`` columns so the span builder
    (:func:`repro_torch.telemetry.spans.spans_from_records`) can rebuild
    request-cohort lifecycles from the saved stream alone. A run with
    the histogram layer on adds a ``hist`` record (sojourn counts +
    decoded percentiles); passing ``slo`` (a
    :class:`repro_torch.telemetry.slo.SloSpec`) folds multi-window burn-rate
    alerts into the event stream and per-class SLO verdicts into the
    summary.
    """
    from repro_torch.telemetry.metrics import HistogramSpec
    from repro_torch.telemetry.slo import burn_events, evaluate_slo

    cost = _np(out["cost"])
    backlog = _np(out["backlog"])
    t_slots = cost.shape[0]
    n_k = len(out["history"][0]["admitted"])
    class_names = list(out.get("class_names")
                       or [f"class{i}" for i in range(n_k)])
    slo_thr = None
    records: list[dict] = [{
        "type": "meta", "schema": SCHEMA_VERSION, "kind": "serve",
        "t_slots": int(t_slots), "level": 0, "events_dropped": 0,
        "class_names": class_names,
        **(meta or {}),
    }]

    events = [dict(ev) for ev in out.get("events", ())]
    if slo is not None:
        events.extend(burn_events(out["admitted"], out["completed"], slo,
                                  class_names=class_names))
    for ev in events:
        if slo_thr is None:
            # Fleet-level SLO: every class at its per-class threshold.
            slo_thr = float(meta.get("slo_backlog", 0.0)) * n_k if meta else 0.0
        tts, thr = time_to_slo(
            backlog, ev["t"],
            TelemetryConfig(slo_backlog=slo_thr or float(backlog.mean())),
        )
        ev["time_to_slo"] = tts
        ev["slo_backlog"] = thr
    if "hedged_jobs" in out:
        events.extend(hedge_events(out["hedged_jobs"],
                                   out.get("hedge_cost")))
    events.extend(switch_events(out["dispatch"]))
    events.sort(key=lambda e: (e["t"], e["code"]))
    records.extend(events)

    wan_slot = _np(out["wan_cost"])
    wan_gb = _np(out["wan_gb"])
    for t, h in enumerate(out["history"]):
        records.append({
            "type": "metric", "t": t,
            "cost": float(cost[t]), "backlog": float(backlog[t]),
            "wan_cost": float(wan_slot[t]), "wan_gb": float(wan_gb[t]),
            "admitted": float(sum(h["admitted"])),
            "rejected": float(sum(h["rejected"])),
            "served": float(sum(h["served"])),
            "energy_j": float(sum(h["energy_j"])),
            "slo_viol": int(sum(h["slo_viol"])),
            "admitted_k": [float(x) for x in h["admitted"]],
            "completed_k": [float(x) for x in h["completed"]],
            "choice": [int(x) for x in h["choice"]],
        })

    if "sojourn_hist" in out:
        spec = HistogramSpec(**out["sojourn_spec"])
        counts = _np(out["sojourn_hist"])
        records.append({
            "type": "hist", "name": "sojourn", "dim": "class",
            "spec": dataclasses.asdict(spec),
            "counts": counts.tolist(),
            "percentiles": percentile_table(counts, spec,
                                            names=class_names),
        })
        if slo is not None:
            records.append({
                "type": "slo", "verdicts": evaluate_slo(
                    counts, spec, slo, names=class_names),
            })

    summary = {
        "type": "summary", "kind": "serve",
        "mean_cost": float(out["mean_cost"]),
        "final_backlog": float(out["final_backlog"]),
        "total_billed_cost": float(out["total_billed_cost"]),
        "admitted": float(_np(out["admitted"]).sum()),
        "rejected": float(_np(out["rejected"]).sum()),
        "served": float(_np(out["served"]).sum()),
        "exec_jobs": int(out["exec_jobs"]),
        "n_recoveries": int(len(out.get("events", ()))),
    }
    if "hedged_jobs" in out:
        summary["hedged_jobs"] = float(_np(out["hedged_jobs"]).sum())
        summary["hedge_cost"] = float(_np(out["hedge_cost"]).sum())
    records.append(summary)
    return records
