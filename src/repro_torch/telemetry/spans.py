"""Span tracing: fold ordered record streams into lifecycle spans.

The flight recorder emits flat per-slot records; this module folds them
into *spans* — named intervals on named tracks — and exports Chrome
trace-event JSON (the ``chrome://tracing`` / Perfetto format), so a
faulted serving run opens as a timeline: request cohorts admit →
dispatch → prefill → KV shuffle → decode → served per class, controller
epochs and recovery-to-SLO windows on their own tracks, death edges and
manager switches as instants.

Two builders:

* :func:`request_spans` — per-request-class lifecycle spans from a
  serving-engine run's output dict (the JAX package's ``FleetEngine.run``;
  the port's serving control plane comes later). The engine is
  a fluid queue, so "a request" is a *cohort*: the mass admitted in one
  slot, tracked FIFO (the same order the sojourn clock in
  :mod:`repro_torch.telemetry.metrics` assumes) until it drains.
* :func:`controller_spans` — epoch / recovery / switch spans from a
  ``collect_records`` / ``fleet_records`` stream (the list of dicts, or
  whatever :func:`repro_torch.telemetry.export.read_jsonl` returned).
* :func:`straggler_spans` — degraded-health windows from a (T, N) health
  trace: per site, each maximal sub-nominal
  window becomes a ``straggler`` (interior factor) or ``dead`` (factor
  hits zero) span with a ``repaired`` instant at its close — overlay
  these on a faulted run's timeline to see WHY the tail moved.

Both return plain span dicts (``name``/``cat``/``t0``/``t1``/``track``/
``args``; ``t1 is None`` marks an instant), which
:func:`to_chrome_trace` converts — slots mapped to milliseconds — and
:func:`write_chrome_trace` writes. The JSON loads directly in Perfetto
(ui.perfetto.dev) or ``chrome://tracing``.
"""

from __future__ import annotations

import json

import numpy as np

_EPS = 1e-9


def span(name, cat, t0, t1=None, track="main", **args) -> dict:
    """One span: an interval (``t1`` set) or an instant (``t1 is None``)."""
    return {
        "name": str(name), "cat": str(cat), "t0": float(t0),
        "t1": None if t1 is None else float(t1),
        "track": str(track), "args": args,
    }


def fifo_cohorts(admitted: np.ndarray, completed: np.ndarray) -> list[list[tuple]]:
    """FIFO cohort attribution: per class, a list of (s, t, mass) triples.

    ``admitted``/``completed`` are (T, K) fluid counts; mass admitted at
    slot ``s`` is matched FIFO against mass completed at slot ``t >= s``
    by intersecting cumulative-count segments — the exact replay of the
    device-side sojourn clock's drain order.
    """
    admitted = np.asarray(admitted, np.float64)
    completed = np.asarray(completed, np.float64)
    t_slots, k = admitted.shape
    out: list[list[tuple]] = []
    for ki in range(k):
        ca = np.concatenate([[0.0], np.cumsum(admitted[:, ki])])
        cc = np.concatenate([[0.0], np.cumsum(completed[:, ki])])
        tri = []
        for t in range(t_slots):
            lo_c, hi_c = cc[t], cc[t + 1]
            if hi_c - lo_c <= _EPS:
                continue
            for s in range(t + 1):
                m = min(hi_c, ca[s + 1]) - max(lo_c, ca[s])
                if m > _EPS:
                    tri.append((s, t, m))
        out.append(tri)
    return out


def request_spans(out: dict, class_names=None) -> list[dict]:
    """Request-cohort lifecycle spans from a ``FleetEngine.run`` dict.

    One track per request class. Each admit-slot cohort with mass gets a
    parent ``request`` span from its admit slot to its last completion
    slot, with phase children: an ``admit`` instant, a one-slot
    ``prefill`` span at dispatch (the fluid step drains prefill in the
    dispatch slot), a ``kv_shuffle`` instant at the prefill → decode
    handoff, a ``decode`` span covering the completion window, and a
    ``served`` instant at the end. Cohorts still backlogged at the
    horizon close with cat ``unserved`` at ``t_slots``. Recovery events
    from the run add death-edge instants and (when ``time_to_slo`` is
    known from a record stream — see :func:`controller_spans`) windows.
    """
    admitted = np.asarray(out["admitted"], np.float64)
    completed = np.asarray(out["completed"], np.float64)
    t_slots, k = admitted.shape
    names = list(class_names or out.get("class_names")
                 or [f"class{i}" for i in range(k)])
    history = out.get("history", [])
    spans: list[dict] = []
    for ki, tri in enumerate(fifo_cohorts(admitted, completed)):
        track = names[ki]
        by_s: dict[int, list[tuple]] = {}
        for s, t, m in tri:
            by_s.setdefault(s, []).append((t, m))
        for s in range(t_slots):
            adm = admitted[s, ki]
            if adm <= _EPS:
                continue
            done = by_s.get(s, [])
            done_mass = sum(m for _, m in done)
            if done:
                t_first = done[0][0]
                t_end = done[-1][0] + 1
                cat = "request"
            else:
                t_first, t_end, cat = s, t_slots, "unserved"
            decode_pod = None
            if history and done:
                decode_pod = history[done[-1][0]]["choice"][ki]
            spans.append(span(
                f"req {track}@t{s}", cat, s, t_end, track=track,
                mass=round(adm, 3), served_mass=round(done_mass, 3),
                decode_pod=decode_pod,
            ))
            spans.append(span("admit", "phase", s, track=track,
                              mass=round(adm, 3)))
            spans.append(span("prefill", "phase", s, s + 1, track=track))
            if done:
                spans.append(span("kv_shuffle", "phase", t_first,
                                  track=track, decode_pod=decode_pod))
                spans.append(span("decode", "phase", t_first, t_end,
                                  track=track))
                spans.append(span("served", "phase", t_end, track=track,
                                  mass=round(done_mass, 3)))
    for ev in out.get("events", ()):
        spans.append(span(
            f"pod {ev['pod']} died", "fault", ev["t"], track="faults",
            n_died=ev.get("n_died"), drained=ev.get("drained"),
        ))
    return spans


def controller_spans(records: list[dict]) -> list[dict]:
    """Controller-plane spans from a flight-record stream.

    * ``epoch`` events become back-to-back placement-epoch spans on the
      ``controller`` track (args: WAN/sync bills, churn, budget use).
    * ``recovery`` events become a death-edge instant plus — when the
      event carries ``time_to_slo`` — a ``recovery→SLO`` span from the
      edge until the backlog re-enters the SLO band (``unrecovered`` to
      the horizon when it never does).
    * ``switch`` events become instants on the ``dispatch`` track.
    """
    meta = next((r for r in records if r.get("type") == "meta"), {})
    t_slots = int(meta.get("t_slots", 0)) or max(
        (int(r.get("t", 0)) + 1 for r in records), default=0
    )
    spans: list[dict] = []
    prev_edge = 0
    for r in records:
        if r.get("type") != "event":
            continue
        t = int(r["t"])
        code = r.get("code")
        if code == "epoch":
            spans.append(span(
                f"epoch {r.get('epoch', '?')}", "epoch", prev_edge, t + 1,
                track="controller", wan_gb=r.get("wan_gb"),
                wan_cost=r.get("wan_cost"), sync_cost=r.get("sync_cost"),
                churn=r.get("churn"), budget_use=r.get("budget_use"),
            ))
            prev_edge = t + 1
        elif code == "recovery":
            site = r.get("site", r.get("pod"))
            spans.append(span(
                f"death edge @{site}", "fault", t, track="faults",
                n_died=r.get("n_died", r.get("n_dead")),
                recovery_gb=r.get("recovery_gb", r.get("drained")),
            ))
            tts = r.get("time_to_slo")
            if tts is not None:
                spans.append(span(
                    "recovery→SLO", "recovery", t, t + max(int(tts), 1),
                    track="controller", slo_backlog=r.get("slo_backlog"),
                ))
            elif "time_to_slo" in r:
                spans.append(span(
                    "unrecovered", "recovery", t, t_slots,
                    track="controller", slo_backlog=r.get("slo_backlog"),
                ))
        elif code == "switch":
            spans.append(span(
                f"switch k{r.get('k')}→{r.get('dst')}", "switch", t,
                track="dispatch", src=r.get("src"), dst=r.get("dst"),
                stage=r.get("stage"),
            ))
        elif code == "slo_burn":
            spans.append(span(
                f"slo burn {r.get('class', '')}", "slo", t, track="slo",
                burn_short=r.get("burn_short"), burn_long=r.get("burn_long"),
                threshold=r.get("threshold"),
            ))
    return spans


def straggler_spans(health, site_names=None, link_health=None) -> list[dict]:
    """Degraded-health windows from a ``(T, N)`` health trace.

    One track per site. Each maximal window where a site's health factor
    sits below 1.0 becomes an interval span — cat ``dead`` when the
    factor bottoms out at zero inside the window, ``straggler``
    otherwise — carrying the window's min/mean factor, with a
    ``repaired`` instant at its close (when it closes before the
    horizon). Pass ``link_health`` (``(T, N, N)``) to additionally emit
    ``link down``/``link up`` instants on a ``links`` track for every
    severed-edge transition. Overlay on a faulted run's request timeline
    to see why the tail moved.
    """
    h = np.asarray(health, np.float64)
    t_slots, n = h.shape
    names = list(site_names or [f"site{i}" for i in range(n)])
    spans: list[dict] = []
    for i in range(n):
        t = 0
        while t < t_slots:
            if h[t, i] >= 1.0 - _EPS:
                t += 1
                continue
            t0 = t
            while t < t_slots and h[t, i] < 1.0 - _EPS:
                t += 1
            win = h[t0:t, i]
            lo = float(win.min())
            cat = "dead" if lo <= _EPS else "straggler"
            label = (f"{names[i]} dead" if cat == "dead"
                     else f"{names[i]} x{lo:.2f}")
            spans.append(span(
                label, cat, t0, t, track=names[i],
                factor_min=round(lo, 4),
                factor_mean=round(float(win.mean()), 4),
            ))
            if t < t_slots:
                spans.append(span("repaired", "repair", t, track=names[i]))
    if link_health is not None:
        lh = np.asarray(link_health, np.float64)
        down = lh <= _EPS
        for t in range(t_slots):
            prev = down[t - 1] if t else np.zeros_like(down[0])
            for src, dst in zip(*np.nonzero(down[t] != prev)):
                if src == dst:
                    continue
                edge = "down" if down[t, src, dst] else "up"
                spans.append(span(
                    f"link {names[src]}→{names[dst]} {edge}", "link", t,
                    track="links", src=int(src), dst=int(dst), edge=edge,
                ))
    return spans


def spans_from_records(records: list[dict]) -> list[dict]:
    """All spans recoverable from one saved record stream.

    Controller spans always; request-cohort spans additionally when the
    metric rows carry the per-class ``admitted_k`` / ``completed_k``
    columns (``fleet_records`` writes them) — so the report tool can
    emit a Chrome trace from a JSONL file alone, no engine rerun.
    """
    spans = controller_spans(records)
    metrics = [r for r in records if r.get("type") == "metric"]
    if metrics and "admitted_k" in metrics[0]:
        meta = next((r for r in records if r.get("type") == "meta"), {})
        out = {
            "admitted": np.asarray([m["admitted_k"] for m in metrics]),
            "completed": np.asarray([m["completed_k"] for m in metrics]),
            "history": [{"choice": m["choice"], "admitted": m["admitted_k"],
                         "completed": m["completed_k"]} for m in metrics],
            "class_names": meta.get("class_names"),
        }
        spans = request_spans(out) + spans
    return spans


def to_chrome_trace(spans: list[dict], slot_ms: float = 1.0,
                    process: str = "repro") -> dict:
    """Spans -> Chrome trace-event JSON (dict), 1 slot = ``slot_ms`` ms.

    Interval spans become complete (``ph="X"``) events, instants become
    thread-scoped instant (``ph="i"``) events; tracks map to tids with
    ``thread_name`` metadata so Perfetto labels the rows. Timestamps are
    microseconds per the trace-event spec; zero-length intervals are
    widened to one microsecond so they stay visible.
    """
    tids: dict[str, int] = {}
    events: list[dict] = [{
        "ph": "M", "pid": 0, "tid": 0, "name": "process_name",
        "args": {"name": process},
    }]
    for sp in spans:
        track = sp["track"]
        if track not in tids:
            tids[track] = len(tids) + 1
            events.append({
                "ph": "M", "pid": 0, "tid": tids[track],
                "name": "thread_name", "args": {"name": track},
            })
        ts = sp["t0"] * slot_ms * 1000.0
        base = {
            "name": sp["name"], "cat": sp["cat"], "pid": 0,
            "tid": tids[track], "ts": ts,
            "args": {k: v for k, v in sp["args"].items() if v is not None},
        }
        if sp["t1"] is None:
            events.append({**base, "ph": "i", "s": "t"})
        else:
            dur = max((sp["t1"] - sp["t0"]) * slot_ms * 1000.0, 1.0)
            events.append({**base, "ph": "X", "dur": dur})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(spans: list[dict], path, slot_ms: float = 1.0,
                       process: str = "repro"):
    """Write :func:`to_chrome_trace` JSON to ``path``; returns the path."""
    trace = to_chrome_trace(spans, slot_ms=slot_ms, process=process)
    with open(path, "w") as f:
        json.dump(trace, f)
    return path
