"""The port's telemetry host side (``collect``, ``export``, ``report``,
``spans``, ``bench_check``) against ``repro.telemetry``'s.

Both sides are numpy over the same values, so on the same inputs the record
streams, rendered timelines, cross-checks, spans and sentinel verdicts are
equal exactly. The port's ``collect_records`` additionally takes torch
tensors: it is fed the JAX engine's own outputs as tensors and must give
the records JAX's ``collect_records`` gives for them. ``BENCH_sim.json`` is
read, never written (its bytes are compared before and after).
"""

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.jobs import dag as jdag
from repro.jobs import engine as je
from repro.jobs import scheduler as jsch
from repro.placement import wan as jw
from repro.telemetry import bench_check as jbc
from repro.telemetry import collect as jcollect
from repro.telemetry import export as jexport
from repro.telemetry import slo as jslo
from repro.telemetry import spans as jspans
from repro.telemetry.config import TRACE as J_TRACE
from repro.telemetry.config import TelemetryConfig as JTelemetryConfig
from repro.telemetry.metrics import HistogramSpec as JHistogramSpec
from repro.core import gmsa as jg
from repro.core import simulator as js
from repro_torch import telemetry as tt
from repro_torch.configs import facebook_4dc_stages as tst
from repro_torch.jobs import engine as te
from repro_torch.jobs import scheduler as tsch
from repro_torch.telemetry import bench_check as tbc
from repro_torch.telemetry import collect as tcollect
from repro_torch.telemetry import export as texport
from repro_torch.telemetry import report as treport
from repro_torch.telemetry import spans as tspans
from repro_torch.telemetry.ring import EventRing

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
T_SLOTS = 48
SPEC = (0.001, 100.0, 24)


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_outs(jouts, cls):
    return cls(*(_t(x) for x in jouts))


def _port_frame(jframe):
    return tt.TelemetryFrame(EventRing(*(_t(x) for x in jframe.ring)),
                             {k: _t(v) for k, v in jframe.metrics.items()})


def _health():
    h = np.ones((T_SLOTS, 4), np.float32)
    h[6:18, 1] = 0.3
    h[20:24, 3] = 0.0
    return h


def _link_health():
    lh = np.ones((T_SLOTS, 4, 4), np.float32)
    lh[10:14, 2, 1] = 0.0
    lh[30:40, 0, 3] = 0.0
    return lh


@pytest.fixture(scope="module")
def staged():
    """One run of the staged paper scenario on both engines' inputs: the
    JAX engine's TRACE outputs (hedged, under a health trace, with the
    queue-delay histograms) and the port's own on the same traces."""
    cfg = dataclasses.replace(tst.StagedPaperConfig(), t_slots=T_SLOTS)
    tpl, tdag, twan, _ = tst.make_staged_builder(cfg, device=CPU)
    jins = js.SimInputs(*(jnp.asarray(x.numpy()) for x in tpl))
    jdag_ = jdag.StageDag(*(jnp.asarray(x.numpy()) for x in tdag))
    jwan = jw.WanModel(*(jnp.asarray(x.numpy()) for x in twan))
    jcfg = JTelemetryConfig(level=J_TRACE, hist=JHistogramSpec(*SPEC))
    tcfg = tt.TelemetryConfig(level=tt.TRACE, hist=tt.HistogramSpec(*SPEC))
    outs, frame = je.simulate_staged(jins, jdag_, jwan, jsch.make_staged_policy(jdag_, jwan,
                                                                                hedge=0.9),
                                     jax.random.key(0), cfg.v, telemetry=jcfg,
                                     health=jnp.asarray(_health()))
    t_outs, t_frame = te.simulate_staged(tpl, tdag, twan,
                                         tsch.make_staged_policy(tdag, twan, hedge=0.9), None,
                                         cfg.v, telemetry=tcfg, health=torch.from_numpy(_health()))
    return dict(outs=outs, frame=frame, jcfg=jcfg, tcfg=tcfg, summary=je.summarize_staged(outs),
                t_outs=t_outs, t_frame=t_frame)


def test_collect_records_equal_jax_on_the_same_staged_outputs(staged, tmp_path):
    s = staged
    assert float(np.asarray(s["outs"].hedged_jobs).sum()) > 0.0
    kw = dict(summary=s["summary"], meta={"arm": "aware"}, link_health=_link_health())
    want = jcollect.collect_records(s["outs"], s["frame"], cfg=s["jcfg"], **kw)
    got = tcollect.collect_records(_port_outs(s["outs"], te.StagedOutputs),
                                   _port_frame(s["frame"]), cfg=s["tcfg"], **kw)
    assert got == want
    codes = {r.get("code") for r in got if r["type"] == "event"}
    assert {"hedge", "link_down"} <= codes
    assert any(r["type"] == "hist" and r["name"] == "queue_delay" for r in got)
    paths = [texport.write_jsonl(got, tmp_path / "port.jsonl"),
             jexport.write_jsonl(want, tmp_path / "jax.jsonl")]
    assert paths[0].read_bytes() == paths[1].read_bytes()
    assert texport.read_jsonl(paths[0]) == jexport.read_jsonl(paths[1])
    assert texport.render_timeline(got) == jexport.render_timeline(want)
    assert texport.render_timeline(got, codes={"hedge"}, max_events=3) == \
        jexport.render_timeline(want, codes={"hedge"}, max_events=3)
    assert texport.cross_check(got) == jexport.cross_check(want)
    assert texport.cross_check(got)["ok"]


def test_collect_records_equal_jax_on_simulator_outputs():
    """The simulator's kind ("sim") with the site-cost histograms."""
    from repro.configs import facebook_4dc as jfb

    cfg = dataclasses.replace(jfb.PaperSimConfig(), t_slots=T_SLOTS)
    tpl, _ = jfb.make_sim_builder(cfg)
    jcfg = JTelemetryConfig(level=J_TRACE, hist=JHistogramSpec(*SPEC))
    outs, frame = js.simulate(tpl, jg.dispatch_fn(1.0), jax.random.key(0), 1.0, telemetry=jcfg)
    summary = js.summarize(outs)
    want = jcollect.collect_records(outs, frame, cfg=jcfg, summary=summary)
    tcfg = tt.TelemetryConfig(level=tt.TRACE, hist=tt.HistogramSpec(*SPEC))
    from repro_torch.core.simulator import SimOutputs

    got = tcollect.collect_records(_port_outs(outs, SimOutputs), _port_frame(frame), cfg=tcfg,
                                   summary=summary)
    assert got == want and got[0]["kind"] == "sim"
    assert texport.cross_check(got) == jexport.cross_check(want)


def test_port_staged_flight_record_round_trip_and_report_check(staged, tmp_path, capsys):
    """The port's own TRACE run: decoded, written, and ``report --check``
    exits 0 (in process and as ``python -m``); a stream whose summary
    disagrees exits 1; a batched call is refused until one run is picked."""
    outs, frame, tcfg = staged["t_outs"], staged["t_frame"], staged["tcfg"]
    records = tt.collect_records(outs, frame, cfg=tcfg, summary=te.summarize_staged(outs))
    assert records[0]["kind"] == "staged" and records[0]["events_dropped"] == 0
    path = tt.write_jsonl(records, tmp_path / "run.jsonl")
    assert treport.main([str(path), "--check", "--percentiles",
                         "--spans", str(tmp_path / "trace.json")]) == 0
    text = capsys.readouterr().out
    assert "cross-check [OK] kind=staged" in text and "queue_delay percentiles" in text
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"][0]["ph"] == "M"
    out = subprocess.run([sys.executable, "-m", "repro_torch.telemetry.report", str(path),
                          "--check"], capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert "cross-check [OK]" in out.stdout
    bad = [dict(r) for r in records]
    bad[-1]["time_avg_wan_cost"] *= 1.01
    tt.write_jsonl(bad, tmp_path / "bad.jsonl")
    assert treport.main([str(tmp_path / "bad.jsonl"), "--check"]) == 1
    batched = type(outs)(*(x[None].expand((2,) + tuple(x.shape)) for x in outs))
    with pytest.raises(ValueError, match="ONE run"):
        tt.collect_records(batched)


def _fleet_out(rng, t_slots=20, k=3, n=5):
    """A serving-engine run dict with the keys ``fleet_records`` /
    ``request_spans`` read (random, seeded)."""
    admitted = rng.poisson(4.0, (t_slots, k)).astype(np.float64)
    completed = np.minimum(admitted, rng.poisson(3.5, (t_slots, k))).astype(np.float64)
    choice = rng.integers(0, n, (t_slots, k))
    history = [{"admitted": admitted[t].tolist(), "rejected": [0.0] * k,
                "served": completed[t].tolist(), "energy_j": rng.uniform(0, 5, k).tolist(),
                "slo_viol": [0] * k, "completed": completed[t].tolist(),
                "choice": choice[t].tolist()} for t in range(t_slots)]
    dispatch = np.zeros((t_slots, n, k), np.float32)
    dispatch[np.arange(t_slots)[:, None], choice, np.arange(k)[None, :]] = 1.0
    return {
        "cost": rng.uniform(1, 2, t_slots), "backlog": rng.uniform(0, 9, t_slots),
        "history": history, "admitted": admitted, "completed": completed,
        "rejected": np.zeros((t_slots, k)), "served": completed,
        "events": [{"type": "event", "t": 7, "code": "recovery", "pod": 2, "n_died": 1,
                    "drained": 3.5}],
        "dispatch": dispatch, "wan_cost": rng.uniform(0, 1, t_slots),
        "wan_gb": rng.uniform(0, 50, t_slots), "mean_cost": 1.5, "final_backlog": 4.0,
        "total_billed_cost": 30.0, "exec_jobs": 0,
        "hedged_jobs": np.where(rng.uniform(size=t_slots) > 0.7, 1.0, 0.0),
        "hedge_cost": rng.uniform(0, 1, t_slots),
        "sojourn_hist": rng.integers(0, 9, (k, 12)).astype(np.float32),
        "sojourn_spec": {"lo": 0.5, "hi": 64.0, "n_buckets": 12},
        "class_names": ["chat", "batch", "rag"],
    }


def test_fleet_records_and_spans_equal_jax():
    out = _fleet_out(np.random.default_rng(3))
    for slo in (None, 2.0):
        jrec = jcollect.fleet_records(out, meta={"slo_backlog": 3.0},
                                      slo=None if slo is None else jslo.SloSpec(target=slo))
        trec = tcollect.fleet_records(out, meta={"slo_backlog": 3.0},
                                      slo=None if slo is None else tt.SloSpec(target=slo))
        assert trec == jrec
        assert tspans.spans_from_records(trec) == jspans.spans_from_records(jrec)
        assert tspans.controller_spans(trec) == jspans.controller_spans(jrec)
        assert texport.render_timeline(trec) == jexport.render_timeline(jrec)
    assert tspans.request_spans(out) == jspans.request_spans(out)
    assert tspans.fifo_cohorts(out["admitted"], out["completed"]) == \
        jspans.fifo_cohorts(out["admitted"], out["completed"])
    spans = tspans.request_spans(out)
    assert tspans.to_chrome_trace(spans, slot_ms=5.0) == jspans.to_chrome_trace(spans, slot_ms=5.0)


def test_derived_events_spans_and_sparkline_equal_jax(staged, tmp_path):
    rng = np.random.default_rng(5)
    health = np.clip(rng.uniform(0.0, 1.6, (30, 4)), 0.0, 1.0)
    lh = _link_health()
    names = ["a", "b", "c", "d"]
    assert tspans.straggler_spans(health, names, lh) == jspans.straggler_spans(health, names, lh)
    assert tcollect.link_down_events(torch.from_numpy(lh)) == jcollect.link_down_events(lh)
    hj, hc = staged["outs"].hedged_jobs, staged["outs"].hedge_cost
    assert tcollect.hedge_events(_t(hj), _t(hc)) == jcollect.hedge_events(hj, hc)
    f = staged["outs"].f_trace
    assert tcollect.switch_events(_t(f)) == jcollect.switch_events(f)
    assert tcollect.switch_events(_t(f)[..., 0]) == jcollect.switch_events(np.asarray(f)[..., 0])
    backlog = rng.uniform(0, 10, 40)
    for t_edge in (0, 5, 30):
        for cfg in (tt.TelemetryConfig(), tt.TelemetryConfig(slo_backlog=4.0)):
            jcfg = JTelemetryConfig(slo_backlog=cfg.slo_backlog)
            assert tcollect.time_to_slo(torch.from_numpy(backlog), t_edge, cfg) == \
                jcollect.time_to_slo(backlog, t_edge, jcfg)
    for v in (np.arange(7.0), np.ones(3), rng.uniform(size=200), np.array([])):
        for width in (10, 60):
            assert texport.sparkline(v, width) == jexport.sparkline(v, width)
    spans = tspans.straggler_spans(health)
    p = tspans.write_chrome_trace(spans, tmp_path / "t.json", slot_ms=2.0)
    assert json.loads(Path(p).read_text()) == jspans.to_chrome_trace(spans, slot_ms=2.0)


def test_bench_check_on_the_committed_bench_history_read_only(capsys):
    path = ROOT / "BENCH_sim.json"
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    got, want = tbc.check_file(path), jbc.check_file(path)
    assert got == want and got["results"]
    assert tbc.load_series(path) == jbc.load_series(path)
    for kw in ({}, {"z_max": 1.0, "min_rel": 0.05, "min_points": 2}):
        assert tbc.check_file(path, **kw) == jbc.check_file(path, **kw)
    assert tbc.main([str(path), "--quiet"]) == jbc.main([str(path), "--quiet"])
    assert tbc.main([str(path / "missing")]) == 2
    capsys.readouterr()
    assert hashlib.sha256(path.read_bytes()).hexdigest() == digest
    for values in ([100.0, 101.0, 99.0, 100.5, 180.0], [5.0, 5.0, 5.0, 5.0, 5.2], [1.0, 2.0]):
        assert tbc.check_series(values) == jbc.check_series(values)
    assert tbc.check_series([100.0, 101.0, 99.0, 100.5, 180.0])["status"] == "regression"


def test_bench_check_reads_the_port_record_format(tmp_path):
    """``write_record``'s entries share the format: a port bench history
    is checkable as it stands."""
    from repro_torch.benchmarks.common import write_record

    path = tmp_path / "records.json"
    for us in (10.0, 10.5, 9.8, 10.1, 30.0):
        write_record(path, "torch_jobs_bench", [{"name": "jobs_aware_4runs_per_run",
                                                 "us_per_call": us, "derived": {}}],
                     torch.device(CPU))
    res = tbc.check_file(path, label="torch_jobs_bench")
    assert res["regressions"] == ["torch_jobs_bench/jobs_aware_4runs_per_run"]
