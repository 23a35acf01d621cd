"""The placement controller under site loss, degraded sites and links, and
its flight recorder, on the port (``repro_torch.placement.controller``
parts B and C) against ``repro.placement.controller``.

Parity runs as in ``tests/test_torch_controller.py``: the port's paper
builder draws R = 3 runs over 96 slots (W = 24), JAX runs each run on the
same traces; the alive mask, health and link-health traces and regions are
the same arrays on both sides.

Tolerances:
* one-hot decisions: exact on these seeds; DATA (the layout): 1e-5;
* layouts, ratios, bills, sums, recovery bills and ring payloads:
  RTOL = 1e-5 relative, ATOL = 1e-4 — fp32 reductions in another order;
  a bill across a severed link is +inf on both sides (compared as equal);
* ring events: codes and slots exactly, in order;
* within the port, bitwise: an all-ones alive mask against none, all-ones
  health and link health against none, regions with every site alive
  against no regions, telemetry OFF/None against no telemetry;
* the carried-r kernel policy against the table policy (``gmsa_policy`` on
  the controller's energy rows) in lockstep: 0 decisions differ off a
  near-tie of the table scores (1e-5 relative + 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jb
from repro.core import gmsa as jg
from repro.core import simulator as jsim
from repro.placement import controller as jc
from repro.placement import replica as jr
from repro.telemetry.config import SUMMARY as J_SUMMARY
from repro.telemetry.config import TRACE as J_TRACE
from repro.telemetry.config import TelemetryConfig as JTelemetryConfig
from repro.telemetry.metrics import HistogramSpec as JHistogramSpec
from repro.telemetry.ring import ring_events as j_ring_events
from repro_torch.configs.facebook_4dc import PaperSimConfig, make_sim_builder, site_bandwidths
from repro_torch.core import baselines as tb
from repro_torch.core import gmsa as tg
from repro_torch.placement import (
    PlacementConfig,
    make_adaptive_rule,
    simulate_placed,
    summarize_placed,
)
from repro_torch.placement.controller import region_averse_weights, survivor_renorm
from repro_torch.telemetry import (
    OFF,
    SUMMARY,
    TRACE,
    HistogramSpec,
    TelemetryConfig,
    collect_records,
    write_jsonl,
)
from repro_torch.telemetry import report as treport
from repro_torch.telemetry.ring import EventRing, ring_events
from repro_torch.traces.drift import ingest_drift_trace
from repro_torch.traces.faults import scheduled_failure_trace

torch.set_float32_matmul_precision("highest")

CPU = "cpu"
R = 3
T, W = 96, 24
RTOL, ATOL = 1e-5, 1e-4
PAPER = PaperSimConfig(t_slots=T)
SUMS = ("cost", "energy", "backlog_total", "backlog_avg", "q_final", "placements", "r_trace",
        "wan_cost", "wan_energy", "wan_gb", "wan_latency_s", "sync_cost", "recovery_cost",
        "recovery_gb", "mu_scale")
#: ForestCity dies at slot 30 and comes back at 60; Luleå dies at 50 for good.
EVENTS = [(1, 30, 60), (2, 50, None)]

J_GMSA = jg.dispatch_fn(PAPER.v)
J_KERNEL = jg.make_kernel_policy(None, interpret=True)
T_GMSA = tg.dispatch_fn(PAPER.v)


def _pcfg(cls, **kw):
    return cls(epoch_slots=W, growth=0.25, manager_share=PAPER.manager_share,
               map_share=PAPER.map_share, **kw)


def _health():
    h = np.ones((T, 4), np.float32)
    h[10:40, 0] = 0.4
    h[70:, 3] = 0.6
    return h


def _link_health():
    """Link 0->2 at half capacity throughout; 3<->0 severed for slots 20-69
    (every boundary move in that window that crosses it bills +inf)."""
    lh = np.ones((T, 4, 4), np.float32)
    lh[:, 0, 2] = 0.5
    lh[20:70, 3, 0] = lh[20:70, 0, 3] = 0.0
    return lh


@pytest.fixture(scope="module")
def paper():
    template, build = make_sim_builder(PAPER, device=CPU)
    up, down = site_bandwidths(PAPER, device=CPU)
    jup, jdown = jnp.asarray(up.numpy()), jnp.asarray(down.numpy())
    return dict(
        template=template, ins=build(torch.Generator().manual_seed(3), R), up=up, down=down,
        jup=jup, jdown=jdown,
        ingest=ingest_drift_trace(torch.Generator().manual_seed(7), T // W, 1, 4,
                                  bias=torch.tensor([0.05, 0.8, 0.05, 0.10]),
                                  bias_strength=0.5, device=CPU),
        alive=scheduled_failure_trace(T, 4, EVENTS, device=CPU),
        t_rule=make_adaptive_rule(up), j_rule=jr.make_adaptive_rule(jup),
    )


def _jax_placed(paper, policy, rule, cfg, **kw):
    ins = paper["ins"]
    kw = {k: (v if k == "telemetry" else jnp.asarray(np.asarray(v)))
          for k, v in kw.items() if v is not None}
    outs = []
    for i in range(R):
        one = jsim.SimInputs(*(jnp.asarray((x[i] if name in ("arrivals", "mu") else x).numpy())
                               for name, x in zip(ins._fields, ins)))
        outs.append(jc.simulate_placed(one, paper["jup"], paper["jdown"], policy, rule,
                                       jax.random.key(0), cfg, **kw))
    return outs


def _stack(outs):
    return jax.tree_util.tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *outs)


def _port(paper, policy, rule, cfg, **kw):
    kw = {k: (v if k == "telemetry" or isinstance(v, torch.Tensor) else torch.as_tensor(v))
          for k, v in kw.items() if v is not None}
    return simulate_placed(paper["ins"], paper["up"], paper["down"], policy, rule, None, cfg,
                           scalar=PAPER.v, **kw)


def _compare(got, want, decisions="exact"):
    if decisions == "exact":
        np.testing.assert_array_equal(got.f_trace.numpy(), np.asarray(want.f_trace))
    else:
        np.testing.assert_allclose(got.f_trace.numpy(), np.asarray(want.f_trace), rtol=RTOL,
                                   atol=1e-6)
    for name in SUMS:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


ARMS = {
    # name: (port policy, JAX policy, adaptive?, config kwargs, extra inputs, decisions)
    "gmsa_static": (T_GMSA, J_GMSA, False, {}, {}, "exact"),
    "gmsa_adaptive_ingest": (T_GMSA, J_GMSA, True, {}, {"ingest": True}, "exact"),
    "data_adaptive": (tb.data_dispatch, jb.data_dispatch, True, {}, {"ingest": True},
                      "fractional"),
    "kernel_adaptive": (tg.make_kernel_policy(None), J_KERNEL, True, {}, {"ingest": True},
                        "exact"),
    "io_coupling": (T_GMSA, J_GMSA, True, {"io_coupling": True}, {}, "exact"),
    "degraded_regions": (T_GMSA, J_GMSA, True, {"capacity_gb": (220.0,) * 4},
                         {"ingest": True, "health": True, "link_health": True, "regions": True},
                         "exact"),
}


def _extras(paper, names):
    kw = {"alive": paper["alive"].numpy()}
    if names.get("ingest"):
        kw["ingest"] = paper["ingest"].numpy()
    if names.get("health"):
        kw["health"] = _health()
    if names.get("link_health"):
        kw["link_health"] = _link_health()
    if names.get("regions"):
        kw["regions"] = np.array([0, 0, 1, 1], np.int32)
    return kw


@pytest.mark.parametrize("arm", list(ARMS))
def test_placed_fault_path_matches_jax(paper, arm):
    t_pol, j_pol, adaptive, ckw, names, decisions = ARMS[arm]
    kw = _extras(paper, names)
    t_rule = paper["t_rule"] if adaptive else tb.static_placement_rule
    j_rule = paper["j_rule"] if adaptive else jb.static_placement_rule
    got = _port(paper, t_pol, t_rule, _pcfg(PlacementConfig, **ckw), **kw)
    want = _stack(_jax_placed(paper, j_pol, j_rule, _pcfg(jc.PlacementConfig, **ckw),
                              scalar=PAPER.v, **kw))
    _compare(got, want, decisions)
    rec = got.recovery_gb.numpy()
    assert (rec[:, [30, 50]] > 0).all() and (np.delete(rec, [30, 50], axis=1) == 0).all()
    f = got.f_trace.numpy()
    alive = paper["alive"].numpy()
    assert (f[:, alive == 0.0] == 0.0).all()                         # dead sites get nothing
    if names.get("link_health"):                                     # a severed crossing
        assert np.isinf(got.recovery_cost.numpy()).any() or np.isinf(got.wan_cost.numpy()).any()


def test_all_ones_alive_health_and_links_are_bitwise_no_faults(paper):
    """Port against port: every masking op is an exact identity on an
    all-alive fleet, on both rules and every policy path."""
    ones = torch.ones(T, 4)
    for policy in (T_GMSA, tb.data_dispatch, tb.random_dispatch, tg.make_kernel_policy(None)):
        for rule in (paper["t_rule"], tb.static_placement_rule):
            run = lambda **kw: simulate_placed(paper["ins"], paper["up"], paper["down"], policy,
                                               rule, torch.Generator().manual_seed(4),
                                               _pcfg(PlacementConfig), scalar=PAPER.v,
                                               ingest=paper["ingest"], **kw)
            base = run()
            for kw in ({"alive": ones}, {"health": ones},
                       {"link_health": torch.ones(T, 4, 4)},
                       {"alive": ones, "health": ones, "link_health": torch.ones(T, 4, 4)}):
                for name, a, b in zip(base._fields, base, run(**kw)):
                    assert torch.equal(a, b), (policy, rule, tuple(kw), name)
    run = lambda **kw: simulate_placed(paper["ins"], paper["up"], paper["down"], T_GMSA,
                                       paper["t_rule"], None, _pcfg(PlacementConfig),
                                       scalar=PAPER.v, alive=ones, **kw)
    for a, b in zip(run(), run(regions=torch.tensor([0, 0, 1, 1]))):
        assert torch.equal(a, b)


def test_region_averse_weights_and_survivor_renorm_match_jax():
    alive = np.array([1, 0, 1, 1, 1, 0], np.float32)
    regions = np.array([0, 0, 1, 1, 2, 2], np.int32)
    got = region_averse_weights(torch.from_numpy(alive), torch.from_numpy(regions))
    want = jc.region_averse_weights(jnp.asarray(alive), jnp.asarray(regions))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert torch.equal(region_averse_weights(torch.ones(6), torch.from_numpy(regions)),
                       torch.ones(6))
    masked = np.array([[0.0, 0.0, 0.0], [0.2, 0.0, 0.6]], np.float32)
    fb = np.full((2, 3), 1 / 3, np.float32)
    np.testing.assert_allclose(
        survivor_renorm(torch.from_numpy(masked), torch.from_numpy(fb)).numpy(),
        np.asarray(jc.survivor_renorm(jnp.asarray(masked), jnp.asarray(fb))), rtol=1e-6)


def _table_lockstep(tally):
    """The carried-r kernel policy's decision, stepped with, against the
    table policy's on the same state every slot."""
    kernel = tg.make_kernel_policy(None)

    def policy(generator, q, arrivals, mu, e, aux, scalar):
        f = kernel(generator, q, arrivals, mu, e, aux, scalar)
        s = tg.drift_plus_penalty_scores(q, arrivals, mu, e, scalar)
        b = f.argmax(dim=-2)
        picked = torch.gather(s, -1, b.unsqueeze(-1)).squeeze(-1)
        low = s.min(dim=-1).values
        near = (picked - low).abs() <= 1e-4 + 1e-5 * low.abs()
        tally["off_tie"] += int(((b != s.argmin(-1)) & ~near).sum())
        tally["decisions"] += b.numel()
        return f

    policy.consumes_key = False
    policy.wants_wpue = True
    policy.wants_r = True
    return policy


@pytest.mark.parametrize("faulty", [False, True])
def test_carried_r_kernel_policy_equals_the_table_policy(paper, faulty):
    """Under per-run carried r (and recovery re-placements), the kernel
    policy decides as ``gmsa_policy`` on the controller's energy rows: in
    lockstep no decision differs off a near-tie, and run freely their
    dispatch traces agree."""
    tally = {"off_tie": 0, "decisions": 0}
    kw = {"alive": paper["alive"]} if faulty else {}
    run = lambda pol: _port(paper, pol, paper["t_rule"], _pcfg(PlacementConfig),
                            ingest=paper["ingest"], **kw)
    k = run(_table_lockstep(tally))
    assert tally["off_tie"] == 0 and tally["decisions"] == R * T
    table = run(tg.gmsa_policy)
    assert float((k.f_trace == table.f_trace).all(-2).float().mean()) >= 0.999


# ---------------------------------------------------------------------------
# Telemetry: SUMMARY streams and the TRACE ring
# ---------------------------------------------------------------------------

def test_summary_and_trace_telemetry_match_jax_and_off_is_bitwise(paper):
    kw = _extras(paper, {"ingest": True})
    spec = dict(lo=0.5, hi=4096.0, n_buckets=20)
    tcfg = TelemetryConfig(level=TRACE, capacity=64, hist=HistogramSpec(**spec))
    jcfg = JTelemetryConfig(level=J_TRACE, capacity=64, hist=JHistogramSpec(**spec))
    got, frame = _port(paper, T_GMSA, paper["t_rule"], _pcfg(PlacementConfig), telemetry=tcfg,
                       **kw)
    jouts = _jax_placed(paper, J_GMSA, paper["j_rule"], _pcfg(jc.PlacementConfig),
                        scalar=PAPER.v, telemetry=jcfg, **kw)
    _compare(got, _stack([o for o, _ in jouts]))
    for name in ("q_site", "site_cost_hist"):
        np.testing.assert_allclose(frame.metrics[name].numpy(),
                                   _stack([f.metrics[name] for _, f in jouts]),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    for i, (_, jframe) in enumerate(jouts):
        mine, dropped = ring_events(EventRing(*(x[i] for x in frame.ring)))
        theirs, jdropped = j_ring_events(jframe.ring)
        assert dropped == jdropped == 0
        assert [(e["t"], e["code"]) for e in mine] == [(e["t"], e["code"]) for e in theirs]
        for a, b in zip(mine, theirs):
            np.testing.assert_allclose(a["val"], b["val"], rtol=RTOL, atol=ATOL)
    codes = [e["code"] for e in ring_events(EventRing(*(x[0] for x in frame.ring)))[0]]
    assert codes.count(2) == T // W and codes.count(1) == 2 and codes.count(5) == 1
    base = _port(paper, T_GMSA, paper["t_rule"], _pcfg(PlacementConfig), **kw)
    for other in (got, _port(paper, T_GMSA, paper["t_rule"], _pcfg(PlacementConfig),
                             telemetry=TelemetryConfig(level=OFF), **kw)):
        for a, b in zip(base, other):
            assert torch.equal(a, b)
    summ, sframe = _port(paper, T_GMSA, paper["t_rule"], _pcfg(PlacementConfig),
                         telemetry=TelemetryConfig(level=SUMMARY), **kw)
    assert int(sframe.ring.count.sum()) == 0 and sframe.ring.t.shape == (R, 1)
    torch.testing.assert_close(sframe.metrics["q_site"].sum(-1), summ.backlog_total,
                               rtol=1e-6, atol=1e-4)
    jsumm = _jax_placed(paper, J_GMSA, paper["j_rule"], _pcfg(jc.PlacementConfig),
                        scalar=PAPER.v, telemetry=JTelemetryConfig(level=J_SUMMARY), **kw)
    np.testing.assert_allclose(sframe.metrics["q_site"].numpy(),
                               _stack([f.metrics["q_site"] for _, f in jsumm]), rtol=RTOL,
                               atol=ATOL)


def test_trace_flight_record_passes_the_report_check(paper, tmp_path, capsys):
    """One run's TRACE record through collect_records -> write_jsonl ->
    ``python -m repro_torch.telemetry.report --check`` (in process): exit 0,
    every bill's stream sum equal to its summary, a recovery paired with
    its repair edge."""
    tcfg = TelemetryConfig(level=TRACE, hist=HistogramSpec())
    one = paper["template"]
    outs, frame = simulate_placed(one, paper["up"], paper["down"], T_GMSA, paper["t_rule"], None,
                                  _pcfg(PlacementConfig), scalar=PAPER.v,
                                  ingest=paper["ingest"], alive=paper["alive"], telemetry=tcfg)
    records = collect_records(outs, frame, cfg=tcfg, summary=summarize_placed(outs),
                              meta={"scenario": "paper placed"})
    assert records[0]["kind"] == "placed"
    rec = [r for r in records if r.get("code") == "recovery"]
    assert [r["t"] for r in rec] == [30, 50] and rec[0].get("repair_t") == 60
    path = tmp_path / "placed.jsonl"
    write_jsonl(records, path)
    assert treport.main([str(path), "--check"]) == 0
    assert "cross-check [OK]" in capsys.readouterr().out
