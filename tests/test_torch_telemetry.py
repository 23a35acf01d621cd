"""The port's telemetry device side against ``repro.telemetry``.

Histogram edges, the numpy decoders (``hist_quantiles``,
``percentile_table``, ``weighted_percentile``, ``fifo_sojourn_replay``) and
the SLO functions are numpy on both sides: bitwise equal. Bucket indices
are fp32 ``log``s on both sides, and torch's ``log`` may differ from XLA's
by an ulp, so a value within ``EDGE_RTOL`` (1e-5 relative) of a bucket edge
may land one bucket over: those values (and, for per-series histograms,
the series holding one) are masked, and the rest must match exactly. The
sojourn clock's cumulative sums run in another order: 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import facebook_4dc as jfb
from repro.core import baselines as jb
from repro.core import gmsa as jg
from repro.core import simulator as js
from repro.telemetry import metrics as jm
from repro.telemetry import ring as jr
from repro.telemetry import slo as jslo
from repro.telemetry.config import SUMMARY as J_SUMMARY
from repro.telemetry.config import TelemetryConfig as JTelemetryConfig
from repro_torch import telemetry as tt
from repro_torch.configs import fleet_256 as tfl
from repro_torch.core import baselines as tb
from repro_torch.core import gmsa as tg
from repro_torch.core import simulator as ts
from test_torch_simulator import RTOL, _bridged_runs

CPU = "cpu"
EDGE_RTOL = 1e-5
SPECS = [jm.HistogramSpec(), jm.HistogramSpec(0.01, 3000.0, 40), jm.HistogramSpec(1.0, 2.0, 3)]


def _port_spec(spec):
    return tt.HistogramSpec(spec.lo, spec.hi, spec.n_buckets)


def _near_edge(values, spec):
    edges = spec.edges()[1:-1]
    v = np.asarray(values, np.float64)[..., None]
    return (np.abs(v - edges) <= EDGE_RTOL * edges).any(-1)


def _values(seed, shape):
    """Log-uniform over 1e-3..5e3 (under, interior and overflow buckets),
    with some exact zeros."""
    rng = np.random.default_rng(seed)
    v = np.exp(rng.uniform(np.log(1e-3), np.log(5e3), shape)).astype(np.float32)
    v.reshape(-1)[::17] = 0.0
    return v


@pytest.mark.parametrize("i", range(len(SPECS)))
def test_edges_and_bucket_index(i):
    spec = SPECS[i]
    port = _port_spec(spec)
    assert np.array_equal(port.edges(), spec.edges())
    assert port.ratio == spec.ratio
    v = np.concatenate([_values(i, 4000), spec.edges()[1:-1].astype(np.float32)])
    got = port.bucket_index(torch.from_numpy(v)).numpy()
    want = np.asarray(spec.bucket_index(v))
    assert got.dtype == np.int32
    keep = ~_near_edge(v, spec)
    assert keep.sum() > 3900
    np.testing.assert_array_equal(got[keep], want[keep])
    assert np.all(np.abs(got - want) <= 1)
    # +inf: the port clamps before its int cast and puts it in the overflow
    # bucket (XLA's CPU cast of inf to int32 is outside the comparison).
    assert int(port.bucket_index(torch.tensor([np.inf]))[0]) == spec.n_buckets - 1


@pytest.mark.parametrize("axis", [0, -1])
def test_hist_series_exact_off_edges(axis):
    spec = SPECS[0]
    v = _values(7, (300, 12)) if axis == 0 else _values(8, (4, 5, 300))
    got = tt.hist_series(_port_spec(spec), torch.from_numpy(v), axis=axis).numpy()
    want = np.asarray(jm.hist_series(spec, v, axis=axis))
    assert got.shape == want.shape
    clean = ~_near_edge(v, spec).any(axis=axis)          # series with no edge value
    assert clean.mean() > 0.5
    np.testing.assert_array_equal(got[clean], want[clean])
    np.testing.assert_array_equal(got.sum(-1), v.shape[axis])


def test_hist_add_and_init():
    """Weights are multiples of 0.25, exact in fp32 in any order."""
    spec = SPECS[1]
    rng = np.random.default_rng(3)
    v = _values(9, (50, 20))
    v = v[~_near_edge(v, spec)]
    w = (rng.integers(0, 8, v.shape) * 0.25).astype(np.float32)
    port = _port_spec(spec)
    c0 = tt.hist_init(port, device=CPU)
    assert tuple(c0.shape) == (spec.n_buckets,) and not bool(c0.any())
    assert tuple(tt.hist_init(port, 3, 2, device=CPU).shape) == (3, 2, spec.n_buckets)
    got = tt.hist_add(port, c0, torch.from_numpy(v), torch.from_numpy(w)).numpy()
    want = np.asarray(jm.hist_add(spec, jm.hist_init(spec), v, w))
    np.testing.assert_array_equal(got, want)
    got1 = tt.hist_add(port, c0, torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got1, np.asarray(jm.hist_add(spec, jm.hist_init(spec), v)))
    assert not bool(c0.any())                                 # not written in place


def _fluid(seed, t_slots=30, k=3):
    rng = np.random.default_rng(seed)
    admitted = rng.uniform(0, 5, (t_slots, k)).astype(np.float32)
    admitted[rng.uniform(size=admitted.shape) < 0.2] = 0.0
    q = np.zeros(k, np.float32)
    completed = np.zeros_like(admitted)
    for t in range(t_slots):
        q = q + admitted[t]
        completed[t] = np.minimum(q, rng.uniform(0, 5, k)).astype(np.float32)
        q = q - completed[t]
    return admitted, completed


def test_sojourn_clock_and_replay():
    spec = SPECS[0]
    admitted, completed = _fluid(4)
    t_slots, k = admitted.shape
    port = _port_spec(spec)
    age, hist = tt.sojourn_init(port, k, t_slots, device=CPU)
    j_age, j_hist = jm.sojourn_init(spec, k, t_slots)
    assert tuple(age.shape) == j_age.shape and tuple(hist.shape) == j_hist.shape
    for t in range(t_slots):
        age, hist = tt.sojourn_step(port, age, hist, torch.from_numpy(admitted[t]),
                                    torch.from_numpy(completed[t]))
        j_age, j_hist = jm.sojourn_step(spec, j_age, j_hist, admitted[t], completed[t])
    np.testing.assert_allclose(age.numpy(), np.asarray(j_age), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(hist.numpy(), np.asarray(j_hist), rtol=1e-5, atol=1e-5)
    # The carried histogram holds the replay's mass, bucket by bucket.
    soj, wgt = tt.fifo_sojourn_replay(admitted, completed)
    j_soj, j_wgt = jm.fifo_sojourn_replay(admitted, completed)
    assert np.array_equal(soj, j_soj) and np.array_equal(wgt, j_wgt)
    idx = port.bucket_index(torch.from_numpy(soj.astype(np.float32))).numpy()
    replay = np.stack([np.bincount(idx[ki], wgt[ki], spec.n_buckets) for ki in range(k)])
    np.testing.assert_allclose(hist.numpy(), replay, rtol=1e-4, atol=1e-4)
    qs = (50.0, 90.0, 99.0)
    assert np.array_equal(tt.weighted_percentile(soj, wgt, qs),
                          jm.weighted_percentile(soj, wgt, qs))
    assert np.isnan(tt.weighted_percentile([], [], qs)).all()


def test_ring_push_order_masking_and_wraparound():
    cap = 4
    ring, j_ring = tt.ring_init(cap, device=CPU), jr.ring_init(cap)
    events = [(True, 3, jr.EV_SWITCH, [1.0, 2.0, 3.0]), (False, 4, jr.EV_EPOCH, [9.0]),
              (True, 5, jr.EV_EPOCH, [0.5] * 6), (True, 8, jr.EV_RECOVERY, []),
              (False, 9, jr.EV_HEDGE, [7.0]), (True, 11, jr.EV_REPAIR, [1.0, 2.0]),
              (True, 12, jr.EV_LINK_DOWN, [3.0, 4.0, 1.0]), (True, 15, jr.EV_HEDGE, [2.0])]
    for step, (do, t, code, fields) in enumerate(events):
        before = ring
        ring = tt.ring_push(ring, torch.tensor(do), torch.tensor(t), code,
                            [torch.tensor(f) for f in fields])
        j_ring = jr.ring_push(j_ring, jnp.asarray(do), jnp.asarray(t), code,
                              [jnp.float32(f) for f in fields])
        if not do:
            for a, b in zip(ring, before):
                assert torch.equal(a, b)
        for a, b in zip(ring, j_ring):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=str(step))
    got, dropped = tt.ring_events(ring)
    want, j_dropped = jr.ring_events(j_ring)
    assert dropped == j_dropped == 2
    assert [(e["t"], e["code"]) for e in got] == [(e["t"], e["code"]) for e in want]
    assert [e["t"] for e in got] == [8, 11, 12, 15]
    for e, f in zip(got, want):
        np.testing.assert_array_equal(e["val"], f["val"])
    assert tt.ring_events(tt.ring_init(3, device=CPU)) == ([], 0)
    with pytest.raises(ValueError, match="payload"):
        tt.ring_push(ring, True, 0, 1, [0.0] * 7)
    frame = tt.empty_frame(device=CPU)
    assert frame.metrics == {} and tuple(frame.ring.t.shape) == (1,)


def test_numpy_decoders_and_slo_are_bitwise_equal():
    spec = SPECS[0]
    port = _port_spec(spec)
    rng = np.random.default_rng(5)
    counts = rng.integers(0, 6, (4, 3, spec.n_buckets)).astype(np.float64)
    counts[0, 0] = 0.0                                    # empty histogram: nan
    counts[1, 1, :-1] = 0.0                               # overflow only: inf error
    qs = (50.0, 95.0, 99.0)
    for got, want in zip(tt.hist_quantiles(counts, port, qs), jm.hist_quantiles(counts, spec, qs)):
        np.testing.assert_array_equal(got, want)
    got, _ = tt.hist_quantiles(torch.from_numpy(counts), port, qs)    # tensors decode too
    np.testing.assert_array_equal(got, jm.hist_quantiles(counts, spec, qs)[0])
    names = [f"c{i}" for i in range(3)]
    for rows in (counts[2], counts[3, 0]):
        assert (tt.percentile_table(rows, port, qs, names if rows.ndim == 2 else None)
                == jm.percentile_table(rows, spec, qs, names if rows.ndim == 2 else None))
    admitted, completed = _fluid(6, t_slots=40)
    slo_t = tt.SloSpec(target=2.0, percentile=90.0, windows=((2, 8, 1.5), (4, 16, 2.0)))
    slo_j = jslo.SloSpec(target=2.0, percentile=90.0, windows=((2, 8, 1.5), (4, 16, 2.0)))
    assert slo_t.budget == slo_j.budget
    assert np.array_equal(tt.slo.bad_fraction(admitted, completed, 2.0),
                          jslo.bad_fraction(admitted, completed, 2.0))
    assert tt.burn_events(admitted, completed, slo_t) == jslo.burn_events(admitted, completed, slo_j)
    assert (tt.evaluate_slo(counts[2], port, slo_t, names)
            == jslo.evaluate_slo(counts[2], spec, slo_j, names))
    for bad in ({"percentile": 100.0}, {"target": -1.0}, {"windows": ((4, 2, 1.0),)}):
        with pytest.raises(ValueError):
            tt.SloSpec(**{"target": 1.0, **bad})


def test_config_levels():
    cfg = tt.TelemetryConfig(level=tt.SUMMARY, hist=tt.HistogramSpec())
    assert tt.enabled(cfg) and tt.histograms(cfg) and not tt.tracing(cfg)
    assert tt.tracing(tt.TelemetryConfig(level=tt.TRACE))
    for off in (None, tt.TelemetryConfig(), tt.TelemetryConfig(hist=tt.HistogramSpec())):
        assert not (tt.enabled(off) or tt.histograms(off) or tt.tracing(off))
    assert [int(x) for x in tt.Level] == [0, 1, 2]
    with pytest.raises(ValueError):
        tt.HistogramSpec(2.0, 1.0)


@pytest.fixture(scope="module")
def paper():
    cfg = dataclasses.replace(jfb.PaperSimConfig(), t_slots=48)
    _, build = jfb.make_sim_builder(cfg)
    key = jax.random.key(2)
    return build, key, _bridged_runs(build, key, 6)


@pytest.mark.parametrize("arm", ["data", "gmsa_v10"])
def test_simulate_summary_metrics_match_jax(paper, arm):
    """q_site to RTOL; the site-cost histograms exactly for every (run,
    site) series without a near-edge value (the bills are fp32 einsums on
    both sides, summed in another order)."""
    build, key, ins = paper
    spec = jm.HistogramSpec(lo=1.0, hi=2000.0, n_buckets=30)
    j_pol, t_pol, v = {"data": (jb.data_dispatch, tb.data_dispatch, 0.0),
                       "gmsa_v10": (jg.dispatch_fn(10.0), tg.dispatch_fn(10.0), 10.0)}[arm]
    o_j, f_j = js.simulate_many(build, j_pol, key, 6, v,
                                telemetry=JTelemetryConfig(level=J_SUMMARY, hist=spec))
    tel = tt.TelemetryConfig(level=tt.SUMMARY, hist=_port_spec(spec))
    o_t, f_t = ts.simulate(ins, t_pol, None, v, telemetry=tel)
    np.testing.assert_array_equal(o_t.f_trace.numpy(), np.asarray(o_j.f_trace))
    q_site = f_t.metrics["q_site"].numpy()
    assert q_site.shape == np.asarray(f_j.metrics["q_site"]).shape == (6, 48, 4)
    np.testing.assert_allclose(q_site, np.asarray(f_j.metrics["q_site"]), rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(q_site.sum(-1), o_t.backlog_total.numpy(), rtol=1e-6)
    hist = f_t.metrics["site_cost_hist"].numpy()
    j_hist = np.asarray(f_j.metrics["site_cost_hist"])
    assert hist.shape == j_hist.shape == (6, 4, spec.n_buckets)
    e_cost = np.einsum("kij,tj->tki", ins.r.numpy().astype(np.float64),
                       (ins.omega * ins.pue).numpy().astype(np.float64)) * ins.p_it.numpy()[None, :, None]
    bill = np.einsum("rtnk,rtk,tkn->rtn", o_t.f_trace.numpy(), ins.arrivals.numpy(), e_cost)
    clean = ~_near_edge(bill, spec).any(axis=1)                     # (R, N)
    assert clean.mean() > 0.5
    np.testing.assert_array_equal(hist[clean], j_hist[clean])
    np.testing.assert_array_equal(hist.sum(-1), 48)
    for a, b in zip(f_t.ring, f_j.ring):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_telemetry_off_is_bitwise_and_summary_leaves_outputs():
    cfg = dataclasses.replace(tfl.FleetConfig(), n_sites=16, k_types=2, t_slots=12)
    _, build = tfl.make_fleet_builder(cfg, device=CPU)
    run = lambda policy, tel: ts.simulate_many(
        build, policy, torch.Generator().manual_seed(1), 3, 1.5, device=CPU, telemetry=tel)
    for policy in (tg.make_kernel_policy(None), tb.random_dispatch):
        base = run(policy, None)
        assert isinstance(base, ts.SimOutputs)
        for off in (tt.TelemetryConfig(), tt.TelemetryConfig(hist=tt.HistogramSpec())):
            other = run(policy, off)
            assert isinstance(other, ts.SimOutputs)
            for a, b in zip(base, other):
                assert torch.equal(a, b)
        outs, frame = run(policy, tt.TelemetryConfig(level=tt.TRACE, hist=tt.HistogramSpec()))
        for a, b in zip(base, outs):
            assert torch.equal(a, b)
        assert tuple(frame.metrics["q_site"].shape) == (3, 12, 16)
        assert tuple(frame.metrics["site_cost_hist"].shape) == (3, 16, 26)
        assert tuple(frame.ring.t.shape) == (3, 1) and tuple(frame.ring.count.shape) == (3,)
        torch.testing.assert_close(frame.metrics["q_site"].sum(-1), base.backlog_total,
                                   rtol=1e-6, atol=1e-6)
