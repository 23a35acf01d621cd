"""Fault traces, link faults and the elastic shrink on the port
(``repro_torch.traces.faults``, the link-fault traces of
``repro_torch.traces.bandwidth``, ``repro_torch.checkpoint.fault``) against
``repro.traces.faults``, ``repro.traces.bandwidth`` and
``repro.checkpoint.fault``.

Deterministic functions (scheduled traces, edges, regions, composition,
projection, ``drop_site``/``drop_site_mask``) match exactly, validation
errors with the same messages. Seeded Markov traces draw from torch
generators, not threefry, so they match by distribution: over long
horizons the stationary shares (alive, straggling, faulted links) agree
within the stated sampling tolerance, and exactly in shapes, value sets and
bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import fault as jfault
from repro.traces import bandwidth as jbw
from repro.traces import faults as jf
from repro_torch.checkpoint import drop_site, drop_site_mask
from repro_torch.traces import bandwidth as tbw
from repro_torch.traces import faults as tf

CPU = "cpu"


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# Deterministic traces: exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("events", [
    [(1, 3, 7)], [(0, 0, None), (2, 5, 9)], [(3, 9, 40)], [],
])
def test_scheduled_failure_trace_matches_jax(events):
    got = tf.scheduled_failure_trace(12, 4, events, device=CPU)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jf.scheduled_failure_trace(12, 4, events)))
    for fn in (tf.failure_edges, tf.repair_edges):
        want = getattr(jf, fn.__name__)(jnp.asarray(got.numpy()))
        np.testing.assert_array_equal(fn(got).numpy(), np.asarray(want))


@pytest.mark.parametrize("bad,msg", [
    ([(4, 1, 2)], "out of range"), ([(0, -1, 3)], "must be >= 0"),
    ([(0, 5, 5)], "must be > down_at"), ([(0, 5, 2)], "must be > down_at"),
])
def test_scheduled_failure_trace_rejects_what_jax_rejects(bad, msg):
    with pytest.raises(ValueError, match=msg):
        jf.scheduled_failure_trace(10, 4, bad)
    with pytest.raises(ValueError, match=msg):
        tf.scheduled_failure_trace(10, 4, bad, device=CPU)


def test_edges_of_a_random_mask_match_jax():
    rng = np.random.default_rng(0)
    alive = (rng.random((50, 6)) > 0.3).astype(np.float32)
    alive[0, 2] = 0.0                                   # a trace that opens dead
    for fn in (tf.failure_edges, tf.repair_edges):
        want = np.asarray(getattr(jf, fn.__name__)(jnp.asarray(alive)))
        np.testing.assert_array_equal(fn(torch.from_numpy(alive)).numpy(), want)
    assert tf.failure_edges(torch.from_numpy(alive))[0, 2] == 1.0
    assert float(tf.repair_edges(torch.from_numpy(alive))[0].sum()) == 0.0


@pytest.mark.parametrize("events", [
    [(1, 2, 6, 0.3), (1, 4, None, 0.5), (3, 0, 3, 0.0)], [],
])
def test_scheduled_health_trace_compose_and_projection_match_jax(events):
    got = tf.scheduled_health_trace(10, 4, events, device=CPU)
    want = jf.scheduled_health_trace(10, 4, events)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    other = np.random.default_rng(1).uniform(0.0, 1.0, (10, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        tf.compose_health(got, torch.from_numpy(other)).numpy(),
        np.asarray(jf.compose_health(want, jnp.asarray(other))))
    np.testing.assert_array_equal(tf.health_to_alive(got).numpy(),
                                  np.asarray(jf.health_to_alive(want)))
    with pytest.raises(ValueError, match="at least one"):
        tf.compose_health()


@pytest.mark.parametrize("bad,msg", [
    ([(5, 1, 2, 0.5)], "out of range"), ([(0, -1, 3, 0.5)], "must be >= 0"),
    ([(0, 4, 4, 0.5)], "must be > start"), ([(0, 1, 3, 1.5)], "must be in"),
])
def test_scheduled_health_trace_rejects_what_jax_rejects(bad, msg):
    with pytest.raises(ValueError, match=msg):
        jf.scheduled_health_trace(10, 4, bad)
    with pytest.raises(ValueError, match=msg):
        tf.scheduled_health_trace(10, 4, bad, device=CPU)


@pytest.mark.parametrize("n,r", [(8, 3), (256, 8), (5, 5), (7, 1)])
def test_region_assignment_matches_jax(n, r):
    got = tf.region_assignment(n, r, device=CPU)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jf.region_assignment(n, r)))


def test_region_and_severity_validation_match_jax():
    for call in (lambda m: m.region_assignment(4, 5), lambda m: m.region_assignment(4, 0)):
        with pytest.raises(ValueError, match="out of range"):
            call(jf)
        with pytest.raises(ValueError, match="out of range"):
            call(tf)
    with pytest.raises(ValueError, match="severity"):
        jf.health_trace(jax.random.key(0), 4, 2, severity=(0.8, 0.2))
    with pytest.raises(ValueError, match="severity"):
        tf.health_trace(_gen(0), 4, 2, severity=(0.8, 0.2), device=CPU)
    with pytest.raises(ValueError, match="min_alive"):
        tf.site_failure_trace(_gen(0), 4, 2, min_alive=3, device=CPU)
    regions = tf.region_assignment(6, 2, device=CPU)
    with pytest.raises(ValueError, match="min_regions_up"):
        tf.regional_health_trace(_gen(0), 4, regions, min_regions_up=3)


@pytest.mark.parametrize("events,symmetric", [
    ([(0, 2, 1, 5, 0.5), (2, 0, 3, None, 0.0)], True),
    ([(1, 3, 0, 4, 0.25)], False),
])
def test_scheduled_link_fault_trace_matches_jax(events, symmetric):
    got = tbw.scheduled_link_fault_trace(8, 4, events, symmetric=symmetric, device=CPU)
    want = jbw.scheduled_link_fault_trace(8, 4, events, symmetric=symmetric)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bad,msg", [
    ([(0, 4, 1, 2, 0.5)], "out of range"), ([(1, 1, 0, 2, 0.5)], "self-link"),
    ([(0, 1, -1, 2, 0.5)], "must be >= 0"), ([(0, 1, 3, 3, 0.5)], "must be > start"),
    ([(0, 1, 0, 2, -0.5)], "must be in"),
])
def test_scheduled_link_fault_trace_rejects_what_jax_rejects(bad, msg):
    with pytest.raises(ValueError, match=msg):
        jbw.scheduled_link_fault_trace(6, 4, bad)
    with pytest.raises(ValueError, match=msg):
        tbw.scheduled_link_fault_trace(6, 4, bad, device=CPU)
    with pytest.raises(ValueError, match="min_factor"):
        tbw.link_fault_trace(_gen(0), 3, 3, min_factor=0.0, device=CPU)


# ---------------------------------------------------------------------------
# Seeded Markov traces: seeded, bounded, and by distribution
# ---------------------------------------------------------------------------

def test_site_failure_trace_seeded_bounded_and_matches_jax_by_distribution():
    """Shapes, {0, 1} values, seeded replay and min_alive exactly; the
    stationary alive share of a Markov on/off site (death 0.05, repair 6
    slots: 1 / (1 + 0.05 * 6) ≈ 0.77) within 0.03 of JAX's over 8 sites x
    3000 slots (the sampling spread of either is < 0.01)."""
    t, n = 3000, 8
    a = tf.site_failure_trace(_gen(3), t, n, 0.05, 6, min_alive=2, device=CPU)
    assert a.shape == (t, n) and a.dtype == torch.float32
    assert set(np.unique(a.numpy())) <= {0.0, 1.0}
    assert torch.equal(a, tf.site_failure_trace(_gen(3), t, n, 0.05, 6, min_alive=2,
                                                device=CPU))
    assert float(a.sum(1).min()) >= 2
    j = np.asarray(jf.site_failure_trace(jax.random.key(3), t, n, 0.05, 6, min_alive=2))
    assert abs(float(a.mean()) - float(j.mean())) < 0.03, (float(a.mean()), float(j.mean()))
    # Permanent loss: once dead, dead for good, in both.
    p = tf.site_failure_trace(_gen(4), 400, n, 0.01, None, device=CPU).numpy()
    assert (np.diff(p, axis=0) <= 0).all()
    assert float(tf.repair_edges(torch.from_numpy(p)).sum()) == 0.0


def test_health_trace_matches_jax_by_distribution():
    """Factors in {1} ∪ [lo, hi] ∪ {0}; the straggling share (onset 0.05,
    recovery 0.25: 0.05 / 0.30 ≈ 0.17) and the dead share (death 0.3 of
    onsets) within 0.02 of JAX's over 8 sites x 3000 slots."""
    t, n, sev = 3000, 8, (0.2, 0.7)
    h = tf.health_trace(_gen(5), t, n, 0.05, 0.25, sev, death_prob=0.3, device=CPU).numpy()
    j = np.asarray(jf.health_trace(jax.random.key(5), t, n, 0.05, 0.25, sev, death_prob=0.3))
    assert h.shape == (t, n) and h.dtype == np.float32
    interior = h[(h > 0) & (h < 1)]
    assert interior.min() >= sev[0] and interior.max() <= sev[1]
    for stat in (lambda x: (x < 1).mean(), lambda x: (x == 0).mean(), lambda x: x.mean()):
        assert abs(stat(h) - stat(j)) < 0.02, (stat(h), stat(j))
    assert (tf.health_trace(_gen(0), 50, 4, straggle_prob=0.0, device=CPU) == 1.0).all()


def test_regional_health_trace_matches_jax_by_distribution():
    """Whole regions fail together (every site of a region shares its
    factor); the outage share (0.05 onset, 4-slot repair, ≈ 0.17) within
    0.03 of JAX's over 4 regions x 3000 slots; min_regions_up holds."""
    regions = tf.region_assignment(12, 4, device=CPU)
    h = tf.regional_health_trace(_gen(6), 3000, regions, 0.05, 4, 0.3, min_regions_up=2).numpy()
    j = np.asarray(jf.regional_health_trace(jax.random.key(6), 3000,
                                            jnp.asarray(regions.numpy()), 0.05, 4, 0.3,
                                            min_regions_up=2))
    assert set(np.unique(h)) <= {np.float32(0.3), np.float32(1.0)}
    r = regions.numpy()
    for g in range(4):
        assert (h[:, r == g] == h[:, r == g][:, :1]).all()
    assert ((h[:, ::3] == 1.0).sum(1) >= 2).all()
    assert abs((h < 1).mean() - (j < 1).mean()) < 0.03, ((h < 1).mean(), (j < 1).mean())


def test_link_fault_trace_matches_jax_by_distribution():
    """Diagonal pinned to 1, factors in {0} ∪ [min, 1]; the faulted-link
    share (0.02 onset, 0.25 recovery: ≈ 0.074) and the severed share
    (sever 0.4 of faults) within 0.01 of JAX's over 8 x 8 links x 1500
    slots."""
    t, n = 1500, 8
    lh = tbw.link_fault_trace(_gen(7), t, n, 0.02, 0.25, 0.4, 0.2, device=CPU).numpy()
    j = np.asarray(jbw.link_fault_trace(jax.random.key(7), t, n, 0.02, 0.25, 0.4, 0.2))
    assert lh.shape == (t, n, n)
    assert (lh[:, np.arange(n), np.arange(n)] == 1.0).all()
    interior = lh[(lh > 0) & (lh < 1)]
    assert interior.min() >= 0.2
    off = ~np.eye(n, dtype=bool)
    for stat in (lambda x: (x[:, off] < 1).mean(), lambda x: (x[:, off] == 0).mean()):
        assert abs(stat(lh) - stat(j)) < 0.01, (stat(lh), stat(j))


# ---------------------------------------------------------------------------
# drop_site / drop_site_mask
# ---------------------------------------------------------------------------

def _state(seed, runs, n=5, k=3):
    rng = np.random.default_rng(seed)
    q = rng.uniform(0, 20, (runs, n, k)).astype(np.float32)
    d = rng.dirichlet(np.ones(n), (runs, k)).astype(np.float32)
    r = rng.dirichlet(np.ones(n), (k, n)).astype(np.float32)
    return q, d, r


def test_drop_site_matches_jax():
    q, d, r = _state(0, 1)
    for dead in (0, 2, 4):
        got = drop_site(torch.from_numpy(q[0]), torch.from_numpy(r), torch.from_numpy(d[0]), dead)
        want = jfault.drop_site(q[0], r, d[0], dead)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)


@pytest.mark.parametrize("alive", [[1, 0, 1, 1, 0], [1, 1, 1, 1, 1], [0, 1, 0, 0, 0]])
def test_drop_site_mask_batched_matches_jax_per_run(alive):
    """Three runs in one call against JAX per run (elementwise selects and
    one 5-term sum: 1e-6 relative); a (K, N) layout whose replicas all sat
    on dead sites falls back to uniform over survivors."""
    q, d, _ = _state(1, 3)
    d[1, 0] = np.array([0.5, 0.5, 0, 0, 0]) if alive[0] == 1 else d[1, 0]
    d[2, 1] = np.array([0, 0.6, 0, 0, 0.4], np.float32)
    a = np.asarray(alive, np.float32)
    died = a * 0 + (1 - a)
    got = drop_site_mask(torch.from_numpy(q), torch.from_numpy(d), torch.from_numpy(a),
                         torch.from_numpy(died))
    for run in range(3):
        want = jfault.drop_site_mask(q[run], d[run], a, died)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[run].numpy(), np.asarray(w), rtol=1e-6, atol=0)
    assert np.allclose(got[2].sum(-1).numpy(), 1.0)


def test_drop_site_mask_wipe_is_a_select_and_all_alive_is_identity():
    """The queue wipe selects, never multiplies: an inf backlog at a dead
    site is wiped to 0 (``inf * 0`` would be NaN), and with every site
    alive the backlog and layout come back bit for bit, the burst 0."""
    q, d, _ = _state(2, 2)
    q = torch.from_numpy(q)
    q[0, 1, 0] = float("inf")
    alive = torch.tensor([1.0, 0.0, 1.0, 1.0, 1.0])
    q2, _, _, _ = drop_site_mask(q, torch.from_numpy(d), alive, torch.zeros(5))
    assert torch.isfinite(q2).all() and float(q2[0, 1, 0]) == 0.0
    q = torch.from_numpy(_state(3, 2)[0])
    dd = torch.from_numpy(d)
    q3, d_masked, d_drop, burst = drop_site_mask(q, dd, torch.ones(5), torch.zeros(5))
    assert torch.equal(q3, q) and torch.equal(d_masked, dd) and float(burst.abs().sum()) == 0.0
    np.testing.assert_allclose(d_drop.numpy(), d, rtol=1e-6)
