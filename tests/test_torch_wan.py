"""The port's WAN model (``repro_torch.placement.wan``) against
``repro.placement.wan`` on the same seeded numpy inputs.

Every function is fp32 arithmetic on both sides; sums and contractions run
in another order (XLA's dot against torch's matmul), so results agree to
RTOL = 1e-5 relative (with ATOL = 1e-5 for values near zero), the tolerance
the reference pins between its fused and materialized bills. Masks and
``inf`` placements must agree exactly. The port takes leading batch dims
on every operand: each batched call is held against a loop of the JAX
function over the batch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.placement import wan as jw
from repro_torch.bridge import wan_from_numpy
from repro_torch.placement import wan as tw

RTOL = 1e-5
ATOL = 1e-5
N, K = 6, 4


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def _simplex(rng, *shape):
    g = rng.gamma(1.0, size=shape)
    return (g / g.sum(-1, keepdims=True)).astype(np.float32)


@pytest.fixture
def setup():
    rng = np.random.default_rng(7)
    up = rng.uniform(0.1, 2.0, N).astype(np.float32)
    down = rng.uniform(0.1, 2.0, N).astype(np.float32)
    jwan = jw.wan_topology(jnp.asarray(up), jnp.asarray(down), 0.03)
    twan = tw.wan_topology(_t(up), _t(down), 0.03)
    omega = rng.uniform(10.0, 60.0, (3, N)).astype(np.float32)
    pue = rng.uniform(1.05, 1.3, (3, N)).astype(np.float32)
    health = np.ones((N, N), np.float32)
    health[0, 3] = 0.5
    health[2, 1] = 0.25
    health[4, 5] = 0.0                         # severed
    return rng, jwan, twan, omega, pue, health


def test_topology_and_bridge(setup):
    _, jwan, twan, *_ = setup
    for name in jw.WanModel._fields:
        np.testing.assert_array_equal(getattr(twan, name).numpy(), np.asarray(getattr(jwan, name)))
    bridged = wan_from_numpy({n: np.asarray(getattr(jwan, n)) for n in jwan._fields}, device="cpu")
    for name in jw.WanModel._fields:
        assert torch.equal(getattr(bridged, name), getattr(twan, name))
    with pytest.raises(ValueError, match="link_bw"):
        wan_from_numpy({"up": np.ones(3), "down": np.ones(3), "link_bw": np.ones((3, 4)),
                        "energy_per_gb": np.asarray(0.1)}, device="cpu")
    with pytest.raises(TypeError, match="numpy"):
        wan_from_numpy({"up": [1.0], "down": np.ones(1), "link_bw": np.ones((1, 1)),
                        "energy_per_gb": np.asarray(0.1)}, device="cpu")


@pytest.mark.parametrize("local_free", [True, False])
@pytest.mark.parametrize("healthy", [True, False])
def test_link_price_matrix(setup, local_free, healthy):
    _, _, _, omega, pue, health = setup
    w = omega[0] * pue[0]
    lh = None if healthy else health
    got = tw.link_price_matrix(_t(w), local_free, None if lh is None else _t(lh)).numpy()
    want = np.asarray(jw.link_price_matrix(jnp.asarray(w), local_free, lh))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    _close(np.where(np.isinf(got), 0, got), np.where(np.isinf(want), 0, want))


def test_transfer_plan_cost_latency(setup):
    rng, jwan, twan, omega, pue, health = setup
    d_old, d_new = _simplex(rng, 3, K, N), _simplex(rng, 3, K, N)
    sizes = rng.uniform(10.0, 100.0, (3, K)).astype(np.float32)
    plan_t = tw.transfer_plan(_t(d_old), _t(d_new), _t(sizes))
    _close(plan_t.numpy(), jw.transfer_plan(jnp.asarray(d_old), jnp.asarray(d_new), jnp.asarray(sizes)))
    got = tw.transfer_cost(plan_t, twan, _t(omega), _t(pue))
    got_h = tw.transfer_cost(plan_t, twan, _t(omega), _t(pue), _t(health))
    lat = tw.transfer_latency(plan_t, twan)
    lat_h = tw.transfer_latency(plan_t, twan, _t(health))
    for b in range(3):
        plan_j = jw.transfer_plan(jnp.asarray(d_old[b]), jnp.asarray(d_new[b]), jnp.asarray(sizes[b]))
        want = jw.transfer_cost(plan_j, jwan, jnp.asarray(omega[b]), jnp.asarray(pue[b]))
        want_h = jw.transfer_cost(plan_j, jwan, jnp.asarray(omega[b]), jnp.asarray(pue[b]),
                                  jnp.asarray(health))
        for g, w in zip(got, want):
            _close(g[b].numpy(), w)
        for g, w in zip(got_h, want_h):
            assert np.isinf(g[b].numpy()) == np.isinf(np.asarray(w))
            if not np.isinf(np.asarray(w)):
                _close(g[b].numpy(), w)
        _close(lat[b].numpy(), jw.transfer_latency(plan_j, jwan))
        assert np.isinf(lat_h[b].numpy()) == np.isinf(np.asarray(
            jw.transfer_latency(plan_j, jwan, jnp.asarray(health))))


def test_plan_cost_matches_jax_and_the_materialized_bill(setup):
    rng, jwan, twan, omega, pue, _ = setup
    src, dst = _simplex(rng, 3, 2, K, N), _simplex(rng, 3, 2, K, N)
    vol = rng.uniform(0.0, 60.0, (3, 2, K)).astype(np.float32)
    om, pu = omega[:, None], pue[:, None]                      # (3, 1, N) against (3, 2, ...)
    got = tw.plan_cost(_t(src), _t(dst), _t(vol), twan, _t(om), _t(pu))
    want = jw.plan_cost(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(vol), jwan,
                        jnp.asarray(om), jnp.asarray(pu))
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    mat = tw.transfer_cost(tw.transfer_plan(_t(src), _t(dst), _t(vol)), twan, _t(om), _t(pu))
    for g, m in zip(got, mat):
        _close(g.numpy(), m.numpy())


@pytest.mark.parametrize("one_hot", [False, True])
@pytest.mark.parametrize("healthy", [True, False])
def test_evacuation_plan_and_cost(setup, one_hot, healthy):
    """The one-hot-source case is the cancellation trap the clamp guards:
    a one-hot surviving row leaves leave-one-out sums of a signed ulp."""
    rng, jwan, twan, omega, pue, health = setup
    d_drop = _simplex(rng, 3, K, N)
    d_masked = d_drop * (rng.uniform(size=(3, K, N)) > 0.4)
    if one_hot:
        d_masked = np.zeros_like(d_drop)
        d_masked[:, np.arange(K), rng.integers(0, N, K)] = 0.37
    d_masked[:, 0] = 0.0                                       # a dataset lost outright
    sizes = rng.uniform(10.0, 100.0, (3, K)).astype(np.float32)
    lh = None if healthy else health
    plan_t = tw.evacuation_plan(_t(d_masked), _t(d_drop), _t(sizes), None if lh is None else _t(lh))
    cost_t = tw.evacuation_cost(_t(d_masked), _t(d_drop), _t(sizes), twan, _t(omega), _t(pue))
    for b in range(3):
        args = (jnp.asarray(d_masked[b]), jnp.asarray(d_drop[b]), jnp.asarray(sizes[b]))
        _close(plan_t[b].numpy(), jw.evacuation_plan(*args, lh))
        want = jw.evacuation_cost(*args, jwan, jnp.asarray(omega[b]), jnp.asarray(pue[b]))
        for g, w in zip(cost_t, want):
            _close(g[b].numpy(), w)
            assert float(g[b]) >= 0.0
        if healthy:
            mat = tw.transfer_cost(plan_t[b], twan, _t(omega[b]), _t(pue[b]))
            for g, m in zip(cost_t, mat):
                _close(g[b].numpy(), m.numpy())


@pytest.mark.parametrize("simplex", [False, True])
def test_expected_pull(setup, simplex):
    rng, *_ , omega, pue, _ = setup
    src = _simplex(rng, 3, K, N)
    w = omega * pue
    got = tw.expected_pull(_t(src), _t(w), assume_simplex=simplex)
    for b in range(3):
        _close(got[b].numpy(), jw.expected_pull(jnp.asarray(src[b]), jnp.asarray(w[b]), simplex))
        full = _t(src[b]) @ tw.link_price_matrix(_t(w[b]))
        _close(got[b].numpy(), full.numpy())


def test_degraded_surcharge_severed_and_nominal(setup):
    """Degraded links bill a premium, a severed link carrying traffic bills
    inf, and an all-nominal trace bills exactly 0."""
    rng, jwan, twan, omega, pue, health = setup
    src, dst = _simplex(rng, 3, K, N), _simplex(rng, 3, K, N)
    vol = rng.uniform(0.0, 60.0, (3, K)).astype(np.float32)
    lh = np.broadcast_to(health, (3, N, N)).copy()
    lh[1, 4, 5] = 1.0                                          # batch 1: no severed link
    got = tw.degraded_surcharge(_t(src), _t(dst), _t(vol), twan, _t(omega), _t(pue), _t(lh))
    want = jw.degraded_surcharge(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(vol), jwan,
                                 jnp.asarray(omega), jnp.asarray(pue), jnp.asarray(lh))
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_array_equal(np.isinf(g), np.isinf(w))
        assert np.isinf(g[0]) and np.isfinite(g[1]) and g[1] > 0.0
        _close(np.where(np.isinf(g), 0, g), np.where(np.isinf(w), 0, w))
    nominal = tw.degraded_surcharge(_t(src), _t(dst), _t(vol), twan, _t(omega), _t(pue),
                                    torch.ones(3, N, N))
    for x in nominal:
        assert torch.equal(x, torch.zeros(3))
