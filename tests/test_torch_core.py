"""The port's core modules (queues, energy, GMSA, baselines, Iridium) against
the JAX package on the same seeded numpy inputs."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jb
from repro.core import energy as je
from repro.core import gmsa as jg
from repro.core import iridium as ji
from repro.core import queues as jq
from repro_torch.core import baselines as tb
from repro_torch.core import energy as te
from repro_torch.core import gmsa as tg
from repro_torch.core import iridium as ti
from repro_torch.core import queues as tq

torch.set_float32_matmul_precision("highest")

# Elementwise fp32 arithmetic in the same order on both sides; reductions and
# einsums may sum in another order, which stays well inside 1e-6 relative.
RTOL = 1e-6

N, K = 6, 3


def _state(seed, runs=()):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return types.SimpleNamespace(
        q=(rng.random(runs + (N, K)) * 30).astype(f32),
        f=rng.dirichlet(np.ones(N), runs + (K,)).swapaxes(-1, -2).astype(f32),
        a=rng.integers(0, 60, runs + (K,)).astype(f32),
        mu=rng.integers(0, 20, runs + (N, K)).astype(f32),
        omega=(rng.random(N) * 30 + 5).astype(f32),
        pue=(1.0 + rng.random(N) * 0.2).astype(f32),
        r=rng.dirichlet(np.ones(N), (K, N)).astype(f32),
        p_it=(0.5 + rng.random(K)).astype(f32),
        dd=rng.dirichlet(np.ones(N), K).astype(f32),
        up=(0.1 + rng.random(N) * 1.9).astype(f32),
        down=(0.1 + rng.random(N) * 1.9).astype(f32),
    )


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(port, ref, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol, atol=atol)


# ---------------------------------------------------------------- queues


@pytest.mark.parametrize("runs", [(), (4,)])
def test_queue_functions_match_jax(runs):
    s = _state(1, runs)
    vm = jax.vmap if runs else (lambda f: f)
    q_j = vm(jq.queue_step)(s.q, s.f, s.a, s.mu)
    q_t = tq.queue_step(_t(s.q), _t(s.f), _t(s.a), _t(s.mu))
    _close(q_t, q_j)
    for jf, tf in [(jq.total_backlog, tq.total_backlog),
                   (jq.average_backlog, tq.average_backlog),
                   (jq.lyapunov, tq.lyapunov)]:
        _close(tf(_t(s.q)), vm(jf)(s.q))


# ---------------------------------------------------------------- energy


def test_energy_functions_match_jax():
    s = _state(2)
    e_j = je.manager_energy_cost(s.omega, s.pue, s.r, s.p_it)
    e_t = te.manager_energy_cost(_t(s.omega), _t(s.pue), _t(s.r), _t(s.p_it))
    _close(e_t, e_j)
    _close(te.manager_energy(_t(s.pue), _t(s.r), _t(s.p_it)),
           je.manager_energy(s.pue, s.r, s.p_it))
    _close(te.slot_cost(_t(s.f), _t(s.a), e_t), je.slot_cost(s.f, s.a, e_j))
    _close(te.slot_energy(_t(s.f), _t(s.a), e_t), je.slot_energy(s.f, s.a, e_j))
    m_j = je.EnergyModel(jnp.asarray(s.r), jnp.asarray(s.p_it))
    m_t = te.EnergyModel(_t(s.r), _t(s.p_it))
    m_t.validate()
    _close(m_t.cost_of_managers(_t(s.omega), _t(s.pue)), m_j.cost_of_managers(s.omega, s.pue))
    _close(m_t.slot_cost(_t(s.f), _t(s.a), _t(s.omega), _t(s.pue)),
           m_j.slot_cost(s.f, s.a, s.omega, s.pue))


@pytest.mark.parametrize("bad", ["rowsum", "negative", "shape", "p_it"])
def test_energy_model_validate_raises_like_jax(bad):
    s = _state(3)
    r, p = s.r.copy(), s.p_it.copy()
    if bad == "rowsum":
        r[0, 0, 0] += 0.1
    elif bad == "negative":
        r[1, 2, 0] -= 0.5
        r[1, 2, 1] += 0.5
    elif bad == "shape":
        r = r[:, :, :-1]
    else:
        p = p[:-1]
    with pytest.raises(ValueError):
        je.EnergyModel(jnp.asarray(r), jnp.asarray(p)).validate()
    with pytest.raises(ValueError):
        te.EnergyModel(_t(r), _t(p)).validate()


# ---------------------------------------------------------------- GMSA


@pytest.mark.parametrize("v", [0.0, 1.0, 25.0])
@pytest.mark.parametrize("runs", [(), (5,)])
def test_gmsa_scores_dispatch_and_objective_match_jax(v, runs):
    s = _state(4 + int(v), runs)
    e = je.manager_energy_cost(s.omega, s.pue, s.r, s.p_it)
    e_np = np.asarray(e)
    vm = jax.vmap if runs else (lambda f: f)
    sc_j = vm(lambda q, a, mu: jg.drift_plus_penalty_scores(q, a, mu, e, v))(s.q, s.a, s.mu)
    sc_t = tg.drift_plus_penalty_scores(_t(s.q), _t(s.a), _t(s.mu), _t(e_np), v)
    _close(sc_t, sc_j, atol=1e-4)
    f_j = vm(lambda q, a, mu: jg.gmsa_dispatch(q, a, mu, e, v))(s.q, s.a, s.mu)
    f_t = tg.gmsa_dispatch(_t(s.q), _t(s.a), _t(s.mu), _t(e_np), v)
    assert np.array_equal(f_t.numpy(), np.asarray(f_j))
    obj_j = vm(lambda f, q, a, mu: jg.lp_objective(f, q, a, mu, e, v))(s.f, s.q, s.a, s.mu)
    obj_t = tg.lp_objective(_t(s.f), _t(s.q), _t(s.a), _t(s.mu), _t(e_np), v)
    _close(obj_t, obj_j, atol=1e-3)


def test_gmsa_dispatch_raw_operands_and_errors():
    s = _state(5)
    # p_it folds into vp: the raw path equals the table path at the same V.
    e = te.manager_energy_cost(_t(s.omega), _t(s.pue), _t(s.r), _t(s.p_it))
    f_tab = tg.gmsa_dispatch(_t(s.q), _t(s.a), _t(s.mu), e, 2.0)
    f_raw = tg.gmsa_dispatch(_t(s.q), _t(s.a), _t(s.mu), None, 2.0, impl="ref",
                             r=_t(s.r), wpue=_t(s.omega * s.pue), p_it=_t(s.p_it))
    assert torch.equal(f_tab, f_raw)
    q = torch.zeros(4, 2)
    with pytest.raises(ValueError, match="raw operands"):
        tg.gmsa_dispatch(q, torch.ones(2), q, None, 1.0, impl="kernel")
    with pytest.raises(ValueError, match="unknown impl"):
        tg.gmsa_dispatch(q, torch.ones(2), q, torch.zeros(2, 4), 1.0, impl="bogus")


def test_lyapunov_bound_and_config_match_jax():
    a_max = np.array([128.0, 64.0], np.float32)
    mu_max = np.array([32.0, 16.0], np.float32)
    _close(tg.lyapunov_drift_bound_B(_t(a_max), _t(mu_max), 7),
           jg.lyapunov_drift_bound_B(a_max, mu_max, 7))
    assert tg.GMSAConfig() == tg.GMSAConfig(v=jg.GMSAConfig().v)


def test_policy_attribute_protocol_matches_jax():
    r = np.eye(4, dtype=np.float32)[None]
    attrs = ("consumes_key", "state_independent", "wants_wpue", "wants_r", "static_r")
    pairs = [
        (jg.gmsa_policy, tg.gmsa_policy),
        (jg.dispatch_fn(1.0), tg.dispatch_fn(1.0)),
        (jg.make_kernel_policy(None), tg.make_kernel_policy(None)),
        (jg.make_kernel_policy(jnp.asarray(r)), tg.make_kernel_policy(_t(r))),
        (jb.data_dispatch, tb.data_dispatch),
        (jb.random_dispatch, tb.random_dispatch),
        (jb.jsq_dispatch, tb.jsq_dispatch),
        (jb.greedy_cost_dispatch, tb.greedy_cost_dispatch),
    ]
    for jp, tp in pairs:
        for name in attrs:
            assert getattr(tp, name, None) == getattr(jp, name, None), (tp, name)
    assert tb.MAX_SLOT_ARRIVALS == jb.MAX_SLOT_ARRIVALS


def test_kernel_policy_static_and_carried_r_agree():
    s = _state(6)
    wpue = s.omega * s.pue
    aux_c = (_t(s.dd), _t(wpue), _t(s.r))
    f_c = tg.make_kernel_policy(None)(None, _t(s.q), _t(s.a), _t(s.mu), None, aux_c, 3.0)
    f_s = tg.make_kernel_policy(_t(s.r))(None, _t(s.q), _t(s.a), _t(s.mu), None,
                                          aux_c[:2], 3.0)
    f_j = jg.make_kernel_policy(None)(None, s.q, s.a, s.mu, None,
                                      (s.dd, wpue, s.r), 3.0)
    assert torch.equal(f_c, f_s)
    assert np.array_equal(f_c.numpy(), np.asarray(f_j))


# ---------------------------------------------------------------- baselines


@pytest.mark.parametrize("runs", [(), (4,)])
def test_data_jsq_greedy_match_jax_exactly(runs):
    s = _state(7, runs)
    e = np.asarray(je.manager_energy_cost(s.omega, s.pue, s.r, s.p_it))
    vm = jax.vmap if runs else (lambda f: f)
    for jp, tp in [(jb.data_dispatch, tb.data_dispatch),
                   (jb.jsq_dispatch, tb.jsq_dispatch),
                   (jb.greedy_cost_dispatch, tb.greedy_cost_dispatch)]:
        f_j = vm(lambda q, a, mu: jp(None, q, a, mu, e, s.dd))(s.q, s.a, s.mu)
        f_t = tp(None, _t(s.q), _t(s.a), _t(s.mu), _t(e), _t(s.dd))
        f_t = f_t.broadcast_to(runs + (N, K))
        assert np.array_equal(f_t.numpy(), np.asarray(f_j)), tp.__name__


def test_random_dispatch_matches_jax_in_distribution():
    """Per-site counts of the multinomial split: mean A/N and variance
    A(1/N)(1-1/N) per (site, type), on both sides, over 4000 slots.

    With 4000 slots the standard error of a per-site mean is about
    sqrt(var/4000) <= 0.05 jobs; 6 standard errors bound each comparison."""
    slots, a = 4000, np.array([40.0, 7.0, 0.0], np.float32)
    arrivals = np.broadcast_to(a, (slots, K)).copy()
    q0 = np.zeros((N, K), np.float32)
    keys = jax.random.split(jax.random.key(0), slots)
    f_j = np.asarray(jax.vmap(
        lambda kk, aa: jb.random_dispatch(kk, q0, aa, q0, None, None))(keys, arrivals))
    g = torch.Generator().manual_seed(0)
    f_t = tb.random_dispatch(g, torch.zeros(1, N, K), _t(arrivals), None, None, None).numpy()
    assert f_t.shape == f_j.shape == (slots, N, K)
    for f in (f_j, f_t):
        counts = f[:, :, :2] * a[:2]
        np.testing.assert_allclose(counts.sum(1), np.broadcast_to(a[:2], (slots, 2)))
        mean, var = a[:2] / N, a[:2] * (1 / N) * (1 - 1 / N)
        se = np.sqrt(var / slots)
        assert np.all(np.abs(counts.mean(0) - mean) < 6 * se)
        assert np.all(np.abs(counts.var(0) / var - 1) < 0.15)
        np.testing.assert_allclose(f[:, :, 2], 1.0 / N)   # empty slots: uniform


def test_random_dispatch_same_seed_same_draws():
    a = torch.full((2, 5, K), 9.0)
    f1 = tb.random_dispatch(torch.Generator().manual_seed(3), torch.zeros(N, K), a, None, None, None)
    f2 = tb.random_dispatch(torch.Generator().manual_seed(3), torch.zeros(N, K), a, None, None, None)
    assert torch.equal(f1, f2)


def test_static_placement_rule_matches_jax():
    s = _state(8)
    d = _t(s.dd)
    assert tb.static_placement_rule(d, object()) is d
    alive_all = types.SimpleNamespace(alive=np.ones(N, np.float32))
    assert torch.equal(tb.static_placement_rule(d, alive_all), d)
    alive = np.ones(N, np.float32)
    alive[[1, 4]] = 0.0
    got = tb.static_placement_rule(d, types.SimpleNamespace(alive=alive))
    want = jb.static_placement_rule(jnp.asarray(s.dd), types.SimpleNamespace(alive=alive))
    _close(got, want)


# ---------------------------------------------------------------- Iridium


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_iridium_and_task_allocation_match_jax(seed):
    s = _state(10 + seed)
    for k in range(K):
        r_j, z_j = ji.iridium_reduce_placement(s.dd[k], s.up, s.down, 1.0)
        r_t, z_t = ti.iridium_reduce_placement(_t(s.dd[k]), _t(s.up), _t(s.down), 1.0)
        _close(r_t, r_j, rtol=1e-5, atol=1e-6)
        _close(z_t, z_j, rtol=1e-5)
    r_j = ji.build_task_allocation(s.dd, s.up, s.down, 1.0, 0.62, 0.6)
    r_t = ti.build_task_allocation(_t(s.dd), _t(s.up), _t(s.down), 1.0, 0.62, 0.6)
    assert r_t.dtype == torch.float32 and tuple(r_t.shape) == (K, N, N)
    _close(r_t, r_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(r_t.sum(-1).numpy(), 1.0, atol=1e-5)
    rebuild = ti.make_allocation_rebuilder(_t(s.up), _t(s.down), 1.0, 0.62, 0.6)
    assert torch.equal(rebuild(_t(s.dd)), r_t)


def test_iridium_skewed_fleet_layout_matches_jax():
    """Dirichlet(0.5) layouts (the fleet's) put near-all data on few sites,
    the regime where the bisection's float32 slacks matter."""
    rng = np.random.default_rng(99)
    n = 32
    dd = rng.dirichlet(np.full(n, 0.5), 4).astype(np.float32)
    up = rng.uniform(1.0, 40.0, n).astype(np.float32)
    down = rng.uniform(1.0, 40.0, n).astype(np.float32)
    r_j = ji.build_task_allocation(dd, up, down, 1.0, 0.3, 0.6)
    r_t = ti.build_task_allocation(_t(dd), _t(up), _t(down), 1.0, 0.3, 0.6)
    _close(r_t, r_j, rtol=1e-5, atol=1e-6)
