"""The slice as a whole: the port's simulator against JAX's on bridged traces.

JAX's threefry streams cannot be reproduced by torch generators, so the
per-run JAX trace bundles are built exactly as ``repro.core.simulator
.simulate_many`` builds them (split the key per run, then ``k_build``),
carried across with ``repro_torch.bridge`` and stacked on the port's runs
axis; both engines then run on identical traces. The JAX kernel path runs
its Pallas kernel in interpret mode, as tests/test_kernels.py does; the
port's kernel policy takes the plain version for CPU tensors.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import facebook_4dc as jfb
from repro.configs import fleet_256 as jfl
from repro.core import baselines as jb
from repro.core import gmsa as jg
from repro.core import simulator as js
from repro_torch.bridge import sim_inputs_from_numpy, stack_runs
from repro_torch.configs import facebook_4dc as tfb
from repro_torch.configs import fleet_256 as tfl
from repro_torch.core import baselines as tb
from repro_torch.core import gmsa as tg
from repro_torch.core import simulator as ts

torch.set_float32_matmul_precision("highest")

# test_kernels.py:141's tolerance for a kernel-path run against a reference
# engine: costs and backlogs accumulate fp32 sums taken in another order.
RTOL = 1e-4
FLEET = dataclasses.replace(jfl.FleetConfig(), n_sites=32, k_types=3, t_slots=24, n_runs=4)
PAPER = dataclasses.replace(jfb.PaperSimConfig(), t_slots=48)


def _numpy_fields(ins):
    return {name: np.asarray(getattr(ins, name)) for name in ins._fields}


def _bridged_runs(build_inputs, key, n_runs):
    """Per-run JAX inputs exactly as simulate_many draws them, bridged and
    stacked on the port's leading runs axis."""
    runs = []
    for run_key in jax.random.split(key, n_runs):
        k_build, _ = jax.random.split(run_key)
        runs.append(sim_inputs_from_numpy(_numpy_fields(build_inputs(k_build)), device="cpu"))
    return stack_runs(runs)


@pytest.fixture(scope="module")
def fleet():
    _, build = jfl.make_fleet_builder(FLEET)
    key = jax.random.key(0)
    return build, key, _bridged_runs(build, key, FLEET.n_runs)


@pytest.fixture(scope="module")
def paper():
    _, build = jfb.make_sim_builder(PAPER)
    key = jax.random.key(1)
    return build, key, _bridged_runs(build, key, 8)


def _first_divergence_is_near_tie(f_port, f_jax, ins, v):
    """Where the decisions first differ in a run, the two picks' scores on
    JAX's state (replayed with Eq. 1 in float64) are within 1e-5 relative."""
    for run in range(f_port.shape[0]):
        diff = np.nonzero((f_port[run] != f_jax[run]).any(axis=(-2, -1)))[0]
        if diff.size == 0:
            continue
        t = int(diff[0])
        a = ins.arrivals[run].numpy().astype(np.float64)
        mu = ins.mu[run].numpy().astype(np.float64)
        q = np.zeros(mu.shape[1:])
        for s in range(t):
            q = np.maximum(q + f_jax[run, s] * a[s] - mu[s], 0.0)
        wpue = (ins.omega[t] * ins.pue[t]).numpy().astype(np.float64)
        e = np.einsum("kij,j->ki", ins.r.numpy().astype(np.float64), wpue)
        scores = a[t][:, None] * ((q - mu[t]).T + v * e)          # (K, N)
        for k in np.nonzero((f_port[run, t] != f_jax[run, t]).any(0))[0]:
            i_p, i_j = f_port[run, t, :, k].argmax(), f_jax[run, t, :, k].argmax()
            lo = min(scores[k, i_p], scores[k, i_j])
            assert abs(scores[k, i_p] - scores[k, i_j]) <= 1e-5 * abs(lo) + 1e-4, (run, t, k)


def _compare(o_port, o_jax, v=None, ins=None, min_agree=1.0):
    f_p, f_j = o_port.f_trace.numpy(), np.asarray(o_jax.f_trace)
    assert f_p.shape == f_j.shape
    agree = float((f_p == f_j).all(axis=-2).mean())
    assert agree >= min_agree, agree
    if agree < 1.0:
        _first_divergence_is_near_tie(f_p, f_j, ins, v)
    for name in ("cost", "energy", "backlog_total", "backlog_avg", "q_final"):
        np.testing.assert_allclose(
            getattr(o_port, name).numpy(), np.asarray(getattr(o_jax, name)),
            rtol=RTOL, atol=RTOL, err_msg=name,
        )


@pytest.mark.parametrize("arm", ["kernel_policy", "gmsa_policy"])
def test_fleet_kernel_policy_matches_jax(fleet, arm):
    build, key, ins = fleet
    v = FLEET.v
    jax_policy = jg.make_kernel_policy(None) if arm == "kernel_policy" else jg.gmsa_policy
    o_j = js.simulate_many(build, jax_policy, key, FLEET.n_runs, v)
    o_t = ts.simulate(ins, tg.make_kernel_policy(None), None, v)
    assert tuple(o_t.f_trace.shape) == (4, 24, 32, 3)
    _compare(o_t, o_j, v, ins, min_agree=0.999)


def test_fleet_port_policies_agree(fleet):
    """Within the port: carried-r kernel policy, static-r kernel policy,
    its plain version and the table policy on the same bridged traces."""
    _, _, ins = fleet
    v = FLEET.v
    base = ts.simulate(ins, tg.make_kernel_policy(None), None, v)
    for policy in (tg.make_kernel_policy(ins.r, ins.p_it),
                   tg.make_kernel_policy(None, impl="ref")):
        o = ts.simulate(ins, policy, None, v)
        assert torch.equal(o.f_trace, base.f_trace)
        assert torch.equal(o.cost, base.cost)
    o = ts.simulate(ins, tg.gmsa_policy, None, v)
    assert float((o.f_trace == base.f_trace).all(-2).float().mean()) >= 0.999
    np.testing.assert_allclose(o.cost.numpy(), base.cost.numpy(), rtol=RTOL)


@pytest.mark.parametrize("arm", ["gmsa_v1", "data", "jsq", "greedy"])
def test_paper_scenario_matches_jax(paper, arm):
    build, key, ins = paper
    jax_policy, port_policy, v = {
        "gmsa_v1": (jg.dispatch_fn(1.0), tg.dispatch_fn(1.0), 1.0),
        "data": (jb.data_dispatch, tb.data_dispatch, 0.0),
        "jsq": (jb.jsq_dispatch, tb.jsq_dispatch, 0.0),
        "greedy": (jb.greedy_cost_dispatch, tb.greedy_cost_dispatch, 0.0),
    }[arm]
    o_j = js.simulate_many(build, jax_policy, key, 8, v)
    o_t = ts.simulate(ins, port_policy, None, v)
    _compare(o_t, o_j, v, ins, min_agree=1.0 if arm != "gmsa_v1" else 0.999)
    s_t, s_j = ts.summarize(o_t), js.summarize(o_j)
    assert s_t.keys() == s_j.keys()
    for name in s_t:
        np.testing.assert_allclose(s_t[name], s_j[name], rtol=RTOL)


def test_paper_scenario_gmsa_beats_baselines_in_the_port():
    """The paper's headline on the port's own traces (CPU, 48 slots)."""
    cfg = dataclasses.replace(tfb.PaperSimConfig(), t_slots=48)
    _, build = tfb.make_sim_builder(cfg, device="cpu")
    res = {}
    for name, policy, v in [("gmsa", tg.dispatch_fn(1.0), 1.0),
                            ("data", tb.data_dispatch, 0.0),
                            ("random", tb.random_dispatch, 0.0)]:
        gen = torch.Generator().manual_seed(0)
        res[name] = ts.summarize(ts.simulate_many(build, policy, gen, 32, v, device="cpu"))
    assert res["gmsa"]["time_avg_cost"] < res["data"]["time_avg_cost"]
    assert res["gmsa"]["time_avg_cost"] < res["random"]["time_avg_cost"]
    assert res["gmsa"]["time_avg_backlog"] < 50.0


def test_time_varying_r_carried_and_static_raise(fleet):
    """A (T, K, N, N) ratio trace: the carried-r kernel policy matches JAX's
    on it; a statically bound r raises in both engines."""
    _, _, ins = fleet
    rng = np.random.default_rng(0)
    t_slots = ins.omega.shape[0]
    drift = rng.dirichlet(np.ones(FLEET.n_sites), (t_slots, FLEET.k_types, FLEET.n_sites))
    r_t = (0.8 * ins.r.numpy()[None] + 0.2 * drift).astype(np.float32)
    one = ins._replace(arrivals=ins.arrivals[0], mu=ins.mu[0], r=torch.from_numpy(r_t))
    j_in = js.SimInputs(**{n: np.asarray(getattr(one, n).numpy()) for n in one._fields})
    o_j = js.simulate(j_in, jg.make_kernel_policy(None), jax.random.key(0), FLEET.v)
    o_t = ts.simulate(one, tg.make_kernel_policy(None), None, FLEET.v)
    np.testing.assert_array_equal(o_t.f_trace.numpy(), np.asarray(o_j.f_trace))
    np.testing.assert_allclose(o_t.cost.numpy(), np.asarray(o_j.cost), rtol=RTOL)
    with pytest.raises(ValueError, match="time-varying"):
        ts.simulate(one, tg.make_kernel_policy(ins.r), None, FLEET.v)

    def bad(generator, q, arrivals, mu, e, aux, scalar):
        return tg.gmsa_dispatch(q, arrivals, mu, e, scalar)

    bad.consumes_key, bad.wants_r = False, True
    with pytest.raises(ValueError, match="wants_wpue"):
        ts.simulate(ins, bad, None, 1.0)


def test_all_ones_health_is_identity_and_health_matches_jax(paper):
    build, key, ins = paper
    policy = tg.dispatch_fn(1.0)
    base = ts.simulate(ins, policy, None, 1.0)
    ones = ts.simulate(ins, policy, None, 1.0, health=torch.ones(ins.omega.shape))
    for a, b in zip(base, ones):
        assert torch.equal(a, b)
    health = np.ones(ins.omega.shape, np.float32)
    health[10:30, 2] = 0.0
    health[5:, 0] = 0.5
    o_t = ts.simulate(ins, policy, None, 1.0, health=torch.from_numpy(health))
    o_j = js.simulate_many(build, jg.dispatch_fn(1.0), key, 8, 1.0, health=health)
    _compare(o_t, o_j, 1.0, ins._replace(mu=ins.mu * torch.from_numpy(health)[:, :, None]),
             min_agree=0.999)


def test_same_seed_same_outputs_and_runs_axis_is_per_run():
    cfg = dataclasses.replace(tfl.FleetConfig(), n_sites=16, k_types=2, t_slots=12)
    _, build = tfl.make_fleet_builder(cfg, device="cpu")
    run = lambda seed, policy: ts.simulate_many(
        build, policy, torch.Generator().manual_seed(seed), 3, cfg.v, device="cpu")
    for policy in (tb.random_dispatch, tg.make_kernel_policy(None)):
        a, b = run(11, policy), run(11, policy)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        assert not torch.equal(run(12, policy).cost, a.cost)
    # Run i of the batched engine is the unbatched engine on run i's traces.
    ins = build(torch.Generator().manual_seed(4), 3)
    batched = ts.simulate(ins, tg.make_kernel_policy(None), None, cfg.v)
    for i in range(3):
        single = ts.simulate(ins._replace(arrivals=ins.arrivals[i], mu=ins.mu[i]),
                             tg.make_kernel_policy(None), None, cfg.v)
        assert torch.equal(single.f_trace, batched.f_trace[i])
        np.testing.assert_allclose(single.cost.numpy(), batched.cost[i].numpy(), rtol=1e-6)
        assert tuple(single.q_final.shape) == (16, 2)


def test_device_rule_defaults_to_cuda():
    """device=None means CUDA: without a card the entry points raise rather
    than quietly use the CPU; with one they build on it."""
    cfg = dataclasses.replace(tfl.FleetConfig(), n_sites=8, k_types=2, t_slots=4)
    if torch.cuda.is_available():
        template, _ = tfl.make_fleet_builder(cfg)
        assert template.mu.is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        tfl.make_fleet_builder(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfb.make_sim_builder(tfb.PaperSimConfig())
    _, build = tfl.make_fleet_builder(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ts.simulate_many(build, tg.gmsa_policy, torch.Generator(), 2, 1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        sim_inputs_from_numpy({n: np.zeros(1, np.float32) for n in ts.SimInputs._fields})


def test_bridge_casts_and_checks():
    fields = {n: np.ones((2, 2)) for n in ts.SimInputs._fields}     # float64
    ins = sim_inputs_from_numpy(fields, device="cpu")
    assert all(x.dtype == torch.float32 for x in ins)
    with pytest.raises(TypeError, match="numpy"):
        sim_inputs_from_numpy({**fields, "mu": [[1.0]]}, device="cpu")
    other = ins._replace(omega=ins.omega + 1)
    with pytest.raises(ValueError, match="omega"):
        stack_runs([ins, other])
    stacked = stack_runs([ins, ins._replace(mu=ins.mu * 2)])
    assert tuple(stacked.mu.shape) == (2, 2, 2) and tuple(stacked.omega.shape) == (2, 2)
