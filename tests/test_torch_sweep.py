"""The port's V-sweep (``repro_torch.core.sweep``) against JAX's and itself.

JAX's ``sweep_grid`` vmaps ``simulate_many`` over V with one key, so every
V lane replays the same per-run traces. Both engines run here on those
traces: the per-run JAX bundles are bridged exactly as
tests/test_torch_simulator.py does (``_bridged_runs``). Decisions must match
exactly off near-ties and the sums to ``RTOL`` (1e-4, that file's
tolerance: fp32 sums taken in another order). Within the port, a lane must
equal ``simulate_many`` at its V with the same seed: decisions and final
queues bitwise (each lane's arithmetic is elementwise the per-point one),
the per-slot sums bitwise on the CPU too (checked to 1e-6 relative on the
card, where a reduction may split a larger batch differently).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import facebook_4dc as jfb
from repro.configs import fleet_256 as jfl
from repro.core import gmsa as jg
from repro.core import sweep as jsw
from repro_torch.configs import facebook_4dc as tfb
from repro_torch.configs import fleet_256 as tfl
from repro_torch.core import baselines as tb
from repro_torch.core import gmsa as tg
from repro_torch.core import simulator as ts
from repro_torch.core import sweep as tsw
from test_torch_simulator import FLEET, PAPER, _bridged_runs, _compare

torch.set_float32_matmul_precision("highest")

V_POINTS = (0.01, 1.0, 100.0)     # tests/test_sweep.py's grid
CPU = "cpu"


def _lane(outs, i):
    return type(outs)(*(x[i] for x in outs))


@pytest.mark.parametrize("scenario", ["fleet_kernel_policy", "paper_gmsa_policy"])
def test_sweep_matches_jax_sweep_grid_lane_for_lane(scenario):
    if scenario == "fleet_kernel_policy":
        _, build = jfl.make_fleet_builder(FLEET)
        key, runs = jax.random.key(0), FLEET.n_runs
        jax_policy, port_policy = jg.make_kernel_policy(None), tg.make_kernel_policy(None)
    else:
        _, build = jfb.make_sim_builder(PAPER)
        key, runs = jax.random.key(1), 8
        jax_policy, port_policy = jg.gmsa_policy, tg.gmsa_policy
    ins = _bridged_runs(build, key, runs)
    o_j = jsw.sweep_grid(build, jax_policy, key, runs, V_POINTS)
    o_t = tsw.simulate_sweep(ins, port_policy, None, V_POINTS)
    assert tuple(o_t.f_trace.shape) == np.asarray(o_j.f_trace).shape
    assert tuple(o_t.cost.shape) == (len(V_POINTS), runs, ins.omega.shape[0])
    for i, v in enumerate(V_POINTS):
        lane_j = jax.tree_util.tree_map(lambda x: x[i], o_j)
        _compare(_lane(o_t, i), lane_j, v, ins, min_agree=0.999)


def _fleet_port(n_sites=32, k_types=3, t_slots=24):
    cfg = dataclasses.replace(tfl.FleetConfig(), n_sites=n_sites, k_types=k_types,
                              t_slots=t_slots)
    return tfl.make_fleet_builder(cfg, device=CPU)[1]


@pytest.mark.parametrize("arm", ["kernel_policy", "kernel_policy_ref", "gmsa_policy"])
def test_sweep_lanes_equal_per_point_simulate_many(arm):
    build = _fleet_port()
    policy = {"kernel_policy": tg.make_kernel_policy(None),
              "kernel_policy_ref": tg.make_kernel_policy(None, impl="ref"),
              "gmsa_policy": tg.gmsa_policy}[arm]
    grid = tsw.sweep_grid(build, policy, torch.Generator().manual_seed(5), 4, V_POINTS,
                          device=CPU)
    assert tuple(grid.f_trace.shape) == (3, 4, 24, 32, 3)
    for i, v in enumerate(V_POINTS):
        per = ts.simulate_many(build, policy, torch.Generator().manual_seed(5), 4, v,
                               device=CPU)
        lane = _lane(grid, i)
        assert torch.equal(lane.f_trace, per.f_trace)
        assert torch.equal(lane.q_final, per.q_final)
        for name in ("cost", "energy", "backlog_total", "backlog_avg"):
            torch.testing.assert_close(getattr(lane, name), getattr(per, name),
                                       rtol=1e-6, atol=0.0, msg=name)


def test_random_lanes_are_identical_and_equal_simulate_many():
    """RANDOM ignores V and consumes the generator: it runs once on the
    (R,) batch and every lane is that run, bit for bit."""
    _, build = tfb.make_sim_builder(dataclasses.replace(tfb.PaperSimConfig(), t_slots=48),
                                    device=CPU)
    grid = tsw.sweep_grid(build, tb.random_dispatch, torch.Generator().manual_seed(9), 6,
                          V_POINTS, device=CPU)
    per = ts.simulate_many(build, tb.random_dispatch, torch.Generator().manual_seed(9), 6,
                           device=CPU)
    for i in range(len(V_POINTS)):
        for a, b in zip(_lane(grid, i), per):
            assert torch.equal(a, b)


def test_sweep_grid_v_monotonicity():
    """Mirrors tests/test_sweep.py's test_sweep_grid_v_monotonicity on the
    port's own traces: cost falls with V, backlog rises."""
    _, build = tfb.make_sim_builder(tfb.PaperSimConfig(), device=CPU)
    grid = tsw.sweep_grid(build, tg.gmsa_policy, torch.Generator().manual_seed(43), 16,
                          V_POINTS, device=CPU)
    costs = [float(grid.cost[i].mean()) for i in range(len(V_POINTS))]
    backlogs = [float(grid.backlog_avg[i].mean()) for i in range(len(V_POINTS))]
    assert costs[0] >= costs[1] >= costs[2] * 0.99
    assert backlogs[-1] >= backlogs[0]


@pytest.mark.parametrize("arm", ["kernel_policy", "gmsa_policy"])
def test_scalar_contract_0d_and_batched_v(arm):
    """A number, a 0-d tensor and a one-point sweep give the same outputs
    bit for bit, and a (V, 1) scalar equals V per-point calls; scalars that
    do not fit the batch raise."""
    build = _fleet_port(16, 2, 12)
    ins = build(torch.Generator().manual_seed(2), 3)
    policy = tg.make_kernel_policy(None) if arm == "kernel_policy" else tg.gmsa_policy
    base = ts.simulate(ins, policy, None, 2.5)
    for other in (ts.simulate(ins, policy, None, torch.tensor(2.5)),
                  _lane(tsw.simulate_sweep(ins, policy, None, [2.5]), 0)):
        for a, b in zip(base, other):
            assert torch.equal(a, b)
    v = torch.tensor([[0.5], [2.5]])
    stacked = ins._replace(arrivals=ins.arrivals.expand(2, -1, -1, -1),
                           mu=ins.mu.expand(2, -1, -1, -1, -1))
    both = ts.simulate(stacked, policy, None, v)
    for i in range(2):
        per = ts.simulate(ins, policy, None, float(v[i, 0]))
        assert torch.equal(both.f_trace[i], per.f_trace)
        assert torch.equal(both.q_final[i], per.q_final)
    for bad in (torch.ones(3), torch.ones(2, 3, 1), torch.ones(1, 3)):
        with pytest.raises(ValueError, match="does not fit the batch"):
            ts.simulate(stacked, policy, None, bad)


def test_key_consuming_state_dependent_policy_raises():
    build = _fleet_port(8, 2, 4)

    def noisy(generator, q, arrivals, mu, e, aux, scalar):
        return tg.gmsa_dispatch(q, arrivals, mu, e, scalar)

    with pytest.raises(ValueError, match="consumes the generator"):
        tsw.sweep_grid(build, noisy, torch.Generator(), 2, V_POINTS, device=CPU)
    with pytest.raises(ValueError, match="1-D"):
        tsw.sweep_grid(build, tg.gmsa_policy, torch.Generator(), 2, [[1.0]], device=CPU)


def test_kernel_wrapper_folds_runs_in_q_layout():
    """The CUDA wrapper's fold of (*B, K, N) operands into the kernels' runs
    axis: a view where the batch folds; a sweep's mu, expanded over V with
    stride 0, is copied K-contiguous like the simulator's q, so the pick
    kernel keeps its coalesced layout."""
    from repro_torch.kernels.gmsa_score.kernel import _fold_runs

    r, t, n, k, v = 3, 5, 6, 4, 2
    mu_t = torch.randn(r, t, n, k)[:, 1]                     # (R, N, K), a slot column
    view = _fold_runs(mu_t.mT, r, k, n, True)
    assert view.data_ptr() == mu_t.data_ptr() and torch.equal(view, mu_t.mT)
    lanes = mu_t.expand(v, r, n, k).mT                       # (V, R, K, N), stride 0 on V
    copied = _fold_runs(lanes, v * r, k, n, True)
    assert copied.stride() == (n * k, 1, k)
    assert torch.equal(copied, lanes.reshape(v * r, k, n))
    flat = torch.randn(r, k, n)
    assert _fold_runs(flat, r, k, n, False).data_ptr() == flat.data_ptr()
