"""Replica selection, drift traces and the run-axis repairs on the port
(``repro_torch.placement.replica``, ``repro_torch.traces.drift``, the
per-run forms of ``core.iridium``, ``core.baselines.static_placement_rule``,
``core.simulator.energy_row`` and the controller's ``epoch_energy_tables``,
``traces.datasets.io_slowdown_from_bandwidth``, and ``gmsa_score`` with one
ratio tensor per run) against the JAX package.

Every batched port call runs R = 3 runs at once against JAX per run.

Tolerances:
* layouts and scores: RTOL = 1e-5 relative, ATOL = 1e-6 — fp32 softmax,
  32 capacity passes and Iridium's bisection, in another summation order
  (XLA's fused reductions against torch's);
* argmin-type outputs (replica choices, the sync ladder's pick): exact;
* within the port, an R-run batch against R single-run calls: bitwise (the
  same elementwise arithmetic and per-row reductions);
* the Dirichlet drift walk by distribution (the row-mixing std within 15%
  of JAX's over many rows), shapes and row sums exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jb
from repro.core import iridium as jir
from repro.core import simulator as jsim
from repro.kernels.gmsa_score import ops as jops
from repro.placement import controller as jc
from repro.placement import replica as jr
from repro.placement import wan as jw
from repro.traces import datasets as jds
from repro.traces import drift as jdrift
from repro_torch.configs.facebook_4dc import PaperSimConfig, make_sim_builder, site_bandwidths
from repro_torch.configs.fleet_256 import FleetConfig, make_fleet_builder, make_serve_grid
from repro_torch.core import baselines as tb
from repro_torch.core import iridium as tir
from repro_torch.core import simulator as tsim
from repro_torch.kernels.gmsa_score import gmsa_score, gmsa_score_phases_ref, gmsa_score_ref
from repro_torch.placement import controller as tc
from repro_torch.placement import replica as tr
from repro_torch.placement import wan as tw
from repro_torch.traces import datasets as tds
from repro_torch.traces import drift as tdrift

torch.set_float32_matmul_precision("highest")

CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-6
R = 3


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def _case(seed, n=6, k=4):
    rng = np.random.default_rng(seed)
    return dict(
        d=rng.dirichlet(np.full(n, 0.7), (R, k)).astype(np.float32),
        mu=rng.uniform(0, 30, (R, n, k)).astype(np.float32),
        q=rng.uniform(0, 10, (R, n, k)).astype(np.float32),
        wpue=rng.uniform(10, 60, n).astype(np.float32),
        up=rng.uniform(0.1, 2.0, n).astype(np.float32),
        down=rng.uniform(0.1, 2.0, n).astype(np.float32),
        sizes=rng.uniform(50, 150, k).astype(np.float32),
    )


def _obs_pair(c, cap, alive=None):
    tobs = tc.SlowObs(wpue_bar=_t(c["wpue"]), mu_bar=_t(c["mu"]), q=_t(c["q"]),
                      sizes_gb=_t(c["sizes"]), capacity_gb=_t(cap),
                      alive=None if alive is None else _t(alive))
    jobs = [jc.SlowObs(wpue_bar=jnp.asarray(c["wpue"]), mu_bar=jnp.asarray(c["mu"][i]),
                       q=jnp.asarray(c["q"][i]), sizes_gb=jnp.asarray(c["sizes"]),
                       capacity_gb=jnp.asarray(cap, jnp.float32),
                       alive=None if alive is None else jnp.asarray(alive, jnp.float32))
            for i in range(R)]
    return tobs, jobs


# ---------------------------------------------------------------------------
# Replica scoring and the adaptive rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capped", [False, True])
def test_hosting_scores_and_target_placement_match_jax(capped):
    c = _case(0)
    n = c["wpue"].shape[0]
    cap = np.full(n, 120.0, np.float32) if capped else np.full(n, np.inf, np.float32)
    share = c["mu"] / c["mu"].sum(-2, keepdims=True)
    share = np.swapaxes(share, -1, -2)
    sc = tr.hosting_scores(_t(c["wpue"]), _t(share), _t(c["up"]), 1.5, 2.0)
    tp = tr.target_placement(sc, _t(c["sizes"]), _t(cap), temp=3.0)
    for i in range(R):
        js = jr.hosting_scores(jnp.asarray(c["wpue"]), jnp.asarray(share[i]),
                               jnp.asarray(c["up"]), 1.5, 2.0)
        _close(sc[i], js)
        _close(tp[i], jr.target_placement(js, jnp.asarray(c["sizes"]), jnp.asarray(cap), temp=3.0))
        assert torch.equal(tr.target_placement(sc[i], _t(c["sizes"]), _t(cap), temp=3.0), tp[i])
    if capped:
        load = (tp * _t(c["sizes"])[:, None]).sum(-2)
        assert float(load.max()) <= 120.0 * 1.01


def test_replica_selection_premium_and_read_cost_match_jax():
    c = _case(1)
    d = c["d"].copy()
    d[0, 0] = [0.995, 0.005, 0, 0, 0, 0]                        # a shard under threshold
    wan_t = tw.wan_topology(_t(c["up"]), _t(c["down"]), 0.02)
    wan_j = jw.wan_topology(jnp.asarray(c["up"]), jnp.asarray(c["down"]), 0.02)
    share = np.swapaxes(c["mu"] / c["mu"].sum(-2, keepdims=True), -1, -2)
    reads = tr.replica_read_assignment(_t(d), wan_t, _t(c["wpue"]), latency_weight=0.5)
    eff = tr.effective_replicas(_t(d))
    prem = tr.replication_premium(_t(d), 0.02)
    sync = tr.sync_cost(_t(d), _t(c["sizes"]), wan_t, _t(c["wpue"]), 0.02)
    read = tr.expected_read_cost(_t(d), _t(c["wpue"]), _t(share))
    assert reads.shape == (R,) + d.shape[1:] + (d.shape[-1],) and sync.shape == (R,)
    for i in range(R):
        dj = jnp.asarray(d[i])
        np.testing.assert_array_equal(
            reads[i].numpy(), np.asarray(jr.replica_read_assignment(dj, wan_j, jnp.asarray(c["wpue"]),
                                                                    latency_weight=0.5)))
        _close(eff[i], jr.effective_replicas(dj))
        _close(prem[i], jr.replication_premium(dj, 0.02))
        _close(sync[i], jr.sync_cost(dj, jnp.asarray(c["sizes"]), wan_j, jnp.asarray(c["wpue"]),
                                     0.02))
        _close(read[i], jr.expected_read_cost(dj, jnp.asarray(c["wpue"]), jnp.asarray(share[i])))
    # A reader holding a live replica serves itself.
    live = d >= tr.REPLICA_THRESHOLD
    diag = torch.diagonal(reads, dim1=-2, dim2=-1).numpy()
    assert (diag[live] == 1.0).all()


@pytest.mark.parametrize("sync_weight", [0.0, 0.5, 50.0])
@pytest.mark.parametrize("faulty", [False, True])
def test_adaptive_rule_matches_jax_per_run(sync_weight, faulty):
    """The rule on (R, N, K) observations: each run's target equals JAX's
    on that run's observation; a dead site gets exactly zero preference."""
    c = _case(2)
    n = c["wpue"].shape[0]
    cap = np.full(n, 200.0, np.float32)
    alive = np.array([1, 0, 1, 1, 0, 1], np.float32) if faulty else None
    tobs, jobs = _obs_pair(c, cap, alive)
    got = tr.make_adaptive_rule(_t(c["up"]), temp=2.5, colo_weight=3.0,
                                sync_weight=sync_weight)(_t(c["d"]), tobs)
    rule_j = jr.make_adaptive_rule(jnp.asarray(c["up"]), temp=2.5, colo_weight=3.0,
                                   sync_weight=sync_weight)
    for i in range(R):
        _close(got[i], rule_j(jnp.asarray(c["d"][i]), jobs[i]), msg=f"run {i}")
    if faulty:
        assert float(got[..., alive == 0].abs().max()) == 0.0


def test_sync_weight_zero_is_exactly_the_single_candidate_rule():
    c = _case(3)
    cap = np.full(6, np.inf, np.float32)
    tobs, _ = _obs_pair(c, cap)
    up = _t(c["up"])
    got = tr.make_adaptive_rule(up, temp=2.0, sync_weight=0.0)(_t(c["d"]), tobs)
    share = (tobs.mu_bar / torch.clamp_min(tobs.mu_bar.sum(-2, keepdim=True), 1e-12)).mT
    want = tr.target_placement(tr.hosting_scores(tobs.wpue_bar, share, up), tobs.sizes_gb,
                               tobs.capacity_gb, temp=2.0)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# Drift traces
# ---------------------------------------------------------------------------

def test_dataset_growth_trace_matches_jax():
    got = tdrift.dataset_growth_trace(6, 3, 100.0, 0.05, device=CPU)
    _close(got, jdrift.dataset_growth_trace(6, 3, 100.0, 0.05), rtol=1e-6, atol=0)
    base = np.array([10.0, 20.0, 30.0], np.float32)
    _close(tdrift.dataset_growth_trace(4, 3, _t(base), 0.1, device=CPU),
           jdrift.dataset_growth_trace(4, 3, jnp.asarray(base), 0.1), rtol=1e-6, atol=0)


def test_ingest_drift_trace_shapes_and_matches_jax_by_distribution():
    """(E, K, N) on the simplex, seeded; with a strong pull toward ``bias``
    the late epochs sit near it in both; the per-epoch step size (std of
    the change of a row between epochs) within 15% of JAX's over 200 types
    x 20 epochs."""
    e, k, n = 20, 200, 5
    got = tdrift.ingest_drift_trace(torch.Generator().manual_seed(1), e, k, n, conc=30.0,
                                    device=CPU)
    want = np.asarray(jdrift.ingest_drift_trace(jax.random.key(1), e, k, n, conc=30.0))
    assert got.shape == (e, k, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-6)
    assert torch.equal(got, tdrift.ingest_drift_trace(torch.Generator().manual_seed(1), e, k, n,
                                                      conc=30.0, device=CPU))
    step = lambda x: np.diff(np.asarray(x), axis=0).std()
    assert abs(step(got) / step(want) - 1.0) < 0.15, (step(got), step(want))
    bias = np.array([0.05, 0.8, 0.05, 0.05, 0.05], np.float32)
    pulled = tdrift.ingest_drift_trace(torch.Generator().manual_seed(2), 8, 50, n,
                                       bias=_t(bias), bias_strength=0.5, device=CPU)
    jpulled = jdrift.ingest_drift_trace(jax.random.key(2), 8, 50, n, bias=jnp.asarray(bias),
                                        bias_strength=0.5)
    np.testing.assert_allclose(pulled[-1].mean(0).numpy(), np.asarray(jpulled[-1]).mean(0),
                               atol=0.05)


# ---------------------------------------------------------------------------
# Run-axis repairs in modules ported earlier
# ---------------------------------------------------------------------------

def test_build_task_allocation_per_run_matches_jax_and_single_runs():
    c = _case(4)
    got = tir.build_task_allocation(_t(c["d"]), _t(c["up"]), _t(c["down"]), 1.0, 0.4, 0.5)
    assert got.shape == c["d"].shape + (c["d"].shape[-1],)
    for i in range(R):
        one = tir.build_task_allocation(_t(c["d"][i]), _t(c["up"]), _t(c["down"]), 1.0, 0.4, 0.5)
        assert torch.equal(got[i], one)
        _close(got[i], jir.build_task_allocation(jnp.asarray(c["d"][i]), jnp.asarray(c["up"]),
                                                 jnp.asarray(c["down"]), 1.0, 0.4, 0.5))


@pytest.mark.parametrize("alive", [None, [1, 1, 0, 1, 1, 0], [1, 1, 1, 1, 1, 1]])
def test_static_placement_rule_per_run_matches_jax(alive):
    c = _case(5)
    cap = np.full(6, np.inf, np.float32)
    tobs, jobs = _obs_pair(c, cap, None if alive is None else np.asarray(alive, np.float32))
    got = tb.static_placement_rule(_t(c["d"]), tobs)
    for i in range(R):
        _close(got[i], jb.static_placement_rule(jnp.asarray(c["d"][i]), jobs[i]), rtol=1e-6)
        assert torch.equal(tb.static_placement_rule(_t(c["d"][i]), tobs), got[i])
    if alive is None or all(alive):
        assert torch.equal(got, _t(c["d"]))


def test_energy_tables_and_rows_per_run():
    """Per-run (R, K, N, N) ratios give the controller (R, T, K, N) tables
    and (R, K, N) rows, each run its own shared-r call's values up to the
    matmul shape (1e-6), and JAX's (1e-5); on a shared r the controller's
    tables are the simulator's, bitwise."""
    rng = np.random.default_rng(6)
    k, n, t = 3, 5, 7
    r = rng.dirichlet(np.ones(n), (R, k, n)).astype(np.float32)
    wpue, pue = rng.uniform(10, 60, (t, n)), rng.uniform(1.0, 1.3, (t, n))
    wpue, pue = wpue.astype(np.float32), pue.astype(np.float32)
    p_it = rng.uniform(0.5, 1.5, k).astype(np.float32)
    ec, er = tc.epoch_energy_tables(_t(r), _t(wpue), _t(pue), _t(p_it))
    assert ec.shape == (R, t, k, n)
    shared = tc.epoch_energy_tables(_t(r[0]), _t(wpue), _t(pue), _t(p_it))
    want = tsim.energy_tables(_t(r[0]), _t(wpue), _t(pue), _t(p_it))
    assert all(torch.equal(a, b) for a, b in zip(shared, want))
    rc, rr = tsim.energy_row(_t(r), _t(wpue[2]), _t(pue[2]), _t(p_it))
    assert rc.shape == (R, k, n)
    for i in range(R):
        jec, jer = jsim.energy_tables(jnp.asarray(r[i]), jnp.asarray(wpue), jnp.asarray(pue),
                                      jnp.asarray(p_it))
        _close(ec[i], jec)
        _close(er[i], jer)
        one = tsim.energy_row(_t(r[i]), _t(wpue[2]), _t(pue[2]), _t(p_it))
        _close(rc[i], one[0].numpy(), rtol=1e-6, atol=0)
        _close(rr[i], one[1].numpy(), rtol=1e-6, atol=0)


def test_io_slowdown_per_run_matches_jax():
    c = _case(7)
    wan_t = tw.wan_topology(_t(c["up"]), _t(c["down"]))
    reads = tr.replica_read_assignment(_t(c["d"]), wan_t, torch.ones(6))
    avg = tds.io_slowdown_from_bandwidth(_t(c["up"]), _t(c["down"]), _t(c["d"]))
    per = tds.io_slowdown_from_bandwidth(_t(c["up"]), _t(c["down"]), _t(c["d"]), reads=reads)
    assert avg.shape == (R, 6) and per.shape == (R, 6, 4)
    for i in range(R):
        ja = jds.io_slowdown_from_bandwidth(jnp.asarray(c["up"]), jnp.asarray(c["down"]),
                                            jnp.asarray(c["d"][i]))
        jp = jds.io_slowdown_from_bandwidth(jnp.asarray(c["up"]), jnp.asarray(c["down"]),
                                            jnp.asarray(c["d"][i]),
                                            reads=jnp.asarray(reads[i].numpy()))
        _close(avg[i], ja)
        _close(per[i], jp)


@pytest.mark.parametrize("cfg,builder", [
    (PaperSimConfig(t_slots=24), make_sim_builder),
    (FleetConfig(n_sites=16, k_types=3, t_slots=24), make_fleet_builder),
])
def test_rebuilds_reproduce_the_template_ratios_bitwise(cfg, builder):
    """The controller's rebuild from the builder's own (up, down) and shares
    is the template's r bit for bit: no jump at the first boundary for
    non-placement reasons."""
    template, _ = builder(cfg, device=CPU)
    if isinstance(cfg, PaperSimConfig):
        up, down = site_bandwidths(cfg, device=CPU)
    else:
        _, _, _, up, down, _, _ = make_serve_grid(cfg, cfg.k_types, cfg.t_slots, device=CPU)
    rebuild = tir.make_allocation_rebuilder(up, down, manager_share=cfg.manager_share,
                                            map_share=cfg.map_share)
    assert torch.equal(rebuild(template.data_dist), template.r)


# ---------------------------------------------------------------------------
# gmsa_score with one ratio tensor per run (the plain versions; the CUDA
# kernel is held against them in tests/test_torch_cuda.py)
# ---------------------------------------------------------------------------

def _score_ops(seed, runs, k, n):
    rng = np.random.default_rng(seed)
    return (_t(rng.random((runs, k, n)) * 100), _t(rng.random((runs, k, n)) * 50),
            _t(rng.random((runs, k)) * 40), _t(rng.random(k) * 10),
            _t(rng.dirichlet(np.ones(n), (runs, k, n))), _t(rng.random(n) * 20))


@pytest.mark.parametrize("runs,k,n", [(3, 8, 32), (2, 1, 4), (4, 3, 17)])
def test_gmsa_score_per_run_r_matches_jax_per_run(runs, k, n):
    """Each run's scores and argmin against the JAX kernel (interpret mode)
    with that run's r: scores 1e-4 (test_kernels.py's tolerance), argmin
    off near-ties; the per-run call equals per-run shared-r calls within
    1e-6 (the matvec is one matmul of another shape); the phases version
    lays the cost workspace out (runs, K, N)."""
    ops = _score_ops(runs * 10 + n, runs, k, n)
    s, b = gmsa_score(*ops)
    q, mu, a, vp, r, wpue = ops
    cost, s_ph, b_ph = gmsa_score_phases_ref(*ops)
    assert cost.shape == (runs, k, n) and torch.equal(b_ph, b)
    for i in range(runs):
        one = gmsa_score_ref(q[i], mu[i], a[i], vp, r[i], wpue)
        _close(s[i], one[0].numpy(), rtol=1e-6, atol=1e-6)
        js, jb_ = jops.gmsa_score(*(jnp.asarray(x.numpy()) for x in (q[i], mu[i], a[i], vp,
                                                                     r[i], wpue)),
                                  interpret=True)
        np.testing.assert_allclose(s[i].numpy(), np.asarray(js), rtol=1e-4, atol=1e-4)
        picked = s[i].numpy()[np.arange(k), np.asarray(jb_)]
        np.testing.assert_allclose(picked, s[i].numpy().min(-1), rtol=1e-5, atol=1e-4)


def test_gmsa_score_refuses_a_ratio_tensor_of_other_runs():
    from repro_torch.kernels.gmsa_score.kernel import gmsa_score_cuda

    ops = _score_ops(0, 3, 2, 8)
    with pytest.raises(TypeError, match="CUDA"):
        gmsa_score_cuda(*ops)
