"""Stage-structured jobs on the port (``repro_torch.jobs``, ``traces.stages``,
``configs.facebook_4dc_stages``, ``configs.fleet_256.make_serve_grid``)
against ``repro.jobs`` and friends.

Engine parity runs both engines on the same traces: the port's builders
draw an R-run batch, and the JAX engine runs it per run as
``simulate_staged_many`` does (``jax.vmap`` of ``simulate_staged``), the
batch, stage chain and WAN model carried across as numpy arrays (the JAX
builders take seconds each on the CPU; ``dag_from_numpy`` /
``wan_from_numpy`` carry JAX's drawn mix the other way). The JAX kernel
policy runs its Pallas kernel in interpret mode, as its own tests do; the
port's takes the plain version for CPU tensors.

Tolerances:
* decisions (one-hot ``f``) agree exactly, except where the first
  divergence of a run is a near-tie of the deciding scores, recomputed in
  the port on the shared state (1e-5 relative + 1e-4, as
  ``test_torch_simulator``);
* sums and bills: RTOL = 1e-5 relative (ATOL = 1e-4 near zero) — fp32
  sums taken in another order and XLA's dot against torch's matmul;
* within the port, an R-run batch against R single-run calls, and
  ``simulate_staged`` on a one-stage dag against ``simulate``: decisions and
  queues bitwise (both are elementwise), sums SUM_RTOL = 1e-6 (the same
  fp32 values reduced over another shape).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import facebook_4dc_stages as jst
from repro.core import baselines as jb
from repro.core import gmsa as jg
from repro.jobs import dag as jdag
from repro.jobs import engine as je
from repro.jobs import scheduler as jsch
from repro.placement import wan as jw
from repro.telemetry.config import TRACE as J_TRACE
from repro.telemetry.config import TelemetryConfig as JTelemetryConfig
from repro.telemetry.metrics import HistogramSpec as JHistogramSpec
from repro.traces import stages as jstages
from repro_torch import telemetry as tt
from repro_torch.bridge import dag_from_numpy, wan_from_numpy
from repro_torch.configs import facebook_4dc_stages as tst
from repro_torch.configs import fleet_256 as tfl
from repro_torch.core import baselines as tb
from repro_torch.core import gmsa as tg
from repro_torch.core import simulator as ts
from repro_torch.jobs import dag as tdag
from repro_torch.jobs import engine as te
from repro_torch.jobs import scheduler as tsch
from repro_torch.placement import wan as tw
from repro_torch.placement.wan import expected_pull
from repro_torch.traces import stages as tstages

torch.set_float32_matmul_precision("highest")

CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-4
SUM_RTOL = 1e-6
SUMS = ("cost", "energy", "backlog_total", "backlog_avg", "wan_cost", "wan_energy", "wan_gb",
        "completed", "hedge_cost", "hedge_gb", "hedged_jobs")
PAPER = dataclasses.replace(jst.StagedPaperConfig(), t_slots=48)
FLEET = tfl.FleetConfig(n_sites=16, k_types=3, t_slots=24)
HEDGE = 0.9


def _np_fields(nt):
    return {name: np.asarray(getattr(nt, name)) for name in nt._fields}


def _health(t_slots, n):
    """Hand-made (T, N) degraded-mode factor: site 1 a straggler at 0.3 for
    slots 6-17, site 3 down for slots 20-23, site 0 at 0.6 from slot 30."""
    h = np.ones((t_slots, n), np.float32)
    h[6:18, 1] = 0.3
    h[20:24, 3] = 0.0
    h[30:, 0] = 0.6
    return h


def _link_health(t_slots, n):
    """(T, N, N): link 0->2 at half capacity throughout, link 2->1 severed
    for slots 10-13."""
    lh = np.ones((t_slots, n, n), np.float32)
    lh[:, 0, 2] = 0.5
    lh[10:14, 2, 1] = 0.0
    return lh


def _to_jax(nt, cls):
    return cls(*(jnp.asarray(x.numpy()) for x in nt))


def _jax_staged(setup, policy, v, **kw):
    """JAX's engine on the port's R-run batch, per run as
    ``simulate_staged_many`` runs it (a vmap of ``simulate_staged``)."""
    jins = _to_jax(setup.ins, je.SimInputs)
    kw = {k: x if k == "telemetry" else jnp.asarray(x) for k, x in kw.items() if x is not None}
    one = lambda a, m: je.simulate_staged(jins._replace(arrivals=a, mu=m), setup.dag, setup.wan,
                                          policy, jax.random.key(0), v, **kw)
    return jax.vmap(one)(jins.arrivals, jins.mu)


@pytest.fixture(scope="module")
def paper():
    """The staged paper scenario (canonical mix), 48 slots, 4 runs."""
    _, tdag_, twan, build = tst.make_staged_builder(
        dataclasses.replace(tst.StagedPaperConfig(), t_slots=PAPER.t_slots), device=CPU)
    return types.SimpleNamespace(
        ins=build(torch.Generator().manual_seed(3), 4), runs=4, tdag=tdag_, twan=twan,
        dag=_to_jax(tdag_, jdag.StageDag), wan=_to_jax(twan, jw.WanModel),
    )


@pytest.fixture(scope="module")
def fleet():
    """A small fleet (16 sites, 3 types, 24 slots, 3 runs) with a 3-stage
    mix drawn by JAX's ``staged_mix_profile`` and the fleet's own backbone
    (``make_serve_grid``)."""
    _, build = tfl.make_fleet_builder(FLEET, device=CPU)
    mask, compute, sel = jstages.staged_mix_profile(jax.random.key(11), FLEET.k_types, 3, 2)
    dag = jdag.chain_dag(compute, jdag.shuffle_volumes_from_selectivity(100.0, sel), mask)
    _, _, _, up, down, _, _ = tfl.make_serve_grid(FLEET, FLEET.k_types, FLEET.t_slots, device=CPU)
    twan = tw.wan_topology(up, down, energy_per_gb=0.03)
    return types.SimpleNamespace(
        ins=build(torch.Generator().manual_seed(5), 3), runs=3,
        tdag=dag_from_numpy(_np_fields(dag), device=CPU), twan=twan,
        dag=dag, wan=_to_jax(twan, jw.WanModel),
    )


def _scores_at(ins, dag, wan, run, t, s, f_ref, v, kind, hedge):
    """The port's deciding (K, N) scores of stage ``s`` at slot ``t`` of one
    run: the state is the port's own after slots [0, t) (the decisions
    before the first divergence agree), the earlier stages of slot t walk
    ``f_ref``'s decisions."""
    one = ins._replace(arrivals=ins.arrivals[run], mu=ins.mu[run])
    q = torch.zeros(one.mu.shape[-2:] + (dag.s_max,))
    if t:
        past = one._replace(arrivals=one.arrivals[:t], mu=one.mu[:t], omega=one.omega[:t],
                            pue=one.pue[:t])
        pol = (tsch.stage_oblivious(tg.gmsa_policy, pin_map=True) if kind == "oblivious"
               else tsch.make_staged_policy(dag, wan, hedge=hedge))
        q = te.simulate_staged(past, dag, wan, pol, None, v).q_final
    a, mu = one.arrivals[t], one.mu[t]
    wpue = one.omega[t] * one.pue[t]
    e, _ = ts.energy_row(one.r, wpue, one.pue[t], one.p_it)
    if kind == "oblivious":
        return tg.drift_plus_penalty_scores(q.sum(-1), a, mu, e, v)
    mu_st = tsch.stage_service_rates(mu, dag)
    total_in, src = a, one.data_dist
    for u in range(s):
        f_u = torch.from_numpy(f_ref[run, t, :, :, u])
        mu_u = mu_st[..., u]
        if hedge is not None:
            _, boost = tsch.hedge_clone_choice(f_u, mu_u, dag.stage_mask[:, u], hedge)
            mu_u = mu_u + f_u * boost
        total_done, src = tsch.flow_step(q[..., u], f_u, total_in, mu_u)
        total_in = total_done * dag.stage_mask[:, u + 1]
    pull = expected_pull(src, wpue, assume_simplex=True) * wan.energy_per_gb
    return tsch.staged_stage_scores(q[..., s], total_in, mu_st[..., s], e, dag.compute[:, s],
                                    dag.shuffle_gb[:, s], pull, v)


def _first_divergence_is_near_tie(f_port, f_jax, ins, dag, wan, v, kind, hedge=None):
    """Where the decisions first differ in a run (lowest stage first), the
    two picks' scores are within 1e-5 relative (+ 1e-4)."""
    for run in range(f_port.shape[0]):
        diff = np.nonzero((f_port[run] != f_jax[run]).any(axis=(-3, -2, -1)))[0]
        if diff.size == 0:
            continue
        t = int(diff[0])
        s = int(np.nonzero((f_port[run, t] != f_jax[run, t]).any(axis=(0, 1)))[0][0])
        scores = _scores_at(ins, dag, wan, run, t, s, f_jax, v, kind, hedge).numpy()
        for k in np.nonzero((f_port[run, t, :, :, s] != f_jax[run, t, :, :, s]).any(0))[0]:
            i_p = f_port[run, t, :, k, s].argmax()
            i_j = f_jax[run, t, :, k, s].argmax()
            lo = min(scores[k, i_p], scores[k, i_j])
            assert abs(scores[k, i_p] - scores[k, i_j]) <= 1e-5 * abs(lo) + 1e-4, (run, t, s, k)


def _compare(o_port, o_jax, setup, v, kind, hedge=None):
    f_p, f_j = o_port.f_trace.numpy(), np.asarray(o_jax.f_trace)
    assert f_p.shape == f_j.shape
    agree = float((f_p == f_j).all(axis=-3).mean())
    if kind == "fractional":
        assert agree == 1.0
    elif agree < 1.0:
        _first_divergence_is_near_tie(f_p, f_j, setup.ins, setup.tdag, setup.twan, v, kind, hedge)
    assert agree >= 0.999, agree
    for name in SUMS + ("q_final",):
        np.testing.assert_allclose(getattr(o_port, name).numpy(), np.asarray(getattr(o_jax, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


# ---------------------------------------------------------------------------
# The stage chain and its builders
# ---------------------------------------------------------------------------

def test_dag_builders_match_jax():
    rng = np.random.default_rng(0)
    comp = rng.uniform(0.1, 1.0, (4, 3)).astype(np.float32)
    shuf = rng.uniform(0.0, 50.0, (4, 3)).astype(np.float32)
    mask = np.array([[1, 1, 1], [1, 1, 0], [1, 0, 0], [1, 1, 0]], np.float32)
    pairs = [
        (tdag.chain_dag(torch.from_numpy(comp), torch.from_numpy(shuf), torch.from_numpy(mask)),
         jdag.chain_dag(comp, shuf, mask)),
        (tdag.chain_dag(comp.tolist(), shuf.tolist(), device=CPU), jdag.chain_dag(comp, shuf)),
        (tdag.single_stage_dag(5, device=CPU), jdag.single_stage_dag(5)),
        (tdag.map_reduce_dag(3, 7.5, 0.55, 2.0, device=CPU), jdag.map_reduce_dag(3, 7.5, 0.55, 2.0)),
        (tdag.pad_chains(jst.CANONICAL_COMPUTE, jst.CANONICAL_SHUFFLE_GB, device=CPU),
         jdag.pad_chains(jst.CANONICAL_COMPUTE, jst.CANONICAL_SHUFFLE_GB)),
    ]
    for got, want in pairs:
        for name in jdag.StageDag._fields:
            np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
        assert (got.k_types, got.s_max) == (want.k_types, want.s_max)
        np.testing.assert_array_equal(got.n_stages.numpy(), np.asarray(want.n_stages))
        assert got.n_stages.dtype == torch.int32
        tdag.validate_dag(got)
    for bill in (False, True):
        np.testing.assert_allclose(
            tdag.shuffle_volumes_from_selectivity(torch.tensor([100.0, 50.0, 10.0, 1.0]),
                                                  torch.from_numpy(comp), bill).numpy(),
            np.asarray(jdag.shuffle_volumes_from_selectivity(
                jnp.asarray([100.0, 50.0, 10.0, 1.0]), comp, bill)),
            rtol=1e-6)
    with pytest.raises(ValueError, match="same K types"):
        tdag.pad_chains([[1.0]], [[0.0], [0.0]], device=CPU)
    with pytest.raises(ValueError, match="stage count mismatch"):
        tdag.pad_chains([[0.5, 0.5]], [[0.0]], device=CPU)


@pytest.mark.parametrize("bad,msg", [
    ("shape", "inconsistent dag shapes"),
    ("binary", "must be {0, 1}"),
    ("first", "at least one active stage"),
    ("monotone", "monotone"),
    ("compute", "strictly positive compute"),
    ("shuffle", "non-negative"),
])
def test_validate_dag_errors_match_jax(bad, msg):
    comp = np.full((2, 3), 0.5, np.float32)
    shuf = np.zeros((2, 3), np.float32)
    mask = np.ones((2, 3), np.float32)
    if bad == "shape":
        shuf = np.zeros((2, 2), np.float32)
    elif bad == "binary":
        mask[0, 2] = 0.5
    elif bad == "first":
        mask[1] = 0.0
    elif bad == "monotone":
        mask[0] = [1.0, 0.0, 1.0]
    elif bad == "compute":
        comp[1, 1] = 0.0
    else:
        shuf[0, 1] = -1.0
    for mod, make in ((jdag, jnp.asarray), (tdag, torch.from_numpy)):
        dag = mod.StageDag(make(comp), make(shuf), make(mask))
        with pytest.raises(ValueError, match=msg):
            mod.validate_dag(dag)


def test_dag_bridge_checks():
    dag = jdag.pad_chains(jst.CANONICAL_COMPUTE, jst.CANONICAL_SHUFFLE_GB)
    fields = _np_fields(dag)
    got = dag_from_numpy(fields, device=CPU)
    for name in fields:
        assert got.__getattribute__(name).dtype == torch.float32
        np.testing.assert_array_equal(getattr(got, name).numpy(), fields[name])
    with pytest.raises(ValueError, match="stage_mask"):
        dag_from_numpy({**fields, "stage_mask": fields["stage_mask"][:, :2]}, device=CPU)
    with pytest.raises(TypeError, match="dtype"):
        dag_from_numpy({**fields, "stage_mask": fields["stage_mask"].astype(np.int32)}, device=CPU)


def test_stage_traces_shapes_masks_and_clips():
    gen = torch.Generator().manual_seed(0)
    mask = tstages.stage_depth_mask(gen, 5, 4, min_stages=2, device=CPU)
    assert mask.shape == (5, 4) and mask.dtype == torch.float32
    assert bool((mask[:, :-1] >= mask[:, 1:]).all()) and bool((mask.sum(1) >= 2).all())
    comp = tstages.stage_compute_profile(gen, mask)
    torch.testing.assert_close((comp * mask).sum(1), torch.ones(5), rtol=0, atol=1e-5)
    assert bool((comp[mask == 0] == 1.0).all())
    sel = tstages.selectivity_trace(gen, 5, 4, device=CPU)
    assert bool(((sel >= 0.02) & (sel <= 1.2)).all())
    with pytest.raises(ValueError, match="min_stages"):
        tstages.stage_depth_mask(gen, 3, 2, min_stages=3, device=CPU)
    m2, c2, s2 = tstages.staged_mix_profile(torch.Generator().manual_seed(0), 5, 4, device=CPU)
    assert m2.shape == c2.shape == s2.shape == (5, 4)
    tdag.validate_dag(tdag.chain_dag(c2, tdag.shuffle_volumes_from_selectivity(100.0, s2), m2))


def test_stage_traces_match_jax_by_distribution():
    """20000 job types of S = 3 from each side. Depth frequencies within
    0.015 (~5 standard errors of a 1/2 share); the map stage's mean compute
    share in depth-3 rows (Dirichlet mean 0.8/2.8) within 0.005; the clipped
    selectivities' mean log10 within 0.01 and their clip shares within 0.01
    (the log10 std is 0.35, so 60000 draws give a 0.0014 standard error)."""
    k, s = 20000, 3
    m_t, c_t, s_t = (x.numpy() for x in tstages.staged_mix_profile(
        torch.Generator().manual_seed(1), k, s, 2, device=CPU))
    m_j, c_j, s_j = (np.asarray(x) for x in jstages.staged_mix_profile(jax.random.key(1), k, s, 2))
    for d in (2, 3):
        assert abs((m_t.sum(1) == d).mean() - (m_j.sum(1) == d).mean()) < 0.015
    deep_t, deep_j = m_t.sum(1) == 3, m_j.sum(1) == 3
    assert abs(c_t[deep_t, 0].mean() - c_j[deep_j, 0].mean()) < 0.005
    assert abs(c_t[deep_t, 0].mean() - 0.8 / 2.8) < 0.005
    assert abs(np.log10(s_t).mean() - np.log10(s_j).mean()) < 0.01
    for lo_hi in (s_t <= 0.02, s_j <= 0.02), (s_t >= 1.2, s_j >= 1.2):
        assert abs(lo_hi[0].mean() - lo_hi[1].mean()) < 0.01


# ---------------------------------------------------------------------------
# The staged engine against JAX on bridged traces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arm", ["oblivious", "aware", "hedge", "data", "link_health"])
def test_paper_staged_engine_matches_jax(paper, arm):
    v = PAPER.v
    health = link_health = None
    if arm == "oblivious" or arm == "link_health":
        jp, tp, kind = (jsch.stage_oblivious(jg.gmsa_policy, pin_map=True),
                        tsch.stage_oblivious(tg.gmsa_policy, pin_map=True), "oblivious")
    elif arm == "data":
        jp, tp, kind = jb.data_dispatch, tb.data_dispatch, "fractional"
    else:
        hedge = HEDGE if arm == "hedge" else None
        jp = jsch.make_staged_policy(paper.dag, paper.wan, hedge=hedge)
        tp = tsch.make_staged_policy(paper.tdag, paper.twan, hedge=hedge)
        kind = "aware"
        if hedge is not None:
            health = _health(PAPER.t_slots, PAPER.n_sites)
    if arm == "link_health":
        link_health = _link_health(PAPER.t_slots, PAPER.n_sites)
    o_j = _jax_staged(paper, jp, v, health=health, link_health=link_health)
    o_t = te.simulate_staged(paper.ins, paper.tdag, paper.twan, tp, None, v,
                             health=None if health is None else torch.from_numpy(health),
                             link_health=None if link_health is None
                             else torch.from_numpy(link_health))
    _compare(o_t, o_j, paper, v, kind, HEDGE if arm == "hedge" else None)
    assert float(o_t.wan_gb.sum()) > 0.0
    if arm == "hedge":
        assert float(o_t.hedged_jobs.sum()) > 0.0 and float(o_t.hedge_cost.sum()) > 0.0
    if arm == "link_health":
        nominal = te.simulate_staged(paper.ins, paper.tdag, paper.twan, tp, None, v)
        assert bool((o_t.wan_cost >= nominal.wan_cost).all())
        assert bool((o_t.wan_cost > nominal.wan_cost).any())
        for name in ("f_trace", "q_final", "cost", "wan_gb"):
            assert torch.equal(getattr(o_t, name), getattr(nominal, name)), name
    s_t, s_j = te.summarize_staged(o_t), je.summarize_staged(o_j)
    assert s_t.keys() == s_j.keys()
    for name in s_t:
        np.testing.assert_allclose(s_t[name], s_j[name], rtol=RTOL, atol=ATOL, err_msg=name)


def test_fleet_kernel_policy_through_stage_oblivious_matches_jax(fleet):
    """``stage_oblivious(make_kernel_policy(None), pin_map=True)``, the
    card's fleet arm: the kernel policy gets the engine's ``(data_dist,
    wpue, r_t)`` aux on both sides."""
    pin_map = True
    v = FLEET.v
    jp = jsch.stage_oblivious(jg.make_kernel_policy(None), pin_map=pin_map)
    tp = tsch.stage_oblivious(tg.make_kernel_policy(None), pin_map=pin_map)
    assert tp.wants_r and not tp.static_r and not tp.consumes_key
    o_j = _jax_staged(fleet, jp, v)
    o_t = te.simulate_staged(fleet.ins, fleet.tdag, fleet.twan, tp, None, v)
    assert tuple(o_t.f_trace.shape) == (3, FLEET.t_slots, FLEET.n_sites, FLEET.k_types, 3)
    _compare(o_t, o_j, fleet, v, "oblivious")
    assert float(o_t.wan_gb.sum()) > 0.0


def test_fleet_aware_policy_matches_jax(fleet):
    v = FLEET.v
    o_j = _jax_staged(fleet, jsch.make_staged_policy(fleet.dag, fleet.wan), v)
    o_t = te.simulate_staged(fleet.ins, fleet.tdag, fleet.twan,
                             tsch.make_staged_policy(fleet.tdag, fleet.twan), None, v)
    _compare(o_t, o_j, fleet, v, "aware")


def test_staged_telemetry_matches_jax_and_off_is_bitwise(paper):
    """TRACE with a histogram spec: the per-stage streams equal JAX's to
    RTOL; the queue-delay histograms exactly for every stage whose delays
    lie off bucket edges (1e-5 relative, as test_torch_telemetry); the
    outputs bitwise the OFF call's."""
    v = PAPER.v
    spec = JHistogramSpec(0.001, 100.0, 24)
    jcfg = JTelemetryConfig(level=J_TRACE, hist=spec)
    tcfg = tt.TelemetryConfig(level=tt.TRACE, hist=tt.HistogramSpec(spec.lo, spec.hi, spec.n_buckets))
    jp = jsch.make_staged_policy(paper.dag, paper.wan)
    tp = tsch.make_staged_policy(paper.tdag, paper.twan)
    o_j, f_j = _jax_staged(paper, jp, v, telemetry=jcfg)
    off = te.simulate_staged(paper.ins, paper.tdag, paper.twan, tp, None, v)
    for level in (tt.SUMMARY, tt.TRACE):
        o_t, f_t = te.simulate_staged(paper.ins, paper.tdag, paper.twan, tp, None, v,
                                      telemetry=dataclasses.replace(tcfg, level=level))
        for name, a, b in zip(off._fields, o_t, off):
            assert torch.equal(a, b), name
    assert set(f_t.metrics) == set(f_j.metrics) == {
        "q_site", "stage_backlog", "stage_wan_cost", "stage_wan_gb", "queue_delay",
        "queue_delay_hist"}
    for name in ("q_site", "stage_backlog", "stage_wan_cost", "stage_wan_gb", "queue_delay"):
        np.testing.assert_allclose(f_t.metrics[name].numpy(), np.asarray(f_j.metrics[name]),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    torch.testing.assert_close(f_t.metrics["q_site"].sum(-1), off.backlog_total,
                               rtol=SUM_RTOL, atol=1e-4)
    torch.testing.assert_close(f_t.metrics["stage_wan_cost"].sum(-1), off.wan_cost,
                               rtol=1e-5, atol=1e-3)
    delay = np.asarray(f_j.metrics["queue_delay"], np.float64)          # (R, T, S)
    edges = spec.edges()[1:-1]
    near = (np.abs(delay[..., None] - edges) <= 1e-5 * edges).any(-1).any(-2)   # (R, S)
    h_t, h_j = f_t.metrics["queue_delay_hist"].numpy(), np.asarray(f_j.metrics["queue_delay_hist"])
    assert h_t.shape == h_j.shape == (paper.runs, paper.tdag.s_max, spec.n_buckets)
    np.testing.assert_array_equal(h_t[~near], h_j[~near])
    assert (h_t.sum(-1) == PAPER.t_slots).all()
    assert tuple(f_t.ring.count.shape) == (paper.runs,)


# ---------------------------------------------------------------------------
# Within the port: batches, the single-stage identity, hedging per run
# ---------------------------------------------------------------------------

def _per_run(ins, run):
    return ins._replace(arrivals=ins.arrivals[run], mu=ins.mu[run])


@pytest.mark.parametrize("arm", ["oblivious", "aware", "hedge", "kernel"])
def test_batched_runs_equal_single_run_calls(fleet, arm):
    """Every absolute axis of the single-run reference became a negative
    one: an R-run call equals R single-run calls."""
    health = torch.from_numpy(_health(FLEET.t_slots, FLEET.n_sites))
    policy = {
        "oblivious": tsch.stage_oblivious(tg.gmsa_policy, pin_map=True),
        "aware": tsch.make_staged_policy(fleet.tdag, fleet.twan),
        "hedge": tsch.make_staged_policy(fleet.tdag, fleet.twan, hedge=HEDGE),
        "kernel": tsch.stage_oblivious(tg.make_kernel_policy(None), pin_map=True),
    }[arm]
    tel = tt.TelemetryConfig(level=tt.SUMMARY, hist=tt.HistogramSpec())
    both, frame = te.simulate_staged(fleet.ins, fleet.tdag, fleet.twan, policy, None, FLEET.v,
                                     telemetry=tel, health=health)
    for run in range(fleet.runs):
        one, f_one = te.simulate_staged(_per_run(fleet.ins, run), fleet.tdag, fleet.twan, policy,
                                        None, FLEET.v, telemetry=tel, health=health)
        for name in ("f_trace", "q_final"):
            assert torch.equal(getattr(both, name)[run], getattr(one, name)), name
        for name in SUMS:
            torch.testing.assert_close(getattr(both, name)[run], getattr(one, name),
                                       rtol=SUM_RTOL, atol=1e-5)
        for name, x in f_one.metrics.items():
            torch.testing.assert_close(frame.metrics[name][run], x, rtol=SUM_RTOL, atol=1e-5)
    if arm == "hedge":
        assert float(both.hedged_jobs.sum()) > 0.0


def test_hedged_mu_selects_per_run():
    """A hedge that fires in one run boosts that run only: the run in which
    nothing fired keeps its rates bit for bit."""
    rng = np.random.default_rng(0)
    mu = torch.from_numpy(rng.uniform(1.0, 5.0, (2, 4, 3, 2)).astype(np.float32))
    f = torch.zeros(2, 4, 3, 2)
    f[:, 1] = 1.0
    g = torch.zeros(2, 4, 3, 2)
    g[0, 2, 1, 0] = 1.0                                      # run 0 only
    out = te.hedged_mu(f, g, mu)
    assert torch.equal(out[1], mu[1])
    want0 = mu[0].clone()
    want0[1, 1, 0] += mu[0, 2, 1, 0]
    assert torch.equal(out[0], want0)


def test_hedges_fire_in_one_run_only_and_match_jax(paper):
    """Under a hand-made health trace with stragglers and no dead site (site
    1 at 0.3 for slots 6-17, site 0 at 0.6 from slot 30) a hedge completes
    work in run 0 and never in run 1, which carries a tenth of the traffic
    (its queues stay below the degraded rates). The batch equals JAX's
    per-run (vmapped) engine and the port's single-run calls."""
    v = PAPER.v
    health = _health(PAPER.t_slots, PAPER.n_sites)
    health[20:24, 3] = 1.0
    ins = paper.ins._replace(arrivals=paper.ins.arrivals[:2].clone(), mu=paper.ins.mu[:2])
    ins.arrivals[1] *= 0.1
    tp = tsch.make_staged_policy(paper.tdag, paper.twan, hedge=HEDGE)
    o_t = te.simulate_staged(ins, paper.tdag, paper.twan, tp, None, v,
                             health=torch.from_numpy(health))
    hj = o_t.hedged_jobs.numpy()
    assert hj[0].sum() > 0.0 and hj[1].sum() == 0.0
    jp = jsch.make_staged_policy(paper.dag, paper.wan, hedge=HEDGE)
    o_j = _jax_staged(types.SimpleNamespace(ins=ins, dag=paper.dag, wan=paper.wan), jp, v,
                      health=health)
    np.testing.assert_array_equal(o_t.f_trace.numpy(), np.asarray(o_j.f_trace))
    for name in SUMS + ("q_final",):
        np.testing.assert_allclose(getattr(o_t, name).numpy(), np.asarray(getattr(o_j, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    for run in range(2):
        one = te.simulate_staged(_per_run(ins, run), paper.tdag, paper.twan, tp, None, v,
                                 health=torch.from_numpy(health))
        assert torch.equal(one.f_trace, o_t.f_trace[run])
        assert torch.equal(one.q_final, o_t.q_final[run])


@pytest.mark.parametrize("arm", ["gmsa", "kernel", "data", "random", "jsq", "greedy"])
def test_single_stage_dag_reproduces_simulate(fleet, arm):
    """``simulate_staged`` over ``single_stage_dag`` replays the port's own
    ``simulate``: dispatch and queues bitwise, the per-slot sums (summed over
    (N, K, 1) after the loop instead of (N, K) per slot) within SUM_RTOL.
    The reference's own identity test is red on jax 0.9.0, so this holds
    port against port."""
    policy = {"gmsa": tg.gmsa_policy, "kernel": tg.make_kernel_policy(None),
              "data": tb.data_dispatch, "random": tb.random_dispatch,
              "jsq": tb.jsq_dispatch, "greedy": tb.greedy_cost_dispatch}[arm]
    dag = tdag.single_stage_dag(FLEET.k_types, device=CPU)
    gen = lambda: torch.Generator().manual_seed(9)
    base = ts.simulate(fleet.ins, policy, gen(), FLEET.v)
    staged = te.simulate_staged(fleet.ins, dag, fleet.twan, policy, gen(), FLEET.v)
    assert torch.equal(staged.f_trace[..., 0], base.f_trace)
    assert torch.equal(staged.q_final[..., 0], base.q_final)
    for name in ("cost", "energy", "backlog_total", "backlog_avg"):
        torch.testing.assert_close(getattr(staged, name), getattr(base, name),
                                   rtol=SUM_RTOL, atol=1e-6)
    for name in ("wan_cost", "wan_gb", "hedged_jobs"):
        assert float(getattr(staged, name).abs().sum()) == 0.0
    # Conservation: what arrived and is not queued at the end completed.
    torch.testing.assert_close(staged.completed.sum(-2),
                               fleet.ins.arrivals.sum(-2) - base.q_final.sum(-2),
                               rtol=1e-5, atol=1e-2)


def test_engine_contract_errors(paper):
    v = PAPER.v
    with pytest.raises(ValueError, match="dag is for K=5"):
        te.simulate_staged(paper.ins, tdag.single_stage_dag(5, device=CPU), paper.twan,
                           tg.gmsa_policy, None, v)
    t_slots = PAPER.t_slots
    varying = paper.ins._replace(r=paper.ins.r.expand((t_slots,) + tuple(paper.ins.r.shape)))
    with pytest.raises(ValueError, match="static"):
        te.simulate_staged(varying, paper.tdag, paper.twan,
                           tg.make_kernel_policy(paper.ins.r), None, v)
    carried = te.simulate_staged(varying, paper.tdag, paper.twan,
                                 tg.make_kernel_policy(None), None, v)
    static = te.simulate_staged(paper.ins, paper.tdag, paper.twan,
                                tg.make_kernel_policy(None), None, v)
    assert torch.equal(carried.f_trace, static.f_trace)
    bad = tsch.make_staged_policy(paper.tdag, paper.twan)
    bad.state_independent = True
    with pytest.raises(ValueError, match="state-dependent"):
        te.simulate_staged(paper.ins, paper.tdag, paper.twan, bad, None, v)


def test_summarize_staged_any_runs_axis(paper):
    outs = te.simulate_staged(paper.ins, paper.tdag, paper.twan,
                              tsch.make_staged_policy(paper.tdag, paper.twan), None, PAPER.v)
    batch = te.summarize_staged(outs)
    runs = [te.summarize_staged(type(outs)(*(x[i] for x in outs))) for i in range(paper.runs)]
    for name in batch:
        np.testing.assert_allclose(batch[name], np.mean([r[name] for r in runs]), rtol=1e-5,
                                   err_msg=name)
    assert batch["time_avg_total_cost"] == pytest.approx(
        batch["time_avg_compute_cost"] + batch["time_avg_wan_cost"], rel=1e-6)


# ---------------------------------------------------------------------------
# Configs: the staged paper scenario and the fleet's serving grid
# ---------------------------------------------------------------------------

def test_staged_builder_contract_and_canonical_mix():
    cfg = dataclasses.replace(tst.StagedPaperConfig(), t_slots=24)
    tpl, dag, wan, build = tst.make_staged_builder(cfg, device=CPU)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        dataclasses.replace(jst.StagedPaperConfig(), t_slots=24))
    jdag_ = jdag.pad_chains(jst.CANONICAL_COMPUTE, jst.CANONICAL_SHUFFLE_GB)
    for name in jdag.StageDag._fields:
        np.testing.assert_array_equal(getattr(dag, name).numpy(), np.asarray(getattr(jdag_, name)))
    np.testing.assert_array_equal(tpl.data_dist.numpy(),
                                  np.asarray(jst.CANONICAL_DATA_DIST, np.float32))
    shapes = {"arrivals": (24, 3), "mu": (24, 4, 3), "omega": (24, 4), "pue": (24, 4),
              "r": (3, 4, 4), "p_it": (3,), "data_dist": (3, 4)}
    for name in ts.SimInputs._fields:
        assert tuple(getattr(tpl, name).shape) == shapes[name], name
    assert tuple(wan.link_bw.shape) == (4, 4) and float(wan.energy_per_gb) == pytest.approx(0.03)
    assert bool(torch.isinf(wan.link_bw.diagonal()).all())
    ins = build(torch.Generator().manual_seed(0), 3)
    assert tuple(ins.arrivals.shape) == (3, 24, 3) and tuple(ins.mu.shape) == (3, 24, 4, 3)
    assert torch.equal(ins.omega, tpl.omega) and torch.equal(ins.r, tpl.r)
    with pytest.raises(ValueError, match="canonical mix"):
        tst.make_staged_builder(dataclasses.replace(cfg, k_types=4), device=CPU)
    drawn = dataclasses.replace(cfg, k_types=5, mix_seed=3)
    tpl5, dag5, wan5, _ = tst.make_staged_builder(drawn, device=CPU)
    assert tuple(dag5.compute.shape) == (5, 3) and tuple(tpl5.data_dist.shape) == (5, 4)
    assert float(dag5.shuffle_gb[:, 0].abs().sum()) == 0.0
    tdag.validate_dag(dag5)


def test_make_serve_grid_equals_the_fleet_builder_template():
    cfg = tfl.FleetConfig(n_sites=16, k_types=3, t_slots=24)
    tpl, _ = tfl.make_fleet_builder(cfg, device=CPU)
    omega, pue, r, up, down, layout, shares = tfl.make_serve_grid(cfg, cfg.k_types, cfg.t_slots,
                                                                  device=CPU)
    assert torch.equal(omega, tpl.omega) and torch.equal(pue, tpl.pue)
    assert torch.equal(r, tpl.r) and torch.equal(layout, tpl.data_dist)
    assert tuple(up.shape) == tuple(down.shape) == (cfg.n_sites,)
    assert bool(((up >= cfg.bw_lo_gbps) & (up <= cfg.bw_hi_gbps)).all())
    assert shares == tuple(float(x) for x in tfl.fleet_capacity_shares(cfg))
    o2, p2, r2, *_, l2, _ = tfl.make_serve_grid(cfg, 5, 12, device=CPU)
    assert tuple(o2.shape) == tuple(p2.shape) == (12, cfg.n_sites)
    assert tuple(r2.shape) == (5, cfg.n_sites, cfg.n_sites) and tuple(l2.shape) == (5, cfg.n_sites)
