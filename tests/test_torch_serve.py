"""The serving control plane on the port (``repro_torch.serve.engine``,
``repro_torch.launch.serve``, ``traces.arrivals``' serving tables) against
``repro.serve.engine`` / ``repro.launch.serve`` / ``repro.traces.arrivals``.

Random streams differ between the packages (threefry against torch
generators), so engine parity runs both engines on one scenario: the
reference's ``build_serve_scenario`` draws it, and
``bridge.serve_scenario_from_numpy`` carries it into the port's engine.
The traces (prices, PUE, layout, bandwidths) are seeded numpy; the task
ratios come from the reference's Iridium allocation. Two ``mamba2-2.7b``
classes (smoke executes, full prices) with different prompt lengths.
The reference's kernel dispatch runs its Pallas kernel in interpret mode,
as its own tests do; the port's takes the plain version for CPU tensors.

Tolerances:
* dispatch (one-hot ``f``) exact, except at a near-tie of the port's
  deciding scores at the first divergence (TIE_RTOL = 1e-5 relative +
  TIE_ATOL = 1e-4, chip_smoke's); the series are then compared up to it;
* cost, backlog, served, completed and the history's float values:
  RTOL = 1e-5 relative (ATOL = 1e-6 near zero) — fp32 sums taken in another
  order, XLA's einsum against torch's;
* the WAN bill: WAN_RTOL = 1e-6 relative (the same fused bilinear form);
* port against port (the replay pin, all-ones masks): bitwise, except the
  pin's cost (1e-5 relative), total (1e-6) and backlog (1e-5 relative +
  1e-5), which reduce the same fp32 values over another shape
  (``serve_bench.check_replay``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget
from repro.core.iridium import build_task_allocation as j_allocation
from repro.serve import engine as je
from repro.telemetry.config import SUMMARY as J_SUMMARY
from repro.telemetry.config import TelemetryConfig as JTelemetryConfig
from repro.telemetry.metrics import HistogramSpec as JHistogramSpec
from repro.traces import arrivals as jarr
from repro_torch.benchmarks import serve_bench
from repro_torch.bridge import serve_scenario_from_numpy
from repro_torch.configs import ModelConfig, get_arch
from repro_torch.jobs import scheduler as tsch
from repro_torch.jobs.engine import simulate_staged
from repro_torch.kernels.gmsa_score.ref import gmsa_score_ref
from repro_torch.launch import serve as tl
from repro_torch.placement.wan import expected_pull
from repro_torch.serve import engine as te
from repro_torch.telemetry import (
    SUMMARY,
    HistogramSpec,
    TelemetryConfig,
    fleet_records,
    read_jsonl,
    write_jsonl,
)
from repro_torch.telemetry import report as treport
from repro_torch.traces import arrivals as tarr

torch.set_float32_matmul_precision("highest")

CPU = "cpu"
T = 12
RTOL, ATOL = 1e-5, 1e-6
WAN_RTOL = 1e-6
TIE_RTOL, TIE_ATOL = 1e-5, 1e-4
ARCH = "mamba2-2.7b"
#: (name, prompt_len, gen_len, arrival rate): two classes of one
#: architecture at two request shapes.
CLASSES = (("mamba-short", 32, 8, 4.0), ("mamba-long", 96, 8, 6.0))
ADMIT_MAX = 5.0
HEDGE = 0.35


def _traces(n_pods: int):
    """Seeded numpy (omega, pue, r, up, down, layout); r from the
    reference's Iridium allocation over the layout."""
    rng = np.random.default_rng(100 + n_pods)
    f32 = lambda x: np.asarray(x, np.float32)
    omega = f32(rng.uniform(20.0, 60.0, (T, n_pods)))
    pue = f32(rng.uniform(1.05, 1.25, (T, n_pods)))
    layout = f32(rng.dirichlet(np.full(n_pods, 2.0), len(CLASSES)))
    up, down = f32(rng.uniform(0.5, 5.0, n_pods)), f32(rng.uniform(0.5, 5.0, n_pods))
    r = f32(j_allocation(jnp.asarray(layout), jnp.asarray(up), jnp.asarray(down),
                         manager_share=0.62))
    return omega, pue, r, up, down, layout


def _classes(pkg):
    get = jget if pkg is je else get_arch
    return [pkg.RequestClass(name=name, cfg=get(ARCH, "smoke"), energy_cfg=get(ARCH, "full"),
                             prompt_len=p, gen_len=g, arrival_rate=rate)
            for name, p, g, rate in CLASSES]


def _np_scenario(scn) -> dict:
    fields = lambda nt: {name: np.asarray(getattr(nt, name)) for name in nt._fields}
    return {"inputs": fields(scn.inputs), "dag": fields(scn.dag), "wan": fields(scn.wan),
            **{name: np.asarray(getattr(scn, name))
               for name in ("raw_arrivals", "rejected", "layout", "reads")}}


def _pair(n_pods=4, dispatch="staged", shares=None, alive=None, health=None, link_health=None,
          hedge=None, hist=False, seed=3):
    """(reference engine, port engine) on one scenario: the reference's draw,
    bridged."""
    omega, pue, r, up, down, layout = _traces(n_pods)
    kw = dict(n_pods=n_pods, horizon_slots=T, v=1.0, seed=seed, admit_max=ADMIT_MAX,
              dispatch=dispatch, hedge_threshold=hedge)
    if shares is not None:
        kw["capacity_shares"] = shares
    jfc, tfc = je.FleetConfig(**kw), te.FleetConfig(**kw)
    jrcs = _classes(je)
    jscn = je.build_serve_scenario(jfc, jrcs, omega, pue, r, up=jnp.asarray(up),
                                   down=jnp.asarray(down), layout=jnp.asarray(layout))
    jtel = JTelemetryConfig(level=J_SUMMARY, hist=JHistogramSpec()) if hist else None
    ttel = TelemetryConfig(level=SUMMARY, hist=HistogramSpec()) if hist else None
    jeng = je.FleetEngine(jfc, jrcs, omega, pue, r, up=jnp.asarray(up), down=jnp.asarray(down),
                          layout=jnp.asarray(layout), alive=alive, telemetry=jtel, health=health,
                          link_health=link_health)
    teng = te.FleetEngine(tfc, _classes(te), omega, pue, r, alive=alive, telemetry=ttel,
                          health=health, link_health=link_health,
                          scenario=serve_scenario_from_numpy(_np_scenario(jscn), CPU),
                          device=CPU)
    return jeng, teng


def _deciding_scores(teng, t: int, s: int, f_ref: np.ndarray, hedge=None) -> np.ndarray:
    """The port's (K, N) scores deciding stage ``s`` at slot ``t``, from its
    own state after slots [0, t) (no faults; the slots before the first
    divergence agree); earlier stages of slot t walk ``f_ref``'s picks."""
    scn = teng.scenario
    ins, dag, v = scn.inputs, scn.dag, teng.fcfg.v
    q = torch.zeros(tuple(ins.mu.shape[1:]) + (dag.s_max,))
    if t:
        past = ins._replace(arrivals=ins.arrivals[:t], mu=ins.mu[:t], omega=ins.omega[:t],
                            pue=ins.pue[:t])
        q = simulate_staged(past, dag, scn.wan, teng.policy, None, v).q_final
    a, mu, wpue = ins.arrivals[t], ins.mu[t], ins.omega[t] * ins.pue[t]
    if teng.fcfg.dispatch == "kernel":
        s_ref, _ = gmsa_score_ref(q.sum(-1).mT, mu.mT, a, v * ins.p_it, ins.r, wpue)
        return s_ref.numpy()
    e = torch.einsum("kij,j->ki", ins.r, wpue) * ins.p_it[:, None]
    mu_st = tsch.stage_service_rates(mu, dag)
    total_in, src = a, ins.data_dist
    for u in range(s):
        f_u = torch.from_numpy(f_ref[t, :, :, u])
        mu_u = mu_st[..., u]
        if hedge is not None:
            _, boost = tsch.hedge_clone_choice(f_u, mu_u, dag.stage_mask[:, u], hedge)
            mu_u = mu_u + f_u * boost
        total_done, src = tsch.flow_step(q[..., u], f_u, total_in, mu_u)
        total_in = total_done * dag.stage_mask[:, u + 1]
    pull = expected_pull(src, wpue, assume_simplex=True) * scn.wan.energy_per_gb
    return tsch.staged_stage_scores(q[..., s], total_in, mu_st[..., s], e, dag.compute[:, s],
                                    dag.shuffle_gb[:, s], pull, v).numpy()


def _agreeing_slots(teng, tout, jout, hedge=None, faulty=False, upto=T) -> int:
    """The number of leading slots (of the first ``upto``) on which the two
    dispatch traces agree; a divergence must be a near-tie of the port's
    deciding scores (a run with a fault trace must agree everywhere)."""
    f_t, f_j = tout["dispatch"], jout["dispatch"]
    assert f_t.shape == f_j.shape
    diff = np.nonzero((f_t[:upto] != f_j[:upto]).any(axis=(1, 2, 3)))[0]
    if diff.size == 0:
        return upto
    assert not faulty, f"dispatch diverged at slot {diff[0]} under a fault trace"
    t = int(diff[0])
    s = int(np.nonzero((f_t[t] != f_j[t]).any(axis=(0, 1)))[0][0])
    scores = _deciding_scores(teng, t, s, f_j, hedge)
    for k in np.nonzero((f_t[t, :, :, s] != f_j[t, :, :, s]).any(axis=0))[0]:
        i_t, i_j = f_t[t, :, k, s].argmax(), f_j[t, :, k, s].argmax()
        lo = min(scores[k, i_t], scores[k, i_j])
        assert abs(scores[k, i_t] - scores[k, i_j]) <= TIE_ATOL + TIE_RTOL * abs(lo), (t, s, k)
    return t


def _compare(teng, tout, jout, hedge=None, faulty=False, upto=T):
    n = _agreeing_slots(teng, tout, jout, hedge, faulty, upto)
    close = lambda a, b, name, rtol=RTOL: np.testing.assert_allclose(
        np.asarray(a)[:n], np.asarray(b)[:n], rtol=rtol, atol=ATOL, err_msg=name)
    for name in ("cost", "backlog", "served", "completed", "hedge_cost", "hedged_jobs"):
        close(tout[name], jout[name], name)
    close(tout["wan_cost"], jout["wan_cost"], "wan_cost", WAN_RTOL)
    close(tout["wan_gb"], jout["wan_gb"], "wan_gb", WAN_RTOL)
    for name in ("raw_arrivals", "admitted", "rejected"):
        np.testing.assert_array_equal(tout[name], jout[name], err_msg=name)
    assert len(tout["history"]) == len(jout["history"]) == T
    for h_t, h_j in zip(tout["history"][:n], jout["history"][:n]):
        assert h_t.keys() == h_j.keys(), (h_t.keys(), h_j.keys())
        for key in h_t:
            if key in ("t", "choice", "slo_viol", "admitted", "rejected"):
                assert h_t[key] == h_j[key], (h_t["t"], key)
            elif key == "recovery":
                assert {k: v for k, v in h_t[key].items() if k != "drained"} == \
                       {k: v for k, v in h_j[key].items() if k != "drained"}
                assert h_t[key]["drained"] == pytest.approx(h_j[key]["drained"], rel=RTOL)
            else:
                np.testing.assert_allclose(h_t[key], h_j[key], rtol=RTOL, atol=ATOL,
                                           err_msg=f"{key} at t={h_t['t']}")
    if n == T:
        np.testing.assert_allclose(tout["q_final"], np.asarray(jout["q_final"]), rtol=RTOL,
                                   atol=1e-5)
        assert tout["total_billed_cost"] == pytest.approx(jout["total_billed_cost"], rel=RTOL)
    assert [(e["t"], e["pod"], e["n_died"]) for e in tout["events"]] == \
           [(e["t"], e["pod"], e["n_died"]) for e in jout["events"]]
    for e_t, e_j in zip(tout["events"], jout["events"]):
        assert e_t["drained"] == pytest.approx(e_j["drained"], rel=RTOL)
    return n


@pytest.fixture(scope="module")
def base():
    """The no-fault pairs at 4 and 8 pods, both dispatch modes, run once."""
    out = {}
    for n_pods in (4, 8):
        for dispatch in ("staged", "kernel"):
            jeng, teng = _pair(n_pods, dispatch)
            out[n_pods, dispatch] = (jeng, teng, jeng.run(execute_real=False),
                                     teng.run(execute_real=False))
    return out


# ---------------------------------------------------------------------------
# Arrival tables, admission, request classes, fleet config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rates,shares,headroom", [
    ((4.0, 6.0), (0.3, 0.2, 0.9, 0.6), 1.0),
    ((40.0,) * 8, tuple(np.linspace(0.001, 0.01, 256)), 1.0),
    ((0.5, 2.0, 9.0), (1.0, 0.25), 1.4),
])
def test_serve_rate_tables_bitwise(rates, shares, headroom):
    a_t, m_t = tarr.serve_rate_tables(rates, shares, headroom)
    a_j, m_j = jarr.serve_rate_tables(rates, shares, headroom)
    assert a_t.dtype == m_t.dtype == np.float32
    np.testing.assert_array_equal(a_t, a_j)
    np.testing.assert_array_equal(m_t, m_j)


@pytest.mark.parametrize("admit_max", [None, 5.0, (3.0, 7.5, 0.0)])
def test_admission_split_exact(admit_max):
    rng = np.random.default_rng(7)
    arrivals = rng.poisson(5.0, (48, 3)).astype(np.float32)
    adm, rej = tarr.admission_split(torch.from_numpy(arrivals), None if admit_max is None
                                    else torch.tensor(admit_max))
    adm_j, rej_j = jarr.admission_split(jnp.asarray(arrivals), None if admit_max is None
                                        else jnp.asarray(admit_max))
    np.testing.assert_array_equal(adm.numpy(), np.asarray(adm_j))
    np.testing.assert_array_equal(rej.numpy(), np.asarray(rej_j))
    np.testing.assert_array_equal((adm + rej).numpy(), arrivals)
    if admit_max is not None:
        assert float(rej.sum()) > 0.0


@pytest.mark.parametrize("variant", ["full", "smoke"])
@pytest.mark.parametrize("prompt_len,gen_len", [(32, 8), (96, 24)])
def test_request_class_methods_match_reference(variant, prompt_len, gen_len):
    cfg_t, cfg_j = get_arch(ARCH, variant), jget(ARCH, variant)
    assert cfg_t.active_param_count() == cfg_j.active_param_count() == cfg_t.param_count()
    rc_t = te.RequestClass("c", cfg=get_arch(ARCH, "smoke"), energy_cfg=cfg_t,
                           prompt_len=prompt_len, gen_len=gen_len)
    rc_j = je.RequestClass("c", cfg=jget(ARCH, "smoke"), energy_cfg=cfg_j,
                           prompt_len=prompt_len, gen_len=gen_len)
    for name in ("flops_per_job", "energy_per_job_j", "stage_compute", "kv_gb"):
        assert getattr(rc_t, name)() == getattr(rc_j, name)(), name
    assert rc_t.kv_gb() > 0.0


def test_kv_gb_attention_branch_and_engine_refuses_attention():
    """A port ModelConfig with the reference's qwen2-0.5b fields prices its
    KV cache as the reference does. The engine builds a qwen2-0.5b class
    (smoke executes, full prices), a mamba class priced on qwen and a MoE
    class (executed, or pricing a mamba one); it still refuses a frontend
    class."""
    cfg_j = jget("qwen2-0.5b", "full")
    cfg_t = ModelConfig(**dataclasses.asdict(cfg_j))
    assert cfg_t.has_attention and cfg_t == get_arch("qwen2-0.5b", "full")
    rc_t = te.RequestClass("qwen", cfg=cfg_t, prompt_len=48)
    rc_j = je.RequestClass("qwen", cfg=cfg_j, prompt_len=48)
    assert rc_t.kv_gb() == rc_j.kv_gb() > 0.0
    assert rc_t.stage_compute() == rc_j.stage_compute()
    omega, pue, r, *_ = _traces(4)
    fc = te.FleetConfig(n_pods=4, horizon_slots=T)
    smoke = get_arch(ARCH, "smoke")
    for rc, leaf in ((te.RequestClass("qwen", cfg=get_arch("qwen2-0.5b", "smoke"),
                                      energy_cfg=cfg_t), "wq"),
                     (te.RequestClass("mixed", cfg=smoke, energy_cfg=cfg_t), "w_x")):
        eng = te.FleetEngine(fc, [rc], omega, pue, r[:1], device=CPU)
        assert leaf in eng.params[rc.name]["blocks"]
    moe = dataclasses.replace(get_arch("qwen2-0.5b", "smoke"), num_experts=4, top_k=2)
    for rc, leaf in ((te.RequestClass("moe", cfg=moe), "we_gate"),
                     (te.RequestClass("moe", cfg=smoke, energy_cfg=moe), "w_x")):
        eng = te.FleetEngine(fc, [rc], omega, pue, r[:1], device=CPU)
        assert leaf in eng.params[rc.name]["blocks"]
    vision = dataclasses.replace(get_arch("qwen2-0.5b", "smoke"), frontend="vision")
    for rc in (te.RequestClass("vlm", cfg=vision),
               te.RequestClass("vlm", cfg=smoke, energy_cfg=vision)):
        with pytest.raises(NotImplementedError, match="slice 7b"):
            te.FleetEngine(fc, [rc], omega, pue, r[:1], device=CPU)


def test_fleet_config_cycling_and_errors():
    for pkg in (te, je):
        fc = pkg.FleetConfig(n_pods=8)
        assert len(fc.capacity_shares) == 8
        assert fc.capacity_shares[:4] == fc.capacity_shares[4:]
        assert pkg.FleetConfig(n_pods=3).capacity_shares == (0.3, 0.2, 0.9)
        assert pkg.FleetConfig(n_pods=2, capacity_shares=(1, 2, 3)).capacity_shares == (1.0, 2.0)
    assert te.FleetConfig(n_pods=5) == dataclasses.replace(te.FleetConfig(), n_pods=5)
    for kw, msg in [
        (dict(n_pods=2, capacity_shares=()), "must not be empty"),
        (dict(dispatch="magic"), "unknown dispatch impl"),
        (dict(dispatch="kernel", hedge_threshold=0.5), "requires the staged dispatcher"),
        (dict(hedge_threshold=0.0), "must be > 0"),
    ]:
        for pkg in (te, je):
            with pytest.raises(ValueError, match=msg):
                pkg.FleetConfig(**kw)


# ---------------------------------------------------------------------------
# The engine against the reference, on bridged scenarios
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dispatch", ["staged", "kernel"])
@pytest.mark.parametrize("n_pods", [4, 8])
def test_engine_matches_reference(base, n_pods, dispatch):
    jeng, teng, jout, tout = base[n_pods, dispatch]
    assert tout["dispatch"].shape == (T, n_pods, 2, 2)
    assert _compare(teng, tout, jout) == T
    assert float(tout["rejected"].sum()) > 0.0          # the cap binds
    assert float(tout["wan_gb"].sum()) > 0.0            # decode moves off the prefill mix
    np.testing.assert_allclose(teng.p_it.numpy(), np.asarray(jeng.p_it), rtol=0, atol=0)


@pytest.mark.parametrize("arm", ["death-staged", "death-kernel", "health", "link_health",
                                 "hedge", "hist"])
def test_engine_matches_reference_under_faults_hedging_and_histograms(arm):
    kw, hedge, faulty = {}, None, arm.startswith("death")
    if faulty:
        # Slow pods so the dying pod carries backlog at its death edge.
        alive = np.ones((T, 4), np.float32)
        alive[6:, 1] = 0.0
        kw = dict(dispatch=arm.split("-")[1], shares=(0.1,) * 4, alive=alive)
    elif arm in ("health", "hedge"):
        health = np.ones((T, 4), np.float32)
        health[3:, 2] = 0.12
        health[5:9, 0] = 0.5
        kw = dict(health=health)
        if arm == "hedge":
            hedge = kw["hedge"] = HEDGE
    elif arm == "link_health":
        lh = np.ones((T, 4, 4), np.float32)
        lh[2:9] = 0.5                     # every link at half capacity
        lh[4:6, 2, 3] = 0.25
        kw = dict(link_health=lh)
    else:
        kw = dict(hist=True)
    jeng, teng = _pair(4, **kw)
    jout, tout = jeng.run(execute_real=False), teng.run(execute_real=False)
    upto = T
    if faulty:
        # The reference's kernel dispatch prices from the raw (r, wpue) and
        # never sees a dead pod's 1e30 energy: under this overload the dead
        # pod's zero backlog wins the decode argmin, and the wipe destroys
        # what it is sent (ROADMAP §3). The port moves that mass to the
        # survivors; the two agree on every slot before it.
        on_dead = np.nonzero(np.asarray(jout["dispatch"])[6:, 1].any(axis=(1, 2)))[0]
        if arm == "death-kernel":
            assert on_dead.size > 0
            upto = 6 + int(on_dead[0])
        else:
            assert on_dead.size == 0
    assert _compare(teng, tout, jout, hedge, faulty, upto) == upto
    if faulty:
        ev = tout["events"]
        assert len(ev) == 1 and ev[0]["t"] == 6 and ev[0]["pod"] == 1 and ev[0]["drained"] > 0.0
        assert float(np.abs(tout["dispatch"][6:, 1]).max()) == 0.0
        assert float(tout["q_final"][1].sum()) == 0.0
        assert all(h["q_pod"][1] == 0.0 for h in tout["history"][6:])
        np.testing.assert_allclose(tout["dispatch"].sum(axis=1), 1.0, atol=1e-6)
        assert serve_bench.check_conservation(tout) <= serve_bench.CONSERVE_RTOL
    if arm == "hedge":
        assert float(tout["hedged_jobs"].sum()) > 0.0 and float(tout["hedge_cost"].sum()) > 0.0
    if arm == "link_health":
        nominal = _pair(4)[1].run(execute_real=False)
        assert (tout["wan_cost"] >= nominal["wan_cost"]).all()
        assert (tout["wan_cost"] > nominal["wan_cost"]).any()
    if arm == "hist":
        np.testing.assert_allclose(tout["sojourn_hist"], np.asarray(jout["sojourn_hist"]),
                                   rtol=RTOL, atol=1e-4)
        assert tout["class_names"] == jout["class_names"]
        assert tout["sojourn_spec"] == jout["sojourn_spec"]
        for p_t, p_j in zip(tout["sojourn_percentiles"], jout["sojourn_percentiles"]):
            assert p_t.keys() == p_j.keys()
            for key in p_t:
                assert p_t[key] == pytest.approx(p_j[key], rel=1e-4, abs=1e-4), key
        np.testing.assert_allclose(tout["sojourn_hist"].sum(axis=-1),
                                   tout["completed"].sum(axis=0), rtol=1e-5)


def test_high_v_prefers_cheap_pods():
    """The reference's ``test_engine`` property, on the port's class."""
    o1 = tl.build_engine([ARCH], slots=24, v=0.001, seed=5, arrival=4.0,
                         device=CPU).run(execute_real=False)
    o2 = tl.build_engine([ARCH], slots=24, v=1000.0, seed=5, arrival=4.0,
                         device=CPU).run(execute_real=False)
    assert o2["mean_cost"] <= o1["mean_cost"] * 1.001


# ---------------------------------------------------------------------------
# Port against port: the replay pin, masks, conservation, execution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arm", ["staged", "kernel", "degraded", "hedge", "hist"])
def test_dispatch_replays_simulate_staged(base, arm):
    if arm in ("staged", "kernel"):
        teng, tout = base[8, arm][1], base[8, arm][3]
    else:
        health = np.ones((T, 4), np.float32)
        health[3:, 2] = 0.12
        lh = np.ones((T, 4, 4), np.float32)
        lh[2:9, 0, 1] = 0.5
        kw = {"degraded": dict(health=health, link_health=lh),
              "hedge": dict(health=health, hedge=HEDGE), "hist": dict(hist=True)}[arm]
        teng = _pair(4, **kw)[1]
        tout = teng.run(execute_real=False)
    scn = teng.scenario
    outs = simulate_staged(scn.inputs, scn.dag, scn.wan, teng.policy, None, teng.fcfg.v,
                           link_health=None if teng.link_health is None
                           else torch.from_numpy(teng.link_health))
    np.testing.assert_array_equal(tout["dispatch"], outs.f_trace.numpy())
    np.testing.assert_array_equal(tout["wan_cost"], outs.wan_cost.numpy())
    np.testing.assert_allclose(tout["cost"], outs.cost.numpy(), rtol=1e-5, atol=0)
    total = float(outs.cost.sum() + outs.wan_cost.sum() + outs.hedge_cost.sum())
    assert tout["total_billed_cost"] == pytest.approx(total, rel=1e-6)
    np.testing.assert_allclose(tout["backlog"], outs.backlog_total.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tout["hedge_cost"], outs.hedge_cost.numpy(), rtol=1e-5, atol=0)
    if teng.link_health is None:
        assert serve_bench.check_replay(teng, tout)["cost_rel"] <= serve_bench.COST_RTOL


@pytest.mark.parametrize("mask", ["alive", "health", "link_health"])
@pytest.mark.parametrize("dispatch", ["staged", "kernel"])
def test_all_ones_masks_are_bitwise(base, mask, dispatch):
    _, teng, _, out = base[4, dispatch]
    shape = (T, 4, 4) if mask == "link_health" else (T, 4)
    eng = te.FleetEngine(teng.fcfg, teng.classes, teng.omega, teng.pue, teng.r,
                         scenario=teng.scenario, device=CPU,
                         **{mask: np.ones(shape, np.float32)})
    out1 = eng.run(execute_real=False)
    for name in ("dispatch", "cost", "wan_cost", "backlog", "q_final", "served", "completed"):
        np.testing.assert_array_equal(out[name], out1[name], err_msg=name)
    assert out["history"] == out1["history"]
    assert out1["events"] == []


def test_request_conservation_and_served_priced_energy(base):
    jeng, teng, _, out = base[4, "staged"]
    np.testing.assert_array_equal(out["raw_arrivals"], out["admitted"] + out["rejected"])
    assert (out["admitted"] <= ADMIT_MAX).all()
    assert serve_bench.check_conservation(out) <= serve_bench.CONSERVE_RTOL
    e_per_job = np.asarray([rc.energy_per_job_j() for rc in teng.classes])
    hist_e = np.asarray([h["energy_j"] for h in out["history"]])
    np.testing.assert_allclose(hist_e, out["served"] * e_per_job[None, :], rtol=1e-6)
    assert (hist_e.sum(axis=0) <= e_per_job * out["admitted"].sum(axis=0) + 1e-6).all()
    np.testing.assert_allclose([sum(h["q_pod"]) for h in out["history"]], out["backlog"],
                               rtol=1e-5)
    for t, h in enumerate(out["history"]):
        np.testing.assert_array_equal(h["choice"], out["dispatch"][t][:, :, -1].argmax(axis=0))
    # Prefill stays pinned to the replica-read serving distribution.
    serve_dist = teng.scenario.inputs.data_dist.numpy()
    np.testing.assert_allclose(teng.scenario.reads.numpy().mean(axis=1), serve_dist, atol=1e-6)
    for t in range(T):
        np.testing.assert_allclose(out["dispatch"][t][:, :, 0], serve_dist.T, atol=1e-6)


def test_scenario_draw_is_seeded_and_matches_the_reference_by_distribution():
    """The port draws its own scenario (torch generator): same seed, same
    draw; another seed, another; the admission split and shapes as the
    reference's; arrival and capacity means as the tables say."""
    omega, pue, r, up, down, layout = _traces(4)
    rcs = _classes(te)
    fc = te.FleetConfig(n_pods=4, horizon_slots=400, seed=3, admit_max=ADMIT_MAX)
    build = lambda f: te.build_serve_scenario(f, rcs, omega, pue, r, up=up, down=down,
                                              layout=layout, device=CPU)
    s1, s2 = build(fc), build(fc)
    s3 = build(dataclasses.replace(fc, seed=4))
    assert torch.equal(s1.raw_arrivals, s2.raw_arrivals) and torch.equal(s1.inputs.mu, s2.inputs.mu)
    assert not torch.equal(s1.raw_arrivals, s3.raw_arrivals)
    assert torch.equal(s1.raw_arrivals, s1.inputs.arrivals + s1.rejected)
    assert tuple(s1.inputs.omega.shape) == (400, 4)
    torch.testing.assert_close(s1.inputs.omega[T:2 * T], torch.from_numpy(omega))
    jscn = je.build_serve_scenario(je.FleetConfig(n_pods=4, horizon_slots=400, seed=3,
                                                  admit_max=ADMIT_MAX), _classes(je),
                                   omega, pue, r, up=jnp.asarray(up), down=jnp.asarray(down),
                                   layout=jnp.asarray(layout))
    for name in ("dag", "wan"):
        for field, a, b in zip(getattr(s1, name)._fields, getattr(s1, name), getattr(jscn, name)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, err_msg=field)
    for name in ("layout", "reads"):
        np.testing.assert_array_equal(getattr(s1, name).numpy(), np.asarray(getattr(jscn, name)))
    np.testing.assert_allclose(s1.inputs.data_dist.numpy(), np.asarray(jscn.inputs.data_dist))
    np.testing.assert_allclose(s1.inputs.p_it.numpy(), np.asarray(jscn.inputs.p_it), rtol=0)
    # Means over 400 slots: Poisson sd / sqrt(400) = 0.1 sd per class.
    rates = np.asarray([c[3] for c in CLASSES])
    np.testing.assert_allclose(s1.raw_arrivals.numpy().mean(0), rates, rtol=0.1)
    mu_mean = np.asarray(fc.capacity_shares)[:, None] * rates.sum() / len(rates)
    np.testing.assert_allclose(s1.inputs.mu.numpy().mean(0), np.broadcast_to(mu_mean, (4, 2)),
                               rtol=0.15)


def test_execute_jobs_runs_exact_counts(base):
    _, teng, _, _ = base[4, "staged"]
    b = teng.fcfg.batch_per_exec
    for rc in teng.classes:
        for n_jobs in (1, b - 1, b, b + 1, 2 * b + 3):
            done, secs = teng._execute_jobs(rc, n_jobs)
            assert done == n_jobs and secs > 0.0, (n_jobs, done)
        assert teng._execute_jobs(rc, 0) == (0, 0.0)


def test_run_executes_the_drained_jobs_through_the_model():
    eng = tl.build_engine([ARCH], slots=6, v=1.0, seed=3, arrival=4.0, device=CPU)
    calls = {"prefill": [], "decode": 0}
    pre, dec = eng._prefill[ARCH], eng._decode[ARCH]
    vocab = eng.classes[0].cfg.vocab_size

    def prefill(params, tokens):
        calls["prefill"].append(tokens.shape[0])
        logits, cache = pre(params, tokens)
        assert bool(torch.isfinite(logits).all())
        return logits, cache

    def decode(params, cache, tok):
        calls["decode"] += 1
        assert bool(((tok >= 0) & (tok < vocab)).all())
        return dec(params, cache, tok)

    eng._prefill[ARCH], eng._decode[ARCH] = prefill, decode
    out = eng.run(execute_real=True)
    want = [min(int(round(c)), eng.fcfg.exec_cap) for c in out["completed"][:, 0]]
    assert out["exec_jobs"] == sum(want) > 0 and out["exec_seconds"] > 0.0
    b = eng.fcfg.batch_per_exec
    assert calls["prefill"] == [min(b, n - i) for n in want for i in range(0, n, b)]
    assert calls["decode"] == len(calls["prefill"]) * eng.classes[0].gen_len
    assert set(out["timing"]) == {"enqueue", "readback", "record", "execute", "bill"}
    assert out["timing"]["execute"] == out["exec_seconds"]


def test_stream_reaches_the_callback_in_slot_order():
    base_eng = tl.build_engine([ARCH], slots=T, v=1.0, seed=3, arrival=6.0, device=CPU)
    fc = te.FleetConfig(n_pods=4, horizon_slots=T, v=1.0, seed=3, capacity_shares=(0.1,) * 4)
    alive = np.ones((T, 4), np.float32)
    alive[6:, 1] = 0.0
    eng = te.FleetEngine(fc, base_eng.classes, base_eng.omega, base_eng.pue, base_eng.r,
                         alive=alive, device=CPU)
    seen = []
    out = eng.run(execute_real=False, stream=seen.append)
    kinds = [(r["type"], r["t"]) for r in seen]
    assert [t for kind, t in kinds if kind == "metric"] == list(range(T))
    idx = kinds.index(("event", 6))
    assert kinds[idx - 1] == ("metric", 6) and len(kinds) == T + 1
    ev = seen[idx]
    assert ev["code"] == "recovery" and ev["pod"] == 1 and ev["engine"] == "serve"
    assert ev["drained"] == out["events"][0]["drained"] > 0.0
    for rec, c, b in zip([r for r in seen if r["type"] == "metric"], out["cost"], out["backlog"]):
        assert rec["engine"] == "serve"
        assert rec["cost"] == pytest.approx(float(c), rel=1e-5, abs=1e-12)
        assert rec["backlog"] == pytest.approx(float(b), rel=1e-6)
    # Streaming reads one more value per slot back; the run is unchanged.
    again = eng.run(execute_real=False)
    for name in ("dispatch", "cost", "backlog", "wan_cost"):
        np.testing.assert_array_equal(out[name], again[name], err_msg=name)


def test_fleet_records_pass_the_report_check(base, tmp_path):
    teng = _pair(4, hist=True)[1]
    out = teng.run(execute_real=False)
    recs = fleet_records(out, meta={"slo_backlog": teng.fcfg.slo_backlog})
    assert recs[0]["type"] == "meta" and recs[0]["kind"] == "serve"
    assert [r["t"] for r in recs if r["type"] == "metric"] == list(range(T))
    assert recs[-1]["total_billed_cost"] == pytest.approx(out["total_billed_cost"])
    path = tmp_path / "serve.jsonl"
    write_jsonl(recs, path)
    assert len(read_jsonl(path)) == len(recs)
    assert treport.main([str(path), "--check", "--percentiles"]) == 0


@pytest.mark.parametrize("args", [
    ["--dispatch", "kernel", "--pods", "8"],
    ["--kill", "1:3", "--admit-max", "5"],
    ["--straggle", "2:2:0.2", "--hedge", "0.35"],
])
def test_launcher_main_runs_on_the_cpu(args, capsys):
    out = tl.main(["--slots", "6", "--no-exec", "--device", "cpu"] + args)
    text = capsys.readouterr().out
    assert "device=cpu" in text and "total billed" in text
    assert out["exec_jobs"] == 0 and out["dispatch"].shape[0] == 6
    if "--kill" in args:
        assert [(e["t"], e["pod"]) for e in out["events"]] == [(3, 1)]
        assert "recovery event" in text
    if "--hedge" in args:
        assert "hedge bill" in text


def test_bridge_and_engine_check_shapes():
    jeng, teng = _pair(4)
    good = _np_scenario(jeng.scenario)
    with pytest.raises(ValueError, match="'reads' has shape"):
        serve_scenario_from_numpy({**good, "reads": good["reads"][:, :2]}, CPU)
    with pytest.raises(TypeError, match="not a numpy array"):
        serve_scenario_from_numpy({**good, "layout": list(good["layout"])}, CPU)
    for name, shape in (("alive", (T, 3)), ("health", (T + 1, 4)), ("link_health", (T, 4))):
        with pytest.raises(ValueError, match="must be"):
            te.FleetEngine(teng.fcfg, teng.classes, teng.omega, teng.pue, teng.r,
                           scenario=teng.scenario, device=CPU,
                           **{name: np.ones(shape, np.float32)})
    with pytest.raises(ValueError, match="scenario mu"):
        te.FleetEngine(dataclasses.replace(teng.fcfg, horizon_slots=T + 1), teng.classes,
                       teng.omega, teng.pue, teng.r, scenario=teng.scenario, device=CPU)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable here")
    omega, pue, r, *_ = _traces(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        te.FleetEngine(te.FleetConfig(n_pods=4, horizon_slots=T), _classes(te), omega, pue, r)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tl.build_engine([ARCH], slots=4, v=1.0)
