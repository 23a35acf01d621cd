"""The two-timescale placement controller on the port, no faults
(``repro_torch.placement.controller``, ``core.sweep.sweep_placed_budgets``,
the staged engine fed by the controller) against ``repro.placement`` and
friends.

Parity runs both controllers on the same traces: the port's paper builder
draws an R = 3 run batch over 96 slots (W = 24: four epochs), and the JAX
controller runs each run as ``simulate_placed_many`` would (one call per
run; the jit cache serves the three). The drift trace, sizes and
bandwidths cross as numpy arrays.

Tolerances:
* one-hot decisions (GMSA, GREEDY, the kernel policy): exact on these
  seeds (every divergence would be a near-tie of fp32 scores; none occurs);
  fractional DATA: 1e-5 relative (it is the layout);
* layouts, ratios, bills and sums: RTOL = 1e-5 relative, ATOL = 1e-4 —
  fp32 reductions in another order (XLA's fused ones against torch's), and
  the per-epoch rule's 32 capacity passes;
* RANDOM by distribution (every column a split of the slot's integral
  arrivals, the mean share per site within 0.02 of 1/N over runs and
  slots) and its layouts exactly as the other arms' (the rule never reads
  the dispatch);
* within the port, bitwise: W >= T against ``simulate``, an R-run batch
  against R single-run calls, ``move_budget=None`` against the config's
  value as a tensor, budget-sweep lanes against per-budget calls (decisions,
  queues, layouts, ratios; the sums within 1e-6, reduced over a larger
  batch).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jb
from repro.core import gmsa as jg
from repro.core import simulator as jsim
from repro.jobs import dag as jdag_mod
from repro.jobs import engine as je
from repro.jobs import scheduler as jsch
from repro.placement import controller as jc
from repro.placement import replica as jr
from repro.placement import wan as jw
from repro_torch.configs.facebook_4dc import PaperSimConfig, make_sim_builder, site_bandwidths
from repro_torch.configs.facebook_4dc_stages import StagedPaperConfig, make_staged_builder
from repro_torch.core import baselines as tb
from repro_torch.core import gmsa as tg
from repro_torch.core.simulator import simulate
from repro_torch.core.sweep import sweep_placed_budgets
from repro_torch.jobs import make_staged_policy, simulate_staged, summarize_staged
from repro_torch.placement import (
    PlacedOutputs,
    PlacementConfig,
    make_adaptive_rule,
    simulate_placed,
    simulate_placed_many,
    summarize_placed,
)
from repro_torch.traces.drift import dataset_growth_trace, ingest_drift_trace

torch.set_float32_matmul_precision("highest")

CPU = "cpu"
R = 3
T, W = 96, 24
RTOL, ATOL = 1e-5, 1e-4
SUM_RTOL = 1e-6
PAPER = PaperSimConfig(t_slots=T)
SUMS = ("cost", "energy", "backlog_total", "backlog_avg", "q_final", "placements", "r_trace",
        "wan_cost", "wan_energy", "wan_gb", "wan_latency_s", "sync_cost", "recovery_cost",
        "recovery_gb", "mu_scale")
CAP = (220.0, 220.0, 220.0, 220.0)

# JAX policies and configs made once, so that the jit cache serves every test.
J_GMSA = jg.dispatch_fn(PAPER.v)
J_KERNEL = jg.make_kernel_policy(None, interpret=True)
T_GMSA = tg.dispatch_fn(PAPER.v)


def _pcfg(cls, **kw):
    return cls(epoch_slots=kw.pop("epoch_slots", W), growth=0.25,
                               manager_share=PAPER.manager_share, map_share=PAPER.map_share,
                               **kw)


@pytest.fixture(scope="module")
def paper():
    template, build = make_sim_builder(PAPER, device=CPU)
    up, down = site_bandwidths(PAPER, device=CPU)
    ins = build(torch.Generator().manual_seed(3), R)
    ingest = ingest_drift_trace(torch.Generator().manual_seed(7), T // W, 1, 4,
                                bias=torch.tensor([0.05, 0.8, 0.05, 0.10]), bias_strength=0.5,
                                device=CPU)
    sizes = dataset_growth_trace(T // W, 1, 100.0, 0.05, device=CPU)
    jup, jdown = jnp.asarray(up.numpy()), jnp.asarray(down.numpy())
    return dict(
        template=template, build=build, ins=ins, up=up, down=down, ingest=ingest, sizes=sizes,
        jup=jup, jdown=jdown,
        t_rule=make_adaptive_rule(up), j_rule=jr.make_adaptive_rule(jup),
        t_sync=make_adaptive_rule(up, sync_weight=0.5), j_sync=jr.make_adaptive_rule(jup,
                                                                                    sync_weight=0.5),
    )


def _jax_placed(paper, policy, rule, cfg, **kw):
    """JAX's controller on the port's R-run batch, one call per run."""
    ins = paper["ins"]
    kw = {k: (v if k == "telemetry" or not isinstance(v, torch.Tensor)
              else jnp.asarray(v.numpy())) for k, v in kw.items() if v is not None}
    outs = []
    for i in range(R):
        one = jsim.SimInputs(*(jnp.asarray((x[i] if name in ("arrivals", "mu") else x).numpy())
                               for name, x in zip(ins._fields, ins)))
        outs.append(jc.simulate_placed(one, paper["jup"], paper["jdown"], policy, rule,
                                       jax.random.key(0), cfg, **kw))
    return jax.tree_util.tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *outs)


def _compare(got, want, decisions="exact"):
    f_p, f_j = got.f_trace.numpy(), np.asarray(want.f_trace)
    assert f_p.shape == f_j.shape
    if decisions == "exact":
        np.testing.assert_array_equal(f_p, f_j)
    else:
        np.testing.assert_allclose(f_p, f_j, rtol=RTOL, atol=1e-6)
    for name in SUMS:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


ARMS = {
    # name: (port policy, JAX policy, rule key, config kwargs, decisions)
    "gmsa_static": (T_GMSA, J_GMSA, "static", {}, "exact"),
    "gmsa_adaptive": (T_GMSA, J_GMSA, "rule", {"capacity_gb": CAP}, "exact"),
    "gmsa_sync": (T_GMSA, J_GMSA, "sync", {"capacity_gb": CAP}, "exact"),
    "data_adaptive": (tb.data_dispatch, jb.data_dispatch, "rule", {}, "fractional"),
    "greedy_adaptive": (tb.greedy_cost_dispatch, jb.greedy_cost_dispatch, "rule", {}, "exact"),
    "kernel_adaptive": (tg.make_kernel_policy(None), J_KERNEL, "rule", {}, "exact"),
    "io_coupling": (T_GMSA, J_GMSA, "rule", {"io_coupling": True}, "exact"),
    "io_per_reader": (T_GMSA, J_GMSA, "rule", {"io_coupling": True, "io_per_reader": True},
                      "exact"),
}


def _rules(paper, key):
    if key == "static":
        return tb.static_placement_rule, jb.static_placement_rule
    return paper[f"t_{key}"], paper[f"j_{key}"]


@pytest.mark.parametrize("arm", list(ARMS))
def test_placed_controller_matches_jax(paper, arm):
    t_pol, j_pol, rule_key, kw, decisions = ARMS[arm]
    t_rule, j_rule = _rules(paper, rule_key)
    got = simulate_placed(paper["ins"], paper["up"], paper["down"], t_pol, t_rule, None,
                          _pcfg(PlacementConfig, **kw), scalar=PAPER.v, ingest=paper["ingest"],
                          sizes_gb=paper["sizes"])
    want = _jax_placed(paper, j_pol, j_rule, _pcfg(jc.PlacementConfig, **kw), scalar=PAPER.v,
                       ingest=paper["ingest"], sizes_gb=paper["sizes"])
    _compare(got, want, decisions)
    assert float(got.wan_gb[:, 1:].sum()) > 0.0 or rule_key == "static"


def test_placed_move_budget_override_matches_jax(paper):
    """A traced move budget (JAX) against the port's tensor override."""
    got = simulate_placed(paper["ins"], paper["up"], paper["down"], T_GMSA, paper["t_rule"], None,
                          _pcfg(PlacementConfig), scalar=PAPER.v, ingest=paper["ingest"],
                          move_budget=torch.tensor(0.8))
    want = _jax_placed(paper, J_GMSA, paper["j_rule"], _pcfg(jc.PlacementConfig), scalar=PAPER.v,
                       ingest=paper["ingest"], move_budget=jnp.float32(0.8))
    _compare(got, want)


def test_random_policy_matches_jax_by_distribution(paper):
    got = simulate_placed(paper["ins"], paper["up"], paper["down"], tb.random_dispatch,
                          paper["t_rule"], torch.Generator().manual_seed(1),
                          _pcfg(PlacementConfig), ingest=paper["ingest"])
    want = _jax_placed(paper, jb.random_dispatch, paper["j_rule"], _pcfg(jc.PlacementConfig),
                       ingest=paper["ingest"])
    np.testing.assert_allclose(got.placements.numpy(), want.placements, rtol=RTOL, atol=1e-6)
    f = got.f_trace.numpy()
    a = paper["ins"].arrivals.numpy()
    np.testing.assert_allclose(f.sum(-2), 1.0, rtol=1e-6)
    counts = f * a[:, :, None, :]
    np.testing.assert_allclose(counts, np.round(counts), atol=1e-3)
    for share in (f.mean(axis=(0, 1, 3)), np.asarray(want.f_trace).mean(axis=(0, 1, 3))):
        np.testing.assert_allclose(share, 0.25, atol=0.02)


# ---------------------------------------------------------------------------
# Identities, port against port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", [
    pytest.param(T_GMSA, id="gmsa"), pytest.param(tb.data_dispatch, id="data"),
    pytest.param(tb.random_dispatch, id="random"),
    pytest.param(tb.greedy_cost_dispatch, id="greedy"),
    pytest.param(tg.make_kernel_policy(None), id="kernel"),
])
@pytest.mark.parametrize("rule", ["static", "adaptive"])
def test_w_geq_t_reproduces_simulate_bitwise(paper, policy, rule):
    t_rule = tb.static_placement_rule if rule == "static" else paper["t_rule"]
    gen = lambda: torch.Generator().manual_seed(5)
    placed = simulate_placed(paper["ins"], paper["up"], paper["down"], policy, t_rule, gen(),
                             _pcfg(PlacementConfig, epoch_slots=2 * T), scalar=PAPER.v)
    base = simulate(paper["ins"], policy, gen(), PAPER.v)
    for name in base._fields:
        assert torch.equal(getattr(placed, name), getattr(base, name)), name
    assert placed.placements.shape == (R, 1, 1, 4) and float(placed.wan_gb.abs().sum()) == 0.0


def test_runs_batch_equals_single_run_calls(paper):
    cfg = _pcfg(PlacementConfig, capacity_gb=CAP)
    batch = simulate_placed(paper["ins"], paper["up"], paper["down"], T_GMSA, paper["t_rule"],
                            None, cfg, scalar=PAPER.v, ingest=paper["ingest"],
                            sizes_gb=paper["sizes"])
    for i in range(R):
        one = paper["ins"]._replace(arrivals=paper["ins"].arrivals[i], mu=paper["ins"].mu[i])
        single = simulate_placed(one, paper["up"], paper["down"], T_GMSA, paper["t_rule"], None,
                                 cfg, scalar=PAPER.v, ingest=paper["ingest"],
                                 sizes_gb=paper["sizes"])
        for name in ("f_trace", "q_final", "placements", "r_trace"):
            assert torch.equal(getattr(batch, name)[i], getattr(single, name)), name
        for name in SUMS:
            torch.testing.assert_close(getattr(batch, name)[i], getattr(single, name),
                                       rtol=SUM_RTOL, atol=1e-6, msg=name)


def test_move_budget_none_equals_the_config_value(paper):
    run = lambda mb: simulate_placed(paper["ins"], paper["up"], paper["down"], T_GMSA,
                                     paper["t_rule"], None, _pcfg(PlacementConfig), scalar=PAPER.v,
                                     ingest=paper["ingest"], move_budget=mb)
    base = run(None)
    for mb in (torch.tensor(PlacementConfig.move_budget),
               torch.full((R,), PlacementConfig.move_budget)):
        for a, b in zip(base, run(mb)):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="does not fit"):
        run(torch.ones(R + 1))


def test_budget_sweep_lanes_equal_per_budget_calls_and_jax(paper):
    budgets = (0.25, 0.5, 1.0)
    cfg = _pcfg(PlacementConfig)
    gen = lambda: torch.Generator().manual_seed(2)
    grid = sweep_placed_budgets(paper["build"], paper["up"], paper["down"], T_GMSA,
                                paper["t_rule"], gen(), R, cfg, budgets, scalar=PAPER.v,
                                ingest=paper["ingest"], sizes_gb=paper["sizes"], device=CPU)
    assert grid.f_trace.shape == (3, R, T, 4, 1) and grid.placements.shape == (3, R, T // W, 1, 4)
    for i, mb in enumerate(budgets):
        per = simulate_placed_many(paper["build"], paper["up"], paper["down"], T_GMSA,
                                   paper["t_rule"], gen(), R, dataclasses.replace(cfg, move_budget=mb),
                                   scalar=PAPER.v, ingest=paper["ingest"], sizes_gb=paper["sizes"],
                                   device=CPU)
        lane = PlacedOutputs(*(x[i] for x in grid))
        for name in ("f_trace", "q_final", "placements", "r_trace"):
            assert torch.equal(getattr(lane, name), getattr(per, name)), name
        for name in SUMS:
            torch.testing.assert_close(getattr(lane, name), getattr(per, name), rtol=SUM_RTOL,
                                       atol=1e-6, msg=name)
    # The 1.0 lane against JAX on the same (bridged) traces.
    paper_lane = dict(paper, ins=paper["build"](gen(), R))
    want = _jax_placed(paper_lane, J_GMSA, paper["j_rule"], _pcfg(jc.PlacementConfig),
                       scalar=PAPER.v, ingest=paper["ingest"], sizes_gb=paper["sizes"],
                       move_budget=jnp.float32(1.0))
    _compare(PlacedOutputs(*(x[2] for x in grid)), want)
    with pytest.raises(ValueError, match="consumes the generator"):
        sweep_placed_budgets(paper["build"], paper["up"], paper["down"], tb.random_dispatch,
                             paper["t_rule"], gen(), R, cfg, budgets, device=CPU)
    with pytest.raises(ValueError, match="1-D"):
        sweep_placed_budgets(paper["build"], paper["up"], paper["down"], T_GMSA,
                             paper["t_rule"], gen(), R, cfg, [[0.5]], device=CPU)


def test_summarize_placed_matches_jax(paper):
    got = simulate_placed(paper["ins"], paper["up"], paper["down"], T_GMSA, paper["t_rule"], None,
                          _pcfg(PlacementConfig), scalar=PAPER.v, ingest=paper["ingest"])
    want = jc.summarize_placed(jc.PlacedOutputs(*(jnp.asarray(x.numpy()) for x in got)))
    mine = summarize_placed(got)
    assert mine.keys() == want.keys()
    for key in want:
        assert mine[key] == pytest.approx(want[key], rel=1e-6, abs=1e-9), key
    one = summarize_placed(PlacedOutputs(*(x[0] for x in got)))
    assert one.keys() == mine.keys()


def test_controller_contract_errors_match_jax(paper):
    ins, up, down = paper["ins"], paper["up"], paper["down"]
    run = lambda pol=T_GMSA, cfg=_pcfg(PlacementConfig), i=ins, **kw: simulate_placed(
        i, up, down, pol, paper["t_rule"], None, cfg, **kw)
    with pytest.raises(ValueError, match="stale ratios"):
        run(pol=tg.make_kernel_policy(paper["template"].r))
    with pytest.raises(ValueError, match="must be a multiple"):
        run(cfg=_pcfg(PlacementConfig, epoch_slots=36))
    with pytest.raises(ValueError, match="owns the time axis"):
        run(i=ins._replace(r=ins.r.expand((T,) + tuple(ins.r.shape))))
    with pytest.raises(ValueError, match="health must be"):
        run(health=torch.ones(T, 3))
    with pytest.raises(ValueError, match="link_health must be"):
        run(link_health=torch.ones(T, 4, 3))
    with pytest.raises(ValueError, match="alive mask must be"):
        run(alive=torch.ones(T - 1, 4))
    with pytest.raises(ValueError, match="regions requires"):
        run(regions=torch.zeros(4, dtype=torch.int32))


# ---------------------------------------------------------------------------
# The staged engine replays the controller's layouts
# ---------------------------------------------------------------------------

def test_staged_composes_with_simulate_placed_and_matches_jax():
    """The reference's composition test on one run, through both packages:
    the controller's evolving placements and ratios replay through the
    staged engine as time-varying inputs; jobs are conserved; the adaptive
    arm's staged bill is below the static arm's; each arm's total within
    1e-5 of JAX's on the same template."""
    scfg = StagedPaperConfig()
    template, dag, wan, _ = make_staged_builder(scfg, device=CPU)
    w = 48
    ingest = ingest_drift_trace(torch.Generator().manual_seed(7), scfg.t_slots // w,
                                scfg.k_types, scfg.n_sites,
                                bias=torch.tensor([0.05, 0.8, 0.05, 0.10]), bias_strength=0.5,
                                device=CPU)
    kw = dict(epoch_slots=w, growth=0.25, dataset_gb=scfg.input_gb,
              manager_share=scfg.manager_share, map_share=scfg.map_share)
    jtemp = jsim.SimInputs(*(jnp.asarray(x.numpy()) for x in template))
    jdag = jdag_mod.StageDag(*(jnp.asarray(x.numpy()) for x in dag))
    jwan = jw.WanModel(*(jnp.asarray(x.numpy()) for x in wan))
    totals, jtotals = {}, {}
    pol = tg.dispatch_fn(scfg.v)
    for arm, rule, jrule in [("static", tb.static_placement_rule, jb.static_placement_rule),
                             ("adaptive", make_adaptive_rule(wan.up),
                              jr.make_adaptive_rule(jwan.up))]:
        placed = simulate_placed(template, wan.up, wan.down, pol, rule, None,
                                 PlacementConfig(**kw), scalar=scfg.v, ingest=ingest)
        staged_inputs = template._replace(
            data_dist=placed.placements.repeat_interleave(w, dim=0),
            r=placed.r_trace.repeat_interleave(w, dim=0),
        )
        outs = simulate_staged(staged_inputs, dag, wan, make_staged_policy(dag, wan), None,
                               scfg.v)
        totals[arm] = summarize_staged(outs)["time_avg_total_cost"]
        assert (float(outs.completed.sum()) + float(outs.q_final.sum())
                == pytest.approx(float(template.arrivals.sum()), rel=1e-5))
        jplaced = jc.simulate_placed(jtemp, jwan.up, jwan.down, jg.dispatch_fn(scfg.v), jrule,
                                     jax.random.key(1), jc.PlacementConfig(**kw), scalar=scfg.v,
                                     ingest=jnp.asarray(ingest.numpy()))
        np.testing.assert_allclose(placed.placements.numpy(), np.asarray(jplaced.placements),
                                   rtol=RTOL, atol=1e-6)
        jouts = je.simulate_staged(jtemp._replace(
            data_dist=jnp.repeat(jplaced.placements, w, axis=0),
            r=jnp.repeat(jplaced.r_trace, w, axis=0)), jdag, jwan,
            jsch.make_staged_policy(jdag, jwan), jax.random.key(1), scalar=scfg.v)
        jtotals[arm] = je.summarize_staged(jouts)["time_avg_total_cost"]
        assert totals[arm] == pytest.approx(jtotals[arm], rel=RTOL), arm
    assert totals["adaptive"] < totals["static"], totals
