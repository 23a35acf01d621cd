"""Two-timescale placement vs. static placement on a drifting dataset, on the port.

The scenario the base paper cannot express, as the JAX package's
``benchmarks/placement_bench.py`` runs it: over the 24 h horizon new data
is ingested disproportionately at ForestCity (the priciest power in the
fleet) and datasets grow 5%/epoch. GMSA keeps dispatching per slot in both
arms; the adaptive arm additionally re-places data every W = 48 slots
(4 hours) through the WAN cost model, the static arm never moves a byte.

Reports, per arm: time-averaged total cost (dispatch + WAN moves +
replication sync), the WAN and sync bills, and the wall time per
Monte-Carlo run (best of four warm calls; the first call's extra time
apart). Asserts the reference's check: the adaptive arm's total cost below
the static arm's.

``--fault`` runs the chaos scenario instead: the same drifting trace, but
ForestCity drops dead at slot 144 of 288, permanently. Both arms run the
controller's recovery path and the bench reports the recovery bill plus
*recovery-time-to-SLO*: slots after the loss until the fleet backlog drains
back under 1.5x its pre-loss level.

``--sweep`` maps the cost-vs-churn frontier: the adaptive arm swept over
``epoch_slots`` (W) x ``move_budget`` (alpha), each W's whole budget column
in one controller loop (:func:`repro_torch.core.sweep.sweep_placed_budgets`),
the per-budget calls timed once at the first W beside it.

    PYTHONPATH=src python -m repro_torch.benchmarks.placement_bench
        [--fault | --sweep] [--runs N] [--device cuda] [--record PATH]

``--runs`` defaults to 1000 (64 per cell with ``--sweep``); ``--record PATH``
appends the CSV records under the ``torch_placement_bench`` label.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.benchmarks.common import N_RUNS, emit, timed_compile_sweep, write_record
from repro_torch.configs.facebook_4dc import PaperSimConfig, make_sim_builder, site_bandwidths
from repro_torch.core.baselines import static_placement_rule
from repro_torch.core.gmsa import dispatch_fn
from repro_torch.core.sweep import sweep_placed_budgets
from repro_torch.device import resolve_device
from repro_torch.placement import (
    PlacedOutputs,
    PlacementConfig,
    make_adaptive_rule,
    simulate_placed_many,
    summarize_placed,
)
from repro_torch.traces.drift import dataset_growth_trace, ingest_drift_trace
from repro_torch.traces.faults import scheduled_failure_trace

EPOCH_SLOTS = 48          # 4 h slow-loop period
GROWTH_PER_EPOCH = 0.05   # dataset volume growth
INGEST_FRACTION = 0.25    # share of each dataset that is fresh per epoch
FAULT_SITE = 1            # ForestCity — where the drifting ingest piles up
FAULT_SLOT = 144          # noon of the 24 h horizon
SLO_FACTOR = 1.5          # "recovered" = backlog back under 1.5x pre-loss
CAPACITY_GB = (220.0, 220.0, 220.0, 220.0)
INGEST_BIAS = (0.05, 0.8, 0.05, 0.10)   # toward ForestCity
INGEST_SEED = 7
SEED = 0

SWEEP_EPOCH_SLOTS = (24, 48, 96, 144)   # divisors of the 288-slot horizon
SWEEP_MOVE_BUDGETS = (0.25, 0.5, 1.0)
SWEEP_RUNS = 64           # per-cell Monte-Carlo runs


def recovery_time_to_slo(backlog_avg: np.ndarray, t_die: int) -> int:
    """Slots after ``t_die`` until the run-mean backlog re-enters the SLO.

    The SLO level is ``SLO_FACTOR`` x the mean backlog over the epoch
    preceding the loss. Returns the horizon remainder if it never recovers.
    """
    trace = backlog_avg.mean(axis=0) if backlog_avg.ndim == 2 else backlog_avg
    pre = float(trace[max(t_die - EPOCH_SLOTS, 0):t_die].mean())
    slo = SLO_FACTOR * max(pre, 1e-6)
    post = trace[t_die:]
    ok = np.nonzero(post <= slo)[0]
    return int(ok[0]) if ok.size else int(post.size)


def _ingest(cfg: PaperSimConfig, n_epochs: int, dev: torch.device) -> torch.Tensor:
    gen = torch.Generator(device=dev).manual_seed(INGEST_SEED)
    return ingest_drift_trace(gen, n_epochs, cfg.k_types, cfg.n_sites,
                              bias=torch.tensor(INGEST_BIAS, device=dev),
                              bias_strength=0.5, device=dev)


def _gen(dev: torch.device) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(SEED)


def run(n_runs: int, device=None, fault: bool = False) -> dict:
    """Both arms through ``simulate_placed_many`` on ``device`` (``None``:
    CUDA): per arm its summary, µs per run and the first call's extra µs
    (and under ``fault`` the recovery time to SLO); plus the saving."""
    dev = resolve_device(device)
    cfg = PaperSimConfig()
    _, build = make_sim_builder(cfg, device=dev)
    up, down = site_bandwidths(cfg, device=dev)
    n_epochs = cfg.t_slots // EPOCH_SLOTS
    ingest = _ingest(cfg, n_epochs, dev)
    sizes = dataset_growth_trace(n_epochs, cfg.k_types, 100.0, GROWTH_PER_EPOCH, device=dev)
    pcfg = PlacementConfig(
        epoch_slots=EPOCH_SLOTS, growth=INGEST_FRACTION, capacity_gb=CAPACITY_GB,
        manager_share=cfg.manager_share, map_share=cfg.map_share,
    )
    pol = dispatch_fn(cfg.v)
    alive = (scheduled_failure_trace(cfg.t_slots, cfg.n_sites, [(FAULT_SITE, FAULT_SLOT, None)],
                                     device=dev) if fault else None)
    out = {"n_runs": n_runs, "fault": fault, "arms": {}}
    for name, rule in [("static", static_placement_rule),
                       ("adaptive", make_adaptive_rule(up, temp=2.0))]:
        outs, us_per_run, first_us = timed_compile_sweep(
            lambda: simulate_placed_many(build, up, down, pol, rule, _gen(dev), n_runs, pcfg,
                                         ingest=ingest, sizes_gb=sizes, alive=alive,
                                         device=dev),
            n_runs, dev,
        )
        arm = {"summary": summarize_placed(outs), "us_per_run": us_per_run,
               "first_call_us": first_us}
        if fault:
            arm["recovery_slots_to_slo"] = recovery_time_to_slo(
                outs.backlog_avg.cpu().numpy(), FAULT_SLOT)
        out["arms"][name] = arm
    ad, st = (out["arms"][a]["summary"]["time_avg_total_cost"] for a in ("adaptive", "static"))
    out["saving_frac"] = 1.0 - ad / st
    return out


def verify(result: dict) -> None:
    """The reference's assert; raises AssertionError (also under ``python -O``)."""
    scenario = "site-loss" if result["fault"] else "drifting"
    if not result["saving_frac"] > 0.0:
        raise AssertionError(
            f"adaptive placement must beat STATIC-PLACEMENT on the {scenario} trace")


def report(result: dict) -> list[dict]:
    """The bench's CSV lines, named as the JAX package names them; returns
    them as records."""
    records = []
    n = result["n_runs"]
    tag = "fault_" if result["fault"] else ""
    for name, arm in result["arms"].items():
        s = arm["summary"]
        derived = (
            f"total_cost={s['time_avg_total_cost']:.1f};"
            f"wan_cost={s['time_avg_wan_cost']:.2f};"
            f"sync_cost={s['time_avg_sync_cost']:.2f};"
            f"wan_gb={s['total_wan_gb']:.0f};"
            f"backlog={s['time_avg_backlog']:.2f};"
            f"first_call_us={arm['first_call_us']:.0f}"
        )
        if result["fault"]:
            derived += (
                f";recovery_cost={s['time_avg_recovery_cost']:.3f}"
                f";recovery_gb={s['total_recovery_gb']:.0f}"
                f";recovery_slots_to_slo={arm['recovery_slots_to_slo']}"
            )
        records.append(emit(f"placement_{tag}{name}_{n}runs_per_run", arm["us_per_run"], derived))
    records.append(emit(f"placement_{tag}adaptive_saving", 0.0,
                        f"saving_frac={result['saving_frac']:.3f}"))
    return records


def sweep(n_runs: int, device=None) -> tuple[list[dict], list[dict]]:
    """The epoch-length x move-budget frontier (cost vs. churn).

    Every cell faces the same exogenous drift: one ingest walk drawn at the
    finest epoch granularity, aggregated per slow-loop window (mean mix
    over the window), with the per-epoch mixing fraction and dataset growth
    compounded so a W-slot epoch applies exactly the cumulative drift of
    W/W0 fine epochs. Each W's budget column runs as one
    ``sweep_placed_budgets`` loop; at the first W the per-budget calls are
    timed beside it. Returns ``(frontier, records)``: per cell (W, budget,
    summary, µs per run).
    """
    dev = resolve_device(device)
    cfg = PaperSimConfig()
    _, build = make_sim_builder(cfg, device=dev)
    up, down = site_bandwidths(cfg, device=dev)
    pol = dispatch_fn(cfg.v)
    rule = make_adaptive_rule(up, temp=2.0)
    w0 = min(SWEEP_EPOCH_SLOTS)
    fine = _ingest(cfg, cfg.t_slots // w0, dev)                       # (E0, K, N)
    frontier, records = [], []
    percell = None
    for w in SWEEP_EPOCH_SLOTS:
        n_epochs = cfg.t_slots // w
        stride = w // w0
        ingest = fine.reshape(n_epochs, stride, cfg.k_types, cfg.n_sites).mean(dim=1)
        ingest = ingest / ingest.sum(dim=-1, keepdim=True)
        # Compound the headline scenario's per-48-slot rates to this W.
        growth = 1.0 - (1.0 - INGEST_FRACTION) ** (w / EPOCH_SLOTS)
        sizes = dataset_growth_trace(
            n_epochs, cfg.k_types, 100.0,
            (1.0 + GROWTH_PER_EPOCH) ** (w / EPOCH_SLOTS) - 1.0, device=dev,
        )
        mk = lambda mb: PlacementConfig(
            epoch_slots=w, move_budget=mb, growth=growth, capacity_gb=CAPACITY_GB,
            manager_share=cfg.manager_share, map_share=cfg.map_share,
        )
        pcfg = mk(PlacementConfig.move_budget)
        lanes = n_runs * len(SWEEP_MOVE_BUDGETS)
        col, col_us, col_first = timed_compile_sweep(
            lambda: sweep_placed_budgets(build, up, down, pol, rule, _gen(dev), n_runs, pcfg,
                                         SWEEP_MOVE_BUDGETS, ingest=ingest, sizes_gb=sizes,
                                         device=dev),
            lanes, dev,
        )
        for i, mb in enumerate(SWEEP_MOVE_BUDGETS):
            s = summarize_placed(PlacedOutputs(*(x[i] for x in col)))
            frontier.append({"epoch_slots": w, "move_budget": mb, "summary": s,
                             "us_per_run": col_us})
            records.append(emit(
                f"placement_sweep_w{w}_b{mb}", col_us,
                f"total_cost={s['time_avg_total_cost']:.1f};"
                f"wan_gb={s['total_wan_gb']:.0f};"
                f"wan_cost={s['time_avg_wan_cost']:.2f};"
                f"backlog={s['time_avg_backlog']:.2f};"
                f"grid_first_call_us={col_first:.0f}",
            ))
        if percell is None:
            cfgs = [mk(mb) for mb in SWEEP_MOVE_BUDGETS]

            def percell_pass():
                last = None
                for pc in cfgs:
                    last = simulate_placed_many(build, up, down, pol, rule, _gen(dev), n_runs,
                                                pc, ingest=ingest, sizes_gb=sizes, device=dev)
                return last

            _, p_us, p_first = timed_compile_sweep(percell_pass, lanes, dev)
            percell = (col_us, col_first, p_us, p_first)
    g_us, g_first, p_us, p_first = percell
    records.append(emit(
        "placement_sweep_grid_vs_percell", g_us,
        f"percell_us_per_run={p_us:.1f};"
        f"steady_speedup={p_us / max(g_us, 1e-9):.2f}x;"
        f"grid_first_call_us={g_first:.0f};percell_first_call_us={p_first:.0f}",
    ))
    best = min(frontier, key=lambda c: c["summary"]["time_avg_total_cost"])
    records.append(emit(
        "placement_sweep_best", 0.0,
        f"epoch_slots={best['epoch_slots']};move_budget={best['move_budget']};"
        f"total_cost={best['summary']['time_avg_total_cost']:.1f};"
        f"wan_gb={best['summary']['total_wan_gb']:.0f}",
    ))
    return frontier, records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--fault", action="store_true",
                      help="mid-trace site-loss chaos scenario (adaptive-with-recovery vs static "
                           "under the same outage)")
    mode.add_argument("--sweep", action="store_true",
                      help="epoch_slots x move_budget sweep: the cost-vs-churn frontier")
    ap.add_argument("--runs", type=int, default=None,
                    help=f"Monte-Carlo runs (default {N_RUNS}; {SWEEP_RUNS} per cell with --sweep)")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--record", default=None, help="append the CSV records to this JSON list")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.sweep:
        _, records = sweep(args.runs or min(N_RUNS, SWEEP_RUNS), dev)
        result = None
    else:
        result = run(args.runs or N_RUNS, dev, fault=args.fault)
        records = report(result)
        verify(result)
    if args.record:
        write_record(args.record, "torch_placement_bench", records, dev)
    return result


if __name__ == "__main__":
    main()
