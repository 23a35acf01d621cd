"""Two-timescale placement demo on the port: GMSA dispatch x 4-hourly re-placement.

Over the paper's 24 h / 4-DC horizon, new data keeps arriving at ForestCity
(the most expensive power in the fleet). The slow loop re-places datasets
every 4 hours toward cheap, capacity-rich sites — paying for every byte it
moves over the WAN — while GMSA keeps picking managers per 5-min slot.

The second act is the chaos scenario: ForestCity drops dead at noon. The
controller fires an off-schedule recovery epoch on the death edge — wipes
the dead queues and re-injects them as an arrival burst, re-replicates the
lost dataset share over the survivors (billed as ``recovery_cost``), and
keeps dispatching without ever touching the dead site. As the JAX package's
``examples/adaptive_placement.py``.

    PYTHONPATH=src python -m repro_torch.examples.adaptive_placement [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.configs.facebook_4dc import PaperSimConfig, make_sim_builder, site_bandwidths
from repro_torch.core.baselines import static_placement_rule
from repro_torch.core.gmsa import dispatch_fn
from repro_torch.device import resolve_device
from repro_torch.placement import (
    PlacementConfig,
    make_adaptive_rule,
    simulate_placed,
    simulate_placed_many,
    summarize_placed,
)
from repro_torch.telemetry import TRACE, TelemetryConfig, collect_records, render_timeline
from repro_torch.traces.drift import dataset_growth_trace, ingest_drift_trace
from repro_torch.traces.faults import scheduled_failure_trace
from repro_torch.traces.price import FACEBOOK_SITES

N_RUNS = 200
EPOCH_SLOTS = 48                        # 4 h slow-loop period
INGEST_BIAS = (0.05, 0.8, 0.05, 0.10)   # ForestCity-heavy ingest


def claims(result: dict) -> list[str]:
    """The demo's claims, broken: the adaptive arm's total $/slot below the
    static arm's; no dispatch to the dead site after the loss."""
    bad = []
    if not result["adaptive"]["time_avg_total_cost"] < result["static"]["time_avg_total_cost"]:
        bad.append("adaptive total $/slot is not below static")
    if result["dead_site_mass"] != 0.0:
        bad.append(f"{result['dead_site_mass']} dispatched to the dead site after the loss")
    return bad


def main(device=None, runs=None) -> dict:
    """Both acts on ``device`` (``None``: CUDA) over ``runs`` Monte-Carlo
    runs (default 200); returns each arm's summary, the adaptive layout,
    the site-loss run's summary and its dispatch mass to the dead site."""
    dev = resolve_device(device)
    runs = runs or N_RUNS
    cfg = PaperSimConfig()
    _, build = make_sim_builder(cfg, device=dev)
    up, down = site_bandwidths(cfg, device=dev)

    w = EPOCH_SLOTS
    n_epochs = cfg.t_slots // w
    ingest = ingest_drift_trace(
        torch.Generator(device=dev).manual_seed(7), n_epochs, cfg.k_types, cfg.n_sites,
        bias=torch.tensor(INGEST_BIAS, device=dev), bias_strength=0.5, device=dev,
    )
    sizes = dataset_growth_trace(n_epochs, cfg.k_types, 100.0, 0.05, device=dev)
    pcfg = PlacementConfig(
        epoch_slots=w, growth=0.25, capacity_gb=(220.0,) * 4,
        manager_share=cfg.manager_share, map_share=cfg.map_share,
    )
    gen = lambda: torch.Generator(device=dev).manual_seed(0)
    pol = dispatch_fn(cfg.v)
    result: dict = {}

    print(f"{cfg.t_slots} slots, W = {w} (epochs: {n_epochs}), "
          f"ingest drifting toward ForestCity, {runs} Monte-Carlo runs\n")
    print(f"{'arm':<10} {'total $/slot':>13} {'wan $/slot':>11} "
          f"{'sync $/slot':>12} {'GB moved':>9} {'backlog':>8}")
    outs_by_arm = {}
    for name, rule in [
        ("static", static_placement_rule),
        ("adaptive", make_adaptive_rule(up, temp=2.0)),
    ]:
        outs = simulate_placed_many(build, up, down, pol, rule, gen(), runs, pcfg,
                                    ingest=ingest, sizes_gb=sizes, device=dev)
        outs_by_arm[name] = outs
        s = result[name] = summarize_placed(outs)
        print(f"{name:<10} {s['time_avg_total_cost']:>13.1f} "
              f"{s['time_avg_wan_cost']:>11.2f} {s['time_avg_sync_cost']:>12.2f} "
              f"{s['total_wan_gb']:>9.0f} {s['time_avg_backlog']:>8.2f}")

    names = [s.name for s in FACEBOOK_SITES[: cfg.n_sites]]
    print("\ndataset layout per epoch (type 0, run 0, adaptive arm):")
    print("epoch  " + "  ".join(f"{n:>10}" for n in names))
    result["layout"] = outs_by_arm["adaptive"].placements[0, :, 0].cpu().numpy()  # (E, N)
    for e, row in enumerate(result["layout"]):
        print(f"{e:>5}  " + "  ".join(f"{float(x):>10.2f}" for x in row))
    print("\nThe slow loop drains ForestCity as ingest piles up there, and the")
    print("fast loop (GMSA) keeps queues bounded throughout — two timescales,")
    print("one controller loop.")

    # ---- act two: chaos. ForestCity dies at noon, permanently. ----------
    dead_site, t_die = 1, cfg.t_slots // 2
    alive = scheduled_failure_trace(cfg.t_slots, cfg.n_sites, [(dead_site, t_die, None)],
                                    device=dev)
    print(f"\n=== site loss: {names[dead_site]} dies at slot {t_die} "
          f"(hour {t_die * 5 // 60}) ===")
    outs = simulate_placed_many(build, up, down, pol, make_adaptive_rule(up, temp=2.0), gen(),
                                runs, pcfg, ingest=ingest, sizes_gb=sizes, alive=alive,
                                device=dev)
    s = result["site_loss"] = summarize_placed(outs)
    result["dead_site_mass"] = float(outs.f_trace[:, t_die:, dead_site].abs().max())
    print(f"dispatch mass to the dead site after the loss: {result['dead_site_mass']:.1f}")
    print(f"total cost with recovery: {s['time_avg_total_cost']:.1f} $/slot")

    # The recovery timeline comes straight off the flight recorder: one
    # TRACE-level run, and the death edge (evacuation GB/$ + time-to-SLO),
    # the epoch churn and the ingest redirects are in the event stream —
    # no digging through PlacedOutputs fields.
    tcfg = TelemetryConfig(level=TRACE)
    one = build(gen(), 1)
    one = one._replace(arrivals=one.arrivals[0], mu=one.mu[0])
    outs1, frame = simulate_placed(one, up, down, pol,
                                   make_adaptive_rule(up, temp=2.0), gen(), pcfg,
                                   ingest=ingest, sizes_gb=sizes, alive=alive, telemetry=tcfg)
    records = collect_records(outs1, frame, cfg=tcfg, summary=summarize_placed(outs1))
    result["timeline_events"] = sum(r["type"] == "event" for r in records)
    print("\nrecovery timeline (one TRACE run, event codes: recovery/"
          "epoch/ingest_redirect):")
    print(render_timeline(records, codes={"recovery", "epoch", "ingest_redirect"}))
    print("\nThe dead site's backlog re-enters as an arrival burst, its data")
    print("re-replicates over the survivors, and GMSA never dispatches to a")
    print("dead DC again — the chaos path of the same controller.")
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--runs", type=int, default=None, help=f"default {N_RUNS}")
    args = ap.parse_args()
    if bad := claims(main(args.device, args.runs)):
        sys.exit("adaptive_placement: " + "; ".join(bad))
