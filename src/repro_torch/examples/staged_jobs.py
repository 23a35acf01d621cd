"""Stage-structured jobs demo on the port: joint manager selection x stage placement.

Act 1 — the multi-stage Facebook-4DC mix (3 job types, 2-3 stage chains,
30-60 GB of intermediate data per job): stage-aware scheduling prices the
shuffle WAN pull into every stage's drift-plus-penalty score, against the
stage-oblivious baseline that routes every stage to the one manager base
GMSA picks. Same engine, same bills — the aware arm wins on total cost
and WAN GB, trading a small, bounded amount of extra queueing for it
(both arms complete the same work).

Act 2 — composition with the two-timescale placement layer: ingest drifts
the datasets toward ForestCity over the day, the slow loop re-places them
every 4 hours (``simulate_placed``), and the staged engine replays the
evolving layout (time-varying ``data_dist``/``r``) — re-placement
reshapes the map stage's locality and with it the whole chain's shuffle
sources. As the JAX package's ``examples/staged_jobs.py``.

    PYTHONPATH=src python -m repro_torch.examples.staged_jobs [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.configs.facebook_4dc_stages import StagedPaperConfig, make_staged_builder
from repro_torch.core.baselines import static_placement_rule
from repro_torch.core.gmsa import dispatch_fn, gmsa_policy
from repro_torch.device import resolve_device
from repro_torch.jobs import (
    make_staged_policy,
    simulate_staged,
    simulate_staged_many,
    stage_oblivious,
    summarize_staged,
)
from repro_torch.placement import (
    PlacementConfig,
    make_adaptive_rule,
    simulate_placed,
    summarize_placed,
)
from repro_torch.traces.drift import ingest_drift_trace
from repro_torch.traces.price import FACEBOOK_SITES

N_RUNS = 100
EPOCH_SLOTS = 48
INGEST_BIAS = (0.05, 0.8, 0.05, 0.10)   # toward ForestCity


def act1(cfg, dag, wan, build, runs: int, dev) -> dict:
    print(f"Act 1 — stage-aware vs stage-oblivious "
          f"({cfg.k_types} types, S<= {dag.s_max} stages, {runs} runs)\n")
    print(f"{'arm':<11} {'total $/slot':>12} {'wan $/slot':>11} "
          f"{'GB moved':>9} {'backlog':>8} {'completed':>10}")
    arms = {}
    for name, pol in [
        ("oblivious", stage_oblivious(gmsa_policy, pin_map=True)),
        ("aware", make_staged_policy(dag, wan)),
    ]:
        gen = torch.Generator(device=dev).manual_seed(0)
        outs = simulate_staged_many(build, dag, wan, pol, gen, runs, scalar=cfg.v, device=dev)
        s = summarize_staged(outs)
        arms[name] = s
        print(f"{name:<11} {s['time_avg_total_cost']:>12.1f} "
              f"{s['time_avg_wan_cost']:>11.1f} {s['total_wan_gb']:>9.0f} "
              f"{s['time_avg_backlog']:>8.2f} {s['jobs_completed']:>10.0f}")
    saving = 1 - arms["aware"]["time_avg_total_cost"] / arms["oblivious"]["time_avg_total_cost"]
    print(f"\nstage-aware saving: {saving:.1%} total cost, "
          f"{arms['oblivious']['total_wan_gb'] - arms['aware']['total_wan_gb']:.0f} "
          f"GB less intermediate WAN traffic\n")
    return {"arms": arms, "saving": saving}


def act2(cfg, template, dag, wan, dev) -> dict:
    print("Act 2 — slow-loop re-placement reshaping map locality")
    print("(ingest drifts toward ForestCity; the placement controller\n"
          " corrects it every 4 h; the staged engine replays the evolving "
          "layout)\n")
    w = EPOCH_SLOTS
    n_epochs = cfg.t_slots // w
    ingest = ingest_drift_trace(
        torch.Generator(device=dev).manual_seed(7), n_epochs, cfg.k_types, cfg.n_sites,
        bias=torch.tensor(INGEST_BIAS, device=dev), bias_strength=0.5, device=dev,
    )
    pcfg = PlacementConfig(
        epoch_slots=w, growth=0.25, dataset_gb=cfg.input_gb,
        manager_share=cfg.manager_share, map_share=cfg.map_share,
    )
    pol = dispatch_fn(cfg.v)
    aware = make_staged_policy(dag, wan)
    names = [s.name for s in FACEBOOK_SITES[: cfg.n_sites]]

    print(f"{'placement':<10} {'staged $/slot':>13} {'shuffle $':>10} "
          f"{'move $':>7} {'backlog':>8}")
    arms = {}
    for arm, rule in [
        ("static", static_placement_rule),
        ("adaptive", make_adaptive_rule(wan.up)),
    ]:
        placed = simulate_placed(template, wan.up, wan.down, pol, rule,
                                 torch.Generator(device=dev).manual_seed(1), pcfg, ingest=ingest)
        sp = summarize_placed(placed)
        # Replay the evolving layout through the staged engine: the
        # per-epoch placements/ratios become time-varying inputs.
        staged_inputs = template._replace(
            data_dist=placed.placements.repeat_interleave(w, dim=0),
            r=placed.r_trace.repeat_interleave(w, dim=0),
        )
        outs = simulate_staged(staged_inputs, dag, wan, aware,
                               torch.Generator(device=dev).manual_seed(1), scalar=cfg.v)
        s = summarize_staged(outs)
        arms[arm] = {"staged": s, "placed": sp,
                     "layout": placed.placements[:, 0].cpu().numpy()}
        print(f"{arm:<10} {s['time_avg_total_cost']:>13.1f} "
              f"{s['time_avg_wan_cost']:>10.1f} "
              f"{sp['time_avg_wan_cost']:>7.2f} "
              f"{s['time_avg_backlog']:>8.2f}")
        if arm == "adaptive":
            print("\nmap-stage locality per epoch (type 0, adaptive arm):")
            print("epoch  " + "  ".join(f"{n:>10}" for n in names))
            for e, row in enumerate(arms[arm]["layout"]):
                print(f"{e:>5}  " + "  ".join(f"{x:>10.2f}" for x in row))
    return arms


def claims(result: dict) -> list[str]:
    """Act 1's claim, broken: the aware arm cheaper than the oblivious arm
    on total cost and on WAN GB."""
    aware, obl = (result["act1"]["arms"][a] for a in ("aware", "oblivious"))
    bad = []
    if not aware["time_avg_total_cost"] < obl["time_avg_total_cost"]:
        bad.append("stage-aware total cost is not below stage-oblivious")
    if not aware["total_wan_gb"] < obl["total_wan_gb"]:
        bad.append("stage-aware WAN GB is not below stage-oblivious")
    return bad


def main(device=None, runs=None) -> dict:
    """Both acts on ``device`` (``None``: CUDA), act 1 over ``runs``
    Monte-Carlo runs (default 100); returns ``{"act1": ..., "act2": ...}``."""
    dev = resolve_device(device)
    cfg = StagedPaperConfig()
    template, dag, wan, build = make_staged_builder(cfg, device=dev)
    with np.printoptions(precision=2, suppress=True):
        print(f"{cfg.t_slots} slots x {cfg.n_sites} DCs; stage chains:\n"
              f"  compute =\n{dag.compute.cpu().numpy()}\n"
              f"  shuffle GB =\n{dag.shuffle_gb.cpu().numpy()}\n")
    return {"act1": act1(cfg, dag, wan, build, runs or N_RUNS, dev),
            "act2": act2(cfg, template, dag, wan, dev)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--runs", type=int, default=None, help=f"act 1's runs (default {N_RUNS})")
    args = ap.parse_args()
    if bad := claims(main(args.device, args.runs)):
        sys.exit("staged_jobs: " + "; ".join(bad))
