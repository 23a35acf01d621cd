"""Serving launcher: the simulation-dispatched fleet engine on real models.

  PYTHONPATH=src python -m repro_torch.launch.serve --slots 24 --v 1.0 \\
      [--classes qwen2-0.5b,granite-3-2b] [--no-exec] [--pods 8] [--admit-max 6] \\
      [--kill "2:12"] [--straggle "1:4:0.2"] [--hedge 0.35] \\
      [--dispatch kernel] [--device cpu]

Each request class is an architecture (its smoke variant executes, the
full one prices the energy) modelled as a 2-stage prefill → decode chain;
prefill routes through the placement layer's replica-read assignment over
a drawn dataset layout, every slot dispatches through the joint stage
scheduler (or the ``gmsa_score`` kernel with ``--dispatch kernel``), and
drained jobs execute prefill + decode. ``--kill pod:slot`` injects a pod
death; the recovery drain shows in the history and the printed events.
Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.iridium import build_task_allocation
from repro_torch.device import resolve_device
from repro_torch.serve.engine import FleetConfig, FleetEngine, RequestClass
from repro_torch.telemetry.config import TelemetryConfig
from repro_torch.traces.bandwidth import bandwidth_draw
from repro_torch.traces.datasets import dataset_distribution
from repro_torch.traces.price import FACEBOOK_SITES, price_trace
from repro_torch.traces.pue import pue_trace


def serve_traces(k_classes: int, n_pods: int, slots: int, seed: int = 0, device=None):
    """The launcher's world on ``device`` (``None``: CUDA): ``(omega, pue,
    r, up, down, layout)`` from one generator seeded with ``seed``.

    Pods beyond the four Facebook DCs reuse their site climates (cycled).
    The dataset layout doubles as the KV-prefix placement the replica-read
    router serves prefill from, and the same draw feeds the task-allocation
    ratios, so dispatch pricing and routing share one world.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sites = tuple(FACEBOOK_SITES[i % len(FACEBOOK_SITES)] for i in range(n_pods))
    omega = price_trace(gen, slots, 5.0, sites, device=dev)
    pue = pue_trace(gen, slots, 5.0, sites, device=dev)
    layout = dataset_distribution(gen, k_classes, n_pods, device=dev)
    up, down = bandwidth_draw(gen, n_pods, device=dev)
    r = build_task_allocation(layout, up, down, manager_share=0.62)
    return omega, pue, r, up, down, layout


def build_engine(classes: list[str], slots: int, v: float, seed: int = 0,
                 arrival: float = 6.0, n_pods: int = 4,
                 admit_max: float | None = None, dispatch: str = "staged",
                 alive: np.ndarray | None = None,
                 telemetry: TelemetryConfig | None = None,
                 health: np.ndarray | None = None,
                 link_health: np.ndarray | None = None,
                 hedge: float | None = None, device=None) -> FleetEngine:
    """A :class:`FleetEngine` over :func:`serve_traces`' world, one class per
    architecture id (executing its smoke variant, priced on the full one),
    on ``device`` (``None``: CUDA)."""
    dev = resolve_device(device)
    rcs = [
        RequestClass(name=a, cfg=get_arch(a, "smoke"), energy_cfg=get_arch(a, "full"),
                     arrival_rate=arrival)
        for a in classes
    ]
    omega, pue, r, up, down, layout = serve_traces(len(rcs), n_pods, slots, seed, dev)
    fcfg = FleetConfig(
        n_pods=n_pods, horizon_slots=slots, v=v, seed=seed,
        admit_max=admit_max, dispatch=dispatch, hedge_threshold=hedge,
    )
    return FleetEngine(
        fcfg, rcs, omega, pue, r,
        up=up, down=down, layout=layout, alive=alive, telemetry=telemetry,
        health=health, link_health=link_health, device=dev,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--classes", default="qwen2-0.5b,granite-3-2b",
                    help="comma-separated architecture ids, any of "
                         "repro_torch.configs.list_archs() (dense, SSM, MoE, hybrid, "
                         "frontend: its prompts are tokens only)")
    ap.add_argument("--slots", type=int, default=24)
    ap.add_argument("--v", type=float, default=1.0)
    ap.add_argument("--arrival", type=float, default=6.0)
    ap.add_argument("--pods", type=int, default=4)
    ap.add_argument("--admit-max", type=float, default=None,
                    help="per-class per-slot admission cap (default: admit all)")
    ap.add_argument("--dispatch", choices=["staged", "kernel"], default="staged")
    ap.add_argument("--kill", default=None, metavar="POD:SLOT",
                    help="kill pod POD at slot SLOT (recovery drain demo)")
    ap.add_argument("--straggle", default=None, metavar="POD:SLOT:FACTOR",
                    help="degrade pod POD to FACTOR of its service rate "
                         "from slot SLOT on (straggler demo)")
    ap.add_argument("--hedge", type=float, default=None,
                    help="speculative re-execution threshold (clone a "
                         "stage when its pod's rate falls below this "
                         "fraction of the runner-up's)")
    ap.add_argument("--no-exec", action="store_true",
                    help="skip real model execution (dispatch-only)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    alive = None
    if args.kill:
        pod, slot = (int(x) for x in args.kill.split(":"))
        alive = np.ones((args.slots, args.pods), np.float32)
        alive[slot:, pod] = 0.0
    health = None
    if args.straggle:
        pod, slot, factor = args.straggle.split(":")
        health = np.ones((args.slots, args.pods), np.float32)
        health[int(slot):, int(pod)] = float(factor)

    engine = build_engine(
        args.classes.split(","), args.slots, args.v, args.seed, args.arrival,
        n_pods=args.pods, admit_max=args.admit_max, dispatch=args.dispatch,
        alive=alive, health=health, hedge=args.hedge, device=args.device,
    )
    out = engine.run(execute_real=not args.no_exec)
    print(f"slots={args.slots} classes={args.classes} pods={args.pods} "
          f"dispatch={args.dispatch} device={engine.device}")
    print(f"mean slot cost      : {out['mean_cost']:.3e} $ "
          f"({out['mean_cost']*1e6:.3f} µ$)")
    print(f"KV-handoff WAN bill : {out['wan_cost'].sum():.3e} $ "
          f"({out['wan_gb'].sum():.2f} GB)")
    if args.hedge is not None:
        print(f"hedge bill          : {out['hedge_cost'].sum():.3e} $ "
              f"({out['hedged_jobs'].sum():.2f} jobs re-executed)")
    print(f"total billed        : {out['total_billed_cost']:.3e} $")
    print(f"final total backlog : {out['final_backlog']:.1f}")
    print(f"admitted/rejected   : {out['admitted'].sum():.0f} / "
          f"{out['rejected'].sum():.0f}")
    print(f"SLO violation frac  : {np.round(out['slo_viol_frac'], 3)}")
    print(f"model-exec seconds  : {out['exec_seconds']:.1f} "
          f"({out['exec_jobs']} jobs)")
    share = out["dispatch"].mean(axis=0).sum(axis=(1, 2))
    print("dispatch share/pod  :", np.round(share / share.sum(), 3))
    for ev in out["events"]:
        print(f"recovery event      : pod {ev['pod']} died at t={ev['t']}, "
              f"drained {ev['drained']:.1f} jobs")
    return out


if __name__ == "__main__":
    main()
