"""End-to-end demo on the port: GMSA-dispatched LLM serving across a
simulated geo-distributed fleet — the paper's framework doing real work.

Two request classes (two architectures from the assigned pool, smoke-scale),
Poisson request arrivals, four pods with heterogeneous capacity and
price/PUE traces. Every slot:

  1. each class's prefill routes through the placement layer's
     replica-read mix over the drawn dataset layout, and the joint stage
     scheduler places the decode stage (KV handoff billed via the WAN
     model) by drift-plus-penalty;
  2. drained requests execute REAL batched prefill + decode steps;
  3. per-stage queues update by the staged generalization of Eq. (1) —
     the same slot body `simulate_staged` runs, so a dispatch-only run
     replays the simulator bit-for-bit.

A second pass with V=100 shows the cost/backlog trade-off live
(serving energy is kWh-scale, so dispatch is nearly V-insensitive —
the drift term dominates). As the JAX package's ``examples/serve_geo.py``.

    PYTHONPATH=src python -m repro_torch.examples.serve_geo [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.launch.serve import build_engine

CLASSES = ["qwen2-0.5b", "granite-3-2b"]
SLOTS = 16


def claims(result: dict) -> list[str]:
    """The demo's claims, broken: both classes execute jobs, in more than
    zero seconds."""
    out = result["v1"]
    bad = []
    done = out["completed"].sum(axis=0)
    if not (out["exec_jobs"] > 0 and (done > 0).all()):
        bad.append(f"not every class executed (completed per class {done.tolist()})")
    if not out["exec_seconds"] > 0.0:
        bad.append("no model execution time")
    return bad


def main(device=None, runs=None) -> dict:
    """Both passes on ``device`` (``None``: CUDA) over ``runs`` slots
    (default 16); returns the engine outputs ``{"v1", "v100"}``."""
    dev = resolve_device(device)
    classes, slots = CLASSES, runs or SLOTS

    print("=== GMSA fleet serving (V=1), real model execution ===")
    engine = build_engine(classes, slots, v=1.0, arrival=5.0, device=dev)
    out = engine.run(execute_real=True)
    print(f"mean energy cost/slot : {out['mean_cost']*1e6:.3f} µ$ "
          "(full-arch energy pricing, smoke-scale execution)")
    print(f"final backlog         : {out['final_backlog']:.0f} requests")
    print(f"model execution time  : {out['exec_seconds']:.1f}s "
          f"(batched prefill+decode on {dev.type})")
    print(f"KV-handoff WAN bill   : {out['wan_cost'].sum():.3e} $ "
          f"({out['wan_gb'].sum():.2f} GB)")
    share = out["dispatch"].mean(axis=0).sum(axis=(1, 2))
    print(f"dispatch share per pod: {np.round(share / share.sum(), 3)}")

    # Per-slot timeline straight from the engine's history records —
    # decode pod per class, pod queue depths, served-priced IT Joules.
    print("\nslot timeline (decode pod per class | pod queue depths | J):")
    for h in out["history"]:
        choices = " ".join(f"{c}->pod{p}" for c, p in zip(classes, h["choice"]))
        depths = " ".join(f"{d:5.1f}" for d in h["q_pod"])
        joules = " ".join(f"{j:6.1f}" for j in h["energy_j"])
        print(f"  t={h['t']:>2}  {choices}  | q [{depths}] | E [{joules}]")

    print("\n=== V=100 (cost-greedy) — dispatch only ===")
    engine = build_engine(classes, slots, v=100.0, arrival=5.0, device=dev)
    out100 = engine.run(execute_real=False)
    print(f"mean cost {out100['mean_cost']*1e6:.3f} µ$ "
          f"(vs {out['mean_cost']*1e6:.3f} µ$ at V=1) | "
          f"backlog {out100['final_backlog']:.0f} (vs {out['final_backlog']:.0f})")

    print("\nThe cheap/cool pods (Luleå-like) absorb most requests until their")
    print("queues push back — the paper's drift-plus-penalty balance, applied")
    print("to real transformer serving. Per-job energy is kWh-scale, so the")
    print("V sweep barely moves cost: the drift (queueing) term dominates.")
    return {"v1": out, "v100": out100}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--runs", type=int, default=None, help=f"slots (default {SLOTS})")
    args = ap.parse_args()
    if bad := claims(main(args.device, args.runs)):
        sys.exit("serve_geo: " + "; ".join(bad))
