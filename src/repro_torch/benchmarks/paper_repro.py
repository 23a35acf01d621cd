"""Reproduction of the paper's evaluation (Figs. 5 & 6) on the port.

Runs the full methodology — 4 Facebook DCs, Poisson arrivals at 350K
jobs/month, price/PUE traces, Iridium task ratios, 288 five-minute slots,
Monte-Carlo averaging — and prints the claim-by-claim comparison against
the numbers reported in the paper, as ``examples/paper_repro.py`` does for
the JAX package.

    PYTHONPATH=src python -m repro_torch.benchmarks.paper_repro [--runs 1000]
"""

from __future__ import annotations

import argparse

from repro_torch.benchmarks import fig5, fig6
from repro_torch.benchmarks.common import N_RUNS, card
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=N_RUNS)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {dev.type}" + (f" ({card()})" if dev.type == "cuda" else ""))

    print("=== Fig. 5: performance along time (24 h) ===")
    out5 = fig5.run(args.runs, dev)
    c5 = out5["checks"]
    print(f"GMSA cheapest in {100*c5['frac_slots_gmsa_cheapest']:.0f}% of slots "
          "(paper: 'almost all time slots')")
    print(f"GMSA(V=1) max avg backlog {c5['gmsa_v1_max_avg_backlog']:.1f} "
          "(paper: 'below 50 when V=1')")
    print(f"backlog slope  DATA {c5['slope_data']:+.3f}/slot, "
          f"RANDOM {c5['slope_random']:+.3f}/slot, "
          f"GMSA(V=1) {c5['slope_gmsa_v1']:+.4f}/slot "
          "(paper: baselines 'increase dramatically', GMSA stable)")

    print("\n=== Fig. 6: sensitivity to V ===")
    out6 = fig6.run(args.runs, dev)
    c6 = out6["checks"]
    print(f"{'V':>8} {'cost $':>8} {'backlog':>8}")
    for v in out6["v_grid"]:
        row = out6["gmsa"][v]
        print(f"{v:>8} {row['cost']:>8.1f} {row['backlog']:>8.2f}")
    print(f"baselines ≈ {c6['baseline_cost']:.0f} $ "
          "(paper: 'approximately 750 dollars')")
    print(f"GMSA best {c6['best_gmsa_cost']:.0f} $ (paper: 'as low as 540')")
    print(f"reduction {100*c6['reduction_at_v100']:.1f}% (paper: '30% approximately')")
    print("cost monotone ↓ in V:", c6["cost_monotone_nonincreasing"],
          "| backlog monotone ↑ in V:", c6["backlog_monotone_nondecreasing"])


if __name__ == "__main__":
    main()
