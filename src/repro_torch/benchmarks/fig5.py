"""Paper Fig. 5 on the port — performance along time (24 h, 288 five-minute slots).

(a) energy cost per slot; (b) average queue backlog per slot — for
GMSA(V=1), GMSA(V=10), DATA, RANDOM, averaged over ``n_runs`` Monte-Carlo
runs. The same policies, checks and asserts as the JAX package's
``benchmarks/fig5.py``:

  * GMSA cost below DATA/RANDOM in >= 90% of slots (paper: "almost all");
  * GMSA(V=1) average backlog stays below 50 (paper Fig. 5(b));
  * DATA/RANDOM backlogs grow ~linearly (divergence slope > 0);
    GMSA's is bounded (late-window slope ~ 0).

    PYTHONPATH=src python -m repro_torch.benchmarks.fig5 [--runs 1000] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import numpy as np
import torch

from repro_torch.benchmarks.common import N_RUNS, emit, sync, write_record
from repro_torch.configs.facebook_4dc import PaperSimConfig, make_sim_builder
from repro_torch.core.baselines import data_dispatch, random_dispatch
from repro_torch.core.gmsa import dispatch_fn
from repro_torch.core.simulator import simulate_many
from repro_torch.device import resolve_device

POLICIES = {
    "GMSA_V1": dispatch_fn(1.0),
    "GMSA_V10": dispatch_fn(10.0),
    "DATA": data_dispatch,
    "RANDOM": random_dispatch,
}
SEED = 42


def policy_series(build, n_runs: int, dev: torch.device) -> tuple[dict, dict]:
    """Every policy over ``build``'s traces drawn from ``SEED``: per policy,
    the per-slot run-mean cost and backlog (numpy), and the µs per run."""
    series, t_us = {}, {}
    for name, pol in POLICIES.items():
        t0 = time.perf_counter()
        outs = simulate_many(build, pol, torch.Generator(device=dev).manual_seed(SEED), n_runs,
                             device=dev)
        sync(dev)
        t_us[name] = (time.perf_counter() - t0) * 1e6 / n_runs
        series[name] = {
            "cost": outs.cost.mean(dim=0).cpu().numpy(),
            "backlog": outs.backlog_avg.mean(dim=0).cpu().numpy(),
        }
    return series, t_us


def derived_checks(series: dict, t_slots: int) -> dict:
    """The figure's derived checks from the per-policy series, as the JAX
    package's ``benchmarks/fig5.py`` derives them."""
    gmsa1, data, rnd = series["GMSA_V1"], series["DATA"], series["RANDOM"]
    frac_below = float(np.mean(
        (gmsa1["cost"] <= data["cost"]) & (gmsa1["cost"] <= rnd["cost"])
    ))
    t = np.arange(t_slots)
    late = slice(t_slots // 2, None)
    slope = lambda y: float(np.polyfit(t[late], y[late], 1)[0])
    return {
        "frac_slots_gmsa_cheapest": frac_below,
        "gmsa_v1_max_avg_backlog": float(gmsa1["backlog"].max()),
        "slope_data": slope(data["backlog"]),
        "slope_random": slope(rnd["backlog"]),
        "slope_gmsa_v1": slope(gmsa1["backlog"]),
    }


def run(n_runs: int = N_RUNS, device=None, out=None) -> dict:
    """Every policy over the same seeded traces; returns the figure's
    series, per-policy timings and derived checks. Writes them as JSON to
    ``out`` only when given."""
    dev = resolve_device(device)
    cfg = PaperSimConfig()
    _, build = make_sim_builder(cfg, device=dev)
    series, t_us = policy_series(build, n_runs, dev)
    result = {
        "n_runs": n_runs,
        "per_policy_us": t_us,
        "checks": derived_checks(series, cfg.t_slots),
        "series": {k: {kk: vv.tolist() for kk, vv in v.items()} for k, v in series.items()},
    }
    if out is not None:
        pathlib.Path(out).write_text(json.dumps(result, indent=1))
    return result


def verify(result: dict) -> None:
    """The reference's asserts on the derived checks; raises AssertionError
    (also under ``python -O``)."""
    c = result["checks"]
    for ok, msg in [
        (c["frac_slots_gmsa_cheapest"] >= 0.9, "GMSA not cheapest in >=90% slots"),
        (c["gmsa_v1_max_avg_backlog"] < 50, "paper: V=1 backlog below 50"),
        (c["slope_data"] > 10 * max(c["slope_gmsa_v1"], 1e-9), "DATA backlog slope"),
        (c["slope_random"] > 10 * max(c["slope_gmsa_v1"], 1e-9), "RANDOM backlog slope"),
    ]:
        if not ok:
            raise AssertionError(msg)


def report(result: dict) -> list[dict]:
    """The figure's CSV lines; returns them as records."""
    c = result["checks"]
    us = float(np.mean(list(result["per_policy_us"].values())))
    return [
        emit("fig5a_cost_along_time", us,
             f"gmsa_cheapest_frac={c['frac_slots_gmsa_cheapest']:.3f}"),
        emit("fig5b_backlog_along_time", us,
             f"v1_max_backlog={c['gmsa_v1_max_avg_backlog']:.1f};"
             f"slopes_data/rand/gmsa={c['slope_data']:.3f}/{c['slope_random']:.3f}/"
             f"{c['slope_gmsa_v1']:.4f}"),
    ]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=N_RUNS)
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--out", default=None, help="write the figure's JSON here")
    ap.add_argument("--record", default=None, help="append the CSV records to this JSON list")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    result = run(args.runs, dev, args.out)
    records = report(result)
    verify(result)
    if args.record:
        write_record(args.record, "torch_fig5", records, dev)


if __name__ == "__main__":
    main()
