"""Paper Fig. 6 on the port — sensitivity to the control parameter V (0.001 … 1000).

(a) time-average energy cost vs V — GMSA decreases monotonically toward the
    optimum, baselines flat ~$750; best-case reduction ~30%;
(b) time-average backlog vs V — grows with V (the O(1/V)/O(V) trade-off).

The whole V-grid runs through :func:`repro_torch.core.sweep.sweep_grid`:
one slot loop for all |V| x n_runs simulations. The bench also times the
per-cell loop (one ``simulate_many`` per V) with the same best-of
estimator and reports both (``fig6_grid_vs_percell``). The same grid,
checks and asserts as the JAX package's ``benchmarks/fig6.py``; its
``*_compile_us`` keys hold here each path's first-call overhead (kernel
build, CUDA initialisation), as there is no compile step.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig6 [--runs 1000] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import torch

from repro_torch.benchmarks.common import N_RUNS, emit, sync, timed_compile_sweep, write_record
from repro_torch.configs.facebook_4dc import PaperSimConfig, make_sim_builder
from repro_torch.core.baselines import data_dispatch, greedy_cost_dispatch, random_dispatch
from repro_torch.core.gmsa import gmsa_policy
from repro_torch.core.simulator import simulate_many
from repro_torch.core.sweep import sweep_grid
from repro_torch.device import resolve_device

#: Paper grid (0.001…100) + one extra decade to exhibit the backlog
#: crossing of Fig. 6(b) under the repo's calibration (EXPERIMENTS.md §Calibration).
V_GRID = (0.001, 0.01, 0.1, 1.0, 10.0, 100.0, 1000.0)
SEED = 43


def derived_checks(rows: dict, base: dict) -> dict:
    """The figure's derived checks from the per-V GMSA rows and the
    baselines' rows, as the JAX package's ``benchmarks/fig6.py`` derives
    them."""
    costs = [rows[v]["cost"] for v in V_GRID]
    backlogs = [rows[v]["backlog"] for v in V_GRID]
    baseline_cost = 0.5 * (base["DATA"]["cost"] + base["RANDOM"]["cost"])
    baseline_backlog = min(base["DATA"]["backlog"], base["RANDOM"]["backlog"])
    # the paper reports its headline reduction at the top of its grid (V=100)
    reduction = 1.0 - rows[100.0]["cost"] / baseline_cost
    crossing_v = next(
        (v for v in V_GRID if rows[v]["backlog"] > baseline_backlog), None
    )
    return {
        "cost_monotone_nonincreasing": bool(
            all(costs[i + 1] <= costs[i] * 1.01 for i in range(len(costs) - 1))
        ),
        "backlog_monotone_nondecreasing": bool(
            all(backlogs[i + 1] >= backlogs[i] * 0.99 for i in range(len(backlogs) - 1))
        ),
        "baseline_cost": baseline_cost,
        "best_gmsa_cost": min(costs),
        "reduction_at_v100": reduction,
        "greedy_floor_cost": base["GREEDY"]["cost"],
        "backlog_crossing_v": crossing_v,
    }


def run(n_runs: int = N_RUNS, device=None, out=None) -> dict:
    """The V-grid, the per-cell comparison and the baselines over the same
    seeded traces; returns rows, timings and derived checks. Writes them as
    JSON to ``out`` only when given."""
    dev = resolve_device(device)
    cfg = PaperSimConfig()
    _, build = make_sim_builder(cfg, device=dev)
    gen = lambda: torch.Generator(device=dev).manual_seed(SEED)

    outs, grid_us_per_run, grid_compile_us = timed_compile_sweep(
        lambda: sweep_grid(build, gmsa_policy, gen(), n_runs, V_GRID, device=dev),
        n_runs * len(V_GRID), dev,
    )
    rows = {
        v: {
            "cost": float(outs.cost[i].mean()),
            "backlog": float(outs.backlog_avg[i].mean()),
        }
        for i, v in enumerate(V_GRID)
    }
    del outs

    def percell_pass():
        last = None
        for v in V_GRID:
            last = simulate_many(build, gmsa_policy, gen(), n_runs, scalar=v, device=dev)
        return last

    _, percell_us_per_run, percell_compile_us = timed_compile_sweep(
        percell_pass, n_runs * len(V_GRID), dev
    )

    t1 = time.perf_counter()
    base = {}
    for name, pol in [("DATA", data_dispatch), ("RANDOM", random_dispatch),
                      ("GREEDY", greedy_cost_dispatch)]:
        o = simulate_many(build, pol, gen(), n_runs, device=dev)
        base[name] = {
            "cost": float(o.cost.mean()),
            "backlog": float(o.backlog_avg.mean()),
        }
    sync(dev)
    baselines_us = (time.perf_counter() - t1) * 1e6
    # The figure's own cost (first grid call + one steady grid + baselines),
    # without the per-cell comparison above.
    total_us = (grid_compile_us + n_runs * len(V_GRID) * grid_us_per_run
                + baselines_us)

    result = {
        "n_runs": n_runs,
        "v_grid": list(V_GRID),
        "gmsa": rows,
        "baselines": base,
        "sweep_grid": {
            "grid_us_per_run": grid_us_per_run,
            "grid_compile_us": grid_compile_us,
            "percell_us_per_run": percell_us_per_run,
            "percell_compile_us": percell_compile_us,
        },
        "checks": derived_checks(rows, base),
        "total_us": total_us,
    }
    if out is not None:
        pathlib.Path(out).write_text(json.dumps(result, indent=1))
    return result


def verify(result: dict) -> None:
    """The reference's asserts on the derived checks; raises AssertionError
    (also under ``python -O``)."""
    c = result["checks"]
    for ok, msg in [
        (c["cost_monotone_nonincreasing"], "Fig6a: cost must fall with V"),
        (c["backlog_monotone_nondecreasing"], "Fig6b: backlog must rise with V"),
        (0.2 <= c["reduction_at_v100"] <= 0.45,
         f"paper claims ~30% reduction; got {100*c['reduction_at_v100']:.1f}%"),
    ]:
        if not ok:
            raise AssertionError(msg)


def report(result: dict) -> list[dict]:
    """The figure's CSV lines; returns them as records."""
    c = result["checks"]
    s = result["sweep_grid"]
    return [
        emit("fig6a_cost_vs_V", result["total_us"] / (len(V_GRID) + 3),
             f"baseline={c['baseline_cost']:.0f};best={c['best_gmsa_cost']:.0f};"
             f"reduction={100*c['reduction_at_v100']:.1f}%"),
        emit("fig6b_backlog_vs_V", result["total_us"] / (len(V_GRID) + 3),
             f"monotone_cost={c['cost_monotone_nonincreasing']};"
             f"monotone_backlog={c['backlog_monotone_nondecreasing']};"
             f"crosses_baselines_at_V={c['backlog_crossing_v']}"),
        emit("fig6_grid_vs_percell", s["grid_us_per_run"],
             f"percell_us_per_run={s['percell_us_per_run']:.1f};"
             f"steady_speedup={s['percell_us_per_run']/max(s['grid_us_per_run'],1e-9):.2f}x;"
             f"grid_compile_us={s['grid_compile_us']:.0f};"
             f"percell_compile_us={s['percell_compile_us']:.0f}"),
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
        write_record(args.record, "torch_fig6", records, dev)


if __name__ == "__main__":
    main()
