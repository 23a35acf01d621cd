"""Fig. 5's checks on each generator's trace realisation, run on each engine.

The paper scenario's traces (prices, PUE, links, dataset placement) and
every run's arrivals and service rates are drawn from seeds by a torch
generator on the builder's device, and the CPU's and CUDA's generators draw
different numbers from one seed. This bench tells the realisation apart
from the engine that simulates it:

* ``cross``: for each trace source (the CPU's or CUDA's generator) the
  bundle that ``fig5.run`` draws there is simulated by fig5's policies on
  each engine. GMSA and DATA are deterministic given the bundle; RANDOM
  draws its choices from the engine's own generator. Each row gives the
  checks, the policies' mean cost, and how far the engines' GMSA and DATA
  series lie apart on the same bundle.
* ``seeds``: fig5 on each engine at further ``trace_seed`` values.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig5_traces [--runs 1000] [--seeds 1 2 3]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib

import numpy as np
import torch

from repro_torch.benchmarks import fig5
from repro_torch.benchmarks.common import N_RUNS
from repro_torch.configs.facebook_4dc import PaperSimConfig, make_sim_builder
from repro_torch.core.simulator import SimInputs
from repro_torch.device import resolve_device

#: Policies that draw nothing from the generator: on one bundle their
#: series differ between engines only by rounding.
DETERMINISTIC = ("GMSA_V1", "GMSA_V10", "DATA")


def _row(series: dict, t_slots: int, **labels) -> dict:
    checks = fig5.derived_checks(series, t_slots)
    try:
        fig5.verify({"checks": checks})
        holds = True
    except AssertionError:
        holds = False
    mean_cost = {name: float(np.mean(s["cost"])) for name, s in series.items()}
    return {**labels, "checks": checks, "asserts_hold": holds, "mean_cost": mean_cost}


def cross(n_runs: int, engines=("cpu", "cuda"), cfg: PaperSimConfig | None = None) -> list[dict]:
    """Each source's bundle on each engine (see the module docstring)."""
    cfg = cfg or PaperSimConfig()
    rows = []
    for source in engines:
        src = resolve_device(source)
        _, build = make_sim_builder(cfg, device=src)
        bundle = build(torch.Generator(device=src).manual_seed(fig5.SEED), n_runs)
        first = None
        for engine in engines:
            dev = resolve_device(engine)
            if dev == src:
                engine_build = build            # fig5.run's own path
            else:
                moved = SimInputs(*(x.to(dev) for x in bundle))
                engine_build = lambda g, n, moved=moved: moved
            series, _ = fig5.policy_series(engine_build, n_runs, dev)
            row = _row(series, cfg.t_slots, source=src.type, engine=dev.type)
            if first is None:
                first = series
            else:
                row["deterministic_series_max_rel_diff"] = max(
                    float(np.max(np.abs(series[p][k] - first[p][k])
                                 / np.maximum(np.abs(first[p][k]), 1.0)))
                    for p in DETERMINISTIC for k in ("cost", "backlog"))
            rows.append(row)
    return rows


def seeds(n_runs: int, trace_seeds, engines=("cpu", "cuda")) -> list[dict]:
    """fig5 at each ``trace_seed`` on each engine, its own draws."""
    rows = []
    for seed in trace_seeds:
        cfg = dataclasses.replace(PaperSimConfig(), trace_seed=seed)
        for engine in engines:
            dev = resolve_device(engine)
            _, build = make_sim_builder(cfg, device=dev)
            series, _ = fig5.policy_series(build, n_runs, dev)
            rows.append(_row(series, cfg.t_slots, trace_seed=seed, engine=dev.type))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=N_RUNS)
    ap.add_argument("--seeds", type=int, nargs="*", default=[1, 2, 3],
                    help="further trace_seed values (the scenario's own is "
                         f"{PaperSimConfig().trace_seed})")
    ap.add_argument("--engines", nargs="+", default=["cpu", "cuda"])
    ap.add_argument("--out", default=None, help="write the rows as JSON here")
    args = ap.parse_args(argv)
    result = {"n_runs": args.runs, "cross": cross(args.runs, args.engines),
              "seeds": seeds(args.runs, args.seeds, args.engines)}
    for row in result["cross"] + result["seeds"]:
        print(json.dumps(row), flush=True)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
