"""GMSA simulator throughput on the port: µs per simulated run (288 slots).

Under the paper's configuration, as the JAX package's ``benchmarks/sim_bench.py``
reports it and with its row names:
(a) ``sim_python_loop_1run`` — a naive per-slot numpy loop, the
    paper-faithful unoptimized baseline (host only);
(b) ``sim_jit_scan_1run`` — the port's engine on one run (the name is the
    reference's; the port's slot loop is a Python loop of batched kernels);
(c) ``sim_vmap_{R}runs_per_run`` — ``simulate_many`` with R runs on a
    leading batch axis, per run.

    PYTHONPATH=src python -m repro_torch.benchmarks.sim_bench [--record PATH]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.benchmarks.common import emit, sync, write_record
from repro_torch.configs.facebook_4dc import PaperSimConfig, make_sim_builder
from repro_torch.core.gmsa import dispatch_fn
from repro_torch.core.simulator import simulate, simulate_many
from repro_torch.device import resolve_device


def python_loop_reference(inputs, v: float) -> tuple[float, float]:
    """Paper-faithful unvectorized engine: per-slot Python, per-DC numpy.
    Returns (time-average cost, final total backlog)."""
    host = lambda x: np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)
    t_slots, k_types = inputs.arrivals.shape
    n = inputs.mu.shape[1]
    q = np.zeros((n, k_types), np.float32)
    arr = host(inputs.arrivals)
    mu = host(inputs.mu)
    omega = host(inputs.omega)
    pue = host(inputs.pue)
    r = host(inputs.r)
    p = host(inputs.p_it)
    total_cost = 0.0
    for t in range(t_slots):
        wpue = omega[t] * pue[t]
        e = (r @ wpue) * p[:, None]                      # (K, N)
        score = arr[t][:, None] * ((q - mu[t]).T + v * e)
        best = score.argmin(axis=1)
        f = np.zeros((n, k_types), np.float32)
        f[best, np.arange(k_types)] = 1.0
        total_cost += float((f * arr[t][None, :]).T.flatten() @ e.flatten())
        q = np.maximum(q + f * arr[t][None, :] - mu[t], 0.0)
    return total_cost / t_slots, float(q.sum())


def run(run_counts=(100, 1000), device=None) -> list[dict]:
    """Time (a)–(c); prints the CSV lines and returns them as records."""
    dev = resolve_device(device)
    cfg = PaperSimConfig()
    template, build = make_sim_builder(cfg, device=dev)
    records = []

    t0 = time.perf_counter()
    cost_py, _ = python_loop_reference(template, 1.0)
    us_py = (time.perf_counter() - t0) * 1e6
    records.append(emit("sim_python_loop_1run", us_py, f"avg_cost={cost_py:.1f}"))

    pol = dispatch_fn(1.0)
    simulate(template, pol, None)                        # first call: CUDA init
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(10):
        simulate(template, pol, None)
        sync(dev)
    us_one = (time.perf_counter() - t0) * 1e6 / 10
    records.append(emit("sim_jit_scan_1run", us_one, f"speedup_vs_python={us_py / us_one:.1f}x"))

    for n_runs in run_counts:
        gen = lambda: torch.Generator(device=dev).manual_seed(0)
        simulate_many(build, pol, gen(), n_runs, device=dev)
        sync(dev)
        t0 = time.perf_counter()
        simulate_many(build, pol, gen(), n_runs, device=dev)
        sync(dev)
        us = (time.perf_counter() - t0) * 1e6 / n_runs
        records.append(emit(f"sim_vmap_{n_runs}runs_per_run", us, f"runs_per_sec={1e6 / us:.0f}"))
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--record", default=None, help="append the CSV records to this JSON list")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    records = run(device=dev)
    if args.record:
        write_record(args.record, "torch_sim_bench", records, dev)


if __name__ == "__main__":
    main()
