"""Chunked Monte-Carlo throughput: the runs axis in N chunks against one call.

The port of the JAX package's ``benchmarks/shard_bench.py``. The paper's
methodology is 1000 Monte-Carlo runs per configuration; the reference asks
whether sharding the ``runs`` axis over a host-device mesh buys wall-clock
without costing determinism. One card has one device, so the port's arms
are one chunk against N chunks (:mod:`repro_torch.distributed.mesh`), each
through ``simulate_many(..., mesh=runs_mesh(n))`` on the paper scenario
(facebook_4dc, T = 48, GMSA), the same generator seed:

* ``..._chunks1`` — ``runs_mesh(1)``, the call every figure script makes;
* ``..._chunksN`` — ``runs_mesh(N)``: the same draw, its runs in N chunks.

The N-chunk arm must be **bitwise identical** to the one-chunk arm on every
output of every run (asserted every run). Chunks bound the memory a call
holds; they add no parallelism on one card, so the reference's >= 3x
speedup gate (8 host CPUs) has no counterpart: the ratio is reported, not
gated. The CSV names are the reference's with ``chunks=`` where it writes
``devices=``.

    PYTHONPATH=src python -m repro_torch.benchmarks.shard_bench --chunks 8 --runs 1000
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.benchmarks.common import N_RUNS, emit, timed_compile_sweep, write_record
from repro_torch.configs.facebook_4dc import PaperSimConfig, make_sim_builder
from repro_torch.core.gmsa import gmsa_policy
from repro_torch.core.simulator import simulate_many
from repro_torch.device import resolve_device
from repro_torch.distributed.mesh import runs_mesh

#: Paper-methodology run count for the throughput claim.
SHARD_RUNS = 1000

#: Short horizon: the ratio is about the runs axis, not T.
SHARD_SLOTS = 48


def run(n_runs: int, n_chunks: int = 8, device=None) -> dict:
    """Both arms at ``n_runs`` runs: their outputs, µs per run (best of
    four warm calls) and first-call extra, and whether every output leaf is
    bitwise equal."""
    dev = resolve_device(device)
    _, build = make_sim_builder(PaperSimConfig(t_slots=SHARD_SLOTS), device=dev)
    arms = {}
    for n in (1, n_chunks):
        mesh = runs_mesh(n)
        arms[n] = timed_compile_sweep(
            lambda: simulate_many(build, gmsa_policy, torch.Generator(device=dev).manual_seed(0),
                                  n_runs, device=dev, mesh=mesh),
            n_runs, dev)
    one, many = arms[1][0], arms[n_chunks][0]
    bitwise = all(torch.equal(a, b) for a, b in zip(one, many))
    return {"n_runs": n_runs, "n_chunks": n_chunks, "bitwise": bitwise,
            "us": {n: a[1] for n, a in arms.items()},
            "first_us": {n: a[2] for n, a in arms.items()}}


def report(res: dict) -> list[dict]:
    """The reference's two CSV lines (``chunks=`` for ``devices=``)."""
    n_runs, n = res["n_runs"], res["n_chunks"]
    us1, usn = res["us"][1], res["us"][n]
    return [
        emit(f"shard_simulate_many_{n_runs}runs_dev1", us1,
             f"chunks=1;first_call_us={res['first_us'][1]:.0f}"),
        emit(f"shard_simulate_many_{n_runs}runs_dev{n}", usn,
             f"chunks={n};speedup_vs_dev1={us1 / max(usn, 1e-9):.2f}x;"
             f"bitwise={res['bitwise']};first_call_us={res['first_us'][n]:.0f}"),
    ]


def verify(res: dict) -> None:
    """The reference's determinism assert (its speedup gate applies to 8
    host CPUs and has no one-card counterpart)."""
    assert res["bitwise"], (
        "chunked Monte-Carlo must be bitwise identical to the one-chunk call "
        "(the determinism contract of sharded_runs)"
    )


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", type=int, default=8, help="chunks of the N-chunk arm (default 8)")
    ap.add_argument("--runs", type=int, default=min(SHARD_RUNS, N_RUNS),
                    help="Monte-Carlo runs per arm (default min(1000, REPRO_BENCH_RUNS))")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--record", default=None, help="append the CSV records to this JSON list")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    res = run(args.runs, args.chunks, dev)
    records = report(res)
    verify(res)
    if args.record:
        write_record(args.record, "torch_shard_bench", records, dev)
    return records


if __name__ == "__main__":
    main()
