"""Benchmark orchestrator on the port: one section per paper figure and the
systems benches. Prints ``name,us_per_call,derived`` CSV lines (the stdout
contract of the JAX package's ``benchmarks/run.py``).

  PYTHONPATH=src python -m repro_torch.benchmarks.run            # 1000 runs
  REPRO_BENCH_RUNS=100 PYTHONPATH=src python -m repro_torch.benchmarks.run
  ... python -m repro_torch.benchmarks.run --trace-dir DIR     # + profiler trace
  ... python -m repro_torch.benchmarks.run --record OUT.json   # + the records

Runs on CUDA unless ``--device cpu``. A bench that raises prints
``name,-1,FAILED`` and the run exits non-zero after the rest; a bench the
port does not run would print ``name,-1,SKIPPED <reason>`` (none is left).
``--record PATH`` appends every CSV record under the label ``torch_full``
(``torch_partial`` after a failure) to PATH. ``roofline`` tabulates the
dry-run's artifacts (``python -m repro_torch.launch.dryrun`` first: without
them it fails, as the reference's does) and writes its two tables beside
them; no other bench writes a file.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import traceback
from pathlib import Path

import torch

from repro_torch.benchmarks import (
    common,
    fig5,
    fig6,
    jobs_bench,
    kernel_bench,
    placement_bench,
    roofline,
    serve_bench,
    shard_bench,
    sim_bench,
)
from repro_torch.configs.facebook_4dc_stages import StagedPaperConfig
from repro_torch.device import resolve_device


def _verified(mod, result) -> list[dict]:
    """A bench's CSV lines, then its reference asserts (as its ``main``)."""
    records = mod.report(result)
    mod.verify(result)
    return records


#: name -> bench(device) -> its CSV records, each as its module's ``main``
#: runs it at ``common.N_RUNS`` runs.
BENCHES = {
    "fig5": lambda dev: _verified(fig5, fig5.run(common.N_RUNS, dev)),
    "fig6": lambda dev: _verified(fig6, fig6.run(common.N_RUNS, dev)),
    "sim_bench": lambda dev: sim_bench.run(device=dev),
    "placement_bench": lambda dev: _verified(
        placement_bench, placement_bench.run(common.N_RUNS, dev)),
    "jobs_bench": lambda dev: _verified(
        jobs_bench, jobs_bench.run(min(common.N_RUNS, StagedPaperConfig().n_runs), dev)),
    "kernel_bench": lambda dev: kernel_bench.run(dev),
    "serve_bench": lambda dev: serve_bench.main(["--device", str(dev)]),
    "shard_bench": lambda dev: _verified(
        shard_bench, shard_bench.run(min(shard_bench.SHARD_RUNS, common.N_RUNS), 8, dev)),
    # The dry-run's artifacts tabulated (written by repro_torch.launch.dryrun).
    "roofline": lambda dev: [roofline.tabulate()[1]],
}

#: The JAX package's benches the port does not run, with the reason: none
#: since the dry-run and kernel_bench were ported.
SKIPPED: dict[str, str] = {}


def run_benches(failures: list, device: torch.device, benches=None) -> list[dict]:
    """Every bench in ``benches`` (default :data:`BENCHES`), then the
    SKIPPED lines; a bench that raises is named in ``failures`` and its
    traceback printed. Returns the records of those that ran."""
    records = []
    for name, bench in (BENCHES if benches is None else benches).items():
        try:
            records.extend(bench(device))
        except Exception:  # noqa: BLE001  (report it, run the rest)
            failures.append(name)
            print(f"{name},-1,FAILED", flush=True)
            traceback.print_exc()
    for name, reason in SKIPPED.items():
        print(f"{name},-1,SKIPPED {reason}", flush=True)
    return records


def main(argv=None, benches=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--trace-dir", default=None, metavar="DIR",
                    help="wrap the whole suite in torch.profiler.profile and write its "
                         "Chrome trace to DIR/trace.json (open with Perfetto)")
    ap.add_argument("--record", default=None, metavar="PATH",
                    help="append the records to this JSON list (labels torch_full / "
                         "torch_partial)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    failures: list[str] = []
    print("name,us_per_call,derived")
    if args.trace_dir:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    else:
        prof = contextlib.nullcontext()
    with prof:
        records = run_benches(failures, dev, benches)
    if args.trace_dir:
        Path(args.trace_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(args.trace_dir) / "trace.json"))
    if args.record:
        common.write_record(args.record, "torch_partial" if failures else "torch_full",
                            records, dev)
    if failures:
        sys.exit(f"benchmark failures: {failures}")
    return records


if __name__ == "__main__":
    main()
