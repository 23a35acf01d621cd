"""Shared helpers of the port's benches: the CSV stdout contract, timers,
and a record writer.

Unlike the JAX package's ``benchmarks/common.py`` this module makes no
directory and writes no file on import, never touches ``BENCH_sim.json``
(the JAX CPU history), and writes a record only to a path its caller
names. Under ``benchmarks/artifacts/`` (:data:`ART`) only the dry-run's
``dryrun_torch/`` records and the roofline's ``roofline_torch_*`` tables
are written, by those two modules.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import time

import torch

#: Paper methodology: 1000 Monte-Carlo runs (each entry point's ``--runs``
#: default). Override for quick iterations:
#: ``REPRO_BENCH_RUNS=100 python -m repro_torch.benchmarks.run``
N_RUNS = int(os.environ.get("REPRO_BENCH_RUNS", "1000"))

_REPO = pathlib.Path(__file__).resolve().parents[3]
#: The benches' artifact directory (the JAX package's ``benchmarks/common.ART``).
ART = _REPO / "benchmarks" / "artifacts"


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, device: torch.device, warmup: int = 1, iters: int = 3):
    """Wall-time ``fn()``, each call ending in a synchronize on CUDA:
    ``(result, µs per call)``, the mean of ``iters`` calls after
    ``warmup`` (the JAX package's ``benchmarks.common.timed``)."""
    result = None
    for _ in range(warmup):
        result = fn()
        sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        result = fn()
        sync(device)
    return result, (time.perf_counter() - t0) / iters * 1e6


def timed_compile_sweep(thunk, n_runs: int, device: torch.device, iters: int = 4):
    """Time a Monte-Carlo sweep ``thunk()``, its first call apart.

    The first call pays the kernels' build and CUDA initialisation (there
    is no compile step); steady state is the MINIMUM of ``iters`` further
    calls (best-of: on a shared host every timing above the minimum is
    interference). Each call ends in a synchronize on CUDA. Returns
    ``(outs, us_per_run, first_call_extra_us)``, the last being the first
    call's time beyond one steady call.
    """
    t0 = time.perf_counter()
    outs = thunk()
    sync(device)
    first_call_us = (time.perf_counter() - t0) * 1e6
    steady = []
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        outs = thunk()
        sync(device)
        steady.append((time.perf_counter() - t0) * 1e6)
    us_per_run = min(steady) / n_runs
    return outs, us_per_run, max(first_call_us - n_runs * us_per_run, 0.0)


def parse_derived(derived: str) -> dict:
    """Best-effort ``k=v;k=v`` -> dict (values floated when possible)."""
    out = {}
    for part in derived.split(";"):
        if "=" not in part:
            continue
        k, v = part.split("=", 1)
        try:
            out[k] = float(v.rstrip("%x"))
        except ValueError:
            out[k] = v
    return out


def emit(name: str, us_per_call: float, derived: str) -> dict:
    """Print one ``name,us_per_call,derived`` CSV line; return it as a record."""
    print(f"{name},{us_per_call:.1f},{derived}", flush=True)
    return {"name": name, "us_per_call": us_per_call, "derived": parse_derived(derived)}


def _git_sha() -> str | None:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=_REPO,
            capture_output=True, text=True, timeout=10,
        ).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def card() -> str | None:
    """The card's ``name, power.limit`` as nvidia-smi reports them, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def provenance(device: torch.device) -> dict:
    """Stamp for a record: backend, torch and CUDA versions, git SHA, and
    on CUDA the card's name and power limit."""
    stamp = {"backend": device.type, "torch_version": torch.__version__,
             "cuda_version": torch.version.cuda, "git_sha": _git_sha()}
    if device.type == "cuda":
        stamp["device_name"] = torch.cuda.get_device_name(device)
        stamp["card"] = card()
    return stamp


def write_record(path, label: str, records: list[dict], device: torch.device) -> None:
    """Append one entry (label, time, provenance, the records) to the JSON
    list at ``path``; the file is created if missing. Only ``path`` is
    written."""
    path = pathlib.Path(path)
    history = json.loads(path.read_text()) if path.exists() else []
    history.append({
        "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "label": label,
        **provenance(device),
        "benches": records,
    })
    path.write_text(json.dumps(history, indent=1) + "\n")
