"""The harness: one run of one cell, from ``BENCHMARK.json`` and the files
the names in it lead to.

A cell names a configuration and a traffic mix. The harness loads

* ``portbench/configs/<config>.json``: the sizes as run (``model``) and the
  reference's module (``reference``);
* ``portbench/traffic/<traffic>.json``: the mix's parameters, whose
  ``kind`` names the generator ``portbench/kinds/<kind>.py``;
* ``portbench/limits/<cell>.json``: the limit of each number compared;
* ``portbench/e2e/<metric>.py`` for each end-to-end metric the cell
  reports and ``portbench/metrics/<metric>.py`` for each per-layer one:
  each a ``read(ctx)`` that returns the metric's value, or ``None`` where
  it finds nothing to read (the metric is then left out of the line); a
  per-layer reader may declare the program's launch counters it reads
  (``COUNTERS``, as in ``portbench.trace``), which the traced stretch
  then reads beside the benchmark's own.

A run: set-up (the program's kernels built or loaded, the weights and
tokens made on the device, the traffic's warm-up), the window of
``seconds``, with ``trace`` a profiled stretch of ``profiled_units``
units after it, the peak memory, then the program's state is freed and
its outputs are compared with the plain reference's.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
import time
import types
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_reader(path: Path):
    """A reader module by file path (a metric's name may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"portbench_reader_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    conf: dict               # the configuration file
    mix: dict                # the traffic file
    limits: dict             # number -> {"limit": ...}
    end_to_end: list         # BENCHMARK.json entries this cell reports
    per_layer: list


def reports(entry: dict, cell: str, e2e_names: set | None = None) -> bool:
    """Whether ``cell`` reports the metric of ``entry``: it is listed under
    the metric's ``workloads``, or the metric has none and (per-layer) moves
    an end-to-end metric the cell reports."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    return e2e_names is None or entry["moves"] in e2e_names


def load_cell(bench: dict, name: str) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    return Cell(name=name, conf=load_json(HERE / "configs" / f"{w['config']}.json"),
                mix=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(HERE / "limits" / f"{name}.json"), end_to_end=e2e,
                per_layer=layer)


def model_config(conf: dict):
    """The program's ``ModelConfig`` for a configuration file."""
    from repro_torch.configs.base import ModelConfig

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(name=conf["name"], **{k: v for k, v in conf["model"].items() if k in fields})


def traffic_class(kind: str):
    return importlib.import_module(f"portbench.kinds.{kind}").Traffic


@dataclasses.dataclass
class Window:
    start: float
    end: float
    units: list              # [(issued, returned)] host times of each unit
    unit_tokens: int


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_window(traffic, seconds: float, device) -> Window:
    """Units one after another until ``seconds`` have passed since the first
    was issued; the window ends when the device has finished the last."""
    sync(device)
    units = []
    start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        traffic.run_unit(i)
        t1 = time.perf_counter()
        units.append((t0, t1))
        i += 1
        if t1 - start >= seconds:
            break
    sync(device)
    return Window(start=start, end=time.perf_counter(), units=units,
                  unit_tokens=traffic.unit_tokens)


def loaded_forbidden() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def load_readers(entries: list, folder: str) -> dict:
    """Each metric's reader module, by name, from ``portbench/<folder>/``."""
    return {m["name"]: load_reader(HERE / folder / f"{m['name']}.py") for m in entries}


def counters_of(readers: dict) -> dict:
    """The launch counters a traced stretch reads: those the readers
    declare, and ``portbench.trace.COUNTERS``, which no reader overrides."""
    from portbench.trace import COUNTERS

    out: dict = {}
    for reader in readers.values():
        out.update(getattr(reader, "COUNTERS", {}))
    return {**out, **COUNTERS}


def read_metrics(entries: list, readers: dict, ctx) -> dict:
    out = {}
    for m in entries:
        value = readers[m["name"]].read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool, device,
             process_start: float, fault=None, cell: Cell | None = None):
    """One run of ``workload``: (the result line's object, the readings'
    details for the log). ``cell`` (the cell at other sizes) and ``fault``
    (a fault planted in the program's path) serve the harness's tests."""
    cell = cell or load_cell(bench, workload)
    device = torch.device(device)
    phases = {"to_harness": time.time() - process_start}
    mark = time.perf_counter()

    def phase(name):
        nonlocal mark
        now = time.perf_counter()
        phases[name] = now - mark
        mark = now

    if device.type == "cuda":
        from repro_torch.kernels import _build

        _build.build_all(cell.mix["kernels"])
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats()
    phase("kernels")
    traffic = traffic_class(cell.mix["kind"])(model_config(cell.conf), cell.conf, cell.mix,
                                              seed, device, fault=fault)
    sync(device)
    phase("inputs")
    traffic.warmup()
    sync(device)
    phase("warmup")
    setup_s = time.time() - process_start
    window = run_window(traffic, seconds, device)
    phase("window")
    attempted, failed = traffic.failed_units()
    ctx = types.SimpleNamespace(cell=cell.name, kind=traffic.kind, traffic=traffic,
                                window=window, setup_s=setup_s, trace=None)
    if trace:
        from portbench.trace import profile

        readers = load_readers(cell.per_layer, "metrics")
        first = len(window.units)
        n = cell.mix["profiled_units"]
        ctx.trace = profile(lambda: [traffic.run_unit(first + j) for j in range(n)], device,
                            counters_of(readers))
        metrics = read_metrics(cell.per_layer, readers, ctx)
        phase("trace")
    else:
        metrics = read_metrics(cell.end_to_end, load_readers(cell.end_to_end, "e2e"), ctx)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    traffic.free_program()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    phase("free")
    readings, details = traffic.check()
    sync(device)
    phase("check")
    details = dict(details, phases_s=phases,
                   unit_s=[round(t1 - t0, 5) for t0, t1 in window.units])
    checks = {name: {"value": readings[name], "limit": cell.limits[name]["limit"]}
              for name in readings}
    correct = (failed == 0 and attempted > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics}
    result["device"] = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": peak,
    }
    if ctx.trace is not None:
        result["device"].update(busy_s=ctx.trace.busy_s, window_s=ctx.trace.window_s)
        result["breakdown"] = {"device_ops": ctx.trace.device_ops,
                               "idle_gaps": ctx.trace.idle_gaps}
    result["checks"] = checks
    return result, details
