"""The readings a cell's limits are set from, on the card:

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 \\
        [--control-seeds 4 5 6] [--fault half_batch --fault-seeds 7 8 9] [--out FILE]

In one process, for each seed of ``--seeds`` the program's checked units
(a training cell's checked steps; a prefill cell's ``checked_units``
batches, with no window) against the plain reference; for each of
``--control-seeds`` the control, the reference in the precision below the
cell's (tf32 for fp32, fp8 for bf16) in the program's place; for each of
``--fault-seeds`` the program with ``--fault`` planted. One JSON line per
reading (the numbers compared and what they were worked out from), on
standard output and appended to ``--out``.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def _free(device) -> None:
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def reading(cell, seed: int, device, what: str, fault=None) -> dict:
    import torch

    from portbench import harness

    mix = dict(cell.mix, sample_span=cell.mix.get("checked_units", 1))
    t0 = time.perf_counter()
    traffic = harness.traffic_class(mix["kind"])(harness.model_config(cell.conf), cell.conf, mix,
                                                 seed, device, fault=fault)
    if what == "control":
        traffic.free_program()
        control = CONTROL[mix["dtype"]]
        if traffic.kind == "train":
            t1 = time.perf_counter()
            got = traffic.reference_readings(control)
            want = traffic.reference_readings("fp32")
            readings, details = traffic.readings(got, want), {"got": got, "want": want}
        else:
            traffic.kept = {i: None for i in range(mix["checked_units"])}
            t1 = time.perf_counter()
            readings = traffic.readings(traffic.outputs(control), traffic.outputs("fp32"))
            details = {}
    else:
        traffic.warmup()
        if traffic.kind == "prefill":
            for i in range(mix["checked_units"]):
                traffic.run_unit(i)
        harness.sync(device)
        traffic.free_program()
        t1 = time.perf_counter()
        readings, details = traffic.check()
    harness.sync(device)
    out = {"workload": cell.name, "seed": seed, "what": what, "fault": fault,
           "readings": readings, "program_s": t1 - t0, "reference_s": time.perf_counter() - t1,
           "details": details}
    if device.type == "cuda":
        out["device"] = torch.cuda.get_device_name(device)
    del traffic
    _free(device)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--fault")
    parser.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from portbench import harness

    from repro_torch.kernels import _build

    device = torch.device("cuda:0")
    cell = harness.load_cell(harness.load_json(ROOT / "BENCHMARK.json"), args.workload)
    _build.build_all(cell.mix["kernels"])
    plan = ([(s, "program", None) for s in args.seeds]
            + [(s, "control", None) for s in args.control_seeds]
            + [(s, "fault", args.fault) for s in args.fault_seeds])
    for seed, what, fault in plan:
        line = json.dumps(reading(cell, seed, device, what, fault))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
