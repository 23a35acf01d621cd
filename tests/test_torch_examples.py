"""The port's user-facing entry points: the four examples and the bench
orchestrator, on the CPU at a few runs.

Each example's ``main(device="cpu", runs=…)`` prints the reference script's
table and returns its numbers; the test holds the example's own claim (the
same ``claims`` its command line exits non-zero on) and the printed table's
head. The orchestrator (``repro_torch.benchmarks.run``) is held to the JAX
package's ``name,us_per_call,derived`` stdout contract with stub benches
(a failure reported and the rest run, the SKIPPED lines, the record's
label, the profiler trace) and with one real bench; its bench list against
the reference's. No tolerance: the claims are strict inequalities and the
contract is exact.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path
from unittest import mock

import pytest
import torch

from repro_torch.benchmarks import common
from repro_torch.benchmarks import run as orchestrator
from repro_torch.examples import adaptive_placement, quickstart, serve_geo, staged_jobs

ROOT = Path(__file__).resolve().parents[1]
CSV_LINE = re.compile(r"^([\w.]+),(-?[0-9.]+),(.*)$")


def test_quickstart_gmsa_v100_is_cheapest_with_bounded_backlog(capsys):
    rows = quickstart.main(device="cpu", runs=8)
    text = capsys.readouterr().out
    assert "8 Monte-Carlo runs" in text and "avg cost $/slot" in text
    assert list(rows) == ["GMSA V=1", "GMSA V=100", "DATA", "RANDOM"]
    assert quickstart.claims(rows) == []
    assert min(rows, key=lambda name: rows[name]["cost"]) == "GMSA V=100"
    broken = dict(rows, DATA={"cost": 1.0, "backlog": 0.0})
    assert quickstart.claims(broken) == ["GMSA V=100 is not the cheapest policy",
                                         "a GMSA backlog is not below both baselines'"]


def test_staged_jobs_aware_arm_is_cheaper_in_both_acts(capsys):
    result = staged_jobs.main(device="cpu", runs=4)
    text = capsys.readouterr().out
    assert "Act 1" in text and "Act 2" in text and "map-stage locality per epoch" in text
    assert staged_jobs.claims(result) == []
    assert result["act1"]["saving"] > 0.0
    layout = result["act2"]["adaptive"]["layout"]
    assert layout.shape == (6, 4) and abs(layout.sum(axis=1) - 1.0).max() < 1e-5
    assert result["act2"]["static"]["placed"]["total_wan_gb"] == 0.0


def test_adaptive_placement_is_cheaper_and_never_dispatches_to_the_dead_site(capsys):
    result = adaptive_placement.main(device="cpu", runs=8)
    text = capsys.readouterr().out
    assert "=== site loss: ForestCity dies at slot 144 (hour 12) ===" in text
    assert "recovery timeline" in text and "death edge" in text
    assert adaptive_placement.claims(result) == []
    assert result["site_loss"]["total_recovery_gb"] > 0.0 and result["timeline_events"] > 0
    broken = dict(result, dead_site_mass=1.0)
    assert adaptive_placement.claims(broken) == ["1.0 dispatched to the dead site after the loss"]


def test_serve_geo_executes_both_classes(capsys):
    result = serve_geo.main(device="cpu", runs=6)
    text = capsys.readouterr().out
    assert "real model execution" in text and "V=100 (cost-greedy)" in text
    assert text.count("qwen2-0.5b->pod") == 6
    assert serve_geo.claims(result) == []
    assert result["v100"]["exec_jobs"] == 0


def test_examples_run_as_modules_and_default_to_cuda():
    """``--device`` reaches ``main``; without a card the default (CUDA)
    raises rather than falling back to the CPU."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-m", "repro_torch.examples.quickstart", "--device",
                          "cpu", "--runs", "2"], capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert "2 Monte-Carlo runs" in out.stdout
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve_geo.main()


def _lines(text):
    return [line for line in text.splitlines() if CSV_LINE.match(line)]


def test_orchestrator_csv_contract_failures_skips_and_record(tmp_path, capsys):
    def broken(dev):
        raise RuntimeError("bench fell over")

    benches = {"good": lambda dev: [common.emit("good_bench", 12.5, f"dev={dev.type};k=1")],
               "bad": broken}
    record = tmp_path / "bench.json"
    bench_sim = (ROOT / "BENCH_sim.json").read_bytes()
    with pytest.raises(SystemExit, match=r"benchmark failures: \['bad'\]"):
        orchestrator.main(["--device", "cpu", "--record", str(record)], benches=benches)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert out[1:3] == ["good_bench,12.5,dev=cpu;k=1", "bad,-1,FAILED"]
    skipped = [line.split(",", 2) for line in out if ",-1,SKIPPED" in line]
    assert [s[0] for s in skipped] == list(orchestrator.SKIPPED) == []
    assert all(s[2].startswith("SKIPPED ") and "," not in s[2] for s in skipped)
    history = json.loads(record.read_text())
    assert [h["label"] for h in history] == ["torch_partial"]
    assert history[0]["backend"] == "cpu"
    assert history[0]["benches"] == [{"name": "good_bench", "us_per_call": 12.5,
                                      "derived": {"dev": "cpu", "k": 1.0}}]
    trace = tmp_path / "prof"
    records = orchestrator.main(["--device", "cpu", "--record", str(record), "--trace-dir",
                                 str(trace)], benches={"good": benches["good"]})
    assert [r["name"] for r in records] == ["good_bench"]
    assert [h["label"] for h in json.loads(record.read_text())] == ["torch_partial", "torch_full"]
    assert "traceEvents" in json.loads((trace / "trace.json").read_text())
    assert (ROOT / "BENCH_sim.json").read_bytes() == bench_sim
    orchestrator.main(["--device", "cpu"], benches={"good": benches["good"]})
    assert len(json.loads(record.read_text())) == 2          # no --record: nothing written
    # shard_bench runs under the orchestrator: its two CSV lines, bitwise.
    capsys.readouterr()
    shard = orchestrator.BENCHES["shard_bench"]
    with mock.patch.object(common, "N_RUNS", 12):
        lines = shard(torch.device("cpu"))
    assert [r["name"] for r in lines] == ["shard_simulate_many_12runs_dev1",
                                          "shard_simulate_many_12runs_dev8"]
    assert lines[1]["derived"]["chunks"] == 8.0 and lines[1]["derived"]["bitwise"] == "True"
    assert len(capsys.readouterr().out.strip().splitlines()) == 2


def test_orchestrator_runs_a_real_bench_and_covers_the_reference_list(capsys):
    """sim_bench through the orchestrator: every CSV line has a positive
    us_per_call. The ported and SKIPPED benches are together the JAX
    orchestrator's list."""
    records = orchestrator.main(["--device", "cpu"],
                                benches={"sim_bench": orchestrator.BENCHES["sim_bench"]})
    lines = _lines(capsys.readouterr().out)
    ran = [CSV_LINE.match(line).groups() for line in lines if ",-1," not in line]
    assert [name for name, _, _ in ran] == [r["name"] for r in records]
    assert ran and all(float(us) > 0.0 for _, us, _ in ran)
    reference = re.findall(r'\("(\w+)", "benchmarks\.\w+"\)', (ROOT / "benchmarks" / "run.py")
                           .read_text())
    assert len(reference) == 9
    assert sorted(orchestrator.BENCHES) + sorted(orchestrator.SKIPPED) == \
           sorted(set(reference) - set(orchestrator.SKIPPED)) + sorted(orchestrator.SKIPPED)


def test_bench_runs_honour_repro_bench_runs():
    code = "from repro_torch.benchmarks import common, fig5; print(common.N_RUNS)"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "REPRO_BENCH_RUNS": "7"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "7"
    assert common.N_RUNS == int(os.environ.get("REPRO_BENCH_RUNS", "1000"))
