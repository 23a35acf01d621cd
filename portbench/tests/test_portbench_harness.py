"""The harness driven end to end on the CPU at the program's smoke sizes
(the look for a card skipped): a sound run comes out correct; the same run
with the program's path broken underneath, or with the control (the
reference in the precision below the cell's) in the program's place, comes
out not correct."""

import json
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT, small_cell
from portbench import calibrate, harness

CELLS = ["mamba2-2.7b.train-bf16-8x2048", "hymba-1.5b.prefill-fp32-4x2048",
         "mamba2-2.7b.prefill-fp32-4x2048"]
#: The faults each kind of cell can have.
FAULTS = {"train": ["unchanged", "half_batch"],
          "prefill": ["unchanged", "half_batch", "altered"]}


def run(bench, name, fault=None, trace=False):
    cell = small_cell(bench, name)
    return harness.run_cell(bench, name, 2_718_281_828, 0.3, trace, "cpu", time.time(),
                            fault=fault, cell=cell)[0]


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct_and_reports_the_cells_metrics(bench, name):
    result = run(bench, name)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    cell = harness.load_cell(bench, name)
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(cell.limits)


@pytest.mark.parametrize("name,fault", [(c, f) for c in CELLS
                                        for f in FAULTS["train" if "train" in c else "prefill"]])
def test_a_fault_in_the_programs_path_is_not_correct(bench, name, fault):
    assert not run(bench, name, fault)["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_a_limit(bench, name):
    cell = small_cell(bench, name)
    readings = calibrate.reading(cell, 31_415_926_535, torch.device("cpu"), "control")["readings"]
    assert any(readings[k] > cell.limits[k]["limit"] for k in readings), readings


def test_a_traced_run_reports_per_layer_metrics_only(bench):
    result = run(bench, "hymba-1.5b.prefill-fp32-4x2048", trace=True)
    names = {m["name"] for m in harness.load_cell(bench, "hymba-1.5b.prefill-fp32-4x2048").per_layer}
    assert set(result["metrics"]) <= names and "prefill_mfu_pct" in result["metrics"]
    assert {"busy_s", "window_s"} <= set(result["device"]) and "breakdown" in result


def test_the_same_seed_makes_the_same_inputs():
    from portbench.inputs import make_tokens, make_weights
    from portbench.reference.lm import layer_module
    from conftest import SMOKE

    m = dict(json.loads((ROOT / "portbench/configs/hymba-1.5b.json").read_text())["model"],
             **SMOKE["hymba-1.5b"])
    fam = layer_module("hymba")
    a, b = (make_weights(m, 2**31 + 5, torch.bfloat16, "cpu", fam),
            make_weights(m, 2**31 + 5, torch.bfloat16, "cpu", fam))
    assert all(torch.equal(a["blocks"][k], b["blocks"][k]) for k in a["blocks"])
    assert torch.equal(make_tokens(m, 2**31 + 5, 2, 3, 7, 1.1, "cpu"),
                       make_tokens(m, 2**31 + 5, 2, 3, 7, 1.1, "cpu"))
    assert not torch.equal(make_tokens(m, 1, 2, 3, 7, 1.1, "cpu"),
                           make_tokens(m, 2, 2, 3, 7, 1.1, "cpu"))


def test_without_a_card_or_the_program_it_exits_non_zero_and_prints_no_result(tmp_path):
    cmd = [sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", "1",
           "--seconds", "1", "--trace", "0"]
    if not torch.cuda.is_available():
        out = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT, timeout=300)
        assert out.returncode != 0 and out.stdout.strip() == ""
    # A directory with the benchmark and nothing of the program.
    subprocess.run(["cp", "-r", str(ROOT / "portbench"), str(ROOT / "BENCHMARK.json"),
                    str(tmp_path)], check=True)
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_each_cell_runs_correct_on_the_card():
    """On the card: each cell once, a short window, through the command."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for name in CELLS:
        out = subprocess.run([sys.executable, "portbench/run.py", "--workload", name, "--seed",
                              "3141592653", "--seconds", "5", "--trace", "0"],
                             capture_output=True, text=True, cwd=ROOT, timeout=900)
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"], out.stderr[-2000:]
