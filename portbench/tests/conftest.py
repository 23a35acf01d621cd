"""The benchmark's own tests (run them with ``python -m pytest portbench/tests``
from the repository's root): the frozen arithmetic, the configured cells'
weights and work pinned, the plain references against the program on the
CPU at the program's smoke sizes, the harness driven end to end on the CPU
with the program's path broken underneath, a toy family defined through
every hook of a family's module, and what the benchmark imports. Tests
marked ``cuda`` need the card."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: The program's smoke sizes of each configuration (``repro_torch.configs``).
SMOKE = {
    "mamba2-2.7b": dict(num_layers=2, d_model=128, vocab_size=512, ssm_state=16,
                        ssm_head_dim=32, ssm_chunk=32),
    "hymba-1.5b": dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                       vocab_size=512, head_dim=32, ssm_state=16, ssm_head_dim=32, ssm_chunk=32,
                       sliding_window=64),
}
#: Small mixes of each kind: short sequences, a few units.
SMALL_MIX = {
    "train": dict(rows=4, seq_len=64, units=8, profiled_units=1),
    "prefill": dict(rows=4, seq_len=96, units=8, checked_units=2, sample_span=3,
                    profiled_units=2),
}


@pytest.fixture
def bench():
    from portbench import harness

    return harness.load_json(ROOT / "BENCHMARK.json")


def small_cell(bench, name):
    """``name``'s cell at the program's smoke sizes and a small mix."""
    from portbench import harness

    cell = harness.load_cell(bench, name)
    cell.conf = dict(cell.conf, model=dict(cell.conf["model"], **SMOKE[cell.conf["name"]]))
    cell.mix = dict(cell.mix, **SMALL_MIX[cell.mix["kind"]])
    return cell
