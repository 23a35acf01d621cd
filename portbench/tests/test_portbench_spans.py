"""The reduction of the program's spans (``portbench.spans``) on synthetic
profiler events, its readers' arithmetic, and the harness's traced CPU run
of each small cell, where the span metrics find nothing to read."""

import time
import types

import pytest

from conftest import small_cell
from portbench import harness, spans, trace

CELLS = ["mamba2-2.7b.train-bf16-8x2048", "hymba-1.5b.prefill-fp32-4x2048",
         "mamba2-2.7b.prefill-fp32-4x2048"]
SPAN_METRICS = {"forward_ms.train": "train", "backward_ms.train": "train",
                "optimizer_ms.train": "train", "alloc_retries.train": "train",
                "attention_pct.prefill": "prefill", "ffn_pct.prefill": "prefill",
                "ssm_pct.prefill": "prefill"}


def host(name, start, end, id=0):
    return spans.Event(name, False, start, end, id, False)


def device(name, start, end, id, annotation=False):
    return spans.Event(name, True, start, end, id, annotation)


def launched(name, start, end, id, at):
    """A kernel and the runtime call that launched it at ``at``."""
    return [host("cudaLaunchKernel", at, at + 1, id=id), device(name, start, end, id=id)]


def test_a_device_user_annotation_adds_nothing():
    events = [host("train.forward", 0, 100),
              *launched("gemm", 20, 30, id=5, at=2), *launched("add", 50, 60, id=6, at=4),
              device("train.forward", 15, 60, id=99, annotation=True)]
    busy, found, gaps = spans.reduce(events)
    assert busy == pytest.approx(20e-6)
    assert found == {"train.forward": (pytest.approx(20e-6), 1)}
    assert gaps == [["train.forward > host (no operation)", pytest.approx(20e-6)]]


def test_a_kernel_counts_to_the_span_open_at_its_launch_on_any_thread():
    """The backward launches from autograd's thread while ``train.backward``
    is open on the caller's: the launch's time decides, not its thread."""
    events = [host("train.step", 0, 400), host("train.backward", 100, 200),
              *launched("bwd", 300, 340, id=9, at=150),
              *launched("after", 350, 360, id=10, at=210)]
    _, found, _ = spans.reduce(events)
    assert found["train.backward"] == (pytest.approx(40e-6), 1)
    assert found["train.step"] == (pytest.approx(50e-6), 1)


def test_a_span_takes_the_union_of_its_operations_on_the_device():
    """Two kernels that overlap count once, as in busy_s."""
    events = [host("train.optimizer", 0, 50), *launched("a", 100, 130, id=1, at=5),
              *launched("b", 120, 140, id=2, at=6)]
    busy, found, _ = spans.reduce(events)
    assert found == {"train.optimizer": (pytest.approx(40e-6), 1)}
    assert busy == pytest.approx(40e-6)


def test_spans_of_one_name_sum_their_kernels_and_count_each_range():
    events = [host("lm.ssm", 0, 10), host("lm.ssm", 20, 30),
              *launched("a", 100, 110, id=1, at=5), *launched("b", 120, 125, id=2, at=25),
              *launched("c", 130, 140, id=3, at=15)]
    _, found, _ = spans.reduce(events)
    assert found == {"lm.ssm": (pytest.approx(15e-6), 2)}


def test_a_gap_inside_the_optimizer_is_named_by_its_span():
    events = [host("train.step", 0, 2000), host("train.optimizer", 0, 1000),
              host("aten::mul", 100, 400), *launched("k0", 0, 50, id=1, at=1),
              *launched("k1", 300, 350, id=2, at=120)]
    _, _, gaps = spans.reduce(events)
    assert gaps == [["train.optimizer > aten::mul", pytest.approx(250e-6)]]


def test_a_trace_without_spans_gives_the_old_readings():
    events = [host("aten::mm", 0, 50), host("aten::mul", 60, 200), host("aten::add", 210, 260)]
    for i, (a, b) in enumerate([(5, 40), (30, 45), (100, 120), (240, 300), (303, 310)]):
        events += launched(f"k{i}", a, b, id=i + 1, at=a - 1)
    busy, found, gaps = spans.reduce(events)
    on_device = [(e.start, e.end) for e in events if e.on_device]
    merged = trace._merge(on_device)
    old_gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)
                if merged[i + 1][0] - merged[i][1] >= trace.MIN_GAP_US]
    old_idle = trace._attribute(old_gaps, [(e.start, e.end, e.name) for e in events
                                           if not e.on_device])
    assert found == {}
    assert busy == sum(b - a for a, b in merged) * 1e-6
    assert gaps == [[name, sec] for name, sec in sorted(old_idle.items(), key=lambda kv: -kv[1])]


def _ctx(kind, span_trace):
    return types.SimpleNamespace(kind=kind, trace=types.SimpleNamespace(busy_s=1.0),
                                 span_trace=span_trace)


def _read(name, ctx):
    return harness.load_reader(harness.HERE / "metrics" / f"{name}.py").read(ctx)


def test_the_readers_divide_by_steps_and_by_busy_time():
    train = spans.SpanTrace(busy_s=5.0, allocator=3, idle_gaps=[],
                            spans={"train.step": (5.0, 2), "train.forward": (1.2, 4),
                                   "train.backward": (3.5, 4), "train.optimizer": (0.3, 2)})
    ctx = _ctx("train", train)
    assert _read("forward_ms.train", ctx) == pytest.approx(600.0)
    assert _read("backward_ms.train", ctx) == pytest.approx(1750.0)
    assert _read("optimizer_ms.train", ctx) == pytest.approx(150.0)
    assert _read("alloc_retries.train", ctx) == pytest.approx(1.5)
    assert _read("attention_pct.prefill", ctx) is None
    prefill = spans.SpanTrace(busy_s=2.0, allocator=0, idle_gaps=[],
                              spans={"lm.ssm": (1.5, 192)})
    ctx = _ctx("prefill", prefill)
    assert _read("ssm_pct.prefill", ctx) == pytest.approx(75.0)
    assert _read("attention_pct.prefill", ctx) is None
    assert _read("forward_ms.train", ctx) is None


def test_without_spans_the_readers_find_nothing():
    """A program that opens no span (the parent of the spans)."""
    empty = spans.SpanTrace(busy_s=5.0, allocator=0, idle_gaps=[], spans={})
    for name, kind in SPAN_METRICS.items():
        assert _read(name, _ctx(kind, empty)) is None


def test_the_span_names_are_the_programs_and_each_metric_is_in_the_benchmark(bench):
    from repro_torch.telemetry.ranges import SPANS

    assert spans.SPAN_NAMES == SPANS
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in SPAN_METRICS:
        assert per_layer[name]["source"] == "device_trace" and per_layer[name]["workloads"]


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_cpu_run_reports_no_span_metric(bench, name):
    cell = small_cell(bench, name)
    result = harness.run_cell(bench, name, 2**31 + 11, 0.3, True, "cpu", time.time(),
                              cell=cell)[0]
    assert result["correct"], result["checks"]
    assert not set(result["metrics"]) & set(SPAN_METRICS)
    asked = {m["name"] for m in harness.load_cell(bench, name).per_layer}
    assert {n for n, kind in SPAN_METRICS.items() if kind == cell.mix["kind"]} & asked


def test_a_profiled_program_step_reduces_to_its_span_counts():
    """The profiler's raw events of a CPU train step at smoke sizes: every
    span counted as the program opens it, none with device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from conftest import SMOKE
    from repro_torch.models import lm
    from repro_torch.train import TrainStepConfig, adamw_init, make_train_step

    conf = harness.load_json(harness.HERE / "configs" / "hymba-1.5b.json")
    cfg = harness.model_config(dict(conf, model=dict(conf["model"], **SMOKE["hymba-1.5b"])))
    gen = torch.Generator().manual_seed(5)
    params = lm.init_params(cfg, gen, device="cpu")
    step, init_efb = make_train_step(cfg, TrainStepConfig(microbatches=2, remat="full"),
                                     device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 17), generator=gen)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:], "loss_mask": torch.ones(2, 16)}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, adamw_init(params), batch, init_efb(params))
    busy, found, gaps = spans.reduce(spans.events(prof))
    layers = 2 * 2 * cfg.num_layers          # microbatches x (forward, recompute)
    assert busy == 0.0 and gaps == []
    assert found == {"train.step": (0.0, 1), "train.forward": (0.0, 2),
                     "train.backward": (0.0, 2), "train.optimizer": (0.0, 1),
                     "lm.attention": (0.0, layers), "lm.ssm": (0.0, layers),
                     "lm.ffn": (0.0, layers)}
