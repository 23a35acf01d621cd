"""gemm_f32_roofline.prefill: the products it counts are the program's
weight products, its share reads 100% at the bound, and it finds nothing
in a trace without the kernel or with calls it did not count."""

import json
import types

import pytest

from conftest import ROOT
from portbench import harness, work
from portbench.trace import Trace

READER = harness.load_reader(ROOT / "portbench" / "metrics" / "gemm_f32_roofline.prefill.py")
KERNEL = "(anonymous namespace)::gemm_f32_kernel(CUtensorMap_st, CUtensorMap_st, float*, long)"
#: Kernel launches per 4 x 2048 batch, as the program's counter read them.
CALLS = {"mamba2-2.7b": 192, "hymba-1.5b": 320}


def model(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())["model"]


def ctx(name, seconds, calls, units=3, kind="prefill"):
    traffic = types.SimpleNamespace(model=model(name), rows=4, seq=2048,
                                    mix={"profiled_units": units})
    trace = Trace(window_s=1.0, busy_s=1.0, counters={}, device_ops=[], idle_gaps=[],
                  kernels={KERNEL: (seconds, calls)} if calls else {})
    return types.SimpleNamespace(kind=kind, traffic=traffic, trace=trace)


def bound_per_batch(name):
    m, mod = 4 * 2048, model(name)
    return mod["num_layers"] * sum(
        work.bound_s(4 * (m * k + k * n + m * n), 3 * 2 * m * n * k, "float32")
        for k, n in READER.layer_products(mod) if n > READER.NARROW)


@pytest.mark.parametrize("name", sorted(CALLS))
def test_counted_products_are_the_programs_weights_and_its_launches(name):
    import torch

    import repro_torch.configs  # noqa: F401  (registers the architectures)
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.lm import param_structs

    blocks = param_structs(get_arch(name), torch.float32)["blocks"]
    weights = sorted(tuple(v.shape[1:]) for k, v in blocks.items()
                     if v.dim() == 3 and not k.startswith("conv_"))
    mod = model(name)
    assert sorted(READER.layer_products(mod)) == weights
    counted = [p for p in READER.layer_products(mod) if p[1] > READER.NARROW]
    assert mod["num_layers"] * len(counted) == CALLS[name]


@pytest.mark.parametrize("name", sorted(CALLS))
def test_at_the_bound_it_reads_100_and_below_when_slower(name):
    at = 3 * bound_per_batch(name)
    assert READER.read(ctx(name, at, 3 * CALLS[name])) == pytest.approx(100.0)
    assert READER.read(ctx(name, 2 * at, 3 * CALLS[name])) == pytest.approx(50.0)


def test_mamba2_at_the_kernels_time_on_the_card():
    # 64 layers of w_z, w_x and ssm_out: 41.2 TFLOP a batch as three TF32
    # products is 0.250 s; the kernel's 1.359 s over three batches reads 55%.
    assert bound_per_batch("mamba2-2.7b") == pytest.approx(0.2499, abs=1e-4)
    assert READER.read(ctx("mamba2-2.7b", 1.359, 576)) == pytest.approx(55.2, abs=0.1)


@pytest.mark.parametrize("case", ["no_kernel", "other_calls", "train", "no_trace"])
def test_it_finds_nothing_where_the_count_does_not_hold(case):
    c = ctx("mamba2-2.7b", 1.0, 0 if case == "no_kernel" else
            575 if case == "other_calls" else 576, kind="train" if case == "train" else "prefill")
    if case == "no_trace":
        c.trace = None
    assert READER.read(c) is None
