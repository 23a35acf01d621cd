"""The program's spans (``repro_torch.telemetry.ranges``) on the CPU at smoke
sizes: with no profiler a span is the shared null context and a train
step enters none; under ``torch.profiler`` each phase of a train step and
each layer kind opens as often as the code runs it (remat's recompute
included), as an operator range and not a user annotation, and the
profiled step and prefill compute bitwise what the unprofiled ones do."""

import collections
import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs as TC
from repro_torch.models import lm
from repro_torch.telemetry import ranges
from repro_torch.train import TrainStepConfig, adamw_init, make_train_step
from repro_torch.train.optimizer import leaves

ARCHS = ["mamba2-2.7b", "hymba-1.5b"]
REMATS = ["none", "dots", "full"]
MICROBATCHES = 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the smoke steps are tiny, and several test
    processes' thread pools on the same cores slow them a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layer_kinds(cfg) -> list[str]:
    """The spans one layer of ``cfg`` opens."""
    kinds = []
    if cfg.has_attention:
        kinds.append("lm.attention")
    if cfg.has_ssm:
        kinds.append("lm.ssm")
    if cfg.d_ff > 0 or cfg.is_moe:
        kinds.append("lm.ffn")
    return kinds


def _spans(prof) -> tuple[collections.Counter, list]:
    """Counts of the program's spans among a profile's events, and those events."""
    events = [e for e in prof.events() if e.name in ranges.SPANS]
    return collections.Counter(e.name for e in events), events


def _train_step(arch: str, remat: str, profiled: bool):
    """One smoke train step from fixed weights and tokens: (params, optimizer
    state, metrics, span counts, span events)."""
    cfg = TC.get_arch(arch, "smoke")
    gen = torch.Generator().manual_seed(7)
    params = lm.init_params(cfg, gen, device="cpu")
    step, init_efb = make_train_step(
        cfg, TrainStepConfig(microbatches=MICROBATCHES, remat=remat), device="cpu")
    opt, efb = adamw_init(params), init_efb(params)
    tokens = torch.randint(0, cfg.vocab_size, (4, 33), generator=gen)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:],
             "loss_mask": torch.ones((4, 32), dtype=torch.float32)}
    counts, events = collections.Counter(), []
    tracer = profile(activities=[ProfilerActivity.CPU]) if profiled else contextlib.nullcontext()
    with tracer as prof:
        params, opt, metrics, _ = step(params, opt, batch, efb)
    if profiled:
        counts, events = _spans(prof)
    return cfg, params, opt, metrics, counts, events


def _assert_bitwise(got, want):
    a, b = leaves(got), leaves(want)
    assert len(a) == len(b)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_without_a_profiler_a_span_is_the_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    off = ranges.span("lm.ssm")
    assert isinstance(off, contextlib.nullcontext) and off is ranges.span("train.step")
    with profile(activities=[ProfilerActivity.CPU]):
        assert ranges.span("lm.ssm") is not off


def test_an_unprofiled_train_step_enters_no_span(monkeypatch):
    """The range the spans open raises here: an unprofiled step runs
    through, a profiled one reaches it."""

    def opened(name):
        raise AssertionError(f"span {name!r} entered")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", opened)
    _train_step("hymba-1.5b", "full", profiled=False)
    with pytest.raises(AssertionError, match="entered"):
        _train_step("hymba-1.5b", "full", profiled=True)


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("arch", ARCHS)
def test_a_profiled_train_step_opens_each_span_as_the_code_runs_it(arch, remat):
    cfg, params, opt, metrics, counts, events = _train_step(arch, remat, profiled=True)
    # Remat runs each layer again inside the backward.
    per_layer = MICROBATCHES * (1 if remat == "none" else 2)
    want = {"train.step": 1, "train.forward": MICROBATCHES, "train.backward": MICROBATCHES,
            "train.optimizer": 1}
    want.update({kind: per_layer * cfg.num_layers for kind in _layer_kinds(cfg)})
    assert dict(counts) == want
    # Operator ranges: the device trace gets no span of its own.
    assert not any(e.is_user_annotation for e in events)
    _, params0, opt0, metrics0, _, _ = _train_step(arch, remat, profiled=False)
    _assert_bitwise(params, params0)
    _assert_bitwise(opt, opt0)
    assert metrics.keys() == metrics0.keys()
    assert all(torch.equal(metrics[k], metrics0[k]) for k in metrics)


def test_every_span_is_opened_by_the_program():
    *_, counts, _ = _train_step("hymba-1.5b", "none", profiled=True)
    assert set(counts) == set(ranges.SPANS)


@pytest.mark.parametrize("arch", ARCHS)
def test_a_profiled_prefill_opens_each_layer_kind_once_a_layer(arch):
    cfg = TC.get_arch(arch, "smoke")
    gen = torch.Generator().manual_seed(11)
    params = lm.init_params(cfg, gen, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen)
    logits0, cache0 = lm.prefill_step(params, cfg, tokens, cache_len=48)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        logits, cache = lm.prefill_step(params, cfg, tokens, cache_len=48)
    counts, _ = _spans(prof)
    assert dict(counts) == {kind: cfg.num_layers for kind in _layer_kinds(cfg)}
    assert torch.equal(logits, logits0)
    assert cache.keys() == cache0.keys()
    assert all(torch.equal(cache[k], cache0[k]) for k in cache)
