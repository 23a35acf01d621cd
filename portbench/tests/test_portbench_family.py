"""A family defined by its reference module alone: the toy family of
``toy_family.py`` (two layer kinds in a fixed pattern, each followed by an
FFN of held experts under a wider router) through the weights, the plain
prefill, the loss and training, and the work; and a launch counter that a
metric's reader alone declares, read in a traced run."""

import importlib
import json
import math
import time

import pytest
import torch

from conftest import ROOT, small_cell
from portbench import harness, work
from portbench.inputs import layout, leaf_items, make_tokens, make_weights
from portbench.kinds import prefill
from portbench.reference import lm
from portbench.reference.ops import Products

TOY = "portbench.tests.toy_family"
MODEL = dict(
    num_layers=4, layer_types=["mamba", "attention", "mamba", "mamba"], d_model=64,
    vocab_size=300, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=0, hybrid=False,
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_conv_width=4, ssm_chunk=32,
    sliding_window=0, norm_eps=1e-5, tie_embeddings=True, num_experts=8, experts_held=4,
    top_k=2, expert_d_ff=32, shared_d_ff=48, embedding_multiplier=12.0,
    residual_multiplier=0.22, attention_multiplier=1 / 16, logits_scaling=4.0)


@pytest.fixture
def toy():
    return importlib.import_module(TOY)


def test_the_weights_follow_the_familys_layout(toy):
    w = make_weights(MODEL, 3, torch.float32, "cpu", toy)
    assert sorted(w) == ["attention", "embed", "ffn", "final_norm", "mamba"]
    assert w["mamba"]["w_z"].shape == (3, 64, 128) and w["attention"]["wq"].shape == (1, 64, 64)
    assert w["ffn"]["router"].shape == (4, 64, 8) and w["ffn"]["we_up"].shape == (4, 4, 64, 32)
    assert w["embed"].shape == (384, 64) and "lm_head" not in w
    # One generator: the top leaves, then each group, each in name order,
    # a group's leaves stacked over its layers.
    top, groups = toy.layout(MODEL)
    specs = sorted(top.items()) + [
        (f"{g}/{name}", ((len(layers),) + shape, fan, kind))
        for g, (layers, leaves) in sorted(groups.items()) for name, (shape, fan, kind)
        in sorted(leaves.items())]
    gen = torch.Generator().manual_seed(3)
    got = dict(leaf_items(w))
    assert [path for path, _ in specs] == ["embed", "final_norm"] + sorted(set(got) - set(top))
    for path, (shape, fan, kind) in specs:
        if kind == "normal":
            want = torch.randn(shape, generator=gen) * fan ** -0.5
        elif kind == "a_log":
            want = (torch.rand(shape, generator=gen) * 15 + 1).log()
        elif kind == "dt_bias":
            lo, hi = math.log(1e-3), math.log(1e-1)
            want = (torch.rand(shape, generator=gen) * (hi - lo) + lo).exp().expm1().log()
        else:
            want = torch.full(shape, 1.0 if kind == "ones" else 0.0)
        assert torch.equal(got[path], want), path


def test_the_tree_round_trips_through_leaf_items_and_nest(toy):
    w = make_weights(MODEL, 4, torch.bfloat16, "cpu", toy)
    flat = dict(leaf_items(w))
    assert len(flat) == 2 + 5 + 8 + 17
    back = lm.nest(flat)
    assert dict(leaf_items(back)).keys() == flat.keys()
    assert all(back_leaf is flat[p] for p, back_leaf in leaf_items(back))


def test_prefill_runs_the_familys_forward_and_stacks_each_state_over_its_layers(toy):
    w = make_weights(MODEL, 5, torch.float32, "cpu", toy)
    tokens = make_tokens(MODEL, 5, 1, 1, 40, 1.1, "cpu")[0]
    logits, state = lm.prefill_row(toy, w, MODEL, tokens, 48, Products())
    want_logits, want_state = toy.prefill_row(w, MODEL, tokens, 48, Products())
    assert torch.equal(logits, want_logits) and logits.shape == (1, 1, 300)
    assert torch.isfinite(logits).all()
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        "ssm_state": (3, 1, 8, 16, 16), "conv_state": (3, 1, 3, 160),
        "k": (1, 1, 48, 2, 16), "v": (1, 1, 48, 2, 16)}
    assert all(torch.equal(state[k], want_state[k]) for k in state)
    # The family's logit scale: doubling logits_scaling halves the logits.
    scaled = dict(MODEL, logits_scaling=8.0)
    half, _ = lm.prefill_row(toy, w, scaled, tokens, 48, Products())
    torch.testing.assert_close(half, logits / 2, rtol=1e-6, atol=0)


def test_the_loss_and_training_run_the_familys_loss(toy):
    batches = make_tokens(MODEL, 6, 2, 4, 33, 1.1, "cpu")
    opt = {"lr": 1e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1, "clip_norm": 1.0,
           "warmup_steps": 0, "total_steps": 100, "min_lr_ratio": 0.1}
    w = make_weights(MODEL, 6, torch.float32, "cpu", toy)
    for _, p in leaf_items(w):
        p.requires_grad_(True)
    b = batches[0]
    loss = lm.loss_sum(toy, w, MODEL, b[:, :-1], b[:, 1:], Products())
    assert torch.equal(loss, toy.loss_sum(w, MODEL, b[:, :-1], b[:, 1:], Products()))
    loss.backward()
    grads = {path: p.grad for path, p in leaf_items(w)}
    # Every held expert, the router and the one attention layer get a gradient.
    assert all(grads[f"ffn/{n}"][:, e].abs().sum() > 0 for n in ("we_gate", "we_up", "we_down")
               for e in range(4))
    assert grads["ffn/router"].abs().sum() > 0 and grads["attention/wq"].abs().sum() > 0
    ref = lm.train(toy, MODEL, opt, lambda: make_weights(MODEL, 6, torch.float32, "cpu", toy),
                   batches, 2, Products(), row_block=2)
    assert ref["losses"][0] == pytest.approx(loss.item() / b[:, 1:].numel(), rel=1e-6)
    assert set(ref["change_norms"]) == set(grads)
    assert all(ref["change_norms"][p] > 0 for p in grads if grads[p].abs().sum() > 0)


def test_the_work_is_the_familys(toy):
    """By hand, for rows x seq tokens: each leaf held as one multiply-add a
    token, the routed experts at top_k / num_experts = 2 / 8 of the held
    ones, the SSD in three layers, attention in one, the head."""
    mamba = (64 + 2 * 64 * 128 + 2 * 64 * 16 + 64 * 8          # ln_ssm, w_z, w_x, w_b, w_c, w_dt
             + 4 * 128 + 128 + 2 * (4 * 16 + 16)                # conv taps and biases
             + 3 * 8 + 128 + 128 * 64)                          # a_log, d_skip, dt_bias, norm, out
    attn = 64 + 64 * 64 + 2 * 64 * 32 + 64 * 64                 # ln1, wq, wk, wv, wo
    ffn = 64 + 64 * 8 + 3 * 64 * 48                             # ln2, router, shared expert
    experts = 3 * 4 * 64 * 32                                   # four held experts
    assert (mamba, attn, ffn, experts) == (28_152, 12_352, 9_792, 24_576)
    top = 384 * 64 + 64
    assert work.param_count(MODEL, toy) == top + 3 * mamba + attn + 4 * (ffn + experts)
    assert work.param_count(MODEL, toy) == sum(
        t.numel() for _, t in leaf_items(make_weights(MODEL, 1, torch.float32, "cpu", toy)))

    rows, seq = 2, 64
    macs = 3 * mamba + attn + 4 * ffn + 4 * experts * 2 // 8
    # One SSD call at (2, 64, 8 heads of 16, state 16, chunk 32): CBᵀ and the
    # decay-weighted (CBᵀ)x over 2 x 528 causal pairs, C·h_in, the states.
    ssd = (2 * 1056 * 2 * 16 + 2 * 1056 * 2 * 8 * 16 + 4 * 2 * 64 * 8 * 16 * 16
           + 2 * 2 * 2 * 8 * 16 * 16)
    att = 4 * 16 * 4 * (64 * 65 // 2) * 2                       # QKᵀ and AV, causal
    forward = 2 * macs * rows * seq + 3 * ssd + att
    assert work.prefill_flops(MODEL, rows, seq, toy) == forward + 2 * 64 * 300 * rows
    assert work.train_flops(MODEL, rows, seq, toy) == 3 * (forward + 2 * 64 * 300 * rows * seq)


@pytest.mark.parametrize("name", ["mamba2-2.7b", "hymba-1.5b"])
def test_the_configured_families_take_the_defaults(name):
    conf = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    family = lm.layer_module(conf["reference"])
    assert not any(hasattr(family, h) for h in ("layout", "prefill_row", "loss_sum",
                                                "forward_flops"))
    top, groups = layout(conf["model"], family)
    assert list(groups) == ["blocks"] and groups["blocks"][0] == list(range(
        conf["model"]["num_layers"]))


def test_a_counter_declared_by_a_reader_alone_is_read(bench, toy, monkeypatch):
    """A traced run of a prefill cell whose per-layer metric is the toy's
    reader (``metrics/toy_ffn_launches.py`` beside this file): each traced
    batch also runs the toy's plain prefill of one prompt, which calls its
    expert FFN once a layer; the reader's counter counts those calls."""
    from portbench import trace

    readers = harness.load_readers([{"name": "toy_ffn_launches"}], "tests/metrics")
    counters = harness.counters_of(readers)
    assert counters == {**trace.COUNTERS, "toy_ffn": (TOY, "moe_ffn")}
    assert "toy_ffn" not in trace.COUNTERS
    assert trace.read_counters({"toy_ffn": (TOY, "moe_ffn")}) == {
        "toy_ffn": toy.moe_ffn.launches}
    # A counter whose module or function the program lacks fails the run.
    with pytest.raises(AttributeError):
        trace.read_counters({"gone": (TOY, "no_such_kernel")})
    with pytest.raises(ModuleNotFoundError):
        trace.read_counters({"lost": ("portbench.no_such_module", "f")})

    w = make_weights(MODEL, 8, torch.float32, "cpu", toy)
    prompt = make_tokens(MODEL, 8, 1, 1, 16, 1.1, "cpu")[0]
    run_unit = prefill.Traffic.run_unit

    def run_unit_and_toy(self, i):
        run_unit(self, i)
        lm.prefill_row(toy, w, MODEL, prompt, None, Products())

    name = "hymba-1.5b.prefill-fp32-4x2048"
    cell = small_cell(bench, name)
    cell.per_layer = [{"name": "toy_ffn_launches", "unit": "calls/unit"}]
    monkeypatch.setattr(prefill.Traffic, "run_unit", run_unit_and_toy)
    monkeypatch.setattr(harness, "HERE", ROOT / "portbench" / "tests")
    result = harness.run_cell(bench, name, 1_618_033_988, 0.2, True, "cpu", time.time(),
                              cell=cell)[0]
    assert result["correct"]
    assert result["metrics"] == {"toy_ffn_launches": {"value": MODEL["num_layers"],
                                                      "unit": "calls/unit"}}
