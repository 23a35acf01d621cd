"""The plain references against the program, on the CPU at the program's
smoke sizes: a prompt's logits and decode state for both configurations,
the Mamba-2 loss and its gradients, three AdamW steps."""

import dataclasses
import json

import pytest
import torch

from conftest import ROOT, SMOKE
from portbench import harness
from portbench.inputs import leaf_items, make_tokens, make_weights
from portbench.reference import lm
from portbench.reference.ops import Products


def smoke(name):
    conf = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    conf["model"] = dict(conf["model"], **SMOKE[name])
    return conf


@pytest.mark.parametrize("name", ["mamba2-2.7b", "hymba-1.5b"])
def test_prefill_logits_and_state_match_the_program(name):
    from repro_torch.serve.step import make_local_exec

    conf = smoke(name)
    m = conf["model"]
    mod = lm.layer_module(conf["reference"])
    weights = make_weights(m, 11, torch.float32, "cpu", mod)
    tokens = make_tokens(m, 11, 1, 2, 150, 1.1, "cpu")[0]
    prefill, _ = make_local_exec(harness.model_config(conf), 16, device="cpu")
    logits, cache = prefill(weights, tokens)
    slots = min(m["sliding_window"], 166) if m["num_heads"] else None
    for r in range(2):
        want, state = lm.prefill_row(mod, weights, m, tokens[r:r + 1], slots, Products())
        torch.testing.assert_close(logits[r:r + 1, :, :m["vocab_size"]], want,
                                   rtol=1e-5, atol=1e-5)
        assert set(state) == set(cache) - {"pos"}
        for leaf, ref in state.items():
            torch.testing.assert_close(cache[leaf][:, r:r + 1], ref, rtol=1e-5, atol=1e-5)


def test_mamba2_loss_and_gradients_match_the_program():
    from repro_torch.models.lm import loss_fn

    conf = smoke("mamba2-2.7b")
    m = conf["model"]
    cfg = harness.model_config(conf)
    batch = make_tokens(m, 5, 1, 2, 65, 1.1, "cpu")[0]
    mod = lm.layer_module("mamba2")
    got_w = make_weights(m, 5, torch.float32, "cpu", mod)
    want_w = make_weights(m, 5, torch.float32, "cpu", mod)
    for _, p in leaf_items(got_w):
        p.requires_grad_(True)
    for _, p in leaf_items(want_w):
        p.requires_grad_(True)
    loss, _ = loss_fn(got_w, cfg, {"tokens": batch[:, :-1], "labels": batch[:, 1:],
                                   "loss_mask": torch.ones(2, 64)})
    loss.backward()
    ref = lm.loss_sum(mod, want_w, m, batch[:, :-1], batch[:, 1:],
                      Products()) / batch[:, 1:].numel()
    ref.backward()
    torch.testing.assert_close(loss, ref, rtol=1e-6, atol=1e-6)
    want = dict(leaf_items(want_w))
    for name, p in leaf_items(got_w):
        torch.testing.assert_close(p.grad, want[name].grad, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_three_adamw_steps_match_the_programs_train_step(dtype):
    from repro_torch.train import AdamWConfig, TrainStepConfig, adamw_init, make_train_step

    conf = smoke("mamba2-2.7b")
    m = conf["model"]
    opt = {"lr": 3e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1, "clip_norm": 1.0,
           "warmup_steps": 0, "total_steps": 10000, "min_lr_ratio": 0.1}
    batches = make_tokens(m, 9, 3, 4, 65, 1.1, "cpu")
    step, init_efb = make_train_step(
        harness.model_config(conf),
        TrainStepConfig(microbatches=2, remat="full", optimizer=AdamWConfig(**opt)), device="cpu")
    mod = lm.layer_module("mamba2")
    params = make_weights(m, 9, dtype, "cpu", mod)
    state, efb = adamw_init(params), init_efb(params)
    losses = []
    for t in range(3):
        b = batches[t]
        params, state, metrics, efb = step(params, state, {
            "tokens": b[:, :-1], "labels": b[:, 1:], "loss_mask": torch.ones(4, 64)}, efb)
        losses.append(float(metrics["loss"]))
    ref = lm.train(mod, m, opt, lambda: make_weights(m, 9, dtype, "cpu", mod),
                   batches, 3, Products(), row_block=2)
    start = dict(leaf_items(make_weights(m, 9, dtype, "cpu", mod)))
    tol = 1e-5 if dtype == torch.float32 else 3e-3
    assert losses == pytest.approx(ref["losses"], rel=tol)
    for name, p in leaf_items(params):
        change = float((p.detach().float() - start[name].float()).norm())
        assert change == pytest.approx(ref["change_norms"][name], rel=30 * tol, abs=1e-6), name
