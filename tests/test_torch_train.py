"""The port's training path against the JAX package's, on the CPU.

The token stream bitwise (``repro.traces.tokens``); ``loss_fn`` (loss,
metrics and ``jax.grad`` against ``torch.autograd`` per leaf) on bridged
weights for six smoke models; the remat policies; AdamW and the cosine
schedule on identical bridged gradients; three train steps against the
reference's jitted ``make_train_step``; the bridge's optimizer state and
batch; the launcher and ``examples.train_lm``.

Tolerances:

* MODEL_TOL = 2e-4 (tests/test_models.py's model-level tolerance): losses
  and gradients through a whole fp32 model whose SSD the JAX side runs in
  the chunked form and the port in its own chunked form (its
  ``SsdScanFn`` under autograd), with matmuls summed in other orders; a
  gradient leaf is held relative to its largest value.
* OPT_TOL = 1e-6 relative: one AdamW step on identical gradients, the same
  elementwise arithmetic in another association (the port updates in
  place), plus the global norm summed in another order; a value near 0 is
  held to 1e-6 of its leaf's largest.
* Remat and the restarted run: bitwise (CPU kernels are deterministic).
* bf16 training (the reference's own precision: bf16 params, fp32 moments
  and gradient accumulation): loss, ce and grad norm of each of three
  steps within BF16_STEP_RTOL, under half a bf16 ulp (2^-8): the two
  frameworks round bf16 at other places (the port's SSD gradient rounds
  each operand's fp32 gradient once, the reference each of its uses'),
  and the measured gap was at most 1.1e-3 (the grad norm). The updated
  params: the difference from the reference's, in L2 over a leaf, within
  BF16_LEAF_TOL of the reference's own update of that leaf (p_3 - p_0),
  and over all leaves within BF16_MODEL_TOL of the whole update. AdamW's
  first steps move every entry by about lr in the sign of its gradient,
  so an entry whose gradient is near 0 moves by a full step in a sign
  that bf16 rounding decides: measured 0.44 on a zero-initialised (2, 64)
  bias, at most 0.153 on a weight matrix (hymba's embedding) and 0.068
  over the model (hymba). Step 1's accumulated fp32 gradient, leaf by
  leaf, within BF16_GRAD_TOL of the leaf's largest |value| in the
  reference's: each side sums bf16-rounded per-use gradients, and each was
  measured as far from the fp32 gradient at the same bf16 values as from
  the other (relative L2 over a leaf up to 5.1e-2 either way, both on
  hymba's (2, 8) per-head SSM leaves, which sum every step's term);
  measured at most 3.1e-2 (qwen2-0.5b), 3.6e-2 (mamba2-2.7b) and 5.4e-2
  (hymba-1.5b) of the leaf's max. A leaf off by a factor, or missing a
  term, is off by far more.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.launch.mesh import make_debug_mesh
from repro.models import lm as jlm
from repro.traces import tokens as jtokens
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import configs as TC
from repro_torch.bridge import batch_from_numpy, lm_params_from_numpy, opt_state_from_numpy
from repro_torch.distributed.mesh import Mesh
from repro_torch.examples import train_lm
from repro_torch.launch import train as launch_train
from repro_torch.models import lm
from repro_torch.traces import tokens
from repro_torch.train import step as port_step
from repro_torch.train import (
    AdamWConfig,
    TrainStepConfig,
    adamw_init,
    adamw_update,
    cosine_lr,
    make_train_step,
)
from repro_torch.train.optimizer import leaves

torch.set_float32_matmul_precision("highest")

ROOT = Path(__file__).resolve().parents[1]
MODEL_TOL = 2e-4
OPT_TOL = 1e-6
#: The smoke models loss_fn is held on: dense, SSM, MoE (aux > 0), hybrid,
#: vision prefix (sliced off the logits) and audio (frames, no tokens).
LOSS_ARCHS = ["qwen2-0.5b", "mamba2-2.7b", "deepseek-moe-16b", "hymba-1.5b", "internvl2-76b",
              "hubert-xlarge"]
BF16_STEP_RTOL = 3e-3
BF16_LEAF_TOL = 0.5
BF16_MODEL_TOL = 0.15
BF16_GRAD_TOL = 8e-2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one intra-op thread: the smoke models' steps are tiny,
    and under a parallel test run several processes' thread pools on the
    same cores make many small steps a hundred times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x, np.float32)


def _model(arch, seed=0):
    cfg_j, cfg = JC.get_arch(arch, "smoke"), TC.get_arch(arch, "smoke")
    p_j = jlm.init_params(jax.random.key(seed), cfg_j, jnp.float32)
    return cfg_j, p_j, cfg, lm_params_from_numpy(jax.tree.map(np.asarray, p_j), cfg, device="cpu")


def _batch(cfg, b=2, s=40, seed=3):
    """A numpy training batch for ``cfg``: tokens and labels, a loss mask
    with zeros in it; a vision prefix of 8 patches, or audio frames."""
    rng = np.random.default_rng(seed)
    s_text = s
    out = {}
    if cfg.frontend == "audio":
        out["prefix_embeds"] = (0.02 * rng.standard_normal((b, s, 512))).astype(np.float32)
    else:
        if cfg.frontend == "vision":
            out["prefix_embeds"] = (0.02 * rng.standard_normal((b, 8, 1024))).astype(np.float32)
            s_text = s - 8
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, s_text)).astype(np.int32)
    out["labels"] = rng.integers(0, cfg.vocab_size, (b, s_text)).astype(np.int32)
    mask = np.ones((b, s_text), np.float32)
    mask[0, :5] = 0.0
    out["loss_mask"] = mask
    return out


def _assert_leaf_close(got: torch.Tensor, want, tol, what):
    want = _np(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.detach().float().numpy() - want).max())
    assert err <= tol * scale, (what, err, scale)


# ---------------------------------------------------------------------------
# Token stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (0, 17), (9, 3), (123, 250)])
def test_token_stream_is_bitwise_the_reference(seed, step):
    kw = dict(vocab_size=512, seq_len=65, global_batch=4, seed=seed)
    got = tokens.SyntheticTokenStream(tokens.TokenPipelineConfig(**kw)).batch(step)
    want = jtokens.SyntheticTokenStream(jtokens.TokenPipelineConfig(**kw)).batch(step)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    li, lj = tokens.lm_inputs(got), jtokens.lm_inputs(want)
    assert li.keys() == lj.keys() == {"tokens", "labels", "loss_mask"}
    for k in lj:
        np.testing.assert_array_equal(li[k], lj[k])


def test_token_shard_iterator_is_bitwise_the_reference():
    kw = dict(vocab_size=64, seq_len=16, global_batch=8, seed=3)
    got = tokens.SyntheticTokenStream(tokens.TokenPipelineConfig(**kw))
    want = jtokens.SyntheticTokenStream(jtokens.TokenPipelineConfig(**kw))
    for host in range(4):
        it_g, it_w = got.shard_iterator(host, 4, start_step=5), want.shard_iterator(host, 4, 5)
        for _ in range(2):
            a, b = next(it_g), next(it_w)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="evenly"):
        next(got.shard_iterator(0, 3))


# ---------------------------------------------------------------------------
# loss_fn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_fn_value_metrics_and_grads_match_jax(arch):
    cfg_j, p_j, cfg, p = _model(arch)
    raw = _batch(cfg)
    (loss_j, met_j), grads_j = jax.value_and_grad(
        lambda q: jlm.loss_fn(q, cfg_j, {k: jnp.asarray(v) for k, v in raw.items()}),
        has_aux=True)(p_j)
    for leaf in leaves(p):
        leaf.requires_grad_(True)
    loss, met = lm.loss_fn(p, cfg, batch_from_numpy(raw, device="cpu"))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=MODEL_TOL, atol=MODEL_TOL)
    assert met.keys() == met_j.keys() == {"ce", "z_loss", "aux"}
    for k in met_j:
        np.testing.assert_allclose(met[k].item(), float(met_j[k]), rtol=MODEL_TOL,
                                   atol=MODEL_TOL * 1e-2, err_msg=k)
    if cfg.is_moe:
        assert met["aux"].item() > 0.0
    flat_j = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(grads_j)[0]}
    for name, leaf in p.items():
        subs = leaf.items() if isinstance(leaf, dict) else [(None, leaf)]
        for sub, t in subs:
            key = f"['{name}']" + ("" if sub is None else f"['{sub}']")
            got = t.grad if t.grad is not None else torch.zeros_like(t)
            _assert_leaf_close(got, flat_j[key], MODEL_TOL, f"{arch} grad {key}")


def test_loss_fn_masks_padded_vocab_columns():
    """The reference's test_vocab_padding_is_masked on the port: corrupt
    the padded embedding rows (qwen2 ties its head), the loss is unchanged;
    and the port's loss equals the reference's on the same weights. The
    smoke vocabulary (512) is cut to 500, so that 12 columns are padding."""
    cfg_j = dataclasses.replace(JC.get_arch("qwen2-0.5b", "smoke"), vocab_size=500)
    cfg = dataclasses.replace(TC.get_arch("qwen2-0.5b", "smoke"), vocab_size=500)
    p_j = jlm.init_params(jax.random.key(0), cfg_j, jnp.float32)
    p = lm_params_from_numpy(jax.tree.map(np.asarray, p_j), cfg, device="cpu")
    assert lm.padded_vocab(cfg) == 512 > cfg.vocab_size
    raw = _batch(cfg)
    batch = batch_from_numpy(raw, device="cpu")
    loss1, _ = lm.loss_fn(p, cfg, batch)
    p2 = dict(p, embed=p["embed"].clone())
    p2["embed"][cfg.vocab_size:] = 1e3
    loss2, _ = lm.loss_fn(p2, cfg, batch)
    np.testing.assert_allclose(float(loss1), float(loss2), rtol=1e-6)
    loss_j, _ = jlm.loss_fn(p_j, cfg_j, {k: jnp.asarray(v) for k, v in raw.items()})
    np.testing.assert_allclose(float(loss1), float(loss_j), rtol=MODEL_TOL)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-2.7b", "hymba-1.5b"])
def test_remat_policies_give_bitwise_equal_grads(arch):
    _, _, cfg, p = _model(arch)
    batch = batch_from_numpy(_batch(cfg), device="cpu")
    runs = {}
    for remat in lm.REMAT_POLICIES:
        q = {k: ({kk: vv.clone().requires_grad_(True) for kk, vv in v.items()}
                 if isinstance(v, dict) else v.clone().requires_grad_(True))
             for k, v in p.items()}
        loss, _ = lm.loss_fn(q, cfg, batch, remat=remat)
        loss.backward()
        runs[remat] = (loss.detach(), [t.grad for t in leaves(q)])
    base_loss, base = runs["none"]
    for remat, (loss, grads) in runs.items():
        assert torch.equal(loss, base_loss), remat
        for g, g0 in zip(grads, base):
            assert (g is None) == (g0 is None) and (g is None or torch.equal(g, g0)), remat


def test_make_block_fn_is_the_trunk_and_remat_refuses_a_cache():
    cfg_j, p_j, cfg, p = _model("hymba-1.5b")
    tok = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 20)))
    logits, aux = lm.forward(p, cfg, tok)
    h = p["embed"][tok]
    pos = torch.arange(20)
    sin, cos = lm.rope_table(pos, cfg.resolved_head_dim, cfg.rope_theta)
    block = lm.make_block_fn(cfg, sin, cos, "blockwise", pos)
    for i in range(cfg.num_layers):
        h, _, cache = block(h, lm._layer(p, i))
        assert cache == {}
    assert torch.equal(lm._logits(p, cfg, h), logits)
    with pytest.raises(ValueError, match="remat='none'"):
        lm.forward(p, cfg, tok, collect_cache=True, remat="full")
    with pytest.raises(ValueError, match="remat must be one of"):
        lm.forward(p, cfg, tok, remat="everything")


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

def test_cosine_lr_matches_jax():
    cfg = AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=300)
    cfg_j = jopt.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=300)
    for step in (0, 1, 7, 20, 21, 150, 299, 300, 400):
        got = float(cosine_lr(cfg, torch.tensor(step, dtype=torch.int32)))
        want = float(jopt.cosine_lr(cfg_j, jnp.int32(step)))
        np.testing.assert_allclose(got, want, rtol=OPT_TOL, err_msg=str(step))


@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_adamw_update_matches_jax_in_place(clip):
    """Identical bridged params, grads and moments after two reference steps;
    clipping active (clip 1.0: the gradient norm is > 1) or not; weight
    decay on matrices only."""
    cfg_j, p_j, cfg, _ = _model("mamba2-2.7b")
    kw = dict(lr=1e-2, clip_norm=clip, warmup_steps=2, total_steps=10, weight_decay=0.5)
    ocfg, ocfg_j = AdamWConfig(**kw), jopt.AdamWConfig(**kw)
    rng = np.random.default_rng(0)
    draw = lambda: jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(x.shape), jnp.float32), p_j)
    st_j = jopt.adamw_init(p_j)
    for _ in range(2):
        p_j, st_j, _ = jopt.adamw_update(ocfg_j, p_j, draw(), st_j)
    g_j = draw()
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    p = lm_params_from_numpy(np_tree(p_j), cfg, device="cpu")
    st = opt_state_from_numpy(np_tree(st_j), cfg, device="cpu")
    g = lm_params_from_numpy(np_tree(g_j), cfg, device="cpu")
    ids = [id(t) for t in leaves(p) + leaves(st["m"]) + leaves(st["v"])]
    p2, st2, met = adamw_update(ocfg, p, g, st)
    new_j, st_new_j, met_j = jopt.adamw_update(ocfg_j, p_j, g_j, st_j)
    assert p2 is p and st2 is st
    assert [id(t) for t in leaves(p2) + leaves(st2["m"]) + leaves(st2["v"])] == ids
    assert int(st2["step"]) == int(st_new_j["step"]) == 3
    np.testing.assert_allclose(float(met["grad_norm"]), float(met_j["grad_norm"]), rtol=OPT_TOL)
    np.testing.assert_allclose(float(met["lr"]), float(met_j["lr"]), rtol=OPT_TOL)
    assert (float(met["grad_norm"]) > clip) == (clip == 1.0)
    for got, want in [(p2, new_j), (st2["m"], st_new_j["m"]), (st2["v"], st_new_j["v"])]:
        for t, w in zip(leaves(got), jax.tree.leaves(want)):
            # 1e-6 of each value, or of the leaf's largest one near 0.
            np.testing.assert_allclose(t.numpy(), _np(w), rtol=OPT_TOL,
                                       atol=OPT_TOL * float(np.abs(_np(w)).max()))


def test_adamw_decays_matrices_only():
    """With zero gradients only the decoupled decay moves a leaf: matrices
    shrink by lr · wd · p, vectors stay."""
    params = {"blocks": {"w": torch.ones(2, 3, 4), "b": torch.ones(2, 4)}, "norm": torch.ones(5)}
    grads = {"blocks": {"w": torch.zeros(2, 3, 4), "b": torch.zeros(2, 4)}, "norm": torch.zeros(5)}
    cfg = AdamWConfig(lr=0.1, weight_decay=0.5, warmup_steps=0, total_steps=100)
    adamw_update(cfg, params, grads, adamw_init(params))
    lr = float(cosine_lr(cfg, 1))
    torch.testing.assert_close(params["blocks"]["w"], torch.full((2, 3, 4), 1 - lr * 0.5))
    torch.testing.assert_close(params["blocks"]["b"], torch.full((2, 4), 1 - lr * 0.5))
    assert torch.equal(params["norm"], torch.ones(5))


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-2.7b"])
def test_train_step_matches_the_reference_for_three_steps(arch, microbatches):
    cfg_j, p_j, cfg, p = _model(arch, seed=1)
    ocfg = dict(lr=3e-3, total_steps=10, warmup_steps=2)
    tcfg_j = jstep.TrainStepConfig(microbatches=microbatches, remat="none",
                                   optimizer=jopt.AdamWConfig(**ocfg))
    tcfg = TrainStepConfig(microbatches=microbatches, remat="full", optimizer=AdamWConfig(**ocfg))
    step_j, _, _, _, init_efb_j = jstep.make_train_step(cfg_j, make_debug_mesh(), tcfg_j)
    step, init_efb = make_train_step(cfg, tcfg, device="cpu")
    jit_step = jax.jit(step_j)
    st_j, efb_j = jopt.adamw_init(p_j), init_efb_j(p_j)
    st, efb = adamw_init(p), init_efb(p)
    assert all(float(e) == 0.0 and e.shape == () for e in leaves(efb))
    pipe = tokens.SyntheticTokenStream(tokens.TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=33, global_batch=4, seed=0))
    for s in range(3):
        raw = tokens.lm_inputs(pipe.batch(s))
        p_j, st_j, met_j, efb_j = jit_step(p_j, st_j, {k: jnp.asarray(v) for k, v in raw.items()},
                                           efb_j)
        p, st, met, efb = step(p, st, batch_from_numpy(raw, device="cpu"), efb)
        assert met.keys() == met_j.keys()
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(met[k]), float(met_j[k]), rtol=MODEL_TOL,
                                       err_msg=f"step {s} {k}")
        np.testing.assert_allclose(float(met["lr"]), float(met_j["lr"]), rtol=OPT_TOL)
    assert int(st["step"]) == 3


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-2.7b", "hymba-1.5b"])
def test_bf16_train_step_matches_the_reference_for_three_steps(arch, monkeypatch):
    """bf16 params from the reference's init (bridged), two microbatches:
    the port's step against the reference's jitted one for three steps;
    params keep their dtypes, the moments are fp32, an SSM model's SSD
    gradient runs on bf16 operands. Step 1's accumulated gradient, as the
    port's step hands it to AdamW, against the reference's accumulation
    (``jax.grad`` of its bf16 ``loss_fn`` per microbatch, summed in fp32,
    halved), leaf by leaf."""
    cfg_j, cfg = JC.get_arch(arch, "smoke"), TC.get_arch(arch, "smoke")
    p_j = jlm.init_params(jax.random.key(1), cfg_j, jnp.bfloat16)
    p = lm_params_from_numpy(jax.tree.map(np.asarray, p_j), cfg, device="cpu")
    dtypes = [t.dtype for t in leaves(p)]
    assert torch.bfloat16 in dtypes
    start = [t.detach().float().clone() for t in leaves(p)]
    ocfg = dict(lr=3e-3, total_steps=10, warmup_steps=2)
    tcfg_j = jstep.TrainStepConfig(microbatches=2, remat="none", optimizer=jopt.AdamWConfig(**ocfg))
    tcfg = TrainStepConfig(microbatches=2, remat="full", optimizer=AdamWConfig(**ocfg))
    step_j, _, _, _, init_efb_j = jstep.make_train_step(cfg_j, make_debug_mesh(), tcfg_j)
    step, init_efb = make_train_step(cfg, tcfg, device="cpu")
    jit_step = jax.jit(step_j)
    st_j, efb_j = jopt.adamw_init(p_j), init_efb_j(p_j)
    st, efb = adamw_init(p), init_efb(p)
    pipe = tokens.SyntheticTokenStream(tokens.TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=33, global_batch=4, seed=0))
    handed = []
    real_update = port_step.adamw_update

    def keep_grads(ocfg_, params, grads, state):
        if not handed:
            handed.append([g.detach().clone() for g in leaves(grads)])
        return real_update(ocfg_, params, grads, state)

    monkeypatch.setattr(port_step, "adamw_update", keep_grads)
    for s in range(3):
        raw = tokens.lm_inputs(pipe.batch(s))
        if s == 0:
            mbs = jstep._split_microbatches({k: jnp.asarray(v) for k, v in raw.items()}, 2)
            grad_j = jax.jit(jax.grad(lambda q, one: jlm.loss_fn(q, cfg_j, one)[0]))
            acc = jax.tree.map(lambda t: jnp.zeros(t.shape, jnp.float32), p_j)
            for i in range(2):
                g = grad_j(p_j, jax.tree.map(lambda v: v[i], mbs))
                acc = jax.tree.map(lambda a, gi: a + gi.astype(jnp.float32), acc, g)
            want_grads = [np.asarray(a / 2) for a in jax.tree.leaves(acc)]
        p_j, st_j, met_j, efb_j = jit_step(p_j, st_j, {k: jnp.asarray(v) for k, v in raw.items()},
                                           efb_j)
        p, st, met, efb = step(p, st, batch_from_numpy(raw, device="cpu"), efb)
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(met[k]), float(met_j[k]), rtol=BF16_STEP_RTOL,
                                       err_msg=f"{arch} step {s} {k}")
    assert [t.dtype for t in leaves(p)] == dtypes
    assert all(t.dtype == torch.float32 for t in leaves(st["m"]) + leaves(st["v"]))
    assert len(handed[0]) == len(want_grads)
    for i, (got, want) in enumerate(zip(handed[0], want_grads)):
        assert got.dtype == torch.float32, (arch, i, got.dtype)
        _assert_leaf_close(got, want, BF16_GRAD_TOL, f"{arch} step-1 grad leaf {i} {tuple(got.shape)}")
    diff2 = move2 = 0.0
    for i, (got, want, p0) in enumerate(zip(leaves(p), jax.tree.leaves(p_j), start)):
        want = torch.from_numpy(np.asarray(want).astype(np.float32))
        diff, move = float((got.detach().float() - want).norm()), float((want - p0).norm())
        assert move > 0.0 and diff <= BF16_LEAF_TOL * move, (arch, i, tuple(got.shape), diff, move)
        diff2, move2 = diff2 + diff ** 2, move2 + move ** 2
    assert diff2 ** 0.5 <= BF16_MODEL_TOL * move2 ** 0.5, (arch, diff2 ** 0.5, move2 ** 0.5)


def test_train_step_int8_sync_is_native_on_one_device_and_refusals():
    _, _, cfg, p = _model("qwen2-0.5b")
    raw = tokens.lm_inputs(tokens.SyntheticTokenStream(tokens.TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=17, global_batch=2, seed=0)).batch(0))
    outs = []
    for sync in ("native", "int8"):
        q = jax.tree.map(lambda t: t, {k: v for k, v in p.items()})
        q = {k: ({kk: vv.clone() for kk, vv in v.items()} if isinstance(v, dict) else v.clone())
             for k, v in q.items()}
        step, init_efb = make_train_step(cfg, TrainStepConfig(grad_sync=sync), device="cpu")
        q, st, met, _ = step(q, adamw_init(q), batch_from_numpy(raw, device="cpu"), init_efb(q))
        outs.append((met["loss"], leaves(q)))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))
    # A mesh runs when only its "pod" axis has more than one part; the int8
    # pod path is held against the reference in tests/test_torch_distributed.py.
    pod_step, pod_efb = make_train_step(cfg, TrainStepConfig(grad_sync="int8"), device="cpu",
                                        mesh=Mesh((2, 1, 1), ("pod", "data", "model")))
    q = {k: ({kk: vv.clone() for kk, vv in v.items()} if isinstance(v, dict) else v.clone())
         for k, v in p.items()}
    _, _, met, efb = pod_step(q, adamw_init(q), batch_from_numpy(raw, device="cpu"), pod_efb(q))
    assert torch.isfinite(met["loss"]) and all(e.shape[0] == 2 for e in leaves(efb))
    with pytest.raises(NotImplementedError, match="one card"):
        make_train_step(cfg, TrainStepConfig(), device="cpu",
                        mesh=Mesh((1, 2), ("data", "model")))
    # unroll_layers (the reference's dry-run flag) is accepted and changes
    # nothing: the same step as the native one above, bitwise.
    q = {k: ({kk: vv.clone() for kk, vv in v.items()} if isinstance(v, dict) else v.clone())
         for k, v in p.items()}
    unrolled, unrolled_efb = make_train_step(cfg, TrainStepConfig(unroll_layers=True),
                                             device="cpu")
    q, _, met, _ = unrolled(q, adamw_init(q), batch_from_numpy(raw, device="cpu"),
                            unrolled_efb(q))
    assert torch.equal(met["loss"], outs[0][0])
    assert all(torch.equal(a, b) for a, b in zip(leaves(q), outs[0][1]))
    with pytest.raises(ValueError, match="grad_sync"):
        make_train_step(cfg, TrainStepConfig(grad_sync="fp8"), device="cpu")
    step, _ = make_train_step(cfg, TrainStepConfig(microbatches=3), device="cpu")
    with pytest.raises(ValueError, match="microbatches"):
        step(p, adamw_init(p), batch_from_numpy(raw, device="cpu"), {})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_train_step(cfg, TrainStepConfig())


def test_train_step_config_fields_match_the_reference():
    assert ([f.name for f in dataclasses.fields(TrainStepConfig)]
            == [f.name for f in dataclasses.fields(jstep.TrainStepConfig)])
    assert TrainStepConfig().remat == jstep.TrainStepConfig().remat
    assert dataclasses.asdict(AdamWConfig()) == dataclasses.asdict(jopt.AdamWConfig())


# ---------------------------------------------------------------------------
# Bridge
# ---------------------------------------------------------------------------

def test_bridge_carries_an_optimizer_state_and_a_batch():
    cfg_j, p_j, cfg, _ = _model("qwen2-0.5b")
    st_j = jopt.adamw_init(p_j)
    st = opt_state_from_numpy(jax.tree.map(np.asarray, st_j), cfg, device="cpu")
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 0
    assert [tuple(t.shape) for t in leaves(st["m"])] == [x.shape for x in jax.tree.leaves(st_j["m"])]
    with pytest.raises(ValueError, match="missing leaves"):
        opt_state_from_numpy({"m": {}, "v": {}}, cfg, device="cpu")
    raw = _batch(TC.get_arch("internvl2-76b", "smoke"))
    batch = batch_from_numpy(raw, device="cpu")
    assert batch["tokens"].dtype == batch["labels"].dtype == torch.int64
    assert batch["loss_mask"].dtype == batch["prefix_embeds"].dtype == torch.float32
    for k in raw:
        np.testing.assert_array_equal(batch[k].numpy(), raw[k])
    with pytest.raises(ValueError, match="unexpected keys"):
        batch_from_numpy(dict(raw, segment_starts=raw["loss_mask"]), device="cpu")


# ---------------------------------------------------------------------------
# Launcher and example
# ---------------------------------------------------------------------------

def test_launcher_trains_and_resumes_through_a_failure(tmp_path, capsys):
    args = ["--steps", "24", "--batch", "4", "--seq", "32", "--log-every", "8",
            "--device", "cpu"]
    first, last = launch_train.main(args)
    text = capsys.readouterr().out
    assert "step     0 loss" in text and "step    16 loss" in text
    assert f"loss first10={first:.4f} last10={last:.4f}" in text
    assert last < first
    f2, l2 = launch_train.main(args + ["--ckpt-dir", str(tmp_path), "--ckpt-every", "6",
                                       "--fail-at", "15"])
    text = capsys.readouterr().out
    assert "restarts=1 replayed=3 ckpts=4" in text
    # The replayed steps are logged twice; the means over the first and the
    # last ten logged losses still fall.
    assert l2 < f2


def test_launcher_runs_a_frontend_config_with_microbatches_and_remat(capsys):
    first, last = launch_train.main(["--arch", "internvl2-76b", "--steps", "6", "--batch", "4",
                                     "--seq", "24", "--microbatches", "2", "--remat", "dots",
                                     "--device", "cpu"])
    assert np.isfinite(first) and np.isfinite(last)


def test_train_lm_example_claim_holds_as_a_module():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "2"}
    out = subprocess.run([sys.executable, "-m", "repro_torch.examples.train_lm", "--device",
                          "cpu", "--steps", "80"], capture_output=True, text=True, timeout=600,
                         cwd=ROOT, env=env)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "failure injected @40" in out.stdout and "restarts=1" in out.stdout
    assert "learned bigram structure through a mid-run failure" in out.stdout
    assert train_lm.claims(5.0, 3.9) == []
    assert train_lm.claims(5.0, 4.1) == ["model failed to learn: loss 5.00 -> 4.10"]
