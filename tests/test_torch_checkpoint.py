"""The port's checkpoint/restart path on torch state, against the JAX
package's.

The ten tests of tests/test_checkpoint.py on dicts of tensors (the token
stream's two are the port's copy of ``repro.traces.tokens``); checkpoints
crossing between the packages in both directions (the same directory
layout, leaf names and manifest); the failure schedule against the JAX
injector's; the in-place optimizer step against ``save_async``'s snapshot;
a training run restarted by ``run_with_restarts`` bitwise the
uninterrupted one, on a dense and an SSM smoke model. No tolerance: every
comparison is exact (fp32 round trips through ``.npy`` and deterministic
CPU kernels).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as jckpt
from repro.models import lm as jlm
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.checkpoint import (
    CheckpointManager,
    FailureInjector,
    SimulatedFailure,
    restore_tree,
    run_with_restarts,
    save_tree,
)
from repro_torch.configs import get_arch
from repro_torch.launch.train import token_batch
from repro_torch.models.lm import init_params
from repro_torch.traces.tokens import SyntheticTokenStream, TokenPipelineConfig, lm_inputs
from repro_torch.train import AdamWConfig, TrainStepConfig, adamw_init, make_train_step
from repro_torch.train.optimizer import leaves


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one intra-op thread: the smoke models' steps are tiny,
    and under a parallel test run several processes' thread pools on the
    same cores make many small steps a hundred times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "a": torch.randn((4, 8), generator=g),
        "nested": {"b": torch.arange(7, dtype=torch.int32), "c": torch.tensor(3.5)},
    }


def _equal(a, b):
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def _init_state():
    return {"x": torch.tensor(0.0), "hist": torch.zeros(64)}


def _step_fn(state, step):
    rng = np.random.default_rng((7, step))   # seeded-by-step pipeline
    inc = float(rng.uniform())
    hist = state["hist"].clone()
    hist[step] = inc
    return {"x": state["x"] + inc, "hist": hist}


def test_save_restore_roundtrip(tmp_path):
    tree = _tree()
    save_tree(tmp_path, 3, tree, {"note": "hi"})
    restored, meta = restore_tree(tmp_path, 3, like=tree)
    assert meta == {"note": "hi"}
    assert _equal(tree, restored)
    flat, _ = restore_tree(tmp_path, 3)
    assert [tuple(t.shape) for t in flat] == [(4, 8), (7,), ()]


def test_checksum_detects_corruption(tmp_path):
    tree = _tree()
    final = save_tree(tmp_path, 1, tree)
    victim = sorted(final.glob("*.npy"))[0]
    arr = np.load(victim)
    arr_flat = arr.reshape(-1)
    arr_flat[arr_flat.size // 2] += 1
    np.save(victim, arr)
    with pytest.raises(IOError, match="checksum"):
        restore_tree(tmp_path, 1, like=tree)


def test_manager_retention_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, save_interval=10)
    for s in (10, 20, 30, 40):
        mgr.save(s, _tree(s))
    assert mgr.steps() == [30, 40]
    assert mgr.latest_step() == 40
    assert [mgr.should_save(s) for s in (0, 5, 10)] == [False, False, True]


def test_run_with_restarts_replays_identically(tmp_path):
    """Failure + restart reproduces the exact no-failure trajectory."""
    clean, _ = run_with_restarts(_init_state, _step_fn,
                                 CheckpointManager(tmp_path / "a", save_interval=16),
                                 total_steps=50)
    failed, stats = run_with_restarts(_init_state, _step_fn,
                                      CheckpointManager(tmp_path / "b", save_interval=16),
                                      total_steps=50,
                                      injector=FailureInjector(fail_at_steps=(23, 41)))
    assert stats["restarts"] == 2
    assert stats["replayed_steps"] == (23 - 16) + (41 - 32)
    assert _equal(clean, failed)


def test_failure_schedule_is_pure_and_is_the_reference_schedule():
    a = FailureInjector(probability=0.2, seed=42)
    b = FailureInjector(probability=0.2, seed=42)
    sched_a = [a.fails_at(s) for s in range(200)]
    sched_b = [b.fails_at(s) for s in reversed(range(200))][::-1]
    assert sched_a == sched_b
    assert any(sched_a) and not all(sched_a)
    assert all(a.fails_at(7) == a.fails_at(7) for _ in range(5))
    c = FailureInjector(probability=0.2, seed=43)
    assert sched_a != [c.fails_at(s) for s in range(200)]
    ref = jckpt.FailureInjector(probability=0.2, seed=42)
    assert sched_a == [ref.fails_at(s) for s in range(200)]


def test_restarted_process_replays_identical_failure_schedule(tmp_path):
    """Process death + fresh injector: the restarted run does not see again
    the failures the first one survived (the fired set travels in the
    checkpoint metadata) and reaches the state of a never-failed run."""
    seed, prob, total = 0, 0.04, 60
    probe = FailureInjector(probability=prob, seed=seed)
    sched = [s for s in range(total) if probe.fails_at(s)]
    assert sched
    clean, _ = run_with_restarts(_init_state, _step_fn,
                                 CheckpointManager(tmp_path / "a", save_interval=8),
                                 total_steps=total)
    mgr_dir = tmp_path / "b"
    injector1 = FailureInjector(probability=prob, seed=seed)
    half = max(sched[0] + 8, total // 2)
    _, stats1 = run_with_restarts(_init_state, _step_fn,
                                  CheckpointManager(mgr_dir, save_interval=8),
                                  total_steps=half, injector=injector1)
    fired_before = set(injector1.fired_steps())
    assert stats1["restarts"] == len([s for s in sched if s < half])
    injector2 = FailureInjector(probability=prob, seed=seed)
    mgr2 = CheckpointManager(mgr_dir, save_interval=8)
    resumed_at = mgr2.latest_step()
    failed, stats2 = run_with_restarts(_init_state, _step_fn, mgr2, total_steps=total,
                                       injector=injector2)
    replayed_old = [s for s in fired_before if s >= resumed_at]
    fresh = [s for s in sched if s >= half]
    assert stats2["restarts"] == len(replayed_old) + len(fresh)
    assert _equal(clean, failed)


def test_injector_exhausts_restarts(tmp_path):
    with pytest.raises(SimulatedFailure):
        run_with_restarts(lambda: {"x": torch.tensor(0.0)}, lambda s, i: s,
                          CheckpointManager(tmp_path, save_interval=100), total_steps=5,
                          injector=FailureInjector(fail_at_steps=(0,)), max_restarts=0)


def test_token_pipeline_restartable():
    cfg = TokenPipelineConfig(vocab_size=128, seq_len=32, global_batch=4, seed=9)
    a = SyntheticTokenStream(cfg).batch(17)
    b = SyntheticTokenStream(cfg).batch(17)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = SyntheticTokenStream(cfg).batch(18)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_host_sharding_partitions_batch():
    cfg = TokenPipelineConfig(vocab_size=64, seq_len=16, global_batch=8, seed=3)
    stream = SyntheticTokenStream(cfg)
    full = stream.batch(0)["tokens"]
    merged = np.empty_like(full)
    for h in range(4):
        merged[h::4] = next(stream.shard_iterator(h, 4))["tokens"]
    np.testing.assert_array_equal(merged, full)


def test_async_save_snapshots_before_in_place_updates(tmp_path):
    """save_async copies at call time: an in-place update of the same CPU
    tensor after the call (the optimizer step's habit) does not reach the
    file; a rebinding does not either."""
    mgr = CheckpointManager(tmp_path, save_interval=1)
    tree = {"x": torch.arange(8, dtype=torch.float32), "y": torch.ones(3)}
    mgr.save_async(3, tree)
    tree["x"].add_(100.0)
    tree["y"] = tree["y"] + 5.0
    mgr.wait()
    restored, _, step = mgr.restore(tree)
    assert step == 3
    assert torch.equal(restored["x"], torch.arange(8, dtype=torch.float32))
    assert torch.equal(restored["y"], torch.ones(3))


def test_async_save_errors_surface_in_wait(tmp_path):
    mgr = CheckpointManager(tmp_path / "ok", save_interval=1)
    mgr.directory = tmp_path / "file"
    (tmp_path / "file").write_text("not a directory")
    mgr.save_async(1, _tree())
    with pytest.raises(OSError):
        mgr.wait()


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A JAX ``save_tree`` of a model's params restores in the port to the
    bridged values, with the same leaf files and manifest paths; the
    port's checkpoint restores in the JAX package."""
    from repro.configs import get_arch as jget_arch

    cfg_j, cfg = jget_arch("mamba2-2.7b", "smoke"), get_arch("mamba2-2.7b", "smoke")
    p_j = jlm.init_params(jax.random.key(0), cfg_j, jnp.float32)
    tree_j = {"params": p_j, "step": jnp.int32(7)}
    jckpt.save_tree(tmp_path / "jax", 5, tree_j, {"from": "jax"})
    bridged = {"params": lm_params_from_numpy(jax.tree.map(np.asarray, p_j), cfg, device="cpu"),
               "step": torch.tensor(7, dtype=torch.int32)}
    like = {"params": init_params(cfg, torch.Generator().manual_seed(1), device="cpu"),
            "step": torch.tensor(0, dtype=torch.int32)}
    restored, meta = restore_tree(tmp_path / "jax", 5, like=like)
    assert meta == {"from": "jax"}
    assert _equal(restored, bridged)
    save_tree(tmp_path / "torch", 5, bridged, {"from": "torch"})
    man = lambda d: json.loads((d / "step_00000005" / "manifest.json").read_text())
    mj, mt = man(tmp_path / "jax"), man(tmp_path / "torch")
    strip = lambda m: [{k: leaf[k] for k in ("name", "path", "shape", "dtype", "crc32")}
                       for leaf in m["leaves"]]
    assert strip(mj) == strip(mt) and mj["step"] == mt["step"] == 5
    back, meta = jckpt.restore_tree(tmp_path / "torch", 5, like=tree_j)
    assert meta == {"from": "torch"}
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree_j)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-2.7b"])
def test_train_run_restarted_is_bitwise_the_uninterrupted_run(tmp_path, arch):
    cfg = get_arch(arch, "smoke")
    step, init_efb = make_train_step(cfg, TrainStepConfig(
        microbatches=2, remat="full", optimizer=AdamWConfig(lr=3e-3, total_steps=8,
                                                            warmup_steps=2)), device="cpu")
    pipe = SyntheticTokenStream(TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=25,
                                                    global_batch=4, seed=1))

    def init_state():
        params = init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
        return {"params": params, "opt": adamw_init(params), "efb": init_efb(params)}

    def one_step(state, s):
        params, opt, _, efb = step(state["params"], state["opt"],
                                   token_batch(lm_inputs(pipe.batch(s)), "cpu"), state["efb"])
        return {"params": params, "opt": opt, "efb": efb}

    clean, _ = run_with_restarts(init_state, one_step,
                                 CheckpointManager(tmp_path / "a", save_interval=3), 8)
    failed, stats = run_with_restarts(init_state, one_step,
                                      CheckpointManager(tmp_path / "b", save_interval=3), 8,
                                      FailureInjector(fail_at_steps=(5,)))
    assert stats == {"restarts": 1, "replayed_steps": 2, "checkpoints": 2}
    assert int(failed["opt"]["step"]) == 8
    assert _equal(clean, failed)
