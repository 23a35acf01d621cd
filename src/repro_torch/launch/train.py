"""Training launcher: the production path in miniature on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --variant smoke --steps 200 --batch 8 --seq 128 \\
      [--ckpt-dir /tmp/ckpt] [--fail-at 120] [--remat full] [--device cpu]

The synthetic token stream (bitwise the JAX package's batches for the same
seed and step) -> the train step (microbatches, remat, AdamW in place) ->
checkpoint/restart with an injected failure (``--fail-at``). A frontend
config draws its stub embeddings per step from ``make_batch`` with a
generator seeded by the step. Prints the reference launcher's step lines
and its closing ``loss first10=… last10=… delta=…`` line; ``main`` returns
(first, last), ``run`` the final state and every step's loss. Runs on CUDA
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, FailureInjector, run_with_restarts
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models.inputs import make_batch
from repro_torch.models.lm import REMAT_POLICIES, init_params
from repro_torch.traces.tokens import SyntheticTokenStream, TokenPipelineConfig, lm_inputs
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.step import GRAD_SYNCS, TrainStepConfig, make_train_step


def token_batch(raw: dict, device) -> dict:
    """A numpy ``lm_inputs`` batch as the port's tensors: int64 ids and
    labels, fp32 loss mask."""
    return {"tokens": torch.from_numpy(raw["tokens"]).to(device, torch.int64),
            "labels": torch.from_numpy(raw["labels"]).to(device, torch.int64),
            "loss_mask": torch.from_numpy(raw["loss_mask"]).to(device, torch.float32)}


def run(argv=None) -> tuple[dict, list[tuple[int, float]]]:
    """Parse the flags, train, print the step lines; return the final state
    ({"params", "opt", "efb"}) and the (step, loss) of every step run,
    replayed steps included."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--variant", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=REMAT_POLICIES)
    ap.add_argument("--grad-sync", default="native", choices=GRAD_SYNCS)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=-1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch, args.variant)
    shape = ShapeConfig("cli", "train", args.seq, args.batch)
    tcfg = TrainStepConfig(
        microbatches=args.microbatches, remat=args.remat, grad_sync=args.grad_sync,
        optimizer=AdamWConfig(lr=args.lr, total_steps=args.steps,
                              warmup_steps=min(20, args.steps // 5)),
    )
    step_fn, init_efb = make_train_step(cfg, tcfg, device=dev)
    pipe = SyntheticTokenStream(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq + 1, global_batch=args.batch,
        seed=args.seed,
    ))

    def batch_for(step: int) -> dict:
        if cfg.frontend:
            # Modality stubs: seeded synthetic embeddings per step.
            gen = torch.Generator(device=dev).manual_seed(step)
            return make_batch(cfg, shape, gen, device=dev, embed_dtype=torch.float32)
        return token_batch(lm_inputs(pipe.batch(step)), dev)

    def init_state():
        gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
        params = init_params(cfg, gen, torch.float32, device=dev)
        return {"params": params, "opt": adamw_init(params), "efb": init_efb(params)}

    losses = []
    t_start = time.time()

    def one_step(state, step):
        params, opt, metrics, efb = step_fn(state["params"], state["opt"], batch_for(step),
                                            state["efb"])
        loss = float(metrics["loss"])
        losses.append((step, loss))
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e}", flush=True)
        return {"params": params, "opt": opt, "efb": efb}

    if args.ckpt_dir:
        manager = CheckpointManager(args.ckpt_dir, save_interval=args.ckpt_every)
        injector = FailureInjector(fail_at_steps=(args.fail_at,) if args.fail_at >= 0 else ())
        state, stats = run_with_restarts(init_state, one_step, manager, args.steps, injector)
        print(f"done in {time.time() - t_start:.1f}s; restarts={stats['restarts']} "
              f"replayed={stats['replayed_steps']} ckpts={stats['checkpoints']}")
    else:
        state = init_state()
        for s in range(args.steps):
            state = one_step(state, s)
        print(f"done in {time.time() - t_start:.1f}s")
    return state, losses


def main(argv=None):
    _, losses = run(argv)
    first = np.mean([l for _, l in losses[:10]])
    last = np.mean([l for _, l in losses[-10:]])
    print(f"loss first10={first:.4f} last10={last:.4f} delta={first - last:+.4f}")
    return first, last


if __name__ == "__main__":
    main()
