"""End-to-end training run with fault tolerance.

Trains qwen2-0.5b's smoke model (~1M params) for 300 steps on the
synthetic token stream, batch 8 x 128 tokens, checkpoints every 60 steps,
injects a failure at step 150 and resumes from the last checkpoint — the
checkpoint/restart path a real fleet uses, in miniature. Its claim: the
loss falls by more than 1.0 (mean of the last ten steps against the first
ten) through the failure.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--device cpu] [--steps 300]

``--steps`` scales the checkpoint interval (steps / 5) and the failure
(steps / 2) with it.
"""

from __future__ import annotations

import argparse
import shutil
import sys
import tempfile

from repro_torch.device import resolve_device
from repro_torch.launch.train import main as train_main

STEPS = 300


def claims(first: float, last: float) -> list[str]:
    """The demo's claim, broken: the model learned (loss down by > 1.0)."""
    return [] if last < first - 1.0 else [f"model failed to learn: loss {first:.2f} -> {last:.2f}"]


def main(device=None, steps=None) -> tuple[float, float]:
    """Run the demo on ``device`` (``None``: CUDA) for ``steps`` steps
    (default 300); return (first, last) — the mean loss of the first and
    the last ten steps."""
    dev = resolve_device(device)
    steps = steps or STEPS
    ckpt = tempfile.mkdtemp(prefix="repro_torch_train_")
    try:
        print(f"=== train {steps} steps, checkpoint every {steps // 5}, "
              f"failure injected @{steps // 2} ===")
        first, last = train_main([
            "--arch", "qwen2-0.5b", "--variant", "smoke",
            "--steps", str(steps), "--batch", "8", "--seq", "128",
            "--ckpt-dir", ckpt, "--ckpt-every", str(steps // 5),
            "--fail-at", str(steps // 2), "--log-every", "50", "--device", str(dev),
        ])
        print(f"\nlearned bigram structure through a mid-run failure: "
              f"loss {first:.2f} -> {last:.2f}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return first, last


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--steps", type=int, default=None, help=f"default {STEPS}")
    args = ap.parse_args()
    if bad := claims(*main(args.device, args.steps)):
        sys.exit("train_lm: " + "; ".join(bad))
