"""AdamW with decoupled weight decay, global-norm clipping, cosine schedule
— the port of ``repro.train.optimizer``.

The state mirrors the param dict (m, v fp32 whatever the param dtype;
``step`` an int32 scalar). The update follows the reference leaf for leaf,
in the same order — the global-norm clip scale, then the bias-corrected
m̂ / (√v̂ + eps), then decoupled weight decay on leaves with ndim >= 2 only —
but runs **in place** under ``torch.no_grad()``: at mamba2-2.7b's width a
stacked (64, 2560, 5120) leaf is 3.36 GB, and a functional update's half a
dozen temporaries per leaf would not fit the card beside the params, the
gradients and both moments. At most two leaf-sized temporaries live at once.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import Tensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def cosine_lr(cfg: AdamWConfig, step) -> Tensor:
    """Linear warmup then cosine decay to ``min_lr_ratio * lr`` (fp32; the
    step a tensor, on its device, or a number)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos)


def leaves(tree) -> list[Tensor]:
    """A nested dict's tensors in the JAX package's flatten order (keys
    sorted at every level, as ``jax.tree`` flattens dicts)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in leaves(tree[key])]
    return [tree]


def unflatten(tree, it):
    """A dict shaped as ``tree`` whose leaves come from the iterator ``it``
    in :func:`leaves` order."""
    if isinstance(tree, dict):
        return {key: unflatten(tree[key], it) for key in sorted(tree)}
    return next(it)


def tree_map(fn, tree):
    """``fn`` over a nested dict's tensors, keeping its structure."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, val) for key, val in tree.items()}
    return fn(tree)


def adamw_init(params) -> dict:
    """{"m", "v": zeros fp32 shaped as the params, "step": int32 0}, on the
    params' devices."""
    zeros = lambda: tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                             params)
    dev = leaves(params)[0].device
    return {"m": zeros(), "v": zeros(), "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _sq_norm(g: Tensor) -> Tensor:
    flat = g.reshape(-1).float()
    return torch.dot(flat, flat)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state) -> tuple:
    """One AdamW step, **in place**: returns (params, state, metrics) where
    params and state are the same dicts holding the same tensors, updated
    (``step`` too), and metrics {"grad_norm", "lr"} are fp32 scalars on
    the device. ``grads`` (a dict shaped as params) is consumed: fp32
    gradients are scaled by the clip factor in place."""
    flat_p, flat_g = leaves(params), leaves(grads)
    flat_m, flat_v = leaves(state["m"]), leaves(state["v"])
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("params, grads and the moments must hold the same leaves")
    state["step"].add_(1)
    stepf = state["step"].to(torch.float32)
    gnorm = torch.sqrt(sum(_sq_norm(g) for g in flat_g))
    scale = torch.clamp(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), max=1.0)
    lr = cosine_lr(cfg, state["step"])
    bc1, bc2 = 1.0 - cfg.b1 ** stepf, 1.0 - cfg.b2 ** stepf
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        gf = g.mul_(scale) if g.dtype == torch.float32 else g.float().mul_(scale)
        m.mul_(cfg.b1).add_(gf, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(gf, gf, value=1 - cfg.b2)
        del gf
        delta = torch.div(v, bc2).sqrt_().add_(cfg.eps)          # √v̂ + eps
        delta = torch.div(m, bc1).div_(delta)                    # m̂ / (√v̂ + eps)
        pf = p if p.dtype == torch.float32 else p.float()
        if p.ndim >= 2:                                          # decay matrices only
            delta.add_(pf, alpha=cfg.weight_decay)
        pf.sub_(delta.mul_(lr))
        if pf is not p:
            p.copy_(pf)
    return params, state, {"grad_norm": gnorm, "lr": lr}
