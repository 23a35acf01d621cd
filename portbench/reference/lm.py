"""The plain language model around a reference layer: the token embedding,
the layers in turn, the final RMSNorm and the head; a prompt's prefill
outputs, the training loss and AdamW.

The weights are a dict in the benchmark's layout (``portbench.inputs``):
top leaves and ``"blocks"``, each block leaf stacked on a leading layer
axis. Everything is fp32 with TF32 off (:func:`portbench.reference.ops
.fp32_matmuls`), the products in the precision of a :class:`Products`.
Work runs one prompt, or a few rows, at a time, so that the reference fits
on the card beside the program's outputs.
"""

from __future__ import annotations

import importlib
import math
import time

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.ops import Products, rms_norm

#: The z-loss coefficient of the training loss (``z · mean(logsumexp²)``).
Z_COEF = 1e-4


def layer_module(name: str):
    """The module ``portbench.reference.<name>`` that defines ``layer``."""
    return importlib.import_module(f"portbench.reference.{name}")


def _head(weights: dict, model: dict):
    return weights["embed"].T if model["tie_embeddings"] else weights["lm_head"]


@torch.no_grad()
def prefill_row(mod, weights: dict, model: dict, tokens, cache_slots: int | None,
                prod: Products):
    """One prompt (1, S): (last-position logits (1, 1, V) over the real
    vocabulary, {state leaf: (L, 1, ...)} for every layer)."""
    h = weights["embed"][tokens]
    states: dict[str, list] = {}
    for i in range(model["num_layers"]):
        lp = {name: leaf[i] for name, leaf in weights["blocks"].items()}
        h, state = mod.layer(lp, h, model, prod, cache_slots)
        for name, leaf in state.items():
            states.setdefault(name, []).append(leaf)
    h = rms_norm(h[:, -1:], weights["final_norm"], model["norm_eps"])
    logits = prod.linear(h, _head(weights, model))[..., :model["vocab_size"]]
    return logits, {name: torch.stack(leaves) for name, leaves in states.items()}


def loss_sum(mod, weights: dict, model: dict, tokens, labels, prod: Products):
    """Σ over the rows' tokens of cross-entropy + Z_COEF · logsumexp², the
    softmax over the real vocabulary; each layer under checkpoint (its input
    kept, the layer recomputed in the backward)."""
    h = F.embedding(tokens, weights["embed"])
    names = sorted(weights["blocks"])
    views = [weights["blocks"][name].unbind(0) for name in names]

    def run(h, *leaves):
        return mod.layer(dict(zip(names, leaves)), h, model, prod)[0]

    for i in range(model["num_layers"]):
        h = checkpoint(run, h, *(v[i] for v in views), use_reentrant=False)
    h = rms_norm(h, weights["final_norm"], model["norm_eps"])
    logits = prod.linear(h, _head(weights, model))[..., :model["vocab_size"]]
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return ((logz - gold) + Z_COEF * logz.square()).sum()


def nest(flat: dict) -> dict:
    """{"a": x, "blocks/b": y} -> {"a": x, "blocks": {"b": y}}."""
    out: dict = {"blocks": {}}
    for path, leaf in flat.items():
        top, _, name = path.partition("/")
        if name:
            out[top][name] = leaf
        else:
            out[top] = leaf
    return out


def cosine_lr(opt: dict, step: int) -> float:
    """Linear warm-up, then cosine decay to ``min_lr_ratio`` of the rate."""
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    frac = min(max((step - opt["warmup_steps"]) / max(opt["total_steps"] - opt["warmup_steps"], 1),
                   0.0), 1.0)
    ratio = opt["min_lr_ratio"]
    return opt["lr"] * warm * (ratio + (1.0 - ratio) * 0.5 * (1.0 + math.cos(math.pi * frac)))


def train(mod, model: dict, opt: dict, make_weights, batches, steps: int, prod: Products,
          row_block: int) -> dict:
    """``steps`` AdamW steps from ``make_weights()`` (the benchmark's weights,
    in the dtypes the cell stores them) on ``batches`` (steps, rows, S + 1):
    the gradient of the mean loss over every token of a step, clipped to
    the global norm ``clip_norm``, bias-corrected moments, decoupled decay
    on matrices, each leaf rounded back to its stored dtype after its update.
    Returns {"losses": [per step], "grad_norms": {leaf: ‖g‖ of step 1},
    "change_norms": {leaf: ‖p_steps - p_0‖}, "step_s": [host seconds a step]}."""
    from portbench.inputs import leaf_items

    stored = dict(leaf_items(make_weights()))
    dtypes = {name: w.dtype for name, w in stored.items()}
    params = {name: w.float().requires_grad_(True) for name, w in stored.items()}
    del stored
    m = {name: torch.zeros_like(p) for name, p in params.items()}
    v = {name: torch.zeros_like(p) for name, p in params.items()}
    weights = nest(params)
    losses, grad_norms, walls = [], {}, []
    for t in range(steps):
        t0 = time.perf_counter()
        batch = batches[t]
        rows, tokens = batch.shape[0], batch.shape[0] * (batch.shape[1] - 1)
        total = torch.zeros((), dtype=torch.float64, device=batch.device)
        for r0 in range(0, rows, row_block):
            rb = batch[r0:r0 + row_block]
            loss = loss_sum(mod, weights, model, rb[:, :-1], rb[:, 1:], prod) / tokens
            loss.backward()
            total += loss.detach().double()
        losses.append(float(total))
        with torch.no_grad():
            norms = {name: p.grad.norm().item() for name, p in params.items()}
            if t == 0:
                grad_norms = norms
            step = t + 1
            gnorm = math.sqrt(sum(n * n for n in norms.values()))
            scale = min(opt["clip_norm"] / max(gnorm, 1e-9), 1.0)
            lr = cosine_lr(opt, step)
            bc1, bc2 = 1.0 - opt["b1"] ** step, 1.0 - opt["b2"] ** step
            for name, p in params.items():
                g = p.grad.mul_(scale)
                m[name].mul_(opt["b1"]).add_(g, alpha=1.0 - opt["b1"])
                v[name].mul_(opt["b2"]).addcmul_(g, g, value=1.0 - opt["b2"])
                p.grad = None
                delta = (m[name] / bc1) / ((v[name] / bc2).sqrt_().add_(opt["eps"]))
                if p.ndim >= 2:
                    delta.add_(p, alpha=opt["weight_decay"])
                p.sub_(delta.mul_(lr))
                p.copy_(p.to(dtypes[name]).float())
        walls.append(time.perf_counter() - t0)
    del m, v
    start = dict(leaf_items(make_weights()))
    with torch.no_grad():
        change = {name: (params[name] - start[name].float()).norm().item() for name in params}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change, "step_s": walls}
