"""The plain language model around a reference layer: the token embedding,
the layers in turn, the final RMSNorm and the head; a prompt's prefill
outputs, the training loss and AdamW.

The weights are a dict in the benchmark's layout (``portbench.inputs``):
top leaves and stacked groups. A family's module
(``portbench.reference.<name>``) defines ``layer`` for the default forward
here, which gives it each layer's leaves of the family's layout in turn
(by default one group ``"blocks"`` over every layer). Or it defines
its own ``prefill_row(weights, model, tokens, cache_slots, prod)`` and
``loss_sum(weights, model, tokens, labels, prod)`` (this module's
arguments, less the module), and owns its layer order, its scales and its
state leaves; :func:`prefill_row`, :func:`loss_sum` and :func:`train`
call those where they exist.

Everything is fp32 with TF32 off (:func:`portbench.reference.ops
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

from portbench.inputs import layer_leaves, layout, leaf_items
from portbench.reference.ops import Products, rms_norm

#: The z-loss coefficient of the training loss (``z · mean(logsumexp²)``).
Z_COEF = 1e-4


def layer_module(name: str):
    """The family's module ``portbench.reference.<name>``."""
    return importlib.import_module(f"portbench.reference.{name}")


def _head(weights: dict, model: dict):
    return weights["embed"].T if model["tie_embeddings"] else weights["lm_head"]


def head_logits(weights: dict, model: dict, h, prod: Products):
    """The final RMSNorm and the head over (..., D): logits over the real
    vocabulary."""
    h = rms_norm(h, weights["final_norm"], model["norm_eps"])
    return prod.linear(h, _head(weights, model))[..., :model["vocab_size"]]


def token_loss_sum(logits, labels):
    """Σ over tokens of cross-entropy + Z_COEF · logsumexp² of ``logits``."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return ((logz - gold) + Z_COEF * logz.square()).sum()


@torch.no_grad()
def prefill_row(mod, weights: dict, model: dict, tokens, cache_slots: int | None,
                prod: Products):
    """One prompt (1, S): (last-position logits (1, 1, V) over the real
    vocabulary, {state leaf: (layers holding it, 1, ...)})."""
    if hasattr(mod, "prefill_row"):
        return mod.prefill_row(weights, model, tokens, cache_slots, prod)
    h = weights["embed"][tokens]
    states: dict[str, list] = {}
    for lp in layer_leaves(weights, layout(model, mod)[1], model["num_layers"]):
        h, state = mod.layer(lp, h, model, prod, cache_slots)
        for name, leaf in state.items():
            states.setdefault(name, []).append(leaf)
    return (head_logits(weights, model, h[:, -1:], prod),
            {name: torch.stack(leaves) for name, leaves in states.items()})


def loss_sum(mod, weights: dict, model: dict, tokens, labels, prod: Products):
    """Σ over the rows' tokens of cross-entropy + Z_COEF · logsumexp², the
    softmax over the real vocabulary; each layer under checkpoint (its input
    kept, the layer recomputed in the backward)."""
    if hasattr(mod, "loss_sum"):
        return mod.loss_sum(weights, model, tokens, labels, prod)
    h = F.embedding(tokens, weights["embed"])

    def run(h, names, *leaves):
        return mod.layer(dict(zip(names, leaves)), h, model, prod)[0]

    for lp in layer_leaves(weights, layout(model, mod)[1], model["num_layers"]):
        h = checkpoint(run, h, list(lp), *lp.values(), use_reentrant=False)
    return token_loss_sum(head_logits(weights, model, h, prod), labels)


def nest(flat: dict) -> dict:
    """The tree that ``portbench.inputs.leaf_items`` flattened:
    {"a": x, "g/b": y} -> {"a": x, "g": {"b": y}}, for any groups."""
    out: dict = {}
    for path, leaf in flat.items():
        *groups, name = path.split("/")
        node = out
        for group in groups:
            node = node.setdefault(group, {})
        node[name] = leaf
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
