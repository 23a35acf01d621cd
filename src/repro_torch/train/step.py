"""The train step on one device — the port of ``repro.train.step``.

``make_train_step`` returns ``(step, init_error_fb)`` with the reference's
step signature

    step(params, opt_state, batch, error_fb) -> (params, opt_state, metrics, error_fb)

and its metrics (loss, ce, z_loss, aux, grad_norm, lr):

* microbatch gradient accumulation: the batch's rows split into
  ``microbatches`` slices, fp32 gradients summed over them and divided by
  their number; loss and metrics are means over the microbatches (the
  reference's ``accumulate``);
* activation checkpointing per layer (``remat``: none | dots | full |
  full_recompute, :func:`repro_torch.models.lm.forward`);
* AdamW in place (:func:`repro_torch.train.optimizer.adamw_update`): the
  returned params and state are the tensors passed in, updated.

``grad_sync`` "native" and "int8" are the same on one device, as in the
reference without a pod axis. A mesh (the pod axis, the shardings and the
int8 cross-pod path) comes with the substrate slice and raises here.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.lm import REMAT_POLICIES, loss_fn
from repro_torch.train.optimizer import AdamWConfig, adamw_update, leaves, tree_map, unflatten

GRAD_SYNCS = ("native", "int8")
METRIC_KEYS = ("ce", "z_loss", "aux")


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1            # grad-accumulation steps per global step
    remat: str = "dots"              # none | dots | full | full_recompute
    attn_impl: str = "blockwise"
    grad_sync: str = "native"        # native | int8 (the same without a pod axis)
    unroll_layers: bool = False      # the dry-run's; not on one device
    optimizer: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    """(B, ...) -> n dicts of (B/n, ...) views, in row order."""
    rows = {v.shape[0] for v in batch.values()}
    if len(rows) != 1 or next(iter(rows)) % n:
        raise ValueError(f"batch rows {sorted(rows)} do not split into {n} microbatches")
    return [{k: v.chunk(n)[i] for k, v in batch.items()} for i in range(n)]


def make_train_step(cfg: ModelConfig, tcfg: TrainStepConfig, device=None, mesh=None):
    """Build the train step for ``cfg`` on ``device`` (``None``: CUDA; the
    step runs where the params live). Returns (step, init_error_fb)."""
    if mesh is not None:
        raise NotImplementedError("a mesh (pod axis, shardings, the int8 cross-pod sync) comes "
                                  "with slice 8b, the substrate")
    if tcfg.unroll_layers:
        raise NotImplementedError("unroll_layers is the dry-run's; it comes with slice 8b")
    if tcfg.grad_sync not in GRAD_SYNCS:
        raise ValueError(f"grad_sync must be one of {GRAD_SYNCS}, got {tcfg.grad_sync!r}")
    if tcfg.remat not in REMAT_POLICIES:
        raise ValueError(f"remat must be one of {REMAT_POLICIES}, got {tcfg.remat!r}")
    if tcfg.microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {tcfg.microbatches}")
    resolve_device(device)
    n = tcfg.microbatches

    def accumulate(params, batch):
        """Loss, metrics (means over microbatches) and the gradient dict
        (fp32 sums over microbatches divided by their number)."""
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
            p.grad = None
        acc: list[torch.Tensor | None] = [None] * len(flat)
        losses, metricses = [], []
        for mb in (_split_microbatches(batch, n) if n > 1 else [batch]):
            loss, metrics = loss_fn(params, cfg, mb, attn_impl=tcfg.attn_impl, remat=tcfg.remat)
            loss.backward()
            losses.append(loss.detach())
            metricses.append({k: metrics[k].detach() for k in METRIC_KEYS})
            # fp32 leaves accumulate in .grad (0 + g1 + g2, the reference's
            # order); others sum into fp32 buffers.
            for i, p in enumerate(flat):
                if p.grad is not None and p.dtype != torch.float32:
                    acc[i] = p.grad.float() if acc[i] is None else acc[i].add_(p.grad)
                    p.grad = None
        grads = []
        for i, p in enumerate(flat):
            g = p.grad if p.dtype == torch.float32 else acc[i]
            p.grad = None
            if g is None:          # a leaf the loss does not reach
                g = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            grads.append(g.div_(n) if n > 1 else g)
        if n == 1:
            return losses[0], metricses[0], grads
        loss = torch.stack(losses).mean()
        metrics = {k: torch.stack([m[k] for m in metricses]).mean() for k in METRIC_KEYS}
        return loss, metrics, grads

    def step(params, opt_state, batch, error_fb):
        loss, metrics, flat_grads = accumulate(params, batch)
        grads = unflatten(params, iter(flat_grads))
        params, opt_state, opt_metrics = adamw_update(tcfg.optimizer, params, grads, opt_state)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return params, opt_state, metrics, error_fb

    def init_error_fb(params):
        """Scalar placeholders per leaf (fp32 0): the reference's native-mode
        error feedback."""
        return tree_map(lambda p: torch.zeros((), dtype=torch.float32, device=p.device), params)

    return step, init_error_fb

