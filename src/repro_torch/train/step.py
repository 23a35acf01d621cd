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
  returned params and state are the tensors passed in, updated;
* under a profiler, the spans ``train.step`` (the whole step),
  ``train.forward`` (each microbatch's loss), ``train.backward`` (each
  microbatch's backward and fp32 accumulation) and ``train.optimizer``
  (:mod:`repro_torch.telemetry.ranges`).

``unroll_layers`` is accepted and changes nothing: the port's layers are
always a Python loop (:mod:`repro_torch.models.lm`).

``grad_sync`` "native" and "int8" are the same without a pod axis, as in
the reference. With a ``mesh`` that has a ``"pod"`` axis and
``grad_sync="int8"`` the step is the reference's multi-pod one, its pods
run one after another on the one device: pod p takes the batch's rows
``[p·B/n, (p+1)·B/n)`` and runs the microbatch accumulation on them; its
gradients plus its error feedback are quantized for the int8 cross-pod
sum (:mod:`repro_torch.distributed.compression`) and freed before the next
pod runs; loss and metrics are means over pods; AdamW updates with the
synced gradients. The error feedback is then one fp32 ``(n_pods,) +
p.shape`` leaf per parameter, updated in place. ``grad_sync="native"``
with a pod axis is the whole batch's step, as the reference's XLA
all-reduce computes it. A mesh whose ``"data"`` or ``"model"`` axis (or
any axis but ``"pod"``) has more than one part raises: one card is a world
of size 1.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.compression import quantize_pod, reduce_pods
from repro_torch.models.lm import REMAT_POLICIES, loss_fn
from repro_torch.telemetry.ranges import span
from repro_torch.train.optimizer import AdamWConfig, adamw_update, leaves, tree_map, unflatten

GRAD_SYNCS = ("native", "int8")
METRIC_KEYS = ("ce", "z_loss", "aux")


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1            # grad-accumulation steps per global step
    remat: str = "dots"              # none | dots | full | full_recompute
    attn_impl: str = "blockwise"
    grad_sync: str = "native"        # native | int8 (the same without a pod axis)
    unroll_layers: bool = False      # the reference's dry-run flag; changes nothing here
    optimizer: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    """(B, ...) -> n dicts of (B/n, ...) views, in row order."""
    rows = {v.shape[0] for v in batch.values()}
    if len(rows) != 1 or next(iter(rows)) % n:
        raise ValueError(f"batch rows {sorted(rows)} do not split into {n} microbatches")
    return [{k: v.chunk(n)[i] for k, v in batch.items()} for i in range(n)]


def _pod_count(mesh) -> int | None:
    """The mesh's pod-axis size (``None``: no pod axis). Any other axis of
    more than one part raises: the port trains on one card."""
    if mesh is None:
        return None
    wide = {a: n for a, n in mesh.shape.items() if a != "pod" and n > 1}
    if wide:
        raise NotImplementedError(
            f"mesh axes {wide}: the port trains on one card, a world of size 1; only a "
            "'pod' axis (its pods run one after another) has more than one part")
    return mesh.shape.get("pod")


def make_train_step(cfg: ModelConfig, tcfg: TrainStepConfig, device=None, mesh=None):
    """Build the train step for ``cfg`` on ``device`` (``None``: CUDA; the
    step runs where the params live). ``mesh``: a
    :class:`repro_torch.distributed.mesh.Mesh`, whose ``"pod"`` axis runs
    the int8 cross-pod sync under ``grad_sync="int8"``. Returns (step,
    init_error_fb)."""
    if tcfg.grad_sync not in GRAD_SYNCS:
        raise ValueError(f"grad_sync must be one of {GRAD_SYNCS}, got {tcfg.grad_sync!r}")
    if tcfg.remat not in REMAT_POLICIES:
        raise ValueError(f"remat must be one of {REMAT_POLICIES}, got {tcfg.remat!r}")
    if tcfg.microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {tcfg.microbatches}")
    n_pods = _pod_count(mesh)
    resolve_device(device)
    n = tcfg.microbatches
    pod_int8 = tcfg.grad_sync == "int8" and n_pods is not None

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
            with span("train.forward"):
                loss, metrics = loss_fn(params, cfg, mb, attn_impl=tcfg.attn_impl,
                                        remat=tcfg.remat, unroll_layers=tcfg.unroll_layers)
            losses.append(loss.detach())
            metricses.append({k: metrics[k].detach() for k in METRIC_KEYS})
            with span("train.backward"):
                loss.backward()
                # fp32 leaves accumulate in .grad (0 + g1 + g2, the
                # reference's order); others sum into fp32 buffers.
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

    def pod_step(params, batch, error_fb):
        """The multi-pod loss, metrics and synced gradients; each pod's
        error feedback is replaced by its new residual in place."""
        rows = {v.shape[0] for v in batch.values()}
        if len(rows) != 1 or next(iter(rows)) % n_pods:
            raise ValueError(f"batch rows {sorted(rows)} do not split over {n_pods} pods")
        flat_p, flat_e = leaves(params), leaves(error_fb)
        sent = [[] for _ in flat_p]
        losses, metricses = [], []
        for pod in range(n_pods):
            loss, metrics, grads = accumulate(params, {k: v.chunk(n_pods)[pod]
                                                       for k, v in batch.items()})
            losses.append(loss)
            metricses.append(metrics)
            for i, g in enumerate(grads):
                q, scale, resid = quantize_pod(g + flat_e[i][pod].to(g.dtype), n_pods)
                flat_e[i][pod].copy_(resid)
                sent[i].append((q, scale))
            del grads
        synced = []
        for i, p in enumerate(flat_p):
            q = torch.stack([x[0] for x in sent[i]])
            scale = torch.stack([x[1] for x in sent[i]])
            sent[i] = None
            synced.append(reduce_pods(q, scale, p.shape, torch.float32) / n_pods)
        pmean = lambda xs: sum(xs[1:], xs[0]) / n_pods
        return (pmean(losses), {k: pmean([m[k] for m in metricses]) for k in METRIC_KEYS},
                synced)

    def step(params, opt_state, batch, error_fb):
        with span("train.step"):
            if pod_int8:
                loss, metrics, flat_grads = pod_step(params, batch, error_fb)
            else:
                loss, metrics, flat_grads = accumulate(params, batch)
            grads = unflatten(params, iter(flat_grads))
            with span("train.optimizer"):
                params, opt_state, opt_metrics = adamw_update(tcfg.optimizer, params, grads,
                                                              opt_state)
            metrics = dict(metrics, loss=loss, **opt_metrics)
        return params, opt_state, metrics, error_fb

    def init_error_fb(params):
        """fp32 zeros ``(n_pods,) + p.shape`` per leaf on the int8 pod path;
        scalar placeholders per leaf (fp32 0) otherwise, the reference's
        native-mode error feedback."""
        if pod_int8:
            return tree_map(lambda p: torch.zeros((n_pods,) + tuple(p.shape), dtype=torch.float32,
                                                  device=p.device), params)
        return tree_map(lambda p: torch.zeros((), dtype=torch.float32, device=p.device), params)

    return step, init_error_fb

