"""int8 compressed cross-pod gradient sum with error feedback — the port of
``repro.distributed.compression``.

The reference splits a multi-pod mesh's gradient sync in two tiers: native
fp32 within a pod, and an int8 reduce-scatter + all-gather over the slow
``"pod"`` axis (the paper's inter-datacenter WAN tier), run inside
``shard_map``. One card holds every pod, so the pod axis is a leading
``(n_pods, ...)`` axis on one device and the collectives become data
movement:

  1. per leaf, each pod flattens its copy, pads it to a multiple of n_pods
     and views it as (n_pods, chunk) rows, row j bound for pod j;
  2. per-row absmax scale (absmax / 127, at least 1e-30) -> int8 by
     ``round`` (half to even in both libraries); the quantization residual
     is taken here, before the exchange, as the error feedback;
  3. ``all_to_all`` is a transpose: pod j receives every pod's row j;
  4. each pod's owned chunk is the fp32 sum of the dequantized rows it
     received, added in pod order;
  5. the owned chunk is quantized again, ``all_gather`` is a stack of the
     pods' chunks in pod order, and the dequantized stack, unpadded, is the
     total.

The sums are plain elementwise arithmetic outside any kernel in the
reference too (``jnp``), so plain torch operations are their port.
:func:`quantize_pod` and :func:`reduce_pods` split the exchange at its
send side, so that a train step can quantize one pod's gradients and free
them before it computes the next pod's.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor

__all__ = ["compressed_psum_pod", "quantize_pod", "reduce_pods", "sync_tree"]


def _quantize(x: Tensor) -> tuple[Tensor, Tensor]:
    """Symmetric int8 quantization per row (last axis). The absmax is
    divided by a tensor of 127s: CUDA divides by a number as a product with
    its reciprocal, which can round otherwise than the division."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(absmax / torch.full_like(absmax, 127.0), 1e-30)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: Tensor, scale: Tensor) -> Tensor:
    return q.to(torch.float32) * scale


def quantize_pod(leaf: Tensor, n_pods: int) -> tuple[Tensor, Tensor, Tensor]:
    """One pod's send side for one leaf: ``(q (n_pods, chunk) int8, scale
    (n_pods, 1) fp32, residual)``, the residual (the error feedback) shaped
    and typed as ``leaf``. Row j of ``q`` is bound for pod j."""
    flat = leaf.to(torch.float32).reshape(-1)
    size = flat.numel()
    pad = (-size) % n_pods
    rows = torch.nn.functional.pad(flat, (0, pad)).reshape(n_pods, -1)
    q, scale = _quantize(rows)
    residual = (rows - _dequantize(q, scale)).reshape(-1)[:size]
    return q, scale, residual.reshape(leaf.shape).to(leaf.dtype)


def reduce_pods(q: Tensor, scale: Tensor, shape, dtype) -> Tensor:
    """The exchange and the owned sums: ``q`` (n_src, n_dst, chunk) and
    ``scale`` (n_src, n_dst, 1) stack every pod's :func:`quantize_pod`
    rows in pod order. Returns the summed leaf, ``shape`` in ``dtype``, as
    every pod receives it."""
    n_pods = q.shape[0]
    recv_q, recv_s = q.transpose(0, 1), scale.transpose(0, 1)   # all_to_all: [dst, src]
    owned = _dequantize(recv_q[:, 0], recv_s[:, 0])             # (dst, chunk)
    for p in range(1, n_pods):
        owned = owned + _dequantize(recv_q[:, p], recv_s[:, p])
    q2, s2 = _quantize(owned)                                   # each pod its own chunk
    total = _dequantize(q2, s2).reshape(-1)[:math.prod(shape)]  # all_gather: the stack
    return total.reshape(shape).to(dtype)


def compressed_psum_pod(leaf: Tensor, n_pods: int) -> tuple[Tensor, Tensor]:
    """Compressed sum over the pod axis of one leaf stacked over pods,
    ``(n_pods, ...)``: returns ``(total, residual)``, the total shaped as
    one pod's leaf (``leaf.shape[1:]``, in its dtype), the residual
    ``(n_pods, ...)`` as ``leaf``."""
    if leaf.shape[0] != n_pods:
        raise ValueError(f"leaf's leading pod axis is {leaf.shape[0]}, not n_pods={n_pods}")
    sent = [quantize_pod(leaf[p], n_pods) for p in range(n_pods)]
    q = torch.stack([s[0] for s in sent])
    scale = torch.stack([s[1] for s in sent])
    return reduce_pods(q, scale, leaf.shape[1:], leaf.dtype), torch.stack([s[2] for s in sent])


def sync_tree(grads, n_pods: int, error_fb=None):
    """Tree-wise compressed pod-axis mean of per-pod gradients.

    Args:
        grads: a dict tree whose leaves stack each pod's partial gradient,
            ``(n_pods, ...)``.
        n_pods: the pod-axis size.
        error_fb: an optional tree shaped as ``grads``: the previous step's
            residuals, added (cast to the gradient's dtype) before the
            quantization.

    Returns:
        (the gradients averaged over pods, one pod's shape; the new error
        feedback, ``(n_pods, ...)`` per leaf).
    """
    # Imported here: repro_torch.train's step imports this module.
    from repro_torch.train.optimizer import leaves, unflatten

    flat = leaves(grads)
    if error_fb is not None:
        flat = [g + e.to(g.dtype) for g, e in zip(flat, leaves(error_fb))]
    outs = [compressed_psum_pod(g, n_pods) for g in flat]
    synced = unflatten(grads, iter([t / n_pods for t, _ in outs]))
    resid = unflatten(grads, iter([r for _, r in outs]))
    return synced, resid
