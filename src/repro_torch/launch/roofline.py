"""Roofline terms of a dry-run cell on one NVIDIA H100 — the port of
``repro.launch.roofline``.

Hardware constants: NVIDIA's data sheet for the H100 SXM, dense rates (no
sparsity), at the card's 700 W limit. A card set below 700 W runs slower
under load; these are the published peaks, not a measurement.

    compute    = FLOPs            / peak FLOP/s of the compute dtype
    memory     = bytes            / HBM bytes/s
    collective = collective bytes / NVLink bytes/s

A pass's FLOPs are priced at the rate of its params' dtype
(:func:`peak_flops_for`): fp32 at the CUDA cores' rate, where ``torch.matmul``
runs them with TF32 off, bf16 at the tensor cores'. The fp32 weight
products that ``matmul_f32`` gives the ``gemm_f32`` kernel (no gradient
wanted, past its size rule) run as three TF32 products on the tensor cores
and are priced at PEAK_FLOPS_3XTF32 (:func:`pass_peak_flops`).

There is no HLO here, so no HLO parser: the one collective the port runs,
the int8 cross-pod gradient sum (:mod:`repro_torch.distributed.compression`),
is counted from the gradient leaves' shapes by :func:`pod_sync_bytes`.
"""

from __future__ import annotations

import math

import torch

#: Dense fp32 FLOP/s outside the tensor cores (``torch.matmul``: TF32 off).
PEAK_FLOPS_FP32 = 67e12
#: Dense TF32 tensor-core FLOP/s.
PEAK_FLOPS_TF32 = 495e12
#: An fp32-accurate product as three TF32 products (``gemm_f32``).
PEAK_FLOPS_3XTF32 = PEAK_FLOPS_TF32 / 3
#: Dense bf16 / fp16 tensor-core FLOP/s.
PEAK_FLOPS_BF16 = 989e12
#: The port's compute peak: fp32.
PEAK_FLOPS = PEAK_FLOPS_FP32
#: HBM3 bytes/s.
HBM_BW = 3.35e12
#: NVLink bytes/s per GPU (18 links in all).
NVLINK_BW = 900e9
#: The reference's name for the interconnect's rate.
ICI_BW = NVLINK_BW
#: Device memory, bytes.
HBM_BYTES = 80e9

_PEAKS = {torch.float32: PEAK_FLOPS_FP32, torch.bfloat16: PEAK_FLOPS_BF16,
          torch.float16: PEAK_FLOPS_BF16, "tf32": PEAK_FLOPS_TF32}


def peak_flops_for(dtype) -> float:
    """The peak FLOP/s of compute in ``dtype`` (a torch dtype, or "tf32")."""
    try:
        return _PEAKS[dtype]
    except KeyError:
        raise ValueError(f"no H100 peak for {dtype!r}; known: {list(_PEAKS)}") from None


def pass_peak_flops(flops: float, flops_3xtf32: float, dtype) -> float:
    """The rate of a pass whose ``flops`` hold ``flops_3xtf32`` of 3xTF32
    products: those at PEAK_FLOPS_3XTF32, the rest at ``dtype``'s peak, so
    that ``flops`` over it is the sum of the two times."""
    peak = peak_flops_for(dtype)
    if flops_3xtf32 <= 0 or flops <= 0:
        return peak
    return flops / ((flops - flops_3xtf32) / peak + flops_3xtf32 / PEAK_FLOPS_3XTF32)


def pod_sync_bytes(grad_leaves, n_pods: int) -> dict:
    """Result bytes of the int8 cross-pod exchange of one step, by kind, as
    the reference's ``collective_bytes_from_hlo`` sums them from a compiled
    ``compressed_psum_pod`` per leaf. ``grad_leaves``: tensors or shapes.
    Per leaf of n elements, with c = ceil(n / P) and P = ``n_pods``:

    * ``all-to-all``: the received rows, P·c int8, and their P fp32 scales;
    * ``all-gather``: the gathered chunks, P·c int8, and P fp32 scales.

    On one card the pods run in turn and these bytes are device copies, so
    they are in the step's own bytes as well; ``collective_s`` prices them
    at NVLink's rate, as the figure a world of two cards would pay.
    """
    per_kind = 0
    for leaf in grad_leaves:
        shape = leaf.shape if isinstance(leaf, torch.Tensor) else leaf
        c = math.ceil(math.prod(shape) / n_pods)
        per_kind += n_pods * c + 4 * n_pods
    by_kind = {"all-to-all": float(per_kind), "all-gather": float(per_kind)}
    return {"total": float(2 * per_kind), "by_kind": by_kind}


def roofline_terms(
    flops: float, bytes_accessed: float, collective_bytes: float, chips: int,
    peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW, ici_bw: float = ICI_BW,
) -> dict:
    """Three roofline terms in seconds and the dominant one, with the
    reference's keys. The counts are one card's (the dry-run counts the
    program one card runs), so ``chips`` is kept in the signature for the
    record, as the reference keeps it, and not divided again."""
    del chips
    compute_s = flops / peak_flops if flops > 0 else 0.0
    memory_s = bytes_accessed / hbm_bw if bytes_accessed > 0 else 0.0
    collective_s = collective_bytes / ici_bw
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    step_s = max(terms.values())
    return {
        **terms,
        "dominant": dominant,
        "step_time_s": step_s,
        "roofline_fraction": compute_s / step_s if step_s > 0 else None,
    }
