"""Public wrapper of the ``gemm_f32`` kernel.

:func:`matmul_f32` is what the model calls at every 2-D weight product
``x @ W`` (``W`` (in, out) as the params hold it). It adapts to what it
observes, with no switch: the kernel takes the product only when both
operands are fp32 CUDA tensors, no gradient is wanted (grad mode off, as
under ``torch.inference_mode``, and neither operand requires grad), the
kernel reads their layout as it is (``kernel.layout_ok``: contiguous, K and
N multiples of 4, aligned bases) and the shape passes :func:`kernel_wins`
(:func:`kernel_route` says all of it but the device and dtype).
Every other call is ``torch.matmul(x, w)``, exactly as before: CPU and
``meta`` tensors, bf16, autograd and small shapes. The fp32 CUDA calls that
go to ``torch.matmul`` are counted in ``matmul_f32.library_calls``; the
kernel's own ``gemm_f32_cuda.launches`` counts the rest. On ``meta``, where
the dry-run stands in for the card, a product the kernel would take is
still ``torch.matmul``, and counted as 3xTF32 work
(:func:`repro_torch.launch.cost.as_3xtf32`) for the roofline's price.
"""

from __future__ import annotations

import torch
from torch import Tensor

from repro_torch.kernels.gemm_f32.kernel import gemm_f32_cuda, layout_ok
from repro_torch.launch.cost import as_3xtf32

#: The size rule, measured on an H100 80GB HBM3 at 700 W against cuBLAS's
#: fp32 SGEMM at K = 1600 and 2560: the kernel's time is one persistent wave
#: of K / 32 stages per 132 of its 128 x 128 output tiles, so it wins once a
#: product fills most of a wave with tiles of real rows (256 x 5120: 1.2-1.3x;
#: 1024 x 1600: 1.6-1.8x; 8192 x 320: 1.3-1.5x) and loses below (512 x 1600:
#: 0.8x; 2048 x 320: 0.7-0.8x; 8192 x 64: 0.5-0.6x; 128 rows: under 0.8x).
#: Decode's rows and the last position's head (M = batch rows) fall under it,
#: as do a prefill's narrow products (N <= 128). At other K it is unmeasured.
MIN_ROWS = 256
MIN_TILES = 80
TILE = 128


def kernel_wins(m: int, n: int, k: int) -> bool:
    """Whether the kernel is the faster route for an (M, K) @ (K, N)
    product on the card."""
    return k >= 1 and m >= MIN_ROWS and -(-m // TILE) * -(-n // TILE) >= MIN_TILES


def kernel_route(x: Tensor, w: Tensor) -> bool:
    """Whether :func:`matmul_f32` gives the fp32 CUDA product ``x`` (..., K)
    @ ``w`` (K, N) to the kernel: no gradient wanted, the shape past the
    size rule, the layout the kernel's."""
    if w.dim() != 2 or x.dim() < 2 or x.shape[-1] != w.shape[0]:
        return False
    k, n = w.shape
    if (torch.is_grad_enabled() or x.requires_grad or w.requires_grad
            or not kernel_wins(x.numel() // k if k else 0, n, k)):
        return False
    return layout_ok(x.reshape(-1, k), w)


def matmul_f32(x: Tensor, w: Tensor) -> Tensor:
    """``x @ w`` for x (..., K) and a weight w (K, N): the kernel where it
    takes the product and wins, else ``torch.matmul`` (see the module's
    docstring)."""
    if not (x.is_cuda and x.dtype == torch.float32 and w.dtype == torch.float32):
        if x.is_meta and x.dtype == w.dtype == torch.float32 and kernel_route(x, w):
            return as_3xtf32(torch.matmul, x, w)
        return torch.matmul(x, w)
    if not kernel_route(x, w):
        matmul_f32.library_calls += 1
        return torch.matmul(x, w)
    k, n = w.shape
    return gemm_f32_cuda(x.reshape(-1, k), w).reshape(*x.shape[:-1], n)


matmul_f32.library_calls = 0
