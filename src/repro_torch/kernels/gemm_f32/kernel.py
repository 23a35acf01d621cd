"""ctypes binding of the CUDA ``gemm_f32`` kernel (``csrc/gemm_f32.cu``).

The library is built by ``nvcc`` at first use (:mod:`repro_torch.kernels._build`).
One call of ``gemm_f32_launch`` encodes the two operands' TMA maps and
launches one persistent kernel on PyTorch's current stream, at most one
block per SM; that call is what ``gemm_f32_cuda.launches`` counts. Before
the first launch on a device the wrapper calls ``gemm_f32_init`` there (the
kernel's 193 KB of dynamic shared memory). The wrapper allocates y.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch import Tensor

from repro_torch.kernels import _build

#: TMA reads rows at a pitch that is a multiple of 16 bytes from a 16-byte
#: aligned base: K and N multiples of 4 fp32, both bases aligned.
ALIGN = 4
_ENCODE_FAILED = 10000


@functools.cache
def _lib():
    lib = _build.load("gemm_f32")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.gemm_f32_launch.argtypes = [ptr, ptr, ptr, i64, i64, i64, ctypes.c_int, ptr]
    lib.gemm_f32_init.argtypes = []
    for fn in (lib.gemm_f32_launch, lib.gemm_f32_init):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _ready(index: int) -> int:
    """Once per device, before its first launch (and so outside any stream
    capture): the kernel's dynamic shared memory limit. Returns the
    device's SM count."""
    with torch.cuda.device(index):
        rc = _lib().gemm_f32_init()
    if rc != 0:
        raise RuntimeError(f"gemm_f32 init failed on cuda:{index}: CUDA error {rc}")
    return torch.cuda.get_device_properties(index).multi_processor_count


def layout_ok(x: Tensor, w: Tensor) -> bool:
    """Whether the kernel reads ``x`` (M, K) and ``w`` (K, N) as they lie:
    both 2-D and contiguous, K and N multiples of 4, both bases 16-byte
    aligned (the device and dtype are the caller's to check)."""
    return (x.dim() == 2 and w.dim() == 2 and x.shape[1] == w.shape[0]
            and x.is_contiguous() and w.is_contiguous()
            and x.shape[1] % ALIGN == 0 and w.shape[1] % ALIGN == 0
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)


def gemm_f32_cuda(x: Tensor, w: Tensor) -> Tensor:
    """y (M, N) = x (M, K) @ w (K, N) on fp32 CUDA tensors, 3xTF32 on the
    tensor cores. Raises on what the kernel does not take (``layout_ok``).
    Increments ``gemm_f32_cuda.launches`` once per launch; an empty M, N
    or K launches nothing (y empty, or zeros for K = 0)."""
    if x.device.type != "cuda" or w.device != x.device:
        raise TypeError("gemm_f32_cuda takes CUDA tensors on one device only")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"gemm_f32_cuda takes fp32 operands, got {x.dtype}, {w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)} @ w {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("gemm_f32_cuda operands must be contiguous")
    if not layout_ok(x, w):
        raise ValueError(f"gemm_f32_cuda needs K and N multiples of {ALIGN} and 16-byte "
                         f"aligned bases, got x {tuple(x.shape)}, w {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if k == 0:
        return torch.zeros((m, n), device=x.device, dtype=torch.float32)
    y = torch.empty((m, n), device=x.device, dtype=torch.float32)
    if m and n:
        dev = x.device
        sms = _ready(dev.index if dev.index is not None else torch.cuda.current_device())
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            rc = _lib().gemm_f32_launch(x.data_ptr(), w.data_ptr(), y.data_ptr(), m, n, k, sms,
                                        stream)
        if rc == _ENCODE_FAILED:
            raise RuntimeError("gemm_f32: cuTensorMapEncodeTiled refused a TMA tensor map "
                               f"(x {tuple(x.shape)}, w {tuple(w.shape)})")
        if rc != 0:
            raise RuntimeError(f"gemm_f32 kernel launch failed: CUDA error {rc}")
        gemm_f32_cuda.launches += 1
    return y


gemm_f32_cuda.launches = 0
