"""ctypes binding of the CUDA ``ssd_scan`` chain (``csrc/ssd_scan.cu``).

The library is built by ``nvcc`` at first use (:mod:`repro_torch.kernels._build`).
One call of ``ssd_scan_launch`` launches the chain's five kernels in order on
PyTorch's current stream — cumsum, chunk_cb, chunk_state, state_pass,
chunk_scan — and that call is what ``ssd_scan_cuda.launches`` counts as one
launch. The wrapper allocates the chain's workspaces (the per-chunk cumsum,
CBᵀ per chunk and the per-chunk states); they are freed after the call.
Sizes go over as 64-bit integers and every offset inside the kernels is
64-bit: at the ``prefill_32k`` shape (B = 32, S = 32768, H = 80, P = 64) x
has 5.4e9 elements.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch import Tensor

from repro_torch.kernels import _build

#: The kernels' limits: one 8x4-per-thread register tile covers the (P, N)
#: state (P <= 64, N <= 128), and chunk_scan stages the chunk's cumsum and dt
#: in static shared memory (Q <= 1024).
MAX_P, MAX_N, MAX_CHUNK = 64, 128, 1024
#: Every phase's grid is one-dimensional, at most 2^31 - 1 blocks. The
#: launcher checks each; the wrapper names chunk_scan's, B·(S/Q)·ceil(Q/64)·H.
_MAX_BLOCKS = 2**31 - 1
_TILE = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _launcher():
    fn = _build.load("ssd_scan").ssd_scan_launch
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [ptr] * 10 + [i64] * 6 + [ctypes.c_int, ptr]
    fn.restype = ctypes.c_int
    return fn


def _ssd_scan_cuda_phases(
    x: Tensor, dt: Tensor, a: Tensor, b_mat: Tensor, c_mat: Tensor, chunk: int
) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """:func:`ssd_scan_cuda` returning the workspaces too, in the layouts of
    :func:`~repro_torch.kernels.ssd_scan.ref.ssd_scan_phases_ref`: (y,
    h_final, cum (B,H,S) fp64, G (B,S/Q,Q,Q) fp32, valid on and below the
    diagonal, h_in (B,S/Q,H,P,N) fp32). The main path calls it only through
    :func:`ssd_scan_cuda`; called directly, it checks the chain phase by
    phase on the card. Counts one launch."""
    tensors = (x, dt, a, b_mat, c_mat)
    if any(t.device.type != "cuda" for t in tensors):
        raise TypeError("ssd_scan_cuda takes CUDA tensors only")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("ssd_scan_cuda operands must share one device")
    if x.dtype not in _DTYPES or b_mat.dtype != x.dtype or c_mat.dtype != x.dtype:
        raise TypeError(f"x, b_mat, c_mat must share fp32 or bf16, got "
                        f"{x.dtype}, {b_mat.dtype}, {c_mat.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"dt and a must be fp32, got {dt.dtype}, {a.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_scan_cuda operands must be contiguous")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    if (tuple(dt.shape) != (bsz, s, h) or tuple(a.shape) != (h,)
            or tuple(b_mat.shape) != (bsz, s, n) or tuple(c_mat.shape) != (bsz, s, n)):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, dt {tuple(dt.shape)}, a {tuple(a.shape)}, "
            f"b {tuple(b_mat.shape)}, c {tuple(c_mat.shape)}"
        )
    if not 1 <= chunk <= MAX_CHUNK or s % chunk:
        raise ValueError(f"chunk {chunk} must be in [1, {MAX_CHUNK}] and divide S={s}")
    nc = s // chunk
    blocks = bsz * nc * -(-chunk // _TILE) * h
    if p > MAX_P or n > MAX_N or blocks > _MAX_BLOCKS:
        raise ValueError(f"P={p}, N={n}, {blocks} blocks outside the kernels' limits "
                         f"(P <= {MAX_P}, N <= {MAX_N}, blocks <= {_MAX_BLOCKS})")
    dev, f32 = x.device, torch.float32
    y = torch.empty_like(x)
    launch = bool(bsz and s and h and p and n)
    h_final = (torch.empty if launch else torch.zeros)((bsz, h, p, n), device=dev, dtype=f32)
    cum = torch.empty((bsz, h, s), device=dev, dtype=torch.float64)
    g = torch.empty((bsz, nc, chunk, chunk), device=dev, dtype=f32)
    h_in = torch.empty((bsz, nc, h, p, n), device=dev, dtype=f32)
    if launch:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            rc = _launcher()(
                x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(),
                c_mat.data_ptr(), y.data_ptr(), h_final.data_ptr(), cum.data_ptr(),
                g.data_ptr(), h_in.data_ptr(), bsz, s, h, p, n, chunk,
                _DTYPES[x.dtype], stream,
            )
        if rc != 0:
            raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
        ssd_scan_cuda.launches += 1
    return y, h_final, cum, g, h_in


def ssd_scan_cuda(
    x: Tensor, dt: Tensor, a: Tensor, b_mat: Tensor, c_mat: Tensor, chunk: int
) -> tuple[Tensor, Tensor]:
    """Launch the chain on contiguous CUDA tensors, S a multiple of ``chunk``.

    x (B,S,H,P), b_mat and c_mat (B,S,N) share one dtype, fp32 or bf16; dt
    (B,S,H) and a (H,) are fp32. Returns (y (B,S,H,P) in x's dtype, h_final
    (B,H,P,N) fp32). Increments ``ssd_scan_cuda.launches`` once per call:
    one launch is one call of the five-kernel chain.
    """
    y, h_final, _, _, _ = _ssd_scan_cuda_phases(x, dt, a, b_mat, c_mat, chunk)
    return y, h_final


ssd_scan_cuda.launches = 0
