"""ctypes binding of the CUDA ``gmsa_score`` kernel (``csrc/gmsa_score.cu``).

The library is built by ``nvcc`` at first use (:mod:`repro_torch.kernels._build`)
and launched on PyTorch's current stream. q, mu, a and vp are passed with
their element strides, so the simulator's (R, N, K) backlogs are read in
place through a transposed view — no per-slot transpose copy.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch import Tensor

from repro_torch.kernels import _build

#: Shared memory holds the (N,) cost row; the card allows 227 KB a block.
MAX_N = 56 * 1024
_MAX_GRID_Y = 65535


@functools.cache
def _launcher():
    lib = _build.load("gmsa_score")
    fn = lib.gmsa_score_launch
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes = [ptr] * 8 + [i32] * 4 + [i64] * 10 + [ptr]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _runs_per_block(r_runs: int, k: int, sms: int) -> int:
    """Chunk the runs so the grid roughly fills the card once: each block
    re-reads r[k] (from L2 after the first), so more chunks than SMs only
    adds traffic."""
    chunks = max(1, min(r_runs, sms // max(k, 1)))
    rpb = -(-r_runs // chunks)
    return max(rpb, -(-r_runs // _MAX_GRID_Y))


def gmsa_score_cuda(
    q: Tensor, mu: Tensor, a: Tensor, vp: Tensor, r: Tensor, wpue: Tensor
) -> tuple[Tensor, Tensor]:
    """Launch the kernel on fp32 CUDA tensors.

    Shapes: q, mu (*B, K, N); a (*B, K); vp (K,) or (*B, K); r (K, N, N);
    wpue (N,). Returns (scores (*B, K, N) fp32, best (*B, K) int32).
    Increments ``gmsa_score_cuda.launches`` once per kernel launch.
    """
    tensors = (q, mu, a, vp, r, wpue)
    if any(t.device.type != "cuda" or t.dtype != torch.float32 for t in tensors):
        raise TypeError("gmsa_score_cuda takes fp32 CUDA tensors only")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("gmsa_score_cuda operands must share one device")
    batch = q.shape[:-2]
    k, n = q.shape[-2:]
    if (tuple(mu.shape) != tuple(q.shape) or tuple(r.shape) != (k, n, n)
            or tuple(wpue.shape) != (n,)):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, mu {tuple(mu.shape)}, "
            f"r {tuple(r.shape)}, wpue {tuple(wpue.shape)}"
        )
    if n > MAX_N:
        raise ValueError(f"N={n} exceeds the kernel's shared-memory limit {MAX_N}")
    runs = 1
    for d in batch:
        runs *= d
    q3 = q.reshape(runs, k, n)
    mu3 = mu.reshape(runs, k, n)
    a2 = a.broadcast_to(batch + (k,)).reshape(runs, k)
    vp2 = vp.broadcast_to(batch + (k,)).reshape(runs, k)
    r = r.contiguous()
    wpue = wpue.contiguous()
    scores = torch.empty((runs, k, n), device=q.device, dtype=torch.float32)
    best = torch.empty((runs, k), device=q.device, dtype=torch.int32)
    if runs and k and n:
        dev = q.device.index if q.device.index is not None else torch.cuda.current_device()
        rpb = _runs_per_block(runs, k, _sm_count(dev))
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = _launcher()(
                q3.data_ptr(), mu3.data_ptr(), a2.data_ptr(), vp2.data_ptr(),
                r.data_ptr(), wpue.data_ptr(), scores.data_ptr(), best.data_ptr(),
                runs, k, n, rpb,
                *q3.stride(), *mu3.stride(), *a2.stride(), *vp2.stride(),
                stream,
            )
        if rc != 0:
            raise RuntimeError(f"gmsa_score kernel launch failed: CUDA error {rc}")
        gmsa_score_cuda.launches += 1
    return scores.reshape(batch + (k, n)), best.reshape(batch + (k,))


gmsa_score_cuda.launches = 0
