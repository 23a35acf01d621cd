"""ctypes binding of the CUDA ``gmsa_score`` kernels (``csrc/gmsa_score.cu``).

The library is built by ``nvcc`` at first use (:mod:`repro_torch.kernels._build`).
One call of ``gmsa_score_launch`` launches two kernels on PyTorch's current
stream — the card-wide cost matvec, then the per-run score and argmin as a
programmatic dependent launch — and that call is what
``gmsa_score_cuda.launches`` counts as one launch. The wrapper allocates the
cost workspace, (K, N) for a shared r and (runs, K, N) for a per-run r; it
is freed after the call. q, mu, a and vp are passed with their element
strides, so the simulator's (R, N, K) backlogs are read in place through a
transposed view — no per-slot transpose copy.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch import Tensor

from repro_torch.kernels import _build

#: The cost kernel stages wpue in fp64 in shared memory: 8·N bytes of the
#: 227 KB (232,448 bytes) a block may hold.
MAX_N = 232_448 // 8
#: The pick kernel's grid is (runs, ceil(K / 8)).
_MAX_RUNS, _MAX_K = 2**31 - 1, 8 * 65535


@functools.cache
def _launcher():
    fn = _build.load("gmsa_score").gmsa_score_launch
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes = [ptr] * 9 + [i32] * 5 + [i64] * 10 + [ptr]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _fold_runs(x: Tensor, runs: int, k: int, n: int, k_contig: bool) -> Tensor:
    """(*B, K, N) -> (runs, K, N): a view where the batch dims fold into one
    stride, else one copy — laid out K-contiguous when ``k_contig`` (the
    simulator's (R, N, K) buffers seen through .mT), so that q and a copied
    mu share the pick kernel's coalesced layout."""
    if k_contig:
        return x.mT.reshape(runs, n, k).mT
    return x.reshape(runs, k, n)


def _gmsa_score_cuda_phases(
    q: Tensor, mu: Tensor, a: Tensor, vp: Tensor, r: Tensor, wpue: Tensor
) -> tuple[Tensor, Tensor, Tensor]:
    """:func:`gmsa_score_cuda` returning the cost workspace too, in the
    layout of :func:`~repro_torch.kernels.gmsa_score.ref.gmsa_score_phases_ref`:
    (cost (K, N) or, for a per-run r, (runs, K, N) fp32, scores (*B, K, N)
    fp32, best (*B, K) int32). The main
    path calls it only through :func:`gmsa_score_cuda`; called directly, it
    checks the two phases apart on the card. Counts one launch."""
    tensors = (q, mu, a, vp, r, wpue)
    if any(t.device.type != "cuda" or t.dtype != torch.float32 for t in tensors):
        raise TypeError("gmsa_score_cuda takes fp32 CUDA tensors only")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("gmsa_score_cuda operands must share one device")
    batch = q.shape[:-2]
    k, n = q.shape[-2:]
    per_run = r.ndim > 3
    if (tuple(mu.shape) != tuple(q.shape) or tuple(wpue.shape) != (n,)
            or tuple(r.shape) not in ((k, n, n), tuple(batch) + (k, n, n))):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, mu {tuple(mu.shape)}, "
            f"r {tuple(r.shape)}, wpue {tuple(wpue.shape)}"
        )
    runs = 1
    for d in batch:
        runs *= d
    if n > MAX_N or k > _MAX_K or runs > _MAX_RUNS:
        raise ValueError(f"N={n}, K={k}, {runs} runs outside the kernels' limits "
                         f"(N <= {MAX_N}, K <= {_MAX_K}, runs <= {_MAX_RUNS})")
    k_contig = q.stride(-2) == 1
    q3 = _fold_runs(q, runs, k, n, k_contig)
    mu3 = _fold_runs(mu, runs, k, n, k_contig)
    a2 = a.broadcast_to(batch + (k,)).reshape(runs, k)
    vp2 = vp.broadcast_to(batch + (k,)).reshape(runs, k)
    # A per-run r folds into (runs, K, N, N): a view when contiguous, else
    # one copy. Its cost workspace has a run stride of K·N, a shared r's 0.
    r = r.contiguous()
    r_runs = runs if per_run else 1
    wpue = wpue.contiguous()
    dev = q.device
    cost = torch.empty(((runs,) if per_run else ()) + (k, n), device=dev, dtype=torch.float32)
    scores = torch.empty((runs, k, n), device=dev, dtype=torch.float32)
    best = torch.empty((runs, k), device=dev, dtype=torch.int32)
    if runs and k and n:
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            rc = _launcher()(
                q3.data_ptr(), mu3.data_ptr(), a2.data_ptr(), vp2.data_ptr(),
                r.data_ptr(), wpue.data_ptr(), cost.data_ptr(), scores.data_ptr(),
                best.data_ptr(), runs, r_runs, k, n, _sm_count(index),
                *q3.stride(), *mu3.stride(), *a2.stride(), *vp2.stride(),
                stream,
            )
        if rc != 0:
            raise RuntimeError(f"gmsa_score kernel launch failed: CUDA error {rc}")
        gmsa_score_cuda.launches += 1
    return cost, scores.reshape(batch + (k, n)), best.reshape(batch + (k,))


def gmsa_score_cuda(
    q: Tensor, mu: Tensor, a: Tensor, vp: Tensor, r: Tensor, wpue: Tensor
) -> tuple[Tensor, Tensor]:
    """Launch the kernels on fp32 CUDA tensors.

    Shapes: q, mu (*B, K, N); a and vp (K,), (*B, K) or any shape that
    broadcasts to (*B, K), such as a sweep's (V, 1, K) vp; r (K, N, N),
    shared by every run, or (*B, K, N, N), one per run; wpue (N,). Returns
    (scores (*B, K, N) fp32, best (*B, K) int32). The
    batch dims fold into the kernels' runs axis; an operand whose batch dims
    do not fold into one stride (a (V, R) mu expanded over V with stride 0)
    is copied first, into q's layout.
    Increments ``gmsa_score_cuda.launches`` once per call: one launch is
    one call of the two-kernel chain.
    """
    _, scores, best = _gmsa_score_cuda_phases(q, mu, a, vp, r, wpue)
    return scores, best


gmsa_score_cuda.launches = 0
