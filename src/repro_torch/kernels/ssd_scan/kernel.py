"""ctypes bindings of the CUDA ``ssd_scan`` chains: the forward
(``csrc/ssd_scan.cu``) and its gradient (``csrc/ssd_scan_bwd.cu``).

The library is built by ``nvcc`` at first use (:mod:`repro_torch.kernels._build`).
One call of ``ssd_scan_launch`` launches the chain's five kernels in order on
PyTorch's current stream — cumsum, chunk_cb, chunk_state, state_pass,
chunk_scan — and that call is what ``ssd_scan_cuda.launches`` counts as one
launch. chunk_cb, chunk_state and chunk_scan run their products on the
tensor cores (3xTF32, 2xTF32 where x, B and C are bf16; the routine in
``csrc/ssd_scan_mma.cuh``, shared with the backward chain); before the first
launch on a device the wrapper calls ``ssd_scan_init`` there (chunk_scan's
and cumsum's dynamic shared memory limits). The wrapper allocates the chain's workspaces
(the per-chunk cumsum, CBᵀ per chunk and the per-chunk states); they are
freed after the call.
Sizes go over as 64-bit integers and every offset inside the kernels is
64-bit: at the ``prefill_32k`` shape (B = 32, S = 32768, H = 80, P = 64) x
has 5.4e9 elements.

One call of ``ssd_scan_bwd_launch`` launches the backward chain's five
kernels in order — chunk_dstate (with R's head-group partials),
dstate_pass (with R's sum), chunk_bwd, chunk_dbc, dbc_sum — and counts as
one launch of ``ssd_scan_bwd_cuda``. It
reads the forward's three workspaces, so its caller keeps them from the
forward (:class:`~repro_torch.kernels.ssd_scan.ops.SsdScanFn`). Before the
first launch on a device the wrapper calls ``ssd_scan_bwd_init`` there
(the dynamic shared memory limits of chunk_dstate, chunk_bwd and
chunk_dbc). x, B, C and dy are fp32 or bf16, one dtype, as the forward's
operands are; the chain reads them in that dtype and writes dx, dB and dC
in it, and everything else is fp32 (cum fp64) in both.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch import Tensor

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import DBC_HEAD_GROUP, DSTATE_HEAD_GROUP

#: The kernels' limits: one 64-row tile covers P (P <= 64), chunk_scan keeps
#: its 64 rows of C resident (N <= 128), and chunk_state's and the
#: backward's per-step arrays hold the chunk (Q <= 1024).
MAX_P, MAX_N, MAX_CHUNK = 64, 128, 1024
#: Every phase's grid is one-dimensional, at most 2^31 - 1 blocks. The
#: launcher checks each; the wrapper names the largest, chunk_scan's
#: B·(S/Q)·ceil(Q/64)·H or chunk_state's B·(S/Q)·H·ceil(N/64).
_MAX_BLOCKS = 2**31 - 1
_TILE = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


#: The forward chain's kernels, in launch order (``ssd_scan_<name>_kernel``).
PHASES = ("cumsum", "chunk_cb", "chunk_state", "state_pass", "chunk_scan")


@functools.cache
def _lib():
    lib = _build.load("ssd_scan")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    args = [ptr] * 10 + [i64] * 6 + [ctypes.c_int, ptr]
    lib.ssd_scan_launch.argtypes = args
    lib.ssd_scan_phase_launch.argtypes = [ctypes.c_int] + args
    lib.ssd_scan_init.argtypes = []
    for fn in (lib.ssd_scan_launch, lib.ssd_scan_phase_launch, lib.ssd_scan_init):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _ready(index: int) -> None:
    """Once per device, before its first launch (and so outside any stream
    capture): chunk_scan's dynamic shared memory limit."""
    with torch.cuda.device(index):
        rc = _lib().ssd_scan_init()
    if rc != 0:
        raise RuntimeError(f"ssd_scan init failed on cuda:{index}: CUDA error {rc}")


def _call(fn, lead, ops, out, chunk) -> int:
    """One call of the library's ``fn`` (``lead``: arguments before the
    tensors) on ``ops`` = (x, dt, a, b_mat, c_mat) and ``out`` = (y,
    h_final, cum, g, h_in), on the current stream of their device."""
    x, b_mat = ops[0], ops[3]
    dev = x.device
    _ready(dev.index if dev.index is not None else torch.cuda.current_device())
    bsz, s, h, p = x.shape
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        return fn(*lead, *(t.data_ptr() for t in ops), *(t.data_ptr() for t in out),
                  bsz, s, h, p, b_mat.shape[-1], chunk, _DTYPES[x.dtype], stream)


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
    blocks = bsz * nc * h * max(-(-chunk // _TILE), -(-n // _TILE))
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
        rc = _call(_lib().ssd_scan_launch, (), tensors, (y, h_final, cum, g, h_in), chunk)
        if rc != 0:
            raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
        ssd_scan_cuda.launches += 1
    return y, h_final, cum, g, h_in


def _ssd_scan_cuda_phase(
    phase: str, x: Tensor, dt: Tensor, a: Tensor, b_mat: Tensor, c_mat: Tensor, chunk: int,
    out: tuple[Tensor, ...],
) -> None:
    """Launch the chain's kernel ``phase`` (one of :data:`PHASES`) alone, on
    ``out``: what :func:`_ssd_scan_cuda_phases` returned for the same
    operands. For timing each kernel on workspaces already filled; not a
    launch of the chain (``ssd_scan_cuda.launches`` is unchanged).
    chunk_state overwrites the states workspace with the chunks' own
    contributions and state_pass turns it over again on every call."""
    tensors = (x, dt, a, b_mat, c_mat)
    if any(t.device.type != "cuda" for t in tensors + tuple(out)):
        raise TypeError("ssd_scan_cuda takes CUDA tensors only")
    rc = _call(_lib().ssd_scan_phase_launch, (PHASES.index(phase),), tensors, out, chunk)
    if rc != 0:
        raise RuntimeError(f"ssd_scan {phase} launch failed: CUDA error {rc}")


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


#: The backward chain's kernels, in launch order (``ssd_bwd_<name>_kernel``).
BWD_PHASES = ("chunk_dstate", "dstate_pass", "chunk_bwd", "chunk_dbc", "dbc_sum")


@functools.cache
def _bwd_lib():
    lib = _build.load("ssd_scan_bwd")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    args = [ptr] * 22 + [i64] * 6 + [ctypes.c_int, ptr]
    lib.ssd_scan_bwd_launch.argtypes = args
    lib.ssd_scan_bwd_phase_launch.argtypes = [ctypes.c_int] + args
    lib.ssd_scan_bwd_init.argtypes = []
    for fn in (lib.ssd_scan_bwd_launch, lib.ssd_scan_bwd_phase_launch, lib.ssd_scan_bwd_init):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _bwd_ready(index: int) -> None:
    """Once per device, before its first launch (and so outside any stream
    capture): the chain's dynamic shared memory limits."""
    with torch.cuda.device(index):
        rc = _bwd_lib().ssd_scan_bwd_init()
    if rc != 0:
        raise RuntimeError(f"ssd_scan backward init failed on cuda:{index}: CUDA error {rc}")


def _bwd_operands(x, dt, a, b_mat, c_mat, dy, dh_final, cum, g, h_in, chunk):
    """Checks the backward chain's operands; returns (B, S, H, P, N)."""
    ops = (x, dt, a, b_mat, c_mat, dy, dh_final, h_in, g)
    if any(t.device.type != "cuda" for t in ops + (cum,)):
        raise TypeError("ssd_scan_bwd_cuda takes CUDA tensors only")
    if len({t.device for t in ops + (cum,)}) != 1:
        raise ValueError("ssd_scan_bwd_cuda operands must share one device")
    typed, rest = (x, b_mat, c_mat, dy), (dt, a, dh_final, h_in, g)
    if (x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in typed)
            or any(t.dtype != torch.float32 for t in rest) or cum.dtype != torch.float64):
        raise TypeError(
            "the ssd_scan backward takes x, b_mat, c_mat and dy in one dtype, fp32 or bf16, "
            "dt, a, dh_final and the g, h_in workspaces fp32 and cum fp64, got x, b_mat, "
            f"c_mat, dy {[t.dtype for t in typed]}, dt, a, dh_final, h_in, g "
            f"{[t.dtype for t in rest]}, cum {cum.dtype}")
    if not all(t.is_contiguous() for t in ops + (cum,)):
        raise ValueError("ssd_scan_bwd_cuda operands must be contiguous")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    if not 1 <= chunk <= MAX_CHUNK or s % chunk:
        raise ValueError(f"chunk {chunk} must be in [1, {MAX_CHUNK}] and divide S={s}")
    nc = s // chunk
    want = {"dt": (bsz, s, h), "a": (h,), "b": (bsz, s, n), "c": (bsz, s, n),
            "dy": (bsz, s, h, p), "dh_final": (bsz, h, p, n), "cum": (bsz, h, s),
            "g": (bsz, nc, chunk, chunk), "h_in": (bsz, nc, h, p, n)}
    got = dict(zip(want, (dt, a, b_mat, c_mat, dy, dh_final, cum, g, h_in)))
    bad = {k: tuple(v.shape) for k, v in got.items() if tuple(v.shape) != want[k]}
    if bad:
        raise ValueError(f"shape mismatch against x {tuple(x.shape)}, N={n}: {bad}")
    if p > MAX_P or n > MAX_N or bsz * nc * h > _MAX_BLOCKS:
        raise ValueError(f"P={p}, N={n} outside the kernels' limits (P <= {MAX_P}, "
                         f"N <= {MAX_N}) or too many blocks")
    return bsz, s, h, p, n


def _bwd_call(fn, lead, tensors, out, dims, chunk) -> int:
    """One call of the library's ``fn`` (``lead``: arguments before the
    tensors) on the current stream of the operands' device."""
    dev = tensors[0].device
    _bwd_ready(dev.index if dev.index is not None else torch.cuda.current_device())
    # The C order: dx, ddt, da, dB, dC, gstates, r, da_part, scale_out, scale_in, part,
    # r_part.
    order = (0, 1, 2, 3, 4, 5, 6, 10, 7, 8, 9, 11)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        return fn(*lead, *(t.data_ptr() for t in tensors), *(out[i].data_ptr() for i in order),
                  *dims, chunk, _DTYPES[tensors[0].dtype], stream)


def _ssd_scan_bwd_cuda_phases(
    x: Tensor, dt: Tensor, a: Tensor, b_mat: Tensor, c_mat: Tensor, dy: Tensor,
    dh_final: Tensor, cum: Tensor, g: Tensor, h_in: Tensor, chunk: int,
) -> tuple[Tensor, ...]:
    """:func:`ssd_scan_bwd_cuda` returning the chain's workspaces too, in the
    layouts of :func:`~repro_torch.kernels.ssd_scan.ref.ssd_scan_bwd_phases_ref`:
    (dx, ddt, da, dB, dC, G (B,S/Q,H,P,N), R (B,S/Q,Q,Q), valid on and below
    the diagonal, scale_out and scale_in (B,S,H), chunk_dbc's partials
    (B,S/Q,2,1+ceil(H/DBC_HEAD_GROUP),Q,N), da_part (B,S/Q,H), R's partials
    (B,S/Q,ceil(H/DSTATE_HEAD_GROUP),Q,Q), valid on and below the diagonal).
    dx, dB and dC are in their operands' dtype, the rest fp32. Counts one
    launch."""
    tensors = (x, dt, a, b_mat, c_mat, dy, dh_final, cum, g, h_in)
    bsz, s, h, p, n = _bwd_operands(*tensors, chunk)
    nc, dev, f32 = s // chunk, x.device, torch.float32
    nslots, ngroups = 1 + -(-h // DBC_HEAD_GROUP), -(-h // DSTATE_HEAD_GROUP)
    empty = lambda *shape: torch.empty(shape, device=dev, dtype=f32)
    out = (torch.empty_like(x), torch.empty_like(dt), empty(h), torch.empty_like(b_mat),
           torch.empty_like(c_mat), empty(bsz, nc, h, p, n), empty(bsz, nc, chunk, chunk),
           empty(bsz, s, h), empty(bsz, s, h), empty(bsz, nc, 2, nslots, chunk, n),
           empty(bsz, nc, h), empty(bsz, nc, ngroups, chunk, chunk))
    if bsz and s and h and p and n:
        rc = _bwd_call(_bwd_lib().ssd_scan_bwd_launch, (), tensors, out, (bsz, s, h, p, n), chunk)
        if rc != 0:
            raise RuntimeError(f"ssd_scan backward kernel launch failed: CUDA error {rc}")
        ssd_scan_bwd_cuda.launches += 1
    else:
        for t in out[:5]:
            t.zero_()
    return out


def _ssd_scan_bwd_cuda_phase(
    phase: str, x: Tensor, dt: Tensor, a: Tensor, b_mat: Tensor, c_mat: Tensor, dy: Tensor,
    dh_final: Tensor, cum: Tensor, g: Tensor, h_in: Tensor, chunk: int, out: tuple[Tensor, ...],
) -> None:
    """Launch the chain's kernel ``phase`` (one of :data:`BWD_PHASES`) alone,
    on ``out``: what :func:`_ssd_scan_bwd_cuda_phases` returned for the same
    operands. For timing each kernel on workspaces already filled; not a
    launch of the chain (``ssd_scan_bwd_cuda.launches`` is unchanged).
    dstate_pass turns G over again on every call."""
    tensors = (x, dt, a, b_mat, c_mat, dy, dh_final, cum, g, h_in)
    dims = _bwd_operands(*tensors, chunk)
    rc = _bwd_call(_bwd_lib().ssd_scan_bwd_phase_launch, (BWD_PHASES.index(phase) + 1,),
                   tensors, out, dims, chunk)
    if rc != 0:
        raise RuntimeError(f"ssd_scan backward {phase} launch failed: CUDA error {rc}")


def ssd_scan_bwd_cuda(
    x: Tensor, dt: Tensor, a: Tensor, b_mat: Tensor, c_mat: Tensor, dy: Tensor,
    dh_final: Tensor, cum: Tensor, g: Tensor, h_in: Tensor, chunk: int,
) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Launch the backward chain: the gradient of :func:`ssd_scan_cuda` at
    (x, dt, a, b_mat, c_mat) given dy (B,S,H,P) and dh_final (B,H,P,N),
    from the forward's workspaces (cum, G, h_in of
    :func:`_ssd_scan_cuda_phases`). x, b_mat, c_mat and dy share one dtype,
    fp32 or bf16, and the chain of that dtype runs; dt, a, dh_final, g and
    h_in are fp32, cum fp64; all contiguous, on one CUDA device, S a
    multiple of ``chunk``. Returns (dx, ddt, da, dB, dC): dx, dB, dC in the
    operands' dtype, ddt and da fp32. Increments
    ``ssd_scan_bwd_cuda.launches`` once per call: one launch is one call of
    the five-kernel chain."""
    return _ssd_scan_bwd_cuda_phases(x, dt, a, b_mat, c_mat, dy, dh_final, cum, g, h_in,
                                     chunk)[:5]


ssd_scan_bwd_cuda.launches = 0
