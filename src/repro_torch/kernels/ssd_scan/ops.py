"""Public wrapper of the ``ssd_scan`` kernel (padding + dtype policy).

Same signature as the JAX package's ``repro.kernels.ssd_scan.ops.ssd_scan``,
less ``interpret=``. S is padded to a chunk multiple with dt = 0 steps
(exp(0) = 1, zero update: exact no-ops) and y is sliced back. dt and a are
cast to fp32. CUDA tensors go to the hand-written kernel — which launches
or raises; there is no fallback — and CPU tensors to the plain sequential
version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor

from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref


def ssd_scan(
    x: Tensor,      # (B, S, H, P)
    dt: Tensor,     # (B, S, H)
    a: Tensor,      # (H,)
    b_mat: Tensor,  # (B, S, N)
    c_mat: Tensor,  # (B, S, N)
    *,
    chunk: int = 128,
) -> tuple[Tensor, Tensor]:
    """Chunked SSD forward from a zero state. Returns (y (B,S,H,P) in x's
    dtype, final_state (B,H,P,N) fp32)."""
    devices = {t.device for t in (x, dt, a, b_mat, c_mat)}
    if len(devices) != 1:
        raise ValueError(f"ssd_scan operands span devices {sorted(map(str, devices))}")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"ssd_scan runs on CUDA or the CPU, not {x.device}")
    dt, a = dt.float(), a.float()
    s = x.shape[1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, pad))
    if x.is_cuda:
        y, h_final = ssd_scan_cuda(
            x.contiguous(), dt.contiguous(), a.contiguous(), b_mat.contiguous(),
            c_mat.contiguous(), chunk,
        )
    else:
        y, h_final = ssd_scan_ref(x, dt, a, b_mat, c_mat)
    return y[:, :s], h_final
