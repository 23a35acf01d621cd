"""Sums whose order for each run does not depend on how many runs a call holds.

The Monte-Carlo entry points run their runs axis in chunks
(:mod:`repro_torch.distributed.mesh`), and a chunked call must give the
unchunked call's bits. PyTorch's CUDA reduction picks its thread layout, and
with it the order in which it adds a row's elements, from the shape of the
whole call: a row of more than 32 elements is split over more threads when
the call has few rows (fewer than 16), and a reduction over an inner
dimension splits by the number of outputs too. The results then change with
the chunk size.

:func:`run_sum` moves the summed dimensions to the end, as one contiguous
row per output, and adds a row of more than 32 elements in two passes: 16
partial sums per row (at least 16 outputs, whatever the number of runs),
then those 16 (a row short enough that one group of at most 32 threads
takes it whole). Each pass's thread layout, and so each row's sum order,
is then the same for any number of runs, on the card and on the CPU.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import Tensor

#: Rows up to this long are summed in one pass: on the card one group of
#: at most 32 threads takes such a row whole, whatever the number of rows.
_ONE_PASS = 32
#: Partial sums per row in the first of two passes.
_PARTIALS = 16


def run_sum(x: Tensor, dims) -> Tensor:
    """``x.sum(dim=dims)`` with each output's sum order fixed by the row
    alone (its length), not by the number of rows in the call."""
    nd = x.ndim
    dims = sorted({d % nd for d in ((dims,) if isinstance(dims, int) else dims)})
    keep = [d for d in range(nd) if d not in dims]
    lead = tuple(x.shape[d] for d in keep)
    m = math.prod(x.shape[d] for d in dims)
    rows = x.permute(keep + dims).reshape(lead + (m,))
    if m > _ONE_PASS:
        pad = (-m) % _PARTIALS
        if pad:
            rows = F.pad(rows, (0, pad))
        rows = rows.unflatten(-1, (_PARTIALS, -1)).sum(dim=-1)
    return rows.sum(dim=-1)
