"""Carry the JAX package's state into the port.

The reference has no weights; its "parameters" are the trace bundle. This
module turns a ``SimInputs``-shaped bundle of numpy arrays (a mapping or an
object with the fields as attributes — a caller converts framework arrays
with ``np.asarray`` first) into the port's :class:`SimInputs`, and stacks
per-run bundles into the port's leading runs axis.

Random streams do not carry across (counter-based threefry on one side,
torch generators on the other), so end-to-end parity runs both engines on
the same bridged traces.
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.simulator import SimInputs
from repro_torch.device import resolve_device

#: Fields that carry the Monte-Carlo randomness; the rest are shared by runs.
STOCHASTIC_FIELDS = ("arrivals", "mu")


def sim_inputs_from_numpy(fields, device=None) -> SimInputs:
    """numpy ``SimInputs`` fields -> the port's ``SimInputs`` on ``device``
    (``None``: CUDA), every field cast to float32 (numpy float64 would
    otherwise survive ``torch.from_numpy``)."""
    dev = resolve_device(device)
    out = {}
    for name in SimInputs._fields:
        x = fields[name] if isinstance(fields, Mapping) else getattr(fields, name)
        if not isinstance(x, np.ndarray):
            raise TypeError(
                f"field {name!r} is {type(x).__name__}, not a numpy array; "
                "convert with np.asarray first"
            )
        out[name] = torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)
    return SimInputs(**out)


def stack_runs(runs: Sequence[SimInputs]) -> SimInputs:
    """Stack single-run bundles on a leading runs axis of arrivals and mu.

    The shared fields must be identical across runs (they are closed over
    by the Monte-Carlo builders); a mismatch raises.
    """
    if not runs:
        raise ValueError("stack_runs needs at least one run")
    first = runs[0]
    for i, run in enumerate(runs[1:], start=1):
        for name in SimInputs._fields:
            if name in STOCHASTIC_FIELDS:
                continue
            if not torch.equal(getattr(run, name), getattr(first, name)):
                raise ValueError(f"run {i} differs from run 0 in shared field {name!r}")
    return first._replace(**{
        name: torch.stack([getattr(run, name) for run in runs])
        for name in STOCHASTIC_FIELDS
    })
