"""Slow-timescale dataset drift & growth traces.

The base paper freezes the dataset distribution for the whole horizon; real
geo-distributed datasets drift — new data is ingested where users generate
it, and total volume grows — which is why placement must be re-decided over
time (Zhang et al., reliable geo-distributed executions). These generators
produce the slow-timescale inputs of
:func:`repro_torch.placement.controller.simulate_placed`:

* :func:`ingest_drift_trace` — per-epoch (E, K, N) ingest distributions: a
  Dirichlet random walk on the simplex, optionally biased toward a target
  mix (e.g. "user growth concentrates at the expensive sites" — the
  adversarial scenario for static placement);
* :func:`dataset_growth_trace` — per-epoch (E, K) dataset sizes under
  compound growth.

Draws come from an explicit ``torch.Generator`` (Dirichlet as normalised
standard-gamma draws); the JAX package draws from threefry keys, so the two
agree by distribution, and exactly in shapes and row sums.
"""

from __future__ import annotations

import torch
from torch import Tensor

from repro_torch.device import resolve_device

_EPS = 1e-6


def _dirichlet(generator: torch.Generator, alpha: Tensor) -> Tensor:
    """Dirichlet(alpha) over the last axis, as normalised gamma draws."""
    g = torch._standard_gamma(alpha, generator=generator)
    return g / g.sum(dim=-1, keepdim=True)


def ingest_drift_trace(
    generator: torch.Generator,
    n_epochs: int,
    k_types: int,
    n_sites: int,
    conc: float = 40.0,
    bias: Tensor | None = None,
    bias_strength: float = 0.0,
    device=None,
) -> Tensor:
    """(E, K, N) ingest distributions: Dirichlet random walk per job type.

    The walk starts from a Dirichlet(6) mix per type; each epoch's mix is
    drawn Dirichlet around the previous one (concentration ``conc`` —
    larger = slower drift), then pulled toward ``bias`` with weight
    ``bias_strength``. Rows sum to 1. Tensors are made on ``device``
    (``None``: CUDA), which must be the generator's.

    Args:
        generator: torch generator on ``device``.
        n_epochs / k_types / n_sites: trace shape.
        conc: Dirichlet concentration of the walk (wander speed).
        bias: optional (N,) attractor distribution.
        bias_strength: per-epoch pull toward the attractor in [0, 1].
    """
    dev = resolve_device(device)
    if bias is None:
        bias = torch.full((n_sites,), 1.0 / n_sites, dtype=torch.float32, device=dev)
    bias = torch.as_tensor(bias, dtype=torch.float32, device=dev)
    c = _dirichlet(generator, torch.full((k_types, n_sites), 6.0, device=dev))
    steps = []
    for _ in range(n_epochs):
        walked = _dirichlet(generator, conc * c + _EPS)
        pulled = (1.0 - bias_strength) * walked + bias_strength * bias[None, :]
        c = pulled / pulled.sum(dim=-1, keepdim=True)
        steps.append(c)
    return torch.stack(steps)


def dataset_growth_trace(
    n_epochs: int,
    k_types: int,
    base_gb: float | Tensor = 100.0,
    growth_per_epoch: float = 0.0,
    device=None,
) -> Tensor:
    """(E, K) dataset sizes: ``base_gb * (1 + g)^e`` compound growth, on
    ``device`` (``None``: CUDA)."""
    dev = resolve_device(device)
    base = torch.as_tensor(base_gb, dtype=torch.float32, device=dev).broadcast_to((k_types,))
    rate = torch.tensor(1.0 + growth_per_epoch, dtype=torch.float32, device=dev)
    factor = rate ** torch.arange(n_epochs, dtype=torch.float32, device=dev)
    return factor[:, None] * base[None, :]
