"""Dataset distributions and the network-I/O service-rate slowdown
(paper Sec. IV-A & V-A).

Each job type's input is "dynamically distributed in four data centers
randomly" — a Dirichlet dataset distribution per type. Service rates are
Poisson around a per-DC capacity, slowed by the time a DC needs to pull
the non-local intermediate data through its downlink.
"""

from __future__ import annotations

import torch
from torch import Tensor

from repro_torch.device import resolve_device

#: Default per-DC capacity shares of the total arrival rate (cheap-power
#: sites Luleå and Altoona are the big ones).
DEFAULT_CAPACITY_SHARES = (0.30, 0.20, 0.90, 0.60)

#: Paper: fixed 100 GB input dataset per job.
JOB_INPUT_GB = 100.0

#: Intermediate (shuffle) data per job moved across the core network.
JOB_INTERMEDIATE_GB = 5.0


def dataset_distribution(
    generator: torch.Generator, k_types: int, n_sites: int, conc: float = 6.0,
    device=None,
) -> Tensor:
    """(K, N) Dirichlet(conc) dataset distribution per job type (rows sum to 1),
    as normalised standard-gamma draws."""
    dev = resolve_device(device)
    alpha = torch.full((k_types, n_sites), conc, dtype=torch.float32, device=dev)
    g = torch._standard_gamma(alpha, generator=generator)
    return g / g.sum(dim=-1, keepdim=True)


def io_slowdown_from_bandwidth(
    up: Tensor, down: Tensor, data_dist: Tensor, compute_seconds: float = 300.0,
    job_gb: float = JOB_INTERMEDIATE_GB, reads: Tensor | None = None,
) -> Tensor:
    """Effective-rate multiplier from network I/O — (N,) or (N, K).

    A DC managing a job pulls the non-local share of the intermediate data
    through its downlink; the slowdown is compute / (compute + transfer).

    With ``reads=None``, ``data_dist`` is averaged over types for a per-DC
    locality estimate ((N,) result). A (K, N, N) per-reader replica
    selection ``reads`` resolves the pull per (site, type) instead: reader
    j's type-k jobs transfer nothing when its chosen replica is itself and
    the full intermediate volume otherwise ((N, K) result).
    """
    if reads is not None:
        local = torch.diagonal(reads, dim1=1, dim2=2)                     # (K, N)
        remote_gb = job_gb * (1.0 - local)
        transfer_s = remote_gb * 8.0 / torch.clamp_min(down[None, :], 1e-6)
        return (compute_seconds / (compute_seconds + transfer_s)).T       # (N, K)
    locality = data_dist.mean(dim=0)                                      # (N,)
    remote_gb = job_gb * (1.0 - locality)
    transfer_s = remote_gb * 8.0 / torch.clamp_min(down, 1e-6)
    return compute_seconds / (compute_seconds + transfer_s)
