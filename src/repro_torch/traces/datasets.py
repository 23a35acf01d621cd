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


def service_rate_trace(
    generator: torch.Generator,
    t_slots: int,
    lam: float | Tensor,
    capacity_shares: Tensor | tuple = DEFAULT_CAPACITY_SHARES,
    k_types: int = 1,
    io_slowdown: Tensor | None = None,
    mu_max: float | None = None,
    device=None,
) -> Tensor:
    """(T, N, K) Poisson service rates on ``device`` (``None``: CUDA).

    Args:
        generator: torch generator on ``device``.
        t_slots: number of slots.
        lam: (K,) or scalar arrival rate (jobs/slot) — capacities scale off it.
        capacity_shares: (N,) per-DC capacity as a fraction of total lam.
        k_types: number of job types.
        io_slowdown: optional (N,) multiplier in (0, 1] from the network I/O
            (slower links -> lower effective service rate).
        mu_max: optional truncation enforcing the paper's finite mu_max.
    """
    dev = resolve_device(device)
    shares = torch.as_tensor(capacity_shares, dtype=torch.float32, device=dev)     # (N,)
    rate = torch.as_tensor(lam, dtype=torch.float32, device=dev).broadcast_to((k_types,))
    mean = shares[:, None] * rate[None, :]                                          # (N, K)
    if io_slowdown is not None:
        mean = mean * torch.as_tensor(io_slowdown, dtype=torch.float32, device=dev)[:, None]
    mu = torch.poisson(mean.expand((t_slots,) + tuple(mean.shape)).contiguous(),
                       generator=generator)
    if mu_max is not None:
        mu = torch.clamp_max(mu, mu_max)
    return mu


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
    the full intermediate volume otherwise ((N, K) result). Leading run
    dimensions on ``data_dist`` / ``reads`` carry through.
    """
    if reads is not None:
        local = torch.diagonal(reads, dim1=-2, dim2=-1)                   # (..., K, N)
        remote_gb = job_gb * (1.0 - local)
        transfer_s = remote_gb * 8.0 / torch.clamp_min(down[None, :], 1e-6)
        return (compute_seconds / (compute_seconds + transfer_s)).mT      # (..., N, K)
    locality = data_dist.mean(dim=-2)                                     # (..., N)
    remote_gb = job_gb * (1.0 - locality)
    transfer_s = remote_gb * 8.0 / torch.clamp_min(down, 1e-6)
    return compute_seconds / (compute_seconds + transfer_s)
