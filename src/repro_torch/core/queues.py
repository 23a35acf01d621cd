"""Queueing law of the GDA service engine (paper Eq. 1).

Each global-manager DC keeps one queue of unfinished jobs per job type:

    Q_i^k(t+1) = max[ Q_i^k(t) + f_i^k(t) A^k(t) - mu_i^k(t), 0 ].

Tensors use the shared (N, K) layout of :mod:`repro_torch.core`, with any
number of leading batch (Monte-Carlo run) dimensions.
"""

from __future__ import annotations

import torch
from torch import Tensor


def queue_step(q: Tensor, f: Tensor, arrivals: Tensor, mu: Tensor) -> Tensor:
    """One application of the queueing law (Eq. 1).

    Args:
        q: (..., N, K) current backlogs.
        f: (..., N, K) dispatch fractions for this slot (columns sum to 1).
        arrivals: (..., K) job arrivals A^k(t) in this slot.
        mu: (..., N, K) service rates mu_i^k(t) in this slot.

    Returns:
        (..., N, K) backlogs at the start of slot t+1.
    """
    return torch.clamp_min(q + f * arrivals.unsqueeze(-2) - mu, 0.0)


def total_backlog(q: Tensor) -> Tensor:
    """Aggregate backlog sum_{i,k} Q_i^k — the quantity bounded by Eq. 2."""
    return q.sum(dim=(-2, -1))


def average_backlog(q: Tensor) -> Tensor:
    """Per-(DC, type) mean backlog — the y-axis of the paper's Fig. 5(b)/6(b)."""
    return q.mean(dim=(-2, -1))


def lyapunov(q: Tensor) -> Tensor:
    """Quadratic Lyapunov function L(t) = 1/2 * sum_{i,k} Q_i^k(t)^2."""
    return 0.5 * q.square().sum(dim=(-2, -1))
