"""Energy-consumption / energy-cost model of GDA (paper Sec. III & IV-A).

    energy(k, manager=i, t)  =  sum_j PUE_j(t) * r^k_{ij} * P^k
    cost(k, manager=i, t)    =  sum_j omega_j(t) * PUE_j(t) * r^k_{ij} * P^k

with the slot-level system cost

    Cost(t) = sum_k sum_i f_i^k(t) * A^k(t) * cost(k, i, t).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import Tensor


def manager_energy_cost(omega: Tensor, pue: Tensor, r: Tensor, p_it: Tensor) -> Tensor:
    """Per-job energy cost e[k, i] = P^k * sum_j omega_j * PUE_j * r[k, i, j].

    Args:
        omega: (N,) energy-price weights at this slot.
        pue:   (N,) PUE values at this slot.
        r:     (K, N, N) task-allocation ratios.
        p_it:  (K,) fixed IT energy per job.

    Returns:
        (K, N) per-job energy cost for every (type, manager) pair.
    """
    e = torch.einsum("kij,j->ki", r, omega * pue)
    return e * p_it[:, None]


def manager_energy(pue: Tensor, r: Tensor, p_it: Tensor) -> Tensor:
    """Per-job *energy* (not cost): E[k, i] = P^k * sum_j PUE_j * r[k, i, j]."""
    return torch.einsum("kij,j->ki", r, pue) * p_it[:, None]


def slot_cost(f: Tensor, arrivals: Tensor, e: Tensor) -> Tensor:
    """System energy cost of one slot, Cost(t).

    Args:
        f: (..., N, K) dispatch fractions.
        arrivals: (..., K) arrivals this slot.
        e: (K, N) per-job manager energy costs.
    """
    return (f.mT * arrivals.unsqueeze(-1) * e).sum(dim=(-2, -1))


def slot_energy(f: Tensor, arrivals: Tensor, energy_ki: Tensor) -> Tensor:
    """System energy of one slot (same contraction, PUE-weighted only)."""
    return (f.mT * arrivals.unsqueeze(-1) * energy_ki).sum(dim=(-2, -1))


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    """Bundles the static pieces of the cost model.

    Attributes:
        r: (K, N, N) task-allocation ratios (row-stochastic over the last axis).
        p_it: (K,) fixed per-job IT energy.
    """

    r: Tensor
    p_it: Tensor

    def cost_of_managers(self, omega: Tensor, pue: Tensor) -> Tensor:
        """(K, N) per-job cost table for one slot's (omega, pue)."""
        return manager_energy_cost(omega, pue, self.r, self.p_it)

    def slot_cost(self, f: Tensor, arrivals: Tensor, omega: Tensor, pue: Tensor) -> Tensor:
        return slot_cost(f, arrivals, self.cost_of_managers(omega, pue))

    def validate(self) -> None:
        """Eager sanity checks; call at construction time."""
        if self.r.ndim != 3 or self.r.shape[1] != self.r.shape[2]:
            raise ValueError(f"r must be (K, N, N), got {tuple(self.r.shape)}")
        k = self.r.shape[0]
        if tuple(self.p_it.shape) != (k,):
            raise ValueError(f"p_it must be (K,)={k}, got {tuple(self.p_it.shape)}")
        rowsum = self.r.sum(dim=-1)
        if not torch.allclose(rowsum, torch.ones_like(rowsum), atol=1e-5, rtol=1e-5):
            raise ValueError("task-allocation ratios must be row-stochastic")
        if bool((self.r < -1e-7).any()):
            raise ValueError("task-allocation ratios must be non-negative")
