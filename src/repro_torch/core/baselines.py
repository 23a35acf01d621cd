"""Baseline global-manager-selection strategies (paper Sec. V-A).

* **DATA**   — type-k jobs dispatched to DC i in proportion to the share of
  the type-k dataset stored at DC i.
* **RANDOM** — every job picks its manager uniformly at random: an exact
  multinomial split of each slot's integral arrivals.
* **JSQ**    — join-the-shortest-queue (GMSA with V = 0).
* **GREEDY-COST** — all type-k jobs to argmin_i e_i^k (GMSA's V -> inf).

All policies share the simulator signature
``(generator, q, arrivals, mu, e, aux, scalar) -> f`` and accept leading
batch (run, slot) dimensions on their per-run operands.
"""

from __future__ import annotations

import torch
from torch import Tensor

# Static upper bound on per-slot arrivals of one job type; the exact
# multinomial sampler draws this many candidate picks and masks the tail.
MAX_SLOT_ARRIVALS = 512


def _one_hot_nk(best: Tensor, n: int, dtype: torch.dtype) -> Tensor:
    """(..., K) indices -> (..., N, K) one-hot columns."""
    idx = torch.arange(n, device=best.device)
    return (idx[:, None] == best.unsqueeze(-2)).to(dtype)


def data_dispatch(generator, q: Tensor, arrivals: Tensor, mu: Tensor, e: Tensor, aux: Tensor, scalar=0.0) -> Tensor:
    """DATA baseline: f[i, k] = dataset_fraction[k, i]."""
    del generator, q, arrivals, mu, e, scalar
    return aux.mT


data_dispatch.state_independent = True
data_dispatch.consumes_key = False


def random_dispatch(generator, q: Tensor, arrivals: Tensor, mu: Tensor, e: Tensor, aux: Tensor, scalar=0.0) -> Tensor:
    """RANDOM baseline: exact multinomial split of each slot's arrivals.

    Empty slots (A^k = 0) fall back to the uniform vector (the choice is
    irrelevant since f multiplies A).
    """
    del mu, e, aux, scalar
    n = q.shape[-2]
    counts = _multinomial_uniform(generator, arrivals, n)         # (..., K, N)
    a = arrivals.unsqueeze(-1)
    frac = torch.where(a > 0, counts / torch.clamp_min(a, 1.0),
                       torch.full_like(counts, 1.0 / n))
    return frac.mT


def _multinomial_uniform(generator, count: Tensor, n: int) -> Tensor:
    """Exact Multinomial(count, uniform-over-n) for every entry of ``count``.

    Draws ``MAX_SLOT_ARRIVALS`` uniform categorical picks per entry, masks
    picks beyond ``count`` into a scratch category and histograms — all
    entries (every run, slot and type) in one batched draw.
    """
    picks = torch.randint(
        0, n, count.shape + (MAX_SLOT_ARRIVALS,),
        generator=generator, device=count.device,
    )
    idx = torch.arange(MAX_SLOT_ARRIVALS, device=count.device)
    masked = torch.where(idx < count.unsqueeze(-1), picks, n)     # overflow bucket n
    hist = torch.zeros(count.shape + (n + 1,), dtype=torch.float32, device=count.device)
    hist.scatter_add_(-1, masked, torch.ones_like(masked, dtype=torch.float32))
    return hist[..., :n]


random_dispatch.state_independent = True


def jsq_dispatch(generator, q: Tensor, arrivals: Tensor, mu: Tensor, e: Tensor, aux: Tensor, scalar=0.0) -> Tensor:
    """Join-the-shortest-queue (drift-only; GMSA with V = 0)."""
    del generator, arrivals, mu, e, aux, scalar
    return _one_hot_nk(torch.argmin(q, dim=-2), q.shape[-2], q.dtype)


jsq_dispatch.consumes_key = False


def greedy_cost_dispatch(generator, q: Tensor, arrivals: Tensor, mu: Tensor, e: Tensor, aux: Tensor, scalar=0.0) -> Tensor:
    """Greedy instantaneous-cost minimizer (GMSA's V -> inf limit)."""
    del generator, arrivals, mu, aux, scalar
    return _one_hot_nk(torch.argmin(e, dim=-1), q.shape[-2], q.dtype)


greedy_cost_dispatch.state_independent = True
greedy_cost_dispatch.consumes_key = False


def static_placement_rule(d: Tensor, obs) -> Tensor:
    """STATIC-PLACEMENT baseline for the two-timescale controller.

    Never re-places. Survivor-aware: when ``obs.alive`` reports dead sites,
    the layout renormalizes over the survivors; with every site alive the
    input ``d`` is returned untouched, bit for bit. ``d`` is (..., K, N)
    with optional leading run dimensions; ``alive`` is (N,) or carries them.
    """
    alive = getattr(obs, "alive", None)
    if alive is None:
        return d
    alive = torch.as_tensor(alive, dtype=d.dtype, device=d.device)
    masked = d * alive.unsqueeze(-2)
    held = masked.sum(dim=-1, keepdim=True)
    n_alive = torch.clamp_min(alive.sum(dim=-1, keepdim=True), 1.0)
    uniform = (alive / n_alive).unsqueeze(-2).broadcast_to(masked.shape)
    dropped = torch.where(held > 1e-9, masked / torch.clamp_min(held, 1e-9), uniform)
    return torch.where((alive < 0.5).any(dim=-1)[..., None, None], dropped, d)
