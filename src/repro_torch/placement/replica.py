"""Replica-selection & placement scoring (slow-timescale counterpart of GMSA).

Where :func:`repro_torch.core.gmsa.gmsa_dispatch` answers "which DC manages
this slot's jobs", this module answers the slow question "which DCs should
*hold* each dataset" — trading the co-location gain of hosting data at
cheap, capacity-rich sites (Kumar et al., data placement & replica
selection) against replication storage/sync cost and per-site storage caps.

Everything is a vectorized closed-form/greedy rule in the style of
``gmsa_dispatch``:

* :func:`hosting_scores` — the per-(type, site) linear objective;
* :func:`target_placement` — softmin over sites (temperature -> 0 recovers
  the LP-vertex one-hot, exactly as GMSA's argmin) projected onto the
  storage-capacity polytope by iterative proportional capping;
* :func:`replica_read_assignment` — the fast replica-*selection* rule: each
  reader site picks its cheapest live replica (an argmin vertex rule);
* :func:`effective_replicas` / :func:`replication_premium` /
  :func:`sync_cost` — the replication premium (the rule's objective term
  and the controller's bill share one definition);
* :func:`expected_read_cost` — spread's benefit under replica selection
  (feeds the sync-aware candidate ladder of :func:`make_adaptive_rule`).

Every function takes optional leading Monte-Carlo run dimensions on its
per-run operands (layouts, service rates), written with negative axes;
prices, sizes and caps are shared. Iteration counts are static.
"""

from __future__ import annotations

import torch
from torch import Tensor

from repro_torch.placement.wan import WanModel, link_price_matrix

_EPS = 1e-12

#: A replica below this placement fraction is considered not materialized at
#: the site (it cannot serve reads, it incurs no sync traffic).
REPLICA_THRESHOLD = 0.01

#: Hosting-score penalty added to dead sites (same units as the scores,
#: $/MWh-equivalents): large enough that the softmin underflows to exactly
#: zero preference there at any realistic temperature.
DEAD_SITE_PENALTY = 1e6


def hosting_scores(
    wpue_bar: Tensor,
    cap_share: Tensor,
    up: Tensor,
    colo_weight: float = 0.0,
    net_weight: float = 0.0,
) -> Tensor:
    """Per-(type, site) cost of hosting one unit of data — lower is better.

        score[k, j] = wpue_bar_j  -  colo_weight * cap_share[k, j]
                      +  net_weight / up_j

    The first term is the epoch-average energy price paid by the data-local
    work that follows the dataset; the second rewards co-locating data with
    service capacity; the third penalizes hosts whose uplink throttles
    shipping the data to remote executors.

    Args:
        wpue_bar: (N,) epoch-average omega * PUE per site.
        cap_share: (..., K, N) per-type service-capacity shares (rows sum to 1).
        up: (N,) uplink bandwidths, Gb/s.

    Returns:
        (..., K, N) scores.
    """
    return (
        wpue_bar[None, :]
        - colo_weight * cap_share
        + net_weight / torch.clamp_min(up[None, :], _EPS)
    )


def capacity_project(
    target: Tensor,
    sizes_gb: Tensor,
    capacity_gb: Tensor,
    iters: int = 32,
) -> Tensor:
    """Project row-simplex placements onto per-site storage caps.

    Repeats ``iters`` times: scale down every site that exceeds its cap,
    then redistribute each row's lost mass to sites with headroom,
    proportionally to ``headroom * original preference``. With feasible
    totals (sum of dataset sizes <= sum of caps) this converges to a
    row-stochastic placement with site loads within a fraction of a percent
    of the caps; callers must provision feasible capacity.

    Args:
        target: (..., K, N) unconstrained placement preference (rows sum to 1).
        sizes_gb: (K,) dataset sizes.
        capacity_gb: (N,) per-site storage caps (``inf`` = uncapped).

    Returns:
        (..., K, N) row-stochastic placement respecting the caps.
    """
    finite_cap = torch.isfinite(capacity_gb)
    big = torch.tensor(1e9, dtype=torch.float32, device=target.device)
    p = target
    for _ in range(iters):
        load = (p * sizes_gb[:, None]).sum(dim=-2)                       # (..., N)
        scale = torch.where(
            finite_cap, torch.clamp_max(capacity_gb / torch.clamp_min(load, _EPS), 1.0), 1.0
        )
        p = p * scale.unsqueeze(-2)
        headroom = torch.where(
            finite_cap,
            torch.clamp_min(capacity_gb - (p * sizes_gb[:, None]).sum(dim=-2), 0.0),
            big,
        )
        w = target * headroom.unsqueeze(-2) + _EPS
        deficit = torch.clamp_min(1.0 - p.sum(dim=-1), 0.0)               # (..., K)
        p = p + deficit[..., None] * w / w.sum(dim=-1, keepdim=True)
    return p / torch.clamp_min(p.sum(dim=-1, keepdim=True), _EPS)


def target_placement(
    scores: Tensor,
    sizes_gb: Tensor,
    capacity_gb: Tensor,
    temp: float = 2.0,
    project_iters: int = 32,
) -> Tensor:
    """Greedy placement target: softmin over sites, capacity-projected.

    ``temp`` is in the same units as the scores ($/MWh-equivalents); as
    ``temp -> 0`` the softmin collapses to the one-hot LP vertex (all of
    dataset k at its single cheapest feasible site), mirroring
    ``gmsa_dispatch``'s argmin. Finite temperature keeps secondary replicas
    alive, which is what replica *selection* then exploits.
    """
    pref = torch.softmax(-scores / max(temp, 1e-6), dim=-1)            # (..., K, N)
    return capacity_project(pref, sizes_gb, capacity_gb, project_iters)


def replica_read_assignment(
    data_dist: Tensor, wan: WanModel, wpue: Tensor, latency_weight: float = 0.0
) -> Tensor:
    """Each reader site's cheapest live replica — an argmin vertex rule.

    read_cost[k, j, i] = energy_per_gb * (wpue_i + wpue_j)/2
                         + latency_weight * 8 / link_bw[i, j]      (i -> j)

    with sites holding less than :data:`REPLICA_THRESHOLD` of dataset k
    masked out. Local reads are free, so a reader holding a replica always
    serves itself.

    Returns:
        (..., K, N, N) selection s[..., k, j, i] one-hot over hosts i for
        each reader j.
    """
    n = wpue.shape[0]
    price = link_price_matrix(wpue) * wan.energy_per_gb                 # (N, N) i,j
    lat = latency_weight * 8.0 / wan.link_bw                            # (N, N)
    cost = price + lat
    eye = torch.eye(n, dtype=torch.bool, device=cost.device)
    cost = torch.where(eye, 0.0, cost)                                  # local free
    live = data_dist >= REPLICA_THRESHOLD                               # (..., K, N)
    cost_kji = torch.where(live.unsqueeze(-2), cost.T, torch.inf)       # (..., K, j, i)
    best = torch.argmin(cost_kji, dim=-1)                               # (..., K, N)
    return torch.nn.functional.one_hot(best, n).to(data_dist.dtype)     # (..., K, N, N)


def effective_replicas(data_dist: Tensor) -> Tensor:
    """(..., K) inverse-Simpson replica count 1 / sum_j d_kj^2: 1.0 when a
    dataset is fully concentrated at one site, N when spread uniformly."""
    return 1.0 / torch.clamp_min(data_dist.square().sum(dim=-1), _EPS)


def sync_cost(
    data_dist: Tensor,
    sizes_gb: Tensor,
    wan: WanModel,
    wpue: Tensor,
    update_fraction: float = 0.01,
) -> Tensor:
    """Per-epoch replication sync bill ($; one per run).

    Every replica beyond the first must absorb ``update_fraction`` of its
    dataset in updates per epoch, shipped over the WAN at the mean link
    price. Shards below :data:`REPLICA_THRESHOLD` are not materialized: they
    hold no copy and sync nothing. The billed quantity is exactly
    :func:`replication_premium` — the term the sync-aware hosting rule
    optimizes — priced in GB.
    """
    gb = (replication_premium(data_dist, update_fraction) * sizes_gb).sum(dim=-1)
    return gb * wan.energy_per_gb * wpue.mean()


def replication_premium(target: Tensor, update_fraction: float) -> Tensor:
    """(..., K) per-unit-data sync overhead of a candidate placement.

    ``update_fraction * (effective_replicas - 1)`` over the *materialized*
    shards (the :data:`REPLICA_THRESHOLD` rule). :func:`sync_cost` prices
    exactly this quantity, so the rule's objective and the controller's
    bill agree on what counts as a replica by construction.
    """
    live = torch.where(target >= REPLICA_THRESHOLD, target, 0.0)
    total = live.sum(dim=-1, keepdim=True)
    live = torch.where(total > _EPS, live / torch.clamp_min(total, _EPS), target)
    return update_fraction * torch.clamp_min(effective_replicas(live) - 1.0, 0.0)


def expected_read_cost(target: Tensor, wpue: Tensor, reader_share: Tensor) -> Tensor:
    """(..., K) per-unit-data cost of serving reads from a candidate placement.

    Each reader site pulls from its cheapest *materialized* replica — the
    selection rule of :func:`replica_read_assignment` (local reads free,
    remote reads at the endpoint-mean price) — weighted by ``reader_share``
    (where the reading work actually runs).

    Args:
        target: (..., K, N) candidate placement (rows on the simplex).
        wpue: (N,) current omega * PUE.
        reader_share: (..., K, N) per-type read weights (rows sum to 1).
    """
    price = link_price_matrix(wpue)                               # (i, j)
    live = target >= REPLICA_THRESHOLD                            # (..., K, N)
    cost_kji = torch.where(live.unsqueeze(-2), price.T, torch.inf)
    best = cost_kji.amin(dim=-1)                                  # (..., K, j)
    # A candidate with no materialized replica cannot serve reads at all;
    # make it maximally unattractive (finite, so argmin stays valid).
    best = torch.where(torch.isfinite(best), best, wpue.max())
    return (reader_share * best).sum(dim=-1)


def make_adaptive_rule(
    up: Tensor,
    temp: float = 2.0,
    colo_weight: float = 0.0,
    net_weight: float = 0.0,
    project_iters: int = 32,
    sync_weight: float = 0.0,
    update_fraction: float = 0.01,
    read_fraction: float = 0.05,
):
    """Bind scoring weights into the controller's slow-timescale rule.

    Returns ``rule(d, obs) -> d_target`` for
    :func:`repro_torch.placement.controller.simulate_placed`; ``obs`` is a
    :class:`repro_torch.placement.controller.SlowObs` whose ``mu_bar`` and
    ``q`` may carry leading run dimensions (each run then gets its own
    target).

    With ``sync_weight > 0`` the rule itself trades replication's benefit
    against its overhead: it evaluates a ladder of spread candidates —
    softmins from 4x warmer than ``temp`` down to the one-hot LP vertex —
    under the replica-*selection* cost surrogate

        min over materialized i of score[k, i]       (primary serving)
        + read_fraction * expected_read_cost(c)      (spread's benefit)
        + sync_weight * wpue_mean
          * replication_premium(c, update_fraction)  (spread's cost)

    and keeps the per-type argmin before capacity projection.
    ``sync_weight = 0`` is exactly the single-candidate rule.
    """
    up = torch.as_tensor(up, dtype=torch.float32)

    def rule(d: Tensor, obs) -> Tensor:
        del d  # memoryless target; the controller applies the move budget
        mu_bar = obs.mu_bar                                              # (..., N, K)
        cap_share = (mu_bar / torch.clamp_min(mu_bar.sum(dim=-2, keepdim=True), _EPS)).mT
        scores = hosting_scores(
            obs.wpue_bar, cap_share, up.to(cap_share.device),
            colo_weight=colo_weight, net_weight=net_weight,
        )                                                                # (..., K, N)
        capacity_gb = obs.capacity_gb
        alive = getattr(obs, "alive", None)
        if alive is not None:
            # Survivor-aware: dead sites can neither host (score penalty
            # underflows the softmin to 0 there) nor store (zero cap for
            # the projection). With every site alive both terms are exact
            # no-ops, keeping the no-fault path bitwise.
            alive = torch.as_tensor(alive, dtype=torch.float32, device=scores.device)
            scores = scores + DEAD_SITE_PENALTY * (1.0 - alive)[None, :]
            capacity_gb = torch.where(alive < 0.5, 0.0, capacity_gb)
        if sync_weight == 0.0:
            return target_placement(
                scores, obs.sizes_gb, capacity_gb,
                temp=temp, project_iters=project_iters,
            )
        # Sync-aware candidate ladder: warmer softmins spread replicas
        # (cheap reads, costly sync), colder ones consolidate. Chosen per
        # type under the selection surrogate.
        cands = torch.stack([
            torch.softmax(-scores / max(t, 1e-6), dim=-1)
            for t in (4.0 * temp, temp, 0.25 * temp, 1e-6)
        ])                                                               # (C, ..., K, N)
        live = cands >= REPLICA_THRESHOLD
        big = scores.abs().amax(dim=(-2, -1), keepdim=True) + 1.0        # (..., 1, 1)
        primary = torch.where(live, scores, big).amin(dim=-1)            # (C, ..., K)
        premium = torch.stack([replication_premium(c, update_fraction) for c in cands])
        read = torch.stack([expected_read_cost(c, obs.wpue_bar, cap_share) for c in cands])
        wpue_mean = obs.wpue_bar.mean()
        total = primary + read_fraction * read + sync_weight * wpue_mean * premium
        best = torch.argmin(total, dim=0)                                # (..., K)
        idx = best[None, ..., None].expand((1,) + tuple(cands.shape[1:]))
        pref = torch.gather(cands, 0, idx)[0]                            # (..., K, N)
        return capacity_project(pref, obs.sizes_gb, capacity_gb, project_iters)

    return rule
