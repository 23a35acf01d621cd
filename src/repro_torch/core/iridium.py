"""Bandwidth-aware task placement in the style of Iridium [Pu et al., SIGCOMM'15].

For one job with intermediate data of total size ``S``, a fraction ``d_j``
of it at site j, uplink ``U_j`` and downlink ``D_j``, a reduce placement
``r`` induces transfer times

    T_up(j)   = (1 - r_j) * d_j * S / U_j
    T_down(j) = r_j * (1 - d_j) * S / D_j

and Iridium solves  min_r max_j max(T_up(j), T_down(j))  over the simplex.
For a fixed bottleneck ``z`` the feasible set is a box intersected with the
simplex, so the optimum is found by a fixed 50-step bisection on ``z``,
computed in float32 like the reference and batched over job types.

``build_task_allocation`` assembles the (K, N, N) manager-conditioned ratio
tensor from data-local map work, Iridium-placed reduce work and a
manager-local aggregation share.
"""

from __future__ import annotations

import torch
from torch import Tensor

_BISECT_ITERS = 50
_EPS = 1e-12


def _bounds(z: Tensor, d: Tensor, up: Tensor, down: Tensor, size: Tensor):
    """Per-site feasible box [lo, hi] for reduce fractions at bottleneck z."""
    inf = torch.tensor(float("inf"), dtype=d.dtype, device=d.device)
    hi = torch.where(d < 1.0, z * down / torch.clamp_min((1.0 - d) * size, _EPS), inf)
    lo = torch.where(d > 0.0, 1.0 - z * up / torch.clamp_min(d * size, _EPS),
                     torch.zeros_like(d))
    return torch.clamp_min(lo, 0.0), hi


def _feasible(z: Tensor, d: Tensor, up: Tensor, down: Tensor, size: Tensor) -> Tensor:
    # The float32 slacks (1 +/- 1e-9) round to 1.0 exactly as in the reference.
    one = torch.tensor(1.0, dtype=torch.float32)
    lo, hi = _bounds(z, d, up, down, size)
    return (
        (lo.sum(-1) <= one + 1e-9)
        & (torch.clamp_max(hi, 1.0).sum(-1) >= one - 1e-9)
        & (lo <= hi + 1e-9).all(-1)
    )


def iridium_reduce_placement(
    d: Tensor, up: Tensor, down: Tensor, size: float | Tensor = 1.0
) -> tuple[Tensor, Tensor]:
    """Bottleneck-minimizing reduce placement.

    Args:
        d: (..., N) fractions of intermediate data per site (rows sum to 1);
            leading dimensions (job types) are placed independently.
        up: (N,) uplink bandwidths.
        down: (N,) downlink bandwidths.
        size: total intermediate data size.

    Returns:
        (r, z): (..., N) reduce fractions in the simplex and the (...,)
        achieved bottleneck transfer times.
    """
    d = torch.as_tensor(d, dtype=torch.float32)
    up = torch.as_tensor(up, dtype=torch.float32, device=d.device)
    down = torch.as_tensor(down, dtype=torch.float32, device=d.device)
    size = torch.as_tensor(size, dtype=torch.float32, device=d.device)
    z_hi = (size * (1.0 / up.min() + 1.0 / down.min())).expand(d.shape[:-1]).clone()
    z_lo = torch.zeros_like(z_hi)
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (z_lo + z_hi)
        ok = _feasible(mid.unsqueeze(-1), d, up, down, size)
        z_lo, z_hi = torch.where(ok, z_lo, mid), torch.where(ok, mid, z_hi)
    z = z_hi
    lo, hi = _bounds(z.unsqueeze(-1), d, up, down, size)
    hi = torch.clamp_max(hi, 1.0)
    # Distribute the remaining simplex mass proportionally to box headroom.
    slack = torch.clamp_min(hi - lo, 0.0)
    missing = torch.clamp_min(1.0 - lo.sum(-1, keepdim=True), 0.0)
    slack_sum = slack.sum(-1, keepdim=True)
    share = torch.where(slack_sum > _EPS, slack / torch.clamp_min(slack_sum, _EPS),
                        torch.zeros_like(slack))
    r = lo + missing * share
    r = r / torch.clamp_min(r.sum(-1, keepdim=True), _EPS)
    return r, z


def build_task_allocation(
    data_dist: Tensor,
    up: Tensor,
    down: Tensor,
    size: float | Tensor = 1.0,
    manager_share: float = 0.3,
    map_share: float = 0.6,
) -> Tensor:
    """Assemble the (K, N, N) manager-conditioned task-allocation ratios.

    When DC i manages a type-k job, its compute splits into a manager-local
    share (``manager_share``) at i, data-local map work (``map_share`` of
    the remainder) proportional to the type-k dataset distribution, and
    Iridium-placed reduce work (the rest). A (..., K, N) ``data_dist`` with
    leading run dimensions gives one tensor per run.

    Returns:
        (..., K, N, N) ratio tensor r[..., k, i, j], row-stochastic over j.
    """
    data_dist = torch.as_tensor(data_dist, dtype=torch.float32)
    n = data_dist.shape[-1]
    reduce_r, _ = iridium_reduce_placement(data_dist, up, down, size)
    base = map_share * data_dist + (1.0 - map_share) * reduce_r            # (..., K, N)
    eye = torch.eye(n, dtype=torch.float32, device=data_dist.device)
    return manager_share * eye + (1.0 - manager_share) * base.unsqueeze(-2)


def make_allocation_rebuilder(
    up: Tensor,
    down: Tensor,
    size: float | Tensor = 1.0,
    manager_share: float = 0.3,
    map_share: float = 0.6,
):
    """Bind the static placement parameters into a ``data_dist -> r`` closure."""
    up = torch.as_tensor(up, dtype=torch.float32)
    down = torch.as_tensor(down, dtype=torch.float32)

    def rebuild(data_dist: Tensor) -> Tensor:
        return build_task_allocation(
            data_dist, up, down,
            size=size, manager_share=manager_share, map_share=map_share,
        )

    return rebuild
