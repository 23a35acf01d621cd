"""Elastic shrink of the GDA control plane when a site is lost.

``drop_site`` removes the dead site (a shape change, host-side);
``drop_site_mask`` zeroes it under an ``alive`` mask so the placement
controller can run it inside its slot loop with N fixed. Both take optional
leading run dimensions on the per-run state (q, data_dist), written with
negative axes; masks are shared or carry the same leading dims.
"""

from __future__ import annotations

import torch
from torch import Tensor


def drop_site(q: Tensor, r: Tensor, data_dist: Tensor, dead: int):
    """Elastic shrink of the GDA control plane when DC/pod ``dead`` is lost.

    Args:
        q: (..., N, K) backlogs; r: (..., K, N, N) ratios; data_dist:
            (..., K, N) dataset distribution.

    Returns (q', r', data_dist', burst) over the surviving N-1 sites:
      * q'          — backlogs with the dead row removed;
      * burst       — the dead site's backlog (..., K), to be re-injected
                      as arrivals (those jobs must be re-dispatched);
      * r'          — ratios with dead row/column removed, renormalized;
      * data_dist'  — dataset distribution renormalized (the dead site's
                      replica share redistributes proportionally).
    """
    n = q.shape[-2]
    keep = torch.tensor([i for i in range(n) if i != dead], device=q.device)
    burst = q[..., dead, :]
    q2 = q[..., keep, :]
    r2 = r[..., keep, :][..., keep]
    r2 = r2 / torch.clamp_min(r2.sum(-1, keepdim=True), 1e-9)
    d2 = data_dist[..., keep]
    d2 = d2 / torch.clamp_min(d2.sum(-1, keepdim=True), 1e-9)
    return q2, r2, d2, burst


def drop_site_mask(q: Tensor, data_dist: Tensor, alive: Tensor, died: Tensor | None = None):
    """Static-shape ``drop_site`` for the controller's loop (N stays N).

    Same semantics as :func:`drop_site`: the dead sites' backlog comes back
    as an arrival burst, and their dataset share re-distributes
    proportionally over the surviving replicas. A dataset whose replicas
    were *all* on dead sites falls back to uniform-over-survivors
    (restore-from-backup; the WAN bill for it is the caller's to charge).

    Args:
        q: (..., N, K) backlogs.
        data_dist: (..., K, N) dataset distribution (rows on the simplex).
        alive: (N,) or (..., N) {0,1} mask of surviving sites.
        died: optional mask of *newly* dead sites (shaped as ``alive``)
            whose backlog forms the burst; defaults to every dead site.

    Returns:
        (q', d_masked, d_drop, burst):
          * q'        — (..., N, K) backlogs, dead rows zeroed;
          * d_masked  — (..., K, N) placement with dead shares zeroed (rows
                        sum to the surviving fraction — what is still held);
          * d_drop    — (..., K, N) renormalized survivor placement (rows
                        back on the simplex — what must be held after
                        recovery);
          * burst     — (..., K) the newly-dead sites' backlog to re-inject.
    """
    alive = torch.as_tensor(alive, dtype=data_dist.dtype, device=data_dist.device)
    if died is None:
        died = 1.0 - alive
    burst = (q * died.unsqueeze(-1)).sum(dim=-2)                  # (..., K)
    # The wipe is a select, never ``q * alive``: the select returns the
    # live rows untouched, so an all-alive mask leaves the backlog
    # recurrence bit for bit that of the no-fault program.
    q2 = torch.where(alive.unsqueeze(-1) > 0.5, q, 0.0)
    d_masked = data_dist * alive.unsqueeze(-2)                     # (..., K, N)
    surviving = d_masked.sum(dim=-1, keepdim=True)                 # (..., K, 1)
    n_alive = torch.clamp_min(alive.sum(dim=-1, keepdim=True), 1.0)
    uniform = (alive / n_alive).unsqueeze(-2).broadcast_to(d_masked.shape)
    d_drop = torch.where(
        surviving > 1e-9, d_masked / torch.clamp_min(surviving, 1e-9), uniform
    )
    return q2, d_masked, d_drop, burst
