"""WAN topology + inter-site transfer energy/latency model.

Bulk data movement between sites rides the same core network as the shuffle
traffic the Iridium layer reasons about: site i's uplink feeds the core,
site j's downlink drains it, so the effective i->j rate is the harmonic
combination 1/(1/U_i + 1/D_j). Moving bytes is not free energy-wise either —
routers/transponders burn a roughly linear energy-per-byte, and that energy
is drawn at the two endpoint DCs (at their PUE and price). The staged
engine bills every inter-stage shuffle through this model.

Units follow the simulator's calibration (see :mod:`repro_torch.traces.price`):
``omega`` is $/MWh, per-job IT energy is 1 MWh-equivalent, so
``energy_per_gb`` is expressed in *job-energy equivalents per GB* — the
default 0.01 means shipping 100 GB costs the energy of one analytics job.

Every function takes optional leading batch dimensions (runs, slots) on its
per-event operands, written with negative axes: a (R, T, K, N) trace of
mixes prices every run's every slot in one call.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from repro_torch.core.reduce import run_sum
from repro_torch.device import as_float32

#: WAN transfer energy per GB moved, in per-job IT-energy equivalents.
#: Calibrated so a full 100 GB dataset migration costs ~1 job's energy.
DEFAULT_ENERGY_PER_GB = 0.01


class WanModel(NamedTuple):
    """Static WAN description.

    Attributes:
        up: (N,) uplink bandwidths, Gb/s.
        down: (N,) downlink bandwidths, Gb/s.
        link_bw: (N, N) effective site-to-site bulk rate, Gb/s
            (``inf`` on the diagonal — local "moves" are free).
        energy_per_gb: 0-d WAN energy per GB, job-energy equivalents.
    """

    up: Tensor
    down: Tensor
    link_bw: Tensor
    energy_per_gb: Tensor


def wan_topology(
    up: Tensor, down: Tensor, energy_per_gb: float = DEFAULT_ENERGY_PER_GB
) -> WanModel:
    """Build the (N, N) core-routed link model from per-site access rates
    (on ``up``'s device; a list goes to CUDA, as the device rule says)."""
    up = as_float32(up)
    down = as_float32(down, up.device)
    n = up.shape[0]
    bw = 1.0 / (1.0 / up[:, None] + 1.0 / down[None, :])        # (N, N)
    eye = torch.eye(n, dtype=torch.bool, device=up.device)
    bw = torch.where(eye, torch.inf, bw)
    epg = torch.as_tensor(energy_per_gb, dtype=torch.float32, device=up.device)
    return WanModel(up, down, bw, epg)


def link_price_matrix(
    per_site: Tensor, local_free: bool = True, link_health: Tensor | None = None
) -> Tensor:
    """(..., N, N) endpoint-mean link weights: 0.5 * (w_i + w_j) for i -> j.

    The single definition of "a byte on link i->j draws its energy half
    at each endpoint" — shared by :func:`transfer_cost` and the stage
    scheduler's shuffle pricing, so their $-per-GB semantics cannot drift
    apart. ``per_site`` is whatever per-site weight is being averaged
    (omega*PUE for prices, PUE for energy). ``local_free`` zeroes the
    diagonal (intra-site hand-offs are free).

    ``link_health`` (optional (N, N) factor in [0, 1]) surcharges degraded
    links by the reciprocal of their health and prices severed links
    (health 0) to ``inf``, so a plan that insists on crossing a partition
    bills loudly rather than silently.
    """
    n = per_site.shape[-1]
    price = 0.5 * (per_site[..., :, None] + per_site[..., None, :])
    if local_free:
        eye = torch.eye(n, dtype=torch.bool, device=price.device)
        price = torch.where(eye, 0.0, price)
    if link_health is not None:
        health = torch.as_tensor(link_health, dtype=price.dtype, device=price.device)
        price = torch.where(health > 0.0, price / torch.clamp_min(health, 1e-9), torch.inf)
    return price


def transfer_plan(d_old: Tensor, d_new: Tensor, sizes_gb: Tensor) -> Tensor:
    """(..., K, N, N) GB moved on each link to morph ``d_old`` into ``d_new``.

    Surplus sites (placement fraction shrinks) export, deficit sites import;
    the coupling routes each exporter's bytes to the importers in
    proportion to their deficits — the product coupling of the two
    marginals, exact on total bytes. Zero diagonal.

    Args:
        d_old: (..., K, N) current placement (rows on the simplex).
        d_new: (..., K, N) target placement.
        sizes_gb: (..., K) dataset sizes in GB.
    """
    delta = d_new - d_old                                          # (..., K, N)
    out_gb = torch.clamp_min(-delta, 0.0) * sizes_gb[..., None]    # exports
    in_gb = torch.clamp_min(delta, 0.0) * sizes_gb[..., None]      # imports
    total = in_gb.sum(dim=-1, keepdim=True)                        # (..., K, 1)
    share = in_gb / torch.clamp_min(total, 1e-12)                  # (..., K, N)
    return out_gb[..., :, None] * share[..., None, :]              # (..., K, N, N)


def evacuation_plan(
    d_masked: Tensor,
    d_drop: Tensor,
    sizes_gb: Tensor,
    link_health: Tensor | None = None,
) -> Tensor:
    """(..., K, N, N) emergency re-replication traffic after a site loss.

    The surviving replicas re-share the dataset (``d_drop``, rows on the
    simplex) but each survivor only *holds* ``d_masked`` (rows sum to the
    surviving fraction): the gap ``(d_drop - d_masked) * sizes_gb`` is
    shipped to every growing survivor, sourced from the sites that still
    hold a copy in proportion to their holdings and never from the receiver
    itself. A dataset whose replicas were all lost (``d_masked`` row ~ 0) is
    restored from the target layout's own source mix. With ``link_health``,
    severed links (health 0) are excluded as sources; destinations whose
    every usable source link is severed fall back to the fault-oblivious
    weights (the bytes still flow and bill ``inf`` under
    :func:`transfer_cost` with the same ``link_health``). Zero diagonal.

    Args:
        d_masked: (..., K, N) surviving holdings (dead columns zeroed, NOT
            renormalized).
        d_drop: (..., K, N) survivor layout after renormalization.
        sizes_gb: (..., K) dataset sizes in GB.
        link_health: optional (N, N) link factor.
    """
    n = d_masked.shape[-1]
    need = torch.clamp_min(d_drop - d_masked, 0.0) * sizes_gb[..., None]       # (..., K, N)
    lost_all = d_masked.sum(dim=-1, keepdim=True) <= 1e-9
    src = torch.where(lost_all, d_drop, d_masked)                              # (..., K, N)
    off_diag = 1.0 - torch.eye(n, dtype=src.dtype, device=src.device)
    w = src[..., :, None] * off_diag                                           # (..., K, i, j)
    if link_health is not None:
        usable = (torch.as_tensor(link_health, dtype=src.dtype, device=src.device) > 0.0)
        w_routed = w * usable.to(src.dtype)
        routable = w_routed.sum(dim=-2, keepdim=True) > 1e-12
        w = torch.where(routable, w_routed, w)
    w = w / torch.clamp_min(w.sum(dim=-2, keepdim=True), 1e-12)
    return w * need[..., None, :]


def _matvec(x: Tensor, w: Tensor) -> Tensor:
    """``x @ w`` over the last axis with batch broadcasting:
    (..., K, N) against (..., N) -> (..., K), as elementwise products summed
    by :func:`repro_torch.core.reduce.run_sum`: each row's sum order is then
    the same whatever the number of rows, where a matmul's kernel (and its
    order) may change with it, so runs in chunks stay bitwise the unchunked
    call."""
    return run_sum(x * w[..., None, :], -1)


def plan_cost(
    d_old: Tensor,
    d_new: Tensor,
    sizes_gb: Tensor,
    wan: WanModel,
    omega: Tensor,
    pue: Tensor,
) -> tuple[Tensor, Tensor, Tensor]:
    """Fused ``transfer_cost(transfer_plan(...))`` — no (K, N, N) ever built.

    The product-coupling plan is rank-1 per type (``plan[k] = out_k ⊗
    share_k``) and the endpoint-mean link price is rank-2
    (``P = 0.5 (w 1ᵀ + 1 wᵀ)``), so the whole bill collapses to four (K,)
    contractions:

        cost = epg * 0.5 * Σ_k [ (out_k·w) * Σ_j share_kj
                                 + (Σ_i out_ki) * (share_k·w) ]

    (the plan's diagonal is exactly zero — a site never both exports and
    imports — so including P's diagonal is exact). The staged engine bills
    every stage of every slot of every run in one batched call. Matches the
    materialized ``transfer_cost(transfer_plan(...))`` to
    float-reassociation tolerance.

    Args:
        d_old: (..., K, N) current placement; d_new: (..., K, N) target.
        sizes_gb: (..., K) dataset sizes in GB.
        wan: the :class:`WanModel`.
        omega: (..., N) prices; pue: (..., N) PUE (broadcast against the
            batch dims).

    Returns:
        (cost, energy, gb_moved) — each (...,).
    """
    delta = d_new - d_old                                          # (..., K, N)
    out_gb = torch.clamp_min(-delta, 0.0) * sizes_gb[..., None]    # exports
    in_gb = torch.clamp_min(delta, 0.0) * sizes_gb[..., None]      # imports
    del delta
    total = in_gb.sum(dim=-1, keepdim=True)                        # (..., K, 1)
    share = in_gb / torch.clamp_min(total, 1e-12)                  # (..., K, N)
    del in_gb, total
    o_tot = out_gb.sum(dim=-1)                                     # (..., K)
    s_tot = share.sum(dim=-1)                                      # ~ {0, 1}
    wpue = omega * pue

    def bilinear(w: Tensor) -> Tensor:
        ow = _matvec(out_gb, w)
        sw = _matvec(share, w)
        return 0.5 * ((ow * s_tot).sum(dim=-1) + (o_tot * sw).sum(dim=-1))

    cost = wan.energy_per_gb * bilinear(wpue)
    energy = wan.energy_per_gb * bilinear(pue)
    return cost, energy, (o_tot * s_tot).sum(dim=-1)


def evacuation_cost(
    d_masked: Tensor,
    d_drop: Tensor,
    sizes_gb: Tensor,
    wan: WanModel,
    omega: Tensor,
    pue: Tensor,
) -> tuple[Tensor, Tensor, Tensor]:
    """Fused ``transfer_cost(evacuation_plan(...))`` — no (K, N, N) built.

    The evacuation plan is ``plan[k, i, j] = w[k, i, j] * need[k, j]`` with
    column-normalized no-self source weights; under the endpoint-mean price
    the source half reduces to the per-destination leave-one-out mean source
    price ``(src_k·w - src_kj w_j) / (Σ src_k - src_kj)`` — an O(K N)
    expression. Same (cost, energy, gb) contract as :func:`transfer_cost`;
    leading batch dims on every operand.
    """
    need = torch.clamp_min(d_drop - d_masked, 0.0) * sizes_gb[..., None]       # (..., K, N)
    lost_all = d_masked.sum(dim=-1, keepdim=True) <= 1e-9
    src = torch.where(lost_all, d_drop, d_masked)                              # (..., K, N)
    src_sum = src.sum(dim=-1, keepdim=True)                                    # (..., K, 1)
    # The leave-one-out sums are mathematically >= 0 but are computed by
    # subtraction — clamp before the eps-guarded divide, or a one-hot
    # ``src`` row cancels to a signed ~ulp and the 1e-12 divisor turns it
    # into a huge spurious (possibly negative) bill.
    z_raw = torch.clamp_min(src_sum - src, 0.0)                                # (..., K, N)
    z = torch.clamp_min(z_raw, 1e-12)
    colsum = z_raw / z                                                         # {0..1}
    wpue = omega * pue

    def half_sum(w: Tensor) -> Tensor:
        src_mean = torch.clamp_min(
            _matvec(src, w)[..., None] - src * w[..., None, :], 0.0
        ) / z                                                                  # (..., K, N)
        return 0.5 * (need * (src_mean + w[..., None, :] * colsum)).sum(dim=(-2, -1))

    cost = wan.energy_per_gb * half_sum(wpue)
    energy = wan.energy_per_gb * half_sum(pue)
    return cost, energy, (need * colsum).sum(dim=(-2, -1))


def expected_pull(src: Tensor, per_site: Tensor, assume_simplex: bool = False) -> Tensor:
    """Fused ``src @ link_price_matrix(per_site)`` — no (N, N) built.

    ``pull[..., k, j] = Σ_i src[..., k, i] * 0.5 * (w_i + w_j)`` with the
    diagonal (local hand-off) free — the stage scheduler's expected-WAN-pull
    term (multiply by ``energy_per_gb`` for $-per-GB). Rank-2 price, so the
    matvec collapses to two (K,) contractions:

        pull[k, j] = 0.5 * (src_k·w + w_j * Σ_i src_ki) - src[k, j] * w_j

    ``assume_simplex=True`` skips the row-sum reduction (Σ src = 1 by
    contract — every source mix the scheduler feeds here is a distribution).
    """
    dot = _matvec(src, per_site)                                   # (..., K)
    half_j = (
        per_site[..., None, :]
        if assume_simplex
        else per_site[..., None, :] * src.sum(dim=-1)[..., None]
    )
    return 0.5 * (dot[..., None] + half_j) - src * per_site[..., None, :]


def transfer_cost(
    plan_gb: Tensor,
    wan: WanModel,
    omega: Tensor,
    pue: Tensor,
    link_health: Tensor | None = None,
) -> tuple[Tensor, Tensor, Tensor]:
    """Price the WAN bytes of one re-placement event.

    Energy for a byte on link i->j is drawn half at each endpoint, at that
    endpoint's PUE, and billed at that endpoint's current price. With
    ``link_health``, degraded links bill at ``price / health`` and bytes
    on a severed link bill ``inf`` (zero bytes on a severed link bill
    exactly zero).

    Args:
        plan_gb: (..., K, N, N) bytes moved per link (:func:`transfer_plan`).
        wan: the :class:`WanModel`.
        omega, pue: (..., N) prices and PUE at the event.
        link_health: optional (N, N) per-link health factor.

    Returns:
        (cost, energy, gb_moved) — each (...,).
    """
    wpue = omega * pue
    link_price = link_price_matrix(wpue, local_free=False, link_health=link_health)
    link_energy = link_price_matrix(pue, local_free=False, link_health=link_health)
    gb_links = plan_gb.sum(dim=-3)                                 # (..., N, N)
    if link_health is None:
        cost = wan.energy_per_gb * (gb_links * link_price).sum(dim=(-2, -1))
        energy = wan.energy_per_gb * (gb_links * link_energy).sum(dim=(-2, -1))
    else:
        # 0 GB * inf price must stay 0, not NaN.
        moved = gb_links > 0.0
        cost = wan.energy_per_gb * torch.where(moved, gb_links * link_price, 0.0).sum(dim=(-2, -1))
        energy = wan.energy_per_gb * torch.where(moved, gb_links * link_energy, 0.0).sum(dim=(-2, -1))
    return cost, energy, gb_links.sum(dim=(-2, -1))


def transfer_latency(
    plan_gb: Tensor, wan: WanModel, link_health: Tensor | None = None
) -> Tensor:
    """Bottleneck completion time (seconds) of a re-placement event.

    Links run in parallel; the event finishes when the slowest link drains:
    ``max_ij plan[i, j] * 8 / bw[i, j]`` (GB -> Gb over Gb/s). With
    ``link_health``, a degraded link runs at ``bw * health`` and bytes on a
    severed link never finish (``inf``); links the plan does not use
    contribute nothing regardless of their health.
    """
    gb_links = plan_gb.sum(dim=-3)                                 # (..., N, N)
    if link_health is None:
        return (gb_links * 8.0 / wan.link_bw).amax(dim=(-2, -1))
    bw = wan.link_bw * torch.as_tensor(link_health, dtype=gb_links.dtype, device=gb_links.device)
    # gb > 0 on a severed link divides to inf; unused links pin to 0 so a
    # 0/0 on a severed-but-unused link cannot leak NaN into the max.
    secs = torch.where(gb_links > 0.0, gb_links * 8.0 / bw, 0.0)
    return secs.amax(dim=(-2, -1))


def degraded_surcharge(
    src: Tensor,
    dst: Tensor,
    vol: Tensor,
    wan: WanModel,
    omega: Tensor,
    pue: Tensor,
    link_health: Tensor,
) -> tuple[Tensor, Tensor]:
    """Extra (cost, energy) billed on degraded links, additive to the fused bill.

    The fused :func:`plan_cost` bill prices every byte at the *nominal*
    endpoint-mean link price (its rank-2 structure does not survive an
    arbitrary (N, N) health matrix), so degraded-link pricing enters as a
    **surcharge** on top: materialize the product-coupling plan, and bill
    each link's bytes the difference ``price * (1/health - 1)`` — zero on
    nominal links, ``inf`` on severed links carrying traffic. On an
    all-nominal trace the surcharge is exactly ``0.0`` everywhere, so
    ``fused_bill + surcharge`` stays bitwise the fused bill.

    This materializes (..., K, N, N) plans: at fleet size (R = 100 runs,
    T = 288, 24 stage-type rows, N = 256) that is ~181 GB, so it is for
    small fleets only.

    Args:
        src/dst: (..., K, N) per-shuffle source/destination mixes.
        vol: (..., K) GB per shuffle.
        omega/pue: (..., N) per-slot prices / PUE.
        link_health: (..., N, N) link factor aligned with the batch dims.

    Returns:
        (cost, energy) — each (...,), the degraded-link premium.
    """
    plans = transfer_plan(src, dst, vol)                           # (..., K, N, N)
    gb_links = plans.sum(dim=-3)                                   # (..., N, N)
    del plans
    health = torch.as_tensor(link_health, dtype=gb_links.dtype, device=gb_links.device)
    premium = torch.where(health > 0.0, 1.0 / torch.clamp_min(health, 1e-9) - 1.0, torch.inf)
    wpue = omega * pue

    def bill(w: Tensor) -> Tensor:
        price = 0.5 * (w[..., :, None] + w[..., None, :])          # (..., N, N)
        extra = gb_links * price * premium
        # 0 GB on a severed link must bill 0, not NaN.
        return wan.energy_per_gb * torch.where(gb_links > 0.0, extra, 0.0).sum(dim=(-2, -1))

    return bill(wpue), bill(pue)
