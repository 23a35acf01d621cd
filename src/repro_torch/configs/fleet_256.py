"""Synthetic fleet-scale scenario: N = 256 heterogeneous sites, K = 8 classes.

The paper's evaluation stops at four DCs; this scenario is the fleet the
``gmsa_score`` kernel serves: 256 sites with seeded price/PUE climates
spanning real spreads (base prices log-uniform ~$9–45/MWh, UTC offsets over
the whole day, PUE 1.04–1.25), a 1–40 Gb/s backbone, skewed Dirichlet
dataset layouts with Iridium ratios, and Poisson arrivals/service at fleet
traffic (``jobs_per_slot`` per class) with capacity spread over the sites.

At full size on the card the state is about 1 GB: (100, 288, 256, 8) fp32
service-rate traces and dispatch traces, plus the draws that make them.
``make_fleet_builder`` returns the ``(template, build_inputs)`` contract of
:func:`repro_torch.configs.facebook_4dc.make_sim_builder`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.facebook_4dc import make_stochastic
from repro_torch.core.iridium import build_task_allocation
from repro_torch.core.simulator import SimInputs
from repro_torch.device import resolve_device
from repro_torch.traces.arrivals import poisson_table
from repro_torch.traces.bandwidth import bandwidth_draw
from repro_torch.traces.datasets import dataset_distribution, io_slowdown_from_bandwidth
from repro_torch.traces.price import SiteSpec, price_trace
from repro_torch.traces.pue import pue_trace


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """The synthetic N = 256 fleet scenario."""

    n_sites: int = 256
    k_types: int = 8
    t_slots: int = 288                 # 24 h of 5-min slots
    slot_minutes: float = 5.0
    jobs_per_slot: float = 80.0        # per class — fleet-scale traffic
    a_max: float = 192.0               # P[poisson(80) > 192] ~ 1e-22
    mu_max: float = 64.0
    headroom: float = 1.4              # fleet capacity / offered load
    bw_lo_gbps: float = 1.0            # fleet backbone access links
    bw_hi_gbps: float = 40.0
    dataset_conc: float = 0.5          # skewed layouts (ingest locality)
    manager_share: float = 0.3
    map_share: float = 0.6
    n_runs: int = 100
    trace_seed: int = 4096
    v: float = 10.0                    # GMSA trade-off parameter


def fleet_sites(cfg: FleetConfig) -> tuple[SiteSpec, ...]:
    """Synthesize the fleet's per-site price/PUE climates (seeded numpy)."""
    rng = np.random.default_rng(cfg.trace_seed)
    base = np.exp(rng.uniform(np.log(9.0), np.log(45.0), cfg.n_sites))
    amp = base * rng.uniform(0.15, 0.30, cfg.n_sites)
    noise = base * rng.uniform(0.02, 0.06, cfg.n_sites)
    off = rng.uniform(-12.0, 12.0, cfg.n_sites)
    pue0 = rng.uniform(1.04, 1.25, cfg.n_sites)
    pue_amp = rng.uniform(0.01, 0.05, cfg.n_sites)
    return tuple(
        SiteSpec(
            name=f"site{i:03d}",
            region="synthetic",
            utc_offset_h=float(off[i]),
            base_price=float(base[i]),
            diurnal_amp=float(amp[i]),
            noise_std=float(noise[i]),
            base_pue=float(pue0[i]),
            pue_amp=float(pue_amp[i]),
        )
        for i in range(cfg.n_sites)
    )


def fleet_capacity_shares(cfg: FleetConfig) -> np.ndarray:
    """(N,) heterogeneous per-site capacity shares summing to ``headroom``."""
    rng = np.random.default_rng(cfg.trace_seed + 1)
    return rng.dirichlet(np.full(cfg.n_sites, 2.0)) * cfg.headroom


def make_fleet_builder(cfg: FleetConfig, device=None) -> tuple[SimInputs, Callable]:
    """Build the fleet scenario's inputs on ``device`` (``None``: CUDA).

    Returns:
        (template, build_inputs): the deterministic trace bundle with one
        draw of the stochastic traces (a single run), and
        ``build_inputs(generator, n_runs)`` for Monte-Carlo replication.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(cfg.trace_seed)
    sites = fleet_sites(cfg)
    omega = price_trace(gen, cfg.t_slots, cfg.slot_minutes, sites, device=dev)
    pue = pue_trace(gen, cfg.t_slots, cfg.slot_minutes, sites, device=dev)
    up, down = bandwidth_draw(gen, cfg.n_sites, lo=cfg.bw_lo_gbps,
                              hi=cfg.bw_hi_gbps, device=dev)
    data_dist = dataset_distribution(gen, cfg.k_types, cfg.n_sites,
                                     conc=cfg.dataset_conc, device=dev)
    r = build_task_allocation(
        data_dist, up, down,
        size=1.0, manager_share=cfg.manager_share, map_share=cfg.map_share,
    )
    p_it = torch.ones((cfg.k_types,), dtype=torch.float32, device=dev)
    slowdown = io_slowdown_from_bandwidth(up, down, data_dist)

    arr_cdf = torch.as_tensor(poisson_table(
        np.full((cfg.k_types,), cfg.jobs_per_slot), int(cfg.a_max)
    ), device=dev)
    mu_mean = (
        fleet_capacity_shares(cfg)[:, None]
        * slowdown.cpu().numpy().astype(np.float64)[:, None]
        * cfg.jobs_per_slot
        * np.ones((1, cfg.k_types))
    )
    mu_cdf = torch.as_tensor(poisson_table(mu_mean, int(cfg.mu_max)), device=dev)
    stochastic = make_stochastic(arr_cdf, mu_cdf, cfg.t_slots)

    arr0, mu0 = stochastic(gen, 1)
    template = SimInputs(
        arrivals=arr0[0], mu=mu0[0], omega=omega, pue=pue,
        r=r, p_it=p_it, data_dist=data_dist,
    )

    def build_inputs(generator: torch.Generator, n_runs: int) -> SimInputs:
        arrivals, mu = stochastic(generator, n_runs)
        return template._replace(arrivals=arrivals, mu=mu)

    return template, build_inputs


def make_score_operands(cfg: FleetConfig, warm_slots: int = 48, device=None):
    """One realistic fleet-scale slot of kernel operands.

    Returns ``(q, mu, a, vp, r, wpue, e)`` in the kernel's (K, N)
    orientation: ``q`` is the backlog GMSA develops over ``warm_slots``
    slots of the template run, ``mu``/``a`` the slot-0 draws, ``wpue`` the
    slot-0 prices, ``r`` the (K, N, N) ratios, ``vp = V * P^k`` and ``e``
    the (K, N) per-job cost row of the precomputed-table path.
    """
    from repro_torch.core.gmsa import gmsa_policy
    from repro_torch.core.simulator import energy_row, simulate

    template, _ = make_fleet_builder(cfg, device=device)
    warm = template._replace(
        arrivals=template.arrivals[:warm_slots],
        mu=template.mu[:warm_slots],
        omega=template.omega[:warm_slots],
        pue=template.pue[:warm_slots],
    )
    outs = simulate(warm, gmsa_policy, None, cfg.v)
    q = outs.q_final.T.contiguous()
    mu = template.mu[0].T.contiguous()
    a = template.arrivals[0]
    vp = cfg.v * template.p_it
    wpue = template.omega[0] * template.pue[0]
    e, _ = energy_row(template.r, wpue, template.pue[0], template.p_it)
    return q, mu, a, vp, template.r, wpue, e


def make_serve_grid(cfg: FleetConfig, k_classes: int, slots: int, device=None):
    """The fleet scenario re-cut as a serving pod grid, on ``device``
    (``None``: CUDA).

    Returns ``(omega, pue, r, up, down, layout, shares)``: the same seeded
    site climates and backbone as the batch scenario, a ``k_classes``-dataset
    layout, Iridium ratios over it, and the Dirichlet capacity shares
    (summing to ``cfg.headroom`` of offered load) as a tuple of floats.

    The draws come from one generator seeded with ``cfg.trace_seed``, in
    :func:`make_fleet_builder`'s order (prices, PUE, backbone, layout), so
    with ``k_classes == cfg.k_types`` and ``slots == cfg.t_slots`` its
    ``omega``, ``pue``, ``r`` and ``layout`` equal the builder template's
    ``omega``, ``pue``, ``r`` and ``data_dist`` bit for bit. Another
    ``slots`` draws another number of price and PUE samples, and so moves
    the backbone and layout draws that follow.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(cfg.trace_seed)
    sites = fleet_sites(cfg)
    omega = price_trace(gen, slots, cfg.slot_minutes, sites, device=dev)
    pue = pue_trace(gen, slots, cfg.slot_minutes, sites, device=dev)
    up, down = bandwidth_draw(gen, cfg.n_sites, lo=cfg.bw_lo_gbps,
                              hi=cfg.bw_hi_gbps, device=dev)
    layout = dataset_distribution(gen, k_classes, cfg.n_sites,
                                  conc=cfg.dataset_conc, device=dev)
    r = build_task_allocation(
        layout, up, down,
        size=1.0, manager_share=cfg.manager_share, map_share=cfg.map_share,
    )
    shares = tuple(float(s) for s in fleet_capacity_shares(cfg))
    return omega, pue, r, up, down, layout, shares
