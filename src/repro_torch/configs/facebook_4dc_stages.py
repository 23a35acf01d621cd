"""Multi-stage Facebook-4DC scenario (the staged-jobs evaluation setup).

The paper's Sec. V-A setup — four Facebook DCs, diurnal prices, PUE
traces, Iridium ratios — extended with the stage structure the base
simulator collapses: a K = 3 mix of shuffle-heavy analytics jobs (2–3
stage chains, ~100 GB input each) whose intermediate data must physically
cross the WAN between consecutive stages' sites.

The canonical mix is hand-calibrated, as the paper pins its own evaluation
constants:

* **ETL/filter-join** (3 stages, compute 0.30/0.45/0.25, shuffle
  60 -> 12 GB): dataset concentrated at ForestCity — the priciest power —
  so "pull the shuffle to the data" and "chase cheap power" conflict.
* **scan-aggregate** (2 stages, 0.30/0.70, shuffle 30 GB): Altoona-heavy.
* **iterative/ML** (3 stages, 0.30/0.40/0.30, shuffle 45 -> 15 GB):
  Prineville-heavy.

Map compute shares are lean (0.30), which keeps the data-local map stage
inside every site's service capacity (effective map rate ``mu / 0.30``).
Other deliberate deviations from the base ``facebook_4dc`` scenario: skewed
per-type dataset layouts (rows concentrate 0.5–0.6 at one site),
``energy_per_gb = 0.03`` (inter-stage shuffle rides the long-haul WAN), and
the service-rate I/O slowdown derived from the scenario's own layout.

``mix_seed`` swaps the canonical mix for a random one drawn from the
:mod:`repro_torch.traces.stages` generators (on a generator seeded with
``mix_seed``, so it differs from the JAX package's draw of the same seed).

``make_staged_builder`` returns ``(template, dag, wan, build_inputs)``: the
contract of :func:`repro_torch.configs.facebook_4dc.make_sim_builder` plus
the staged pieces.
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
from repro_torch.jobs.dag import (
    StageDag,
    chain_dag,
    pad_chains,
    shuffle_volumes_from_selectivity,
    validate_dag,
)
from repro_torch.placement.wan import WanModel, wan_topology
from repro_torch.traces.arrivals import poisson_table, rate_per_slot
from repro_torch.traces.bandwidth import bandwidth_draw
from repro_torch.traces.datasets import (
    DEFAULT_CAPACITY_SHARES,
    dataset_distribution,
    io_slowdown_from_bandwidth,
)
from repro_torch.traces.price import FACEBOOK_SITES, price_trace
from repro_torch.traces.pue import pue_trace
from repro_torch.traces.stages import staged_mix_profile

#: The canonical K = 3 per-type dataset layouts (rows sum to 1): each
#: dataset concentrates where it was ingested — ForestCity, Altoona,
#: Prineville respectively.
CANONICAL_DATA_DIST = (
    (0.15, 0.50, 0.25, 0.10),   # ETL/filter-join — ForestCity-heavy
    (0.10, 0.10, 0.20, 0.60),   # scan-aggregate  — Altoona-heavy
    (0.50, 0.10, 0.25, 0.15),   # iterative/ML    — Prineville-heavy
)

#: Per-stage compute intensities (fractions of P^k; rows sum to 1).
CANONICAL_COMPUTE = (
    (0.30, 0.45, 0.25),
    (0.30, 0.70),
    (0.30, 0.40, 0.30),
)

#: GB entering each stage per job (stage 0 is the data-local map: free).
CANONICAL_SHUFFLE_GB = (
    (0.0, 60.0, 12.0),
    (0.0, 30.0),
    (0.0, 45.0, 15.0),
)


@dataclasses.dataclass(frozen=True)
class StagedPaperConfig:
    """The staged-jobs evaluation configuration (Sec. V-A + stage mix)."""

    n_sites: int = 4
    k_types: int = 3                   # shuffle-heavy analytics mix
    t_slots: int = 288                 # 24 h of 5-min slots
    slot_minutes: float = 5.0
    monthly_jobs: float = 350_000.0    # per type (a 3x larger fleet)
    a_max: float = 128.0
    mu_max: float = 128.0
    capacity_shares: tuple = DEFAULT_CAPACITY_SHARES
    manager_share: float = 0.62
    map_share: float = 0.6
    input_gb: float = 100.0            # per-job input dataset
    energy_per_gb: float = 0.03        # long-haul WAN energy per shuffle GB
    mix_seed: int | None = None        # None = the canonical mix
    s_max: int = 3                     # drawn-mix depth cap
    min_stages: int = 2
    dataset_conc: float = 2.0          # drawn-mix layout skew
    n_runs: int = 200
    trace_seed: int = 2060
    v: float = 10.0                    # GMSA trade-off parameter

    @property
    def lam(self) -> float:
        return rate_per_slot(self.slot_minutes, self.monthly_jobs)


def _scenario_mix(cfg: StagedPaperConfig, device=None) -> tuple[torch.Tensor, StageDag]:
    """(data_dist, dag) on ``device`` (``None``: CUDA) — the canonical
    hand-set mix, or a draw from a generator seeded with ``cfg.mix_seed``."""
    dev = resolve_device(device)
    if cfg.mix_seed is None:
        if cfg.k_types != 3 or cfg.n_sites != 4:
            raise ValueError(
                "the canonical mix is 3 types x 4 sites; pass mix_seed to "
                "draw a random mix for other shapes"
            )
        data_dist = torch.tensor(CANONICAL_DATA_DIST, dtype=torch.float32, device=dev)
        return data_dist, pad_chains(CANONICAL_COMPUTE, CANONICAL_SHUFFLE_GB, device=dev)
    gen = torch.Generator(device=dev).manual_seed(cfg.mix_seed)
    data_dist = dataset_distribution(gen, cfg.k_types, cfg.n_sites, conc=cfg.dataset_conc,
                                     device=dev)
    mask, compute, selectivity = staged_mix_profile(gen, cfg.k_types, cfg.s_max,
                                                    cfg.min_stages, device=dev)
    shuffle = shuffle_volumes_from_selectivity(cfg.input_gb, selectivity)
    return data_dist, chain_dag(compute, shuffle, mask)


def make_staged_builder(
    cfg: StagedPaperConfig, device=None,
) -> tuple[SimInputs, StageDag, WanModel, Callable]:
    """Build the multi-stage scenario's inputs on ``device`` (``None``: CUDA).

    Returns:
        (template, dag, wan, build_inputs): the deterministic trace bundle
        with one draw of the stochastic traces (a single run), the padded
        stage chain, the WAN pricing model, and ``build_inputs(generator,
        n_runs)`` drawing fresh (R, ...) arrivals and service rates.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(cfg.trace_seed)
    sites = FACEBOOK_SITES[: cfg.n_sites]
    omega = price_trace(gen, cfg.t_slots, cfg.slot_minutes, sites, device=dev)
    pue = pue_trace(gen, cfg.t_slots, cfg.slot_minutes, sites, device=dev)
    up, down = bandwidth_draw(gen, cfg.n_sites, device=dev)
    wan = wan_topology(up, down, energy_per_gb=cfg.energy_per_gb)

    data_dist, dag = _scenario_mix(cfg, device=dev)
    validate_dag(dag)

    r = build_task_allocation(
        data_dist, up, down,
        size=1.0, manager_share=cfg.manager_share, map_share=cfg.map_share,
    )
    p_it = torch.ones((cfg.k_types,), dtype=torch.float32, device=dev)
    slowdown = io_slowdown_from_bandwidth(up, down, data_dist)

    arr_cdf = torch.as_tensor(
        poisson_table(np.full((cfg.k_types,), cfg.lam), int(cfg.a_max)), device=dev
    )
    mu_mean = (
        np.asarray(cfg.capacity_shares, np.float64)[:, None]
        * slowdown.cpu().numpy().astype(np.float64)[:, None]
        * cfg.lam
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

    return template, dag, wan, build_inputs
