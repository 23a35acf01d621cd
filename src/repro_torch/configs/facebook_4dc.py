"""The paper's own evaluation setup (Sec. V-A): four Facebook DCs.

* Sites: Prineville OR, Forest City NC, Luleå SE, Altoona IA.
* One job type; Poisson arrivals at 350K jobs/month (40.5 jobs / 5-min slot).
* omega(t): electricity-price traces; PUE(t): dashboard-like PUE traces.
* r: Iridium task-allocation ratios; 100 Mb/s–2 Gb/s links.
* 24 h horizon at 5-min slots (T = 288); results averaged over 1000 runs.
* P^k = 1 (the paper's "one watt" per-job IT energy).

``make_sim_builder`` returns (template, build_inputs): the deterministic
traces are drawn once from ``trace_seed``; ``build_inputs(generator,
n_runs)`` draws fresh arrivals and service rates for every run.
``site_bandwidths`` returns the (up, down) the template's ratios were built
from — the placement controller rebuilds its ratios with them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.iridium import build_task_allocation
from repro_torch.core.simulator import SimInputs
from repro_torch.device import resolve_device
from repro_torch.traces.arrivals import poisson_pair_from_tables, poisson_table, rate_per_slot
from repro_torch.traces.bandwidth import bandwidth_draw
from repro_torch.traces.datasets import (
    DEFAULT_CAPACITY_SHARES,
    dataset_distribution,
    io_slowdown_from_bandwidth,
)
from repro_torch.traces.price import FACEBOOK_SITES, price_trace
from repro_torch.traces.pue import pue_trace


@dataclasses.dataclass(frozen=True)
class PaperSimConfig:
    """Sec. V-A experimental configuration (defaults = the paper's values)."""

    n_sites: int = 4
    k_types: int = 1
    t_slots: int = 288                 # 24 h of 5-min slots
    slot_minutes: float = 5.0
    monthly_jobs: float = 350_000.0
    a_max: float = 128.0               # finite A_max (P[poisson(40.5)>128]≈0)
    mu_max: float = 128.0
    capacity_shares: tuple = DEFAULT_CAPACITY_SHARES
    manager_share: float = 0.62
    map_share: float = 0.6
    n_runs: int = 1000
    trace_seed: int = 2060             # fixes price/PUE/placement traces
    v: float = 1.0                     # GMSA trade-off parameter

    @property
    def lam(self) -> float:
        return rate_per_slot(self.slot_minutes, self.monthly_jobs)


def make_stochastic(arr_cdf, mu_cdf, t_slots: int):
    """``(generator, n_runs) -> (arrivals (R, T, K), mu (R, T, N, K))``."""

    def stochastic(generator: torch.Generator, n_runs: int):
        return poisson_pair_from_tables(generator, arr_cdf, mu_cdf, t_slots, (n_runs,))

    return stochastic


def _site_traces(cfg: PaperSimConfig, dev: torch.device):
    """The seeded stream's first draws: (generator, omega, pue, up, down)."""
    gen = torch.Generator(device=dev).manual_seed(cfg.trace_seed)
    sites = FACEBOOK_SITES[: cfg.n_sites]
    omega = price_trace(gen, cfg.t_slots, cfg.slot_minutes, sites, device=dev)
    pue = pue_trace(gen, cfg.t_slots, cfg.slot_minutes, sites, device=dev)
    up, down = bandwidth_draw(gen, cfg.n_sites, device=dev)
    return gen, omega, pue, up, down


def site_bandwidths(cfg: PaperSimConfig, device=None):
    """(up, down) (N,) Gb/s: the access links :func:`make_sim_builder`
    draws from the same seeded stream on ``device`` (``None``: CUDA), so
    ``build_task_allocation(template.data_dist, up, down, ...)`` with the
    config's shares is the template's ``r`` bit for bit."""
    _, _, _, up, down = _site_traces(cfg, resolve_device(device))
    return up, down


def make_sim_builder(cfg: PaperSimConfig, device=None) -> tuple[SimInputs, Callable]:
    """Build the paper's simulation inputs on ``device`` (``None``: CUDA).

    Returns:
        (template, build_inputs): ``template`` carries the deterministic
        traces plus one draw of the stochastic ones (a single run);
        ``build_inputs(generator, n_runs)`` returns the template with
        fresh (R, ...) arrivals and service rates.
    """
    dev = resolve_device(device)
    gen, omega, pue, up, down = _site_traces(cfg, dev)
    data_dist = dataset_distribution(gen, cfg.k_types, cfg.n_sites, device=dev)
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

    return template, build_inputs
