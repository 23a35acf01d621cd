"""The port's trace pipeline against the JAX package's.

Deterministic pieces (CDF tables, site climates, the draw-to-count step fed
JAX's own uniforms, the I/O slowdown) must agree exactly or to fp32
rounding. The random draws come from different generators (threefry on one
side, torch's on the other), so they are held to the same distributions.
"""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import facebook_4dc as jfb
from repro.configs import fleet_256 as jfl
from repro.traces import arrivals as ja
from repro.traces import bandwidth as jbw
from repro.traces import datasets as jd
from repro.traces import price as jp
from repro.traces import pue as jpue
from repro_torch.configs import facebook_4dc as tfb
from repro_torch.configs import fleet_256 as tfl
from repro_torch.traces import arrivals as ta
from repro_torch.traces import bandwidth as tbw
from repro_torch.traces import datasets as td
from repro_torch.traces import price as tp
from repro_torch.traces import pue as tpue

CPU = "cpu"


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_constants_and_sites_are_identical():
    assert ta.rate_per_slot(5.0) == ja.rate_per_slot(5.0)
    assert ta.FACEBOOK_MONTHLY_JOBS == ja.FACEBOOK_MONTHLY_JOBS
    assert td.DEFAULT_CAPACITY_SHARES == jd.DEFAULT_CAPACITY_SHARES
    assert (td.JOB_INPUT_GB, td.JOB_INTERMEDIATE_GB) == (jd.JOB_INPUT_GB, jd.JOB_INTERMEDIATE_GB)
    assert (tbw.BW_MIN_GBPS, tbw.BW_MAX_GBPS) == (jbw.BW_MIN_GBPS, jbw.BW_MAX_GBPS)
    as_tuple = lambda sites: [dataclasses.astuple(s) for s in sites]
    assert as_tuple(tp.FACEBOOK_SITES) == as_tuple(jp.FACEBOOK_SITES)
    assert dataclasses.asdict(tfb.PaperSimConfig()) == dataclasses.asdict(jfb.PaperSimConfig())
    assert dataclasses.asdict(tfl.FleetConfig()) == dataclasses.asdict(jfl.FleetConfig())


def test_fleet_sites_are_identical():
    cfg_t, cfg_j = tfl.FleetConfig(), jfl.FleetConfig()
    assert [dataclasses.astuple(s) for s in tfl.fleet_sites(cfg_t)] == [
        dataclasses.astuple(s) for s in jfl.fleet_sites(cfg_j)
    ]
    rng = np.random.default_rng(cfg_j.trace_seed + 1)
    want = rng.dirichlet(np.full(cfg_j.n_sites, 2.0)) * cfg_j.headroom
    assert np.array_equal(tfl.fleet_capacity_shares(cfg_t), want)


@pytest.mark.parametrize("lam,m", [(40.5, 128), (80.0, 192), ([[0.3, 12.0], [64.0, 5.5]], 64)])
def test_poisson_table_is_identical(lam, m):
    t = ta.poisson_table(lam, m)
    j = ja.poisson_table(lam, m)
    assert t.dtype == j.dtype == np.float32
    assert np.array_equal(t, j)


@pytest.mark.parametrize("a_max,mu_max", [(192, 64), (128, 128), (20, 48)])
def test_counts_from_jax_uniforms_are_identical(a_max, mu_max):
    """Feed the port's draw-to-count step the uniforms JAX's
    poisson_pair_from_tables draws (same keys, same shapes): identical
    counts, including tables of different widths (padded with 1.0)."""
    rng = np.random.default_rng(a_max)
    n, k, t_slots = 5, 3, 40
    arr_cdf = ja.poisson_table(rng.uniform(5, 80, k), a_max)
    mu_cdf = ja.poisson_table(rng.uniform(1, 40, (n, k)), mu_max)
    keys = jax.random.split(jax.random.key(a_max + mu_max), 3)
    u_arr, u_mu, want_a, want_mu = [], [], [], []
    for key in keys:
        ka, km = jax.random.split(key)
        a_j, mu_j = ja.poisson_pair_from_tables(ka, km, arr_cdf, mu_cdf, t_slots)
        want_a.append(np.asarray(a_j))
        want_mu.append(np.asarray(mu_j))
        u_arr.append(np.asarray(jax.random.uniform(ka, (t_slots, k))))
        u_mu.append(np.asarray(jax.random.uniform(km, (t_slots, n, k))))
    a_t, mu_t = ta.poisson_counts_from_uniforms(
        torch.from_numpy(np.stack(u_arr)), torch.from_numpy(np.stack(u_mu)),
        torch.from_numpy(arr_cdf), torch.from_numpy(mu_cdf),
    )
    assert a_t.dtype == mu_t.dtype == torch.float32
    assert np.array_equal(a_t.numpy(), np.stack(want_a))
    assert np.array_equal(mu_t.numpy(), np.stack(want_mu))


def test_io_slowdown_matches_jax_both_branches():
    rng = np.random.default_rng(3)
    n, k = 6, 3
    up = rng.uniform(0.1, 2.0, n).astype(np.float32)
    down = rng.uniform(0.1, 2.0, n).astype(np.float32)
    dd = rng.dirichlet(np.ones(n), k).astype(np.float32)
    reads = np.zeros((k, n, n), np.float32)
    reads[:, np.arange(n), rng.integers(0, n, n)] = 1.0
    t = lambda x: torch.from_numpy(x)
    for kw_j, kw_t in [({}, {}), ({"reads": reads}, {"reads": t(reads)})]:
        got = td.io_slowdown_from_bandwidth(t(up), t(down), t(dd), **kw_t)
        want = jd.io_slowdown_from_bandwidth(up, down, dd, **kw_j)
        assert tuple(got.shape) == np.asarray(want).shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_dataset_distribution_and_bandwidth_by_distribution():
    """Dirichlet(conc) rows: mean 1/N, variance (1/N)(1-1/N)/(N conc + 1);
    bandwidths uniform on [lo, hi]. 20000 draws: the standard error of a
    mean is < 1% of its value, so 5% bounds are > 5 standard errors."""
    rows, n, conc = 20000, 4, 6.0
    mean, var = 1 / n, (1 / n) * (1 - 1 / n) / (n * conc + 1)
    d_t = td.dataset_distribution(_gen(0), rows, n, conc, device=CPU).numpy()
    d_j = np.asarray(jd.dataset_distribution(jax.random.key(0), rows, n, conc))
    for d in (d_t, d_j):
        np.testing.assert_allclose(d.sum(-1), 1.0, rtol=1e-5)
        np.testing.assert_allclose(d.mean(0), mean, rtol=0.05)
        np.testing.assert_allclose(d.var(0), var, rtol=0.05)
    up, down = tbw.bandwidth_draw(_gen(1), 20000, 1.0, 40.0, device=CPU)
    for x in (up, down):
        assert float(x.min()) >= 1.0 and float(x.max()) <= 40.0
        np.testing.assert_allclose(float(x.mean()), 20.5, rtol=0.02)
        np.testing.assert_allclose(float(x.var()), 39.0**2 / 12, rtol=0.05)


def _deterministic_price(sites, hours):
    base = np.array([s.base_price for s in sites])
    amp = np.array([s.diurnal_amp for s in sites])
    off = np.array([s.utc_offset_h for s in sites])
    diurnal = np.cos(2 * np.pi * (hours[:, None] + off[None] - 17.0) / 24.0)
    weekly = 1.0 + 0.03 * np.sin(2 * np.pi * hours[:, None] / (24.0 * 7.0))
    return base * weekly + amp * diurnal


def test_price_trace_by_distribution():
    """Same site climates, same diurnal/weekly structure; the AR(1) noise
    (phi 0.9, stationary std noise_std / sqrt(1 - 0.81)) differs by draw.
    Per slot, the site-mean of each trace sits within 5 standard deviations
    of the site-mean of the shared deterministic part; the residuals have
    the stationary std (within 25% over 4 * 288 AR samples per site) and
    lag-1 autocorrelation 0.9 (within 0.08)."""
    sites = jfl.fleet_sites(dataclasses.replace(jfl.FleetConfig(), n_sites=64))
    t_slots, slot_min = 4 * 288, 5.0
    hours = np.arange(t_slots) * slot_min / 60.0
    det = _deterministic_price(sites, hours)
    sig = np.array([s.noise_std for s in sites]) / math.sqrt(1 - 0.81)
    se_mean = math.sqrt(np.sum(sig**2)) / len(sites)
    p_t = tp.price_trace(_gen(2), t_slots, slot_min, sites, device=CPU).numpy()
    p_j = np.asarray(jp.price_trace(jax.random.key(2), t_slots, slot_min, sites))
    assert p_t.shape == p_j.shape == det.shape and p_t.dtype == np.float32
    for p in (p_t, p_j):
        assert np.all(np.abs(p.mean(1) - det.mean(1)) < 5 * se_mean)
        res = (p - det) / sig
        np.testing.assert_allclose(res.std(0).mean(), 1.0, rtol=0.25)
        lag1 = np.mean(np.sum(res[1:] * res[:-1], 0) / np.sum(res * res, 0))
        assert abs(lag1 - 0.9) < 0.08, lag1


def test_pue_trace_by_distribution():
    """PUE = base + amp * cos(...) + N(0, 0.004^2): residual mean within 5
    standard errors of 0, std within 5% of 0.004, on the 4-DC sites."""
    sites, t_slots = tp.FACEBOOK_SITES, 4000
    hours = np.arange(t_slots) * 5.0 / 60.0
    base = np.array([s.base_pue for s in sites])
    amp = np.array([s.pue_amp for s in sites])
    off = np.array([s.utc_offset_h for s in sites])
    det = base + amp * np.cos(2 * np.pi * (hours[:, None] + off - 15.0) / 24.0)
    u_t = tpue.pue_trace(_gen(3), t_slots, 5.0, sites, device=CPU).numpy()
    u_j = np.asarray(jpue.pue_trace(jax.random.key(3), t_slots, 5.0, sites))
    for u in (u_t, u_j):
        res = u - det
        assert np.all(np.abs(res.mean(0)) < 5 * 0.004 / math.sqrt(t_slots))
        np.testing.assert_allclose(res.std(0), 0.004, rtol=0.05)


def test_fleet_builder_by_distribution():
    """The port's fleet builder against JAX's, by distribution, at N=16,
    K=3, T=96 with 40 runs (3840 slot samples per site and class).

    Arrivals: both sides' per-class means within 5 standard errors of
    Poisson(80) and variances within 10% of it. Service rates: Poisson
    cells (variance within 20% of the mean where the mean exceeds 1 job);
    the two sides' tables differ only through their own random
    bandwidth/dataset draws, which move the I/O slowdown by at most ~12%
    (a 1 Gb/s downlink) and mostly by < 1%, so per-(site, class) means
    agree within 15%, and both follow the shared capacity shares.
    Prices: the slot-wise site mean follows the shared diurnal structure
    within 5 standard errors of the AR(1) noise."""
    cfg_t = dataclasses.replace(tfl.FleetConfig(), n_sites=16, k_types=3, t_slots=96)
    cfg_j = dataclasses.replace(jfl.FleetConfig(), n_sites=16, k_types=3, t_slots=96)
    runs = 40
    tpl_t, build_t = tfl.make_fleet_builder(cfg_t, device=CPU)
    ins_t = build_t(_gen(5), runs)
    assert tuple(ins_t.mu.shape) == (runs, 96, 16, 3)
    assert tuple(ins_t.arrivals.shape) == (runs, 96, 3)
    assert all(x.dtype == torch.float32 for x in ins_t)
    _, build_j = jfl.make_fleet_builder(cfg_j)
    ins_j = jax.vmap(build_j)(jax.random.split(jax.random.key(5), runs))
    samples = runs * cfg_t.t_slots

    a_t = ins_t.arrivals.numpy().reshape(-1, 3)
    a_j = np.asarray(ins_j.arrivals).reshape(-1, 3)
    for a in (a_t, a_j):
        assert np.all(np.abs(a.mean(0) - 80.0) < 5 * math.sqrt(80.0 / samples))
        np.testing.assert_allclose(a.var(0), 80.0, rtol=0.10)

    shares = tfl.fleet_capacity_shares(cfg_t)
    means = []
    for mu in (ins_t.mu.numpy(), np.asarray(ins_j.mu)):
        mu = mu.reshape(-1, 16, 3)
        m, v = mu.mean(0), mu.var(0)
        big = m > 1.0
        np.testing.assert_allclose(v[big], m[big], rtol=0.20)
        assert np.corrcoef(m.mean(1), shares)[0, 1] > 0.95
        means.append(m)
    big = (means[0] > 1.0) & (means[1] > 1.0)
    assert big.sum() >= 8
    np.testing.assert_allclose(means[0][big], means[1][big], rtol=0.15)

    hours = np.arange(cfg_t.t_slots) * cfg_t.slot_minutes / 60.0
    sites = tfl.fleet_sites(cfg_t)
    det = _deterministic_price(sites, hours)
    sig = np.array([s.noise_std for s in sites]) / math.sqrt(1 - 0.81)
    se_mean = math.sqrt(np.sum(sig**2)) / len(sites)
    assert np.all(np.abs(tpl_t.omega.numpy().mean(1) - det.mean(1)) < 5 * se_mean)
