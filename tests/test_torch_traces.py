"""The port's trace pipeline against the JAX package's.

Deterministic pieces (CDF tables, site climates, the draw-to-count step fed
JAX's own uniforms, the I/O slowdown) must agree exactly or to fp32
rounding. The random draws come from different generators (threefry on one
side, torch's on the other), so they are held to the same distributions.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
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


def test_poisson_arrivals_by_distribution_and_truncation():
    """Poisson(lam) per type: over 20000 slots the mean is within 5 standard
    errors (sqrt(lam / 20000)) of lam and the variance within 5% of it, on
    both sides. Truncation at a_max is exact: the truncated draw is the
    untruncated one from the same seed, clamped."""
    t_slots, lam = 20000, [3.0, 40.5]
    got = ta.poisson_arrivals(_gen(4), t_slots, 2, torch.tensor(lam), device=CPU).numpy()
    want = np.asarray(ja.poisson_arrivals(jax.random.key(4), t_slots, 2, jnp.asarray(lam)))
    assert got.shape == want.shape == (t_slots, 2) and got.dtype == np.float32
    for x in (got, want):
        assert np.all(np.abs(x.mean(0) - lam) < 5 * np.sqrt(np.asarray(lam) / t_slots))
        np.testing.assert_allclose(x.var(0), lam, rtol=0.05)
    cut = ta.poisson_arrivals(_gen(4), t_slots, 2, torch.tensor(lam), a_max=38.0, device=CPU)
    assert np.array_equal(cut.numpy(), np.minimum(got, 38.0))
    j_cut = np.asarray(ja.poisson_arrivals(jax.random.key(4), t_slots, 2, jnp.asarray(lam), 38.0))
    assert np.array_equal(j_cut, np.minimum(want, 38.0))
    scalar = ta.poisson_arrivals(_gen(5), 10, 3, 7.0, device=CPU)
    assert tuple(scalar.shape) == (10, 3)


@pytest.mark.parametrize("table_shape,shape", [((), (500,)), ((3, 2), (40, 3, 2)),
                                               ((4,), (6, 5, 4))])
def test_poisson_from_table_counts_from_jax_uniforms(table_shape, shape):
    """JAX's own uniforms through the port's inverse CDF: identical counts."""
    rng = np.random.default_rng(len(shape))
    cdf = ja.poisson_table(rng.uniform(1, 30, table_shape), 64)
    key = jax.random.key(sum(shape))
    want = np.asarray(ja.poisson_from_table(key, jnp.asarray(cdf), shape))
    u = np.array(jax.random.uniform(key, shape))
    got = ta._inverse_cdf(torch.from_numpy(u), torch.from_numpy(cdf)).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got, want)
    drawn = ta.poisson_from_table(_gen(6), torch.from_numpy(cdf), shape)
    assert tuple(drawn.shape) == shape and float(drawn.max()) <= 64
    with pytest.raises(ValueError, match="tables' dims"):
        ta.poisson_from_table(_gen(6), torch.from_numpy(ja.poisson_table([1.0, 2.0], 8)), (5, 3))


def test_poisson_from_table_by_distribution():
    """A 40.5-rate table (the paper's per-slot rate), 20000 draws: mean
    within 5 standard errors and variance within 5%."""
    cdf = torch.from_numpy(ja.poisson_table(40.5, 128))
    x = ta.poisson_from_table(_gen(7), cdf, (20000,)).numpy()
    assert abs(x.mean() - 40.5) < 5 * math.sqrt(40.5 / 20000)
    np.testing.assert_allclose(x.var(), 40.5, rtol=0.05)


def test_service_rate_trace_by_distribution_and_truncation():
    """Poisson(shares_i * lam_k * slowdown_i) per (site, type): over 5000
    slots each cell's mean is within 5 standard errors of its rate and its
    variance within 10%, on both sides; mu_max truncation is exact."""
    t_slots, lam = 5000, [20.0, 8.0]
    shares, slow = (0.3, 0.2, 0.9, 0.6), np.float32([0.9, 1.0, 0.5, 0.8])
    rate = np.asarray(shares)[:, None] * np.asarray(lam)[None] * slow[:, None]
    got = td.service_rate_trace(_gen(8), t_slots, torch.tensor(lam), shares, 2,
                                torch.from_numpy(slow), device=CPU).numpy()
    want = np.asarray(jd.service_rate_trace(jax.random.key(8), t_slots, jnp.asarray(lam),
                                            shares, 2, jnp.asarray(slow)))
    assert got.shape == want.shape == (t_slots, 4, 2) and got.dtype == np.float32
    for x in (got, want):
        assert np.all(np.abs(x.mean(0) - rate) < 5 * np.sqrt(rate / t_slots))
        np.testing.assert_allclose(x.var(0), rate, rtol=0.10)
    cut = td.service_rate_trace(_gen(8), t_slots, torch.tensor(lam), shares, 2,
                                torch.from_numpy(slow), mu_max=10.0, device=CPU)
    assert np.array_equal(cut.numpy(), np.minimum(got, 10.0))
    default = td.service_rate_trace(_gen(9), 7, 40.5, device=CPU)
    assert tuple(default.shape) == (7, 4, 1)


@pytest.mark.parametrize("loader", ["price", "pue"])
def test_csv_loaders_match_jax(tmp_path, loader):
    port, ref = {"price": (tp.load_price_csv, jp.load_price_csv),
                 "pue": (tpue.load_pue_csv, jpue.load_pue_csv)}[loader]
    rng = np.random.default_rng(1)
    table = rng.uniform(1.0, 80.0, (12, 4))
    path = tmp_path / "trace.csv"
    np.savetxt(path, table, delimiter=",")
    got = port(path, 4, device=CPU)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(ref(str(path), 4)))
    one = tmp_path / "one.csv"
    np.savetxt(one, table[:, 0], delimiter=",")
    assert np.array_equal(port(one, 1, device=CPU).numpy(), np.asarray(ref(str(one), 1)))
    with pytest.raises(ValueError, match="expected 3 columns"):
        port(path, 3, device=CPU)


def test_bandwidth_trace_static_part_and_wobble():
    """The static part is exactly the port's bandwidth_draw from the same
    seed (wobble 0); the per-slot factor is uniform on [1 - w, 1 + w]: over
    64 x 2000 samples its mean is within 0.005 of 1 and its variance within
    5% of w^2 / 3, on both sides."""
    t_slots, n, w = 2000, 64, 0.15
    up, down = tbw.bandwidth_trace(_gen(3), t_slots, n, wobble=0.0, device=CPU)
    up0, down0 = tbw.bandwidth_draw(_gen(3), n, device=CPU)
    assert torch.equal(up, up0.expand(t_slots, n)) and torch.equal(down, down0.expand(t_slots, n))
    up, down = tbw.bandwidth_trace(_gen(3), t_slots, n, wobble=w, device=CPU)
    j_up, j_down = jbw.bandwidth_trace(jax.random.key(3), t_slots, n, wobble=w)
    for x in (up.numpy(), down.numpy(), np.asarray(j_up), np.asarray(j_down)):
        assert x.shape == (t_slots, n)
        base = (x.max(0) + x.min(0)) / 2             # the static draw, to within the noise
        assert np.all((x.min(0) >= 0.1 * (1 - w) - 1e-6) & (x.max(0) <= 2.0 * (1 + w) + 1e-6))
        f = x / base
        assert abs(f.mean() - 1.0) < 0.005
        np.testing.assert_allclose(f.var(), w * w / 3, rtol=0.05)
    f_t = up.numpy() / up0.numpy()
    assert f_t.min() >= 1 - w - 1e-6 and f_t.max() <= 1 + w + 1e-6
