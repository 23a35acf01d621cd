"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU: a CUDA
kernel has no CPU mode. This file imports torch, numpy and the port only —
not JAX, which the machines with the card need not have — so that it runs
there on its own:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.fleet_256 import FleetConfig, make_fleet_builder, make_serve_grid
from repro_torch.core.gmsa import make_kernel_policy
from repro_torch.core.simulator import simulate_many
from repro_torch.core.sweep import sweep_grid
from repro_torch.jobs import (
    chain_dag,
    shuffle_volumes_from_selectivity,
    simulate_staged_many,
    stage_oblivious,
    summarize_staged,
)
from repro_torch.kernels.gmsa_score import gmsa_score, gmsa_score_phases_ref, gmsa_score_ref
from repro_torch.kernels.gmsa_score.kernel import _gmsa_score_cuda_phases, gmsa_score_cuda
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_phases_ref, ssd_scan_ref
from repro_torch.kernels.ssd_scan.kernel import _ssd_scan_cuda_phases, ssd_scan_cuda
from repro_torch.models import lm
from repro_torch.serve.step import make_local_exec
from repro_torch.benchmarks import serve_bench
from repro_torch.serve.engine import FleetConfig as ServeFleetConfig
from repro_torch.serve.engine import FleetEngine, RequestClass
from repro_torch.placement import (
    PlacedOutputs,
    PlacementConfig,
    make_adaptive_rule,
    simulate_placed_many,
    wan_topology,
)
from repro_torch.core.sweep import sweep_placed_budgets
from repro_torch.traces.drift import ingest_drift_trace
from repro_torch.traces.faults import scheduled_failure_trace
from repro_torch.telemetry import (
    SUMMARY,
    TRACE,
    HistogramSpec,
    TelemetryConfig,
    collect_records,
    cross_check,
)
from repro_torch.traces.stages import staged_mix_profile

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


def _ssd_inputs(seed, b, s, h, p, n, dtype, dev):
    rng = np.random.default_rng(seed)
    t = lambda x, d=torch.float32: torch.from_numpy(x.astype(np.float32)).to(dev, d)
    return (
        t(rng.standard_normal((b, s, h, p)), dtype),
        t(np.logaddexp(0.0, rng.standard_normal((b, s, h)))),
        t(-np.exp(rng.standard_normal(h))),
        t(rng.standard_normal((b, s, n)), dtype),
        t(rng.standard_normal((b, s, n)), dtype),
    )


# tests/test_kernels.py's tolerances: fp32 (chunked vs sequential rounding),
# bf16 (y rounded to bf16).
SSD_TOL = {torch.float32: 3e-4, torch.bfloat16: 5e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,chunk", [(200, 64), (100, 24), (256, 256)])
def test_ssd_scan_kernel_matches_plain_version(cuda, s, chunk, dtype):
    ops = _ssd_inputs(s + chunk, 2, s, 3, 64, 128, dtype, cuda)
    before = ssd_scan_cuda.launches
    y, hf = ssd_scan(*ops, chunk=chunk)
    y2, hf2 = ssd_scan(*ops, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan_cuda.launches == before + 2
    assert torch.equal(y, y2) and torch.equal(hf, hf2)
    y0, h0 = ssd_scan_ref(*ops)
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(y.float(), y0.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(hf, h0, rtol=tol, atol=tol)


def _rel(got, want):
    """max |got - want| / max(|want|, 1), elementwise."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / want.abs().clamp_min(1.0)).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,chunk", [(512, 128), (192, 24), (384, 96)])
def test_ssd_scan_chain_workspaces_match_plain_phases(cuda, s, chunk, dtype):
    """Phase by phase: the fp64 cumsum (summation order only: 1e-12
    relative), CBᵀ on and below the diagonal and the entering states (fp32
    sums in another order: 1e-4 relative to max(|plain|, 1)), then y and
    h_final at the SSD tolerances."""
    ops = _ssd_inputs(s + chunk, 2, s, 3, 64, 128, dtype, cuda)
    y, hf, cum, g, h_in = _ssd_scan_cuda_phases(*ops, chunk)
    y0, h0, cum0, g0, h_in0 = ssd_scan_phases_ref(*ops, chunk)
    torch.cuda.synchronize()
    torch.testing.assert_close(cum, cum0, rtol=1e-12, atol=0)
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=cuda).tril()
    assert _rel(g[..., tri], g0[..., tri]) <= 1e-4
    assert _rel(h_in, h_in0) <= 1e-4
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(y.float(), y0.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(hf, h0, rtol=tol, atol=tol)


@pytest.mark.parametrize("chunk", [24, 256])
def test_ssd_scan_chain_repeats_bitwise_and_counts_one_launch_per_call(cuda, chunk):
    """Every output and workspace repeats bitwise (G where the chain writes
    it: on and below the diagonal)."""
    ops = _ssd_inputs(chunk, 2, 4 * chunk, 3, 64, 128, torch.float32, cuda)
    before = ssd_scan_cuda.launches
    first = _ssd_scan_cuda_phases(*ops, chunk)
    assert ssd_scan_cuda.launches == before + 1
    second = _ssd_scan_cuda_phases(*ops, chunk)
    assert ssd_scan_cuda.launches == before + 2
    y, hf = ssd_scan_cuda(*ops, chunk)
    assert ssd_scan_cuda.launches == before + 3
    torch.cuda.synchronize()
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=cuda).tril()
    for name, u, v in zip(("y", "h_final", "cum", "G", "h_in"), first, second):
        if name == "G":
            u, v = u[..., tri], v[..., tri]
        assert torch.equal(u, v), name
    assert torch.equal(y, first[0]) and torch.equal(hf, first[1])


def test_ssd_scan_chain_long_single_sequence_matches_sequential(cuda):
    """B = 1 over 16 chunks: the entering state is carried through every
    chunk by state_pass."""
    ops = _ssd_inputs(16, 1, 16 * 64, 2, 64, 128, torch.float32, cuda)
    y, hf = ssd_scan(*ops, chunk=64)
    y0, h0 = ssd_scan_ref(*ops)
    torch.testing.assert_close(y, y0, rtol=3e-4, atol=3e-4)
    torch.testing.assert_close(hf, h0, rtol=3e-4, atol=3e-4)


def test_ssd_scan_cuda_rejects_what_it_cannot_run(cuda):
    x, dt, a, bm, cm = _ssd_inputs(1, 1, 64, 2, 64, 128, torch.float32, cuda)
    with pytest.raises(ValueError, match="divide"):
        ssd_scan_cuda(x, dt, a, bm, cm, 48)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan_cuda(x.transpose(1, 2).contiguous().transpose(1, 2), dt, a, bm, cm, 64)
    with pytest.raises(TypeError, match="share"):
        ssd_scan_cuda(x, dt, a, bm.bfloat16(), cm, 64)
    big = _ssd_inputs(2, 1, 64, 2, 64, 256, torch.float32, cuda)
    with pytest.raises(ValueError, match="limits"):
        ssd_scan_cuda(*big, 64)


def test_gmsa_score_kernel_matches_plain_version(cuda):
    rng = np.random.default_rng(0)
    k, n = 8, 256
    t = lambda x: torch.from_numpy(x.astype(np.float32)).to(cuda)
    ops = (t(rng.random((3, k, n)) * 100), t(rng.random((3, k, n)) * 50),
           t(rng.random((3, k)) * 40), t(rng.random(k) * 10),
           t(rng.dirichlet(np.ones(n), (k, n))), t(rng.random(n) * 20))
    before = gmsa_score_cuda.launches
    s, b = gmsa_score(*ops)
    assert gmsa_score_cuda.launches == before + 1
    s0, b0 = gmsa_score_ref(*ops)
    torch.testing.assert_close(s, s0, rtol=1e-4, atol=1e-4)
    picked = torch.gather(s0, -1, b.long()[..., None])[..., 0]
    torch.testing.assert_close(picked, s0.min(-1).values, rtol=1e-5, atol=1e-4)


def _score_ops(seed, runs, k, n, layout, dev):
    """gmsa_score operands with q and mu in one of the layouts the kernel
    tells apart: ``k_contig`` (the simulator's (R, N, K) buffers through
    .mT), ``n_contig`` (contiguous (R, K, N)), ``strided`` (every second
    element of a wider buffer: the scalar path), ``r_unaligned`` (n_contig,
    with r contiguous but 4 bytes off 16-byte alignment: the cost kernel's
    scalar path)."""
    rng = np.random.default_rng(seed)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev)
    q, mu = rng.random((runs, k, n)) * 100, rng.random((runs, k, n)) * 50
    r = rng.random((k, n, n), dtype=np.float32)
    r /= r.sum(-1, keepdims=True)
    a, vp, wpue = t(rng.random((runs, k)) * 40), t(rng.random(k) * 10), t(rng.random(n) * 20)
    r = t(r)
    if layout == "k_contig":
        q, mu = t(np.swapaxes(q, -1, -2)).mT, t(np.swapaxes(mu, -1, -2)).mT
    elif layout == "strided":
        wide = lambda x: torch.repeat_interleave(t(x), 2, dim=-1)[..., ::2]
        q, mu = wide(q), wide(mu)
    else:
        q, mu = t(q), t(mu)
    if layout == "r_unaligned":
        flat = torch.empty(r.numel() + 1, device=dev)
        flat[1:] = r.flatten()
        r = flat[1:].view(k, n, n)
        assert r.is_contiguous() and r.data_ptr() % 16
    return q, mu, a, vp, r, wpue


def _check_scores(s, b, s0):
    """Scores within the fp32 summation-order tolerance of the plain
    version; a differing argmin only on a near-tie (1e-5 relative)."""
    torch.testing.assert_close(s, s0, rtol=1e-4, atol=1e-4)
    picked = torch.gather(s0, -1, b.long()[..., None])[..., 0]
    torch.testing.assert_close(picked, s0.min(-1).values, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("layout", ["k_contig", "n_contig", "strided", "r_unaligned"])
@pytest.mark.parametrize("runs,k,n", [(3, 8, 256), (2, 9, 129), (4, 1, 4), (2, 5, 130),
                                      (1, 128, 1024)])
def test_gmsa_score_chain_matches_plain_phases(cuda, runs, k, n, layout):
    """The cost workspace against gmsa_score_phases_ref (both accumulate in
    fp64 and round once: 1e-6 relative), scores and argmin against the
    plain version; calls repeat bitwise and each counts one launch."""
    ops = _score_ops(runs * k + n, runs, k, n, layout, cuda)
    before = gmsa_score_cuda.launches
    cost, s, b = _gmsa_score_cuda_phases(*ops)
    s2, b2 = gmsa_score(*ops)
    assert gmsa_score_cuda.launches == before + 2
    torch.cuda.synchronize()
    assert torch.equal(s, s2) and torch.equal(b, b2)
    assert s.shape == (runs, k, n) and b.shape == (runs, k) and b.dtype == torch.int32
    cost0, s0p, _ = gmsa_score_phases_ref(*ops)
    assert _rel(cost, cost0) <= 1e-6
    _check_scores(s, b, s0p)
    _check_scores(s, b, gmsa_score_ref(*ops)[0])


@pytest.mark.parametrize("layout", ["k_contig", "n_contig"])
def test_gmsa_score_chain_ties_zero_arrivals_and_nan(cuda, layout):
    """Exact ties go to the lowest index, a = 0 rows to index 0, and a NaN
    score wins at its index, as in torch.argmin."""
    # clone() keeps each operand's strides, so the layout survives.
    q, mu, a, vp, r, wpue = (x.clone() for x in _score_ops(21, 4, 8, 256, layout, cuda))
    lo, hi = 37, 201
    q[..., lo] = -1e4
    q[..., hi], mu[..., hi], r[:, hi, :] = q[..., lo], mu[..., lo], r[:, lo, :]
    a[:, 3] = 0.0
    q[2, 6, 77] = float("nan")
    s, b = gmsa_score(q, mu, a, vp, r, wpue)
    want = torch.full((4, 8), lo, dtype=torch.int32, device=cuda)
    want[:, 3] = 0
    want[2, 6] = 77
    assert torch.equal(b, want)
    assert torch.equal(s[..., lo], s[..., hi])
    assert torch.equal(b, torch.argmin(s, dim=-1).to(torch.int32))


def _per_run_ops(seed, runs, k, n, layout, dev):
    """``_score_ops`` with one (K, N, N) ratio tensor per run: contiguous
    (``r_layout="contig"``), a non-contiguous view the wrapper copies
    (``"strided"``), or contiguous 4 bytes off 16-byte alignment (the cost
    kernel's scalar path, ``"unaligned"``)."""
    q, mu, a, vp, _, wpue = _score_ops(seed, runs, k, n, "k_contig", dev)
    rng = np.random.default_rng(seed + 1)
    r = rng.random((runs, k, n, n), dtype=np.float32)
    r = torch.from_numpy(r / r.sum(-1, keepdims=True)).to(dev)
    if layout == "strided":
        wide = torch.zeros((runs, k, n, n + 3), device=dev)
        wide[..., :n] = r
        r = wide[..., :n]
        assert not r.is_contiguous()
    elif layout == "unaligned":
        flat = torch.empty(r.numel() + 1, device=dev)
        flat[1:] = r.flatten()
        r = flat[1:].view(runs, k, n, n)
        assert r.is_contiguous() and r.data_ptr() % 16
    return q, mu, a, vp, r, wpue


@pytest.mark.parametrize("layout", ["contig", "strided", "unaligned"])
@pytest.mark.parametrize("runs,k,n", [(3, 8, 256), (2, 9, 129), (4, 1, 4), (5, 3, 130)])
def test_gmsa_score_per_run_r_matches_both_plain_versions(cuda, runs, k, n, layout):
    """One ratio tensor per run: the (runs, K, N) cost workspace against
    gmsa_score_phases_ref (1e-6 relative), scores and argmin against both
    plain versions, each run against a shared-r call with that run's r
    (bitwise: the same arithmetic); one counted launch per call."""
    ops = _per_run_ops(runs * k + n, runs, k, n, layout, cuda)
    before = gmsa_score_cuda.launches
    cost, s, b = _gmsa_score_cuda_phases(*ops)
    s2, b2 = gmsa_score(*ops)
    assert gmsa_score_cuda.launches == before + 2
    torch.cuda.synchronize()
    assert cost.shape == (runs, k, n)
    assert torch.equal(s, s2) and torch.equal(b, b2)
    cost0, s0p, _ = gmsa_score_phases_ref(*ops)
    assert cost0.shape == (runs, k, n)
    assert _rel(cost, cost0) <= 1e-6
    _check_scores(s, b, s0p)
    _check_scores(s, b, gmsa_score_ref(*ops)[0])
    q, mu, a, vp, r, wpue = ops
    for i in range(runs):
        c1, s1, b1 = _gmsa_score_cuda_phases(q[i:i + 1], mu[i:i + 1], a[i:i + 1], vp,
                                             r[i].contiguous(), wpue)
        assert torch.equal(c1, cost[i]) and torch.equal(s1[0], s[i]) and torch.equal(b1[0], b[i])


def test_gmsa_score_per_run_r_ties_and_shape_errors(cuda):
    """Ties to the lowest index per run with per-run r; an r whose batch dims
    are not q's is refused."""
    q, mu, a, vp, r, wpue = (x.clone() for x in _per_run_ops(5, 4, 8, 256, "contig", cuda))
    lo, hi = 11, 240
    q[..., lo] = -1e4
    q[..., hi], mu[..., hi], r[:, :, hi, :] = q[..., lo], mu[..., lo], r[:, :, lo, :]
    _, b = gmsa_score(q, mu, a, vp, r, wpue)
    assert bool((b == lo).all())
    with pytest.raises(ValueError, match="shape mismatch"):
        gmsa_score_cuda(q, mu, a, vp, r[:2], wpue)


def _small_placed(cuda):
    """fleet widths cut to N = 32, K = 3, T = 96, W = 24, with a drifting
    ingest toward the priciest sites and the fleet's backbone."""
    cfg = dataclasses.replace(FleetConfig(), n_sites=32, k_types=3, t_slots=96)
    _, build = make_fleet_builder(cfg, device=cuda)
    omega, pue, _, up, down, _, _ = make_serve_grid(cfg, cfg.k_types, cfg.t_slots, device=cuda)
    day = (omega * pue).mean(0)
    ingest = ingest_drift_trace(torch.Generator(device=cuda).manual_seed(7), 4, cfg.k_types,
                                cfg.n_sites, bias=day / day.sum(), bias_strength=0.5, device=cuda)
    pcfg = PlacementConfig(epoch_slots=24, growth=0.25, manager_share=cfg.manager_share,
                           map_share=cfg.map_share)
    alive = scheduled_failure_trace(cfg.t_slots, cfg.n_sites, [(int(day.argmax()), 50, None)],
                                    device=cuda)
    return cfg, build, up, down, pcfg, ingest, alive


@pytest.mark.parametrize("faulty", [False, True])
def test_placed_kernel_policy_one_launch_per_slot_and_matches_plain(cuda, faulty):
    """The carried-r kernel policy in the placement controller: exactly T
    launches per call (per-run r after the first boundary), finite bills,
    decisions equal the plain policy's off near-ties (0.999, as
    test_torch_simulator.py), an all-ones mask bitwise equal to none."""
    cfg, build, up, down, pcfg, ingest, alive = _small_placed(cuda)
    rule = make_adaptive_rule(up)
    run = lambda pol, al: simulate_placed_many(
        build, up, down, pol, rule, torch.Generator(device=cuda).manual_seed(3), 5, pcfg,
        scalar=cfg.v, ingest=ingest, alive=al)
    before = gmsa_score_cuda.launches
    k = run(make_kernel_policy(None), alive if faulty else None)
    torch.cuda.synchronize()
    assert gmsa_score_cuda.launches == before + cfg.t_slots
    for name, x in k._asdict().items():
        assert bool(torch.isfinite(x).all()), name
    p = run(make_kernel_policy(None, impl="ref"), alive if faulty else None)
    assert float((k.f_trace == p.f_trace).all(-2).float().mean()) >= 0.999
    if not faulty:
        ones = run(make_kernel_policy(None), torch.ones_like(alive))
        for a, b in zip(k, ones):
            assert torch.equal(a, b)


def test_placed_budget_sweep_lanes_bitwise_on_the_card(cuda):
    """sweep_placed_budgets: T launches per call; each lane's decisions,
    queues and layouts equal the per-budget call bit for bit, sums within
    1e-6 relative."""
    cfg, build, up, down, pcfg, ingest, _ = _small_placed(cuda)
    rule = make_adaptive_rule(up)
    pol = make_kernel_policy(None)
    gen = lambda: torch.Generator(device=cuda).manual_seed(4)
    before = gmsa_score_cuda.launches
    grid = sweep_placed_budgets(build, up, down, pol, rule, gen(), 4, pcfg, (0.25, 1.0),
                                scalar=cfg.v, ingest=ingest)
    torch.cuda.synchronize()
    assert gmsa_score_cuda.launches == before + cfg.t_slots
    for i, mb in enumerate((0.25, 1.0)):
        per = simulate_placed_many(build, up, down, pol, rule, gen(), 4,
                                   dataclasses.replace(pcfg, move_budget=mb), scalar=cfg.v,
                                   ingest=ingest)
        lane = PlacedOutputs(*(x[i] for x in grid))
        for name in ("f_trace", "q_final", "placements", "r_trace"):
            assert torch.equal(getattr(lane, name), getattr(per, name)), name
        for name in ("cost", "energy", "wan_cost", "sync_cost"):
            torch.testing.assert_close(getattr(lane, name), getattr(per, name), rtol=1e-6,
                                       atol=0.0, msg=name)


def test_smoke_model_on_the_card_matches_the_cpu(cuda):
    """Prefill through the CUDA kernel (one launch per layer) and decode agree
    with the CPU run of the same weights (tests/test_models.py's 2e-4)."""
    cfg = get_arch("mamba2-2.7b", "smoke")
    p = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    p_gpu = {k: v.to(cuda) for k, v in p.items() if k != "blocks"}
    p_gpu["blocks"] = {k: v.to(cuda) for k, v in p["blocks"].items()}
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 41)))
    pre, dec = make_local_exec(cfg, 2)
    before = ssd_scan_cuda.launches
    logits, cache = pre(p_gpu, tokens[:, :40])
    assert ssd_scan_cuda.launches == before + cfg.num_layers
    logits_c, cache_c = lm.prefill_step(p, cfg, tokens[:, :40], cache_dtype=torch.float32)
    torch.testing.assert_close(logits.cpu(), logits_c, rtol=2e-4, atol=2e-4)
    step, _ = dec(p_gpu, cache, tokens[:, 40:41])
    step_c, _ = lm.decode_step(p, cfg, cache_c, tokens[:, 40:41])
    torch.testing.assert_close(step.cpu(), step_c, rtol=2e-4, atol=2e-4)


def _small_fleet(cuda):
    cfg = dataclasses.replace(FleetConfig(), n_sites=32, k_types=3, t_slots=24)
    return cfg, make_fleet_builder(cfg, device=cuda)[1]


SWEEP_V = (0.01, 1.0, 100.0)


def test_kernel_sweep_grid_one_launch_per_slot_and_lanes_bitwise(cuda):
    """A kernel-policy sweep_grid folds the V x R lanes into the kernel's
    runs axis: exactly T launches per call. Each lane's decisions and final
    queues equal simulate_many at its V with the same seed, bit for bit;
    the per-slot sums to 1e-6 relative (a reduction may split a larger
    batch differently)."""
    cfg, build = _small_fleet(cuda)
    policy = make_kernel_policy(None)
    gen = lambda: torch.Generator(device=cuda).manual_seed(3)
    before = gmsa_score_cuda.launches
    grid = sweep_grid(build, policy, gen(), 5, SWEEP_V)
    torch.cuda.synchronize()
    assert gmsa_score_cuda.launches == before + cfg.t_slots
    assert grid.f_trace.shape == (3, 5, cfg.t_slots, cfg.n_sites, cfg.k_types)
    for i, v in enumerate(SWEEP_V):
        per = simulate_many(build, policy, gen(), 5, v)
        assert torch.equal(grid.f_trace[i], per.f_trace)
        assert torch.equal(grid.q_final[i], per.q_final)
        for name in ("cost", "energy", "backlog_total", "backlog_avg"):
            torch.testing.assert_close(getattr(grid, name)[i], getattr(per, name),
                                       rtol=1e-6, atol=0.0, msg=name)


def test_kernel_sweep_grid_matches_the_plain_policy(cuda):
    """The same sweep through the plain policy on the card: decisions agree
    off near-ties (test_torch_simulator.py's 0.999)."""
    _, build = _small_fleet(cuda)
    gen = lambda: torch.Generator(device=cuda).manual_seed(4)
    k = sweep_grid(build, make_kernel_policy(None), gen(), 4, SWEEP_V)
    p = sweep_grid(build, make_kernel_policy(None, impl="ref"), gen(), 4, SWEEP_V)
    assert float((k.f_trace == p.f_trace).all(-2).float().mean()) >= 0.999


def test_telemetry_off_is_bitwise_and_summary_adds_streams_on_the_card(cuda):
    cfg, build = _small_fleet(cuda)
    policy = make_kernel_policy(None)
    run = lambda tel: simulate_many(build, policy, torch.Generator(device=cuda).manual_seed(5),
                                    4, cfg.v, telemetry=tel)
    base = run(None)
    for other in (run(TelemetryConfig()), run(TelemetryConfig(hist=HistogramSpec()))):
        for a, b in zip(base, other):
            assert torch.equal(a, b)
    before = gmsa_score_cuda.launches
    outs, frame = run(TelemetryConfig(level=SUMMARY, hist=HistogramSpec()))
    assert gmsa_score_cuda.launches == before + cfg.t_slots
    for a, b in zip(base, outs):
        assert torch.equal(a, b)
    torch.testing.assert_close(frame.metrics["q_site"].sum(-1), base.backlog_total,
                               rtol=1e-6, atol=1e-6)
    counts = frame.metrics["site_cost_hist"]
    assert counts.shape == (4, cfg.n_sites, HistogramSpec().n_buckets)
    assert bool((counts.sum(-1) == cfg.t_slots).all())


def _staged_fleet(cuda):
    """fleet_256's widths (N = 256, K = 8) over 24 slots with a drawn K = 8,
    S = 3 mix (100 GB inputs) and the fleet's backbone, as chip_smoke.py's
    staged phase builds it at full size."""
    cfg = dataclasses.replace(FleetConfig(), t_slots=24)
    _, build = make_fleet_builder(cfg, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(17)
    mask, compute, sel = staged_mix_profile(gen, cfg.k_types, 3, min_stages=2, device=cuda)
    dag = chain_dag(compute, shuffle_volumes_from_selectivity(100.0, sel), mask)
    _, _, _, up, down, _, _ = make_serve_grid(cfg, cfg.k_types, cfg.t_slots, device=cuda)
    return cfg, build, dag, wan_topology(up, down, energy_per_gb=0.03)


def test_staged_fleet_kernel_policy_launches_once_per_slot_and_matches_plain(cuda):
    """``stage_oblivious(make_kernel_policy(None))`` on the staged engine:
    exactly T launches per call, finite outputs, decisions equal the plain
    policy's off near-ties (test_torch_simulator.py's 0.999)."""
    cfg, build, dag, wan = _staged_fleet(cuda)
    gen = lambda: torch.Generator(device=cuda).manual_seed(6)
    before = gmsa_score_cuda.launches
    k = simulate_staged_many(build, dag, wan, stage_oblivious(make_kernel_policy(None),
                                                              pin_map=True), gen(), 6, cfg.v)
    torch.cuda.synchronize()
    assert gmsa_score_cuda.launches == before + cfg.t_slots
    assert k.f_trace.shape == (6, cfg.t_slots, cfg.n_sites, cfg.k_types, 3)
    for name, x in k._asdict().items():
        assert bool(torch.isfinite(x).all()), name
    p = simulate_staged_many(build, dag, wan, stage_oblivious(
        make_kernel_policy(None, impl="ref"), pin_map=True), gen(), 6, cfg.v)
    assert gmsa_score_cuda.launches == before + cfg.t_slots
    assert float((k.f_trace == p.f_trace).all(-3).float().mean()) >= 0.999
    s = summarize_staged(k)
    assert all(np.isfinite(v) for v in s.values()) and s["total_wan_gb"] > 0.0


def test_collect_records_accepts_cuda_outputs(cuda):
    """The host decoder moves CUDA tensors to the host itself; one run is
    indexed out of the batch first."""
    cfg, build, dag, wan = _staged_fleet(cuda)
    tel = TelemetryConfig(level=TRACE, hist=HistogramSpec())
    outs, frame = simulate_staged_many(build, dag, wan, stage_oblivious(make_kernel_policy(None)),
                                       torch.Generator(device=cuda).manual_seed(2), 2, cfg.v,
                                       telemetry=tel)
    one = type(outs)(*(x[0] for x in outs))
    one_frame = type(frame)(type(frame.ring)(*(x[0] for x in frame.ring)),
                            {name: x[0] for name, x in frame.metrics.items()})
    assert one.cost.is_cuda
    records = collect_records(one, one_frame, cfg=tel, summary=summarize_staged(one))
    assert records[0]["kind"] == "staged" and records[0]["t_slots"] == cfg.t_slots
    assert cross_check(records)["ok"]


def _serve_grid_engine(dev, n_pods=16, slots=24, **kw):
    """The fleet serving grid cut to ``n_pods`` pods: two mamba2-2.7b-smoke
    classes priced on the full model, kernel dispatch."""
    cfg = FleetConfig(n_sites=n_pods, k_types=2, t_slots=slots)
    omega, pue, r, up, down, layout, shares = make_serve_grid(cfg, 2, slots, device=dev)
    rcs = [RequestClass(name=f"mamba2-2.7b/{i}", cfg=get_arch("mamba2-2.7b", "smoke"),
                        energy_cfg=get_arch("mamba2-2.7b", "full"), arrival_rate=6.0)
           for i in range(2)]
    fc = ServeFleetConfig(n_pods=n_pods, horizon_slots=slots, v=cfg.v, seed=1,
                          capacity_shares=shares, dispatch="kernel", admit_max=8.0, **kw)
    return FleetEngine(fc, rcs, omega, pue, r, up=up, down=down, layout=layout, device=dev)


def test_serve_kernel_dispatch_launches_once_per_slot_and_replays_simulate_staged(cuda):
    """FleetEngine with ``dispatch="kernel"`` on the card: exactly T
    ``gmsa_score`` launches per dispatch-only run, the replay pin against
    the port's ``simulate_staged`` (``serve_bench.check_replay``: dispatch
    and WAN bill bitwise), conservation, and an all-ones alive mask
    bitwise equal to none."""
    eng = _serve_grid_engine(cuda)
    before = gmsa_score_cuda.launches
    out = eng.run(execute_real=False)
    assert gmsa_score_cuda.launches == before + eng.fcfg.horizon_slots
    assert eng.scenario.inputs.r.device.type == cuda.type
    assert out["dispatch"].shape == (24, 16, 2, 2)
    serve_bench.check_replay(eng, out)
    serve_bench.check_conservation(out)
    ones = FleetEngine(eng.fcfg, eng.classes, eng.omega, eng.pue, eng.r,
                       alive=np.ones((24, 16), np.float32), scenario=eng.scenario, device=cuda)
    out1 = ones.run(execute_real=False)
    for name in ("dispatch", "cost", "wan_cost", "backlog"):
        np.testing.assert_array_equal(out[name], out1[name], err_msg=name)


def test_serve_execute_jobs_launch_ssd_scan_per_layer_per_batch(cuda):
    """``_execute_jobs`` on the card with the smoke model: exactly n_jobs
    run, a remainder batch included, and one ``ssd_scan`` launch per layer
    per prefill batch (64 per batch at full depth, 2 for the smoke one)."""
    eng = _serve_grid_engine(cuda, n_pods=4, slots=4)
    rc = eng.classes[0]
    b = eng.fcfg.batch_per_exec
    for n_jobs in (1, b, b + 1, 2 * b + 3):
        before = ssd_scan_cuda.launches
        done, secs = eng._execute_jobs(rc, n_jobs)
        assert done == n_jobs and secs > 0.0
        assert ssd_scan_cuda.launches - before == rc.cfg.num_layers * -(-n_jobs // b)
    assert eng._execute_jobs(rc, 0) == (0, 0.0)


# ---------------------------------------------------------------------------
# The dense attention family on the card (plain PyTorch: no kernel of its own)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-0.5b", "granite-3-2b"])
def test_dense_smoke_model_on_the_card_matches_the_cpu(cuda, arch):
    """Blockwise prefill into an fp32 KV ring and decode on both
    ``uniform_pos`` paths agree with the CPU run of the same weights
    (tests/test_models.py's 2e-4)."""
    cfg = get_arch(arch, "smoke")
    p = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    p_gpu = {k: v.to(cuda) for k, v in p.items() if k != "blocks"}
    p_gpu["blocks"] = {k: v.to(cuda) for k, v in p["blocks"].items()}
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 41)))
    pre, _ = make_local_exec(cfg, 2)
    logits, cache = pre(p_gpu, tokens[:, :40])
    logits_c, cache_c = lm.prefill_step(p, cfg, tokens[:, :40], cache_dtype=torch.float32,
                                        cache_len=42)
    torch.testing.assert_close(logits.cpu(), logits_c, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(cache["k"].cpu(), cache_c["k"], rtol=2e-4, atol=2e-4)
    for uniform_pos in (True, False):
        step, new = lm.decode_step(p_gpu, cfg, cache, tokens[:, 40:41].to(cuda),
                                   uniform_pos=uniform_pos)
        step_c, new_c = lm.decode_step(p, cfg, cache_c, tokens[:, 40:41],
                                       uniform_pos=uniform_pos)
        torch.testing.assert_close(step.cpu(), step_c, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(new["v"].cpu(), new_c["v"], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("s,causal,window", [(2048, True, 0), (1000, False, 256)])
def test_blockwise_attention_matches_naive_at_a_real_shape(cuda, s, causal, window):
    """granite-3-2b's prefill shape (4 x 2048, 32 heads on 8, d 64), and a
    ragged one whose last KV chunk is padded: chip_smoke.py's ATTN_TOL
    (fp32, another reduction order)."""
    from repro_torch.models.attention import attend_blockwise, attend_naive

    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((4, s, 32, 64), generator=gen, device=cuda)
    k = torch.randn((4, s, 8, 64), generator=gen, device=cuda)
    v = torch.randn((4, s, 8, 64), generator=gen, device=cuda)
    pos = torch.arange(s, device=cuda)
    blk = attend_blockwise(q, k, v, pos, pos, causal=causal, window=window)
    ref = attend_naive(q, k, v, pos, pos, causal=causal, window=window)
    torch.testing.assert_close(blk, ref, rtol=5e-5, atol=5e-5)


def test_dense_engine_launches_gmsa_score_once_per_slot(cuda):
    """A qwen2-0.5b class (smoke executes) with ``dispatch="kernel"``: one
    ``gmsa_score`` launch per slot, no ``ssd_scan``, every drained job run."""
    from repro_torch.launch.serve import build_engine

    eng = build_engine(["qwen2-0.5b"], slots=6, v=1.0, seed=3, arrival=4.0,
                       dispatch="kernel", device=cuda)
    score0, ssd0 = gmsa_score_cuda.launches, ssd_scan_cuda.launches
    out = eng.run(execute_real=True)
    assert gmsa_score_cuda.launches == score0 + 6
    assert ssd_scan_cuda.launches == ssd0
    want = sum(min(int(round(c)), eng.fcfg.exec_cap) for c in out["completed"][:, 0])
    assert out["exec_jobs"] == want > 0
    serve_bench.check_conservation(out)


# ---------------------------------------------------------------------------
# The MoE and hybrid families on the card (MoE plain PyTorch; the hybrid's
# SSM through ssd_scan at 50 heads x 64, state 16)
# ---------------------------------------------------------------------------

def _to(p, dev):
    out = {k: v.to(dev) for k, v in p.items() if k != "blocks"}
    out["blocks"] = {k: v.to(dev) for k, v in p["blocks"].items()}
    return out


@pytest.mark.parametrize("b,s,chunk", [(2, 300, 256), (4, 32, 32), (1, 2000, 256)])
def test_ssd_scan_kernel_at_hymba_heads_and_state(cuda, b, s, chunk):
    """hymba-1.5b's SSM shape (H = 50, P = 64, N = 16): the chain against
    the sequential plain version (SSD_TOL) and its workspaces against the
    plain phases, one counted launch per call."""
    ops = _ssd_inputs(s + chunk + b, b, s, 50, 64, 16, torch.float32, cuda)
    before = ssd_scan_cuda.launches
    y, hf = ssd_scan(*ops, chunk=chunk)
    assert ssd_scan_cuda.launches == before + 1
    y0, h0 = ssd_scan_ref(*ops)
    torch.testing.assert_close(y, y0, rtol=3e-4, atol=3e-4)
    torch.testing.assert_close(hf, h0, rtol=3e-4, atol=3e-4)
    if s % chunk == 0:
        y1, _, cum, g, h_in = _ssd_scan_cuda_phases(*ops, chunk)
        _, _, cum0, g0, h_in0 = ssd_scan_phases_ref(*ops, chunk)
        torch.testing.assert_close(cum, cum0, rtol=1e-12, atol=0)
        tri = torch.ones(chunk, chunk, dtype=torch.bool, device=cuda).tril()
        assert _rel(g[..., tri], g0[..., tri]) <= 1e-4 and _rel(h_in, h_in0) <= 1e-4


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "phi3.5-moe-42b-a6.6b", "hymba-1.5b"])
def test_moe_and_hybrid_smoke_models_on_the_card_match_the_cpu(cuda, arch):
    """Prefill (80 tokens: MoE capacity rounded, pairs drop; the hybrid's
    window of 64 in force, one ssd_scan launch per layer), the forward's
    summed aux, and decode on both ``uniform_pos`` paths agree with the CPU
    run of the same weights (tests/test_models.py's 2e-4)."""
    cfg = get_arch(arch, "smoke")
    p = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    p_gpu = _to(p, cuda)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 81)))
    pre, _ = make_local_exec(cfg, 2)
    before = ssd_scan_cuda.launches
    logits, cache = pre(p_gpu, tokens[:, :80])
    assert ssd_scan_cuda.launches == before + (cfg.num_layers if cfg.has_ssm else 0)
    logits_c, cache_c = lm.prefill_step(p, cfg, tokens[:, :80], cache_dtype=torch.float32,
                                        cache_len=82)
    torch.testing.assert_close(logits.cpu(), logits_c, rtol=2e-4, atol=2e-4)
    for leaf in cache_c:
        torch.testing.assert_close(cache[leaf].cpu(), cache_c[leaf], rtol=2e-4, atol=2e-4)
    with torch.inference_mode():
        _, aux = lm.forward(p_gpu, cfg, tokens[:, :80].to(cuda))
    _, aux_c = lm.forward(p, cfg, tokens[:, :80])
    assert float(aux) == pytest.approx(float(aux_c), rel=1e-6) and (float(aux) > 0) == cfg.is_moe
    for uniform_pos in (True, False):
        step, _ = lm.decode_step(p_gpu, cfg, cache, tokens[:, 80:81].to(cuda),
                                 uniform_pos=uniform_pos)
        step_c, _ = lm.decode_step(p, cfg, cache_c, tokens[:, 80:81], uniform_pos=uniform_pos)
        torch.testing.assert_close(step.cpu(), step_c, rtol=2e-4, atol=2e-4)


def test_moe_ffn_on_the_card_routes_drops_and_combines_as_the_cpu(cuda):
    """One deepseek-moe-16b-width MoE layer (64 experts, top 6, d 2048, f
    1408) on 2 x 256 tokens: expert indices and dropped pairs equal to the
    CPU's on the same weights (no near-tie among these draws), output
    within 2e-4 relative, aux within 1e-6, and the card's call bitwise
    repeatable (the combine has no atomics)."""
    from repro_torch.models import moe

    cfg = get_arch("deepseek-moe-16b", "full")
    gen = torch.Generator().manual_seed(4)
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    x = torch.randn((2, 256, d), generator=gen)
    w = [torch.randn(shape, generator=gen) * shape[-2] ** -0.5
         for shape in ((d, e), (e, d, f), (e, d, f), (e, f, d))]
    y_c, aux_c = moe.moe_ffn(x, *w, cfg)
    w_g, x_g = [t.to(cuda) for t in w], x.to(cuda)
    y, aux = moe.moe_ffn(x_g, *w_g, cfg)
    y2, aux2 = moe.moe_ffn(x_g, *w_g, cfg)
    assert torch.equal(y, y2) and torch.equal(aux, aux2)
    _, idx, _ = moe.route_topk(x_g, w_g[0], cfg.top_k)
    _, idx_c, _ = moe.route_topk(x, w[0], cfg.top_k)
    assert torch.equal(idx.cpu(), idx_c)
    cap = moe.expert_capacity(256, cfg, 1.25)
    drop = moe.dispatch_plan(idx, e, cap)["pos"] >= cap
    drop_c = moe.dispatch_plan(idx_c, e, cap)["pos"] >= cap
    assert torch.equal(drop.cpu(), drop_c) and bool(drop_c.any())
    assert _rel(y.cpu(), y_c) <= 2e-4
    assert float(aux) == pytest.approx(float(aux_c), rel=1e-6)


def test_moe_and_hybrid_engine_launches_gmsa_score_once_per_slot(cuda):
    """A deepseek-moe-16b and a hymba-1.5b class (smoke executes) with
    ``dispatch="kernel"``: one ``gmsa_score`` launch per slot, one
    ``ssd_scan`` launch per hymba layer per executed batch, every drained
    job run."""
    from repro_torch.launch.serve import build_engine

    eng = build_engine(["deepseek-moe-16b", "hymba-1.5b"], slots=6, v=1.0, seed=3, arrival=4.0,
                       dispatch="kernel", device=cuda)
    batches = {rc.name: [] for rc in eng.classes}
    for rc in eng.classes:
        pre = eng._prefill[rc.name]

        def counted(params, tokens, name=rc.name, pre=pre):
            batches[name].append(tokens.shape[0])
            return pre(params, tokens)

        eng._prefill[rc.name] = counted
    score0, ssd0 = gmsa_score_cuda.launches, ssd_scan_cuda.launches
    out = eng.run(execute_real=True)
    assert gmsa_score_cuda.launches == score0 + 6
    hymba = eng.classes[1].cfg
    assert ssd_scan_cuda.launches - ssd0 == hymba.num_layers * len(batches["hymba-1.5b"])
    want = sum(min(int(round(c)), eng.fcfg.exec_cap) for c in out["completed"].reshape(-1))
    assert out["exec_jobs"] == want > 0 and len(batches["deepseek-moe-16b"]) > 0
    serve_bench.check_conservation(out)
