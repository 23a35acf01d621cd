"""The port's substrate (``repro_torch.distributed``, the chunked Monte-Carlo
entry points, the pod train step, the sharded serving steps) against the JAX
package and against itself, on the CPU.

* The sharding rules against ``repro.distributed.sharding`` for every
  registered arch, at ("data", "model") and ("pod", "data", "model") axes of
  sizes 1, 2 and 16: equal specs leaf by leaf (``tuple(PartitionSpec)``)
  and equal replication fallbacks. Pure rules: exact.
* The int8 cross-pod sum and ``sync_tree`` against the reference run under
  ``shard_map`` on 2 and 4 XLA host devices, and the pod train step against
  the reference's ``make_train_step`` on a ("pod",) mesh of 2 host devices.
  The reference needs several host devices, which the XLA flag gives only to
  a process that sets it before JAX starts: one subprocess (with a timeout)
  runs every reference call and writes its results to an ``.npz``; it starts
  in the background when this file's first test begins.
* Runs chunking: each of the five Monte-Carlo entry points at chunk counts
  1, 2, 3 and R + 1 with R = 5 (2 and 3 do not divide it) against the
  unchunked call: every output leaf and every telemetry leaf bitwise.
* The sharded serving steps against the reference's on a one-device mesh.

Tolerances:

* Residuals and error feedback of the int8 sum: within ``RESID_TOL`` =
  2**-23 of the leaf's largest value, the fp32 rounding of the
  dequantized product: the reference is jitted, and XLA contracts
  ``rows - q * scale`` into one fused multiply-add where the port rounds
  the product first. The total: within ``SUM_TOL`` = 2e-6 of the leaf's
  largest value (the owned sum's products and adds contract alike, and at
  4 pods XLA may add the received rows in another order than the port's
  pod order).
* ``MODEL_TOL`` = 2e-4 (tests/test_models.py's model-level tolerance) for
  the train step and the serving steps: fp32 models whose matmuls sum in
  other orders.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.distributed import sharding as jsh
from repro.models import lm as jlm
from repro.serve import step as jserve
from repro_torch import configs as TC
from repro_torch.bridge import batch_from_numpy, lm_params_from_numpy
from repro_torch.configs.facebook_4dc import PaperSimConfig, make_sim_builder, site_bandwidths
from repro_torch.configs.fleet_256 import FleetConfig, make_fleet_builder, make_serve_grid
from repro_torch.core import baselines as tb
from repro_torch.core import gmsa as tg
from repro_torch.core.simulator import simulate_many
from repro_torch.core.sweep import sweep_grid, sweep_placed_budgets
from repro_torch.distributed import compression, sharding
from repro_torch.distributed.mesh import Mesh, runs_mesh, sharded_runs, take_runs
from repro_torch.jobs import (
    chain_dag,
    make_staged_policy,
    shuffle_volumes_from_selectivity,
    simulate_staged_many,
    stage_oblivious,
)
from repro_torch.models import lm
from repro_torch.placement import (
    PlacementConfig,
    make_adaptive_rule,
    simulate_placed_many,
    wan_topology,
)
from repro_torch.serve.step import make_decode_step, make_local_exec, make_prefill_step
from repro_torch.telemetry import HistogramSpec, TelemetryConfig
from repro_torch.telemetry.config import SUMMARY, TRACE
from repro_torch.traces.bandwidth import link_fault_trace
from repro_torch.traces.faults import health_trace
from repro_torch.traces.stages import staged_mix_profile
from repro_torch.train import AdamWConfig, TrainStepConfig, adamw_init, make_train_step
from repro_torch.train.optimizer import leaves

torch.set_float32_matmul_precision("highest")

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
MODEL_TOL = 2e-4
SUM_TOL = 2e-6
RESID_TOL = 2.0 ** -23
R = 5
CHUNKS = (1, 2, 3, R + 1)
REF_TIMEOUT = 300


# ---------------------------------------------------------------------------
# The reference's multi-device runs, in one background subprocess
# ---------------------------------------------------------------------------

#: Compression inputs: leaves whose sizes 2 and 4 divide or do not (7, 15).
COMP_SHAPES = {"a": (5, 3), "b": (7,), "c": (4, 4), "d": (3, 5)}
POD_BATCH = (4, 17)
POD_OPT = dict(lr=3e-3, total_steps=10, warmup_steps=2)

_REFERENCE_PROG = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, sys.argv[1])
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    import repro.configs as C
    from repro.distributed.compat import shard_map
    from repro.distributed.compression import compressed_psum_pod, sync_tree
    from repro.models import lm as jlm
    from repro.train.optimizer import AdamWConfig, adamw_init
    from repro.train.step import TrainStepConfig, make_train_step

    shapes = {SHAPES}
    out = {}
    for n in (2, 4):
        mesh = jax.make_mesh((n,), ("pod",), devices=jax.devices()[:n])
        rng = np.random.default_rng(n)
        g = {k: rng.standard_normal((n,) + s).astype(np.float32) for k, s in shapes.items()}
        e = {k: (0.01 * rng.standard_normal((n,) + s)).astype(np.float32)
             for k, s in shapes.items()}
        for k in shapes:
            out[f"in{n}_g_{k}"], out[f"in{n}_e_{k}"] = g[k], e[k]

        def one(leaf):
            total, resid = compressed_psum_pod(leaf[0], n, "pod")
            return total, resid[None]

        total, resid = jax.jit(shard_map(one, mesh=mesh, in_specs=P("pod"),
                                         out_specs=(P(), P("pod")), check_vma=False))(
            jnp.asarray(g["a"]))
        out[f"psum{n}_total"], out[f"psum{n}_resid"] = np.asarray(total), np.asarray(resid)

        def tree(gs, es):
            synced, resid = sync_tree({k: v[0] for k, v in gs.items()}, n, "pod",
                                      {k: v[0] for k, v in es.items()})
            return synced, {k: v[None] for k, v in resid.items()}

        spec = {k: P("pod") for k in shapes}
        synced, resid = jax.jit(shard_map(tree, mesh=mesh, in_specs=(spec, spec),
                                          out_specs=({k: P() for k in shapes}, spec),
                                          check_vma=False))(
            {k: jnp.asarray(v) for k, v in g.items()}, {k: jnp.asarray(v) for k, v in e.items()})
        for k in shapes:
            out[f"sync{n}_{k}"], out[f"efb{n}_{k}"] = np.asarray(synced[k]), np.asarray(resid[k])

    mesh = jax.make_mesh((2,), ("pod",), devices=jax.devices()[:2])
    cfg = C.get_arch("qwen2-0.5b", "smoke")
    params = jlm.init_params(jax.random.key(1), cfg, jnp.float32)
    rng = np.random.default_rng(7)
    b, s = {BATCH}
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
             "loss_mask": np.ones((b, s), np.float32)}
    batch["loss_mask"][0, :4] = 0.0
    for sync in ("native", "int8"):
        tcfg = TrainStepConfig(microbatches=2, remat="none", grad_sync=sync,
                               optimizer=AdamWConfig(**{OPT}))
        step, _, _, _, init_efb = make_train_step(cfg, mesh, tcfg)
        p2, o2, met, efb = jax.jit(step)(params, adamw_init(params),
                                         {k: jnp.asarray(v) for k, v in batch.items()},
                                         init_efb(params))
        for k, v in met.items():
            out[f"step_{sync}_met_{k}"] = np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(p2)[0]:
            out[f"step_{sync}_p_{jax.tree_util.keystr(path)}"] = np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(o2["m"])[0]:
            out[f"step_{sync}_m_{jax.tree_util.keystr(path)}"] = np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(efb)[0]:
            out[f"step_{sync}_efb_{jax.tree_util.keystr(path)}"] = np.asarray(v)
    np.savez(sys.argv[2], **out)
""").replace("{SHAPES}", repr(COMP_SHAPES)).replace("{BATCH}", repr(POD_BATCH)).replace(
    "{OPT}", repr(POD_OPT))


class _ReferenceRuns:
    """The reference subprocess, started once; ``result()`` waits for it."""

    def __init__(self, out: Path):
        self.out = out
        env = {**os.environ, "JAX_PLATFORMS": "cpu"}
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _REFERENCE_PROG, str(ROOT / "src"), str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
        self._data = None

    def result(self) -> dict:
        if self._data is None:
            try:
                log, _ = self.proc.communicate(timeout=REF_TIMEOUT)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.communicate()
                pytest.fail(f"the reference subprocess took over {REF_TIMEOUT} s")
            assert self.proc.returncode == 0, log.decode()[-4000:]
            self._data = dict(np.load(self.out))
        return self._data


@pytest.fixture(scope="module", autouse=True)
def reference_runs(tmp_path_factory):
    runs = _ReferenceRuns(tmp_path_factory.mktemp("reference") / "runs.npz")
    yield runs
    if runs.proc.poll() is None:
        runs.proc.kill()
        runs.proc.communicate()


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------

MESHES = [(("data", "model"), (s, s)) for s in (1, 2, 16)] + \
         [(("pod", "data", "model"), (s, s, s)) for s in (1, 2, 16)] + \
         [(("pod", "data", "model"), (2, 1, 16))]


def _jax_spec_tree(tree):
    if isinstance(tree, dict):
        return {k: _jax_spec_tree(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("names,sizes", MESHES, ids=lambda x: "x".join(map(str, x)))
@pytest.mark.parametrize("arch", JC.list_archs())
def test_sharding_rules_match_the_reference(arch, names, sizes):
    cfg_j, cfg = JC.get_arch(arch), TC.get_arch(arch)
    mesh = Mesh(sizes, names)
    stand_in = types.SimpleNamespace(shape=dict(zip(names, sizes)))
    log, log_j = {}, {}
    assert sharding.param_pspecs(cfg, mesh, log) == _jax_spec_tree(
        jsh.param_pspecs(cfg_j, stand_in, log_j))
    assert log == log_j
    if arch == "qwen2-0.5b" and sizes[-1] == 16:
        assert {"q_out", "kv_out"} <= set(log["replicated_fallbacks"])
    for batch in (1, 4, 6, 32):
        tree = {"tokens": jax.ShapeDtypeStruct((batch, 64), jnp.int32),
                "prefix_embeds": jax.ShapeDtypeStruct((batch, 8, 16), jnp.float32)}
        assert sharding.batch_pspecs(tree, mesh, batch) == _jax_spec_tree(
            jsh.batch_pspecs(tree, stand_in, batch))
        assert sharding.logits_pspec(cfg, mesh, batch) == tuple(
            jsh.logits_pspec(cfg_j, stand_in, batch))
        cache = jax.eval_shape(lambda: jlm.init_cache(cfg_j, batch, 256, jnp.float32))
        for kv in ("heads", "seq", "auto"):
            assert sharding.cache_pspecs(cache, cfg, mesh, batch, kv) == _jax_spec_tree(
                jsh.cache_pspecs(cache, cfg_j, stand_in, batch, kv)), kv
    assert sharding.resolve_kv_shard(cfg, mesh) == jsh.resolve_kv_shard(cfg_j, stand_in)
    assert sharding.axis_size(mesh, ("pod", "data")) == jsh.axis_size(stand_in, ("pod", "data"))
    for lax_name in ("vocab", "q_out", "kv_out", "mlp", "ssm_inner", "embed"):
        for size in (1, 2, 16):
            assert sharding._shardable(lax_name, cfg, size) == jsh._shardable(lax_name, cfg_j,
                                                                              size)


def test_mesh_and_runs_mesh_contracts():
    mesh = Mesh((2, 1, 16), ("pod", "data", "model"))
    assert mesh.shape == {"pod": 2, "data": 1, "model": 16}
    assert mesh.axis_names == ("pod", "data", "model")
    assert runs_mesh(7).shape == {"runs": 7}
    for bad in (lambda: Mesh((2,), ("a", "b")), lambda: Mesh((2, 2), ("a", "a")),
                lambda: Mesh((0,), ("a",)), lambda: runs_mesh(0)):
        with pytest.raises(ValueError):
            bad()
    with pytest.raises(ValueError, match="runs_mesh"):
        sharded_runs(lambda sel: torch.zeros(3), 3, mesh)
    # pad-and-slice: the chunks see the leading runs again, the result does not.
    seen = []

    def one(sel):
        seen.append(sel.tolist())
        return {"x": take_runs(torch.arange(5.0) * 10, sel), "y": (take_runs(torch.arange(5), sel),)}

    out = sharded_runs(one, 5, runs_mesh(3))
    assert seen == [[0, 1], [2, 3], [4, 0]]
    assert torch.equal(out["x"], torch.arange(5.0) * 10)
    assert torch.equal(out["y"][0], torch.arange(5))


# ---------------------------------------------------------------------------
# int8 cross-pod sum and sync_tree
# ---------------------------------------------------------------------------

def _assert_resid(got, want, leaf):
    np.testing.assert_allclose(got, want, rtol=0, atol=RESID_TOL * float(np.abs(leaf).max()))


def _assert_total(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=SUM_TOL * float(np.abs(want).max()))


@pytest.mark.parametrize("n", [2, 4])
def test_compressed_psum_pod_and_sync_tree_match_the_reference(reference_runs, n):
    ref = reference_runs.result()
    g = {k: torch.from_numpy(ref[f"in{n}_g_{k}"]) for k in COMP_SHAPES}
    e = {k: torch.from_numpy(ref[f"in{n}_e_{k}"]) for k in COMP_SHAPES}
    total, resid = compression.compressed_psum_pod(g["a"], n)
    assert total.shape == COMP_SHAPES["a"] and resid.shape == (n,) + COMP_SHAPES["a"]
    _assert_total(total.numpy(), ref[f"psum{n}_total"])
    _assert_resid(resid.numpy(), ref[f"psum{n}_resid"], g["a"].numpy())
    synced, efb = compression.sync_tree(g, n, e)
    for k in COMP_SHAPES:
        _assert_total(synced[k].numpy(), ref[f"sync{n}_{k}"])
        _assert_resid(efb[k].numpy(), ref[f"efb{n}_{k}"], (g[k] + e[k]).numpy())
    # The split form a train step uses is the same arithmetic.
    sent = [compression.quantize_pod(g["b"][p] + e["b"][p], n) for p in range(n)]
    split = compression.reduce_pods(torch.stack([s[0] for s in sent]),
                                    torch.stack([s[1] for s in sent]), COMP_SHAPES["b"],
                                    torch.float32) / n
    assert torch.equal(split, synced["b"])
    assert torch.equal(torch.stack([s[2] for s in sent]), efb["b"])
    with pytest.raises(ValueError, match="pod axis"):
        compression.compressed_psum_pod(g["a"], n + 1)


def test_quantize_rounds_half_to_even_and_keeps_zero_rows():
    q, scale = compression._quantize(torch.tensor([[127.0, 0.5, 1.5, -2.5], [0.0, 0.0, 0.0, 0.0]]))
    assert q.dtype == torch.int8
    assert q[0].tolist() == [127, 0, 2, -2] and q[1].tolist() == [0, 0, 0, 0]
    assert scale[1] == torch.tensor(1e-30) and float(scale[0]) == 1.0


# ---------------------------------------------------------------------------
# Runs chunking: the five entry points, bitwise at every chunk count
# ---------------------------------------------------------------------------

def _assert_tree_equal(got, want, what=""):
    if isinstance(want, torch.Tensor):
        assert got.shape == want.shape and torch.equal(got, want), what
    elif isinstance(want, dict):
        assert got.keys() == want.keys(), what
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, tuple):
        assert type(got) is type(want) and len(got) == len(want), what
        names = getattr(want, "_fields", range(len(want)))
        for name, a, b in zip(names, got, want):
            _assert_tree_equal(a, b, f"{what}.{name}")
    else:
        assert got == want, what


def _chunked(call, policy_consumes=False):
    """``call(mesh)`` at every chunk count against ``call(None)``."""
    want = call(None)
    for n in CHUNKS:
        if policy_consumes and n > 1:
            with pytest.raises(ValueError, match="consumes the generator"):
                call(runs_mesh(n))
            continue
        _assert_tree_equal(call(runs_mesh(n)), want, f"chunks={n}")
    return want


PAPER = PaperSimConfig(t_slots=48)
FLEET = FleetConfig(n_sites=16, k_types=3, t_slots=24)
gen = lambda seed=0: torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def paper_build():
    return make_sim_builder(PAPER, device=CPU)[1]


@pytest.fixture(scope="module")
def fleet_build():
    return make_fleet_builder(FLEET, device=CPU)[1]


@pytest.mark.parametrize("case", ["gmsa", "random", "per_run_v", "kernel_telemetry_health"])
def test_simulate_many_is_bitwise_at_every_chunk_count(paper_build, fleet_build, case):
    if case == "kernel_telemetry_health":
        health = health_trace(gen(4), FLEET.t_slots, FLEET.n_sites, device=CPU)
        tel = TelemetryConfig(level=SUMMARY, hist=HistogramSpec())
        call = lambda mesh: simulate_many(fleet_build, tg.make_kernel_policy(None), gen(), R,
                                          FLEET.v, health=health, device=CPU, telemetry=tel,
                                          mesh=mesh)
    else:
        policy = {"gmsa": tg.gmsa_policy, "random": tb.random_dispatch,
                  "per_run_v": tg.gmsa_policy}[case]
        v = torch.linspace(0.5, 50.0, R) if case == "per_run_v" else PAPER.v
        call = lambda mesh: simulate_many(paper_build, policy, gen(), R, v, device=CPU,
                                          mesh=mesh)
    want = _chunked(call)
    if case == "random":
        # the runs differ from each other: a draw per run, not a repeated one
        assert not torch.equal(want.f_trace[0], want.f_trace[1])


def test_simulate_many_refuses_a_state_dependent_generator_policy(paper_build):
    def coin(generator, q, arrivals, mu, e, aux, scalar):
        pick = torch.randint(0, q.shape[-2], arrivals.shape, generator=generator)
        return (torch.arange(q.shape[-2])[:, None] == pick.unsqueeze(-2)).float()

    _chunked(lambda mesh: simulate_many(paper_build, coin, gen(), R, device=CPU, mesh=mesh),
             policy_consumes=True)


@pytest.mark.parametrize("policy", ["kernel", "random"])
def test_sweep_grid_is_bitwise_at_every_chunk_count(fleet_build, policy):
    pol = tg.make_kernel_policy(None) if policy == "kernel" else tb.random_dispatch
    out = _chunked(lambda mesh: sweep_grid(fleet_build, pol, gen(), R, (0.1, 1.0, 50.0),
                                           device=CPU, mesh=mesh))
    assert out.f_trace.shape[:2] == (3, R)


@pytest.fixture(scope="module")
def staged_fleet(fleet_build):
    mask, compute, sel = staged_mix_profile(gen(11), FLEET.k_types, 3, min_stages=2, device=CPU)
    dag = chain_dag(compute, shuffle_volumes_from_selectivity(100.0, sel), mask)
    _, _, _, up, down, _, _ = make_serve_grid(FLEET, FLEET.k_types, FLEET.t_slots, device=CPU)
    return dag, wan_topology(up, down, energy_per_gb=0.03)


@pytest.mark.parametrize("arm", ["oblivious_kernel_degraded", "aware_hedged_telemetry",
                                 "random"])
def test_simulate_staged_many_is_bitwise_at_every_chunk_count(fleet_build, staged_fleet, arm):
    dag, wan = staged_fleet
    kw = {}
    if arm == "oblivious_kernel_degraded":
        pol = stage_oblivious(tg.make_kernel_policy(None), pin_map=True)
        kw["link_health"] = link_fault_trace(gen(6), FLEET.t_slots, FLEET.n_sites,
                                             degrade_prob=0.2, sever_frac=0.0, device=CPU)
        kw["health"] = health_trace(gen(5), FLEET.t_slots, FLEET.n_sites, device=CPU)
    elif arm == "aware_hedged_telemetry":
        pol = make_staged_policy(dag, wan, hedge=0.9)
        kw["telemetry"] = TelemetryConfig(level=TRACE, hist=HistogramSpec())
    else:
        pol = stage_oblivious(tb.random_dispatch)
    _chunked(lambda mesh: simulate_staged_many(fleet_build, dag, wan, pol, gen(), R, FLEET.v,
                                               device=CPU, mesh=mesh, **kw),
             policy_consumes=arm == "random")


@pytest.fixture(scope="module")
def placed():
    up, down = site_bandwidths(PAPER, device=CPU)
    cfg = PlacementConfig(epoch_slots=12, growth=0.25, manager_share=PAPER.manager_share,
                          map_share=PAPER.map_share)
    alive = torch.ones(PAPER.t_slots, 4)
    alive[20:, 2] = 0.0
    return up, down, cfg, alive, make_adaptive_rule(up)


@pytest.mark.parametrize("arm", ["kernel_fault_trace", "gmsa_degraded", "random"])
def test_simulate_placed_many_is_bitwise_at_every_chunk_count(paper_build, placed, arm):
    up, down, cfg, alive, rule = placed
    kw = {}
    if arm == "kernel_fault_trace":
        pol = tg.make_kernel_policy(None)
        kw = dict(alive=alive, telemetry=TelemetryConfig(level=TRACE, hist=HistogramSpec()))
    elif arm == "gmsa_degraded":
        pol = tg.dispatch_fn(PAPER.v)
        kw = dict(link_health=link_fault_trace(gen(8), PAPER.t_slots, 4, degrade_prob=0.2,
                                               sever_frac=0.0, device=CPU),
                  health=health_trace(gen(9), PAPER.t_slots, 4, device=CPU),
                  move_budget=torch.linspace(0.2, 1.0, R))
    else:
        pol = tb.random_dispatch
    _chunked(lambda mesh: simulate_placed_many(paper_build, up, down, pol, rule, gen(), R, cfg,
                                               scalar=PAPER.v, device=CPU, mesh=mesh, **kw),
             policy_consumes=arm == "random")


def test_sweep_placed_budgets_is_bitwise_at_every_chunk_count(paper_build, placed):
    up, down, cfg, alive, rule = placed
    out = _chunked(lambda mesh: sweep_placed_budgets(
        paper_build, up, down, tg.dispatch_fn(PAPER.v), rule, gen(), R, cfg, (0.25, 1.0),
        scalar=PAPER.v, alive=alive, device=CPU, mesh=mesh))
    assert out.f_trace.shape[:2] == (2, R)


# ---------------------------------------------------------------------------
# The pod train step
# ---------------------------------------------------------------------------

@pytest.fixture
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.detach().float().numpy() - want).max())
    assert err <= MODEL_TOL * scale, (what, err, scale)


def _named(tree):
    return {f"['{name}']" + ("" if sub is None else f"['{sub}']"): t.detach().numpy()
            for name, leaf in tree.items()
            for sub, t in (leaf.items() if isinstance(leaf, dict) else [(None, leaf)])}


@pytest.mark.usefixtures("_one_torch_thread")
@pytest.mark.parametrize("sync", ["native", "int8"])
def test_pod_train_step_matches_the_reference(reference_runs, sync):
    """One step of each path against the reference's. Loss and metrics at
    MODEL_TOL. The synced gradients (AdamW's first moment after one step),
    the params and the error feedback at MODEL_TOL of each leaf's scale,
    except at near-ties, which must be few (at most 1% of the params):

    * int8 rounding ties: a value within fp32 noise of a half-quantum
      rounds either way; the two residuals then sit at opposite half quanta
      (they sum to ~0) and the synced value moves by a quantum;
    * AdamW's first step moves an element by lr·g/(|g| + eps), ±lr whatever
      the gradient's size, so an element whose gradient is within 100·eps
      of 0 (and not 0) moves by an amount the summation noise decides: it
      may differ by up to 2·lr.
    """
    cfg_j, cfg = JC.get_arch("qwen2-0.5b", "smoke"), TC.get_arch("qwen2-0.5b", "smoke")
    p_j = jlm.init_params(jax.random.key(1), cfg_j, jnp.float32)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, p_j), cfg, device=CPU)
    rng = np.random.default_rng(7)
    b, s = POD_BATCH
    raw = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "loss_mask": np.ones((b, s), np.float32)}
    raw["loss_mask"][0, :4] = 0.0
    ocfg = AdamWConfig(**POD_OPT)
    step, init_efb = make_train_step(cfg, TrainStepConfig(
        microbatches=2, remat="full", grad_sync=sync, optimizer=ocfg), device=CPU,
        mesh=Mesh((2,), ("pod",)))
    efb = init_efb(params)
    if sync == "int8":
        assert all(e.shape == (2,) + p.shape and e.dtype == torch.float32
                   for e, p in zip(leaves(efb), leaves(params)))
    p2, st, met, efb2 = step(params, adamw_init(params), batch_from_numpy(raw, device=CPU), efb)
    ref = reference_runs.result()
    for k in ("loss", "ce", "z_loss", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(met[k]), float(ref[f"step_{sync}_met_{k}"]),
                                   rtol=MODEL_TOL, atol=MODEL_TOL * 1e-2, err_msg=k)
    got_p, got_m, got_e = _named(p2), _named(st["m"]), _named(efb2)
    assert {k[len(f"step_{sync}_p_"):] for k in ref if k.startswith(f"step_{sync}_p_")} == \
        got_p.keys()
    lr = float(met["lr"])
    n_ties = n_all = 0
    for key in got_p:
        m_ref = ref[f"step_{sync}_m_{key}"]
        ties = np.zeros(m_ref.shape, bool)
        if sync == "int8":
            e_ref, e = ref[f"step_int8_efb_{key}"], got_e[key]
            tol_e = MODEL_TOL * 254.0 * float(np.abs(e_ref).max())    # ~ the gradient's scale
            flip = (np.abs(e - e_ref) > tol_e) & (np.abs(e + e_ref) <= tol_e)
            ties = flip.any(axis=0)
            assert np.all(np.abs(e - e_ref)[~flip] <= tol_e), ("error feedback", key)
        off = ~ties
        assert np.all(np.abs(got_m[key] - m_ref)[off]
                      <= MODEL_TOL * float(np.abs(m_ref).max())), ("synced gradient", key)
        g_ref = m_ref / (1.0 - ocfg.b1)                             # the clipped gradient
        ties |= (g_ref != 0) & (np.abs(g_ref) <= 100.0 * ocfg.eps)
        n_ties, n_all = n_ties + int(ties.sum()), n_all + ties.size
        d = np.abs(got_p[key] - ref[f"step_{sync}_p_{key}"])
        assert np.all(d[~ties] <= MODEL_TOL * float(np.abs(ref[f"step_{sync}_p_{key}"]).max())), \
            ("params", key, float(d[~ties].max()))
        assert np.all(d[ties] <= 2.5 * lr), ("params at near-ties", key)
    assert n_ties <= 0.01 * n_all, ("near-ties", n_ties, n_all)
    if sync == "int8":
        assert any(float(np.abs(e).max()) > 0 for e in got_e.values())


def test_pod_mesh_refusals_and_the_native_path():
    cfg = TC.get_arch("qwen2-0.5b", "smoke")
    for sizes in ((2, 2), (1, 4)):
        with pytest.raises(NotImplementedError, match="one card"):
            make_train_step(cfg, TrainStepConfig(grad_sync="int8"), device=CPU,
                            mesh=Mesh(sizes, ("pod", "model") if sizes[0] == 2 else
                                      ("data", "model")))
    with pytest.raises(NotImplementedError, match="one card"):
        make_train_step(cfg, TrainStepConfig(), device=CPU, mesh=Mesh((2, 2), ("pod", "data")))
    step, init_efb = make_train_step(cfg, TrainStepConfig(grad_sync="int8"), device=CPU,
                                     mesh=Mesh((3,), ("pod",)))
    p = lm.init_params(cfg, gen(2), device=CPU)
    batch = batch_from_numpy({"tokens": np.zeros((4, 9), np.int32),
                              "labels": np.zeros((4, 9), np.int32),
                              "loss_mask": np.ones((4, 9), np.float32)}, device=CPU)
    with pytest.raises(ValueError, match="3 pods"):
        step(p, adamw_init(p), batch, init_efb(p))
    step, init_efb = make_train_step(cfg, TrainStepConfig(grad_sync="native"), device=CPU,
                                     mesh=Mesh((2,), ("pod",)))
    assert all(e.shape == () for e in leaves(init_efb(p)))


# ---------------------------------------------------------------------------
# The sharded serving steps at world size 1
# ---------------------------------------------------------------------------

def test_prefill_and_decode_steps_match_the_reference():
    cfg_j, cfg = JC.get_arch("qwen2-0.5b", "smoke"), TC.get_arch("qwen2-0.5b", "smoke")
    p_j = jlm.init_params(jax.random.key(3), cfg_j, jnp.float32)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, p_j), cfg, device=CPU)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    mesh = Mesh((1, 1), ("data", "model"))
    tok = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    fn_j, pspecs_j, sh_j = jserve.make_prefill_step(cfg_j, jmesh)
    fn, pspecs, sh = make_prefill_step(cfg, mesh, device=CPU)
    assert pspecs == _jax_spec_tree(pspecs_j) == sh({}, 2)[0]
    logits_j, cache_j = jax.jit(lambda p, t: fn_j(p, tokens=t))(p_j, jnp.asarray(tok))
    logits, cache = fn(params, tokens=torch.from_numpy(tok).long())
    assert cache["k"].dtype == torch.bfloat16 and cache["k"].shape == cache_j["k"].shape
    _close(logits, logits_j, "prefill logits")
    # The logits are the local executor's (only the cache's dtype and length differ).
    local, _ = make_local_exec(cfg, 4, device=CPU)[0](params, torch.from_numpy(tok).long())
    assert torch.equal(local, logits)
    bspecs = sh({"tokens": torch.empty(2, 24)}, 2)[1]
    assert bspecs == _jax_spec_tree(jax.tree.map(lambda x: tuple(x.spec), sh_j(
        {"tokens": jax.ShapeDtypeStruct((2, 24), jnp.int32)}, 2)[1]))
    cache_f32 = {k: (v.float() if v.is_floating_point() else v) for k, v in cache.items()}
    step_tok = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    outs = {}
    for kv in ("heads", "seq"):
        fn_j, _, dsh_j = jserve.make_decode_step(cfg_j, jmesh, kv_shard=kv)
        fn_d, _, dsh = make_decode_step(cfg, mesh, kv_shard=kv, device=CPU)
        cj = jax.tree.map(lambda x: jnp.asarray(x.numpy()), cache_f32)
        lj, _ = jax.jit(fn_j)(p_j, cj, jnp.asarray(step_tok))
        outs[kv], new = fn_d(params, cache_f32, torch.from_numpy(step_tok).long())
        _close(outs[kv], lj, f"decode logits {kv}")
        assert int(new["pos"][0]) == 25
        (ps, cs, ts), (ls, cs2) = dsh(cache_f32, 2)
        (ps_j, cs_j, ts_j), (ls_j, _) = dsh_j(cj, 2)
        assert ps == _jax_spec_tree(jax.tree.map(lambda x: tuple(x.spec), ps_j))
        assert cs == cs2 == _jax_spec_tree(jax.tree.map(lambda x: tuple(x.spec), cs_j))
        assert ts == tuple(ts_j.spec) and ls == tuple(ls_j.spec)
    assert torch.equal(outs["heads"], outs["seq"])
    with pytest.raises(ValueError, match="kv_shard"):
        lm.decode_step(params, cfg, cache_f32, torch.from_numpy(step_tok).long(), kv_shard="x")
