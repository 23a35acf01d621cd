"""The port's MoE family against the JAX package's.

``repro_torch.models.moe`` against ``repro.models.moe`` piece by piece on
seeded-numpy inputs (capacity, routing, one row's dispatch, ``moe_ffn`` at
B > 1), then both MoE smoke configs (``deepseek-moe-16b``: 8 routed + 2
shared experts, top-3; ``phi3.5-moe-42b-a6.6b``: 4 experts, top-2) end to
end on bridged JAX weights: ``forward`` logits with the summed aux,
``prefill_step``, and ``decode_step`` against JAX's decode from bridged
caches (MoE decode is not prefill-consistent once prefill drops pairs,
which is why the reference asserts only finiteness; JAX's own decode is
the oracle). Every test that dispatches makes pairs drop, and says so.
Then the full configs' counts, the bridge's MoE leaves, and
``FleetEngine`` with a MoE class against the reference engine.

Tolerances:
* exact: capacities, the stable sort's ``dest`` / ``token_src``, the kept
  and dropped pairs, the packed buffers (copies), counts, names, shapes;
* expert indices: equal except on a near-tie — a token whose JAX router
  probabilities have two neighbours among its top k + 1 within TOPK_TIE =
  1e-6 (fp32 softmax of the same logits in another order differs by a few
  ulps of 1);
* gates and aux: FP32_TOL = 1e-6 (the same fp32 softmax and sums; aux
  relative);
* one MoE layer's output: LAYER_TOL = 1e-5 (expert products of width 128 /
  96 / 192 in another reduction order, the combine's k-sum against the
  reference's scatter-add);
* model logits: MODEL_TOL = 2e-4 (tests/test_models.py's decode-parity
  tolerance: two fp32 layers of attention, experts and norms).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch import configs as TC
from repro_torch.bridge import cache_from_numpy, lm_params_from_numpy
from repro_torch.models import lm, moe
from repro_torch.serve.step import make_local_exec
from test_torch_serve import T, _compare
from test_torch_serve_dense import _engine_pair

torch.set_float32_matmul_precision("highest")

MOE = ["deepseek-moe-16b", "phi3.5-moe-42b-a6.6b"]
FULL_COUNTS = {"deepseek-moe-16b": (16_879_568_896, 2_830_747_648),
               "phi3.5-moe-42b-a6.6b": (41_873_051_648, 6_640_898_048)}
TOPK_TIE = 1e-6
FP32_TOL = 1e-6
LAYER_TOL = 1e-5
MODEL_TOL = 2e-4


def _np(x):
    return np.asarray(x, np.float32)


def _cfgs(arch, variant="smoke", **change):
    return (dataclasses.replace(JC.get_arch(arch, variant), **change),
            dataclasses.replace(TC.get_arch(arch, variant), **change))


def _off_tie_index_mismatches(idx, idx_j, probs_j, k):
    """Tokens whose expert indices differ although no two of the JAX
    probabilities among their top k + 1 lie within TOPK_TIE."""
    idx, idx_j = np.asarray(idx).reshape(-1, k), np.asarray(idx_j).reshape(-1, k)
    top = -np.sort(-np.asarray(probs_j).reshape(idx.shape[0], -1), axis=-1)[:, :k + 1]
    near = (np.abs(np.diff(top, axis=-1)) <= TOPK_TIE).any(axis=-1)
    return int(((idx != idx_j).any(axis=-1) & ~near).sum())


def _router_inputs(seed, b, s, d, e, skew=0.0):
    """Unit-normal tokens and a router scaled like the init; ``skew`` adds
    a bias column pull so a few experts draw more than their share."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    w = (rng.standard_normal((d, e)) * d ** -0.5).astype(np.float32)
    w[:, :2] += skew * x.mean(axis=(0, 1))[:, None]
    return x, w


def _expert_weights(seed, e, d, f):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * shape[1] ** -0.5).astype(np.float32)
            for shape in ((e, d, f), (e, d, f), (e, f, d))]


# ---------------------------------------------------------------------------
# Capacity, routing, dispatch, the MoE layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["full", "smoke"])
@pytest.mark.parametrize("arch", MOE)
def test_expert_capacity_matches_jax_on_an_s_grid(arch, variant):
    """Exactly the reference's C on S = 1..2048 (63 and 64 around the
    rounding switch) and capacity factors where ``int(raw + 0.999)`` and
    ``ceil`` part ways."""
    cfg_j, cfg = _cfgs(arch, variant)
    for s in (1, 2, 7, 24, 32, 40, 63, 64, 65, 80, 127, 128, 256, 1000, 2048):
        for factor in (0.5, 1.0, 1.25, 2.0):
            assert moe.expert_capacity(s, cfg, factor) == jmoe.expert_capacity(s, cfg_j, factor)
    if variant == "full":
        want = {"deepseek-moe-16b": [1, 4, 8, 240], "phi3.5-moe-42b-a6.6b": [1, 5, 16, 320]}[arch]
        assert [moe.expert_capacity(s, cfg, 1.25) for s in (1, 32, 64, 2048)] == want
    # raw = 0.0009 above an integer: the reference's rounding keeps the integer.
    one = dataclasses.replace(cfg, top_k=1, num_experts=1)
    assert moe.expert_capacity(1, one, 3.0009) == 3 == jmoe.expert_capacity(
        1, dataclasses.replace(cfg_j, top_k=1, num_experts=1), 3.0009)


@pytest.mark.parametrize("s,e,k", [(1, 8, 3), (40, 8, 3), (96, 64, 6), (80, 4, 2)])
def test_route_topk_matches_jax(s, e, k):
    x, w = _router_inputs(s * e + k, 1, s, 128, e)
    gates_j, idx_j, aux_j = jmoe.route_topk(jnp.asarray(x[0]), jnp.asarray(w), k)
    gates, idx, aux = moe.route_topk(torch.from_numpy(x[0]), torch.from_numpy(w), k)
    assert idx.dtype == torch.int64 and tuple(idx.shape) == (s, k) and aux.shape == ()
    probs_j = jax.nn.softmax(jnp.asarray(x[0]) @ jnp.asarray(w), axis=-1)
    assert _off_tie_index_mismatches(idx, idx_j, probs_j, k) == 0
    np.testing.assert_allclose(gates.numpy(), _np(gates_j), rtol=FP32_TOL, atol=FP32_TOL)
    assert float(aux) == pytest.approx(float(aux_j), rel=FP32_TOL)
    # Batched over rows: each row routed on its own, one aux per row.
    xb = np.stack([x[0], x[0][::-1].copy()])
    gates_b, idx_b, aux_b = moe.route_topk(torch.from_numpy(xb), torch.from_numpy(w), k)
    assert tuple(aux_b.shape) == (2,) and torch.equal(idx_b[0], idx)
    assert torch.equal(idx_b[1], idx.flip(0)) and float(aux_b[1]) == pytest.approx(float(aux))


def test_route_topk_ties_go_to_the_lower_index_as_in_jax():
    """Duplicated router columns give exactly equal probabilities: both
    sides pick the lower expert index first (jax.lax.top_k's rule)."""
    x, w = _router_inputs(7, 1, 16, 32, 6)
    w[:, 3] = w[:, 1]
    w[:, 5] = w[:, 4]
    gates_j, idx_j, _ = jmoe.route_topk(jnp.asarray(x[0]), jnp.asarray(w), 4)
    gates, idx, _ = moe.route_topk(torch.from_numpy(x[0]), torch.from_numpy(w), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    both = 0
    for row in idx.tolist():
        for lo, hi in ((1, 3), (4, 5)):
            if lo in row and hi in row:
                both += 1
                assert row.index(lo) < row.index(hi)
    assert both > 0, "some token must pick both experts of a tied pair"
    np.testing.assert_allclose(gates.numpy(), _np(gates_j), rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("s,e,k,factor", [(96, 8, 3, 1.25), (40, 8, 3, 1.25), (24, 4, 2, 0.5)])
def test_dispatch_one_row_matches_jax_with_drops(s, e, k, factor):
    """The same kept and dropped pairs, the same ``dest`` (rounded C at
    S >= 64; S < 64 with a skewed router or a small factor forcing drops),
    the same packed buffers, token sources and weights."""
    cfg_j, cfg = _cfgs("deepseek-moe-16b", num_experts=e, top_k=k)
    cap = moe.expert_capacity(s, cfg, factor)
    x, w = _router_inputs(s + e, 1, s, 64, e, skew=3.0)
    gates_j, idx_j, _ = jmoe.route_topk(jnp.asarray(x[0]), jnp.asarray(w), k)
    buf_j, dest_j, src_j, wt_j = jmoe._dispatch_one_row(jnp.asarray(x[0]), gates_j, idx_j, e, cap)
    # The same routing on both sides (checked above): dispatch from JAX's.
    buf, dest, src, wt = moe._dispatch_one_row(
        torch.from_numpy(x[0]), torch.from_numpy(np.array(gates_j, np.float32)),
        torch.from_numpy(np.asarray(idx_j).astype(np.int64)), e, cap)
    np.testing.assert_array_equal(dest.numpy(), np.asarray(dest_j))
    np.testing.assert_array_equal(src.numpy(), np.asarray(src_j))
    np.testing.assert_array_equal(wt.numpy(), _np(wt_j))
    np.testing.assert_array_equal(buf.numpy(), _np(buf_j))
    dropped = dest.numpy() >= e * cap
    assert dropped.any() and not dropped.all(), "the case must drop some pairs and keep some"
    assert tuple(buf.shape) == (e, cap, 64)


@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_matches_jax_at_batch_three_with_drops(arch):
    """``moe_ffn`` on (3, 40, 128): each row routed and packed on its own
    (C = 19 / 25, skewed router: pairs drop), the experts run once on every
    row's buffers; output to LAYER_TOL, aux (the rows' mean) to fp32."""
    cfg_j, cfg = _cfgs(arch)
    e, f = cfg.num_experts, cfg.moe_d_ff
    x, w = _router_inputs(11, 3, 40, cfg.d_model, e, skew=2.0)
    wg, wu, wd = _expert_weights(12, e, cfg.d_model, f)
    y_j, aux_j = jmoe.moe_ffn(*map(jnp.asarray, (x, w, wg, wu, wd)), cfg_j)
    y, aux = moe.moe_ffn(*map(torch.from_numpy, (x, w, wg, wu, wd)), cfg)
    assert tuple(y.shape) == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), _np(y_j), rtol=LAYER_TOL, atol=LAYER_TOL)
    assert float(aux) == pytest.approx(float(aux_j), rel=FP32_TOL)
    _, idx, _ = moe.route_topk(torch.from_numpy(x), torch.from_numpy(w), cfg.top_k)
    cap = moe.expert_capacity(40, cfg, 1.25)
    plan = moe.dispatch_plan(idx, e, cap)
    assert bool((plan["pos"] >= cap).any()), "the case must drop pairs"
    # One row at a time through the same function: the batch changes nothing.
    for row in range(3):
        y_r, _ = moe.moe_ffn(*map(torch.from_numpy, (x[row:row + 1], w, wg, wu, wd)), cfg)
        torch.testing.assert_close(y_r[0], y[row], rtol=LAYER_TOL, atol=LAYER_TOL)


# ---------------------------------------------------------------------------
# The MoE smoke models end to end on bridged weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=MOE)
def model(request):
    """(arch, cfg_j, params_j, cfg, bridged params, tokens (2, 84))."""
    cfg_j, cfg = _cfgs(request.param)
    p_j = jlm.init_params(jax.random.key(0), cfg_j, jnp.float32)
    p = lm_params_from_numpy(jax.tree.map(np.asarray, p_j), cfg, device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 84))
    return request.param, cfg_j, p_j, cfg, p, tokens


@pytest.fixture
def drops(monkeypatch):
    """Count the pairs every MoE dispatch of the test drops."""
    seen = {"dropped": 0, "calls": 0}
    plan_fn = moe.dispatch_plan

    def counting(idx, num_experts, cap):
        plan = plan_fn(idx, num_experts, cap)
        seen["dropped"] += int((plan["pos"] >= cap).sum())
        seen["calls"] += 1
        return plan

    monkeypatch.setattr(moe, "dispatch_plan", counting)
    return seen


@pytest.mark.parametrize("s", [80, 24])
def test_forward_logits_and_summed_aux_match_jax(model, drops, s):
    """S = 80 (C rounded to a multiple of 8) and S = 24 (C unrounded);
    both drop pairs on these weights. Blockwise and naive attention."""
    arch, cfg_j, p_j, cfg, p, tokens = model
    for impl in ("blockwise", "naive"):
        logits_j, aux_j = jlm.forward(p_j, cfg_j, jnp.asarray(tokens[:, :s]), attn_impl=impl)
        logits, aux = lm.forward(p, cfg, torch.from_numpy(tokens[:, :s]), attn_impl=impl)
        assert tuple(logits.shape) == (2, s, lm.padded_vocab(cfg))
        np.testing.assert_allclose(logits.numpy(), _np(logits_j), rtol=MODEL_TOL, atol=MODEL_TOL,
                                   err_msg=f"{arch} {impl}")
        assert aux.shape == () and float(aux) > 0.0
        assert float(aux) == pytest.approx(float(aux_j), rel=FP32_TOL)
    assert drops["calls"] == 2 * cfg.num_layers and drops["dropped"] > 0


@pytest.mark.parametrize("uniform_pos", [True, False])
def test_prefill_and_decode_match_jax_decode_on_bridged_caches(model, drops, uniform_pos):
    """Prefill (pairs dropped) with a ring of S + 8 slots: logits and KV
    leaves; then four decode steps from the port's own cache and from the
    bridged JAX cache, both against JAX's decode."""
    arch, cfg_j, p_j, cfg, p, tokens = model
    s = 72
    last_j, cache_j = jlm.prefill_step(p_j, cfg_j, jnp.asarray(tokens[:, :s]),
                                       cache_dtype=jnp.float32, cache_len=s + 8)
    last, cache = lm.prefill_step(p, cfg, torch.from_numpy(tokens[:, :s]),
                                  cache_dtype=torch.float32, cache_len=s + 8)
    assert drops["dropped"] > 0
    np.testing.assert_allclose(last.numpy(), _np(last_j), rtol=MODEL_TOL, atol=MODEL_TOL)
    assert set(cache) == set(cache_j) == {"k", "v", "pos"}
    for leaf in ("k", "v"):
        np.testing.assert_allclose(cache[leaf].numpy(), _np(cache_j[leaf]), rtol=MODEL_TOL,
                                   atol=MODEL_TOL, err_msg=leaf)
    bridged = cache_from_numpy(jax.tree.map(np.asarray, cache_j), cfg, device="cpu")
    for i in range(4):
        tok = tokens[:, s + i:s + i + 1]
        logits_j, cache_j = jlm.decode_step(p_j, cfg_j, cache_j, jnp.asarray(tok),
                                            uniform_pos=uniform_pos)
        logits, cache = lm.decode_step(p, cfg, cache, torch.from_numpy(tok),
                                       uniform_pos=uniform_pos)
        from_j, bridged = lm.decode_step(p, cfg, bridged, torch.from_numpy(tok),
                                         uniform_pos=uniform_pos)
        for got in (logits, from_j):
            np.testing.assert_allclose(got.numpy(), _np(logits_j), rtol=MODEL_TOL,
                                       atol=MODEL_TOL, err_msg=f"decode {i}")
    assert cache["pos"].tolist() == [s + 4, s + 4] == bridged["pos"].tolist()


def test_make_local_exec_matches_jax(model):
    """The serving pair as FleetEngine._execute_jobs drives it (32-token
    prompts: C = 12 / 16 unrounded, pairs drop), greedy tokens equal off
    near-ties of the JAX logits."""
    from repro.serve.step import make_local_exec as jax_make_local_exec

    arch, cfg_j, p_j, cfg, p, tokens = model
    gen_len = 3
    pre_j, dec_j = jax_make_local_exec(cfg_j, gen_len)
    pre, dec = make_local_exec(cfg, gen_len, device="cpu")
    logits_j, cache_j = pre_j(p_j, jnp.asarray(tokens[:, :32]))
    logits, cache = pre(p, torch.from_numpy(tokens[:, :32]))
    for step in range(gen_len):
        np.testing.assert_allclose(logits.numpy(), _np(logits_j), rtol=MODEL_TOL,
                                   atol=MODEL_TOL, err_msg=f"step {step}")
        lj = _np(logits_j[:, -1, :cfg.vocab_size])
        tok = torch.argmax(logits[:, -1:, :cfg.vocab_size], dim=-1)
        for row, (a, b) in enumerate(zip(tok[:, 0].tolist(), lj.argmax(axis=-1).tolist())):
            assert a == b or abs(lj[row, a] - lj[row, b]) <= MODEL_TOL, (step, row)
        logits_j, cache_j = dec_j(p_j, cache_j, jnp.asarray(tok.numpy(), jnp.int32))
        logits, cache = dec(p, cache, tok)


# ---------------------------------------------------------------------------
# Counts, init, the bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["full", "smoke"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_config_specs_and_counts_match_jax(arch, variant):
    cfg_j, cfg = _cfgs(arch, variant)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
    assert lm.layer_param_specs(cfg) == jlm.layer_param_specs(cfg_j)
    assert lm.top_param_specs(cfg) == jlm.top_param_specs(cfg_j)
    assert "w_gate" not in lm.layer_param_specs(cfg)          # experts, not a dense FFN
    assert lm.count_params(cfg) == jlm.count_params(cfg_j) == cfg.param_count()
    assert cfg.active_param_count() == jlm.count_params(cfg_j, active_only=True)
    if variant == "full":
        assert (cfg.param_count(), cfg.active_param_count()) == FULL_COUNTS[arch]


@pytest.mark.parametrize("arch", MOE)
def test_init_params_expert_leaves_match_jax(arch):
    cfg_j, cfg = _cfgs(arch)
    p_j = jlm.init_params(jax.random.key(0), cfg_j, jnp.float32)
    p = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert set(p["blocks"]) == set(p_j["blocks"])
    for name, leaf in p["blocks"].items():
        assert tuple(leaf.shape) == tuple(p_j["blocks"][name].shape), name
    assert sum(v.numel() for v in p["blocks"].values()) + sum(
        v.numel() for k, v in p.items() if k != "blocks") == lm.count_params(cfg)
    std = cfg.d_model ** -0.5
    assert abs(float(p["blocks"]["we_gate"].std()) / (0.986593 * std) - 1.0) < 0.05


@pytest.mark.parametrize("arch", MOE)
def test_bridge_carries_and_checks_expert_leaves(arch):
    cfg_j, cfg = _cfgs(arch)
    tree = jax.tree.map(np.asarray, jlm.init_params(jax.random.key(3), cfg_j, jnp.float32))
    p = lm_params_from_numpy(tree, cfg, device="cpu")
    for name in ("router", "we_gate", "we_up", "we_down") + (
            ("ws_gate", "ws_up", "ws_down") if cfg.num_shared_experts else ()):
        np.testing.assert_array_equal(p["blocks"][name].numpy(), tree["blocks"][name])
    missing = dict(tree, blocks={k: v for k, v in tree["blocks"].items() if k != "we_up"})
    with pytest.raises(ValueError, match="we_up"):
        lm_params_from_numpy(missing, cfg, device="cpu")
    bad = dict(tree, blocks=dict(tree["blocks"], router=tree["blocks"]["router"][:, :, :1]))
    with pytest.raises(ValueError, match="router"):
        lm_params_from_numpy(bad, cfg, device="cpu")
    dense = dict(tree, blocks=dict(tree["blocks"], w_gate=tree["blocks"]["we_gate"][:, 0]))
    with pytest.raises(ValueError, match="w_gate"):
        lm_params_from_numpy(dense, cfg, device="cpu")


# ---------------------------------------------------------------------------
# Serving a MoE class
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dispatch", ["staged", "kernel"])
def test_moe_class_engine_matches_reference_with_real_execution(dispatch):
    """``FleetEngine`` with a deepseek-moe-16b class (priced on the full
    model's 2,830,747,648 active params) against the reference engine:
    tests/test_torch_serve.py's ``_compare`` over every slot, the same
    ``exec_jobs``, every drained job prefilled and decoded through the
    port's MoE path."""
    arch = "deepseek-moe-16b"
    jeng, teng = _engine_pair(dispatch, arch)
    rc = teng.classes[0]
    assert "we_gate" in teng.params[arch]["blocks"]
    assert rc.energy_per_job_j() == jeng.classes[0].energy_per_job_j()
    assert rc.kv_gb() == jeng.classes[0].kv_gb()
    jout = jeng.run(execute_real=True)
    tout = teng.run(execute_real=True)
    assert _compare(teng, tout, jout) == T
    assert tout["exec_jobs"] == jout["exec_jobs"] > 0 and tout["exec_seconds"] > 0.0
