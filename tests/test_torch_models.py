"""The port's Mamba-2 model path against the JAX package's.

Layers (``ssd_chunked``, ``ssd_step``, the causal convs, ``rms_norm``) on
the same seeded-numpy inputs; param specs, counts and init distributions;
then the smoke config end to end on bridged JAX weights: ``forward``, the
prefill cache, four ``decode_step``s and ``make_local_exec``'s pair. The
port's prefill reaches the SSD through ``ssd_scan`` (its plain sequential
version on the CPU), the JAX model through the pure-JAX ``ssd_chunked``.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import lm as jlm
from repro.models.layers import rms_norm as jax_rms_norm
from repro.models.layers import trunc_normal as jax_trunc_normal
from repro.models.ssm import causal_conv as jax_causal_conv
from repro.models.ssm import causal_conv_update as jax_causal_conv_update
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro.models.ssm import ssd_step as jax_ssd_step
from repro.serve.step import make_local_exec as jax_make_local_exec
from repro_torch import configs as TC
from repro_torch.bridge import cache_from_numpy, lm_params_from_numpy
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
from repro_torch.models import lm
from repro_torch.models.inputs import make_batch, make_decode_tokens
from repro_torch.models.layers import rms_norm, trunc_normal
from repro_torch.models.ssm import causal_conv, causal_conv_update, ssd_chunked, ssd_step
from repro_torch.serve.step import make_local_exec

torch.set_float32_matmul_precision("highest")

ARCH = "mamba2-2.7b"
# Model outputs: tests/test_models.py's decode-parity tolerance (fp32, the
# chunked JAX scan against the port's sequential one, plus matmul order).
MODEL_TOL = 2e-4
# Single layers in fp32: only reduction order differs.
LAYER_TOL = 1e-5


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _ssd_inputs(seed, b, s, h, p, n):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, s, h, p)).astype(np.float32),
        np.logaddexp(0.0, rng.standard_normal((b, s, h))).astype(np.float32),
        -np.exp(rng.standard_normal(h)).astype(np.float32),
        rng.standard_normal((b, s, n)).astype(np.float32),
        rng.standard_normal((b, s, n)).astype(np.float32),
    )


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s,chunk", [(32, 8), (45, 16), (24, 24)])
def test_ssd_chunked_matches_jax(s, chunk, with_h0):
    b, h, p, n = 2, 3, 8, 16
    ops = _ssd_inputs(s * 10 + chunk, b, s, h, p, n)
    h0 = np.random.default_rng(1).standard_normal((b, h, p, n)).astype(np.float32)
    kw_j = {"h0": jnp.asarray(h0)} if with_h0 else {}
    kw_t = {"h0": _t(h0)} if with_h0 else {}
    y_j, h_j = jax_ssd_chunked(*(jnp.asarray(v) for v in ops), chunk, **kw_j)
    y, hf = ssd_chunked(*(_t(v) for v in ops), chunk, **kw_t)
    assert tuple(y.shape) == (b, s, h, p) and tuple(hf.shape) == (b, h, p, n)
    # Sums of up to 32 terms of unit-normal products: 1e-4 (fp32 order).
    np.testing.assert_allclose(y.numpy(), _np(y_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(hf.numpy(), _np(h_j), rtol=1e-4, atol=1e-4)


def test_ssd_step_matches_jax():
    rng = np.random.default_rng(4)
    b, h, p, n = 3, 4, 8, 16
    x, dt, a, bv, cv = (v[:, 0] if v.ndim > 1 else v for v in _ssd_inputs(4, b, 1, h, p, n))
    state = rng.standard_normal((b, h, p, n)).astype(np.float32)
    y_j, s_j = jax_ssd_step(*(jnp.asarray(v) for v in (x, dt, a, bv, cv, state)))
    y, st = ssd_step(*(_t(v) for v in (x, dt, a, bv, cv, state)))
    np.testing.assert_allclose(y.numpy(), _np(y_j), rtol=LAYER_TOL, atol=LAYER_TOL)
    np.testing.assert_allclose(st.numpy(), _np(s_j), rtol=LAYER_TOL, atol=LAYER_TOL)


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 19, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    out_j = jax_causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    out = causal_conv(_t(x), _t(w), _t(bias))
    np.testing.assert_allclose(out.numpy(), _np(out_j), rtol=LAYER_TOL, atol=LAYER_TOL)
    # Causal: a change at position t moves no output before t.
    x2 = x.copy()
    x2[:, 10] += 1.0
    out2 = causal_conv(_t(x2), _t(w), _t(bias))
    assert torch.equal(out2[:, :10], out[:, :10])


def test_causal_conv_update_matches_jax_and_the_full_conv():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    bias = rng.standard_normal(12).astype(np.float32)
    state = x[:, 5:8]
    out_j, st_j = jax_causal_conv_update(*(jnp.asarray(v) for v in (state, x[:, 8], w, bias)))
    out, st = causal_conv_update(*(_t(v) for v in (state, x[:, 8], w, bias)))
    np.testing.assert_allclose(out.numpy(), _np(out_j), rtol=LAYER_TOL, atol=LAYER_TOL)
    np.testing.assert_allclose(st.numpy(), _np(st_j))
    full = causal_conv(_t(x), _t(w), _t(bias))
    np.testing.assert_allclose(out.numpy(), full[:, 8].numpy(), rtol=LAYER_TOL, atol=LAYER_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal((3, 5, 64)) * 3.0).astype(dtype)
    scale = jnp.asarray(rng.standard_normal(64)).astype(dtype)
    out_j = jax_rms_norm(x, scale, 1e-5)
    tt = lambda v: torch.from_numpy(np.array(v.astype(jnp.float32))).to(getattr(torch, dtype))
    out = rms_norm(tt(x), tt(scale), 1e-5)
    assert out.dtype == getattr(torch, dtype)
    # fp32 statistics on both sides; bf16 output rounding may differ by one ulp.
    tol = LAYER_TOL if dtype == "float32" else 1e-2
    np.testing.assert_allclose(out.float().numpy(), _np(out_j.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_trunc_normal_distribution_matches_jax():
    """Same law, different draws: std (0.98659·fan_in^-0.5 for a ±3σ cut)
    within 1% on 2^18 samples, support within ±3σ, mean near 0."""
    fan_in = 64
    std = fan_in ** -0.5
    z = trunc_normal(torch.Generator().manual_seed(0), (512, 512), fan_in, torch.float32)
    z_j = _np(jax_trunc_normal(jax.random.key(0), (512, 512), fan_in, jnp.float32))
    want = 0.986593 * std
    for sample in (z.numpy(), z_j):
        assert abs(sample.std() / want - 1.0) < 0.01
        assert np.abs(sample).max() <= 3.0 * std * (1 + 1e-6)
        assert abs(sample.mean()) < 0.01 * std


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trunc_normal_in_place_draws_bitwise_the_out_of_place_ones(dtype):
    """The in-place draw (one buffer per leaf) gives bitwise the values of
    the earlier out-of-place form, a second erfinv buffer, on the same
    generator state — a stacked expert leaf included."""
    shape, fan_in = (3, 4, 96, 40), 96

    def out_of_place(gen):
        lo = 0.5 * (1.0 + math.erf(-3.0 / math.sqrt(2.0)))
        u = torch.rand(shape, generator=gen, dtype=torch.float32)
        z = torch.erfinv(u.mul_(2.0 * (1.0 - 2.0 * lo)).add_(2.0 * lo - 1.0))
        z.mul_(math.sqrt(2.0)).clamp_(-3.0, 3.0)
        return z.mul_(fan_in ** -0.5).to(getattr(torch, dtype))

    got = trunc_normal(torch.Generator().manual_seed(5), shape, fan_in, getattr(torch, dtype))
    want = out_of_place(torch.Generator().manual_seed(5))
    assert got.dtype == want.dtype and torch.equal(got.view(torch.uint8), want.view(torch.uint8))


# ---------------------------------------------------------------------------
# Configs, specs, counts, init
# ---------------------------------------------------------------------------

def test_registry_has_mamba2_only_and_names_it():
    """The registry holds the JAX package's ten architectures: mamba2-2.7b,
    the four dense GQA decoders, the two MoE decoders, the hybrid and the
    two frontend backbones; an unknown id raises KeyError naming what there
    is."""
    dense = ["granite-3-2b", "phi4-mini-3.8b", "qwen2-0.5b", "stablelm-12b"]
    moe_hybrid = ["deepseek-moe-16b", "phi3.5-moe-42b-a6.6b", "hymba-1.5b"]
    frontends = ["hubert-xlarge", "internvl2-76b"]
    assert TC.list_archs() == sorted(dense + moe_hybrid + frontends + [ARCH]) == JC.list_archs()
    with pytest.raises(KeyError, match=ARCH):
        TC.get_arch("no-such-arch")


@pytest.mark.parametrize("variant", ["full", "smoke"])
def test_config_specs_and_count_match_jax(variant):
    cfg, cfg_j = TC.get_arch(ARCH, variant), JC.get_arch(ARCH, variant)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
    assert lm.layer_param_specs(cfg) == jlm.layer_param_specs(cfg_j)
    assert lm.top_param_specs(cfg) == jlm.top_param_specs(cfg_j)
    assert lm.padded_vocab(cfg) == jlm.padded_vocab(cfg_j)
    assert lm.count_params(cfg) == jlm.count_params(cfg_j) == cfg.param_count()
    if variant == "full":
        assert cfg.param_count() == 2_702_640_640
        assert lm.padded_vocab(cfg) == 50304 and cfg.ssm_heads == 80


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_leaves_match_jax(dtype):
    cfg = TC.get_arch(ARCH, "smoke")
    p_j = jlm.init_params(jax.random.key(0), JC.get_arch(ARCH, "smoke"), getattr(jnp, dtype))
    p = lm.init_params(cfg, torch.Generator().manual_seed(0), getattr(torch, dtype), device="cpu")
    flat_j = {"/".join(str(k.key) for k in path): leaf
              for path, leaf in jax.tree_util.tree_leaves_with_path(p_j)}
    flat = {k: v for k, v in p.items() if k != "blocks"}
    flat.update({f"blocks/{k}": v for k, v in p["blocks"].items()})
    assert set(flat) == set(flat_j)
    for name, leaf in flat.items():
        assert tuple(leaf.shape) == tuple(flat_j[name].shape), name
        assert str(leaf.dtype).removeprefix("torch.") == str(flat_j[name].dtype), name
    assert sum(v.numel() for v in flat.values()) == lm.count_params(cfg)
    # The bridge carries the JAX tree over in its dtype, bf16 included.
    bridged = lm_params_from_numpy(jax.tree.map(np.asarray, p_j), cfg, device="cpu")
    assert bridged["blocks"]["w_x"].dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(
        bridged["blocks"]["w_x"].float().numpy(), _np(p_j["blocks"]["w_x"].astype(jnp.float32)))


def test_init_params_distributions():
    """a_log = log U[1, 16]; softplus(dt_bias) in [1e-3, 0.1]; weights
    trunc-normal with std within 2% of 0.98659·fan_in^-0.5; norms ones,
    conv biases zeros."""
    cfg = dataclasses.replace(TC.get_arch(ARCH, "smoke"), num_layers=16)
    p = lm.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    blk = p["blocks"]
    a_log = blk["a_log"]
    assert a_log.dtype == torch.float32
    assert float(a_log.min()) >= 0.0 and float(a_log.max()) <= math.log(16.0)
    dt = torch.nn.functional.softplus(blk["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5) and float(dt.max()) <= 0.1 * (1 + 1e-5)
    for name, fan in (("w_x", cfg.d_model), ("ssm_out", cfg.d_inner)):
        w = blk[name]
        std = fan ** -0.5
        assert abs(float(w.std()) / (0.986593 * std) - 1.0) < 0.02, name
        assert float(w.abs().max()) <= 3.0 * std * (1 + 1e-6), name
    assert bool((blk["ln_ssm"] == 1).all()) and bool((blk["conv_x_b"] == 0).all())
    assert bool((p["final_norm"] == 1).all())


# ---------------------------------------------------------------------------
# The smoke model end to end on bridged weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    cfg_j = JC.get_arch(ARCH, "smoke")
    cfg = TC.get_arch(ARCH, "smoke")
    p_j = jlm.init_params(jax.random.key(0), cfg_j, jnp.float32)
    p = lm_params_from_numpy(jax.tree.map(np.asarray, p_j), cfg, device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 45))
    return cfg_j, p_j, cfg, p, tokens


@pytest.mark.parametrize("s", [24, 40])   # chunk = min(32, s): 24 whole, 40 ragged
def test_forward_logits_match_jax(smoke, s):
    cfg_j, p_j, cfg, p, tokens = smoke
    logits_j, aux_j = jlm.forward(p_j, cfg_j, jnp.asarray(tokens[:, :s]))
    logits, aux = lm.forward(p, cfg, torch.from_numpy(tokens[:, :s]))
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (2, s, 512)
    np.testing.assert_allclose(logits.numpy(), _np(logits_j), rtol=MODEL_TOL, atol=MODEL_TOL)
    assert float(aux) == float(aux_j) == 0.0


def test_prefill_cache_and_decode_steps_match_jax(smoke):
    cfg_j, p_j, cfg, p, tokens = smoke
    s = 24
    last_j, cache_j = jlm.prefill_step(p_j, cfg_j, jnp.asarray(tokens[:, :s]),
                                       cache_dtype=jnp.float32, cache_len=s + 8)
    last, cache = lm.prefill_step(p, cfg, torch.from_numpy(tokens[:, :s]),
                                  cache_dtype=torch.float32, cache_len=s + 8)
    np.testing.assert_allclose(last.numpy(), _np(last_j), rtol=MODEL_TOL, atol=MODEL_TOL)
    assert set(cache) == set(cache_j)
    assert cache["pos"].dtype == torch.int32 and cache["pos"].tolist() == [s, s]
    for name in ("ssm_state", "conv_state"):
        assert tuple(cache[name].shape) == tuple(cache_j[name].shape)
        np.testing.assert_allclose(cache[name].numpy(), _np(cache_j[name]),
                                   rtol=MODEL_TOL, atol=MODEL_TOL)
    for i in range(4):
        tok = tokens[:, s + i:s + i + 1]
        logits_j, cache_j = jlm.decode_step(p_j, cfg_j, cache_j, jnp.asarray(tok))
        logits, cache = lm.decode_step(p, cfg, cache, torch.from_numpy(tok))
        np.testing.assert_allclose(logits.numpy(), _np(logits_j), rtol=MODEL_TOL, atol=MODEL_TOL)
        np.testing.assert_allclose(cache["ssm_state"].numpy(), _np(cache_j["ssm_state"]),
                                   rtol=MODEL_TOL, atol=MODEL_TOL)
    assert cache["pos"].tolist() == [s + 4, s + 4]


def test_decode_from_a_bridged_jax_cache_matches_jax(smoke):
    cfg_j, p_j, cfg, p, tokens = smoke
    _, cache_j = jlm.prefill_step(p_j, cfg_j, jnp.asarray(tokens[:, :30]),
                                  cache_dtype=jnp.float32)
    cache = cache_from_numpy(jax.tree.map(np.asarray, cache_j), cfg, device="cpu")
    logits_j, _ = jlm.decode_step(p_j, cfg_j, cache_j, jnp.asarray(tokens[:, 30:31]))
    logits, _ = lm.decode_step(p, cfg, cache, torch.from_numpy(tokens[:, 30:31]))
    np.testing.assert_allclose(logits.numpy(), _np(logits_j), rtol=MODEL_TOL, atol=MODEL_TOL)


def test_decode_matches_forward(smoke):
    """The port's own identity (tests/test_models.py's, for the port):
    prefill(t[:, :S]) + decode(t[:, S]) == forward(t[:, :S+1])[:, -1]."""
    _, _, cfg, p, tokens = smoke
    s = 40
    full, _ = lm.forward(p, cfg, torch.from_numpy(tokens[:, :s + 1]))
    _, cache = lm.prefill_step(p, cfg, torch.from_numpy(tokens[:, :s]), cache_dtype=torch.float32)
    step, _ = lm.decode_step(p, cfg, cache, torch.from_numpy(tokens[:, s:s + 1]))
    torch.testing.assert_close(step[:, 0], full[:, -1], rtol=MODEL_TOL, atol=MODEL_TOL)


def test_make_local_exec_matches_jax(smoke):
    """The serving pair as FleetEngine._execute_jobs drives it: prefill, then
    greedy decode; logits at each step and every greedy token agree."""
    cfg_j, p_j, cfg, p, tokens = smoke
    gen_len = 3
    pre_j, dec_j = jax_make_local_exec(cfg_j, gen_len)
    pre, dec = make_local_exec(cfg, gen_len, device="cpu")
    logits_j, cache_j = pre_j(p_j, jnp.asarray(tokens[:, :20]))
    logits, cache = pre(p, torch.from_numpy(tokens[:, :20]))
    assert cache["conv_state"].dtype == torch.float32
    for _ in range(gen_len):
        np.testing.assert_allclose(logits.numpy(), _np(logits_j), rtol=MODEL_TOL, atol=MODEL_TOL)
        tok_j = jnp.argmax(logits_j[:, -1:, :cfg.vocab_size], axis=-1)
        tok = torch.argmax(logits[:, -1:, :cfg.vocab_size], dim=-1)
        assert tok.tolist() == np.asarray(tok_j).tolist()
        logits_j, cache_j = dec_j(p_j, cache_j, tok_j.astype(jnp.int32))
        logits, cache = dec(p, cache, tok)
        assert not logits.requires_grad and logits.is_inference()


def test_prefill_on_the_cpu_launches_no_kernel(smoke):
    _, _, cfg, p, tokens = smoke
    before = ssd_scan_cuda.launches
    lm.prefill_step(p, cfg, torch.from_numpy(tokens[:, :24]))
    assert ssd_scan_cuda.launches == before


def test_inputs_make_token_batches():
    cfg = TC.get_arch(ARCH, "smoke")
    gen = torch.Generator().manual_seed(0)
    batch = make_batch(cfg, ShapeConfig("p", "prefill", 16, 3), gen, device="cpu")
    assert set(batch) == {"tokens"} and tuple(batch["tokens"].shape) == (3, 16)
    train = make_batch(cfg, ShapeConfig("t", "train", 8, 2), gen, device="cpu")
    assert set(train) == {"tokens", "labels", "loss_mask"}
    tok = make_decode_tokens(cfg, ShapeConfig("d", "decode", 64, 5), gen, device="cpu")
    assert tuple(tok.shape) == (5, 1)
    for t in (batch["tokens"], train["labels"], tok):
        assert int(t.min()) >= 0 and int(t.max()) < cfg.vocab_size


# ---------------------------------------------------------------------------
# Contracts: device rule, families, bridge checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["init_params", "init_cache", "make_local_exec",
                                   "make_batch", "bridge"])
def test_device_none_means_cuda_and_raises_without_it(entry, smoke):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: device=None resolves to it")
    cfg_j, p_j, cfg, _, _ = smoke
    calls = {
        "init_params": lambda: lm.init_params(cfg, torch.Generator()),
        "init_cache": lambda: lm.init_cache(cfg, 2, 16),
        "make_local_exec": lambda: make_local_exec(cfg, 4),
        "make_batch": lambda: make_batch(cfg, ShapeConfig("p", "prefill", 8, 2),
                                         torch.Generator()),
        "bridge": lambda: lm_params_from_numpy(jax.tree.map(np.asarray, p_j), cfg),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


@pytest.mark.parametrize("change", [
    {"num_heads": 4, "num_kv_heads": 4}, {"num_experts": 4, "top_k": 2, "moe_d_ff": 64},
    {"hybrid": True, "num_heads": 4, "num_kv_heads": 4}, {"d_ff": 256}, {"frontend": "vision"},
    {"ssm_state": 0},
])
def test_other_model_families_raise_not_implemented(change):
    """No family raises any more: every change builds, counts (total and
    active) as the JAX package does, make_local_exec takes it and a
    forward gives finite logits; only a MoE config has a router aux. The
    MoE case gives the SSM smoke model experts of width 64 (its d_ff is 0);
    the hybrid case gives it attention heads to mix with. The frontend case
    (a vision stub on the SSM smoke model) carries the frontend leaves, and
    on bridged JAX weights its prefix forward and make_local_exec's token
    prefill and decode match the JAX package's within MODEL_TOL."""
    cfg = dataclasses.replace(TC.get_arch(ARCH, "smoke"), **change)
    cfg_j = dataclasses.replace(JC.get_arch(ARCH, "smoke"), **change)
    assert lm.count_params(cfg) == jlm.count_params(cfg_j)
    assert lm.count_params(cfg, active_only=True) == jlm.count_params(cfg_j, active_only=True)
    make_local_exec(cfg, 4, device="cpu")
    p = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    logits, aux = lm.forward(p, cfg, torch.zeros((1, 8), dtype=torch.int64))
    assert tuple(logits.shape) == (1, 8, 512) and bool(torch.isfinite(logits).all())
    assert bool(torch.isfinite(aux)) and (float(aux) > 0.0) == cfg.is_moe
    if not cfg.frontend:
        return
    assert set(lm.top_param_specs(cfg)) - set(lm.top_param_specs(TC.get_arch(ARCH, "smoke"))) \
        == {"frontend_proj", "frontend_norm"}
    p_j = jlm.init_params(jax.random.key(0), cfg_j, jnp.float32)
    p = lm_params_from_numpy(jax.tree.map(np.asarray, p_j), cfg, device="cpu")
    rng = np.random.default_rng(4)
    pre = (0.02 * rng.standard_normal((2, 6, 1024))).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (2, 10))
    logits_j, _ = jlm.forward(p_j, cfg_j, jnp.asarray(tokens), prefix_embeds=jnp.asarray(pre))
    logits, _ = lm.forward(p, cfg, torch.from_numpy(tokens), prefix_embeds=torch.from_numpy(pre))
    assert tuple(logits.shape) == (2, 16, 512)
    np.testing.assert_allclose(logits.numpy(), _np(logits_j), rtol=MODEL_TOL, atol=MODEL_TOL)
    pre_j, dec_j = jax_make_local_exec(cfg_j, 4)
    pre_t, dec_t = make_local_exec(cfg, 4, device="cpu")
    (lj, cj), (lt, ct) = pre_j(p_j, jnp.asarray(tokens)), pre_t(p, torch.from_numpy(tokens))
    np.testing.assert_allclose(lt.numpy(), _np(lj), rtol=MODEL_TOL, atol=MODEL_TOL)
    tok = torch.argmax(lt[:, -1:, :cfg.vocab_size], dim=-1)
    lj, _ = dec_j(p_j, cj, jnp.asarray(tok.numpy(), jnp.int32))
    lt, _ = dec_t(p, ct, tok)
    np.testing.assert_allclose(lt.numpy(), _np(lj), rtol=MODEL_TOL, atol=MODEL_TOL)


def test_bridge_rejects_missing_extra_and_misshaped_leaves(smoke):
    _, p_j, cfg, _, _ = smoke
    tree = jax.tree.map(np.asarray, p_j)
    missing = dict(tree, blocks={k: v for k, v in tree["blocks"].items() if k != "a_log"})
    with pytest.raises(ValueError, match="a_log"):
        lm_params_from_numpy(missing, cfg, device="cpu")
    with pytest.raises(ValueError, match="lm_head"):
        lm_params_from_numpy(dict(tree, lm_head=tree["embed"].T), cfg, device="cpu")
    bad = dict(tree, blocks=dict(tree["blocks"], w_x=tree["blocks"]["w_x"][:, :, :8]))
    with pytest.raises(ValueError, match="w_x"):
        lm_params_from_numpy(bad, cfg, device="cpu")
    with pytest.raises(TypeError, match="np.asarray"):
        lm_params_from_numpy(dict(tree, embed=p_j["embed"]), cfg, device="cpu")
