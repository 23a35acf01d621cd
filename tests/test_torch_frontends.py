"""The port's modality-frontend backbones against the JAX package's.

The audio encoder ``hubert-xlarge`` (GELU, LayerNorm, non-causal, 512-dim
frame stubs in place of tokens) and the vision-language decoder
``internvl2-76b`` (256 1024-dim patch stubs in front of the text): the stub
constants and ``frontend_spec``; the configs field for field, full and
smoke; the ``frontend_proj`` / ``frontend_norm`` leaves and exact counts;
the cell policy (``shape_applicable``, ``applicable_shapes``) for every
registered architecture and shape; ``make_batch``'s stub batches; then both
smoke models end to end on bridged JAX weights — ``forward`` (blockwise and
naive; hubert's 70 frames pad to a 1024-key chunk with no causal mask to
hide the padding), ``prefill_step`` with a vision prefix (its logits and KV
ring, ``pos`` counting the prefix), decode from the port's own cache and
from the bridged JAX cache against JAX's ``decode_step``, a ring shorter
than the prefix + text (eviction), bf16 stubs cast before the projection,
and ``prefix_embeds`` ignored without a frontend.

Tolerances:
* MODEL_TOL = 2e-4 (tests/test_models.py's decode-parity tolerance, as in
  tests/test_torch_dense.py): two fp32 layers of matmuls, attention and
  norms in another reduction order; logits are O(1..10). The stubs are fp32
  numpy on both sides, as tests/test_models.py passes
  ``embed_dtype=jnp.float32``;
* BF16_TOL = 2e-4 on bf16 stubs: both sides cast the same bf16 values to
  fp32 before the projection (exactly), so only fp32 order differs;
* STUB_STD_TOL = 0.05 relative, on the sample std of ``make_batch``'s 0.02 ·
  N(0, 1) stubs (≥ 64 k draws: the std's own relative error is ≈ 0.003);
* exact: constants, fields, names, shapes, dtypes, counts, the cell policy,
  ``pos``, greedy tokens off near-ties.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import frontends as jfrontends
from repro.models import inputs as jinputs
from repro.models import lm as jlm
from repro_torch import configs as TC
from repro_torch.bridge import cache_from_numpy, lm_params_from_numpy
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.models import frontends, lm
from repro_torch.models.inputs import make_batch

torch.set_float32_matmul_precision("highest")

FRONTENDS = {"hubert-xlarge": 946_241_280, "internvl2-76b": 70_562_103_296}
MODEL_TOL = 2e-4
BF16_TOL = 2e-4
STUB_STD_TOL = 0.05


def _np(x):
    return np.asarray(x, np.float32)


def _cfgs(arch, variant="smoke", **change):
    return (dataclasses.replace(JC.get_arch(arch, variant), **change),
            dataclasses.replace(TC.get_arch(arch, variant), **change))


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=tol, atol=tol, err_msg=what)


def _stubs(seed, b, n, dim):
    return (0.02 * np.random.default_rng(seed).standard_normal((b, n, dim))).astype(np.float32)


@pytest.fixture(scope="module", params=list(FRONTENDS))
def model(request):
    """(cfg_j, params_j, cfg, bridged params, prefix stubs, tokens or None):
    hubert 2 x 70 frames; internvl2 2 x 12 patches + 2 x 36 tokens (room
    for decode steps after a 30-token prompt)."""
    cfg_j, cfg = _cfgs(request.param)
    p_j = jlm.init_params(jax.random.key(0), cfg_j, jnp.float32)
    # Give frontend_norm values other than 1, so a dropped norm shows.
    p_j["frontend_norm"] = jnp.asarray(
        np.random.default_rng(9).uniform(0.5, 1.5, p_j["frontend_norm"].shape).astype(np.float32))
    p = lm_params_from_numpy(jax.tree.map(np.asarray, p_j), cfg, device="cpu")
    if cfg.frontend == "audio":
        return cfg_j, p_j, cfg, p, _stubs(1, 2, 70, frontends.AUDIO_STUB_DIM), None
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 36))
    return cfg_j, p_j, cfg, p, _stubs(1, 2, 12, frontends.VISION_STUB_DIM), tokens


def _run(fn, p, cfg, tokens, pre, **kw):
    """Call the port's ``fn`` (or JAX's, on jnp inputs) with optional tokens."""
    if fn in (jlm.forward, jlm.prefill_step):
        return fn(p, cfg, None if tokens is None else jnp.asarray(tokens),
                  prefix_embeds=None if pre is None else jnp.asarray(pre), **kw)
    return fn(p, cfg, None if tokens is None else torch.from_numpy(tokens),
              prefix_embeds=None if pre is None else torch.from_numpy(pre), **kw)


# ---------------------------------------------------------------------------
# Stubs, configs, specs, counts, the cell policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["vision", "audio", "", "speech"])
@pytest.mark.parametrize("seq_len", [64, 4096])
def test_stub_constants_and_frontend_spec_match_jax(kind, seq_len):
    for name in ("VISION_STUB_DIM", "VISION_TOKENS", "AUDIO_STUB_DIM"):
        assert getattr(frontends, name) == getattr(jfrontends, name), name
    got, want = frontends.frontend_spec(kind, seq_len), jfrontends.frontend_spec(kind, seq_len)
    assert (got is None) == (want is None) == (kind not in ("vision", "audio"))
    if got is not None:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("variant", ["full", "smoke"])
@pytest.mark.parametrize("arch", list(FRONTENDS))
def test_frontend_config_specs_and_counts_match_jax(arch, variant):
    cfg_j, cfg = _cfgs(arch, variant)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
    assert lm.top_param_specs(cfg) == jlm.top_param_specs(cfg_j)
    assert lm.layer_param_specs(cfg) == jlm.layer_param_specs(cfg_j)
    stub = {"audio": 512, "vision": 1024}[cfg.frontend]
    specs = lm.top_param_specs(cfg)
    assert specs["frontend_proj"] == ((stub, cfg.d_model), stub, "normal")
    assert specs["frontend_norm"] == ((cfg.d_model,), 0, "ones")
    assert lm.count_params(cfg) == jlm.count_params(cfg_j) == cfg.param_count()
    assert cfg.active_param_count() == cfg.param_count()
    if variant == "full":
        assert cfg.param_count() == FRONTENDS[arch]
        # 8 of internvl2's 80 layers, as chip_smoke.py's phase 17 runs it.
        cut = dataclasses.replace(cfg, num_layers=8)
        assert lm.count_params(cut) == jlm.count_params(dataclasses.replace(cfg_j, num_layers=8))


@pytest.mark.parametrize("arch", JC.list_archs())
def test_shape_applicable_matches_jax_for_every_arch_and_shape(arch):
    cfg, cfg_j = TC.get_arch(arch), JC.get_arch(arch)
    for name, shape in SHAPES.items():
        assert TC.shape_applicable(cfg, shape) == JC.shape_applicable(cfg_j, JC.SHAPES[name])
    assert [s.name for s in TC.applicable_shapes(cfg)] == \
           [s.name for s in JC.applicable_shapes(cfg_j)]
    if arch == "hubert-xlarge":
        assert [s.kind for s in TC.applicable_shapes(cfg)] == ["train", "prefill"]
        assert TC.shape_applicable(cfg, SHAPES["decode_32k"])[1].startswith("encoder-only")


# ---------------------------------------------------------------------------
# make_batch's stubs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("seq_len", [4096, 300, 9])
@pytest.mark.parametrize("arch", list(FRONTENDS))
def test_make_batch_stub_keys_shapes_and_dtypes_match_jax(arch, seq_len, kind):
    """Keys and shapes as JAX's ``as_spec`` batch (S // 2 < 256 at 300 and
    9); dtypes too, except token ids and labels: int64 (torch's index type)
    where JAX has int32. Stubs bf16 by default, fp32 on request."""
    cfg_j, cfg = _cfgs(arch, "full" if seq_len == 4096 else "smoke")
    shape = ShapeConfig("c", kind, seq_len, 2)
    want = jinputs.make_batch(cfg_j, JC.ShapeConfig("c", kind, seq_len, 2), as_spec=True)
    got = make_batch(cfg, shape, torch.Generator().manual_seed(0), device="cpu")
    assert set(got) == set(want)
    for name, leaf in got.items():
        assert tuple(leaf.shape) == tuple(want[name].shape), name
        if name in ("tokens", "labels"):
            assert leaf.dtype == torch.int64
            assert 0 <= int(leaf.min()) and int(leaf.max()) < cfg.vocab_size
        else:
            assert str(leaf.dtype).split(".")[-1] == str(want[name].dtype), name
    if cfg.frontend == "vision":
        n_img = min(frontends.VISION_TOKENS, seq_len // 2)
        assert got["prefix_embeds"].shape[1] == n_img and got["tokens"].shape[1] == seq_len - n_img
    else:
        assert got["prefix_embeds"].shape[1] == seq_len and "tokens" not in got
    if kind == "train":
        assert bool((got["loss_mask"] == 1).all())
    f32 = make_batch(cfg, shape, torch.Generator().manual_seed(0), device="cpu",
                     embed_dtype=torch.float32)["prefix_embeds"]
    assert f32.dtype == torch.float32
    np.testing.assert_array_equal(f32.to(torch.bfloat16).float().numpy(),
                                  got["prefix_embeds"].float().numpy())


def test_make_batch_stubs_are_seeded_0_02_normal():
    cfg = TC.get_arch("hubert-xlarge", "smoke")
    shape = ShapeConfig("p", "prefill", 256, 1)
    a, b = (make_batch(cfg, shape, torch.Generator().manual_seed(5), device="cpu",
                       embed_dtype=torch.float32)["prefix_embeds"] for _ in range(2))
    assert torch.equal(a, b)
    std = float(a.std())
    assert abs(std / 0.02 - 1.0) < STUB_STD_TOL and abs(float(a.mean())) < 0.02 * STUB_STD_TOL


# ---------------------------------------------------------------------------
# The smoke models end to end on bridged weights
# ---------------------------------------------------------------------------

def test_init_params_and_bridge_carry_the_frontend_leaves(model):
    cfg_j, p_j, cfg, p, _, _ = model
    own = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert set(own) == set(p_j) == set(p)
    assert bool((own["frontend_norm"] == 1).all())
    stub = frontends.frontend_spec(cfg.frontend, 0).stub_dim
    assert tuple(own["frontend_proj"].shape) == (stub, cfg.d_model)
    np.testing.assert_array_equal(p["frontend_proj"].numpy(), np.asarray(p_j["frontend_proj"]))
    tree = jax.tree.map(np.asarray, p_j)
    with pytest.raises(ValueError, match="frontend_proj"):
        lm_params_from_numpy({k: v for k, v in tree.items() if k != "frontend_proj"}, cfg,
                             device="cpu")


@pytest.mark.parametrize("impl", ["blockwise", "naive"])
def test_forward_with_prefix_matches_jax(model, impl):
    """hubert: frames only, no tokens (S = 70, non-causal, keys padded to
    1024); internvl2: 12 patches in front of 36 tokens (S = 48)."""
    cfg_j, p_j, cfg, p, pre, tokens = model
    logits_j, aux_j = _run(jlm.forward, p_j, cfg_j, tokens, pre, attn_impl=impl)
    logits, aux = _run(lm.forward, p, cfg, tokens, pre, attn_impl=impl)
    s = pre.shape[1] + (0 if tokens is None else tokens.shape[1])
    assert tuple(logits.shape) == (2, s, lm.padded_vocab(cfg)) and float(aux) == 0.0
    _close(logits, logits_j, MODEL_TOL, impl)


def test_bf16_stubs_are_cast_before_the_projection(model):
    cfg_j, p_j, cfg, p, pre, tokens = model
    pre16 = torch.from_numpy(pre).to(torch.bfloat16)
    logits_j, _ = jlm.forward(p_j, cfg_j, None if tokens is None else jnp.asarray(tokens),
                              prefix_embeds=jnp.asarray(pre16.float().numpy(), jnp.bfloat16))
    logits, _ = lm.forward(p, cfg, None if tokens is None else torch.from_numpy(tokens),
                           prefix_embeds=pre16)
    _close(logits, logits_j, BF16_TOL, "bf16 stubs")
    exact, _ = lm.forward(p, cfg, None if tokens is None else torch.from_numpy(tokens),
                          prefix_embeds=pre16.float())
    assert torch.equal(logits, exact)


def test_prefill_cache_and_decode_with_a_vision_prefix_match_jax():
    """12 patches + a 30-token prompt into a ring of 42 + 4 slots: the
    logits and every KV leaf against JAX's, ``pos`` 42 (the prefix counts);
    four decode steps from the port's own cache and from the bridged JAX
    cache against JAX's ``decode_step``."""
    cfg_j, cfg = _cfgs("internvl2-76b")
    p_j = jlm.init_params(jax.random.key(3), cfg_j, jnp.float32)
    p = lm_params_from_numpy(jax.tree.map(np.asarray, p_j), cfg, device="cpu")
    pre = _stubs(4, 2, 12, frontends.VISION_STUB_DIM)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 34))
    s, n_pre = 30, pre.shape[1]
    kw = dict(cache_dtype=jnp.float32, cache_len=n_pre + s + 4)
    last_j, cache_j = _run(jlm.prefill_step, p_j, cfg_j, tokens[:, :s], pre, **kw)
    last, cache = _run(lm.prefill_step, p, cfg, tokens[:, :s], pre,
                       cache_dtype=torch.float32, cache_len=n_pre + s + 4)
    _close(last, last_j, MODEL_TOL, "prefill logits")
    assert cache["pos"].tolist() == [n_pre + s] * 2 and cache["k"].shape[2] == n_pre + s + 4
    for leaf in ("k", "v"):
        _close(cache[leaf], cache_j[leaf], MODEL_TOL, f"prefill cache {leaf}")
    bridged = cache_from_numpy(jax.tree.map(np.asarray, cache_j), cfg, device="cpu")
    for i in range(4):
        tok = tokens[:, s + i:s + i + 1]
        logits_j, cache_j = jlm.decode_step(p_j, cfg_j, cache_j, jnp.asarray(tok))
        logits, cache = lm.decode_step(p, cfg, cache, torch.from_numpy(tok))
        from_j, bridged = lm.decode_step(p, cfg, bridged, torch.from_numpy(tok))
        _close(logits, logits_j, MODEL_TOL, f"decode {i}")
        _close(from_j, logits_j, MODEL_TOL, f"decode {i} from the bridged cache")
    assert cache["pos"].tolist() == [n_pre + s + 4] * 2


def test_prefill_plus_decode_matches_a_longer_forward_with_prefix(model):
    """prefill(prefix + t[:, :S]) + decode(t[:, S]) == forward(prefix +
    t[:, :S+1])[:, -1] for the vision model (the identity chip_smoke.py's
    phase 17 holds at full width); for the encoder, prefill's last logits
    equal forward's last position."""
    cfg_j, p_j, cfg, p, pre, tokens = model
    if tokens is None:
        last, cache = _run(lm.prefill_step, p, cfg, None, pre, cache_dtype=torch.float32)
        full, _ = _run(lm.forward, p, cfg, None, pre)
        torch.testing.assert_close(last[:, 0], full[:, -1], rtol=MODEL_TOL, atol=MODEL_TOL)
        assert cache["pos"].tolist() == [pre.shape[1]] * 2
        return
    s = 24
    full, _ = _run(lm.forward, p, cfg, tokens[:, :s + 1], pre, attn_impl="naive")
    _, cache = _run(lm.prefill_step, p, cfg, tokens[:, :s], pre, attn_impl="naive",
                    cache_dtype=torch.float32, cache_len=pre.shape[1] + s + 8)
    step, _ = lm.decode_step(p, cfg, cache, torch.from_numpy(tokens[:, s:s + 1]))
    torch.testing.assert_close(step[:, 0, :cfg.vocab_size], full[:, -1, :cfg.vocab_size],
                               rtol=MODEL_TOL, atol=MODEL_TOL)


def test_a_ring_shorter_than_prefix_and_text_evicts_as_jax():
    """cache_len 32 < 12 + 30: the ring keeps the last 32 positions (the
    whole prefix evicted); two decode steps match JAX's from the same ring."""
    cfg_j, cfg = _cfgs("internvl2-76b")
    p_j = jlm.init_params(jax.random.key(6), cfg_j, jnp.float32)
    p = lm_params_from_numpy(jax.tree.map(np.asarray, p_j), cfg, device="cpu")
    pre = _stubs(7, 2, 12, frontends.VISION_STUB_DIM)
    tokens = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 32))
    last_j, cache_j = _run(jlm.prefill_step, p_j, cfg_j, tokens[:, :30], pre,
                           cache_dtype=jnp.float32, cache_len=32)
    last, cache = _run(lm.prefill_step, p, cfg, tokens[:, :30], pre,
                       cache_dtype=torch.float32, cache_len=32)
    assert cache["k"].shape[2] == 32 and cache["pos"].tolist() == [42, 42]
    _close(last, last_j, MODEL_TOL, "prefill logits")
    _close(cache["k"], cache_j["k"], MODEL_TOL, "ring k")
    for i in (30, 31):
        tok = tokens[:, i:i + 1]
        logits_j, cache_j = jlm.decode_step(p_j, cfg_j, cache_j, jnp.asarray(tok))
        logits, cache = lm.decode_step(p, cfg, cache, torch.from_numpy(tok))
        _close(logits, logits_j, MODEL_TOL, f"decode at {i}")


def test_prefix_embeds_are_ignored_without_a_frontend_and_needed_without_tokens():
    cfg_j, cfg = _cfgs("qwen2-0.5b")
    p_j = jlm.init_params(jax.random.key(0), cfg_j, jnp.float32)
    p = lm_params_from_numpy(jax.tree.map(np.asarray, p_j), cfg, device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16))
    pre = _stubs(2, 2, 4, frontends.VISION_STUB_DIM)
    plain, _ = lm.forward(p, cfg, torch.from_numpy(tokens))
    with_pre, _ = lm.forward(p, cfg, torch.from_numpy(tokens), prefix_embeds=torch.from_numpy(pre))
    logits_j, _ = jlm.forward(p_j, cfg_j, jnp.asarray(tokens), prefix_embeds=jnp.asarray(pre))
    assert torch.equal(plain, with_pre) and tuple(plain.shape) == tuple(logits_j.shape)
    _close(with_pre, logits_j, MODEL_TOL, "prefix ignored")
    with pytest.raises(ValueError, match="no tokens"):
        lm.forward(p, cfg, None, prefix_embeds=torch.from_numpy(pre))
