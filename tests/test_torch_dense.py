"""The port's dense attention models against the JAX package's.

The four dense GQA configs (``qwen2-0.5b``, ``granite-3-2b``,
``phi4-mini-3.8b``, ``stablelm-12b``): specs and exact parameter counts,
full and smoke; ``init_params`` leaves by name and shape; then the smoke
models end to end on bridged JAX weights — ``forward`` (blockwise and
naive), ``prefill_step``'s logits and KV ring, ``decode_step`` on both
``uniform_pos`` paths — for qwen2 (QKV bias, GQA), granite, stablelm (an
untied LM head), a GELU/LayerNorm non-causal variant and a sliding-window
variant whose ring wraps; the port's own prefill + decode identity; the
bridge's KV leaves; ``make_local_exec`` against the JAX pair; the device
rule.

Tolerances:
* MODEL_TOL = 2e-4 (tests/test_models.py's decode-parity tolerance): two
  fp32 layers of matmuls, attention and norms in another reduction order;
  logits are O(1..10);
* WINDOW_TOL = 3e-4 (tests/test_models.py's ring-decode tolerance);
* FP8_TOL = 2e-4 on logits after a float8 cache: both sides cast the same
  values to float8 (checked equal), so only fp32 order differs — unless a
  K/V value rounds differently at a float8 tie, which would show as a
  large difference;
* exact: counts, names, shapes, the ring's slot positions, greedy tokens
  (off near-ties: a token may differ only where the JAX logits of the two
  picks are within MODEL_TOL).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import inputs as jinputs
from repro.models import lm as jlm
from repro.serve.step import make_local_exec as jax_make_local_exec
from repro_torch import configs as TC
from repro_torch.bridge import cache_from_numpy, lm_params_from_numpy
from repro_torch.configs.base import SHAPES
from repro_torch.models import lm
from repro_torch.models.inputs import cache_spec
from repro_torch.serve.step import make_local_exec

torch.set_float32_matmul_precision("highest")

DENSE = ["qwen2-0.5b", "granite-3-2b", "phi4-mini-3.8b", "stablelm-12b"]
FULL_COUNTS = {"qwen2-0.5b": 494_032_768, "granite-3-2b": 2_533_787_648,
               "phi4-mini-3.8b": 3_836_021_760, "stablelm-12b": 12_142_924_800}
MODEL_TOL = 2e-4
WINDOW_TOL = 3e-4
FP8_TOL = 2e-4
#: Variants of the smoke configs the model tests run: name -> (arch, changes).
VARIANTS = {
    "qwen2": ("qwen2-0.5b", {}),
    "granite": ("granite-3-2b", {}),
    "stablelm": ("stablelm-12b", {}),
    "gelu_bidirectional": ("granite-3-2b", {"act": "gelu", "causal": False}),
    "window": ("granite-3-2b", {"sliding_window": 16}),
}


def _np(x):
    return np.asarray(x, np.float32)


def _cfgs(arch, variant="smoke", **change):
    return (dataclasses.replace(JC.get_arch(arch, variant), **change),
            dataclasses.replace(TC.get_arch(arch, variant), **change))


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=tol, atol=tol, err_msg=what)


@pytest.fixture(scope="module", params=list(VARIANTS))
def model(request):
    """(name, cfg_j, params_j, cfg, bridged params, tokens (2, 45))."""
    arch, change = VARIANTS[request.param]
    cfg_j, cfg = _cfgs(arch, **change)
    p_j = jlm.init_params(jax.random.key(0), cfg_j, jnp.float32)
    p = lm_params_from_numpy(jax.tree.map(np.asarray, p_j), cfg, device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 45))
    return request.param, cfg_j, p_j, cfg, p, tokens


# ---------------------------------------------------------------------------
# Configs, specs, counts, init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["full", "smoke"])
@pytest.mark.parametrize("arch", DENSE)
def test_dense_config_specs_and_counts_match_jax(arch, variant):
    cfg_j, cfg = _cfgs(arch, variant)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
    assert lm.layer_param_specs(cfg) == jlm.layer_param_specs(cfg_j)
    assert lm.top_param_specs(cfg) == jlm.top_param_specs(cfg_j)
    assert lm.padded_vocab(cfg) == jlm.padded_vocab(cfg_j)
    assert lm.count_params(cfg) == jlm.count_params(cfg_j) == cfg.param_count()
    assert cfg.active_param_count() == cfg.param_count()
    if variant == "full":
        assert cfg.param_count() == FULL_COUNTS[arch]


@pytest.mark.parametrize("name", list(VARIANTS))
def test_init_params_leaves_match_jax(name):
    arch, change = VARIANTS[name]
    cfg_j, cfg = _cfgs(arch, **change)
    p_j = jlm.init_params(jax.random.key(0), cfg_j, jnp.float32)
    p = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    flat_j = {"/".join(str(k.key) for k in path): leaf
              for path, leaf in jax.tree_util.tree_leaves_with_path(p_j)}
    flat = {k: v for k, v in p.items() if k != "blocks"}
    flat.update({f"blocks/{k}": v for k, v in p["blocks"].items()})
    assert set(flat) == set(flat_j)
    for key, leaf in flat.items():
        assert tuple(leaf.shape) == tuple(flat_j[key].shape), key
        assert leaf.dtype == torch.float32, key
    assert sum(v.numel() for v in flat.values()) == lm.count_params(cfg)
    blk = p["blocks"]
    std = cfg.d_model ** -0.5
    assert abs(float(blk["wq"].std()) / (0.986593 * std) - 1.0) < 0.05
    assert bool((blk["ln1"] == 1).all())
    if cfg.qkv_bias:
        assert bool((blk["bq"] == 0).all())


# ---------------------------------------------------------------------------
# The smoke models end to end on bridged weights
# ---------------------------------------------------------------------------

def test_forward_logits_match_jax(model):
    name, cfg_j, p_j, cfg, p, tokens = model
    tol = WINDOW_TOL if cfg.sliding_window else MODEL_TOL
    s = 40
    for impl in ("blockwise", "naive"):
        logits_j, _ = jlm.forward(p_j, cfg_j, jnp.asarray(tokens[:, :s]), attn_impl=impl)
        logits, aux = lm.forward(p, cfg, torch.from_numpy(tokens[:, :s]), attn_impl=impl)
        assert logits.dtype == torch.float32
        assert tuple(logits.shape) == (2, s, lm.padded_vocab(cfg)) and float(aux) == 0.0
        _close(logits, logits_j, tol, f"{name} {impl}")


@pytest.mark.parametrize("uniform_pos", [True, False])
def test_prefill_cache_and_decode_steps_match_jax(model, uniform_pos):
    """Prefill with a ring of S + 8 slots (S + 8 > window for the windowed
    variant: a window-sized ring that has wrapped), then four decode steps;
    logits and every cache leaf, the ring's garbage slots included."""
    name, cfg_j, p_j, cfg, p, tokens = model
    tol = WINDOW_TOL if cfg.sliding_window else MODEL_TOL
    s = 24
    last_j, cache_j = jlm.prefill_step(p_j, cfg_j, jnp.asarray(tokens[:, :s]),
                                       cache_dtype=jnp.float32, cache_len=s + 8)
    last, cache = lm.prefill_step(p, cfg, torch.from_numpy(tokens[:, :s]),
                                  cache_dtype=torch.float32, cache_len=s + 8)
    assert tuple(last.shape) == (2, 1, lm.padded_vocab(cfg))
    _close(last, last_j, tol, "prefill logits")
    assert set(cache) == set(cache_j) == {"k", "v", "pos"}
    sc = lm.cache_len_for(cfg, s + 8)
    assert tuple(cache["k"].shape) == tuple(cache_j["k"].shape) == (
        cfg.num_layers, 2, sc, cfg.num_kv_heads, cfg.resolved_head_dim)
    assert cache["pos"].dtype == torch.int32 and cache["pos"].tolist() == [s, s]
    for leaf in ("k", "v"):
        _close(cache[leaf], cache_j[leaf], tol, f"prefill cache {leaf}")
    for i in range(4):
        tok = tokens[:, s + i:s + i + 1]
        logits_j, cache_j = jlm.decode_step(p_j, cfg_j, cache_j, jnp.asarray(tok),
                                            uniform_pos=uniform_pos)
        logits, new = lm.decode_step(p, cfg, cache, torch.from_numpy(tok),
                                     uniform_pos=uniform_pos)
        assert not torch.equal(new["k"], cache["k"])      # a new cache; the old one kept
        cache = new
        _close(logits, logits_j, tol, f"decode {i} logits")
        for leaf in ("k", "v"):
            _close(cache[leaf], cache_j[leaf], tol, f"decode {i} cache {leaf}")
    assert cache["pos"].tolist() == [s + 4, s + 4]


def test_decode_matches_forward(model):
    """The port's own identity (tests/test_models.py's, for the port):
    prefill(t[:, :S]) + decode(t[:, S]) == forward(t[:, :S+1])[:, -1], with
    naive attention on both sides, as the reference's test runs it. Decode
    rotates q and k whatever ``causal`` says, so an encoder backbone has no
    such identity: its decode only runs (finite logits)."""
    name, _, _, cfg, p, tokens = model
    s = 40
    full, _ = lm.forward(p, cfg, torch.from_numpy(tokens[:, :s + 1]), attn_impl="naive")
    _, cache = lm.prefill_step(p, cfg, torch.from_numpy(tokens[:, :s]), attn_impl="naive",
                               cache_dtype=torch.float32, cache_len=s + 8)
    step, _ = lm.decode_step(p, cfg, cache, torch.from_numpy(tokens[:, s:s + 1]))
    if not cfg.causal:
        assert bool(torch.isfinite(step).all())
        return
    tol = WINDOW_TOL if cfg.sliding_window else MODEL_TOL
    torch.testing.assert_close(step[:, 0], full[:, -1], rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float8_e4m3fn"])
def test_decode_from_a_bridged_jax_cache_matches_jax(dtype):
    """``cache_from_numpy`` takes the JAX KV ring leaf for leaf, in its
    dtype; decode from it matches the JAX decode."""
    cfg_j, cfg = _cfgs("qwen2-0.5b")
    p_j = jlm.init_params(jax.random.key(2), cfg_j, jnp.float32)
    p = lm_params_from_numpy(jax.tree.map(np.asarray, p_j), cfg, device="cpu")
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 31))
    _, cache_j = jlm.prefill_step(p_j, cfg_j, jnp.asarray(tokens[:, :30]),
                                  cache_dtype=getattr(jnp, dtype), cache_len=34)
    cache = cache_from_numpy(jax.tree.map(np.asarray, cache_j), cfg, device="cpu")
    assert cache["k"].dtype == getattr(torch, dtype) and cache["pos"].dtype == torch.int32
    np.testing.assert_array_equal(cache["v"].float().numpy(),
                                  _np(cache_j["v"].astype(jnp.float32)))
    logits_j, _ = jlm.decode_step(p_j, cfg_j, cache_j, jnp.asarray(tokens[:, 30:31]))
    logits, _ = lm.decode_step(p, cfg, cache, torch.from_numpy(tokens[:, 30:31]))
    _close(logits, logits_j, FP8_TOL if dtype == "float8_e4m3fn" else MODEL_TOL, dtype)
    # The port's own prefill casts to the cache type as JAX does.
    _, own = lm.prefill_step(p, cfg, torch.from_numpy(tokens[:, :30]),
                             cache_dtype=getattr(torch, dtype), cache_len=34)
    assert own["k"].dtype == getattr(torch, dtype)


def test_cache_bridge_rejects_missing_and_misshaped_leaves():
    cfg_j, cfg = _cfgs("granite-3-2b")
    tree = jax.tree.map(np.asarray, jlm.init_cache(cfg_j, 2, 16, jnp.float32, prefilled=3))
    with pytest.raises(ValueError, match="'v'"):
        cache_from_numpy({k: v for k, v in tree.items() if k != "v"}, cfg, device="cpu")
    with pytest.raises(ValueError, match="ssm_state"):
        cache_from_numpy(dict(tree, ssm_state=np.zeros(3, np.float32)), cfg, device="cpu")
    with pytest.raises(ValueError, match="leaf 'k'"):
        cache_from_numpy(dict(tree, k=tree["k"][:, :, :, :1]), cfg, device="cpu")
    out = cache_from_numpy(tree, cfg, device="cpu")
    own = lm.init_cache(cfg, 2, 16, torch.float32, prefilled=3, device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in out.items()} == \
           {k: (tuple(v.shape), v.dtype) for k, v in own.items()}


@pytest.mark.parametrize("sc,s", [(8, 5), (8, 8), (8, 21), (1, 3)])
def test_ring_gather_and_positions_match_jax(sc, s):
    """The prefill ring layout and the slot positions decode masks with:
    slot j holds the position p with p % sc == j; −1 where unwritten."""
    kv = np.arange(2 * s * 3, dtype=np.float32).reshape(2, s, 3)
    np.testing.assert_array_equal(lm._ring_gather(torch.from_numpy(kv), sc).numpy(),
                                  _np(jlm._ring_gather(jnp.asarray(kv), sc)))
    pos = np.array([s, s + 3], np.int32)
    np.testing.assert_array_equal(lm._ring_positions(torch.from_numpy(pos), sc).numpy(),
                                  np.asarray(jlm._ring_positions(jnp.asarray(pos), sc)))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "granite-3-2b"])
def test_make_local_exec_matches_jax(arch):
    """The serving pair as FleetEngine._execute_jobs drives it (blockwise
    prefill into an fp32 ring of S + gen_len slots, uniform-position
    decode): logits at every step, and greedy tokens equal off near-ties."""
    cfg_j, cfg = _cfgs(arch)
    p_j = jlm.init_params(jax.random.key(4), cfg_j, jnp.float32)
    p = lm_params_from_numpy(jax.tree.map(np.asarray, p_j), cfg, device="cpu")
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (3, 32))
    gen_len = 4
    pre_j, dec_j = jax_make_local_exec(cfg_j, gen_len)
    pre, dec = make_local_exec(cfg, gen_len, device="cpu")
    logits_j, cache_j = pre_j(p_j, jnp.asarray(tokens))
    logits, cache = pre(p, torch.from_numpy(tokens))
    assert cache["k"].dtype == torch.float32 and cache["k"].shape[2] == 32 + gen_len
    for step in range(gen_len):
        _close(logits, logits_j, MODEL_TOL, f"step {step}")
        lj = _np(logits_j[:, -1, :cfg.vocab_size])
        tok_j = lj.argmax(axis=-1)
        tok = torch.argmax(logits[:, -1:, :cfg.vocab_size], dim=-1)
        for row, (a, b) in enumerate(zip(tok[:, 0].tolist(), tok_j.tolist())):
            assert a == b or abs(lj[row, a] - lj[row, b]) <= MODEL_TOL, (step, row)
        logits_j, cache_j = dec_j(p_j, cache_j, jnp.asarray(tok.numpy(), jnp.int32))
        logits, cache = dec(p, cache, tok)
        assert logits.is_inference()


def test_cache_spec_matches_jax_without_storage():
    cfg_j, cfg = _cfgs("granite-3-2b", "full")
    shape = SHAPES["decode_32k"]
    for dtype in ("bfloat16", "float8_e4m3fn"):
        spec = cache_spec(cfg, shape, getattr(torch, dtype))
        spec_j = jinputs.cache_spec(cfg_j, jinputs.ShapeConfig(*dataclasses.astuple(shape)),
                                    getattr(jnp, dtype))
        assert set(spec) == set(spec_j)
        for key, leaf in spec.items():
            assert leaf.device.type == "meta", key
            assert tuple(leaf.shape) == tuple(spec_j[key].shape), key
            assert str(leaf.dtype).removeprefix("torch.") == str(spec_j[key].dtype), key


@pytest.mark.parametrize("entry", ["init_params", "init_cache", "make_local_exec"])
def test_device_none_means_cuda_and_raises_without_it(entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: device=None resolves to it")
    cfg = TC.get_arch("qwen2-0.5b", "smoke")
    calls = {
        "init_params": lambda: lm.init_params(cfg, torch.Generator()),
        "init_cache": lambda: lm.init_cache(cfg, 2, 16),
        "make_local_exec": lambda: make_local_exec(cfg, 4),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
