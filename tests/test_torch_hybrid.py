"""The port's hybrid family (Hymba: attention and a Mamba-2 SSM in parallel
in every layer) against the JAX package's.

``hymba-1.5b``'s smoke config end to end on bridged JAX weights: the
parallel block (each branch RMS-normed, the two averaged), a sliding-window
KV ring beside the SSM state and conv tail. ``forward`` (blockwise and
naive), ``prefill_step``'s logits and every cache leaf, ``decode_step``
from the port's own cache and from the bridged JAX cache against JAX's
decode; the port's copy of the reference's ring-decode parity test;
``make_local_exec`` against the JAX pair; the full config's count; the
bridge's hybrid leaves; ``FleetEngine`` with a hybrid class against the
reference engine and the launcher serving a MoE and a hybrid class. The
port's prefill reaches the SSM through ``ssd_scan`` (its plain sequential
version on the CPU), the JAX model through the pure-JAX ``ssd_chunked``.

Tolerances:
* MODEL_TOL = 2e-4 (tests/test_models.py's decode-parity tolerance): two
  fp32 layers, the chunked JAX scan against the port's sequential one;
* WINDOW_TOL = 3e-4 (tests/test_models.py's ring-decode tolerance), where
  the window is shorter than the sequence;
* exact: counts, names, shapes, ``pos``, greedy tokens off near-ties.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import lm as jlm
from repro.serve.step import make_local_exec as jax_make_local_exec
from repro_torch import configs as TC
from repro_torch.bridge import cache_from_numpy, lm_params_from_numpy
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import serve as tl
from repro_torch.models import lm
from repro_torch.serve.step import make_local_exec
from test_torch_serve import T, _compare
from test_torch_serve_dense import _engine_pair

torch.set_float32_matmul_precision("highest")

ARCH = "hymba-1.5b"
FULL_COUNT = 1_641_432_320
MODEL_TOL = 2e-4
WINDOW_TOL = 3e-4
HYBRID_LEAVES = ("branch_attn_norm", "branch_ssm_norm", "wq", "w_x", "a_log", "w_gate")


def _np(x):
    return np.asarray(x, np.float32)


def _cfgs(variant="smoke", **change):
    return (dataclasses.replace(JC.get_arch(ARCH, variant), **change),
            dataclasses.replace(TC.get_arch(ARCH, variant), **change))


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=tol, atol=tol, err_msg=what)


@pytest.fixture(scope="module")
def model():
    """(cfg_j, params_j, cfg, bridged params, tokens (2, 90)); the smoke
    window is 64, so sequences past 64 exercise it."""
    cfg_j, cfg = _cfgs()
    p_j = jlm.init_params(jax.random.key(0), cfg_j, jnp.float32)
    # Give the branch norms values other than 1, so a swapped or dropped
    # branch shows.
    rng = np.random.default_rng(9)
    for name in ("branch_attn_norm", "branch_ssm_norm"):
        p_j["blocks"][name] = jnp.asarray(
            rng.uniform(0.5, 1.5, p_j["blocks"][name].shape).astype(np.float32))
    p = lm_params_from_numpy(jax.tree.map(np.asarray, p_j), cfg, device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 90))
    return cfg_j, p_j, cfg, p, tokens


@pytest.fixture
def scans(monkeypatch):
    """Count the port's ``ssd_scan`` calls (the plain version on the CPU)."""
    seen = {"calls": 0}
    ref = ssd_ops.ssd_scan_ref

    def counting(*args):
        seen["calls"] += 1
        return ref(*args)

    monkeypatch.setattr(ssd_ops, "ssd_scan_ref", counting)
    return seen


# ---------------------------------------------------------------------------
# Config, specs, count, init, bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["full", "smoke"])
def test_hybrid_config_specs_and_count_match_jax(variant):
    cfg_j, cfg = _cfgs(variant)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
    assert cfg.hybrid and cfg.has_attention and cfg.has_ssm and cfg.sliding_window > 0
    assert lm.layer_param_specs(cfg) == jlm.layer_param_specs(cfg_j)
    assert lm.top_param_specs(cfg) == jlm.top_param_specs(cfg_j)
    assert lm.count_params(cfg) == jlm.count_params(cfg_j) == cfg.param_count()
    assert cfg.active_param_count() == cfg.param_count() == jlm.count_params(cfg_j, active_only=True)
    if variant == "full":
        assert cfg.param_count() == FULL_COUNT
        assert (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state) == (50, 64, 16)


def test_init_params_and_bridge_carry_the_hybrid_leaves(model):
    cfg_j, p_j, cfg, p, _ = model
    own = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert set(own["blocks"]) == set(p_j["blocks"]) == set(p["blocks"])
    for name in HYBRID_LEAVES:
        assert name in own["blocks"]
        np.testing.assert_array_equal(p["blocks"][name].numpy(), np.asarray(p_j["blocks"][name]))
    assert bool((own["blocks"]["branch_ssm_norm"] == 1).all())
    tree = jax.tree.map(np.asarray, p_j)
    missing = dict(tree, blocks={k: v for k, v in tree["blocks"].items()
                                 if k != "branch_attn_norm"})
    with pytest.raises(ValueError, match="branch_attn_norm"):
        lm_params_from_numpy(missing, cfg, device="cpu")


def test_cache_bridge_takes_all_four_hybrid_leaves(model):
    cfg_j, _, cfg, _, _ = model
    tree = jax.tree.map(np.asarray, jlm.init_cache(cfg_j, 2, 100, jnp.float32, prefilled=5))
    out = cache_from_numpy(tree, cfg, device="cpu")
    own = lm.init_cache(cfg, 2, 100, torch.float32, prefilled=5, device="cpu")
    assert set(out) == set(own) == {"k", "v", "ssm_state", "conv_state", "pos"}
    assert {k: (tuple(v.shape), v.dtype) for k, v in out.items()} == \
           {k: (tuple(v.shape), v.dtype) for k, v in own.items()}
    assert out["k"].shape[2] == cfg.sliding_window          # window-sized ring
    with pytest.raises(ValueError, match="ssm_state"):
        cache_from_numpy({k: v for k, v in tree.items() if k != "ssm_state"}, cfg, device="cpu")


# ---------------------------------------------------------------------------
# The smoke model end to end on bridged weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [40, 90])
def test_forward_logits_match_jax(model, scans, s):
    """S = 40 inside the window, S = 90 past it; aux 0 (no router); one
    ssd_scan call per layer."""
    cfg_j, p_j, cfg, p, tokens = model
    tol = WINDOW_TOL if s > cfg.sliding_window else MODEL_TOL
    for impl in ("blockwise", "naive"):
        logits_j, _ = jlm.forward(p_j, cfg_j, jnp.asarray(tokens[:, :s]), attn_impl=impl)
        logits, aux = lm.forward(p, cfg, torch.from_numpy(tokens[:, :s]), attn_impl=impl)
        assert tuple(logits.shape) == (2, s, lm.padded_vocab(cfg)) and float(aux) == 0.0
        _close(logits, logits_j, tol, impl)
    assert scans["calls"] == 2 * cfg.num_layers


@pytest.mark.parametrize("uniform_pos", [True, False])
def test_prefill_cache_and_decode_steps_match_jax(model, uniform_pos):
    """Prefill 70 tokens into a window-sized ring (70 + 8 > 64: wrapped),
    every cache leaf against JAX's; four decode steps from the port's own
    cache and from the bridged JAX cache, against JAX's decode."""
    cfg_j, p_j, cfg, p, tokens = model
    s = 70
    last_j, cache_j = jlm.prefill_step(p_j, cfg_j, jnp.asarray(tokens[:, :s]),
                                       cache_dtype=jnp.float32, cache_len=s + 8)
    last, cache = lm.prefill_step(p, cfg, torch.from_numpy(tokens[:, :s]),
                                  cache_dtype=torch.float32, cache_len=s + 8)
    _close(last, last_j, WINDOW_TOL, "prefill logits")
    assert set(cache) == set(cache_j) == {"k", "v", "ssm_state", "conv_state", "pos"}
    assert cache["k"].shape[2] == cfg.sliding_window and cache["pos"].tolist() == [s, s]
    for leaf in ("k", "v", "ssm_state", "conv_state"):
        _close(cache[leaf], cache_j[leaf], WINDOW_TOL, f"prefill cache {leaf}")
    bridged = cache_from_numpy(jax.tree.map(np.asarray, cache_j), cfg, device="cpu")
    for i in range(4):
        tok = tokens[:, s + i:s + i + 1]
        logits_j, cache_j = jlm.decode_step(p_j, cfg_j, cache_j, jnp.asarray(tok),
                                            uniform_pos=uniform_pos)
        logits, new = lm.decode_step(p, cfg, cache, torch.from_numpy(tok),
                                     uniform_pos=uniform_pos)
        assert not torch.equal(new["ssm_state"], cache["ssm_state"])   # the old cache kept
        cache = new
        from_j, bridged = lm.decode_step(p, cfg, bridged, torch.from_numpy(tok),
                                         uniform_pos=uniform_pos)
        _close(logits, logits_j, WINDOW_TOL, f"decode {i}")
        _close(from_j, logits_j, WINDOW_TOL, f"decode {i} from the bridged cache")
        for leaf in ("k", "v", "ssm_state", "conv_state"):
            _close(cache[leaf], cache_j[leaf], WINDOW_TOL, f"decode {i} cache {leaf}")
    assert cache["pos"].tolist() == [s + 4, s + 4]


def test_decode_matches_forward(model):
    """The reference's test_decode_matches_forward for hymba, on the port:
    prefill(t[:, :24]) + decode(t[:, 24]) == forward(t[:, :25])[:, -1]."""
    _, _, cfg, p, tokens = model
    s = 24
    full, _ = lm.forward(p, cfg, torch.from_numpy(tokens[:, :s + 1]), attn_impl="naive")
    _, cache = lm.prefill_step(p, cfg, torch.from_numpy(tokens[:, :s]), attn_impl="naive",
                               cache_dtype=torch.float32, cache_len=s + 8)
    step, _ = lm.decode_step(p, cfg, cache, torch.from_numpy(tokens[:, s:s + 1]))
    torch.testing.assert_close(step[:, 0, :cfg.vocab_size], full[:, -1, :cfg.vocab_size],
                               rtol=MODEL_TOL, atol=MODEL_TOL)


def test_sliding_window_ring_decode_parity():
    """The port's copy of tests/test_models.py's ring-decode test: window 16,
    chunk 8, a 40-token prompt (the ring has wrapped twice); decode through
    the window-sized cache matches the windowed full forward, and JAX's
    decode from the same weights."""
    cfg_j, cfg = _cfgs(sliding_window=16, ssm_chunk=8)
    s = 40
    p_j = jlm.init_params(jax.random.key(0), cfg_j, jnp.float32)
    p = lm_params_from_numpy(jax.tree.map(np.asarray, p_j), cfg, device="cpu")
    tokens = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, s + 1))
    full, _ = lm.forward(p, cfg, torch.from_numpy(tokens), attn_impl="naive")
    _, cache = lm.prefill_step(p, cfg, torch.from_numpy(tokens[:, :s]), attn_impl="naive",
                               cache_dtype=torch.float32)
    assert cache["k"].shape[2] == 16
    step, _ = lm.decode_step(p, cfg, cache, torch.from_numpy(tokens[:, s:]))
    torch.testing.assert_close(step[:, 0, :cfg.vocab_size], full[:, -1, :cfg.vocab_size],
                               rtol=WINDOW_TOL, atol=WINDOW_TOL)
    _, cache_j = jlm.prefill_step(p_j, cfg_j, jnp.asarray(tokens[:, :s]), attn_impl="naive",
                                  cache_dtype=jnp.float32)
    step_j, _ = jlm.decode_step(p_j, cfg_j, cache_j, jnp.asarray(tokens[:, s:]))
    _close(step, step_j, WINDOW_TOL, "against JAX's decode")


def test_make_local_exec_matches_jax(model):
    """The serving pair as FleetEngine._execute_jobs drives it (32-token
    prompts, ring of 32 + 4 slots), greedy tokens equal off near-ties."""
    cfg_j, p_j, cfg, p, tokens = model
    gen_len = 4
    pre_j, dec_j = jax_make_local_exec(cfg_j, gen_len)
    pre, dec = make_local_exec(cfg, gen_len, device="cpu")
    logits_j, cache_j = pre_j(p_j, jnp.asarray(tokens[:, :32]))
    logits, cache = pre(p, torch.from_numpy(tokens[:, :32]))
    assert cache["k"].dtype == torch.float32 and cache["k"].shape[2] == 32 + gen_len
    for step in range(gen_len):
        _close(logits, logits_j, MODEL_TOL, f"step {step}")
        lj = _np(logits_j[:, -1, :cfg.vocab_size])
        tok = torch.argmax(logits[:, -1:, :cfg.vocab_size], dim=-1)
        for row, (a, b) in enumerate(zip(tok[:, 0].tolist(), lj.argmax(axis=-1).tolist())):
            assert a == b or abs(lj[row, a] - lj[row, b]) <= MODEL_TOL, (step, row)
        logits_j, cache_j = dec_j(p_j, cache_j, jnp.asarray(tok.numpy(), jnp.int32))
        logits, cache = dec(p, cache, tok)


# ---------------------------------------------------------------------------
# Serving a hybrid class
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dispatch", ["staged", "kernel"])
def test_hybrid_class_engine_matches_reference_with_real_execution(dispatch):
    """``FleetEngine`` with a hymba-1.5b class against the reference engine
    on the reference launcher's scenario (bridged): tests/test_torch_serve.py's
    ``_compare`` over every slot and the same ``exec_jobs``."""
    jeng, teng = _engine_pair(dispatch, ARCH)
    rc = teng.classes[0]
    assert {"branch_attn_norm", "w_x", "wq"} <= set(teng.params[ARCH]["blocks"])
    assert rc.kv_gb() == jeng.classes[0].kv_gb() > 0.0
    assert rc.energy_per_job_j() == jeng.classes[0].energy_per_job_j()
    jout = jeng.run(execute_real=True)
    tout = teng.run(execute_real=True)
    assert _compare(teng, tout, jout) == T
    assert tout["exec_jobs"] == jout["exec_jobs"] > 0 and tout["exec_seconds"] > 0.0


def test_launcher_serves_a_moe_and_a_hybrid_class_on_the_cpu(capsys):
    """``--classes deepseek-moe-16b,hymba-1.5b --dispatch kernel``: both
    smoke models execute their drained jobs."""
    out = tl.main(["--slots", "4", "--device", "cpu", "--dispatch", "kernel",
                   "--classes", "deepseek-moe-16b,hymba-1.5b"])
    text = capsys.readouterr().out
    assert "classes=deepseek-moe-16b,hymba-1.5b" in text and "device=cpu" in text
    assert out["exec_jobs"] > 0 and out["dispatch"].shape == (4, 4, 2, 2)
