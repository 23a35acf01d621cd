"""The port's attention family against the JAX package's.

``repro_torch.models.attention`` (``attend_naive``, ``attend_blockwise``,
``attend_decode``, ``_mask_bias``, ``_repeat_kv``) and the new
``repro_torch.models.layers`` functions (``rope_table``, ``apply_rope``,
``swiglu``, ``gelu_mlp``, ``layer_norm``) on the same seeded-numpy inputs as
``repro.models.attention`` / ``repro.models.layers``.

Tolerances (fp32 on both sides):
* ATTN_TOL = 1e-5, absolute and relative: attention outputs are convex
  mixes of O(1) values; only the order of the fp32 reductions differs
  (XLA's einsum and softmax against torch's, the online softmax's
  rescaling in the blockwise form);
* LAYER_TOL = 1e-5: one matmul or one normalisation, another reduction
  order;
* ROPE_TOL = 2e-6 absolute: sin/cos of fp32 angles at positions below 64
  (XLA's and torch's ``pow``/``sin`` may differ by an ulp of the angle);
* exact: masks, head repetition, where nothing is summed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jatt
from repro.models import layers as jlay
from repro_torch.models import attention as tatt
from repro_torch.models import layers as tlay

torch.set_float32_matmul_precision("highest")

ATTN_TOL = 1e-5
LAYER_TOL = 1e-5
ROPE_TOL = 2e-6

#: (H, Hkv): GQA groups 1, 2 and 7 (qwen2-0.5b's 14 heads on 2).
GROUPS = [(2, 2), (4, 2), (14, 2)]
#: mask mode -> (causal, window)
MASKS = {"causal": (True, 0), "bidirectional": (False, 0), "window": (True, 6)}


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _qkv(seed, b, sq, sk, h, hkv, d):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(b, sq, h, d), f(b, sk, hkv, d), f(b, sk, hkv, d)


def _both(fn_j, fn_t, *arrays, **kw):
    """(JAX output as numpy, port output as numpy) on the same arrays."""
    out_j = fn_j(*(jnp.asarray(a) for a in arrays), **kw)
    out_t = fn_t(*(_t(a) for a in arrays), **kw)
    return _np(out_j), out_t.numpy()


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
@pytest.mark.parametrize("positions", ["prefill", "decode"])
def test_rope_table_and_apply_rope_match_jax(theta, positions):
    """Split-half RoPE: the (sin, cos) tables and the rotation, for
    prefill's (S,) positions and decode's (B, 1) ones."""
    hd = 16
    pos = np.arange(40) if positions == "prefill" else np.array([[3], [57]])
    sin_j, cos_j = jlay.rope_table(jnp.asarray(pos), hd, theta)
    sin_t, cos_t = tlay.rope_table(_t(pos), hd, theta)
    assert sin_t.dtype == torch.float32 and tuple(sin_t.shape) == pos.shape + (hd // 2,)
    np.testing.assert_allclose(sin_t.numpy(), _np(sin_j), rtol=0, atol=ROPE_TOL)
    np.testing.assert_allclose(cos_t.numpy(), _np(cos_j), rtol=0, atol=ROPE_TOL)
    shape = (2, 40, 3, hd) if positions == "prefill" else (2, 1, 3, hd)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = jlay.apply_rope(jnp.asarray(x), sin_j, cos_j)
    got = tlay.apply_rope(_t(x), sin_t, cos_t)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=LAYER_TOL, atol=LAYER_TOL)
    # The split-half convention: pair (i, i + half), not (2i, 2i + 1).
    np.testing.assert_allclose(got[..., 0].numpy(),
                               x[..., 0] * cos_t[..., None, 0].numpy()
                               - x[..., hd // 2] * sin_t[..., None, 0].numpy(),
                               rtol=LAYER_TOL, atol=LAYER_TOL)


@pytest.mark.parametrize("layer", ["swiglu", "gelu_mlp", "layer_norm"])
def test_mlps_and_layer_norm_match_jax(layer):
    rng = np.random.default_rng(2)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = f(2, 5, 24) * 3.0 + 1.5
    if layer == "swiglu":
        args = (x, f(24, 40) / 5, f(24, 40) / 5, f(40, 24) / 6)
    elif layer == "gelu_mlp":
        args = (x, f(24, 40) / 5, f(40), f(40, 24) / 6, f(24))
    else:
        args = (x, f(24), f(24))
    kw = {"eps": 1e-5} if layer == "layer_norm" else {}
    want, got = _both(getattr(jlay, layer), getattr(tlay, layer), *args, **kw)
    np.testing.assert_allclose(got, want, rtol=LAYER_TOL, atol=LAYER_TOL)
    if layer == "gelu_mlp":   # jax.nn.gelu's default is the tanh approximation
        erf = torch.nn.functional.gelu(_t(x) @ _t(args[1]) + _t(args[2])) @ _t(args[3]) \
            + _t(args[4])
        assert float((erf - _t(got)).abs().max()) > 10 * LAYER_TOL


# ---------------------------------------------------------------------------
# Masks and head order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(MASKS))
def test_mask_bias_and_repeat_kv_match_jax_exactly(mode):
    causal, window = MASKS[mode]
    q_pos = np.arange(20, 30)
    k_pos = np.concatenate([np.arange(30), np.full(4, jatt._PAD_POS)])
    want = jatt._mask_bias(jnp.asarray(q_pos), jnp.asarray(k_pos), causal, window)
    got = tatt._mask_bias(_t(q_pos), _t(k_pos), causal, window)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert (got[:, 30:] == tatt._NEG_INF).all()       # padded keys, every mode
    k = np.random.default_rng(3).standard_normal((2, 5, 2, 4)).astype(np.float32)
    np.testing.assert_array_equal(tatt._repeat_kv(_t(k), 7).numpy(),
                                  _np(jatt._repeat_kv(jnp.asarray(k), 7)))


# ---------------------------------------------------------------------------
# Prefill attention: naive and blockwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(MASKS))
@pytest.mark.parametrize("h,hkv", GROUPS)
def test_naive_and_blockwise_match_jax(h, hkv, mode):
    """S = 40 with chunk = q_chunk = 16: three Q tiles, the last padded and
    cropped (40 % 16 != 0), and three KV chunks, the last padded with
    _PAD_POS keys."""
    causal, window = MASKS[mode]
    q, k, v = _qkv(h * 10 + hkv, 2, 40, 40, h, hkv, 8)
    pos = np.arange(40)
    kw = dict(causal=causal, window=window)
    want_n, got_n = _both(jatt.attend_naive, tatt.attend_naive, q, k, v, pos, pos, **kw)
    np.testing.assert_allclose(got_n, want_n, rtol=ATTN_TOL, atol=ATTN_TOL)
    want_b, got_b = _both(jatt.attend_blockwise, tatt.attend_blockwise, q, k, v, pos, pos,
                          chunk=16, q_chunk=16, **kw)
    np.testing.assert_allclose(got_b, want_b, rtol=ATTN_TOL, atol=ATTN_TOL)
    np.testing.assert_allclose(got_b, got_n, rtol=ATTN_TOL, atol=ATTN_TOL)


@pytest.mark.parametrize("mode", list(MASKS))
@pytest.mark.parametrize("sq,sk,chunk", [(8, 37, 16), (5, 5, 16), (24, 24, 1024)])
def test_blockwise_padded_keys_match_jax(sq, sk, chunk, mode):
    """Sk % chunk != 0: the padded keys' weight is exactly 0 in every mask
    mode, bidirectional included (the queries sit at the tail, as a chunked
    prefill's do). At (24, 24, 1024), the serving shape's form, 1000 of the
    1024 keys scored are padding."""
    causal, window = MASKS[mode]
    q, k, v = _qkv(sq + sk, 2, sq, sk, 4, 2, 8)
    q_pos, k_pos = np.arange(sk - sq, sk), np.arange(sk)
    kw = dict(causal=causal, window=window, chunk=chunk, q_chunk=chunk)
    want, got = _both(jatt.attend_blockwise, tatt.attend_blockwise, q, k, v, q_pos, k_pos, **kw)
    np.testing.assert_allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
    naive = tatt.attend_naive(_t(q), _t(k), _t(v), _t(q_pos), _t(k_pos), causal, window)
    np.testing.assert_allclose(got, naive.numpy(), rtol=ATTN_TOL, atol=ATTN_TOL)
    kp, vp, posp = tatt._pad_keys(_t(k), _t(v), _t(k_pos), chunk)
    assert kp.shape[1] % chunk == 0 and bool((posp[sk:] == tatt._PAD_POS).all())


def test_blockwise_fully_masked_rows_are_zero_not_nan():
    """Queries before every key (causal): every row fully masked. The
    m_safe guard keeps exp() at 0, the final division at max(l, 1e-30)."""
    q, k, v = _qkv(5, 1, 6, 20, 4, 2, 8)
    q_pos, k_pos = np.arange(6), np.arange(100, 120)
    want, got = _both(jatt.attend_blockwise, tatt.attend_blockwise, q, k, v, q_pos, k_pos,
                      causal=True, window=0, chunk=8, q_chunk=8)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.zeros_like(got))


# ---------------------------------------------------------------------------
# Decode attention: the ring cache
# ---------------------------------------------------------------------------

def _ring_positions(pos, sc):
    """(B, sc) absolute position per ring slot, −1 if unwritten (the JAX
    model's ``_ring_positions``, in numpy)."""
    last = np.asarray(pos)[:, None] - 1
    p = last - np.mod(last - np.arange(sc)[None, :], sc)
    return np.where(p >= 0, p, -1)


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("h,hkv", GROUPS)
def test_decode_matches_jax_on_a_ring_with_unwritten_slots(h, hkv, window):
    """A 12-slot ring: row 0 at position 7 (slots 8..11 unwritten, −1),
    row 1 at position 30 (wrapped twice). q sits at pos; the cache holds
    positions up to pos."""
    b, sc, d = 2, 12, 8
    rng = np.random.default_rng(h + window)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    kc = rng.standard_normal((b, sc, hkv, d)).astype(np.float32)
    vc = rng.standard_normal((b, sc, hkv, d)).astype(np.float32)
    q_pos = np.array([7, 30])
    cache_pos = _ring_positions(q_pos + 1, sc)
    assert (cache_pos[0, 8:] == -1).all() and (cache_pos[0, :8] == np.arange(8)).all()
    want, got = _both(jatt.attend_decode, tatt.attend_decode, q, kc, vc, q_pos, cache_pos,
                      window=window)
    np.testing.assert_allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
    # The grouped form equals naive attention over the valid slots.
    ok = cache_pos[0] >= 0
    kv_pos = np.where(ok, cache_pos[0], tatt._PAD_POS)
    naive = tatt.attend_naive(_t(q[:1]), _t(kc[:1]), _t(vc[:1]), _t(q_pos[:1]), _t(kv_pos),
                              causal=True, window=window)
    np.testing.assert_allclose(got[:1], naive.numpy(), rtol=ATTN_TOL, atol=ATTN_TOL)


@pytest.mark.parametrize("dtype", ["float8_e4m3fn", "bfloat16"])
def test_decode_low_precision_cache_matches_jax(dtype):
    """A float8 (or bf16) cache: both sides cast the same fp32 values to the
    cache type, then upcast exactly before the products."""
    b, sc, h, hkv, d = 2, 10, 4, 2, 8
    rng = np.random.default_rng(9)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    kc = rng.standard_normal((b, sc, hkv, d)).astype(np.float32)
    vc = rng.standard_normal((b, sc, hkv, d)).astype(np.float32)
    q_pos = np.array([9, 4])
    cache_pos = _ring_positions(q_pos + 1, sc)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    kc_j, vc_j = jnp.asarray(kc).astype(jdt), jnp.asarray(vc).astype(jdt)
    kc_t, vc_t = _t(kc).to(tdt), _t(vc).to(tdt)
    np.testing.assert_array_equal(kc_t.float().numpy(), _np(kc_j.astype(jnp.float32)))
    want = jatt.attend_decode(jnp.asarray(q), kc_j, vc_j, jnp.asarray(q_pos),
                              jnp.asarray(cache_pos))
    got = tatt.attend_decode(_t(q), kc_t, vc_t, _t(q_pos), _t(cache_pos))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=ATTN_TOL, atol=ATTN_TOL)
