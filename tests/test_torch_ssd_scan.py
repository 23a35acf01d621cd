"""The port's ssd_scan wrapper against the JAX package's Pallas kernel.

The JAX side runs the Pallas kernel in interpret mode and its sequential
oracle, as tests/test_kernels.py does; the port's wrapper takes its plain
sequential PyTorch version for CPU tensors (the CUDA kernel itself is held
against that plain version by chip_smoke.py and tests/test_torch_cuda.py
on the card). The plain phase-by-phase version of the CUDA chain, whose
workspaces the card tests compare phase by phase, is held here against the
JAX kernel, the JAX chunked form and the sequential recurrence. Inputs are
made from seeded numpy and handed to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_scan import ssd_scan_ref as jax_ssd_scan_ref
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_phases_ref, ssd_scan_ref
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda

torch.set_float32_matmul_precision("highest")

#: (B, S, H, P, N, chunk) of tests/test_kernels.py's ssd_scan tests.
SHAPES = [(1, 32, 2, 8, 16, 8), (2, 128, 3, 64, 128, 128), (1, 72, 2, 32, 64, 16)]
# fp32: the chunked Pallas form and the sequential recurrence round
# differently (exp of cumsum differences vs products of per-step decays);
# bf16: y is rounded to bf16 on both sides. test_kernels.py's tolerances.
TOL = {"float32": 3e-4, "bfloat16": 5e-2}
#: SHAPES, a ragged S with chunk 24 (3 chunks, the last one padded), an S
#: of 6 chunks, then the card tests' ragged shapes (tests/test_torch_cuda.py):
#: S = 130 on Q = 65 (a 64-row tile and a one-row one), P = 12 and 20, N =
#: 16 and 40, H = 17 and 20; H = 1 and N = 12 on Q = 65 with 16 chunks;
#: Q = 1024, the kernels' largest chunk, at H = 3, one chunk (the card test
#: runs two: over a second 1024-step chunk of these unit-normal inputs the
#: JAX kernel and ssd_chunked, whose cumsum is fp32, sit 1.2e-3 off the
#: sequential oracle, past test_kernels.py's 3e-4; the phase version, fp64,
#: 1.3e-5).
PHASE_SHAPES = SHAPES + [(1, 70, 2, 8, 16, 24), (2, 96, 2, 16, 32, 16),
                         (1, 130, 17, 12, 16, 65), (2, 130, 20, 20, 40, 65),
                         (2, 1040, 1, 16, 12, 65), (1, 1024, 3, 8, 24, 1024)]
#: (B, S, H, P, N, chunk) where cum rises in some heads (a > 0): the card
#: tests' shapes of the per-element fallback in chunk_scan (several 64-row
#: tiles per chunk, so off-diagonal ones).
RISING_SHAPES = [(1, 256, 3, 16, 16, 128), (2, 130, 4, 20, 40, 65)]


def _inputs(seed, b, s, h, p, n):
    """Unit-normal x, B, C; dt = softplus(normal); a = -exp(normal)."""
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, s, h, p)).astype(np.float32),
        np.logaddexp(0.0, rng.standard_normal((b, s, h))).astype(np.float32),
        -np.exp(rng.standard_normal(h)).astype(np.float32),
        rng.standard_normal((b, s, n)).astype(np.float32),
        rng.standard_normal((b, s, n)).astype(np.float32),
    )


def _cast(arrays, dtype):
    """The same rounded values for both frameworks: x, B, C in ``dtype``,
    dt and a in fp32 (the kernel's contract)."""
    j, t = [], []
    for i, x in enumerate(arrays):
        jd = dtype if i in (0, 3, 4) else "float32"
        xj = jnp.asarray(x).astype(jd)
        j.append(xj)
        t.append(torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, jd)))
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_ssd_scan_matches_jax_kernel_and_ref(b, s, h, p, n, chunk, dtype):
    j, t = _cast(_inputs(b + s, b, s, h, p, n), dtype)
    y_k, h_k = jax_ssd_scan(*j, chunk=chunk, interpret=True)
    y_r, h_r = jax_ssd_scan_ref(*j)
    y, hf = ssd_scan(*t, chunk=chunk)
    assert y.dtype == getattr(torch, dtype) and hf.dtype == torch.float32
    assert tuple(y.shape) == (b, s, h, p) and tuple(hf.shape) == (b, h, p, n)
    tol = TOL[dtype]
    for y_j, h_j in ((y_k, h_k), (y_r, h_r)):
        np.testing.assert_allclose(y.float().numpy(), np.asarray(y_j, np.float32),
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(hf.numpy(), np.asarray(h_j), rtol=tol, atol=tol)


def test_ssd_scan_ref_matches_jax_ref_closely():
    """Both sequential oracles do the same fp32 arithmetic step by step: only
    the einsum reduction order differs (tight 1e-5)."""
    x, dt, a, bm, cm = _inputs(3, 2, 40, 3, 16, 32)
    y_j, h_j = jax_ssd_scan_ref(*(jnp.asarray(v) for v in (x, dt, a, bm, cm)))
    y, hf = ssd_scan_ref(*(torch.from_numpy(v) for v in (x, dt, a, bm, cm)))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(hf.numpy(), np.asarray(h_j), rtol=1e-5, atol=1e-5)


def test_ssd_scan_matches_jax_model_path():
    """Port wrapper == the JAX model's chunked pure-JAX path (the third
    formulation; 2e-4 as test_kernels.py)."""
    b, s, h, p, n = 2, 64, 2, 16, 32
    x, dt, a, bm, cm = _inputs(7, b, s, h, p, n)
    y_j, h_j = jax_ssd_chunked(*(jnp.asarray(v) for v in (x, dt, a, bm, cm)), 16)
    y, hf = ssd_scan(*(torch.from_numpy(v) for v in (x, dt, a, bm, cm)), chunk=16)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(hf.numpy(), np.asarray(h_j), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("s,chunk", [(45, 8), (45, 16), (45, 32), (45, 64), (70, 24), (24, 24)])
def test_ssd_scan_chunk_invariance_and_ragged_padding(s, chunk):
    """Padding S to a chunk multiple with dt = 0 steps is an exact no-op: the
    result equals the unpadded sequential scan bitwise, whatever the chunk."""
    x, dt, a, bm, cm = (torch.from_numpy(v) for v in _inputs(s + chunk, 1, s, 2, 8, 16))
    y, hf = ssd_scan(x, dt, a, bm, cm, chunk=chunk)
    y0, h0 = ssd_scan_ref(x, dt, a, bm, cm)
    assert tuple(y.shape) == (1, s, 2, 8)
    assert torch.equal(y, y0) and torch.equal(hf, h0)


def test_ssd_scan_casts_dt_and_a_to_fp32():
    x, dt, a, bm, cm = (torch.from_numpy(v) for v in _inputs(11, 1, 16, 2, 8, 16))
    y, hf = ssd_scan(x, dt.double(), a.double(), bm, cm, chunk=8)
    y0, h0 = ssd_scan(x, dt, a, bm, cm, chunk=8)
    assert y.dtype == torch.float32 and hf.dtype == torch.float32
    assert torch.equal(y, y0) and torch.equal(hf, h0)


def test_ssd_scan_rejects_mixed_devices_and_bad_chunk():
    x, dt, a, bm, cm = (torch.from_numpy(v) for v in _inputs(1, 1, 8, 2, 8, 16))
    with pytest.raises(ValueError, match="chunk"):
        ssd_scan(x, dt, a, bm, cm, chunk=0)
    with pytest.raises(ValueError, match="devices"):
        ssd_scan(x, dt, a, bm.to("meta"), cm, chunk=8)


def test_ssd_scan_cuda_takes_cuda_tensors_only():
    """The kernel binding never falls back: CPU tensors raise."""
    x, dt, a, bm, cm = (torch.from_numpy(v) for v in _inputs(1, 1, 8, 2, 8, 16))
    with pytest.raises(TypeError, match="CUDA"):
        ssd_scan_cuda(x, dt, a, bm, cm, 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", PHASE_SHAPES)
def test_ssd_scan_phases_ref_matches_jax_kernel_and_refs(b, s, h, p, n, chunk, dtype):
    """The chain's algorithm, phase by phase, against the JAX Pallas kernel
    (interpret mode), the JAX chunked form and the sequential oracle, at
    test_kernels.py's tolerances."""
    j, t = _cast(_inputs(b + s + chunk, b, s, h, p, n), dtype)
    y, hf, cum, g, h_in = ssd_scan_phases_ref(*t, chunk)
    nc = -(-s // chunk)
    assert y.dtype == getattr(torch, dtype) and tuple(y.shape) == (b, s, h, p)
    assert hf.dtype == torch.float32 and tuple(hf.shape) == (b, h, p, n)
    assert cum.dtype == torch.float64 and tuple(cum.shape) == (b, h, nc * chunk)
    assert g.dtype == torch.float32 and tuple(g.shape) == (b, nc, chunk, chunk)
    assert h_in.dtype == torch.float32 and tuple(h_in.shape) == (b, nc, h, p, n)
    tol = TOL[dtype]
    for y_j, h_j in (jax_ssd_scan(*j, chunk=chunk, interpret=True), jax_ssd_scan_ref(*j),
                     jax_ssd_chunked(*j, chunk)):
        np.testing.assert_allclose(y.float().numpy(), np.asarray(y_j, np.float32),
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(hf.numpy(), np.asarray(h_j, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("b,s,h,p,n,chunk", PHASE_SHAPES)
def test_ssd_scan_phases_ref_workspaces_follow_the_recurrence(b, s, h, p, n, chunk):
    """Each workspace in its layout: cum is the per-chunk fp64 cumsum of
    a·dt (summation order only: 1e-12), G is C_c B_cᵀ below the diagonal and
    0 above (fp32 against fp64 sums: 1e-4), h_in[0] = 0 and h_in[c+1] is
    the sequential recurrence's state after chunk c (chunked against
    sequential rounding: 3e-4)."""
    x, dt, a, bm, cm = _inputs(s * chunk, b, s, h, p, n)
    y, hf, cum, g, h_in = ssd_scan_phases_ref(
        *(torch.from_numpy(v) for v in (x, dt, a, bm, cm)), chunk)
    nc = -(-s // chunk)
    pad = ((0, 0), (0, nc * chunk - s), (0, 0))
    dt64 = np.pad(dt, pad).astype(np.float64) * a.astype(np.float64)
    cum_np = dt64.reshape(b, nc, chunk, h).cumsum(2).transpose(0, 3, 1, 2).reshape(b, h, -1)
    np.testing.assert_allclose(cum.numpy(), cum_np, rtol=1e-12, atol=0)
    bc, cc = (np.pad(v, pad).astype(np.float64).reshape(b, nc, chunk, n) for v in (bm, cm))
    g_np = np.tril(np.einsum("bctn,bcun->bctu", cc, bc))
    np.testing.assert_allclose(g.numpy(), g_np, rtol=1e-4, atol=1e-4)
    assert not h_in[:, 0].any()
    for c in range(nc - 1):
        end = (c + 1) * chunk
        _, h_seq = ssd_scan_ref(*(torch.from_numpy(np.ascontiguousarray(v[:, :end]))
                                  for v in (x, dt)), torch.from_numpy(a),
                                *(torch.from_numpy(np.ascontiguousarray(v[:, :end]))
                                  for v in (bm, cm)))
        np.testing.assert_allclose(h_in[:, c + 1].numpy(), h_seq.numpy(), rtol=3e-4, atol=3e-4)
    y_seq, h_seq = ssd_scan_ref(*(torch.from_numpy(v) for v in (x, dt, a, bm, cm)))
    np.testing.assert_allclose(hf.numpy(), h_seq.numpy(), rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(y.numpy(), y_seq.numpy(), rtol=3e-4, atol=3e-4)


def _rising_inputs(seed, b, s, h, p, n):
    """The model's input ranges (dt log-uniform in [1e-3, 0.1], x, B, C
    through silu) with a of either sign, head 0's a = 3 and the last head's
    -3: cum rises within a chunk in head 0 (a·dt > 0, which no model's a
    does) and falls in the last."""
    rng = np.random.default_rng(seed)
    silu = lambda v: v / (1.0 + np.exp(-v))
    a = rng.uniform(-4.0, 4.0, h)
    a[0], a[-1] = 3.0, -3.0
    return (
        silu(rng.standard_normal((b, s, h, p))).astype(np.float32),
        np.exp(rng.uniform(np.log(1e-3), np.log(0.1), (b, s, h))).astype(np.float32),
        a.astype(np.float32),
        silu(rng.standard_normal((b, s, n))).astype(np.float32),
        silu(rng.standard_normal((b, s, n))).astype(np.float32),
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", RISING_SHAPES)
def test_ssd_scan_phases_ref_where_cum_rises(b, s, h, p, n, chunk, dtype):
    """With a > 0 in some heads (cum rising within a chunk, where chunk_scan
    on the card takes its per-element form): the chain's algorithm against
    the JAX Pallas kernel (interpret mode), the JAX chunked form and the
    sequential oracle. The state grows as exp(cum) there (|y| up to 6e6),
    and each formulation's rounding scales with the largest terms, not with
    an element's own size, so test_kernels.py's tolerances hold relative to
    the largest |value| (measured at most 1.3e-6 fp32, 1.1e-4 bf16)."""
    j, t = _cast(_rising_inputs(b + s + chunk, b, s, h, p, n), dtype)
    assert float(t[2].max()) > 0.0 > float(t[2].min())
    y, hf, _, _, _ = ssd_scan_phases_ref(*t, chunk)
    assert bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(hf).all())
    tol = TOL[dtype]
    for y_j, h_j in (jax_ssd_scan(*j, chunk=chunk, interpret=True), jax_ssd_scan_ref(*j),
                     jax_ssd_chunked(*j, chunk)):
        for got, want in ((y.float().numpy(), np.asarray(y_j, np.float32)),
                          (hf.numpy(), np.asarray(h_j, np.float32))):
            assert np.abs(got - want).max() <= tol * np.abs(want).max()
