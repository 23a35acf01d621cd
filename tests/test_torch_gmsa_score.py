"""The port's gmsa_score wrapper against the JAX package's Pallas kernel.

The JAX side runs the Pallas kernel in interpret mode, as tests/test_kernels.py
does; the port's wrapper takes its plain PyTorch version for CPU tensors (the
CUDA kernel itself is held against that plain version by chip_smoke.py on the
card). Inputs are made from seeded numpy and handed to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gmsa_score import gmsa_score as jax_gmsa_score
from repro_torch.core.gmsa import gmsa_dispatch
from repro_torch.kernels.gmsa_score import gmsa_score, gmsa_score_phases_ref, gmsa_score_ref
from repro_torch.kernels.gmsa_score.kernel import _gmsa_score_cuda_phases, gmsa_score_cuda

torch.set_float32_matmul_precision("highest")

SHAPES = [(1, 4), (4, 17), (8, 128), (8, 256), (9, 129), (16, 256)]
# fp32: summation order differs (XLA matvec vs torch einsum); bf16 inputs are
# rounded identically on both sides but the tolerance of test_kernels.py holds.
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _inputs(seed, k, n, runs=()):
    rng = np.random.default_rng(seed)
    return (
        (rng.random(runs + (k, n)) * 100).astype(np.float32),
        (rng.random(runs + (k, n)) * 50).astype(np.float32),
        (rng.random(runs + (k,)) * 40).astype(np.float32),
        (rng.random(k) * 10).astype(np.float32),
        rng.dirichlet(np.ones(n), (k, n)).astype(np.float32),
        (rng.random(n) * 20).astype(np.float32),
    )


def _cast(arrays, dtype):
    """The same rounded values as numpy fp32, for both frameworks."""
    j = [jnp.asarray(x).astype(dtype) for x in arrays]
    t = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(getattr(torch, dtype))
         for x in j]
    return j, t


def _check_best(best, s_jax):
    """Equal argmin, or a near-tie: the port's pick has a JAX score within
    1e-5 relative of the JAX minimum (the rule of test_kernels.py:70)."""
    s = np.asarray(s_jax, np.float64)
    picked = np.take_along_axis(s, best[..., None].astype(np.int64), -1)[..., 0]
    np.testing.assert_allclose(picked, s.min(-1), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,n", SHAPES)
def test_gmsa_score_matches_jax_kernel(k, n, dtype):
    j, t = _cast(_inputs(k * 1000 + n, k, n), dtype)
    s_j, b_j = jax_gmsa_score(*j, interpret=True)
    s_t, b_t = gmsa_score(*t)
    assert s_t.dtype == torch.float32 and b_t.dtype == torch.int32
    assert tuple(s_t.shape) == (k, n) and tuple(b_t.shape) == (k,)
    tol = TOL[dtype]
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=tol, atol=tol)
    _check_best(b_t.numpy(), s_j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,n", SHAPES)
def test_gmsa_score_runs_axis_matches_vmapped_jax(k, n, dtype):
    j, t = _cast(_inputs(k * 1000 + n + 1, k, n, runs=(3,)), dtype)
    q, mu, a, vp, r, wpue = j
    s_j, _ = jax.vmap(
        lambda qq, mm, aa: jax_gmsa_score(qq, mm, aa, vp, r, wpue, interpret=True)
    )(q, mu, a)
    s_t, b_t = gmsa_score(*t)
    assert tuple(s_t.shape) == (3, k, n) and tuple(b_t.shape) == (3, k)
    tol = TOL[dtype]
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=tol, atol=tol)
    _check_best(b_t.numpy(), s_j)


@pytest.mark.parametrize("layout", ["contiguous", "transposed"])
@pytest.mark.parametrize("runs", [(), (3,)], ids=["single", "runs"])
@pytest.mark.parametrize("k,n", SHAPES)
def test_gmsa_score_phases_ref_matches_jax(k, n, runs, layout):
    """The CUDA chain's two-phase algorithm in plain PyTorch: its cost
    workspace against the JAX matvec, its scores and argmin against the
    Pallas kernel (vmapped over runs), with q and mu given contiguous or as
    the simulator's transposed (R, N, K) view. fp32, summation order: 1e-4."""
    q, mu, a, vp, r, wpue = _inputs(k * 1000 + n + 2, k, n, runs=runs)
    cost_j = jnp.einsum("kij,j->ki", jnp.asarray(r), jnp.asarray(wpue))
    kernel = lambda qq, mm, aa: jax_gmsa_score(
        qq, mm, aa, jnp.asarray(vp), jnp.asarray(r), jnp.asarray(wpue), interpret=True)
    if runs:
        kernel = jax.vmap(kernel)
    s_j, _ = kernel(jnp.asarray(q), jnp.asarray(mu), jnp.asarray(a))
    if layout == "transposed":
        as_view = lambda x: torch.from_numpy(np.ascontiguousarray(np.swapaxes(x, -1, -2))).mT
        q_t, mu_t = as_view(q), as_view(mu)
        assert k == 1 or (q_t.stride(-2) == 1 and not q_t.is_contiguous())
    else:
        q_t, mu_t = torch.from_numpy(q), torch.from_numpy(mu)
    cost, s_t, b_t = gmsa_score_phases_ref(
        q_t, mu_t, *(torch.from_numpy(x) for x in (a, vp, r, wpue)))
    assert cost.dtype == s_t.dtype == torch.float32 and b_t.dtype == torch.int32
    assert tuple(cost.shape) == (k, n)
    assert tuple(s_t.shape) == runs + (k, n) and tuple(b_t.shape) == runs + (k,)
    np.testing.assert_allclose(cost.numpy(), np.asarray(cost_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-4, atol=1e-4)
    _check_best(b_t.numpy(), s_j)


def test_gmsa_score_phases_ref_ties_and_zero_arrivals():
    """The two-phase version keeps the contract: exact ties to the lowest
    index, a = 0 rows to index 0, a NaN score wins as in torch.argmin."""
    q, mu, a, vp, r, wpue = (torch.from_numpy(x) for x in _inputs(17, 8, 64, runs=(2,)))
    lo, hi = 5, 40
    q[..., lo] = -1e4
    q[..., hi], mu[..., hi], r[:, hi, :] = q[..., lo], mu[..., lo], r[:, lo, :]
    a[:, 3] = 0.0
    q[1, 6, 50] = float("nan")
    _, s, b = gmsa_score_phases_ref(q, mu, a, vp, r, wpue)
    want = torch.full((2, 8), lo, dtype=torch.int32)
    want[:, 3] = 0
    want[1, 6] = 50
    assert torch.equal(b, want)
    assert torch.equal(b, torch.argmin(s, dim=-1).to(torch.int32))


def test_gmsa_score_reads_transposed_operands():
    """The simulator hands (R, N, K) backlogs as transposed views and a
    strided arrivals column; the result equals the contiguous call exactly."""
    q, mu, a, vp, r, wpue = (torch.from_numpy(x) for x in _inputs(5, 8, 33, runs=(4,)))
    q_v = q.mT.contiguous().mT
    a_v = torch.stack([a, a], dim=-2)[..., 1, :]
    assert not q_v.is_contiguous() and not a_v.is_contiguous()
    s0, b0 = gmsa_score(q, mu, a, vp, r, wpue)
    s1, b1 = gmsa_score(q_v, mu.mT.contiguous().mT, a_v, vp, r, wpue)
    assert torch.equal(s0, s1) and torch.equal(b0, b1)


def test_gmsa_score_exact_ties_pick_lowest_index():
    q, mu, a, vp, r, wpue = (torch.from_numpy(x) for x in _inputs(7, 8, 256, runs=(2,)))
    lo, hi = 37, 201
    q[..., lo] = -1e4
    q[..., hi], mu[..., hi], r[:, hi, :] = q[..., lo], mu[..., lo], r[:, lo, :]
    s, b = gmsa_score(q, mu, a, vp, r, wpue)
    assert torch.equal(s[..., lo], s[..., hi])
    assert b.tolist() == [[lo] * 8] * 2
    # All-equal rows: index 0.
    flat = torch.ones(8, 256)
    _, b = gmsa_score(flat, flat, a[0], vp, r[:, :1, :].expand(8, 256, 256), wpue)
    assert b.tolist() == [0] * 8


def test_gmsa_score_zero_arrivals_row_picks_index_zero():
    q, mu, a, vp, r, wpue = (torch.from_numpy(x) for x in _inputs(9, 4, 17))
    a[2] = 0.0
    s, b = gmsa_score(q, mu, a, vp, r, wpue)
    assert bool((s[2] == 0).all())      # +0.0 and -0.0 compare equal
    assert int(b[2]) == 0
    j = [jnp.asarray(x.numpy()) for x in (q, mu, a, vp, r, wpue)]
    _, b_j = jax_gmsa_score(*j, interpret=True)
    assert int(b_j[2]) == 0


def test_gmsa_dispatch_kernel_on_cpu_is_the_plain_version():
    """impl="kernel" on CPU tensors equals impl="ref" (raw operands) exactly,
    and the CUDA kernel's launch count does not move."""
    q, mu, a, vp, r, wpue = (torch.from_numpy(x) for x in _inputs(11, 8, 64, runs=(3,)))
    before = gmsa_score_cuda.launches
    f_k = gmsa_dispatch(q.mT, a, mu.mT, None, 3.0, impl="kernel", r=r, wpue=wpue)
    f_r = gmsa_dispatch(q.mT, a, mu.mT, None, 3.0, impl="ref", r=r, wpue=wpue)
    assert gmsa_score_cuda.launches == before
    assert torch.equal(f_k, f_r)
    assert tuple(f_k.shape) == (3, 64, 8)
    assert torch.equal(f_k.sum(-2), torch.ones(3, 8))


def test_gmsa_score_cuda_refuses_cpu_tensors():
    ops = [torch.from_numpy(x) for x in _inputs(13, 2, 8)]
    with pytest.raises(TypeError, match="CUDA"):
        gmsa_score_cuda(*ops)
    with pytest.raises(TypeError, match="CUDA"):
        _gmsa_score_cuda_phases(*ops)
    assert gmsa_score_ref(*ops)[1].dtype == torch.int32


def test_kernel_build_needs_nvcc_and_keys_builds_by_source(monkeypatch, tmp_path):
    """Without nvcc the build raises (no fallback); every kernel source is
    in the checkout and its library name carries the source's hash."""
    from repro_torch.kernels import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()
    assert all(src.is_file() for src in _build.SOURCES.values())
    lib = _build.library_path("gmsa_score")
    assert lib.parent == _build.BUILD_DIR and lib.name.startswith("libgmsa_score_")
    assert lib == _build.library_path("gmsa_score")
