"""The gradient of the port's ``ssd_scan`` on the CPU.

``ssd_scan_bwd_ref`` (the CUDA backward chain's algorithm phase by phase)
from ``ssd_scan_phases_ref``'s workspaces, against autograd through the
port's sequential ``ssd_scan_ref`` and against ``jax.vjp`` of the JAX
package's sequential ``repro.kernels.ssd_scan.ref.ssd_scan_ref``; the
wrapper under autograd (``SsdScanFn``); the paths without grad unchanged;
the bf16 gradient (the JAX package trains in bf16) against ``jax.vjp`` of
``repro.models.ssm.ssd_chunked``.
The CUDA chain itself is held against these on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 19). Inputs come from
seeded numpy.

Tolerance: BWD_TOL = 3e-4 of each gradient's largest |value| (the
forward's fp32 tolerance, tests/test_kernels.py): the chunked backward
forms exponents of cumsum differences where the oracles multiply per-step
decays, and sums in other orders; a fp64 check of the algorithm gave at
most 9e-6.

bf16 (dx, dB, dC in bf16; ddt, da fp32): each bf16 gradient element within
one bf16 ulp of itself plus BWD_TOL of the gradient's largest |value| of
the reference's fp32 gradient at the same bf16 values, rounded once to
bf16 as the reference's ``astype`` rounds it: the two fp32 values differ
by the fp32 tolerance, and one rounding may then fall either side (one
ulp). Against ``jax.vjp`` with bf16 operands, BF16_PARTS_TOL of the max
more: there x, B and C each enter two einsums through two ``astype``s, and
JAX rounds each use's fp32 gradient to bf16 and adds the two in bf16,
where the port rounds their fp32 sum once (measured: at most 1.1e-3 of the
max past one ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ml_dtypes

from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ssd_scan_ref
from repro.models.ssm import ssd_chunked
from repro_torch.kernels.ssd_scan import (
    ssd_scan,
    ssd_scan_bwd_phases_ref,
    ssd_scan_bwd_ref,
    ssd_scan_phases_ref,
    ssd_scan_ref,
)
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_bwd_cuda, ssd_scan_cuda
from repro_torch.kernels.ssd_scan.ref import DBC_HEAD_GROUP, DSTATE_HEAD_GROUP

torch.set_float32_matmul_precision("highest")

BWD_TOL = 3e-4
NAMES = ("dx", "ddt", "da", "dB", "dC")
#: (B, S, H, P, N, chunk, model-range inputs): a ragged S (100 on chunk 32:
#: four chunks, the last padded), several chunks at N = 128 and N = 16 with
#: small H, one chunk, and unit-normal inputs.
SHAPES = [(2, 100, 3, 8, 16, 32, True), (1, 192, 2, 16, 128, 64, True),
          (2, 96, 2, 16, 16, 24, True), (1, 40, 3, 8, 32, 64, True),
          (2, 64, 2, 8, 16, 16, False)]
#: Shapes whose H is no multiple of DBC_HEAD_GROUP or DSTATE_HEAD_GROUP
#: (chunk_dbc's and chunk_dstate's last head group ragged): hymba-1.5b's H =
#: 50 and N = 16, H = 20, and H = 17 at a ragged S with unit-normal inputs
#: (exponents deep into fp32's range).
GROUP_SHAPES = [(1, 64, 50, 8, 16, 32, True), (2, 48, 20, 4, 16, 16, True),
                (1, 70, 17, 4, 32, 32, False)]
#: bf16: ragged S at N = 16 and N = 128 (mamba2's state), and H = 17 (the
#: head groups ragged), with the model's input ranges.
BF16_SHAPES = [(2, 100, 3, 8, 16, 32, True), (1, 150, 2, 16, 128, 64, True),
               (1, 70, 17, 4, 32, 32, True)]
#: 2^-8 of the max: one bf16 ulp at the gradient's largest values.
BF16_PARTS_TOL = 2.0 ** -8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one intra-op thread: the smoke models' steps are tiny,
    and under a parallel test run several processes' thread pools on the
    same cores make many small steps a hundred times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, b, s, h, p, n, model_like):
    """x, dt, a, B, C and the upstream dy, dh_final: the model's ranges (dt
    log-uniform in [1e-3, 0.1], A in [-16, -1], silu'd x, B, C) or
    unit-normal ones."""
    rng = np.random.default_rng(seed)
    silu = lambda v: v / (1.0 + np.exp(-v))
    rn = lambda *shape: rng.standard_normal(shape)
    if model_like:
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), (b, s, h)))
        a = -rng.uniform(1.0, 16.0, h)
        x, bm, cm = silu(rn(b, s, h, p)), silu(rn(b, s, n)), silu(rn(b, s, n))
    else:
        x, dt, a = rn(b, s, h, p), np.logaddexp(0.0, rn(b, s, h)), -np.exp(rn(h))
        bm, cm = rn(b, s, n), rn(b, s, n)
    f = lambda v: np.asarray(v, np.float32)
    return [f(v) for v in (x, dt, a, bm, cm)], f(rn(b, s, h, p)), f(rn(b, h, p, n))


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


def _bf16_ulp(v):
    """One bf16 ulp at each element's magnitude (8 significant bits)."""
    v = np.abs(np.asarray(v, np.float64))
    return 2.0 ** (np.floor(np.log2(np.maximum(v, 1e-30))) - 7)


def _assert_bf16_close(got, want, rel, what):
    """Each element within one bf16 ulp (of the larger of the two) plus
    ``rel`` of want's largest |value|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    slack = _bf16_ulp(np.maximum(np.abs(got), np.abs(want))) + rel * np.abs(want).max()
    excess = np.abs(got - want) - slack
    assert excess.max() <= 0.0, (what, float(excess.max()), float(np.abs(want).max()))


def _to_bf16(v):
    return np.asarray(v, np.float32).astype(ml_dtypes.bfloat16)


def _padded_phases(ops, dy, dhf, q):
    """ssd_scan_bwd_phases_ref on the operands padded to a chunk multiple as
    the wrapper pads them: (padded operands, padded dy, the forward's
    workspaces cum, G, h_in, the backward's outputs)."""
    pad = (-ops[0].shape[1]) % q
    t = [torch.from_numpy(v) for v in ops]
    padw = lambda v: torch.nn.functional.pad(v, (0, 0) * (v.dim() - 2) + (0, pad))
    t = [padw(v) if v.dim() > 1 else v for v in t]
    dyp = padw(torch.from_numpy(dy))
    _, _, cum, g, h_in = ssd_scan_phases_ref(*t, q)
    out = ssd_scan_bwd_phases_ref(*t, dyp, torch.from_numpy(dhf), cum, g, h_in, q)
    return t, dyp, (cum, g, h_in), out


def _padded_bwd(ops, dy, dhf, q):
    """ssd_scan_bwd_ref's gradients on the padded operands, sliced back."""
    s = ops[0].shape[1]
    grads = _padded_phases(ops, dy, dhf, q)[3][:5]
    return [u[:, :s] if u.dim() > 1 else u for u in grads]


@pytest.mark.parametrize("shape", SHAPES + GROUP_SHAPES, ids=str)
def test_bwd_ref_matches_autograd_of_the_sequential_form(shape):
    b, s, h, p, n, q, model_like = shape
    ops, dy, dhf = _inputs(sum(shape[:6]), b, s, h, p, n, model_like)
    got = _padded_bwd(ops, dy, dhf, q)
    leaves = [torch.from_numpy(v).requires_grad_() for v in ops]
    y, hf = ssd_scan_ref(*leaves)
    torch.autograd.backward([y, hf], [torch.from_numpy(dy), torch.from_numpy(dhf)])
    for name, g, t in zip(NAMES, got, leaves):
        assert _rel(g.numpy(), t.grad.numpy()) <= BWD_TOL, (name, shape)


@pytest.mark.parametrize("shape", SHAPES[:3] + GROUP_SHAPES, ids=str)
def test_bwd_ref_matches_jax_vjp_of_the_reference(shape):
    b, s, h, p, n, q, model_like = shape
    ops, dy, dhf = _inputs(sum(shape[:6]) + 1, b, s, h, p, n, model_like)
    got = _padded_bwd(ops, dy, dhf, q)
    _, vjp = jax.vjp(jax_ssd_scan_ref, *(jnp.asarray(v) for v in ops))
    want = vjp((jnp.asarray(dy), jnp.asarray(dhf)))
    for name, g, w in zip(NAMES, got, want):
        assert _rel(g.numpy(), np.asarray(w)) <= BWD_TOL, (name, shape)


def test_bwd_phases_ref_workspaces():
    """G is dh_final in the last chunk; R and its head-group partials are
    zero above the diagonal, R's diagonal is Σ_h dt_t dy_t·x_t and each
    partial's that sum over its group's heads; CBᵀ above the diagonal is
    never read."""
    b, s, h, p, n, q = 1, 96, 2, 8, 16, 32
    ops, dy, dhf = _inputs(5, b, s, h, p, n, True)
    t = [torch.from_numpy(v) for v in ops]
    _, _, cum, g, h_in = ssd_scan_phases_ref(*t, q)
    out = ssd_scan_bwd_phases_ref(*t, torch.from_numpy(dy), torch.from_numpy(dhf), cum, g, h_in, q)
    gst, r, r_part = out[5], out[6], out[11]
    assert gst.shape == (b, s // q, h, p, n) and r.shape == (b, s // q, q, q)
    assert r_part.shape == (b, s // q, -(-h // DSTATE_HEAD_GROUP), q, q)
    assert torch.equal(gst[:, -1], torch.from_numpy(dhf))
    assert torch.equal(r.triu(1), torch.zeros_like(r))
    assert torch.equal(r_part.triu(1), torch.zeros_like(r_part))
    # R's diagonal: Σ_h dt_t dy_t·x_t (L_tt = 1); a partial's, over its heads.
    xt, dyt = torch.from_numpy(ops[0]), torch.from_numpy(dy)
    per_head = (torch.from_numpy(ops[1]) * (xt * dyt).sum(-1)).reshape(b, s // q, q, h)
    torch.testing.assert_close(torch.diagonal(r, dim1=-2, dim2=-1), per_head.sum(-1), rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(torch.diagonal(r_part[:, :, 0], dim1=-2, dim2=-1),
                               per_head[..., :DSTATE_HEAD_GROUP].sum(-1), rtol=1e-5, atol=1e-6)
    # G above the diagonal is never read (the forward chain leaves it
    # unspecified): NaN there changes nothing.
    g_nan = g.masked_fill(~torch.ones(q, q, dtype=torch.bool).tril(), float("nan"))
    again = ssd_scan_bwd_phases_ref(*t, torch.from_numpy(dy), torch.from_numpy(dhf), cum, g_nan,
                                    h_in, q)
    assert all(torch.equal(u, v) for u, v in zip(out, again))
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_scan_bwd_phases_ref(*(v[:, :95] if v.dim() > 1 else v for v in t),
                                torch.from_numpy(dy)[:, :95], torch.from_numpy(dhf), cum, g,
                                h_in, q)


@pytest.mark.parametrize("shape", SHAPES[:1] + GROUP_SHAPES, ids=str)
def test_bwd_scales_match_numpy_exp_of_the_fp64_differences(shape):
    """chunk_dbc's scales, scale_out_s = dt_s exp(A_c - cum_s) and scale_in_t
    = exp(cum_t): numpy's fp64 exp of the same fp64 cum differences, each
    rounded once to fp32 as the kernels round them, within 1e-6 relative
    (fp32's exp and one product; values that fp32 holds only as denormals
    within 1e-38)."""
    b, s, h, p, n, q, model_like = shape
    ops, dy, dhf = _inputs(sum(shape[:6]) + 2, b, s, h, p, n, model_like)
    t, _, (cum, _, _), out = _padded_phases(ops, dy, dhf, q)
    sp = cum.shape[-1]
    cc = cum.numpy().reshape(b, h, sp // q, q)                          # fp64
    e = lambda d: np.exp(d.astype(np.float32).astype(np.float64))
    to_bsh = lambda v: v.reshape(b, h, sp).transpose(0, 2, 1)
    dt = t[1].numpy().astype(np.float64)
    scale_out, scale_in = out[7].numpy(), out[8].numpy()
    assert scale_out.shape == scale_in.shape == (b, sp, h)
    np.testing.assert_allclose(scale_out, dt * to_bsh(e(cc[..., -1:] - cc)), rtol=1e-6, atol=1e-38)
    np.testing.assert_allclose(scale_in, to_bsh(e(cc)), rtol=1e-6, atol=1e-38)


@pytest.mark.parametrize("shape", SHAPES[:1] + GROUP_SHAPES, ids=str)
def test_bwd_group_partials_sum_to_the_whole_einsum(shape):
    """chunk_dbc's partials: slot 0 the R term, slot 1 + g the heads
    [16g, 16g + 16) (the last group ragged), dB's then dC's. Summed over the
    slots in order they are the chain's dB and dC (bitwise: the plain
    version defines them so), and within 1e-5 of the largest |value| of the
    whole product over every head at once in fp64 (fp32 rounding of a few
    partial sums)."""
    b, s, h, p, n, q, model_like = shape
    ops, dy, dhf = _inputs(sum(shape[:6]) + 3, b, s, h, p, n, model_like)
    t, dyp, (_, _, h_in), out = _padded_phases(ops, dy, dhf, q)
    sp = t[0].shape[1]
    nc, slots = sp // q, 1 + -(-h // DBC_HEAD_GROUP)
    part = out[9]
    assert part.shape == (b, nc, 2, slots, q, n) and out[10].shape == (b, nc, h)
    ordered = part[:, :, :, 0]
    for k in range(1, slots):
        ordered = ordered + part[:, :, :, k]
    assert torch.equal(ordered[:, :, 0].reshape(b, sp, n), out[3])
    assert torch.equal(ordered[:, :, 1].reshape(b, sp, n), out[4])
    f64 = lambda v: v.numpy().astype(np.float64)
    r, gst = f64(out[6]), f64(out[5])
    xc, dyc = f64(t[0]).reshape(b, nc, q, h, p), f64(dyp).reshape(b, nc, q, h, p)
    bc, cc = f64(t[3]).reshape(b, nc, q, n), f64(t[4]).reshape(b, nc, q, n)
    so, si = f64(out[7]).reshape(b, nc, q, h), f64(out[8]).reshape(b, nc, q, h)
    whole_db = (np.einsum("bcts,bctn->bcsn", r, cc)
                + np.einsum("bcsh,bcshp,bchpn->bcsn", so, xc, gst))
    whole_dc = (np.einsum("bcts,bcsn->bctn", r, bc)
                + np.einsum("bcth,bcthp,bchpn->bctn", si, dyc, f64(h_in)))
    assert _rel(ordered[:, :, 0].numpy(), whole_db) <= 1e-5
    assert _rel(ordered[:, :, 1].numpy(), whole_dc) <= 1e-5
    # Each head group's slot is that group's product alone.
    g_last = (slots - 2) * DBC_HEAD_GROUP
    hs = slice(g_last, h)
    last_db = np.einsum("bcsh,bcshp,bchpn->bcsn", so[..., hs], xc[..., hs, :], gst[:, :, hs])
    assert _rel(part[:, :, 0, -1].numpy(), last_db) <= 1e-5
    # da: the chunks' partials summed over (b, c).
    np.testing.assert_allclose(out[2].numpy(), f64(out[10]).sum((0, 1)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES[:1] + GROUP_SHAPES, ids=str)
def test_bwd_r_partials_sum_to_the_whole_einsum(shape):
    """chunk_dstate's partials of R: group g the heads [16g, 16g + 16) (the
    last group ragged). Summed over the groups in order they are the chain's
    R (bitwise: the plain version defines it so), and within 1e-5 of the
    largest |value| of R over every head at once in fp64 (fp32 rounding of
    a few partial sums); the last group's partial is its heads' sum alone."""
    b, s, h, p, n, q, model_like = shape
    ops, dy, dhf = _inputs(sum(shape[:6]) + 4, b, s, h, p, n, model_like)
    t, dyp, (cum, _, _), out = _padded_phases(ops, dy, dhf, q)
    sp = t[0].shape[1]
    nc, groups = sp // q, -(-h // DSTATE_HEAD_GROUP)
    r_part = out[11]
    assert r_part.shape == (b, nc, groups, q, q)
    ordered = r_part[:, :, 0]
    for g in range(1, groups):
        ordered = ordered + r_part[:, :, g]
    assert torch.equal(ordered, out[6])
    f64 = lambda v: v.numpy().astype(np.float64)
    xc, dyc = f64(t[0]).reshape(b, nc, q, h, p), f64(dyp).reshape(b, nc, q, h, p)
    dtc = f64(t[1]).reshape(b, nc, q, h)
    cc = cum.numpy().reshape(b, h, nc, q).transpose(0, 2, 3, 1)          # (B,NC,Q,H) fp64
    tri = np.tril(np.ones((q, q), bool))[None, None, :, :, None]
    seg = np.where(tri, cc[:, :, :, None, :] - cc[:, :, None, :, :], -np.inf)
    lm = np.exp(seg.astype(np.float32).astype(np.float64)) * np.einsum(
        "bcthp,bcshp->bctsh", dyc, xc)
    whole = np.einsum("bctsh,bcsh->bcts", lm, dtc)
    assert _rel(ordered.numpy(), whole) <= 1e-5
    g0 = (groups - 1) * DSTATE_HEAD_GROUP
    last = np.einsum("bctsh,bcsh->bcts", lm[..., g0:], dtc[..., g0:])
    assert _rel(r_part[:, :, -1].numpy(), last) <= 1e-5


@pytest.mark.parametrize("shape", SHAPES[:2], ids=str)
def test_wrapper_under_grad_goes_through_ssd_scan_fn(shape):
    b, s, h, p, n, q, model_like = shape
    ops, dy, dhf = _inputs(7, b, s, h, p, n, model_like)
    leaves = [torch.from_numpy(v).requires_grad_() for v in ops]
    y, hf = ssd_scan(*leaves, chunk=q)
    assert type(hf.grad_fn).__name__ == "SsdScanFnBackward"
    assert y.shape == (b, s, h, p) and hf.shape == (b, h, p, n)
    torch.autograd.backward([y, hf], [torch.from_numpy(dy), torch.from_numpy(dhf)])
    ref = [torch.from_numpy(v).requires_grad_() for v in ops]
    y_r, h_r = ssd_scan_ref(*ref)
    torch.autograd.backward([y_r, h_r], [torch.from_numpy(dy), torch.from_numpy(dhf)])
    assert _rel(y.detach().numpy(), y_r.detach().numpy()) <= BWD_TOL
    for name, t, r in zip(NAMES, leaves, ref):
        assert _rel(t.grad.numpy(), r.grad.numpy()) <= BWD_TOL, name
    # Only y's gradient (h_final unused): dh_final is taken as zeros.
    only = [torch.from_numpy(v).requires_grad_() for v in ops]
    y2, _ = ssd_scan(*only, chunk=q)
    y2.backward(torch.from_numpy(dy))
    ref2 = [torch.from_numpy(v).requires_grad_() for v in ops]
    ssd_scan_ref(*ref2)[0].backward(torch.from_numpy(dy))
    for name, t, r in zip(NAMES, only, ref2):
        assert _rel(t.grad.numpy(), r.grad.numpy()) <= BWD_TOL, name


def test_paths_without_grad_are_unchanged():
    ops, _, _ = _inputs(3, 2, 70, 3, 8, 16, False)
    t = [torch.from_numpy(v) for v in ops]
    y_r, h_r = ssd_scan_ref(*t)
    y, hf = ssd_scan(*t, chunk=32)
    assert torch.equal(y, y_r) and torch.equal(hf, h_r)
    assert y.grad_fn is None
    with torch.no_grad():
        y2, h2 = ssd_scan(*(v.clone().requires_grad_() for v in t), chunk=32)
    assert torch.equal(y2, y_r) and torch.equal(h2, h_r)


def test_gradient_refuses_bf16_and_the_chain_refuses_cpu_tensors():
    """The gradient takes x, B, C in one dtype: bf16 mixed with fp32 raises
    (all-bf16 runs, above); the CUDA chain refuses CPU tensors and nothing
    on the CPU counts a launch."""
    ops, dy, dhf = _inputs(4, 1, 32, 2, 8, 16, True)
    t = [torch.from_numpy(v) for v in ops]
    bf = [v.to(torch.bfloat16) if i == 0 else v for i, v in enumerate(t)]
    with pytest.raises(TypeError, match="one dtype"):
        ssd_scan(*(v.clone().requires_grad_() for v in bf), chunk=16)
    with torch.no_grad():   # bf16 without grad: the forward as before
        ssd_scan(*[v.to(torch.bfloat16) if i in (0, 3, 4) else v for i, v in enumerate(t)],
                 chunk=16)
    _, _, cum, g, h_in = ssd_scan_phases_ref(*t, 16)
    before = (ssd_scan_cuda.launches, ssd_scan_bwd_cuda.launches)
    with pytest.raises(TypeError, match="CUDA tensors only"):
        ssd_scan_bwd_cuda(*t, torch.from_numpy(dy), torch.from_numpy(dhf), cum, g, h_in, 16)
    ssd_scan(*(v.clone().requires_grad_() for v in t), chunk=16)[0].sum().backward()
    assert (ssd_scan_cuda.launches, ssd_scan_bwd_cuda.launches) == before

def _bf16_torch_grads(ops, dy, dhf, q):
    """The wrapper under autograd with bf16 x, B, C (and dy), fp32 dt, a."""
    leaves = [torch.from_numpy(_to_bf16(v).astype(np.float32)).bfloat16() if i in (0, 3, 4)
              else torch.from_numpy(v) for i, v in enumerate(ops)]
    leaves = [v.requires_grad_() for v in leaves]
    y, hf = ssd_scan(*leaves, chunk=q)
    assert y.dtype == torch.bfloat16 and hf.dtype == torch.float32
    assert type(hf.grad_fn).__name__ == "SsdScanFnBackward"
    dyb = torch.from_numpy(_to_bf16(dy).astype(np.float32)).bfloat16()
    torch.autograd.backward([y, hf], [dyb, torch.from_numpy(dhf)])
    return [t.grad for t in leaves]


@pytest.mark.parametrize("shape", BF16_SHAPES, ids=str)
def test_bf16_gradient_matches_jax_vjp_of_ssd_chunked(shape):
    """bf16 x, B, C under autograd: dx, dB, dC bf16 and ddt, da fp32, as
    jax.vjp of ssd_chunked gives them, within the module's bf16 bounds of
    the reference's fp32 gradient rounded once, and of its bf16 one."""
    b, s, h, p, n, q, model_like = shape
    ops, dy, dhf = _inputs(sum(shape[:6]) + 5, b, s, h, p, n, model_like)
    got = _bf16_torch_grads(ops, dy, dhf, q)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32, torch.float32,
                                      torch.bfloat16, torch.bfloat16]
    wide = [_to_bf16(v).astype(np.float32) if i in (0, 3, 4) else v for i, v in enumerate(ops)]
    chunked = lambda *a: ssd_chunked(*a, q)
    _, vjp32 = jax.vjp(chunked, *map(jnp.asarray, wide))
    want32 = vjp32((jnp.asarray(_to_bf16(dy).astype(np.float32)), jnp.asarray(dhf)))
    _, vjp16 = jax.vjp(chunked, *(jnp.asarray(_to_bf16(v)) if i in (0, 3, 4) else jnp.asarray(v)
                                  for i, v in enumerate(ops)))
    want16 = vjp16((jnp.asarray(_to_bf16(dy)), jnp.asarray(dhf)))
    assert [str(w.dtype) for w in want16] == ["bfloat16", "float32", "float32", "bfloat16",
                                              "bfloat16"]
    for i, (name, g, w32, w16) in enumerate(zip(NAMES, got, want32, want16)):
        g = g.float().numpy()
        if i in (0, 3, 4):
            _assert_bf16_close(g, _to_bf16(w32).astype(np.float32), BWD_TOL, (name, shape))
            _assert_bf16_close(g, np.asarray(w16).astype(np.float32), BF16_PARTS_TOL,
                               (name, shape))
        else:
            assert _rel(g, np.asarray(w32)) <= BWD_TOL, (name, shape)
            assert _rel(g, np.asarray(w16)) <= BWD_TOL, (name, shape)


@pytest.mark.parametrize("shape", BF16_SHAPES[:2], ids=str)
def test_bf16_bwd_ref_rounds_the_fp32_gradients_once(shape):
    """ssd_scan_bwd_phases_ref on bf16 x, B, C, dy is the fp32 version on the
    same values widened, with dx, dB and dC rounded once to bf16: bitwise,
    every workspace too (the chain is held against it on the card)."""
    b, s, h, p, n, q, model_like = shape
    ops, dy, dhf = _inputs(sum(shape[:6]) + 6, b, s, h, p, n, model_like)
    s_pad = -(-s // q) * q
    pad = lambda v: torch.nn.functional.pad(v, (0, 0) * (v.dim() - 2) + (0, s_pad - s))
    t32 = [torch.from_numpy(_to_bf16(v).astype(np.float32)) if i in (0, 3, 4)
           else torch.from_numpy(v) for i, v in enumerate(ops)]
    t32 = [pad(v) if v.dim() > 1 else v for v in t32]
    t16 = [v.bfloat16() if i in (0, 3, 4) else v for i, v in enumerate(t32)]
    dy32 = pad(torch.from_numpy(_to_bf16(dy).astype(np.float32)))
    dhf = torch.from_numpy(dhf)
    _, _, cum, g, h_in = ssd_scan_phases_ref(*t32, q)
    want = ssd_scan_bwd_phases_ref(*t32, dy32, dhf, cum, g, h_in, q)
    got = ssd_scan_bwd_phases_ref(*t16, dy32.bfloat16(), dhf, cum, g, h_in, q)
    for i, (u, v) in enumerate(zip(got, want)):
        rounded = v.bfloat16() if i in (0, 3, 4) else v
        assert u.dtype == rounded.dtype and torch.equal(u, rounded), i
