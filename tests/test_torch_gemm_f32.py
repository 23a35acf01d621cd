"""The ``gemm_f32`` kernel's CPU side: the plain 3xTF32 version against fp64,
the route ``matmul_f32`` picks, its counters, and the dry-run's price of
the products it would take on the card.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
Here the plain version, which splits and sums as the kernel does, is held
to the kernel's accuracy gates, and the dispatch is shown to leave every
product the card does not take to ``torch.matmul``, bitwise as before.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.kernels.gemm_f32.ops as gemm_ops
from repro_torch.kernels.gemm_f32 import gemm_f32_ref, matmul_f32, split_tf32, tf32_rna
from repro_torch.kernels.gemm_f32.kernel import gemm_f32_cuda, layout_ok
from repro_torch.kernels.gemm_f32.ops import kernel_route, kernel_wins
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.cost import CostMode
from repro_torch.train import TrainStepConfig

#: The accuracy gates (each the largest gap to fp64 over |x|·|W|): 3xTF32
#: within this many times fp32's own gap, and this many times under one
#: TF32 product's.
FP32_FACTOR, TF32_FACTOR = 4.0, 30.0

#: Ragged against the kernel's 128 x 128 x 32 tiles in M, N and K.
RAGGED = [(300, 68, 516), (257, 20, 132), (33, 4, 8), (129, 260, 96), (65, 1036, 130)]


@pytest.fixture
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _operands(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32))
    return x, w


def _gap(got, x, w):
    x64, w64 = x.double(), w.double()
    scale = (x64.abs() @ w64.abs()).clamp_min(1e-300)
    return float(((got.double() - x64 @ w64).abs() / scale).max())


def test_tf32_rna_rounds_to_nearest_with_ties_away_from_zero():
    ulp = 2.0 ** -10   # of TF32 at 1.0
    v = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 2 - 2.0 ** -23,
                      1.0 + 3 * ulp / 2, 0.0, -0.0, 3.0], dtype=torch.float32)
    want = torch.tensor([1.0 + ulp, -(1.0 + ulp), 1.0, 1.0 + 2 * ulp, 0.0, -0.0, 3.0])
    assert torch.equal(tf32_rna(v), want)


def test_split_parts_are_tf32_values_that_sum_to_v(one_thread):
    rng = np.random.default_rng(1)
    v = torch.from_numpy((rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 6, 4096))
                         .astype(np.float32))
    big, small = split_tf32(v)
    for part in (big, small):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert bool(((v - big).abs() <= v.abs() * 2.0 ** -11).all())
    assert bool(((v.double() - big.double() - small.double()).abs()
                 <= v.double().abs() * 2.0 ** -21).all())


@pytest.mark.parametrize("m,k,n", RAGGED)
def test_plain_3xtf32_meets_the_accuracy_gates(one_thread, m, k, n):
    x, w = _operands(m, k, n)
    got = gemm_f32_ref(x, w)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    xb, _ = split_tf32(x)
    wb, _ = split_tf32(w)
    err, err_fp32, err_tf32 = _gap(got, x, w), _gap(x @ w, x, w), _gap(xb @ wb, x, w)
    assert err <= FP32_FACTOR * err_fp32, (err, err_fp32)
    assert TF32_FACTOR * err <= err_tf32, (err, err_tf32)


def test_the_kernel_takes_cuda_tensors_only():
    x, w = _operands(70, 36, 20, seed=3)
    with pytest.raises(TypeError, match="CUDA"):
        gemm_f32_cuda(x, w)


@pytest.fixture
def counters():
    launches, library = gemm_f32_cuda.launches, matmul_f32.library_calls
    yield
    assert (gemm_f32_cuda.launches, matmul_f32.library_calls) == (launches, library)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grad", [False, True])
def test_matmul_f32_off_the_card_is_torch_matmul_bitwise(one_thread, counters, dtype, grad):
    x, w = _operands(96, 40, 24, seed=4)
    x, w = x.reshape(2, 48, 40).to(dtype), w.to(dtype)
    with torch.set_grad_enabled(grad):
        got = matmul_f32(x, w)
    assert torch.equal(got, torch.matmul(x, w))


def _big(grad_x=False, grad_w=False, m=8192, k=64, n=1280):
    x = torch.zeros((m // 2, 2, k)).transpose(0, 1).contiguous().requires_grad_(grad_x)
    return x, torch.zeros((k, n)).requires_grad_(grad_w)


@pytest.mark.parametrize("case,want", [
    ("fits", True),
    ("grad_enabled", False),
    ("x_requires_grad", False),
    ("w_requires_grad", False),
    ("few_rows", False),
    ("narrow", False),
    ("n_not_a_multiple_of_4", False),
    ("w_transposed_view", False),
    ("x_unaligned_view", False),
    ("x_one_dimensional", False),
])
def test_kernel_route_takes_only_what_the_kernel_wins(case, want):
    grad = case == "grad_enabled"
    x, w = _big(grad_x=case == "x_requires_grad", grad_w=case == "w_requires_grad")
    if case == "few_rows":
        x = x[:, :2]
    elif case == "narrow":
        w = w[:, :128].contiguous()
    elif case == "n_not_a_multiple_of_4":
        w = torch.zeros((64, 1282))
    elif case == "w_transposed_view":
        w = torch.zeros((1280, 64)).T
    elif case == "x_unaligned_view":
        x = torch.zeros(8192 * 64 + 1)[1:].view(2, 4096, 64)
    elif case == "x_one_dimensional":
        x = torch.zeros(64)
    with torch.set_grad_enabled(grad):
        assert kernel_route(x, w) is want


def test_size_rule_is_one_rule_on_the_shape():
    # Decode's rows and the last position's head stay on cuBLAS; a prefill
    # batch's projections do not.
    assert not kernel_wins(4, 50304, 2560)
    assert not kernel_wins(128, 5120, 2560)
    assert not kernel_wins(8192, 128, 2560)
    assert kernel_wins(8192, 5120, 2560) and kernel_wins(8192, 320, 1600)
    assert not kernel_wins(8192, 5120, 0)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card, to follow
    ``matmul_f32``'s CUDA branch without one."""

    @property
    def is_cuda(self):
        return True


def test_matmul_f32_counts_each_fp32_card_product_once(monkeypatch):
    calls = []

    def fake_kernel(x2, w):
        calls.append((tuple(x2.shape), tuple(w.shape)))
        return torch.matmul(x2.as_subclass(torch.Tensor), w)

    monkeypatch.setattr(gemm_ops, "gemm_f32_cuda", fake_kernel)
    monkeypatch.setattr(matmul_f32, "library_calls", 0)
    x, w = _big()
    x = x.as_subclass(_OnCard)
    with torch.no_grad():
        y = matmul_f32(x, w)
        assert calls == [((8192, 64), (64, 1280))] and matmul_f32.library_calls == 0
        assert y.shape == (2, 4096, 1280)
        matmul_f32(x[:, :2], w)                 # few rows: the library, counted
        assert len(calls) == 1 and matmul_f32.library_calls == 1
        matmul_f32(x.to(torch.bfloat16), w.to(torch.bfloat16))   # bf16: not counted
        assert len(calls) == 1 and matmul_f32.library_calls == 1
    matmul_f32(x, w)                            # grad mode on: the library, counted
    assert len(calls) == 1 and matmul_f32.library_calls == 2


def test_layout_ok_names_the_kernels_limits():
    x, w = torch.zeros((8, 16)), torch.zeros((16, 12))
    assert layout_ok(x, w)
    assert not layout_ok(torch.zeros((8, 18)), torch.zeros((18, 12)))   # K % 4
    assert not layout_ok(x, torch.zeros((16, 10)))                      # N % 4
    assert not layout_ok(x.T.contiguous().T, w)                         # not contiguous
    assert not layout_ok(x, torch.zeros((12, 12)))                      # K mismatch


# ---------------------------------------------------------------------------
# The dry-run's price: what the kernel would take on the card, counted on meta
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,counted", [
    ("fits", True), ("grad_enabled", False), ("bf16", False), ("few_rows", False),
])
def test_meta_products_the_kernel_takes_count_as_3xtf32(case, counted):
    x = torch.empty((2, 4096, 64), device="meta")
    w = torch.empty((64, 1280), device="meta")
    if case == "bf16":
        x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    elif case == "few_rows":
        x = x[:, :2]
    mode = CostMode()
    with mode, torch.set_grad_enabled(case == "grad_enabled"):
        y = matmul_f32(x, w)
    assert y.shape == (*x.shape[:-1], 1280) and y.is_meta
    assert mode.flops == 2 * x.numel() * 1280
    assert mode.flops_3xtf32 == (mode.flops if counted else 0)
    with torch.no_grad():
        assert matmul_f32(x, w).shape == y.shape      # no CostMode: torch.matmul


def test_pass_peak_flops_prices_the_3xtf32_part_apart():
    fp32, tf32x3 = roofline.PEAK_FLOPS_FP32, roofline.PEAK_FLOPS_3XTF32
    assert tf32x3 == roofline.PEAK_FLOPS_TF32 / 3
    assert roofline.pass_peak_flops(4e12, 0.0, torch.float32) == fp32
    assert roofline.pass_peak_flops(4e12, 4e12, torch.float32) == pytest.approx(tf32x3)
    want = 4e12 / (1e12 / fp32 + 3e12 / tf32x3)
    assert roofline.pass_peak_flops(4e12, 3e12, torch.float32) == pytest.approx(want)
    assert roofline.pass_peak_flops(0.0, 0.0, torch.bfloat16) == roofline.PEAK_FLOPS_BF16


def test_dryrun_prices_what_the_kernel_takes_at_3xtf32():
    """One wide qwen2-0.5b layer over 4 x 512 tokens in fp32: the prefill's
    q, o and FFN products pass the size rule and are 3xTF32 work (k and v,
    N = 128, and the last position's head do not); the training step's
    products are all under autograd, so none is."""
    cfg = dataclasses.replace(get_arch("qwen2-0.5b"), num_layers=1)
    d, q, f, m = cfg.d_model, cfg.num_heads * cfg.resolved_head_dim, cfg.d_ff, 4 * 512
    mesh = dryrun.MESHES[False][1]
    tcfg = TrainStepConfig(microbatches=1, remat="full")
    counts = {}
    for kind in ("prefill", "train"):
        mode, _, _ = dryrun._run_one(cfg, ShapeConfig(kind, kind, 512, 4), mesh, tcfg,
                                     torch.float32, "auto", torch.bfloat16)
        counts[kind] = mode.flops_3xtf32
    assert counts == {"prefill": 2 * m * (2 * d * q + 3 * d * f), "train": 0}
