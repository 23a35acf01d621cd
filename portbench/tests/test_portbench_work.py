"""The frozen arithmetic, pinned to the counts PERF.md already held."""

import json

import pytest

from conftest import ROOT
from portbench import work
from portbench.reference.lm import layer_module


def conf(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())


def model(name):
    return conf(name)["model"]


def family(name):
    return layer_module(conf(name)["reference"])


def test_ssd_forward_counts_at_the_serving_shapes():
    nbytes, ops = work.ssd_fwd_work(4, 2048, 80, 64, 128, 256, "float32")
    # PERF.md's 32.5 GFLOP (32.57 with state_pass's recurrence) and 357 MB.
    assert int(ops / 1e8) == 325 and round(nbytes / 1e6) == 357
    assert round(work.ssd_fwd_work(4, 2048, 50, 64, 16, 256, "float32")[0] / 1e6) == 213
    # bf16 halves x, B, C, y; the fp32 dt, a and final state stay.
    bf16 = work.ssd_fwd_work(4, 2048, 80, 64, 128, 256, "bfloat16")[0]
    assert bf16 == nbytes - 2 * (2 * 4 * 2048 * 80 * 64 + 2 * 4 * 2048 * 128)


def test_bounds_are_the_larger_time_at_the_data_sheet_peaks():
    nbytes, ops = work.ssd_fwd_work(4, 2048, 80, 64, 128, 256, "float32")
    assert work.bound_s(nbytes, ops, "float32") == pytest.approx(nbytes / 3.35e12)
    assert work.bound_s(1, 989e12, "bfloat16") == pytest.approx(1.0)
    assert work.bound_s(1, 495e12, "float32") == pytest.approx(1.0)


@pytest.mark.parametrize("name,params", [("mamba2-2.7b", 2_702_640_640),
                                         ("hymba-1.5b", 1_641_432_320)])
def test_parameter_counts_match_the_file_and_the_program(name, params):
    from repro_torch.configs.registry import get_arch
    import repro_torch.configs  # noqa: F401  (registers the architectures)

    assert work.param_count(model(name), family(name)) == conf(name)["params"] == params
    assert get_arch(name).param_count() == params


def test_train_flops_are_six_n_per_token_plus_the_ssd():
    m = model("mamba2-2.7b")
    n, t, d = 2_702_640_640, 8 * 2048, m["d_model"]
    vp = work.padded_vocab(m)
    ssd = 3 * m["num_layers"] * work.ssd_products_per_layer(m, 8, 2048)
    # The head over the real vocabulary, no lookup, the final norm not a product.
    assert (work.train_flops(m, 8, 2048, family("mamba2-2.7b"))
            == 6 * (n - vp * d - d) * t + 6 * d * m["vocab_size"] * t + ssd)


def test_prefill_flops_count_the_head_once_a_prompt_and_the_window():
    h, fam = model("hymba-1.5b"), family("hymba-1.5b")
    # The untied head's rows, the embedding's and the final norm are no layer's.
    per_layer = (work.param_count(h, fam) - 2 * work.padded_vocab(h) * 1600 - 1600) // 32
    assert per_layer * 32 == work.held_params(h, fam)[1]
    attn = work.attention_products_per_layer(h, 4, 2048)
    # 1024 queries see 1..1024 keys, the next 1024 see 1024 each.
    assert attn == 4 * 64 * 25 * (1024 * 1025 // 2 + 1024 * 1024) * 4
    want = (2 * 32 * per_layer * 4 * 2048 + 2 * 1600 * 32001 * 4
            + 32 * (work.ssd_products_per_layer(h, 4, 2048) + attn))
    assert work.prefill_flops(h, 4, 2048, fam) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_call_at_its_bound_reads_at_most_100_percent(dtype):
    for fn in (work.ssd_fwd_work, work.ssd_bwd_work):
        for shape in [(4, 2048, 80, 64, 128, 256), (4, 2048, 50, 64, 16, 256), (4, 32, 80, 64, 128, 32)]:
            bound = work.bound_s(*fn(*shape, dtype), dtype)
            assert work.share_pct(bound, bound) == pytest.approx(100.0)
            assert work.share_pct(bound, 1.01 * bound) < 100.0
    for name in ("mamba2-2.7b", "hymba-1.5b"):
        m, fam = model(name), family(name)
        # A step or batch at exactly the peak reads 100%.
        for flops in (work.train_flops(m, 8, 2048, fam), work.prefill_flops(m, 4, 2048, fam)):
            at_peak = flops / work.peak_flops(dtype)
            assert work.share_pct(flops / at_peak, work.peak_flops(dtype)) == pytest.approx(100.0)
