"""The inputs and the work of the configured cells, pinned: the weights
``make_weights`` draws for each configuration's file at the program's smoke
sizes, as SHA-256 digests, and the FLOP and parameter counts at the
published sizes, both frozen from the benchmark as it stood before a
family's module could define its own layout and work (the weights drawn
by torch's CPU generator)."""

import hashlib
import json

import pytest
import torch

from conftest import ROOT, SMOKE
from portbench import work
from portbench.inputs import leaf_items, make_weights
from portbench.reference import lm

#: (configuration, dtype, seed) -> digest of every leaf's path, dtype,
#: shape and bytes in ``leaf_items`` order.
DIGESTS = {
    ("mamba2-2.7b", "float32", 7):
        "cdce6c7f95f482ae42b5e47e4bb5ed5dcc65d8c3a880dea9b76243de9cec012e",
    ("mamba2-2.7b", "float32", 2_718_281_828):
        "4a016d4fcf7c4101b48e7b819dc157657a97e518353099daf8452d569e44ba45",
    ("mamba2-2.7b", "bfloat16", 7):
        "41e0ca19f09adb31bbee314f4fcca254795e250245507b9374b63656b12c54fa",
    ("mamba2-2.7b", "bfloat16", 2_718_281_828):
        "4d704d1428b6b789c458823c3459a6305bf13b7aba8cfe8c540cad310be67982",
    ("hymba-1.5b", "float32", 7):
        "3c96fc2f3082db5bfade4d9f798c04c2f2542f2b81dba91fcdc1a3788dfc8e56",
    ("hymba-1.5b", "float32", 2_718_281_828):
        "d43846612698234819bc81ac413ef7b2767a5b51a6ddbdbef4621033c4764890",
    ("hymba-1.5b", "bfloat16", 7):
        "118d6b5f63e12e17003aec2210fa79391f9c9b9e85c4b6b807ebc6b63b1663c6",
    ("hymba-1.5b", "bfloat16", 2_718_281_828):
        "ae6e5da355fce41119735c5d495a2bc37bd8d8f4588d1601c362517240c939a1",
}
#: configuration -> (prefill_flops at 4 x 2048, train_flops at 8 x 2048,
#: param_count), at the published sizes.
COUNTS = {
    "mamba2-2.7b": (44_255_349_280_768, 278_178_538_979_328, 2_702_640_640),
    "hymba-1.5b": (26_768_544_772_608, 165_642_133_045_248, 1_641_432_320),
}


def conf(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())


def digest(tree) -> str:
    h = hashlib.sha256()
    for path, t in leaf_items(tree):
        h.update(f"{path} {t.dtype} {tuple(t.shape)}\n".encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name,dtype,seed", sorted(DIGESTS))
def test_the_weights_are_those_frozen(name, dtype, seed):
    c = conf(name)
    model = dict(c["model"], **SMOKE[name])
    family = lm.layer_module(c["reference"])
    got = make_weights(model, seed, getattr(torch, dtype), "cpu", family)
    assert digest(got) == DIGESTS[name, dtype, seed]


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_the_work_is_that_frozen(name):
    c = conf(name)
    model, family = c["model"], lm.layer_module(c["reference"])
    got = (work.prefill_flops(model, 4, 2048, family), work.train_flops(model, 8, 2048, family),
           work.param_count(model, family))
    assert got == COUNTS[name]
