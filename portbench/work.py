"""The benchmark's frozen arithmetic: the work a task needs, the H100's
data-sheet peaks, and the shares built from them.

Nothing here reads the program. Every count comes from a configuration
file's sizes (``portbench/configs/<name>.json``, its ``model`` group) and
the shapes a traffic mix runs, so a share reads the same work whatever
implements it.

* **Peaks** (NVIDIA H100 SXM data sheet, dense, at the 700 W limit): 989
  TFLOP/s for bf16 operands, 495 TFLOP/s (TF32) for fp32 operands, the
  fastest dense rate the sheet gives for each dtype, and 3.35 TB/s of HBM.
  An fp32-accurate tensor-core product (3xTF32, as the port's SSD kernels
  compute) can pass the 67 TFLOP/s CUDA-core rate, so no share here is
  taken against that rate.
* **Model FLOPs** count the products of matrices the outputs need: every
  parameter of a layer as one multiply-add per token (the 6·N convention,
  which covers the projections, the FFN and the depthwise conv taps), the
  head over the real vocabulary, the SSD's own products and attention's
  QKᵀ and AV over the causal, windowed context. The input-embedding lookup
  and remat's recomputation are not counted. A prefill runs every layer
  for every prompt token and the head at each prompt's last position; a
  training step is three forwards of every token, head included.
* **A kernel's bound** is the larger of its operations over the peak of
  its operand dtype and its bytes over 3.35 TB/s, each input read once and
  each output written once, at the unpadded sequence length.

The parameters are those of the family's layout (:func:`portbench.inputs
.layout`, ``family`` the family's reference module). A family may define
``forward_flops(model, rows, seq, head_positions)``, for layers that
differ in kind or hold experts: :func:`prefill_flops` and
:func:`train_flops` take it where it exists, and the count below where
not.

The SSD counts are frozen copies of ``chip_smoke.py``'s ``ssd_fwd_work``
and ``ssd_bwd_work`` with two changes: the backward reads only the
function's inputs (x, dt, a, B, C, dy, dh_final), not the forward's
workspaces (the per-chunk cumsum, CBᵀ, the entering states) that one
implementation keeps and another recomputes; and no product is priced by
the class of its operands.
"""

from __future__ import annotations

import math

BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}
#: The program pads the vocabulary rows of its embedding and head to this.
VOCAB_PAD = 128


def peak_flops(dtype: str) -> float:
    """The fastest dense rate of the data sheet for operands of ``dtype``."""
    return PEAK_FLOPS[dtype]


def padded_vocab(model: dict) -> int:
    return math.ceil(model["vocab_size"] / VOCAB_PAD) * VOCAB_PAD


def _ssm_sizes(model: dict) -> tuple[int, int, int, int]:
    """(d_inner, state N, heads H, head size P) of the SSD mixer."""
    d_inner = model["ssm_expand"] * model["d_model"]
    return d_inner, model["ssm_state"], d_inner // model["ssm_head_dim"], model["ssm_head_dim"]


def held_params(model: dict, family) -> tuple[int, int]:
    """(top parameters, the layers' parameters) of the family's layout."""
    from portbench.inputs import layout     # inputs reads padded_vocab from here

    top, groups = layout(model, family)
    return (sum(math.prod(shape) for shape, _, _ in top.values()),
            sum(len(layers) * math.prod(shape) for layers, leaves in groups.values()
                for shape, _, _ in leaves.values()))


def param_count(model: dict, family) -> int:
    """N: every parameter the model holds (the padded embedding rows, an
    untied head, the final norm)."""
    return sum(held_params(model, family))


def ssd_fwd_work(b: int, s: int, h: int, p: int, n: int, q: int,
                 dtype: str) -> tuple[int, int]:
    """(bytes, operations) of one SSD scan from a zero state: x, dt, a, B, C
    read once, y and the final state written once (x, B, C, y in ``dtype``,
    the rest fp32); CBᵀ once per (batch row, chunk), the causal half of the
    decay-weighted (CBᵀ)x per head, C·h_inᵀ, the chunk states and their
    recurrence."""
    elt = ELEMENT_BYTES[dtype]
    full, rem = divmod(s, q)
    pairs = full * q * (q + 1) // 2 + rem * (rem + 1) // 2
    nbytes = elt * (2 * b * s * h * p + 2 * b * s * n) + 4 * (b * s * h + h + b * h * p * n)
    ops = (2 * pairs * b * n + 2 * pairs * b * h * p + 4 * b * s * h * p * n
           + 2 * b * -(-s // q) * h * p * n)
    return nbytes, ops


def ssd_bwd_work(b: int, s: int, h: int, p: int, n: int, q: int,
                 dtype: str) -> tuple[int, int]:
    """(bytes, operations) of the SSD scan's gradient: x, dt, a, B, C, dy and
    dh_final read once, dx, ddt, da, dB and dC written once (x, B, C, dy,
    dx, dB, dC in ``dtype``, the rest fp32); the four (P, N) products per
    (row, head, step), the causal halves of (L ∘ CBᵀ)ᵀ dy and of dy xᵀ per
    head, R·C and R·B per (row, chunk), and the state terms' elementwise
    work."""
    elt = ELEMENT_BYTES[dtype]
    full, rem = divmod(s, q)
    pairs = full * q * (q + 1) // 2 + rem * (rem + 1) // 2
    nbytes = elt * (3 * b * s * h * p + 4 * b * s * n) + 4 * (2 * b * s * h + 2 * h + b * h * p * n)
    causal = 2 * pairs * b * h * p
    ops = causal + (8 * b * s * h * p * n + causal + 4 * pairs * b * n) + 2 * b * s * h * n
    return nbytes, ops


def bound_s(nbytes: int, ops: int, dtype: str) -> float:
    """The least time of work that moves ``nbytes`` and computes ``ops``
    with operands of ``dtype``: the larger of the two times."""
    return max(nbytes / BYTES_PER_S, ops / peak_flops(dtype))


def ssd_products_per_layer(model: dict, rows: int, seq: int) -> int:
    """The SSD's products for ``rows`` sequences of ``seq`` tokens through one
    layer (ssd_fwd_work's operations)."""
    _, ns, h, p = _ssm_sizes(model)
    return ssd_fwd_work(rows, seq, h, p, ns, model["ssm_chunk"], "float32")[1]


def attention_products_per_layer(model: dict, rows: int, seq: int) -> int:
    """QKᵀ and AV over the causal context, cut to the sliding window."""
    hd = model["head_dim"] or model["d_model"] // model["num_heads"]
    w = model.get("sliding_window") or seq
    # Query t attends to min(t + 1, w) keys.
    full = max(seq - w, 0)
    keys = full * w + sum(min(t + 1, w) for t in range(seq - full))
    return 4 * hd * model["num_heads"] * keys * rows


def head_flops(model: dict, rows: int, head_positions: int) -> int:
    """The head over the real vocabulary at ``head_positions`` of each row."""
    return 2 * model["d_model"] * model["vocab_size"] * rows * head_positions


def forward_flops(model: dict, rows: int, seq: int, head_positions: int, family) -> int:
    """Model FLOPs of one forward over ``rows`` × ``seq`` tokens with the
    head at ``head_positions`` positions of each row; the family's count
    where it defines one."""
    if hasattr(family, "forward_flops"):
        return family.forward_flops(model, rows, seq, head_positions)
    tokens = rows * seq
    f = 2 * held_params(model, family)[1] * tokens
    f += head_flops(model, rows, head_positions)
    if model["ssm_state"]:
        f += model["num_layers"] * ssd_products_per_layer(model, rows, seq)
    if model["num_heads"]:
        f += model["num_layers"] * attention_products_per_layer(model, rows, seq)
    return f


def prefill_flops(model: dict, rows: int, seq: int, family) -> int:
    """A prefill batch: every layer for every prompt token, the head at each
    prompt's last position."""
    return forward_flops(model, rows, seq, 1, family)


def train_flops(model: dict, rows: int, seq: int, family) -> int:
    """A training step over ``rows`` × ``seq`` tokens: forward and backward,
    three forwards, the head at every position."""
    return 3 * forward_flops(model, rows, seq, seq, family)


def share_pct(bound: float, measured: float) -> float:
    """A share of a bound or a peak, in %: the least time over the time
    taken."""
    return 100.0 * bound / measured
