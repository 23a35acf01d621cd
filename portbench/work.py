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


def layer_params(model: dict) -> int:
    """Parameters of one layer, as the program's layout holds them."""
    d = model["d_model"]
    n = 0
    if model["num_heads"]:
        hd = model["head_dim"] or d // model["num_heads"]
        q, kv = model["num_heads"] * hd, model["num_kv_heads"] * hd
        n += d + d * q + 2 * d * kv + q * d                     # ln1, wq, wk, wv, wo
    if model["ssm_state"]:
        di, ns, h, _ = _ssm_sizes(model)
        w = model["ssm_conv_width"]
        n += d                                                   # ln_ssm
        n += 2 * d * di + 2 * d * ns + d * h                     # w_z, w_x, w_b, w_c, w_dt
        n += (w + 1) * (di + 2 * ns)                             # conv taps and biases
        n += 3 * h + di + di * d                                 # a_log, d_skip, dt_bias, norm, out
    if model.get("hybrid"):
        n += 2 * d                                               # the two branch norms
    if model["d_ff"]:
        n += d + 3 * d * model["d_ff"]                           # ln2, gate, up, down
    return n


def param_count(model: dict) -> int:
    """N: every parameter the model holds (the padded embedding rows, an
    untied head, the final norm)."""
    vp = padded_vocab(model)
    head = 0 if model["tie_embeddings"] else vp * model["d_model"]
    return model["num_layers"] * layer_params(model) + vp * model["d_model"] + model["d_model"] + head


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


def forward_flops(model: dict, rows: int, seq: int, head_positions: int) -> int:
    """Model FLOPs of one forward over ``rows`` × ``seq`` tokens with the
    head at ``head_positions`` positions of each row."""
    d = model["d_model"]
    tokens = rows * seq
    f = 2 * model["num_layers"] * layer_params(model) * tokens
    f += 2 * d * model["vocab_size"] * rows * head_positions
    if model["ssm_state"]:
        f += model["num_layers"] * ssd_products_per_layer(model, rows, seq)
    if model["num_heads"]:
        f += model["num_layers"] * attention_products_per_layer(model, rows, seq)
    return f


def prefill_flops(model: dict, rows: int, seq: int) -> int:
    """A prefill batch: every layer for every prompt token, the head at each
    prompt's last position."""
    return forward_flops(model, rows, seq, 1)


def train_flops(model: dict, rows: int, seq: int) -> int:
    """A training step over ``rows`` × ``seq`` tokens: forward and backward,
    three forwards, the head at every position."""
    return 3 * forward_flops(model, rows, seq, seq)


def share_pct(bound: float, measured: float) -> float:
    """A share of a bound or a peak, in %: the least time over the time
    taken."""
    return 100.0 * bound / measured
