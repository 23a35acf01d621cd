"""gemm_f32_roofline.prefill: the 3xTF32 bound of the weight products a
prefill batch gives the program's ``gemm_f32`` kernel over that kernel's
device time (the kernels named gemm_f32_kernel) in the traced prefill
batches, in %.

The products are counted from the configuration's sizes, frozen here: of
each layer's weight products x (M, K) @ W (K, N), at M = rows × seq_len
tokens, those with N over 128 columns (the projections, the FFN; not the
SSD's B, C and dt, nor the head at the last position). Each product's bound
is the larger of three TF32 products at the tensor cores' rate
(portbench.work.bound_s of 3 · 2MNK in float32) and its operands read and
y written once in fp32. None where the trace shows no such kernel, or where
its calls are not one per counted product and traced batch (then the count
no longer describes the kernel's work).
"""

from portbench import work

#: Products of at most this many output columns are not counted.
NARROW = 128
#: The three TF32 products of one fp32-accurate product.
SPLIT_PRODUCTS = 3


def layer_products(model: dict) -> list[tuple[int, int]]:
    """(K, N) of each weight product of one layer, as the program holds
    the weights (portbench.inputs.default_layout)."""
    d, out = model["d_model"], []
    if model["num_heads"]:
        hd = model["head_dim"] or d // model["num_heads"]
        q, kv = model["num_heads"] * hd, model["num_kv_heads"] * hd
        out += [(d, q), (d, kv), (d, kv), (q, d)]
    if model["ssm_state"]:
        di = model["ssm_expand"] * d
        out += [(d, di), (d, di), (d, model["ssm_state"]), (d, model["ssm_state"]),
                (d, di // model["ssm_head_dim"]), (di, d)]
    if model["d_ff"]:
        out += [(d, model["d_ff"]), (d, model["d_ff"]), (model["d_ff"], d)]
    return out


def read(ctx):
    if ctx.kind != "prefill" or ctx.trace is None:
        return None
    t = ctx.traffic
    name = ("gemm_f32_kernel",)
    seconds = ctx.trace.device_seconds(name)
    calls = sum(n for k, (_, n) in ctx.trace.kernels.items() if all(s in k for s in name))
    m, units = t.rows * t.seq, t.mix["profiled_units"]
    counted = [(k, n) for k, n in layer_products(t.model) if n > NARROW]
    if seconds <= 0 or calls != units * t.model["num_layers"] * len(counted):
        return None
    per_layer = sum(work.bound_s(4 * (m * k + k * n + m * n), SPLIT_PRODUCTS * 2 * m * n * k,
                                 "float32") for k, n in counted)
    return work.share_pct(units * t.model["num_layers"] * per_layer, seconds)
