"""toy_ffn_launches: calls of the toy family's expert FFN per traced unit,
from a launch counter that this reader alone declares."""

COUNTERS = {"toy_ffn": ("portbench.tests.toy_family", "moe_ffn")}


def read(ctx):
    if ctx.trace is None or not ctx.trace.counters.get("toy_ffn"):
        return None
    return ctx.trace.counters["toy_ffn"] / ctx.traffic.mix["profiled_units"]
