"""prefill_p95_ms: the 95th percentile, nearest rank, over the window's
prompts of the time from a batch's issue to its first tokens on the host
(every prompt of a batch waits as long as its batch)."""

import math


def read(ctx):
    if ctx.kind != "prefill":
        return None
    waits = sorted(t1 - t0 for t0, t1 in ctx.window.units)
    return 1e3 * waits[math.ceil(0.95 * len(waits)) - 1]
