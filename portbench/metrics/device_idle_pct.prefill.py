"""device_idle_pct.prefill: the share of the traced stretch's wall in which no
operation ran on the device, in %."""


def read(ctx):
    if ctx.kind != "prefill" or ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
