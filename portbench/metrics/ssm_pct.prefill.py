"""ssm_pct.prefill: device time of the program's ``lm.ssm`` spans as a
share of the device's busy time, in the readers' traced stretch of prefill
batches (portbench.spans), in %."""

from portbench import spans


def read(ctx):
    if ctx.kind != "prefill":
        return None
    return spans.busy_pct(ctx, "lm.ssm")
