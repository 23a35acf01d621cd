"""alloc_retries.train: the caching allocator's retries (each frees cached
blocks and waits for the device) per ``train.step``, in the readers' traced
stretch (portbench.spans)."""

from portbench import spans


def read(ctx):
    if ctx.kind != "train":
        return None
    return spans.retries_per_step(ctx)
