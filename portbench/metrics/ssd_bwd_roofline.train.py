"""ssd_bwd_roofline.train: the SSD scan's gradient bound at one call's shape
(portbench.work.ssd_bwd_work) over the mean device time of a call of the
backward chain (the kernels named ssd_bwd_*; calls from the program's
launch counter) in the traced training steps, in %."""

from portbench import work


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None:
        return None
    calls = ctx.trace.counters.get("ssd_scan_bwd", 0)
    seconds = ctx.trace.device_seconds(("ssd_bwd_", "_kernel"))
    shape = ctx.traffic.ssd_call()
    if not calls or seconds <= 0 or shape is None:
        return None
    *dims, dtype = shape
    return work.share_pct(work.bound_s(*work.ssd_bwd_work(*dims, dtype), dtype), seconds / calls)
