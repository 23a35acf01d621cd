"""train_mfu_pct: model FLOPs of the window's training steps (portbench.work
.train_flops) over the window's time and the peak of the weights' dtype,
in %."""

from portbench import work


def read(ctx):
    if ctx.kind != "train":
        return None
    w, t = ctx.window, ctx.traffic
    rate = len(w.units) * t.unit_flops / (w.end - w.start)
    return work.share_pct(rate, work.peak_flops(t.flops_dtype))
