"""prefill_tokens_per_s: the prompt tokens of every batch the window ran,
over the time from the window's start to the end of the last batch."""


def read(ctx):
    if ctx.kind != "prefill":
        return None
    w = ctx.window
    return len(w.units) * w.unit_tokens / (w.end - w.start)
