"""train_tokens_per_s: the tokens of every step the window ran, over the
time from the window's start to the device's end of the last step."""


def read(ctx):
    if ctx.kind != "train":
        return None
    w = ctx.window
    return len(w.units) * w.unit_tokens / (w.end - w.start)
