"""setup_s: seconds from the process's start to the window's start (the
kernels built or loaded, the weights and tokens made, the warm-up)."""


def read(ctx):
    return ctx.setup_s
