"""backward_ms.train: device time of the program's ``train.backward`` spans
(each microbatch's backward, remat's recompute within it, and the fp32
gradient accumulation) per ``train.step``, in the readers' traced stretch
(portbench.spans), in ms."""

from portbench import spans


def read(ctx):
    if ctx.kind != "train":
        return None
    return spans.per_step_ms(ctx, "train.backward")
