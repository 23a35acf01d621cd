"""forward_ms.train: device time of the program's ``train.forward`` spans
(each microbatch's loss) per ``train.step``, in the readers' traced stretch
(portbench.spans), in ms."""

from portbench import spans


def read(ctx):
    if ctx.kind != "train":
        return None
    return spans.per_step_ms(ctx, "train.forward")
