"""Program spans: named ranges at the port's layer boundaries, seen by
``torch.profiler`` (and by every other consumer of PyTorch's record
functions) and free when no profiler is on.

:func:`span` opens one of :data:`SPANS` as an operator range, the kind of
range PyTorch opens around each ``aten`` op (``RecordScope::FUNCTION``), and
not as a user annotation (``record_function``). Under CUDA the profiler
turns a user annotation into a device-side event as well, one that covers
all of its kernels and the gaps between them, and a reader that sums the
device events then counts those gaps as work. An operator range leaves the
device trace kernels, copies and sets alone. A kernel belongs to a span
when the host call that launched it (the runtime event of the same
correlation id) starts inside the span, on whichever thread: the backward
launches from autograd's device thread while ``train.backward`` is open on
the caller's.

With no profiler active a span is one check of the profiler's state and
returns a shared :class:`contextlib.nullcontext`.
"""

from __future__ import annotations

import contextlib

import torch

#: The program's spans, each beside the benchmark metric that reads it
#: (``portbench/metrics/<metric>.py``).
SPANS = (
    "train.step",        # per-step divisor of the train.* metrics and alloc_retries.train
    "train.forward",     # forward_ms.train: each microbatch's loss_fn
    "train.backward",    # backward_ms.train: each microbatch's backward and fp32 accumulation
    "train.optimizer",   # optimizer_ms.train: adamw_update
    "lm.attention",      # attention_pct.prefill: a layer's attention block
    "lm.ssm",            # ssm_pct.prefill: a layer's SSM block
    "lm.ffn",            # ffn_pct.prefill: a layer's FFN (dense or MoE)
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records ``name`` as a range while a profiler
    is active, and enters nothing otherwise."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)
