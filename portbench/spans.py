"""The program's spans in a traced run: device time by span, the caching
allocator's retries, and idle gaps by span.

``portbench.trace`` reduces its traced stretch to aggregates and keeps no
event, so the metrics that read the program's spans (``train.*`` and
``lm.*``, opened by ``repro_torch.telemetry.ranges``) profile a stretch of
their own: the ``profiled_units`` units of the traffic that follow the
traced stretch, once per run, kept on the readers' context. Without a
device trace (the CPU), or in a program that opens no span, the readers
find nothing and return None.

* ``busy_s``: the union of the intervals in which the device ran an
  operation, as ``portbench.trace`` takes it, with device-side user
  annotations left out: under CUDA a ``record_function`` range is one, and
  it covers its kernels and the gaps between them;
* ``spans``: span name -> (device seconds, count): how many host ranges of
  that name the stretch opened, and the union of the device intervals of
  every operation whose launch (the host runtime call of the same
  correlation id, on any thread) starts inside one of them;
* ``allocator``: the caching allocator's retries in the stretch
  (``num_alloc_retries``): a retry frees cached blocks with ``cudaFree``,
  which waits for the device;
* ``idle_gaps``: ``portbench.trace``'s, each prefixed with the innermost
  span open at the gap's middle (``train.optimizer > aten::mul``).
"""

from __future__ import annotations

import bisect
import dataclasses
import typing

import torch

from portbench.trace import MIN_GAP_US, NAME_CHARS, _merge

#: The program's spans that the metrics read.
SPAN_NAMES = ("train.step", "train.forward", "train.backward", "train.optimizer",
              "lm.attention", "lm.ssm", "lm.ffn")
NO_OPERATION = "host (no operation)"
#: Host events looked back through for the one that holds an instant.
LOOKBACK = 4000


class Event(typing.NamedTuple):
    """One event of a profiler's trace, times in µs."""
    name: str
    on_device: bool          # a CUDA event (kernel, copy, set, annotation)
    start: float
    end: float
    id: int                  # correlation id
    annotation: bool         # a user annotation


@dataclasses.dataclass
class SpanTrace:
    busy_s: float
    spans: dict              # name -> (device seconds, count)
    allocator: int           # allocator retries in the stretch
    idle_gaps: list          # [[span > host op, seconds]]


def _innermost(host: list, starts: list, t: float, default: str | None) -> str | None:
    """The name of the innermost of ``host`` (sorted (start, end, name))
    that holds ``t``: the one that started last."""
    k = bisect.bisect_right(starts, t) - 1
    for j in range(k, max(k - LOOKBACK, -1), -1):
        if host[j][1] >= t:
            return host[j][2]
    return default


def _holds(intervals: list):
    """A test of whether an instant lies in the union of ``intervals``."""
    merged = _merge(intervals)
    starts = [a for a, _ in merged]

    def holds(t: float) -> bool:
        k = bisect.bisect_right(starts, t) - 1
        return k >= 0 and merged[k][1] >= t

    return holds


def reduce(events: list) -> tuple[float, dict, list]:
    """(busy seconds, spans, idle gaps) of a trace's :class:`Event` list."""
    device = [e for e in events if e.on_device and not e.annotation]
    host = [e for e in events if not e.on_device]
    merged = _merge([(e.start, e.end) for e in device])
    busy = sum(b - a for a, b in merged) * 1e-6
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)
            if merged[i + 1][0] - merged[i][1] >= MIN_GAP_US]
    # A kernel, copy or set shares its correlation id with the runtime or
    # driver call that launched it (cudaLaunchKernel, cuLaunchKernel, ...).
    launched = {e.id: e.start for e in host if e.name.startswith("cu")}
    ranges: dict = {}
    for e in host:
        if e.name in SPAN_NAMES:
            ranges.setdefault(e.name, []).append((e.start, e.end))
    spans = {}
    for name, rs in ranges.items():
        holds = _holds(rs)
        # The union, as for busy_s: a kernel may start before the one ahead
        # of it on the stream has ended.
        mine = _merge([(e.start, e.end) for e in device
                       if e.id in launched and holds(launched[e.id])])
        spans[name] = (sum(b - a for a, b in mine) * 1e-6, len(rs))
    ops = sorted((e.start, e.end, e.name) for e in host if e.name not in SPAN_NAMES)
    # The enclosing span first where two start together.
    opened = sorted(((a, b, name) for name, rs in ranges.items() for a, b in rs),
                    key=lambda s: (s[0], -s[1]))
    op_starts, span_starts = [a for a, _, _ in ops], [a for a, _, _ in opened]
    idle: dict = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        name = _innermost(ops, op_starts, mid, NO_OPERATION)
        around = _innermost(opened, span_starts, mid, None)
        if around is not None:
            name = f"{around} > {name}"
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
    top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return busy, spans, [[name[:NAME_CHARS], sec] for name, sec in top]


def events(prof) -> list:
    """A finished ``torch.profiler.profile``'s events, read from its raw
    results (building the profiler's own event objects and their tree
    takes many times as long)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() * 1e-3
        out.append(Event(e.name(), e.device_type() == DeviceType.CUDA, start,
                         start + e.duration_ns() * 1e-3, e.correlation_id(),
                         e.is_user_annotation()))
    return out


def profile(run, device) -> SpanTrace:
    """Run ``run()`` on the CUDA ``device`` under the profiler and reduce
    its trace."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    retries = lambda: torch.cuda.memory_stats(device).get("num_alloc_retries", 0)
    before = retries()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize(device)
    busy, spans, gaps = reduce(events(prof))
    return SpanTrace(busy_s=busy, spans=spans, allocator=retries() - before, idle_gaps=gaps)


def stretch(ctx) -> SpanTrace | None:
    """The readers' stretch: the ``profiled_units`` units after the traced
    stretch, profiled on the first call and kept on ``ctx``; None where the
    traced stretch saw no device time."""
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    if getattr(ctx, "span_trace", None) is None:
        traffic = ctx.traffic
        n = traffic.mix["profiled_units"]
        first = len(ctx.window.units) + n
        ctx.span_trace = profile(lambda: [traffic.run_unit(first + j) for j in range(n)],
                                 torch.device(traffic.device))
    return ctx.span_trace


def per_step_ms(ctx, name: str) -> float | None:
    """Device ms of span ``name`` per ``train.step`` in the readers' stretch."""
    st = stretch(ctx)
    if st is None:
        return None
    sec, _ = st.spans.get(name, (0.0, 0))
    steps = st.spans.get("train.step", (0.0, 0))[1]
    return 1e3 * sec / steps if steps and sec > 0 else None


def busy_pct(ctx, name: str) -> float | None:
    """Device time of span ``name`` as a share of the stretch's busy time, in %."""
    st = stretch(ctx)
    if st is None or st.busy_s <= 0:
        return None
    sec, _ = st.spans.get(name, (0.0, 0))
    return 100.0 * sec / st.busy_s if sec > 0 else None


def retries_per_step(ctx) -> float | None:
    """The allocator's retries per ``train.step`` in the readers' stretch."""
    st = stretch(ctx)
    if st is None:
        return None
    steps = st.spans.get("train.step", (0.0, 0))[1]
    return st.allocator / steps if steps else None
