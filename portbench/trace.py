"""The traced stretch: a few units of the cell's traffic under
``torch.profiler``, reduced to aggregates (nothing of the trace is
written to disk).

* ``busy_s``: the union of the intervals in which the device ran an
  operation (kernels, copies, sets), ``window_s`` the stretch's host wall,
  ending in a synchronize.
* ``kernels``: device seconds and calls by kernel name.
* ``counters``: what the program's launch counters counted in the stretch
  (one per call of a hand-written kernel chain): :data:`COUNTERS`, and
  those the cell's per-layer readers declare (a reader's module-level
  ``COUNTERS``, of the same form); a counter whose module or function the
  program lacks fails the run, as a kernel out of the readers' sight.
* ``device_ops``: the ten operations that took most device time;
  ``idle_gaps``: the device's idle time between operations, by the host
  operation that was running (the innermost one) at each gap's middle, the
  ten largest.
"""

from __future__ import annotations

import bisect
import dataclasses
import importlib
import time

import torch

#: The program's launch counters: name -> (module, function with ``.launches``).
COUNTERS = {
    "ssd_scan": ("repro_torch.kernels.ssd_scan.kernel", "ssd_scan_cuda"),
    "ssd_scan_bwd": ("repro_torch.kernels.ssd_scan.kernel", "ssd_scan_bwd_cuda"),
}
NAME_CHARS = 120
#: Idle gaps shorter than this are launch spacing, not waiting.
MIN_GAP_US = 5.0


def read_counters(counters: dict) -> dict[str, int]:
    """Each counter's ``launches`` now."""
    out = {}
    for name, (module, fn) in counters.items():
        out[name] = int(getattr(getattr(importlib.import_module(module), fn), "launches", 0))
    return out


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: dict            # name -> (device seconds, calls)
    counters: dict           # name -> calls in the stretch
    device_ops: list         # [[name, seconds]]
    idle_gaps: list          # [[host op, seconds]]

    def device_seconds(self, include, exclude=()) -> float:
        """Device seconds of the kernels whose names hold every string of
        ``include`` and none of ``exclude``."""
        return sum(sec for name, (sec, _) in self.kernels.items()
                   if all(s in name for s in include) and not any(s in name for s in exclude))


def _merge(intervals: list) -> list:
    merged: list = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _attribute(gaps: list, host: list) -> dict:
    """Seconds of idle gap by the innermost host event holding each gap's
    middle (host events nest; the one that started last holds it)."""
    host.sort()
    starts = [a for a, _, _ in host]
    out: dict = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        name = "host (no operation)"
        k = bisect.bisect_right(starts, mid) - 1
        for j in range(k, max(k - 4000, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        out[name] = out.get(name, 0.0) + (b - a) * 1e-6
    return out


def profile(run, device, counters: dict = COUNTERS) -> Trace:
    """Run ``run()`` under the profiler and reduce its trace, reading
    ``counters`` (name -> (module, function with ``.launches``)) around it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    before = read_counters(counters)
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        if cuda:
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    after = read_counters(counters)
    events = prof.events()
    on_device = [(e.time_range.start, e.time_range.end) for e in events
                 if e.device_type == DeviceType.CUDA]
    merged = _merge(on_device)
    busy = sum(b - a for a, b in merged) * 1e-6
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)
            if merged[i + 1][0] - merged[i][1] >= MIN_GAP_US]
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == DeviceType.CPU]
    idle = _attribute(gaps, host)
    kernels: dict = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
            sec, calls = kernels.get(e.key, (0.0, 0))
            kernels[e.key] = (sec + us * 1e-6, calls + e.count)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    return Trace(
        window_s=wall, busy_s=busy, kernels=kernels,
        counters={k: after[k] - before[k] for k in after},
        device_ops=[[name[:NAME_CHARS], sec] for name, (sec, _) in top],
        idle_gaps=[[name[:NAME_CHARS], sec]
                   for name, sec in sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
    )
