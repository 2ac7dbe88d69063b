"""One ``torch.profiler`` window over a slice of steps, reduced to what the
per-layer readers take.

The slice runs inside the benchmark's own span ``perfbench.window``; its
start and end bound the traced window. From the trace:

- ``busy_s``: the union of the device's kernel intervals inside the window;
- ``op_s`` and ``op_calls``: the device seconds of the kernels that each
  host operator launched itself (the profiler's self device time, by
  operator name: an autograd Function's name for the kernels its forward
  launches, ``<Function>Backward`` for its backward's), and how often that
  operator ran. A kernel launched through a PyTorch operator inside a
  Function counts for that operator, not for the Function;
- the longest idle gaps, each named by the innermost host operator open
  at its middle.

Beside them the reading carries the untraced window's rate, so that what
the profiler costs the slice shows (``Reading.cost``) and a share of the
peak is read over the whole window, free of that cost.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

SPAN = "perfbench.window"
# the profiler's own entries: a launch that waited for room in the queue
# (the profiler also hands it the device time of those kernels, which
# their operators already count) and the profiler's buffer handling
PROFILER = ("Command Buffer Full", "Activity Buffer Request", "Buffer Flush")


@dataclasses.dataclass
class Reading:
    """What a per-layer reader gets: the trace of the slice and the
    cell's sizes."""
    window_s: float          # the traced window (the span's length)
    busy_s: float            # device busy inside it
    kernel_s: float          # the sum of kernel times inside it
    op_s: dict               # launching operator -> device seconds
    op_calls: dict           # operator -> calls in the window
    steps: int               # steps (forwards or training steps) run
    samples: int             # pairs or samples those steps took
    window_rate: float       # pairs or samples a second, untraced window
    config: dict
    traffic: dict
    device_ops: list         # [[operator, seconds]] the ten largest
    idle_gaps: list          # [[host operator, seconds]] the ten longest

    def cost(self) -> float:
        """The traced slice's seconds over the seconds its samples take at
        the untraced window's rate, less 1: what tracing costs."""
        return self.window_s * self.window_rate / self.samples - 1.0


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def traced(run_slice: Callable[[], tuple], config: dict, traffic: dict,
           window_rate: float) -> Reading:
    """Trace ``run_slice() -> (steps, samples)``, which ends with the
    device drained, and reduce the trace; ``window_rate`` is the untraced
    window's pairs or samples a second."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(SPAN):
            steps, samples = run_slice()
    events = prof.events()
    span = [e for e in events if e.name == SPAN
            and e.device_type == DeviceType.CPU]
    if not span:
        raise RuntimeError(f"the trace holds no {SPAN!r} span")
    w0, w1 = span[0].time_range.start, span[0].time_range.end
    kern = [(max(e.time_range.start, w0), min(e.time_range.end, w1))
            for e in events if e.device_type == DeviceType.CUDA
            and e.name not in PROFILER]
    kern = [(s, e) for s, e in kern if e > s]
    busy = _union(kern)
    busy_us = sum(e - s for s, e in busy)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:10]
    cpu = [e for e in events if e.device_type == DeviceType.CPU
           and e.name != SPAN and e.name not in PROFILER]
    idle = []
    for length, s, e in gaps:
        mid = (s + e) / 2
        open_ = [c for c in cpu
                 if c.time_range.start <= mid <= c.time_range.end]
        name = (max(open_, key=lambda c: (c.time_range.start,
                                          -c.time_range.end)).name
                if open_ else "no host operator")
        idle.append([name, length / 1e6])
    op_s, op_calls = {}, {}
    for a in prof.key_averages():
        if a.device_type != DeviceType.CPU or a.key in PROFILER + (SPAN,):
            continue
        op_calls[a.key] = a.count
        if a.self_device_time_total > 0:
            op_s[a.key] = a.self_device_time_total / 1e6
    top = sorted(op_s.items(), key=lambda kv: -kv[1])[:10]
    return Reading(window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6,
                   kernel_s=sum(e - s for s, e in kern) / 1e6, op_s=op_s,
                   op_calls=op_calls, steps=steps, samples=samples,
                   window_rate=window_rate,
                   config=config, traffic=traffic,
                   device_ops=[[k, v] for k, v in top], idle_gaps=idle)
