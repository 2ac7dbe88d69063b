"""The port's spans (``mfvit_tpu_torch.ops.span``: ``mfv.step``,
``mfv.forward``, ``mfv.serve``, ...) in one profiler window, reduced to
what the span readers (``metrics/_spans.py``) take.

``reduce`` is one pure function over the window's events as plain tuples
(``Events``), times in microseconds. It gives, for each span name:

- ``span_calls``: how often it ran;
- ``span_host_s``: each call's host seconds, less the time the profiler's
  ``Command Buffer Full`` waits inside it took (a launch waiting for room
  in the device's queue: the device setting the pace, not host work);
- ``span_s`` and ``span_total_s``: the device seconds of the kernels
  attributed to it, and to it or any span inside it (``span_s`` holds
  those launched outside every span under ``none``).

A kernel belongs to the innermost port span open on the host when its
launch call ran, on any thread: ``loss.backward()`` launches from
autograd's device thread while the calling thread sits in
``mfv.backward``. Beside those, ``kernels``, the device's kernels in the
window, and ``idle_spans``, the ten longest stretches of the window with
no device activity, each named by the innermost port span open on the
window's thread at its middle (``none`` between them).

``events_of`` draws the events from a ``torch.profiler`` run with CPU
and CUDA activities whose window is ``trace.SPAN``; ``extend`` adds the
reduction to a ``trace.Reading``. Intervals merge with ``trace._union``;
``longest_gaps`` is ``trace.traced``'s own gap computation, for it to
call once it reduces the spans.
"""
from __future__ import annotations

import bisect
import dataclasses

from perfbench import trace

PREFIX = "mfv."
WAIT = "Command Buffer Full"
NONE = "none"


@dataclasses.dataclass
class Events:
    """One traced window's events, times in microseconds."""
    window: tuple        # (start, end) of the window's own span
    thread: int          # the thread that ran the window
    spans: list          # [(name, thread, start, end)] the port's spans
    waits: list          # [(start, end)] launches waiting for queue room
    launches: dict       # correlation -> (thread, host time) of a launch
    device: list         # [(correlation, start, end, is_kernel)]


@dataclasses.dataclass
class SpanReading(trace.Reading):
    """A ``trace.Reading`` with the reduction of the port's spans."""
    span_s: dict = dataclasses.field(default_factory=dict)
    span_total_s: dict = dataclasses.field(default_factory=dict)
    span_host_s: dict = dataclasses.field(default_factory=dict)
    span_calls: dict = dataclasses.field(default_factory=dict)
    kernels: int = 0
    port_launches: dict = dataclasses.field(default_factory=dict)
    idle_spans: list = dataclasses.field(default_factory=list)


class _Open:
    """The innermost span open at a time, among spans sorted by start."""

    def __init__(self, spans: list):
        self.spans = spans
        self.starts = [s[2] for s in spans]
        self.reach = []          # the latest end among spans[:i + 1]
        for s in spans:
            self.reach.append(max(s[3], self.reach[-1] if self.reach
                                  else s[3]))

    def at(self, t: float):
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.reach[i] >= t:
            if self.spans[i][3] >= t:
                return i
            i -= 1
        return None


def longest_gaps(busy: list, w0: float, w1: float, n: int = 10) -> list:
    """The ``n`` longest stretches of ``(w0, w1)`` that no interval of
    ``busy`` covers, as (length, start, end), longest first: the gaps
    ``trace.traced`` computes inline for its ``idle_gaps``."""
    edges = [w0] + [x for iv in trace._union(busy) for x in iv] + [w1]
    return sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:n]


def _parents(spans: list) -> list:
    """Each span's index of the innermost span of its thread around it
    (None at the top), spans sorted by (start, -end)."""
    parents, stacks = [], {}
    for i, (_, thread, start, end) in enumerate(spans):
        stack = stacks.setdefault(thread, [])
        while stack and spans[stack[-1]][3] < end:
            stack.pop()
        parents.append(stack[-1] if stack else None)
        stack.append(i)
    return parents


def reduce(ev: Events) -> dict:
    """The reduction the module's docstring sets out."""
    w0, w1 = ev.window
    spans = sorted(ev.spans, key=lambda s: (s[2], -s[3]))
    parents = _parents(spans)
    anywhere = _Open(spans)
    on_thread = _Open([s for s in spans if s[1] == ev.thread])
    self_us = [0.0] * len(spans)
    busy, kernels, outside = [], 0, 0.0
    for corr, start, end, is_kernel in ev.device:
        start, end = max(start, w0), min(end, w1)
        if end <= start:
            continue
        busy.append((start, end))
        kernels += bool(is_kernel)
        _, t = ev.launches.get(corr, (None, None))
        i = None if t is None else anywhere.at(t)
        if i is None:
            outside += end - start
        else:
            self_us[i] += end - start
    span_s, total_s, host_s, calls = {NONE: outside / 1e6}, {}, {}, {}
    waits = trace._union(ev.waits)
    wait_ends = [e for _, e in waits]
    for i, (name, _, start, end) in enumerate(spans):
        span_s[name] = span_s.get(name, 0.0) + self_us[i] / 1e6
        calls[name] = calls.get(name, 0) + 1
        j, k = bisect.bisect_right(wait_ends, start), i
        waited = 0.0
        while j < len(waits) and waits[j][0] < end:
            waited += min(end, waits[j][1]) - max(start, waits[j][0])
            j += 1
        host_s.setdefault(name, []).append((end - start - waited) / 1e6)
        seen = set()     # a name counts once along the chain
        while k is not None:
            if spans[k][0] not in seen:
                seen.add(spans[k][0])
                total_s[spans[k][0]] = (total_s.get(spans[k][0], 0.0)
                                        + self_us[i] / 1e6)
            k = parents[k]
    idle = []
    for length, s, e in longest_gaps(busy, w0, w1):
        i = on_thread.at((s + e) / 2)
        idle.append([NONE if i is None else on_thread.spans[i][0],
                     length / 1e6])
    return {"span_s": span_s, "span_total_s": total_s, "span_host_s": host_s,
            "span_calls": calls, "kernels": kernels, "idle_spans": idle}


def events_of(prof) -> Events:
    """The port's spans, the queue waits, the launch calls and the device
    activities of a ``torch.profiler.profile`` run whose window is the
    span ``trace.SPAN``, from the profiler's own events. As the profiler
    links them: an operator or a span carries no linked correlation; a
    runtime call (``cudaLaunchKernel``, ...) and a device activity carry
    the correlation of the operator they ran under, and share their own
    correlation with each other. A launch is placed at its runtime call,
    or at its operator's start where the call is missing."""
    from torch.autograd import DeviceType

    window, spans, waits, device = None, [], [], []
    ops, calls = {}, {}     # correlation -> (thread, host start)
    for e in prof.profiler.kineto_results.events():
        name, linked = e.name(), e.linked_correlation_id()
        start = e.start_ns() / 1e3
        end = start + e.duration_ns() / 1e3
        if name == WAIT:
            waits.append((start, end))
        elif e.device_type() == DeviceType.CUDA:
            if linked > 0 and name not in trace.PROFILER:
                device.append((e.correlation_id(), linked, start, end,
                               not name.startswith(("Memcpy", "Memset"))))
        elif linked > 0:        # the earliest runtime call of a launch
            c = e.correlation_id()
            if c not in calls or start < calls[c][1]:
                calls[c] = (e.start_thread_id(), start)
        else:
            ops[e.correlation_id()] = (e.start_thread_id(), start)
            if name == trace.SPAN and window is None:
                window = (start, end, e.start_thread_id())
            elif name.startswith(PREFIX):
                spans.append((name, e.start_thread_id(), start, end))
    if window is None:
        raise RuntimeError(f"the trace holds no {trace.SPAN!r} span")
    launches = {c: calls.get(c, ops.get(op)) for c, op, *_ in device}
    return Events(window[:2], window[2], spans, waits,
                  {c: at for c, at in launches.items() if at is not None},
                  [(c, s, e, k) for c, _, s, e, k in device])


def extend(base: trace.Reading, prof, port_launches: dict) -> SpanReading:
    """``base`` with the reduction of ``prof``'s events and the port's
    launches in the slice (``ops.launch_counts()`` after less before)."""
    fields = {f.name: getattr(base, f.name)
              for f in dataclasses.fields(trace.Reading)}
    return SpanReading(**fields, **reduce(events_of(prof)),
                       port_launches=port_launches)
