"""What the span readers share: a part of the step's device time by the
port's spans (``spans.SpanReading``), a span's host milliseconds a call,
the device's kernels a step. Each gives None on a reading without the
spans (a trace of a program that has none)."""
from __future__ import annotations

import statistics


def device_pct(r, spans: tuple, functions: tuple = ()):
    """100 x the device seconds under ``spans`` (each span with what ran
    inside it), less those of the kernels that ``functions`` (the port's
    autograd Functions) launched, over all device seconds by operator."""
    under = getattr(r, "span_total_s", {})
    total = sum(r.op_s.values())
    if total <= 0 or not any(s in under for s in spans):
        return None
    dev = (sum(under.get(s, 0.0) for s in spans)
           - sum(r.op_s.get(f, 0.0) for f in functions))
    return 100.0 * dev / total, None


def host_ms(r, span: str):
    """The median of ``span``'s calls' host milliseconds, the queue's
    waits left out."""
    calls = getattr(r, "span_host_s", {}).get(span)
    if not calls:
        return None
    return 1e3 * statistics.median(calls), None


def kernels_per_step(r):
    """The device's kernels in the traced slice over its steps."""
    n = getattr(r, "kernels", 0)
    if n <= 0 or r.steps <= 0:
        return None
    return n / r.steps, None
