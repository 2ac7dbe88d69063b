"""The host's milliseconds to enqueue one served forward: the median over
the slice of ``mfv.serve``'s host time, less the profiler's waits for
room in the device's queue."""
from perfbench.metrics import _spans


def read(r):
    return _spans.host_ms(r, "mfv.serve")
