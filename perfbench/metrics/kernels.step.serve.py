"""The device's kernels a served forward: kernels in the traced slice over
its forwards (the benchmark's own sum of the three logit sets counted
in)."""
from perfbench.metrics import _spans


def read(r):
    return _spans.kernels_per_step(r)
