"""The device's kernels a training step: kernels in the traced slice over
its steps."""
from perfbench.metrics import _spans


def read(r):
    return _spans.kernels_per_step(r)
