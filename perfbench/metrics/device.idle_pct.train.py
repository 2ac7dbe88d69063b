"""The share of the traced training window in which no kernel ran."""
from perfbench.metrics import _kernels


def read(r):
    return _kernels.idle(r)
