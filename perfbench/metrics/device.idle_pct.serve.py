"""The share of the traced serving window in which no kernel ran."""
from perfbench.metrics import _kernels


def read(r):
    return _kernels.idle(r)
