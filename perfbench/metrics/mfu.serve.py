"""The serving step's share of the bf16 peak: the model's FLOPs a pair
(``yardstick.serve_flops_per_pair``) at the untraced window's pairs a
second."""
from perfbench import yardstick
from perfbench.metrics import _kernels


def read(r):
    return _kernels.mfu(r, yardstick.serve_flops_per_pair)
