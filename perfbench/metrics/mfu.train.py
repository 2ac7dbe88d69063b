"""The training step's share of the bf16 peak: the model's FLOPs a sample
(``yardstick.train_flops_per_sample``, no recompute counted) at the
untraced window's samples a second."""
from perfbench import yardstick
from perfbench.metrics import _kernels


def read(r):
    return _kernels.mfu(r, yardstick.train_flops_per_sample)
