"""The optimizer's share of the training step's device time: device time
under ``mfv.optim`` (``torch.optim.Adam`` over every parameter), over all
device time."""
from perfbench.metrics import _spans


def read(r):
    return _spans.device_pct(r, ("mfv.optim",))
