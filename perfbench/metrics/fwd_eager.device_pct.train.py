"""The training step's forward outside the port's kernels: device time
under ``mfv.forward`` and ``mfv.loss`` (patch embedding, casts, the heads,
the logit sum, the CE) less what the forward Functions (K1 to K4)
launched, over all device time."""
from perfbench.metrics import _spans

FUNCTIONS = ("_AttentionBlock", "_MlpBlock", "_MlpBlockFinalLN",
             "_FusionCls")


def read(r):
    return _spans.device_pct(r, ("mfv.forward", "mfv.loss"), FUNCTIONS)
