"""The training step's backward outside the port's kernels: device time
under ``mfv.backward`` (patch-embedding dW, K4's recomputed plain
backward, the heads' and the CE's gradients, casts) less what the
backward Functions (K5, K7) launched, over all device time."""
from perfbench.metrics import _spans

FUNCTIONS = ("_AttentionBlockBackward", "_MlpBlockBackward",
             "_MlpBlockFinalLNBackward")


def read(r):
    return _spans.device_pct(r, ("mfv.backward",), FUNCTIONS)
