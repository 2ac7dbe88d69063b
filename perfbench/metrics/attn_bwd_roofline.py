"""K5, the attention half's backward: its calls' least time
(``yardstick.attn_bwd_bound``) over the device time of the kernels
``_AttentionBlockBackward`` launches."""
from perfbench import yardstick
from perfbench.metrics import _kernels

OPS = ("_AttentionBlockBackward",)


def read(r):
    s = _kernels.shapes(r)
    return _kernels.roofline(r, OPS, yardstick.attn_bwd_bound(
        s["B"], s["N"], s["D"], s["heads"]))
