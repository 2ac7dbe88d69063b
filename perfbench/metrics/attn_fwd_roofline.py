"""K1 (K9 past 256 tokens), the attention half's forward: its calls'
least time (``yardstick.attn_fwd_bound``) over the device time of the
kernels ``_AttentionBlock`` launches."""
from perfbench import yardstick
from perfbench.metrics import _kernels

OPS = ("_AttentionBlock",)


def read(r):
    s = _kernels.shapes(r)
    return _kernels.roofline(r, OPS, yardstick.attn_fwd_bound(
        s["B"], s["N"], s["D"], s["heads"]))
