"""K4, the CA fusion head's forward: its calls' least time
(``yardstick.fusion_head_bound``) over the device time of the kernels
``_FusionCls`` launches."""
from perfbench import yardstick
from perfbench.metrics import _kernels

OPS = ("_FusionCls",)


def read(r):
    s = _kernels.shapes(r)
    return _kernels.roofline(r, OPS, yardstick.fusion_head_bound(
        s["B"], s["N"], s["D"], r.config["fusion_heads"]))
