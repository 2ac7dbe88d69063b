"""K2 and K3, the MLP half's forward (K3 with the final LayerNorm): their
calls' least time (``yardstick.mlp_fwd_bound``) over the device time of
the kernels ``_MlpBlock`` and ``_MlpBlockFinalLN`` launch."""
from perfbench import yardstick
from perfbench.metrics import _kernels

OPS = ("_MlpBlock", "_MlpBlockFinalLN")


def read(r):
    s = _kernels.shapes(r)
    return _kernels.roofline(r, OPS, yardstick.mlp_fwd_bound(
        s["B"], s["N"], s["D"], s["H"]))
