"""K7, the MLP half's backward (also under K3's backward, after its
final LayerNorm's eager backward): its calls' least time
(``yardstick.mlp_bwd_bound``) over the device time of the kernels
``_MlpBlockBackward`` and ``_MlpBlockFinalLNBackward`` launch."""
from perfbench import yardstick
from perfbench.metrics import _kernels

OPS = ("_MlpBlockBackward", "_MlpBlockFinalLNBackward")


def read(r):
    s = _kernels.shapes(r)
    return _kernels.roofline(r, OPS, yardstick.mlp_bwd_bound(
        s["B"], s["N"], s["D"], s["H"]))
