"""The share of the training step's device time outside the port's
kernels: every kernel but those the forward and backward Functions that
the roofline readers below attribute (K1 to K5, K7) launch: patch
embedding, heads, loss, K4's recomputed backward, Adam, casts and
copies."""
import importlib

ROOFLINES = ("attn_fwd_roofline", "mlp_fwd_roofline", "fusion_head_roofline",
             "attn_bwd_roofline", "mlp_bwd_roofline")
PORT_OPS = tuple(op for name in ROOFLINES for op in importlib.import_module(
    f"perfbench.metrics.{name}").OPS)


def read(r):
    total = sum(r.op_s.values())
    if total <= 0:
        return None
    port = sum(r.op_s.get(k, 0.0) for k in PORT_OPS)
    return 100.0 * (total - port) / total, None
