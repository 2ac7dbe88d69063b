"""What the per-layer readers share: the cell's shapes; a kernel's share
of its roofline from the device seconds and calls of the operators that
launch it; the step's share of the bf16 peak; the device's idle share."""
from __future__ import annotations

from perfbench import yardstick


def shapes(r) -> dict:
    """B, N, D, H and heads of the cell's branches."""
    c, t = r.config, r.traffic
    return {"B": t["batch"], "N": (t["img_size"] // c["patch_size"]) ** 2 + 1,
            "D": c["hidden_size"], "H": c["intermediate_size"],
            "heads": c["num_attention_heads"]}


def roofline(r, ops: tuple, bound: tuple):
    """(100 x the calls' least seconds over their device seconds, what
    bounds it), or None where the trace holds no device time of ``ops``."""
    dev = sum(r.op_s.get(k, 0.0) for k in ops)
    calls = sum(r.op_calls.get(k, 0) for k in ops)
    if dev <= 0 or calls == 0:
        return None
    secs, by = bound
    return 100.0 * calls * secs / dev, by


def mfu(r, flops_per_sample):
    """The model's FLOPs of a pair or sample (``flops_per_sample(config,
    img_size)``) times the untraced window's pairs or samples a second,
    over 989 TFLOP/s; None where the trace shows no kernel (the step did
    not run on the device)."""
    if r.kernel_s <= 0 or r.window_rate <= 0:
        return None
    flops = flops_per_sample(r.config, r.traffic["img_size"])
    return (100.0 * flops * r.window_rate / yardstick.PEAK["bf16"],
            "operations")


def idle(r):
    """The share of the traced window in which no kernel ran."""
    if r.kernel_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s), None
