"""The closed loop every cell's window runs, and the comparisons that
decide ``correct``."""
from __future__ import annotations

import collections
import math
import statistics
import time
from typing import Callable

import torch


def closed_loop(call: Callable[[int], torch.Tensor], *, lag: int,
                seconds: float | None = None, steps: int | None = None,
                start: int = 0) -> tuple:
    """Dispatch ``call(i)`` back to back for ``seconds`` (or ``steps``
    calls), fetching call i's output to the host once call i + ``lag`` has
    been dispatched, then drain. Returns ([(i, dispatched, fetched, host
    output)], the loop's seconds from its first dispatch to its last
    fetch)."""
    done, pending = [], collections.deque()
    t0 = time.perf_counter()
    i = start
    while (time.perf_counter() - t0 < seconds if steps is None
           else i - start < steps):
        pending.append((i, time.perf_counter(), call(i)))
        i += 1
        if len(pending) > lag:
            j, t, out = pending.popleft()
            host = out.cpu()
            done.append((j, t, time.perf_counter(), host))
    while pending:
        j, t, out = pending.popleft()
        host = out.cpu()
        done.append((j, t, time.perf_counter(), host))
    return done, time.perf_counter() - t0


class Marks:
    """Seconds between successive calls, by name, the device drained at
    each: where set-up goes."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.last = time.perf_counter()
        self.seconds = {}

    def __call__(self, name: str) -> dict:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.seconds[name] = now - self.last
        self.last = now
        return self.seconds


def percentile(values: list, q: float) -> float:
    """The q-th percentile (0-100), interpolated between order statistics
    as ``statistics.quantiles(..., method="inclusive")`` does."""
    return statistics.quantiles(values, n=100, method="inclusive")[
        int(q) - 1] if len(values) > 1 else values[0]


# ------------------------------------------------------------ comparisons

def logit_numbers(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """Served decision logits (rows, classes) against the reference's, in
    logits (nats): ``logit_max``, the largest gap of any logit, and
    ``logit_rms``, the root mean square of the gaps; and each row's
    largest gap."""
    diff = (got.double() - ref.double()).abs()
    return {"logit_max": diff.max().item(),
            "logit_rms": diff.square().mean().sqrt().item(),
            "row_gaps": diff.amax(-1)}


def batch_numbers(got: list, ref: list) -> dict:
    """``logit_numbers`` over every batch served (lists of each batch's
    logits and the reference's), with ``batch_rms``: the worst batch's
    root mean square gap, so that a fault in one batch shows; and each
    batch's own (``batch_gaps``)."""
    nums = logit_numbers(torch.cat(got), torch.cat(ref))
    gaps = [logit_numbers(g, r)["logit_rms"] for g, r in zip(got, ref)]
    return dict(nums, batch_rms=max(gaps), batch_gaps=gaps)


def _leaf_gaps(prog: dict, ref: dict, keys: list) -> dict:
    """|prog - ref| of each leaf over the larger of the leaf's reference
    value and the median leaf's."""
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys}


def train_numbers(prog: dict, ref: dict) -> tuple:
    """The first steps of a training run against the reference's, both as
    ``reference.train_steps`` returns them (the losses, the first step's
    decision logits, each leaf's first gradient and its change over the
    steps). Returns (numbers, notes):

    - ``logit_rms`` and ``logit_max``: the first step's decision logits
      against the reference's, as ``logit_numbers`` takes them (infinite
      where rows are missing);
    - ``loss_gap``: the relative gap of each step's loss, the largest;
    - ``grad_err``: the first gradient, the worst leaf's norm of the
      difference, ||g - g_ref||: first order in any error of the
      gradient, such as rows of the batch left out of the loss or of a
      backward kernel;
    - ``grad_gap``: the same leaves' gap between the norms, |(||g|| -
      ||g_ref||)|;
    - ``change_gap``: the norms of the change over the steps, the worst
      leaf's gap, over the elements whose reference gradient is at least
      a thousandth of the median leaf's (as a root mean square): under
      Adam the others, such as a key's bias under the softmax, move by
      round-off alone.

    Each leaf's reading is over the larger of its reference norm and the
    median leaf's. The notes hold the first step's loss gap and the
    median leaf's readings beside them."""
    losses = [abs(a - b) / abs(b)
              for a, b in zip(prog["losses"], ref["losses"])]
    got, want = prog["logits"], ref["logits"]
    if got.shape == want.shape:
        out = logit_numbers(got.cpu(), want.cpu())
        out.pop("row_gaps")
    else:   # answers that never came
        out = {"logit_max": math.inf, "logit_rms": math.inf}
    keys = list(ref["grads"])
    g_ref = {k: ref["grads"][k].norm().item() for k in keys}
    g_prog = {k: prog["grads"][k].norm().item() for k in keys}
    g_diff = {k: (prog["grads"][k].to(ref["grads"][k].device).float()
                  - ref["grads"][k]).norm().item() for k in keys}
    med = statistics.median(g_ref.values())
    e_gaps = {k: g_diff[k] / max(g_ref[k], med) for k in keys}
    g_gaps = _leaf_gaps(g_prog, g_ref, keys)
    floor = 1e-3 * statistics.median(
        g_ref[k] / ref["grads"][k].numel() ** 0.5 for k in keys)
    masks = {k: ref["grads"][k].abs() >= floor for k in keys}
    moved = [k for k in keys if masks[k].any()]
    c_ref = {k: (ref["deltas"][k] * masks[k]).norm().item() for k in moved}
    c_prog = {k: (prog["deltas"][k].to(ref["deltas"][k].device)
                  * masks[k]).norm().item() for k in moved}
    c_gaps = _leaf_gaps(c_prog, c_ref, moved)
    e_worst = max(e_gaps, key=e_gaps.get)
    g_worst = max(g_gaps, key=g_gaps.get)
    c_worst = max(c_gaps, key=c_gaps.get)
    notes = {"loss_gap_first": losses[0], "grad_err_leaf": e_worst,
             "grad_err_median": statistics.median(e_gaps.values()),
             "grad_gap_leaf": g_worst,
             "grad_gap_median": statistics.median(g_gaps.values()),
             "change_gap_leaf": c_worst,
             "change_gap_median": statistics.median(c_gaps.values()),
             "elements_left_out_of_change":
                 sum(int((~masks[k]).sum()) for k in keys),
             "losses": prog["losses"], "ref_losses": ref["losses"]}
    return ({**out, "loss_gap": max(losses), "grad_err": e_gaps[e_worst],
             "grad_gap": g_gaps[g_worst], "change_gap": c_gaps[c_worst]},
            notes)
