"""Fusion training: the port's ``make_fusion_steps`` train step (as
``cli.fuse`` builds it; ``freeze_backbones`` from the traffic) with
``train.optim.build_optimizer``, on a pool of seeded batches on the
device, stepped back to back, the loss of step i fetched once step
i + lag is dispatched.

Set-up drives the step from the seed through its first ``checked_steps``
steps, on pool batches 0, 1, 2, ... (rows that all differ), through the
window's own call, and keeps what the check compares: each step's loss,
the first step's decision logits, each leaf's first gradient as the
optimizer got it (Adam's first moment after one step over 1 - beta1) and
each leaf's change after those steps.
The window then goes on training the same objects.

Metric: ``train_samples_per_s`` (the samples of every step completed in
the window over its seconds).
"""
from __future__ import annotations

import math

import torch

from perfbench import loop
from perfbench.steps import mfvit_port


class Session:
    RATE = "train_samples_per_s"     # the rate a trace is read against

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 reference):
        marks = loop.Marks(device)
        from mfvit_tpu_torch.train import optim
        from mfvit_tpu_torch.train import steps as steps_mod

        marks("import")
        self.config, self.traffic, self.ref = config, traffic, reference
        gen = torch.Generator(device=device).manual_seed(seed)
        self.params = reference.make_params(config, gen, device)
        self.inputs = reference.make_inputs(config, traffic, gen, device)
        marks("draw")
        self.models = mfvit_port.build(config, traffic["img_size"],
                                       self.params, device)
        marks("build")
        self.models.train()
        self.opt = optim.build_optimizer(
            traffic["optimizer"], self.models.named_parameters(),
            traffic["lr"])
        train_step, _ = steps_mod.make_fusion_steps(
            compute_dtype=getattr(torch, config["compute_dtype"]),
            freeze_backbones=traffic["freeze_backbones"])
        xc, xe, y = (self.inputs[k] for k in ("cxr", "enh", "labels"))
        pool = traffic["pool"]

        def step(i):
            return train_step(self.models, self.opt, xc[i % pool],
                              xe[i % pool], y[i % pool])

        self.step = step
        self.call = lambda i: step(i)[0]
        self.losses = []     # the loss of every step after the checked
        self.record = self._first_steps(traffic["checked_steps"])
        self.next = traffic["checked_steps"]
        self.marks = marks("checked steps")

    def _first_steps(self, n: int) -> dict:
        names = self.opt.names
        params = self.opt.params()
        beta1 = self.opt.opt.param_groups[0]["betas"][0]
        losses, grads, logits = [], None, None
        for i in range(n):
            loss, out = self.step(i)
            losses.append(loss.item())
            if i == 0:   # a leaf the optimizer never got has no moment
                logits = out.float().cpu()
                grads = [self.opt.opt.state[p].get(
                    "exp_avg", torch.zeros_like(p)) / (1 - beta1)
                    for p in params]
        flat = {f"{part}.{n}": t for part, tree in self.params.items()
                for n, t in tree.items()}
        return {"losses": losses, "logits": logits,
                "grads": dict(zip(names, grads)),
                "deltas": {n: p.detach() - flat[n]
                           for n, p in zip(names, params)}}

    def _run(self, **kw) -> tuple:
        done, secs = loop.closed_loop(self.call, lag=self.traffic["lag"],
                                      start=self.next, **kw)
        self.next += len(done)
        self.losses += [out.item() for *_, out in done]
        return done, secs

    def window(self, seconds: float) -> dict:
        done, secs = self._run(seconds=seconds)
        B = self.traffic["batch"]
        # the rate over each quarter of the window's steps, by their fetches
        ends = [(len(done) * j) // 4 for j in range(5)]
        t = [done[0][1]] + [done[e - 1][2] for e in ends[1:]]
        self.quarters = [B * (e1 - e0) / (t1 - t0) for e0, e1, t0, t1 in
                         zip(ends, ends[1:], t, t[1:])] if ends[1] else []
        return {"train_samples_per_s": B * len(done) / secs}

    def trace_slice(self) -> tuple:
        done, _ = self._run(steps=self.traffic["trace_steps"])
        return len(done), self.traffic["batch"] * len(done)

    def free(self) -> None:
        del self.models, self.opt, self.call, self.step
        torch.cuda.empty_cache()

    def reference_steps(self, precision: str = "fp32") -> dict:
        n = self.traffic["checked_steps"]
        batches = [(self.inputs["cxr"][i], self.inputs["enh"][i],
                    self.inputs["labels"][i]) for i in range(n)]
        return self.ref.train_steps(self.params, self.config, batches,
                                    self.traffic["lr"],
                                    self.traffic["ref_rows"], precision)

    def check(self, limits: dict) -> tuple:
        """(numbers, steps that failed, notes): the first steps against the
        reference, and ``nonfinite_losses``, the steps after them whose
        loss is not finite. ``attempted`` counts every step run; the
        checked steps fail together where one of their numbers is over its
        limit."""
        self.free()
        nums, notes = loop.train_numbers(self.record, self.reference_steps())
        finite = [x for x in self.losses if math.isfinite(x)]
        nums["nonfinite_losses"] = len(self.losses) - len(finite)
        n = self.traffic["checked_steps"]
        self.attempted = n + len(self.losses)
        first = any(not v <= limits[k] for k, v in nums.items()
                    if k in limits and k != "nonfinite_losses")
        notes["window_losses"] = {
            "steps": len(self.losses), "first": self.losses[:3],
            "last": self.losses[-3:], "max": max(finite, default=None)}
        notes["window_quarters_samples_per_s"] = self.quarters
        return nums, n * first + nums["nonfinite_losses"], notes
