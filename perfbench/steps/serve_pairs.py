"""Paired serving: the port's ``make_fusion_forward`` (as ``cli.infer``
builds it) on a pool of seeded batches on the device, dispatched back to
back, the decision logits of batch i fetched once batch i + lag is
dispatched.

Metrics: ``serve_pairs_per_s`` (pairs whose logits reached the host over
the window's seconds) and ``serve_batch_p95_ms`` (the 95th percentile,
over every batch, of its fetch minus its dispatch). The check compares
every batch the run served against the reference's logits of its input,
each batch by itself too.
"""
from __future__ import annotations

import torch

from perfbench import loop
from perfbench.steps import mfvit_port


class Session:
    RATE = "serve_pairs_per_s"     # the rate a trace is read against

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 reference):
        marks = loop.Marks(device)
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
        for m in self.models.values():
            m.eval()
        fwd3 = steps_mod.make_fusion_forward(
            compute_dtype=getattr(torch, config["compute_dtype"]))
        xc, xe = self.inputs["cxr"], self.inputs["enh"]
        pool = traffic["pool"]

        def call(i):
            fused, lc, le = fwd3(self.models, xc[i % pool], xe[i % pool])
            return fused + lc + le

        self.call = call
        self.served = []     # (pool index, host logits) of every batch
        self.next = 0
        done, _ = loop.closed_loop(call, lag=0, steps=traffic["warmup"])
        self.next = len(done)
        self.marks = marks("warm")

    def _run(self, **kw) -> tuple:
        done, secs = loop.closed_loop(self.call, lag=self.traffic["lag"],
                                      start=self.next, **kw)
        self.next += len(done)
        self.served += [(i % self.traffic["pool"], out)
                        for i, _, _, out in done]
        return done, secs

    def window(self, seconds: float) -> dict:
        done, secs = self._run(seconds=seconds)
        B = self.traffic["batch"]
        lat = [(f - d) * 1e3 for _, d, f, _ in done]
        return {"serve_pairs_per_s": B * len(done) / secs,
                "serve_batch_p95_ms": loop.percentile(lat, 95)}

    def trace_slice(self) -> tuple:
        done, _ = self._run(steps=self.traffic["trace_steps"])
        return len(done), self.traffic["batch"] * len(done)

    def free(self) -> None:
        del self.models, self.call
        torch.cuda.empty_cache()

    def reference_logits(self, idx: list, precision: str = "fp32") -> dict:
        return {k: self.ref.serve_logits(
            self.params, self.config, self.inputs["cxr"][k],
            self.inputs["enh"][k], self.traffic["ref_rows"], precision)
            .cpu() for k in idx}

    def check(self, limits: dict) -> tuple:
        """(numbers, pairs that failed, notes) over every batch served
        (``attempted`` counts those pairs). A pair fails where its batch's
        ``batch_rms`` or its own largest gap is over its limit."""
        self.free()
        ref = self.reference_logits(sorted({k for k, _ in self.served}))
        nums = loop.batch_numbers([out for _, out in self.served],
                                  [ref[k] for k, _ in self.served])
        row_gaps, batch_gaps = nums.pop("row_gaps"), nums.pop("batch_gaps")
        B = self.traffic["batch"]
        self.attempted = B * len(self.served)
        bad = torch.zeros(len(row_gaps), dtype=torch.bool)
        if "batch_rms" in limits:
            over = torch.tensor(batch_gaps) > limits["batch_rms"]
            bad |= over.repeat_interleave(B)
        if "logit_max" in limits:
            bad |= row_gaps > limits["logit_max"]
        return nums, int(bad.sum()), {
            "batches": len(self.served),
            "batch_rms_median": sorted(batch_gaps)[len(batch_gaps) // 2]}
