"""Faults planted under the timed path, for the benchmark's own tests and
for reading the limits' upper ends: each patches the port's step
factories, as the step kinds look them up, for the length of a ``with``.

- ``answer_altered`` (serving): one pair's decision logits rotated
  where they are produced;
- ``half_batch`` (serving): the first half of the batch served and its
  answers given for the second half too;
- ``half_batch`` (training): the step's loss, gradients and update taken
  on the first half of the batch alone, the mean over it, while the
  decision logits it returns are the whole batch's, as if answered;
- ``state_unchanged`` (training): the loss computed and nothing
  updated.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

KINDS = ("answer_altered", "half_batch", "state_unchanged")


@contextlib.contextmanager
def planted(kind: str):
    from mfvit_tpu_torch.train import steps as steps_mod

    make_fwd, make_steps = (steps_mod.make_fusion_forward,
                            steps_mod.make_fusion_steps)

    def fusion_forward(**kw):
        fwd = make_fwd(**kw)

        def broken(models, xc, xe):
            if kind == "half_batch":
                h = xc.shape[0] // 2
                return tuple(torch.cat([t, t]) for t in
                             fwd(models, xc[:h], xe[:h]))
            fused, lc, le = fwd(models, xc, xe)
            if kind == "answer_altered":
                fused = fused.clone()
                fused[0] = fused[0].roll(1)
            return fused, lc, le
        return broken

    def fusion_steps(**kw):
        train_step, eval_step = make_steps(**kw)
        fwd = make_fwd(compute_dtype=kw.get("compute_dtype",
                                            torch.bfloat16))

        def broken(models, opt, xc, xe, y):
            if kind == "half_batch":
                h = xc.shape[0] // 2
                with torch.no_grad():
                    whole = sum(fwd(models, xc, xe))
                loss, _ = train_step(models, opt, xc[:h], xe[:h], y[:h])
                return loss, whole
            if kind == "state_unchanged":
                out = sum(fwd(models, xc, xe))
                return F.cross_entropy(out.float(), y.long()), out
            return train_step(models, opt, xc, xe, y)
        return broken, eval_step

    steps_mod.make_fusion_forward = fusion_forward
    steps_mod.make_fusion_steps = fusion_steps
    try:
        yield
    finally:
        steps_mod.make_fusion_forward = make_fwd
        steps_mod.make_fusion_steps = make_steps
