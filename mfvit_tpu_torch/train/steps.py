"""Train and eval steps, the port of ``mfvit_tpu/train/steps.py``:
``softmax_ce``, the classifier steps of the LP/FT entry point
(``make_classifier_steps``) and the MF-ViT CA forward that serving uses
(``make_fusion_forward``). Fusion training comes with its own slice
(ROADMAP.md)."""
from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from mfvit_tpu_torch.models import fusion as fusion_mod


def softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy on fp32 logits, integer labels."""
    return F.cross_entropy(logits.float(), labels.long())


def make_classifier_steps(*, compute_dtype: torch.dtype = torch.bfloat16,
                          remat: bool = False, reference: bool = False
                          ) -> Tuple[Callable, Callable]:
    """(train_step, eval_step) for the single-stream ViT classifier.

    ``train_step(model, opt, imgs, labels) -> (loss, logits)``: forward,
    CE on the fp32 logits, backward (K5/K7 on CUDA) and one step of ``opt``
    (a ``train.optim.Scheduled``); loss and logits come back detached, on
    the device, unsynchronised. ``eval_step(model, imgs) -> logits`` runs
    under ``torch.inference_mode()``. ``remat`` recomputes the blocks in
    the backward; ``reference`` runs the plain versions of the kernels."""

    def train_step(model, opt, imgs, labels):
        logits = model(imgs, compute_dtype=compute_dtype, remat=remat,
                       reference=reference)
        loss = softmax_ce(logits, labels)
        opt.zero_grad()
        loss.backward()
        opt.step()
        return loss.detach(), logits.detach()

    @torch.inference_mode()
    def eval_step(model, imgs):
        return model(imgs, compute_dtype=compute_dtype, reference=reference)

    return train_step, eval_step


def make_fusion_forward(*, compute_dtype: torch.dtype = torch.bfloat16,
                        reference: bool = False) -> Callable:
    """``forward(models, img_cxr, img_enh) -> (fused, logits_cxr,
    logits_enh)`` with ``models = {"cxr": ViT, "enh": ViT, "fus": Fusion}``,
    without autograd. The decision logits are the sum of the three."""

    @torch.inference_mode()
    def forward(models, img_cxr, img_enh):
        return fusion_mod.fused_forward(
            models["cxr"], models["enh"], models["fus"], img_cxr, img_enh,
            compute_dtype=compute_dtype, reference=reference)

    return forward
