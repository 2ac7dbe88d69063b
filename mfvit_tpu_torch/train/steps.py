"""Train and eval steps, the port of ``mfvit_tpu/train/steps.py``:
``softmax_ce``, the classifier steps of the LP/FT entry point
(``make_classifier_steps``), the MF-ViT CA forward that serving uses
(``make_fusion_forward``) and the fusion-training steps
(``make_fusion_steps``)."""
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


def make_fusion_steps(*, compute_dtype: torch.dtype = torch.bfloat16,
                      freeze_backbones: bool = False, remat: bool = False,
                      reference: bool = False
                      ) -> Tuple[Callable, Callable]:
    """(train_step, eval_step) for MF-ViT CA, the port of
    ``mfvit_tpu/train/steps.py::make_fusion_steps`` (:136-195), with
    ``models = {"cxr": ViT, "enh": ViT, "fus": Fusion}`` (an
    ``nn.ModuleDict``).

    ``train_step(models, opt, img_cxr, img_enh, labels) -> (loss, out)``
    with the decision logits ``out = fused + logits_cxr + logits_enh`` and
    CE on them in fp32, backward and one step of ``opt``; both come back
    detached, unsynchronised. ``eval_step(models, img_cxr, img_enh)`` gives
    the decision logits under ``torch.inference_mode()``.

    ``freeze_backbones`` is the LP fusion mode, JAX's frozen generic path
    (:106-123): both branches run forward with no autograd graph (the
    ``stop_gradient`` on their tokens and CLS), so only the fusion head's
    backward runs (K4's plain recompute); the branch heads still give their
    logits. Otherwise the whole forward runs under autograd (K5 and K7 on
    both branches). ``remat`` recomputes the branches' blocks in the
    backward; ``reference`` runs the plain versions of the kernels."""

    def forward(models, img_cxr, img_enh):
        if not freeze_backbones:
            return fusion_mod.fused_forward(
                models["cxr"], models["enh"], models["fus"], img_cxr,
                img_enh, compute_dtype=compute_dtype, reference=reference,
                remat=remat)
        kw = dict(compute_dtype=compute_dtype, return_features=True,
                  reference=reference)
        with torch.no_grad():
            tok_c, lc = models["cxr"](img_cxr, **kw)
            tok_e, le = models["enh"](img_enh, **kw)
        return models["fus"](tok_c, tok_e, reference=reference), lc, le

    def train_step(models, opt, img_cxr, img_enh, labels):
        fused, lc, le = forward(models, img_cxr, img_enh)
        out = fused + lc + le
        loss = softmax_ce(out, labels)
        opt.zero_grad()
        loss.backward()
        opt.step()
        return loss.detach(), out.detach()

    serve = make_fusion_forward(compute_dtype=compute_dtype,
                                reference=reference)

    @torch.inference_mode()
    def eval_step(models, img_cxr, img_enh):
        fused, lc, le = serve(models, img_cxr, img_enh)
        return fused + lc + le

    return train_step, eval_step
