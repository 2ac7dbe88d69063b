"""Train and eval steps, the port of ``mfvit_tpu/train/steps.py``:
``softmax_ce``, the classifier steps of the LP/FT entry point
(``make_classifier_steps``), the MF-ViT fusion forward that serving uses
(``make_fusion_forward``, the CA or the GPT head) and the
fusion-training steps (``make_fusion_steps``).

The steps and the serving forward mark their parts with ``ops.span``
(free while no profiler records): ``mfv.step`` around a training step,
with ``mfv.forward``, ``mfv.loss``, ``mfv.backward`` and ``mfv.optim`` in
turn inside it, and ``mfv.serve`` around a served forward."""
from __future__ import annotations

import contextlib
from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from mfvit_tpu_torch.models import fusion as fusion_mod
from mfvit_tpu_torch.ops import span
from mfvit_tpu_torch.parallel import dist


def softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy on fp32 logits, integer labels."""
    return F.cross_entropy(logits.float(), labels.long())


def make_classifier_steps(*, compute_dtype: torch.dtype = torch.bfloat16,
                          remat: bool = False, reference: bool = False,
                          attn_backend: str | None = None
                          ) -> Tuple[Callable, Callable]:
    """(train_step, eval_step) for the single-stream ViT classifier.

    ``train_step(model, opt, imgs, labels) -> (loss, logits)``: forward,
    CE on the fp32 logits, backward (K5/K7 on CUDA) and one step of ``opt``
    (a ``train.optim.Scheduled``); loss and logits come back detached, on
    the device, unsynchronised. Under a process group ``imgs`` is this
    rank's row block of the global batch: the gradients are averaged over
    the ranks before the step and the loss is the global batch's mean, as
    JAX's step over a sharded batch computes them. ``eval_step(model, imgs) -> logits`` runs
    under ``torch.inference_mode()``. ``remat`` recomputes the blocks in
    the backward; ``reference`` runs the plain versions of the kernels,
    ``attn_backend="xla"`` JAX's XLA route (``nn.xla_route``)."""

    def train_step(model, opt, imgs, labels):
        with span("mfv.step"):
            with span("mfv.forward"):
                logits = model(imgs, compute_dtype=compute_dtype,
                               remat=remat, reference=reference,
                               attn_backend=attn_backend)
            with span("mfv.loss"):
                loss = softmax_ce(logits, labels)
            _backward_and_step(opt, loss)
            return dist.all_mean(loss.detach()), logits.detach()

    @torch.inference_mode()
    def eval_step(model, imgs):
        return model(imgs, compute_dtype=compute_dtype, reference=reference,
                     attn_backend=attn_backend)

    return train_step, eval_step


def _backward_and_step(opt, loss: torch.Tensor) -> None:
    """The training steps' backward (``mfv.backward``, with the gradients
    cleared just before it) and the optimizer's step (``mfv.optim``: the
    gradients averaged over the ranks, then ``opt.step()``)."""
    with span("mfv.backward"):
        opt.zero_grad()
        loss.backward()
    with span("mfv.optim"):
        dist.mean_grads(opt.params())
        opt.step()


def _fusion_forward(fusion_arch: str, compute_dtype, reference,
                    frozen: bool, remat: bool,
                    attn_backend: str | None = None) -> Callable:
    """``forward(models, img_cxr, img_enh) -> (fused, logits_cxr,
    logits_enh)``, the port of JAX's :92-133. The CA head unfrozen runs
    ``fusion.fused_forward`` (K4 on the head); every other case takes the
    generic per-branch route: each ViT gives its tokens and logits
    (``return_features``; K1-K3), then the head. ``frozen`` runs the
    branches with no autograd graph (JAX's ``stop_gradient`` on their
    tokens and CLS), then their heads on the CLS rows under autograd. The
    GPT head carries its own config (JAX passes ``gpt_cfg`` beside the
    params). ``attn_backend="xla"`` runs JAX's XLA
    route in the branches and the CA head."""
    if fusion_arch not in ("ca", "gpt"):
        raise ValueError(f"unknown fusion_arch {fusion_arch!r}")

    def forward(models, img_cxr, img_enh):
        if fusion_arch == "ca" and not frozen:
            return fusion_mod.fused_forward(
                models["cxr"], models["enh"], models["fus"], img_cxr,
                img_enh, compute_dtype=compute_dtype, reference=reference,
                remat=remat, attn_backend=attn_backend)
        kw = dict(compute_dtype=compute_dtype, return_features=True,
                  reference=reference, remat=remat,
                  attn_backend=attn_backend)
        with torch.no_grad() if frozen else contextlib.nullcontext():
            tok_c, lc = models["cxr"](img_cxr, **kw)
            tok_e, le = models["enh"](img_enh, **kw)
        if frozen:
            # the gradient stops at the tokens and the CLS, not at the
            # branch heads, which train where the optimizer holds them
            lc, le = (F.linear(t[:, 0].float(), m.head.weight, m.head.bias)
                      for t, m in ((tok_c, models["cxr"]),
                                   (tok_e, models["enh"])))
        return (models["fus"](tok_c, tok_e, reference=reference,
                              attn_backend=attn_backend), lc, le)

    return forward


def make_fusion_forward(*, compute_dtype: torch.dtype = torch.bfloat16,
                        reference: bool = False, fusion_arch: str = "ca",
                        attn_backend: str | None = None) -> Callable:
    """``forward(models, img_cxr, img_enh) -> (fused, logits_cxr,
    logits_enh)`` with ``models = {"cxr": ViT, "enh": ViT, "fus": head}``
    (``models.fusion.Fusion`` for ``fusion_arch="ca"``,
    ``models.gpt_fusion.GPTFusion`` for ``"gpt"``), without autograd: the
    one forward that serving and the eval step share. The decision logits
    are the sum of the three."""
    forward = _fusion_forward(fusion_arch, compute_dtype, reference,
                              frozen=False, remat=False,
                              attn_backend=attn_backend)

    @torch.inference_mode()
    def serve(models, img_cxr, img_enh):
        with span("mfv.serve"):
            return forward(models, img_cxr, img_enh)

    return serve


def make_fusion_steps(*, compute_dtype: torch.dtype = torch.bfloat16,
                      freeze_backbones: bool = False, remat: bool = False,
                      reference: bool = False, fusion_arch: str = "ca",
                      attn_backend: str | None = None
                      ) -> Tuple[Callable, Callable]:
    """(train_step, eval_step) for MF-ViT fusion, the port of
    ``mfvit_tpu/train/steps.py::make_fusion_steps`` (:136-195), with
    ``models = {"cxr": ViT, "enh": ViT, "fus": head}`` (an
    ``nn.ModuleDict``; the head as in ``make_fusion_forward``).

    ``train_step(models, opt, img_cxr, img_enh, labels) -> (loss, out)``
    with the decision logits ``out = fused + logits_cxr + logits_enh`` and
    CE on them in fp32, backward and one step of ``opt``; both come back
    detached, unsynchronised (under a process group: the gradients
    averaged over the ranks, the loss the global mean, as in
    ``make_classifier_steps``). ``eval_step(models, img_cxr, img_enh)`` gives
    the decision logits under ``torch.inference_mode()``.

    ``freeze_backbones`` is the LP fusion mode: both branches run forward
    with no autograd graph, so only the head's backward runs (the CA
    head's K4 by its plain recompute); the branch heads still give their
    logits. Otherwise the whole forward runs under autograd (K5 and K7 on
    both branches). ``fusion_arch="gpt"`` takes the GPT head on the
    generic per-branch route in both modes (K4 never runs). ``remat``
    recomputes the branches' blocks in the backward; ``reference`` runs
    the plain versions of the kernels, ``attn_backend="xla"`` JAX's XLA
    route (``nn.xla_route``)."""
    forward = _fusion_forward(fusion_arch, compute_dtype, reference,
                              frozen=freeze_backbones, remat=remat,
                              attn_backend=attn_backend)

    def train_step(models, opt, img_cxr, img_enh, labels):
        with span("mfv.step"):
            with span("mfv.forward"):
                fused, lc, le = forward(models, img_cxr, img_enh)
            with span("mfv.loss"):
                out = fused + lc + le
                loss = softmax_ce(out, labels)
            _backward_and_step(opt, loss)
            return dist.all_mean(loss.detach()), out.detach()

    serve = make_fusion_forward(compute_dtype=compute_dtype,
                                reference=reference, fusion_arch=fusion_arch,
                                attn_backend=attn_backend)

    @torch.inference_mode()
    def eval_step(models, img_cxr, img_enh):
        fused, lc, le = serve(models, img_cxr, img_enh)
        return fused + lc + le

    return train_step, eval_step
