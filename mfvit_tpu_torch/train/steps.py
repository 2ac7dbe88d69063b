"""The eval half of ``mfvit_tpu/train/steps.py::make_fusion_forward``: the
one MF-ViT CA forward that serving uses. Training steps come with the
training slice (ROADMAP.md)."""
from __future__ import annotations

from typing import Callable

import torch

from mfvit_tpu_torch.models import fusion as fusion_mod


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
