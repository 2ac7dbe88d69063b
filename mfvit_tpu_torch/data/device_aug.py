"""Eval-mode batch preprocessing on the device (the port of
``mfvit_tpu/data/device_aug.py::augment_batch`` with ``training=False``):
uint8 NHWC canvases -> /255 -> per-flavour normalisation -> cast. The
training augmentations (flip, rotation, crops) come with the data slice
(ROADMAP.md)."""
from __future__ import annotations

import torch

from mfvit_tpu_torch.data.constants import norm_stats


def augment_batch(canvases: torch.Tensor, *, img_type: str = "data",
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 (B, S, S, C) canvases on any device -> normalised
    (B, S, S, C) in ``out_dtype`` on the same device."""
    mean, std = norm_stats(img_type)
    x = canvases.float() / 255.0
    mean_t = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=x.device)
    return ((x - mean_t) / std_t).to(out_dtype)
