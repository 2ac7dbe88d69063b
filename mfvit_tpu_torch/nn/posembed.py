"""Fixed 2-D sin-cos position embedding (MoCo-v3 ViT), as
``mfvit_tpu/nn/posembed.py``: per-axis bands of dim/4 channels concatenated
as [sin(w), cos(w), sin(h), cos(h)] over a meshgrid(w, h, 'ij'), with an
all-zeros CLS row in front."""
from __future__ import annotations

import numpy as np
import torch


def sincos_2d(grid_h: int, grid_w: int, dim: int) -> torch.Tensor:
    """The (1, 1 + H*W, dim) fp32 table."""
    if dim % 4:
        raise ValueError("sincos_2d requires embed dim divisible by 4")
    gw, gh = np.meshgrid(np.arange(grid_w, dtype=np.float32),
                         np.arange(grid_h, dtype=np.float32), indexing="ij")
    pos_dim = dim // 4
    omega = 1.0 / (10000.0 ** (np.arange(pos_dim, dtype=np.float32)
                                / pos_dim))
    out_w = np.einsum("m,d->md", gw.flatten(), omega)
    out_h = np.einsum("m,d->md", gh.flatten(), omega)
    pe = np.concatenate([np.sin(out_w), np.cos(out_w), np.sin(out_h),
                         np.cos(out_h)], axis=1)
    pe = np.concatenate([np.zeros((1, dim), np.float32), pe], axis=0)
    return torch.from_numpy(pe[None].astype(np.float32))
