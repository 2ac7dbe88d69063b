"""Kernels of the ported paths (K1-K5, K7, K9-K15; K5 and K7 also cover
K6 and K8) and of the tools' schedule variants (T3, T4, T6, T7) with their
plain PyTorch versions.

Each kernel module keeps a ``LAUNCHES`` count that its wrapper raises by
one where it launches its kernels on a CUDA tensor, and nowhere else."""
from __future__ import annotations

from mfvit_tpu_torch.ops import (attention, attn_variants, fused_attn,
                                 fused_block, fused_fusion, fused_int8,
                                 fused_mlp, mlp_variants)

_COUNTERS = (fused_attn.LAUNCHES, fused_mlp.LAUNCHES, fused_fusion.LAUNCHES,
             fused_int8.LAUNCHES, attention.LAUNCHES, fused_block.LAUNCHES,
             mlp_variants.LAUNCHES, attn_variants.LAUNCHES)


def launch_counts() -> dict:
    out = {}
    for c in _COUNTERS:
        out.update(c)
    return out


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        for k in c:
            c[k] = 0
