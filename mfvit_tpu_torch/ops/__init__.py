"""Kernels of the ported paths (K1-K5, K7, K9-K15; K5 and K7 also cover
K6 and K8) and of the tools' schedule variants (T1-T7) with their plain
PyTorch versions, and the two GEMM cores alone (``gemm``).

Each kernel module keeps a ``LAUNCHES`` count that its wrapper raises by
one where it launches its kernels on a CUDA tensor, and nowhere else.
``span`` names a region of the hot path on the profiler's timeline."""
from __future__ import annotations

import contextlib

import torch

from mfvit_tpu_torch.ops import (attention, attn_variants, fused_attn,
                                 fused_block, fused_fusion, fused_int8,
                                 fused_mlp, gemm, mlp_variants)

_COUNTERS = (fused_attn.LAUNCHES, fused_mlp.LAUNCHES, fused_fusion.LAUNCHES,
             fused_int8.LAUNCHES, attention.LAUNCHES, fused_block.LAUNCHES,
             mlp_variants.LAUNCHES, attn_variants.LAUNCHES, gemm.LAUNCHES)


def launch_counts() -> dict:
    out = {}
    for c in _COUNTERS:
        out.update(c)
    return out


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        for k in c:
            c[k] = 0


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A named region of the hot path (``mfv.step``, ``mfv.forward``, ...):
    while a profiler records, a host event of the operators' kind
    (``torch._C._profiler._RecordFunctionFast``), which lands among the
    profiler's events on the timeline of the device's kernels; otherwise
    one shared null context, which calls nothing in the profiler.

    Not ``record_function``: a user annotation also puts a device-side
    range over the kernels launched on its thread inside it, which a
    reader that takes every device event for a kernel counts as busy."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _NO_SPAN
