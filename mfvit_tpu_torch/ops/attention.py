"""Attention outside the kernels, as eager PyTorch: the plain packed-qkv
MHSA (``mfvit_tpu/ops/attention.py::mhsa_from_packed`` with
``backend="xla"``, :403-418) and the 1-query CLS cross-attention
(``cross_attention_1q``, :423-437). In JAX both are XLA einsums with no
Pallas kernel, so they have no kernel here either."""
from __future__ import annotations

import math

import torch


def mhsa_from_packed(qkv: torch.Tensor, heads: int, scale: float):
    """(B, N, 3*dim) packed [q|k|v] x head x dh -> (B, N, dim); fp32 scores
    and softmax, probabilities cast to the value dtype for PV."""
    B, N, three_dim = qkv.shape
    dim = three_dim // 3
    q, k, v = (t.reshape(B, N, heads, dim // heads)
               for t in qkv.split(dim, dim=-1))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, -1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, N, dim)


def cross_attention_1q(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float | None = None) -> torch.Tensor:
    """CLS-token cross-attention: q (B, H, 1, D), k/v (B, H, N, D) ->
    (B, H, 1, D) in q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, -1)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)
