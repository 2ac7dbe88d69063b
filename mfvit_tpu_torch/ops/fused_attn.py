"""K1: the attention half of a ViT block, x + proj(MHSA(LN(x))).

Replaces ``mfvit_tpu/ops/fused_attn.py::fused_attention_block`` (Pallas
``_kernel`` :28). On a CUDA tensor it runs hand-written kernels: the
LayerNorm row statistics, ``gemm_ln`` with the LayerNorm prologue and the
qkv bias (bf16 qkv out), ``attn_core`` (scores and softmax on chip) and
``gemm_ln`` with the proj bias and the bf16 residual add, all behind one
C entry point (csrc/fused_attn.cu over csrc/gemm_ln.cuh and
csrc/attn_core.cuh, whose notes say what bounds each on an H100). Unlike
the TPU kernel, qkv makes one round trip through device memory; the
scores do not.

On a CPU tensor it runs ``fused_attention_block_plain``, the same math in
PyTorch, which is also the reference the kernels are held to on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from mfvit_tpu_torch.nn.layers import layer_norm
from mfvit_tpu_torch.ops import launch

LAUNCHES = {"fused_attention_block": 0}


def attn_core_plain(qkv: torch.Tensor, heads: int, scale: float):
    """(B, N, 3D) packed qkv ([q|k|v] x head x dh) -> (B, N, D), with the
    TPU kernel's rounding points: q scaled in fp32 and rounded, fp32 scores
    and softmax, P rounded for PV, 1/sum applied to the PV output."""
    B, N, three_d = qkv.shape
    D = three_d // 3
    dt = qkv.dtype
    q, k, v = (t.reshape(B, N, heads, D // heads).transpose(1, 2)
               for t in qkv.split(D, dim=-1))
    q = (q.float() * scale).to(dt)
    s = q.float() @ k.float().transpose(-1, -2)          # (B, H, N, N)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    r = 1.0 / p.sum(-1, keepdim=True)
    o = (p.to(dt).float() @ v.float()) * r
    return o.transpose(1, 2).reshape(B, N, D).to(dt)


def fused_attention_block_plain(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj,
                                heads: int, scale: float) -> torch.Tensor:
    """x (B, N, D) -> x + proj(MHSA(LN(x))) in x's dtype. Weights are torch
    Linear layout (out, in): wqkv (3D, D), wproj (D, D)."""
    dt = x.dtype
    h = layer_norm(x, ln_s, ln_b, 1e-6)
    qkv = F.linear(h, wqkv.to(dt), bqkv.to(dt))
    o = attn_core_plain(qkv, heads, scale)
    return x + F.linear(o, wproj.to(dt), bproj.to(dt))


def fused_attention_block(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj,
                          heads: int, scale: float) -> torch.Tensor:
    """K1. CPU tensors take the plain version; CUDA tensors the kernels
    (bf16 x and weights) or a ValueError."""
    if not x.is_cuda:
        return fused_attention_block_plain(x, ln_s, ln_b, wqkv, bqkv, wproj,
                                           bproj, heads, scale)
    B, N, D = x.shape
    dh = D // heads
    if dh * heads != D or dh not in (32, 64, 128) or N > 256 or D % 128:
        raise ValueError(f"the K1 kernels take head_dim 32/64/128, N <= 256 "
                         f"and D % 128 == 0; got D={D}, heads={heads}, N={N}")
    bf16 = torch.bfloat16
    launch.require(x, bf16, "x")
    launch.require(wqkv, bf16, "wqkv", (3 * D, D))
    launch.require(wproj, bf16, "wproj", (D, D))
    stats = torch.empty(B * N, 2, dtype=torch.float32, device=x.device)
    qkv = torch.empty(B, N, 3 * D, dtype=bf16, device=x.device)
    o = torch.empty(B, N, D, dtype=bf16, device=x.device)
    out = torch.empty_like(x)
    launch.call("mfv_fused_attention_block", x.device, x,
                launch.vec(ln_s, D, "ln_s"), launch.vec(ln_b, D, "ln_b"),
                wqkv, launch.vec(bqkv, 3 * D, "bqkv"), wproj,
                launch.vec(bproj, D, "bproj"), stats, qkv, o, out, B, N, D,
                heads, scale)
    LAUNCHES["fused_attention_block"] += 1
    return out
