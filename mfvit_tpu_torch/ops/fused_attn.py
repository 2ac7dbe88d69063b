"""K1 and K5: the attention half of a ViT block, x + proj(MHSA(LN(x))),
and its backward.

- K1, the forward, replaces ``mfvit_tpu/ops/fused_attn.py::
  fused_attention_block`` (Pallas ``_kernel`` :28). On a CUDA tensor it
  runs hand-written kernels: the LayerNorm row statistics, ``gemm_ln`` with
  the LayerNorm prologue and the qkv bias (bf16 qkv out), ``attn_core``
  (scores and softmax on chip) and ``gemm_ln`` with the proj bias and the
  bf16 residual add, all behind one C entry point (csrc/fused_attn.cu over
  csrc/gemm_ln.cuh and csrc/attn_core.cuh, whose notes say what bounds each
  on an H100). Unlike the TPU kernel, qkv makes one round trip through
  device memory; the scores do not.
- K5, the backward, replaces ``_fused_attn_bwd_impl`` (Pallas
  ``_bwd_kernel`` :385) and, at D > 512, ``_fused_attn_bwd_bigdim`` (K6,
  :661): csrc/fused_attn_bwd.cu over csrc/attn_bwd.cuh and
  csrc/gemm_bwd.cuh.

``fused_attention_block`` is a ``torch.autograd.Function`` on both
devices. It takes the fp32 master weights, casts them to x's dtype inside,
and returns fp32 weight and bias gradients and a dx in x's dtype, as the
JAX ``_bwd`` (:734-751) does. On a CPU tensor (or with ``plain=True``) it
runs ``fused_attention_block_plain`` forward and
``fused_attention_block_bwd_plain`` backward, the same math in PyTorch,
which is also the reference the kernels are held to on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from mfvit_tpu_torch.nn.layers import (layer_norm, layer_norm_bwd,
                                       layer_norm_stats, linear_f32, mm_f32)
from mfvit_tpu_torch.ops import launch

LAUNCHES = {"fused_attention_block": 0, "fused_attention_block_bwd": 0}


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


def fused_attention_block_bwd_plain(g, x, ln_s, ln_b, wqkv, bqkv, wproj,
                                    heads: int, scale: float):
    """The gradients of ``fused_attention_block_plain`` for the cotangent
    g: (dx, dln_s, dln_b, dwqkv, dbqkv, dwproj, dbproj), dx in x's dtype,
    the rest fp32 in the torch layout. In bf16 it rounds where the TPU
    backward does (``_bwd_kernel`` :385-481): h, qkv (bias in, q not
    pre-scaled; the scale goes on the fp32 scores), dO, dS and dqkv in
    bf16; P in fp32 and rounded for the PV and dV products; o and dWproj
    in fp32; dh and the LayerNorm backward in fp32. In fp32 it is
    ``_bwd_xla_reference`` (:754)."""
    B, N, D = x.shape
    dh_ = D // heads
    dt = x.dtype
    gf = g.float()
    xhat, inv = layer_norm_stats(x)
    h = (xhat * ln_s.float() + ln_b.float()).to(dt).reshape(B * N, D)
    wq, wp = wqkv.to(dt), wproj.to(dt)
    qkv = (mm_f32(h, wq.t()) + bqkv.float()).to(dt)
    q, k, v = (t.reshape(B, N, heads, dh_).transpose(1, 2).float()
               for t in qkv.split(D, dim=-1))                 # (B, H, N, dh)
    s = (q @ k.transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)                           # fp32
    pb = p.to(dt).float()
    o = (pb @ v).transpose(1, 2).reshape(B * N, D)            # fp32
    g2 = gf.reshape(B * N, D)
    dwproj = g2.t() @ o
    dbproj = g2.sum(0)
    do = mm_f32(g.reshape(B * N, D), wp).to(dt).float()
    do = do.reshape(B, N, heads, dh_).transpose(1, 2)
    dv = pb.transpose(-1, -2) @ do
    dp = do @ v.transpose(-1, -2)
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True))).to(dt).float()
    dq = (ds @ k) * scale
    dk = (ds.transpose(-1, -2) @ q) * scale
    dqkv = torch.cat([t.transpose(1, 2).reshape(B * N, D)
                      for t in (dq, dk, dv)], -1).to(dt)
    dwqkv = mm_f32(dqkv.t(), h)
    dbqkv = dqkv.float().sum(0)
    dh = mm_f32(dqkv, wq).reshape(B, N, D)
    dx_ln, dln_s, dln_b = layer_norm_bwd(dh, xhat, inv, ln_s)
    return ((gf + dx_ln).to(dt), dln_s, dln_b, dwqkv, dbqkv, dwproj, dbproj)


def _check(B: int, N: int, D: int, heads: int, what: str) -> None:
    dh = D // heads
    if dh * heads != D or dh not in (32, 64, 128) or N > 256 or D % 128:
        raise ValueError(f"the {what} kernels take head_dim 32/64/128, "
                         f"N <= 256 and D % 128 == 0; got D={D}, "
                         f"heads={heads}, N={N}")


def _forward_cuda(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, heads, scale):
    """K1 on bf16 x; the weights are cast to bf16 here."""
    B, N, D = x.shape
    _check(B, N, D, heads, "K1")
    bf16 = torch.bfloat16
    launch.require(x, bf16, "x")
    wqkv = wqkv.to(bf16).contiguous()
    wproj = wproj.to(bf16).contiguous()
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


def fused_attention_block_bwd(g, x, ln_s, ln_b, wqkv, bqkv, wproj,
                              heads: int, scale: float):
    """K5 on CUDA tensors: the outputs of ``fused_attention_block_bwd_plain``
    from the kernels (bf16 g and x; the weights are cast to bf16 here).
    Anything the kernels do not take raises."""
    B, N, D = x.shape
    _check(B, N, D, heads, "K5")
    bf16, f32 = torch.bfloat16, torch.float32
    launch.require(x, bf16, "x")
    launch.require(g, bf16, "g", (B, N, D))
    wqkv = wqkv.to(bf16).contiguous()
    wproj = wproj.to(bf16).contiguous()
    launch.require(wqkv, bf16, "wqkv", (3 * D, D))
    launch.require(wproj, bf16, "wproj", (D, D))
    M, dev = B * N, x.device

    def empty(*shape, dtype=f32):
        return torch.empty(*shape, dtype=dtype, device=dev)

    s_qkv, k_qkv = launch.k_split(M, 3 * (D // 128) ** 2, 32)
    s_proj, k_proj = launch.k_split(M, (D // 64) ** 2, 16)
    s_ln, k_ln = launch.k_split(M, D // 128, 1)
    part = empty(max(s_qkv * (3 * D * D + 3 * D), s_proj * (D * D + D),
                     2 * s_ln * D))
    dx = torch.empty_like(x)
    dln_s, dln_b, dbproj = empty(D), empty(D), empty(D)
    dwqkv, dbqkv, dwproj = empty(3 * D, D), empty(3 * D), empty(D, D)
    launch.call("mfv_fused_attention_block_bwd", dev, g, x,
                launch.vec(ln_s, D, "ln_s"), launch.vec(ln_b, D, "ln_b"),
                wqkv, launch.vec(bqkv, 3 * D, "bqkv"), wproj,
                empty(M, 2), empty(M, D, dtype=bf16),
                empty(M, 3 * D, dtype=bf16), empty(M, D, dtype=bf16),
                empty(M, D), empty(M, 3 * D, dtype=bf16), empty(M, D), part,
                dx, dln_s, dln_b, dwqkv, dbqkv, dwproj, dbproj, B, N, D,
                heads, scale, s_qkv, k_qkv, s_proj, k_proj, s_ln, k_ln)
    LAUNCHES["fused_attention_block_bwd"] += 1
    return dx, dln_s, dln_b, dwqkv, dbqkv, dwproj, dbproj


class _AttentionBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, heads, scale,
                plain):
        ctx.save_for_backward(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj)
        ctx.heads, ctx.scale = heads, scale
        ctx.plain = plain or not x.is_cuda
        if ctx.plain:
            return fused_attention_block_plain(x, ln_s, ln_b, wqkv, bqkv,
                                               wproj, bproj, heads, scale)
        return _forward_cuda(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, heads,
                             scale)

    @staticmethod
    def backward(ctx, g):
        x, ln_s, ln_b, wqkv, bqkv, wproj, bproj = ctx.saved_tensors
        bwd = (fused_attention_block_bwd_plain if ctx.plain
               else fused_attention_block_bwd)
        grads = bwd(g.contiguous(), x, ln_s, ln_b, wqkv, bqkv, wproj,
                    ctx.heads, ctx.scale)
        params = (x, ln_s, ln_b, wqkv, bqkv, wproj, bproj)
        return (*(d.to(p.dtype) for d, p in zip(grads, params)), None, None,
                None)


def fused_attention_block(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj,
                          heads: int, scale: float, plain: bool = False):
    """K1 forward, K5 backward. CPU tensors (and ``plain=True``) take the
    plain versions; CUDA tensors the kernels (bf16 x) or a ValueError.
    Weights may be fp32 (the master copies); their gradients are fp32."""
    return _AttentionBlock.apply(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj,
                                 heads, scale, plain)
