"""K2, K3 and K7: the MLP half of a ViT block and its backward.

- K2 ``fused_mlp_block``: x + fc2(GELU(fc1(LN(x)))); replaces
  ``mfvit_tpu/ops/fused_mlp.py::fused_mlp_block`` (Pallas ``_mlp_kernel``
  :62).
- K3 ``fused_mlp_block_final_ln``: LN_final(x + MLP(LN(x))) with the sum
  kept in fp32 into the epilogue LayerNorm; replaces
  ``fused_mlp_block_final_ln`` (Pallas ``_mlp_kernel_final`` :137). The
  port folds the final LayerNorm into the last block at every width.
- K7 ``fused_mlp_block_bwd``: the backward of both; replaces
  ``_fused_mlp_bwd_impl`` (Pallas ``_bwd_kernel`` :246) and, for large D
  or N, ``_fused_mlp_bwd_bigdim`` (K8, :459). K3's backward ports
  ``_final_bwd`` (:214): the epilogue LayerNorm backward on an fp32
  recompute in PyTorch (eager math in JAX too), then K7.

On a CUDA tensor K2/K3 run the LayerNorm row statistics and two ``gemm_ln``
kernels (csrc/fused_mlp.cu over csrc/gemm_ln.cuh): LN prologue + fc1 +
bias + exact-erf GELU (bf16 hidden), then fc2 + bias with the bf16
residual add (K2), or with the fp32 residual written out in fp32 and a row
LayerNorm kernel after it (K3). Unlike the TPU kernel, the (M, 4D) hidden
activation (and K3's fp32 sum) make one round trip through device memory.
K7 is csrc/fused_mlp_bwd.cu over csrc/gemm_bwd.cuh.

Both entry points are ``torch.autograd.Function``s on both devices: they
take the fp32 master weights, cast them inside, and return fp32 weight
gradients. On a CPU tensor (or with ``plain=True``) they run the plain
versions below, the reference the kernels are held to on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from mfvit_tpu_torch.nn.layers import (layer_norm, layer_norm_bwd,
                                       layer_norm_stats, linear_f32, mm_f32)
from mfvit_tpu_torch.ops import launch

LAUNCHES = {"fused_mlp_block": 0, "fused_mlp_block_final_ln": 0,
            "fused_mlp_block_bwd": 0}


def _hidden(x, ln_s, ln_b, w1, b1):
    h = layer_norm(x, ln_s, ln_b, 1e-6)
    return F.gelu(linear_f32(h, w1, b1)).to(x.dtype)


def fused_mlp_block_plain(x, ln_s, ln_b, w1, b1, w2, b2) -> torch.Tensor:
    """x (B, N, D) -> x + MLP(LN(x)) in x's dtype; w1 (4D, D), w2 (D, 4D).
    fc2's fp32 sums take the fp32 bias and are rounded once, as in the
    kernels."""
    h = _hidden(x, ln_s, ln_b, w1, b1)
    return x + linear_f32(h, w2, b2).to(x.dtype)


def fused_mlp_block_final_ln_plain(x, ln_s, ln_b, w1, b1, w2, b2, final_s,
                                   final_b) -> torch.Tensor:
    h = _hidden(x, ln_s, ln_b, w1, b1)
    o = x.float() + linear_f32(h, w2, b2)
    return layer_norm(o, final_s, final_b, 1e-6).to(x.dtype)


def fused_mlp_block_bwd_plain(g, x, ln_s, ln_b, w1, b1, w2):
    """The gradients of ``fused_mlp_block_plain`` for the cotangent g: (dx,
    dln_s, dln_b, dw1, db1, dw2, db2), dx in x's dtype, the rest fp32 in
    the torch layout. In bf16 it rounds where the TPU backward does
    (``_bwd_kernel`` :246-299): h1, ga and gelu(a) in bf16; a, g . W2,
    dW1, dW2, dh1 and the LayerNorm backward in fp32; the GELU with the
    exact erf. In fp32 it is ``_bwd_xla_reference`` (:587)."""
    B, N, D = x.shape
    dt = x.dtype
    xhat, inv = layer_norm_stats(x)
    h1 = (xhat * ln_s.float() + ln_b.float()).to(dt).reshape(B * N, D)
    w1d, w2d = w1.to(dt), w2.to(dt)
    gm = g.reshape(B * N, D)
    a = mm_f32(h1, w1d.t()) + b1.float()
    cdf = 0.5 * (1.0 + torch.erf(a * 0.7071067811865476))
    pdf = torch.exp(-0.5 * a * a) * 0.3989422804014327
    ga = (mm_f32(gm, w2d) * (cdf + a * pdf)).to(dt)
    gelu_a = (a * cdf).to(dt)
    dw2 = mm_f32(gm.t(), gelu_a)
    db2 = gm.float().sum(0)
    dw1 = mm_f32(ga.t(), h1)
    db1 = ga.float().sum(0)
    dh1 = mm_f32(ga, w1d).reshape(B, N, D)
    dx_ln, dln_s, dln_b = layer_norm_bwd(dh1, xhat, inv, ln_s)
    return ((g.float() + dx_ln).to(dt), dln_s, dln_b, dw1, db1, dw2, db2)


def final_ln_bwd(g, x, ln_s, ln_b, w1, b1, w2, b2, final_s):
    """The epilogue LayerNorm's backward of K3 (``_final_bwd`` :214-236):
    o = x + MLP(LN(x)) recomputed in fp32 with the fp32 weights, then
    (g2 in x's dtype, d_final_s, d_final_b) with g2 the cotangent the MLP
    backward takes."""
    B, N, D = x.shape
    xhat, _ = layer_norm_stats(x)
    h1 = xhat * ln_s.float() + ln_b.float()
    a = F.linear(h1, w1.float(), b1.float())
    cdf = 0.5 * (1.0 + torch.erf(a * 0.7071067811865476))
    o = x.float() + F.linear(a * cdf, w2.float(), b2.float())
    ohat, inv2 = layer_norm_stats(o)
    go, d_final_s, d_final_b = layer_norm_bwd(g.float(), ohat, inv2, final_s)
    return go.to(x.dtype), d_final_s, d_final_b


def _mlp_cuda(x, ln_s, ln_b, w1, b1, w2, b2, final=None):
    B, N, D = x.shape
    Hd = w1.shape[0]
    if D % 128 or Hd % 128:
        raise ValueError(f"the K2/K3 kernels take D % 128 == 0 and "
                         f"hidden % 128 == 0; got D={D}, hidden={Hd}")
    bf16 = torch.bfloat16
    launch.require(x, bf16, "x")
    w1 = w1.to(bf16).contiguous()
    w2 = w2.to(bf16).contiguous()
    launch.require(w1, bf16, "w1", (Hd, D))
    launch.require(w2, bf16, "w2", (D, Hd))
    fs, fb = ((launch.vec(final[0], D, "final_s"),
               launch.vec(final[1], D, "final_b"))
              if final is not None else (None, None))
    stats = torch.empty(B * N, 2, dtype=torch.float32, device=x.device)
    h = torch.empty(B * N, Hd, dtype=bf16, device=x.device)
    o32 = (torch.empty(B * N, D, dtype=torch.float32, device=x.device)
           if final is not None else None)
    out = torch.empty_like(x)
    launch.call("mfv_fused_mlp_block", x.device, x,
                launch.vec(ln_s, D, "ln_s"), launch.vec(ln_b, D, "ln_b"), w1,
                launch.vec(b1, Hd, "b1"), w2, launch.vec(b2, D, "b2"), fs, fb,
                stats, h, o32, out, B * N, D, Hd)
    return out


def fused_mlp_block_bwd(g, x, ln_s, ln_b, w1, b1, w2):
    """K7 on CUDA tensors: the outputs of ``fused_mlp_block_bwd_plain``
    from the kernels (bf16 g and x; the weights are cast to bf16 here).
    Anything the kernels do not take raises."""
    B, N, D = x.shape
    Hd = w1.shape[0]
    if D % 128 or Hd % 128:
        raise ValueError(f"the K7 kernels take D % 128 == 0 and hidden % "
                         f"128 == 0; got D={D}, hidden={Hd}")
    bf16, f32 = torch.bfloat16, torch.float32
    launch.require(x, bf16, "x")
    launch.require(g, bf16, "g", (B, N, D))
    w1 = w1.to(bf16).contiguous()
    w2 = w2.to(bf16).contiguous()
    launch.require(w1, bf16, "w1", (Hd, D))
    launch.require(w2, bf16, "w2", (D, Hd))
    M, dev = B * N, x.device

    def empty(*shape, dtype=f32):
        return torch.empty(*shape, dtype=dtype, device=dev)

    # dW1 and dW2 have the same tile count, so one split serves both
    s_w, k_w = launch.k_split(M, (D // 128) * (Hd // 128), 32)
    s_ln, k_ln = launch.k_split(M, D // 128, 1)
    part = empty(max(s_w * (Hd * D + max(Hd, D)), 2 * s_ln * D))
    dx = torch.empty_like(x)
    dln_s, dln_b, db2 = empty(D), empty(D), empty(D)
    dw1, db1, dw2 = empty(Hd, D), empty(Hd), empty(D, Hd)
    launch.call("mfv_fused_mlp_block_bwd", dev, g, x,
                launch.vec(ln_s, D, "ln_s"), launch.vec(ln_b, D, "ln_b"), w1,
                launch.vec(b1, Hd, "b1"), w2, empty(M, 2),
                empty(M, D, dtype=bf16), empty(M, Hd, dtype=bf16),
                empty(M, Hd, dtype=bf16), empty(M, D), part, dx, dln_s,
                dln_b, dw1, db1, dw2, db2, M, D, Hd, s_w, k_w, s_ln, k_ln)
    LAUNCHES["fused_mlp_block_bwd"] += 1
    return dx, dln_s, dln_b, dw1, db1, dw2, db2


def _mlp_bwd(plain, g, x, ln_s, ln_b, w1, b1, w2):
    bwd = fused_mlp_block_bwd_plain if plain else fused_mlp_block_bwd
    return bwd(g.contiguous(), x, ln_s, ln_b, w1, b1, w2)


def _cast(grads, params):
    return tuple(d.to(p.dtype) for d, p in zip(grads, params))


class _MlpBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_s, ln_b, w1, b1, w2, b2, plain):
        ctx.save_for_backward(x, ln_s, ln_b, w1, b1, w2, b2)
        ctx.plain = plain or not x.is_cuda
        if ctx.plain:
            return fused_mlp_block_plain(x, ln_s, ln_b, w1, b1, w2, b2)
        out = _mlp_cuda(x, ln_s, ln_b, w1, b1, w2, b2)
        LAUNCHES["fused_mlp_block"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        params = ctx.saved_tensors
        grads = _mlp_bwd(ctx.plain, g, *params[:6])
        return (*_cast(grads, params), None)


class _MlpBlockFinalLN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_s, ln_b, w1, b1, w2, b2, final_s, final_b, plain):
        ctx.save_for_backward(x, ln_s, ln_b, w1, b1, w2, b2, final_s,
                              final_b)
        ctx.plain = plain or not x.is_cuda
        if ctx.plain:
            return fused_mlp_block_final_ln_plain(x, ln_s, ln_b, w1, b1, w2,
                                                  b2, final_s, final_b)
        out = _mlp_cuda(x, ln_s, ln_b, w1, b1, w2, b2,
                        final=(final_s, final_b))
        LAUNCHES["fused_mlp_block_final_ln"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        params = ctx.saved_tensors
        g2, dfs, dfb = final_ln_bwd(g, *params[:8])
        grads = _mlp_bwd(ctx.plain, g2, *params[:6]) + (dfs, dfb)
        return (*_cast(grads, params), None)


def fused_mlp_block(x, ln_s, ln_b, w1, b1, w2, b2, plain: bool = False):
    """K2 forward, K7 backward. CPU tensors (and ``plain=True``) take the
    plain versions; CUDA tensors the kernels (bf16 x) or a ValueError."""
    return _MlpBlock.apply(x, ln_s, ln_b, w1, b1, w2, b2, plain)


def fused_mlp_block_final_ln(x, ln_s, ln_b, w1, b1, w2, b2, final_s,
                             final_b, plain: bool = False):
    """K3 forward; backward the epilogue LayerNorm in PyTorch, then K7."""
    return _MlpBlockFinalLN.apply(x, ln_s, ln_b, w1, b1, w2, b2, final_s,
                                  final_b, plain)

