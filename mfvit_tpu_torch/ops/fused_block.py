"""K15: a whole ViT block in one op, x2 = x + proj(MHSA(LN1(x))) then
x2 + fc2(GELU(fc1(LN2(x2)))), and its backward.

K15 replaces ``mfvit_tpu/ops/fused_block.py::fused_transformer_block``
(:89; ``pallas_call`` :111, ``_block_kernel`` :36). On a CUDA tensor it runs
csrc/fused_block.cu behind one C entry point: K1's first three launches
(LN1(x) in bf16, the qkv GEMM on the wgmma core of csrc/gemm_sm90.cuh, the
attention core of csrc/attn_async.cu), then csrc/block_tail.cuh's tail
kernel with its proj stage, on the same core, which keeps x2 and the (M,
4D) hidden activation in shared memory and registers (the notes in that
header say how, and what bounds it); ``_plan`` sizes the tail's ring of
weight stages, as K2's does (the same tiles).
It takes K1's shapes (head_dim 32/64/128, N <= 256, any B) and D of 128,
256, 384 or 512; the hidden width must be a multiple of 128. Anything
else on a CUDA tensor raises. The TPU kernel's choice of 2 or 1 images a grid step (:104) is a
TPU grid choice and is not ported.

Its rounding points are K1's and then K2's, so its plain version is the
two plain halves in a row, ``fused_mlp_block_plain(
fused_attention_block_plain(x, ...), ...)``, and the kernel equals the
K1 -> K2 kernel chain bit for bit.

The backward is JAX's ``_bwd`` (:154-168), which saves only the inputs:
recompute x2 with K1's forward, run K7 on (x2, g), then K5 on (x, g2). On
a CPU tensor (or with ``plain=True``) each of the three is its plain
version. So one forward and backward on the card launch K15 once and K1,
K7 and K5 once each.

No block plan of ``nn/vit.py`` runs it, as in the JAX package: it is
reached through this Python API and ``mfvit_tpu_torch.tools.bench_block``.
"""
from __future__ import annotations

import torch

from mfvit_tpu_torch.ops import fused_attn as fa
from mfvit_tpu_torch.ops import fused_mlp as fm
from mfvit_tpu_torch.ops import launch

LAUNCHES = {"fused_transformer_block": 0}

# the widest row the block tail holds on chip (its fp32 output tile lives
# in registers)
D_MAX = 512


def _plan(D: int, Hd: int, dh: int) -> fm.Plan:
    """The tail's plan at width D, hidden Hd and head_dim dh: K2's (the
    same tiles and ring; ``fused_mlp._plan``) at the widths the tail
    takes."""
    if D not in fm.TAIL_WIDTHS or Hd % fm.HC or Hd <= 0 \
            or dh not in (32, 64, 128) or D % dh:
        raise ValueError(f"the K15 kernel takes D of 128, 256, 384 or 512 "
                         f"(D <= {D_MAX}), head_dim 32/64/128 and hidden % "
                         f"{fm.HC} == 0; got D={D}, head_dim={dh}, "
                         f"hidden={Hd}")
    return fm._plan(D, Hd)


def fused_transformer_block_plain(x, ln1_s, ln1_b, wqkv, bqkv, wproj, bproj,
                                  ln2_s, ln2_b, w1, b1, w2, b2, heads: int,
                                  scale: float) -> torch.Tensor:
    """x (B, N, D) -> the block's output in x's dtype. Weights are in the
    torch Linear layout (out, in): wqkv (3D, D), wproj (D, D), w1 (Hd, D),
    w2 (D, Hd)."""
    x2 = fa.fused_attention_block_plain(x, ln1_s, ln1_b, wqkv, bqkv, wproj,
                                        bproj, heads, scale)
    return fm.fused_mlp_block_plain(x2, ln2_s, ln2_b, w1, b1, w2, b2)


def _forward_cuda(x, ln1_s, ln1_b, wqkv, bqkv, wproj, bproj, ln2_s, ln2_b,
                  w1, b1, w2, b2, heads, scale):
    """K15 on bf16 x; the weights are cast to bf16 here."""
    B, N, D = x.shape
    Hd = w1.shape[0]
    fa._check(B, N, D, heads, "K15")
    plan = _plan(D, Hd, D // heads)
    bf16 = torch.bfloat16
    launch.require(x, bf16, "x")
    w = {}
    for name, t, shape in (("wqkv", wqkv, (3 * D, D)), ("wproj", wproj, (D, D)),
                           ("w1", w1, (Hd, D)), ("w2", w2, (D, Hd))):
        w[name] = t.to(bf16).contiguous()
        launch.require(w[name], bf16, name, shape)
    dev = x.device
    qkv = torch.empty(B, N, 3 * D, dtype=bf16, device=dev)
    o = torch.empty(B, N, D, dtype=bf16, device=dev)
    out = torch.empty_like(x)
    launch.call("mfv_fused_transformer_block", dev, x,
                launch.vec(ln1_s, D, "ln1_s"), launch.vec(ln1_b, D, "ln1_b"),
                w["wqkv"], launch.vec(bqkv, 3 * D, "bqkv"), w["wproj"],
                launch.vec(bproj, D, "bproj"), launch.vec(ln2_s, D, "ln2_s"),
                launch.vec(ln2_b, D, "ln2_b"), w["w1"],
                launch.vec(b1, Hd, "b1"), w["w2"], launch.vec(b2, D, "b2"),
                qkv, o, out, B, N, D, heads, Hd, plan.stages, scale)
    LAUNCHES["fused_transformer_block"] += 1
    return out


class _Block(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln1_s, ln1_b, wqkv, bqkv, wproj, bproj, ln2_s, ln2_b,
                w1, b1, w2, b2, heads, scale, plain):
        params = (x, ln1_s, ln1_b, wqkv, bqkv, wproj, bproj, ln2_s, ln2_b,
                  w1, b1, w2, b2)
        ctx.save_for_backward(*params)
        ctx.heads, ctx.scale = heads, scale
        ctx.plain = plain or not x.is_cuda
        if ctx.plain:
            return fused_transformer_block_plain(*params, heads, scale)
        return _forward_cuda(*params, heads, scale)

    @staticmethod
    def backward(ctx, g):
        params = ctx.saved_tensors
        x, ln1_s, ln1_b, wqkv, bqkv, wproj, bproj = params[:7]
        ln2_s, ln2_b, w1, b1, w2 = params[7:12]
        attn = (x, ln1_s, ln1_b, wqkv, bqkv, wproj, bproj)
        heads, scale = ctx.heads, ctx.scale
        g = g.contiguous()
        if ctx.plain:
            x2 = fa.fused_attention_block_plain(*attn, heads, scale)
            g2, *d_mlp = fm.fused_mlp_block_bwd_plain(g, x2, ln2_s, ln2_b,
                                                      w1, b1, w2)
            d_attn = fa.fused_attention_block_bwd_plain(g2, *attn[:-1],
                                                        heads, scale)
        else:
            x2 = fa._forward_cuda(*attn, heads, scale, False)
            g2, *d_mlp = fm.fused_mlp_block_bwd(g, x2, ln2_s, ln2_b, w1, b1,
                                                w2)
            d_attn = fa.fused_attention_block_bwd(g2, *attn[:-1], heads,
                                                  scale)
        grads = (*d_attn, *d_mlp)
        return (*(d.to(p.dtype) for d, p in zip(grads, params)), None, None,
                None)


def fused_transformer_block(x, ln1_s, ln1_b, wqkv, bqkv, wproj, bproj, ln2_s,
                            ln2_b, w1, b1, w2, b2, heads: int, scale: float,
                            plain: bool = False):
    """K15 forward; backward K1 (recompute), K7, K5. CPU tensors (and
    ``plain=True``) take the plain versions; CUDA tensors the kernels (bf16
    x) or a ValueError. Weights may be fp32 (the master copies); their
    gradients are fp32."""
    return _Block.apply(x, ln1_s, ln1_b, wqkv, bqkv, wproj, bproj, ln2_s,
                        ln2_b, w1, b1, w2, b2, heads, scale, plain)
