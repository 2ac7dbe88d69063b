"""K15: a whole ViT block in one op, x2 = x + proj(MHSA(LN1(x))) then
x2 + fc2(GELU(fc1(LN2(x2)))), and its backward.

K15 replaces ``mfvit_tpu/ops/fused_block.py::fused_transformer_block``
(:89; ``pallas_call`` :111, ``_block_kernel`` :36). On a CUDA tensor it runs
csrc/fused_block.cu behind one C entry point: LN1(x) in bf16, the qkv GEMM
on the wgmma core of csrc/gemm_sm90.cuh, K1's attention core, then one
block-tail kernel on the same core that keeps x2 and the (M, 4D) hidden
activation in shared memory and registers (the notes in that source say
how, and what bounds it); ``_plan`` sizes the tail's ring of weight stages.
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

from typing import NamedTuple

import torch

from mfvit_tpu_torch.ops import fused_attn as fa
from mfvit_tpu_torch.ops import fused_mlp as fm
from mfvit_tpu_torch.ops import launch

LAUNCHES = {"fused_transformer_block": 0}

# the widest row the block tail holds on chip (its fp32 output tile lives
# in registers)
D_MAX = 512
# csrc/fused_block.cu's and gemm_sm90.cuh's constants: the tail's rows a
# tile, bytes of a ring stage and of a 64-row swizzled K slice, the hidden
# chunk, the most stages; the registers setmaxnreg gives a consumer and a
# producer thread, and a block's threads; the qkv GEMM's shared memory; and
# the shared memory a block can take on an H100
TAIL_ROWS, STAGE, TILE64, HC, STAGES_MAX = 64, 16384, 8192, 128, 8
CONSUMER_REGS, PRODUCER_REGS, THREADS = 232, 40, 384
GEMM_SMEM = 7 * 32768 + 2 * 7 * 8 + 1024
SMEM_MAX = 232448


class Plan(NamedTuple):
    """A launch of K15's block tail: ``stages`` weight stages in its ring,
    ``smem`` bytes of shared memory a block, and ``acc_regs`` fp32
    accumulators a consumer thread holds at once (fc2's D/4, across the
    chunks, and one fc1 chunk's 32)."""
    stages: int
    smem: int
    acc_regs: int


def _smem(D: int, stages: int) -> int:
    """fused_block.cu's Tail<D>::smem: the ring, the A tile (D / 64 K
    slices), the hidden chunk (two slices), x2 (pitch D + 8), the
    barriers, and 1024 bytes to align the swizzled tiles."""
    return (stages * STAGE + D // 64 * TILE64 + 2 * TILE64
            + TAIL_ROWS * (D + 8) * 2 + (2 * stages + 2) * 8 + 1024)


def _plan(D: int, Hd: int, dh: int) -> Plan:
    """The tail's plan at width D, hidden Hd and head_dim dh: as many ring
    stages as the shared memory beside the tiles holds, at most
    STAGES_MAX."""
    if D not in (128, 256, 384, 512) or Hd % HC or dh not in (32, 64, 128) \
            or D % dh:
        raise ValueError(f"the K15 kernel takes D of 128, 256, 384 or 512 "
                         f"(D <= {D_MAX}), head_dim 32/64/128 and hidden % "
                         f"{HC} == 0; got D={D}, head_dim={dh}, hidden={Hd}")
    stages = max(s for s in range(1, STAGES_MAX + 1)
                 if _smem(D, s) <= SMEM_MAX)
    return Plan(stages, _smem(D, stages), D // 4 + 32)


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
