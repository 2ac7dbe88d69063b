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

On a CUDA tensor K2 and K3 run on the wgmma core of csrc/gemm_sm90.cuh
(csrc/fused_mlp.cu), by width: at D of 128, 256, 384 or 512 one launch of
csrc/block_tail.cuh's tail kernel without its proj stage (LN2, the hidden
in chunks of 128 and fc2's output tile on chip, the (M, 4D) hidden never in
device memory; ``_plan`` sizes its ring of weight stages), K3 with an
epilogue that keeps x + fc2 + b2 in fp32 and takes the final LayerNorm of
each row on chip (the fp32 rows never in device memory); at D = 768
(vit_base, vit_base_ori, vit_conv_base), where fc2's fp32 output tile does
not fit the registers, three launches: LN2 in bf16, fc1 + bias + exact-erf
GELU into an (M, 4D) bf16 scratch, fc2 + bias + the bf16 residual (K3: fc2
with x + acc + bias in an (M, D) fp32 scratch, then a fourth launch for the
row LayerNorm). The route follows from D; neither gives way to the other
or to the plain version, and any other width raises.
``fused_mlp_block_wmma`` and ``fused_mlp_block_final_ln_wmma`` run the
WMMA chains K2 and K3 ran before on csrc/gemm_ln.cuh (the LayerNorm row
statistics, LN + fc1 + GELU into a bf16 hidden, fc2 + bias with the bf16
residual or, for K3, with the fp32 residual written out in fp32, then a
row LayerNorm kernel), for the card's checks only (no op calls them);
every route rounds where the chains do and sums in their order, so each
gives their bits. K7 is csrc/fused_mlp_bwd.cu on the wgmma core
(csrc/gemm_bwd_sm90.cuh: the recompute of fc1 and g . W2 as two
accumulators of one tile with the GELU backward in its epilogue, then the
weight-gradient and dh1 GEMMs with MN-major operands);
``fused_mlp_block_bwd_wmma`` runs the chain K7 ran before (csrc/
gemm_bwd.cuh's WMMA kernels) for the card's checks only, with the same
bits.

Both entry points are ``torch.autograd.Function``s on both devices: they
take the fp32 master weights, cast them inside, and return fp32 weight
gradients. On a CPU tensor (or with ``plain=True``) they run the plain
versions below, the reference the kernels are held to on the card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from mfvit_tpu_torch.nn.layers import (layer_norm, layer_norm_bwd,
                                       layer_norm_stats, linear_f32, mm_f32)
from mfvit_tpu_torch.ops import launch

LAUNCHES = {"fused_mlp_block": 0, "fused_mlp_block_final_ln": 0,
            "fused_mlp_block_bwd": 0}

# csrc/block_tail.cuh's and gemm_sm90.cuh's constants: the tail's rows a
# tile, bytes of a ring stage and of a 64-row swizzled K slice, the hidden
# chunk, the most stages, the fp32 rows K3's epilogue stages at once; the
# registers setmaxnreg gives a consumer and a producer thread, and a
# block's threads; the GEMM's shared memory; and the shared memory a block
# can take on an H100
TAIL_ROWS, STAGE, TILE64, HC, STAGES_MAX = 64, 16384, 8192, 128, 8
FINAL_ROWS = 32
CONSUMER_REGS, PRODUCER_REGS, THREADS = 232, 40, 384
GEMM_SMEM = 7 * 32768 + 2 * 7 * 8 + 1024
SMEM_MAX = 232448
# csrc/gemm_bwd_sm90.cuh's K7 dual kernel: rows a tile, ring stages, bytes
# of a stage (64-wide D slices of h1 and g, 128 rows each, W1's 128 rows and
# W2's two 64 x 64 boxes) and a block's shared memory
DUAL_BM, DUAL_STAGES = 128, 3
DUAL_STAGE = 8 * TILE64
DUAL_SMEM = DUAL_STAGES * DUAL_STAGE + 2 * DUAL_STAGES * 8 + 1024
# the widths the tail takes (its fp32 output tile lives in registers), and
# the wider ones K2 runs in three launches
TAIL_WIDTHS, WIDE_WIDTHS = (128, 256, 384, 512), (768,)


class Plan(NamedTuple):
    """A launch of K2 or K3 (or of K15's tail, at the same widths):
    ``route``
    "tail" (one launch, ``stages`` weight stages in its ring, ``smem``
    bytes of shared memory a block, ``acc_regs`` fp32 accumulators a
    consumer thread holds at once: fc2's D/4 across the chunks and one fc1
    chunk's 32) or "gemm" (three launches on the GEMM core, D > 512: no
    ring of its own, the GEMM's shared memory and 128 accumulators)."""
    route: str
    stages: int
    smem: int
    acc_regs: int


def _smem(D: int, stages: int) -> int:
    """block_tail.cuh's Tail<D>::smem: the ring, the A tile (D / 64 K
    slices), the hidden chunk (two slices), x2 (pitch D + 8), the
    barriers, and 1024 bytes to align the swizzled tiles. K3's epilogue
    takes no more: its fp32 rows pass through the x2 tile FINAL_ROWS at a
    time (FINAL_ROWS x (D + 8) fp32, the tile's bytes)."""
    return (stages * STAGE + D // 64 * TILE64 + 2 * TILE64
            + TAIL_ROWS * (D + 8) * 2 + (2 * stages + 2) * 8 + 1024)


def _plan(D: int, Hd: int) -> Plan:
    """K2's and K3's plan at width D and hidden Hd: at a tail width, as
    many ring stages as the shared memory beside the tiles holds (at most
    STAGES_MAX); at D = 768 the route on the GEMM core (K2 three launches,
    K3 four)."""
    if Hd % HC == 0 and Hd > 0:
        if D in TAIL_WIDTHS:
            stages = max(s for s in range(1, STAGES_MAX + 1)
                         if _smem(D, s) <= SMEM_MAX)
            return Plan("tail", stages, _smem(D, stages), D // 4 + 32)
        if D in WIDE_WIDTHS:
            return Plan("gemm", 0, GEMM_SMEM, 128)
    raise ValueError(f"the K2 and K3 kernels take D of 128, 256, 384 or 512 "
                     f"(one launch) or 768 (the GEMM core), and hidden % {HC} "
                     f"== 0; got D={D}, hidden={Hd}")


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


def _weights(x, w1, w2):
    """bf16 x and the bf16 weights the kernels take, or a ValueError."""
    D, Hd = x.shape[-1], w1.shape[0]
    bf16 = torch.bfloat16
    launch.require(x, bf16, "x")
    w1 = w1.to(bf16).contiguous()
    w2 = w2.to(bf16).contiguous()
    launch.require(w1, bf16, "w1", (Hd, D))
    launch.require(w2, bf16, "w2", (D, Hd))
    return w1, w2


def _mlp_cuda(x, ln_s, ln_b, w1, b1, w2, b2, final=()):
    """K2, or K3 with ``final`` = (final_s, final_b), on bf16 x, on the
    route ``_plan`` gives its width."""
    B, N, D = x.shape
    Hd = w1.shape[0]
    plan = _plan(D, Hd)
    w1, w2 = _weights(x, w1, w2)
    wide = plan.route == "gemm"
    scratch = [torch.empty(B * N, n, dtype=dt, device=x.device)
               if wide else None
               for n, dt in ((D, torch.bfloat16), (Hd, torch.bfloat16),
                             (D, torch.float32))[:3 if final else 2]]
    out = torch.empty_like(x)
    launch.call("mfv_fused_mlp_block_final_ln" if final
                else "mfv_fused_mlp_block", x.device, x,
                launch.vec(ln_s, D, "ln_s"), launch.vec(ln_b, D, "ln_b"), w1,
                launch.vec(b1, Hd, "b1"), w2, launch.vec(b2, D, "b2"),
                *_finals(final, D), *scratch, out, B * N, D, Hd, plan.stages)
    return out


def _finals(final, D: int) -> list:
    return [launch.vec(v, D, n) for v, n in zip(final, ("final_s",
                                                        "final_b"))]


def _wmma_chain(entry, x, ln_s, ln_b, w1, b1, w2, b2, final=()):
    """K3's (``final`` = (final_s, final_b)) or K2's former chain on
    csrc/gemm_ln.cuh."""
    B, N, D = x.shape
    Hd = w1.shape[0]
    if D % 128 or Hd % 128:
        raise ValueError(f"the K2/K3 WMMA kernels take D % 128 == 0 and "
                         f"hidden % 128 == 0; got D={D}, hidden={Hd}")
    w1, w2 = _weights(x, w1, w2)
    f32, dev = torch.float32, x.device
    out = torch.empty_like(x)
    launch.call(entry, dev, x, launch.vec(ln_s, D, "ln_s"),
                launch.vec(ln_b, D, "ln_b"), w1, launch.vec(b1, Hd, "b1"), w2,
                launch.vec(b2, D, "b2"), *_finals(final, D),
                torch.empty(B * N, 2, dtype=f32, device=dev),
                torch.empty(B * N, Hd, dtype=torch.bfloat16, device=dev),
                *([torch.empty(B * N, D, dtype=f32, device=dev)] if final
                  else []), out, B * N, D, Hd)
    return out


def fused_mlp_block_wmma(x, ln_s, ln_b, w1, b1, w2, b2) -> torch.Tensor:
    """The chain K2 ran before its redesign (LN statistics and two
    ``gemm_ln`` launches, csrc/fused_mlp.cu's ``mfv_fused_mlp_block_wmma``),
    forward only, on CUDA tensors: the comparator the card's checks hold K2
    against bit for bit. No op calls it, and it counts no launch."""
    return _wmma_chain("mfv_fused_mlp_block_wmma", x, ln_s, ln_b, w1, b1, w2,
                       b2)


def fused_mlp_block_final_ln_wmma(x, ln_s, ln_b, w1, b1, w2, b2, final_s,
                                  final_b) -> torch.Tensor:
    """The chain K3 ran before its redesign (csrc/fused_mlp.cu's
    ``mfv_fused_mlp_block_final_ln_wmma``: LN statistics, two ``gemm_ln``
    launches with the fp32 sum written out, then the row LayerNorm),
    forward only, on CUDA tensors: the comparator the card's checks hold
    K3 against. No op calls it, and it counts no launch."""
    return _wmma_chain("mfv_fused_mlp_block_final_ln_wmma", x, ln_s, ln_b,
                       w1, b1, w2, b2, final=(final_s, final_b))


def fused_mlp_block_bwd(g, x, ln_s, ln_b, w1, b1, w2):
    """K7 on CUDA tensors: the outputs of ``fused_mlp_block_bwd_plain``
    from the kernels (bf16 g and x; the weights are cast to bf16 here).
    Anything the kernels do not take raises."""
    out = _mlp_bwd_chain("mfv_fused_mlp_block_bwd", g, x, ln_s, ln_b, w1, b1,
                         w2)
    LAUNCHES["fused_mlp_block_bwd"] += 1
    return out


def fused_mlp_block_bwd_wmma(g, x, ln_s, ln_b, w1, b1, w2):
    """The chain K7 ran before its redesign (csrc/fused_mlp_bwd.cu's
    ``mfv_fused_mlp_block_bwd_wmma``: gemm_bwd.cuh's WMMA dual, TN and NN
    kernels), on CUDA tensors: the comparator the card's checks hold K7
    against bit for bit. No op calls it, and it counts no launch."""
    return _mlp_bwd_chain("mfv_fused_mlp_block_bwd_wmma", g, x, ln_s, ln_b,
                          w1, b1, w2)


def _mlp_bwd_chain(entry, g, x, ln_s, ln_b, w1, b1, w2):
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
    launch.call(entry, dev, g, x,
                launch.vec(ln_s, D, "ln_s"), launch.vec(ln_b, D, "ln_b"), w1,
                launch.vec(b1, Hd, "b1"), w2, empty(M, 2),
                empty(M, D, dtype=bf16), empty(M, Hd, dtype=bf16),
                empty(M, Hd, dtype=bf16), empty(M, D), part, dx, dln_s,
                dln_b, dw1, db1, dw2, db2, M, D, Hd, s_w, k_w, s_ln, k_ln)
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
    plain versions; CUDA tensors the kernels (bf16 x, D of 128-512 or 768)
    or a ValueError."""
    return _MlpBlock.apply(x, ln_s, ln_b, w1, b1, w2, b2, plain)


def fused_mlp_block_final_ln(x, ln_s, ln_b, w1, b1, w2, b2, final_s,
                             final_b, plain: bool = False):
    """K3 forward (CUDA tensors: bf16 x, D of 128-512 or 768, or a
    ValueError); backward the epilogue LayerNorm in PyTorch, then K7."""
    return _MlpBlockFinalLN.apply(x, ln_s, ln_b, w1, b1, w2, b2, final_s,
                                  final_b, plain)

