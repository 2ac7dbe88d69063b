"""K1, K5 and K9: the attention half of a ViT block, x + proj(MHSA(LN(x))),
and its backward.

- K1, the forward, replaces ``mfvit_tpu/ops/fused_attn.py::
  fused_attention_block`` (Pallas ``_kernel`` :28). On a CUDA tensor it
  runs four hand-written kernels behind one C entry point
  (csrc/fused_attn.cu): LN1(x) in bf16 (csrc/block_tail.cuh's LayerNorm
  pass), the qkv GEMM with its bias on the wgmma core of
  csrc/gemm_sm90.cuh, the attention core of csrc/attn_async.cu (scores and
  softmax on chip; a producer warp stages each (image, head)'s q, K and V
  into a ring of shared memory under the previous pair's MMAs), and the
  proj GEMM with its bias and the bf16 residual on the same wgmma core. The
  notes in those sources say what bounds each on an H100. Unlike the TPU
  kernel, qkv and o make one round trip through device memory; the scores
  do not. It takes N <= 256 and D of 128, 256, 384, 512 or 768.
  ``fused_attention_block_wmma`` runs the chain K1 ran before (the
  LayerNorm row statistics, ``gemm_ln``'s WMMA GEMMs and csrc/
  attn_core.cuh's core) for the card's checks only: no op calls it, and
  both give the same bits.
- K5, the backward of K1, replaces ``_fused_attn_bwd_impl`` (Pallas
  ``_bwd_kernel`` :385) and, at D > 512, ``_fused_attn_bwd_bigdim`` (K6,
  :661): csrc/fused_attn_bwd.cu, its GEMMs on the wgmma core (the qkv
  recompute on csrc/gemm_sm90.cuh, dO, dWqkv and dh on its MN-major forms
  in csrc/gemm_bwd_sm90.cuh), the fp32 dWproj on the CUDA cores and the
  attention-backward core of csrc/attn_bwd_async.cuh (a producer warp
  staging each (image, head)'s rows, ldmatrix fragments).
  ``fused_attention_block_bwd_wmma`` runs the chain K5 ran before (WMMA
  GEMMs of csrc/gemm_bwd.cuh, csrc/attn_bwd.cuh's core) for the card's
  checks only: no op calls it, and both give the same bits.
- K9, ``fused_attention_block_large``, the same forward for any N,
  replaces ``fused_attention_block_large`` (Pallas ``_kernel_qblocked``
  :244, ``pallas_call`` :343): csrc/fused_attn_large.cu, K1's route (its
  LN pass, and its qkv and proj GEMMs on the wgmma core) around the
  long-sequence attention core csrc/attn_long_async.cu: persistent blocks,
  a producer warp streaming each unit's q rows and key tiles (K for the
  first pass over the keys, K and V for the second) into an mbarrier ring
  by ``cp.async``, consumer warps that each hold a 16-row query tile of
  the unit's head, ldmatrix fragments; ``_long_plan`` copies its sizes.
  It takes D of 128, 256, 384, 512 or 768 and any N.
  ``fused_attention_block_large_wmma`` runs the chain K9 ran before (the
  LayerNorm row statistics, ``gemm_ln``'s WMMA GEMMs and csrc/
  attn_long.cuh's core, which streams the keys through shared memory in
  tiles staged by every warp) for the card's checks only: no op calls
  it, and both give the same bits. Its backward is the JAX package's for K9, ``_bwd_xla_reference`` (:754),
  a full-fp32 recompute with no bf16 rounding and no Pallas kernel: here
  ``fused_attention_block_bwd_plain`` on fp32 copies of its inputs, plain
  PyTorch on both devices (its large products are ``torch.matmul``).

K9 rounds where K1 does (``_kernel_qblocked`` :244-292 against ``_kernel``
:28-87), so both have one plain version, ``fused_attention_block_plain``,
line by line: LayerNorm with eps 1e-6 and fp32 statistics, h rounded to
x's dtype; qkv = h . Wqkv + bqkv with fp32 sums and the fp32 bias, rounded;
q scaled in fp32 and rounded; fp32 scores (the padded keys the TPU kernel
masks to -1e30 do not exist here); the row max, p = exp(s - max) and
r = 1/sum(p) in fp32; PV with p rounded, fp32 sums, times r, rounded;
proj + bias in fp32, rounded, plus x in x's dtype.

``fused_attention_block`` and ``fused_attention_block_large`` are one
``torch.autograd.Function`` on both devices. It takes the fp32 master
weights, casts them to x's dtype inside, and returns fp32 weight and bias
gradients and a dx in x's dtype, as the JAX ``_bwd`` (:734-751) and
``_bwd_xla_reference`` do. On a CPU tensor (or with ``plain=True``) it runs
``fused_attention_block_plain`` forward and, for K1,
``fused_attention_block_bwd_plain`` backward, the same math in PyTorch,
which is also the reference the kernels are held to on the card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mfvit_tpu_torch.nn.layers import (layer_norm, layer_norm_bwd,
                                       layer_norm_stats, linear_f32, mm_f32)
from mfvit_tpu_torch.ops import launch

LAUNCHES = {"fused_attention_block": 0, "fused_attention_block_bwd": 0,
            "fused_attention_block_large": 0}


def attn_core_plain(qkv: torch.Tensor, heads: int, scale: float,
                    out_dtype: torch.dtype | None = None):
    """(B, N, 3D) packed qkv ([q|k|v] x head x dh) -> (B, N, D), with the
    TPU kernel's rounding points: q scaled in fp32 and rounded, fp32 scores
    and softmax, P rounded for PV, 1/sum applied to the PV output. The
    output is in qkv's dtype unless ``out_dtype`` is given (K10 quantizes
    the fp32 output)."""
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
    return o.transpose(1, 2).reshape(B, N, D).to(out_dtype or dt)


def fused_attention_block_plain(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj,
                                heads: int, scale: float) -> torch.Tensor:
    """x (B, N, D) -> x + proj(MHSA(LN(x))) in x's dtype. Weights are torch
    Linear layout (out, in): wqkv (3D, D), wproj (D, D)."""
    dt = x.dtype
    h = layer_norm(x, ln_s, ln_b, 1e-6)
    qkv = linear_f32(h, wqkv, bqkv).to(dt)
    o = attn_core_plain(qkv, heads, scale)
    return x + linear_f32(o, wproj, bproj).to(dt)


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


def _check(B: int, N: int, D: int, heads: int, what: str,
           n_max: int | None = 256) -> None:
    """The shapes the kernels take: head_dim 32/64/128, D % 128 == 0 and
    N <= ``n_max`` (any N where it is None: K9, and K10 over K9's core)."""
    dh = D // heads
    if (dh * heads != D or dh not in (32, 64, 128) or D % 128
            or (n_max is not None and N > n_max)):
        n_rule = "" if n_max is None else f"N <= {n_max} and "
        raise ValueError(f"the {what} kernels take head_dim 32/64/128, "
                         f"{n_rule}D % 128 == 0; got D={D}, "
                         f"heads={heads}, N={N}")


# csrc/attn_bwd_async.cuh's constants (K5's attention-backward core): the
# shared memory a block can take, the consumer warps a block by head_dim,
# and the key rows staged, the smallest of these that holds N
BWD_SMEM_MAX = 232448
BWD_WARPS = {32: 15, 64: 15, 128: 7}
BWD_KEYS = (64, 128, 208, 256)


class BwdPlan(NamedTuple):
    """A launch of K5's attention-backward core: ``keys`` rows staged of
    each part (zeros past N), ``slots`` ring slots (each one stage: a
    pair's K and V rows, or its Q and dO rows) and as many statistics
    buffers, ``warps`` consumer warps beside the producer warp, ``smem``
    bytes of shared memory a block."""
    keys: int
    slots: int
    warps: int
    smem: int


def _bwd_slot_bytes(keys: int, dh: int) -> int:
    """AsyncBwd::PER_SLOT: two parts of ``keys`` rows of pitch dh + 8 in
    bf16, the row max, sum and D_i in fp32, three mbarriers."""
    return 2 * keys * (dh + 8) * 2 + 3 * keys * 4 + 3 * 8


def _bwd_plan(N: int, dh: int) -> BwdPlan:
    """The core's plan at N tokens and head_dim dh: as many slots (at most
    4) as a block's shared memory holds. The C side computes the same
    from its template arguments; this copy checks what it takes."""
    if dh not in BWD_WARPS or not 0 < N <= BWD_KEYS[-1]:
        raise ValueError(f"the K5 kernels take head_dim 32/64/128 and N <= "
                         f"{BWD_KEYS[-1]}; got head_dim {dh}, N={N}")
    keys = next(k for k in BWD_KEYS if N <= k)
    per = _bwd_slot_bytes(keys, dh)
    slots = max(s for s in range(1, 5) if s * per <= BWD_SMEM_MAX)
    return BwdPlan(keys, slots, BWD_WARPS[dh], slots * per)


# the widths K1's LayerNorm pass takes (csrc/block_tail.cuh's ln1_takes)
K1_WIDTHS = (128, 256, 384, 512, 768)

# csrc/attn_long_async.cuh's constants (K9's long-sequence core): keys (and
# query rows) a ring stage, consumer warps a block, ring stages; the blocks
# an SM by head_dim (attn_long_async.cu's LongAsync::BLOCKS)
LONG_KEYS, LONG_W, LONG_STAGES = 64, 8, 8
LONG_BLOCKS = {32: 2, 64: 2, 128: 1}


class LongPlan(NamedTuple):
    """A launch of K9's long-sequence core at N tokens: ``stages`` ring
    stages of ``stage_bytes`` each (LONG_KEYS rows of pitch dh + 8 in
    bf16: a unit's q rows, a K tile or a V tile), ``warps`` consumer warps
    beside the producer warp (one 16-row query tile each), ``blocks``
    blocks an SM, ``smem`` bytes of shared memory a block (the ring and
    its full and empty mbarriers), ``units`` units of ``warps`` query
    tiles for each (image, head), ``key_tiles`` key tiles of LONG_KEYS."""
    stages: int
    stage_bytes: int
    warps: int
    blocks: int
    smem: int
    units: int
    key_tiles: int


def _long_plan(N: int, dh: int) -> LongPlan:
    """The long core's plan at N tokens and head_dim dh; the C side
    computes the same from its constants and the launch's N."""
    if dh not in LONG_BLOCKS or N < 1:
        raise ValueError(f"the K9 kernels take head_dim 32/64/128 and N >= "
                         f"1; got head_dim {dh}, N={N}")
    stage = LONG_KEYS * (dh + 8) * 2
    return LongPlan(LONG_STAGES, stage, LONG_W, LONG_BLOCKS[dh],
                    LONG_STAGES * stage + 2 * LONG_STAGES * 8,
                    -(-N // (16 * LONG_W)), -(-N // LONG_KEYS))


def _forward_cuda(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, heads, scale,
                  large):
    """K1 (K9 if ``large``) on bf16 x; the weights are cast to bf16 here."""
    B, N, D = x.shape
    what = "K9" if large else "K1"
    _check(B, N, D, heads, what, None if large else 256)
    if D not in K1_WIDTHS:
        raise ValueError(f"the {what} kernels take D of 128, 256, 384, 512 "
                         f"or 768; got D={D}")
    if large:
        _long_plan(N, D // heads)
    name = "fused_attention_block_large" if large else "fused_attention_block"
    out = _attn_chain(f"mfv_{name}", x, ln_s, ln_b, wqkv, bqkv, wproj, bproj,
                      heads, scale, stats=False)
    LAUNCHES[name] += 1
    return out


def _attn_chain(entry, x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, heads,
                scale, stats):
    """One launch chain of the attention half through its C entry point,
    with the (M, 2) fp32 statistics scratch where the chain takes it."""
    B, N, D = x.shape
    bf16 = torch.bfloat16
    launch.require(x, bf16, "x")
    wqkv = wqkv.to(bf16).contiguous()
    wproj = wproj.to(bf16).contiguous()
    launch.require(wqkv, bf16, "wqkv", (3 * D, D))
    launch.require(wproj, bf16, "wproj", (D, D))
    dev = x.device
    scratch = ([torch.empty(B * N, 2, dtype=torch.float32, device=dev)]
               if stats else [])
    qkv = torch.empty(B, N, 3 * D, dtype=bf16, device=dev)
    o = torch.empty(B, N, D, dtype=bf16, device=dev)
    out = torch.empty_like(x)
    launch.call(entry, dev, x,
                launch.vec(ln_s, D, "ln_s"), launch.vec(ln_b, D, "ln_b"),
                wqkv, launch.vec(bqkv, 3 * D, "bqkv"), wproj,
                launch.vec(bproj, D, "bproj"), *scratch, qkv, o, out, B, N,
                D, heads, scale)
    return out


def fused_attention_block_wmma(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj,
                               heads: int, scale: float) -> torch.Tensor:
    """The chain K1 ran before its redesign (csrc/fused_attn.cu's
    ``mfv_fused_attention_block_wmma``: LN statistics, ``gemm_ln``'s GEMMs,
    attn_core.cuh's core), forward only, on CUDA tensors: the comparator
    the card's checks hold K1 against bit for bit. No op calls it, and it
    counts no launch."""
    B, N, D = x.shape
    _check(B, N, D, heads, "K1")
    return _attn_chain("mfv_fused_attention_block_wmma", x, ln_s, ln_b, wqkv,
                       bqkv, wproj, bproj, heads, scale, stats=True)


def fused_attention_block_large_wmma(x, ln_s, ln_b, wqkv, bqkv, wproj,
                                     bproj, heads: int,
                                     scale: float) -> torch.Tensor:
    """The chain K9 ran before its redesign (csrc/fused_attn_large.cu's
    ``mfv_fused_attention_block_large_wmma``: LN statistics, ``gemm_ln``'s
    GEMMs, attn_long.cuh's core), forward only, on CUDA tensors: the
    comparator the card's checks hold K9 against bit for bit. No op calls
    it, and it counts no launch."""
    B, N, D = x.shape
    _check(B, N, D, heads, "K9", None)
    return _attn_chain("mfv_fused_attention_block_large_wmma", x, ln_s, ln_b,
                       wqkv, bqkv, wproj, bproj, heads, scale, stats=True)


def bwd_cuda(g, x, ln_s, ln_b, wqkv, bqkv, wproj, heads: int, scale: float,
             cb: int = 0, entry: str | None = None):
    """K5's launch chain on CUDA tensors, with T5's staged core over units
    of ``cb`` images where cb > 0 (or the chain ``entry`` names): the outputs
    of ``fused_attention_block_bwd_plain`` (bf16 g and x; the weights are
    cast to bf16 here). Anything the kernels do not take raises. Counts no
    launch: its callers do."""
    B, N, D = x.shape
    _check(B, N, D, heads, "K5")
    _bwd_plan(N, D // heads)
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
    entry = entry or ("mfv_staged_bwd" if cb
                      else "mfv_fused_attention_block_bwd")
    launch.call(entry, dev, g, x,
                launch.vec(ln_s, D, "ln_s"), launch.vec(ln_b, D, "ln_b"),
                wqkv, launch.vec(bqkv, 3 * D, "bqkv"), wproj,
                empty(M, 2), empty(M, D, dtype=bf16),
                empty(M, 3 * D, dtype=bf16), empty(M, D, dtype=bf16),
                empty(M, D), empty(M, 3 * D, dtype=bf16), empty(M, D), part,
                dx, dln_s, dln_b, dwqkv, dbqkv, dwproj, dbproj, B, N, D,
                heads, scale, s_qkv, k_qkv, s_proj, k_proj, s_ln, k_ln,
                *([cb] if cb else []))
    return dx, dln_s, dln_b, dwqkv, dbqkv, dwproj, dbproj


def fused_attention_block_bwd(g, x, ln_s, ln_b, wqkv, bqkv, wproj,
                              heads: int, scale: float):
    """K5 on CUDA tensors: the outputs of ``fused_attention_block_bwd_plain``
    from the kernels (bf16 g and x; the weights are cast to bf16 here).
    Anything the kernels do not take raises."""
    out = bwd_cuda(g, x, ln_s, ln_b, wqkv, bqkv, wproj, heads, scale)
    LAUNCHES["fused_attention_block_bwd"] += 1
    return out


def fused_attention_block_bwd_wmma(g, x, ln_s, ln_b, wqkv, bqkv, wproj,
                                   heads: int, scale: float):
    """The chain K5 ran before its redesign (csrc/fused_attn_bwd.cu's
    ``mfv_fused_attention_block_bwd_wmma``: ``gemm_ln``'s qkv GEMM,
    gemm_bwd.cuh's WMMA NN and TN GEMMs and 4 x 4 fp32 dWproj, attn_bwd.cuh's
    core), on CUDA tensors: the comparator the card's checks hold K5
    against bit for bit. No op calls it, and it counts no launch."""
    return bwd_cuda(g, x, ln_s, ln_b, wqkv, bqkv, wproj, heads, scale,
                    entry="mfv_fused_attention_block_bwd_wmma")


def fused_attention_block_bwd_f32(g, x, ln_s, ln_b, wqkv, bqkv, wproj,
                                  heads: int, scale: float):
    """K9's backward, the JAX package's ``_bwd_xla_reference`` (:754): the
    gradients of the block recomputed in fp32 from fp32 copies of g, x and
    the weights, with no bf16 rounding anywhere, on the inputs' device.
    Outputs as ``fused_attention_block_bwd_plain``'s, all fp32."""
    return fused_attention_block_bwd_plain(
        *(t.float() for t in (g, x, ln_s, ln_b, wqkv, bqkv, wproj)), heads,
        scale)


class _AttentionBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, heads, scale,
                plain, large):
        ctx.save_for_backward(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj)
        ctx.heads, ctx.scale, ctx.large = heads, scale, large
        ctx.plain = plain or not x.is_cuda
        if ctx.plain:
            return fused_attention_block_plain(x, ln_s, ln_b, wqkv, bqkv,
                                               wproj, bproj, heads, scale)
        return _forward_cuda(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, heads,
                             scale, large)

    @staticmethod
    def backward(ctx, g):
        x, ln_s, ln_b, wqkv, bqkv, wproj, bproj = ctx.saved_tensors
        bwd = (fused_attention_block_bwd_f32 if ctx.large
               else fused_attention_block_bwd_plain if ctx.plain
               else fused_attention_block_bwd)
        grads = bwd(g.contiguous(), x, ln_s, ln_b, wqkv, bqkv, wproj,
                    ctx.heads, ctx.scale)
        params = (x, ln_s, ln_b, wqkv, bqkv, wproj, bproj)
        return (*(d.to(p.dtype) for d, p in zip(grads, params)), None, None,
                None, None)


def fused_attention_block(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj,
                          heads: int, scale: float, plain: bool = False):
    """K1 forward, K5 backward. CPU tensors (and ``plain=True``) take the
    plain versions; CUDA tensors the kernels (bf16 x, N <= 256, D of 128,
    256, 384, 512 or 768) or a ValueError. Weights may be fp32 (the master
    copies); their gradients are fp32."""
    return _AttentionBlock.apply(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj,
                                 heads, scale, plain, False)


def fused_attention_block_large(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj,
                                heads: int, scale: float,
                                plain: bool = False):
    """K9 forward (any N), fp32-recompute backward on both devices. CPU
    tensors (and ``plain=True``) take the plain forward; CUDA tensors the
    kernels (bf16 x) or a ValueError. Weights may be fp32; their gradients
    are fp32."""
    return _AttentionBlock.apply(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj,
                                 heads, scale, plain, True)
