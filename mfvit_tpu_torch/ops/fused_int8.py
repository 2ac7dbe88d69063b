"""K10 and K11: the int8 W8A8 serving variants of the two halves of a ViT
block (inference only), the port of ``mfvit_tpu/ops/fused_int8.py``.

- K10 ``fused_attention_block_i8``: x + proj(MHSA(LN(x))) with int8 qkv
  and proj GEMMs; replaces ``fused_attention_block_i8`` (Pallas
  ``_attn_kernel_i8`` :168).
- K11 ``fused_mlp_block_i8``: x + fc2(GELU(fc1(LN(x)))) with int8 fc1 and
  fc2; replaces ``fused_mlp_block_i8`` (Pallas ``_mlp_kernel_i8`` :100).

Weights are symmetric int8 with one fp32 scale per output channel
(``quantize_weight_cols``, in the torch (out, in) layout); activations are
quantized per row (per token) with a dynamic absmax scale
(``quant_rows``) inside the op. The attention math (scores, softmax, PV)
stays bf16/fp32, the LayerNorms fp32 and the residual stream in x's dtype.

On a CUDA tensor each op launches its kernels (csrc/fused_int8.cu) on
bf16 x or raises; on a CPU tensor (or with ``plain=True``) it runs the
plain version below, which rounds where the TPU kernels do and is the
reference the kernels are held to on the card. The ops have no backward,
as in JAX: an x that requires a gradient under grad mode raises.

- K10 runs, from ``I8Q_FUSED_WORK`` token rows x width on, three
  launches: the qkv GEMM on csrc/gemm_i8_sm90.cuh's quantizing int8 GEMM
  (LN and the row quantization of x on chip), the attention core with an
  fp32 output (csrc/attn_async.cu; past 256 tokens
  csrc/attn_long_async.cu), and the proj GEMM on the same quantizing GEMM
  over that output; no int8 rows or scales in device memory. ``_qa_plan``
  copies each GEMM's sizes. At fewer rows each quantization is a launch of
  its own before the plain int8 wgmma core (five launches). ``fused_attention_block_i8_route`` forces
  either route and ``fused_attention_block_i8_mma`` runs the chain K10 ran
  before (csrc/gemm_i8.cuh's ``mma.sync`` GEMMs, csrc/attn_core.cuh's or
  attn_long.cuh's core), for the card's checks and timings only: no op
  calls them, and all give the same bits.
- K11 runs, at D of 128-384 and from ``I8T_TAIL_ROWS`` rows on, one
  launch of csrc/gemm_i8_sm90.cuh's tail:
  per 64-row tile, LN and the row quantization of x on chip, fc1 on the
  int8 wgmma core twice (first each row's absmax of GELU(fc1), then its
  int8 codes, a chunk of 128 hidden columns at a time), fc2 from those
  codes in shared memory, the residual; no scratch in device memory.
  ``_plan`` copies its ring's size. At wider D, and at fewer rows (a
  wave of the tail takes a tile's latency), it runs four launches (LN +
  quantize, fc1 + GELU into fp32 h1, quantize h1, fc2 + residual) with
  both GEMMs on the int8 wgmma core. ``fused_mlp_block_i8_route`` forces
  either route, for the card's checks and timings only;
  ``fused_mlp_block_i8_mma`` runs the
  chain K11 ran before (the same four launches on gemm_i8.cuh's
  ``mma.sync`` GEMMs) for the card's checks only: no op calls it, and
  both give the same bits.

Which attention half an int8 block runs decides its result, so the port
takes the JAX package's route (``w8a8_attention``): K10 where it holds,
else ``fused_attention_block_dequant``, K9 on the dequantized weights
(W8A16), as ``mfvit_tpu/nn/vit.py:351-382`` does on the chip.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mfvit_tpu_torch.nn.layers import layer_norm
from mfvit_tpu_torch.ops import launch
from mfvit_tpu_torch.ops.fused_attn import (_check, attn_core_plain,
                                            fused_attention_block_large)

LAUNCHES = {"fused_attention_block_i8": 0, "fused_mlp_block_i8": 0}

# csrc/gemm_i8_sm90.cuh's tail constants: rows a tile, hidden columns a
# chunk, bytes of a ring stage (128 weight rows of a 128-byte K slice) and
# of a 64-row swizzled K slice; the ring's depth where pass B needs fewer
# (I8Tail<D>::STAGES); the rows from which K11 takes the tail; the widths
# the tail takes (fc2's accumulators, D / 4 a thread, live in registers);
# and the shared memory a block can take on an H100
I8T_ROWS, I8T_HC, I8T_STAGE, TILE64 = 64, 128, 16384, 8192
I8T_STAGES_PREF = 6
I8T_TAIL_ROWS = 16896
I8T_WIDTHS = (128, 256, 384)
SMEM_MAX = 232448

# csrc/gemm_i8_sm90.cuh's quantizing GEMM (K10's qkv and proj): its ring's
# deepest, the depth up to which a tile holds 128 rows (else 64), the
# token rows x width from which K10 takes it (csrc/fused_int8.cu's
# I8Q_FUSED_WORK), and the SMs of an H100, over which the column tiles are
# split into groups
QA_STAGES_MAX, QA_HM2_MAX_K = 8, 512
I8Q_FUSED_WORK = 1 << 23
SMS = 132


class Plan(NamedTuple):
    """A launch of K11: ``route`` "tail" (one launch, ``stages`` weight
    stages in its ring, ``smem`` bytes of shared memory a block) or "gemm"
    (four launches on the int8 wgmma core: no ring of its own, so 0 and
    0)."""
    route: str
    stages: int
    smem: int


def _smem(D: int, stages: int) -> int:
    """gemm_i8_sm90.cuh's I8Tail<D>::SMEM: the ring, two A tiles of int8
    codes of LN(x) (each D / 128 K slices of 64 rows), one hidden chunk's
    codes (one slice), the A tiles' row scales and two warpgroups' h1 row
    absmax (4 x 64 fp32), the barriers (two a stage, two an A tile), and
    1024 bytes to align the swizzled tiles."""
    return (stages * I8T_STAGE + 2 * (D // 128) * TILE64 + TILE64
            + 4 * I8T_ROWS * 4 + (2 * stages + 4) * 8 + 1024)


def _stages_min(D: int) -> int:
    """I8Tail<D>::STAGES_MIN: pass B holds a chunk's fc1 stages (D / 128)
    and the last chunk's fc2 stages (D / 128) at once."""
    return 2 * (D // 128)


def _plan(D: int, Hd: int, M: int) -> Plan:
    """K11's plan at width D, hidden Hd (both % 128 == 0) and M token rows,
    the route csrc/fused_int8.cu takes: at a tail width from I8T_TAIL_ROWS
    rows on, the tail with I8Tail<D>::STAGES ring stages (I8T_STAGES_PREF,
    or the ``_stages_min`` pass B needs if that is more); else the four
    launches."""
    if D <= 0 or Hd <= 0 or D % 128 or Hd % I8T_HC:
        raise ValueError(f"the K11 kernels take D % 128 == 0 and hidden % "
                         f"{I8T_HC} == 0; got D={D}, hidden={Hd}")
    stages = max(I8T_STAGES_PREF, _stages_min(D))
    if D in I8T_WIDTHS and M >= I8T_TAIL_ROWS:
        return Plan("tail", stages, _smem(D, stages))
    return Plan("gemm", 0, 0)


class QaPlan(NamedTuple):
    """A launch of the quantizing int8 GEMM: ``rows`` a tile (128 or 64),
    ``stages`` ring stages of W, the 128-column output tiles cut into
    ``groups`` of ``per`` (a block quantizes its rows once a group),
    ``smem`` bytes of shared memory a block."""
    rows: int
    stages: int
    groups: int
    per: int
    smem: int


def _qa_plan(M: int, N: int, K: int, sms: int = SMS,
             ln: bool = True) -> QaPlan:
    """gemm_i8_sm90.cuh's ``qa_plan`` for M rows (bf16 x with its
    LayerNorm, ``ln``, for qkv; the fp32 attention output without, for
    proj), N outputs (% 128) and depth K (% 128) on ``sms`` SMs: 128-row
    tiles up to K = QA_HM2_MAX_K, else 64; two A tiles of int8 codes (rows
    x K), LN's two fp32 vectors, W's fp32 scales and the bias (N each), the
    A tiles' fp32 row scales, the four A-tile barriers and two row
    counters, 1024 bytes to align, then as many 16 KB W stages (two
    barriers each) as fit, at most QA_STAGES_MAX (fewer than 2: the shape
    does not fit); the N tiles cut into groups of nt // g, g the SMs over
    the row tiles (at most nt), so that the items (a row tile and a group)
    fill a wave of the SMs where M allows."""
    rows = 128 if K <= QA_HM2_MAX_K else 64
    fixed = (2 * rows * K + (8 * K if ln else 0) + 8 * N + 2 * rows * 4
             + 5 * 8 + 1024)
    stages = min(QA_STAGES_MAX, (SMEM_MAX - fixed) // (I8T_STAGE + 16))
    mt, nt = -(-M // rows), N // 128
    g = min(max(-(-sms // mt), 1), nt)
    per = nt // g
    return QaPlan(rows, stages, -(-nt // per), per,
                  fixed + stages * (I8T_STAGE + 16))


def _qa_plans(M: int, D: int, sms: int = SMS) -> tuple:
    """K10's two quantizing GEMMs at M rows and width D: (qkv's plan, on
    bf16 x with LN; proj's, on the fp32 attention output)."""
    return _qa_plan(M, 3 * D, D, sms, True), _qa_plan(M, D, D, sms, False)


def _k10_fused(M: int, D: int) -> bool:
    """Whether K10 at M token rows and width D takes its three launches
    (the quantizing GEMMs), as csrc/fused_int8.cu chooses: where M x D >=
    I8Q_FUSED_WORK and both GEMMs' A tiles fit."""
    return M * D >= I8Q_FUSED_WORK and all(p.stages >= 2
                                       for p in _qa_plans(1, D, 1))


def w8a8_attention(N: int, D: int, heads: int) -> bool:
    """Whether an int8 block's attention half is W8A8 (K10) or W8A16 (K9 on
    ``dequant_w`` weights) at sequence length N, width D: the route the JAX
    package takes on the chip, so that both give the same result. It is
    the formula of JAX's ``attn_supported`` (``_i8_cb(1, N, D, heads)``,
    ``mfvit_tpu/ops/fused_int8.py:34-65``) with its 21 MiB budget, a
    calibration of TPU memory, not a limit of the port's kernels, which
    take either route at any N."""
    Np = -(-N // 128) * 128
    est = 4 * D * D + heads * N * Np * 4 + 3 * D * Np * 8 + 8 * N * D
    return est < 21 * 1024 * 1024


def _amax_scale(amax: torch.Tensor) -> torch.Tensor:
    """amax / 127 as an IEEE division on every device. On CUDA, dividing
    by a Python scalar multiplies by its reciprocal instead, which can be
    an ulp off the TPU kernels' (and csrc/gemm_i8.cuh's) scale."""
    return amax / torch.full_like(amax, 127.0)


def quantize_weight_cols(w: torch.Tensor):
    """fp32 (out, in) -> (int8 (out, in), fp32 (out,)): one symmetric scale
    per output channel, amax / 127 (1 where the channel is all zero), codes
    rounded half to even and clamped to +-127 (``quantize_weight_cols``
    :81 on the (in, out) layout)."""
    w = w.float()
    s = _amax_scale(w.abs().amax(dim=1))
    s = torch.where(s == 0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(w / s[:, None]), -127, 127).to(torch.int8)
    return q, s


def dequant_w(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """int8 (out, in) + per-output scales -> fp32 weight (``dequant_w``
    :76)."""
    return q.float() * s[:, None]


def quant_rows(h: torch.Tensor):
    """fp32 (M, K) -> (int8 (M, K), fp32 (M, 1)), one absmax scale per row
    (``_quant_rows`` :90)."""
    s = _amax_scale(h.abs().amax(dim=-1, keepdim=True))
    s = torch.where(s == 0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(h / s), -127, 127).to(torch.int8)
    return q, s


def _i8_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) . int8 (N, K)^T as the int32 sums converted to fp32.
    The float64 product is exact for these sums (|sum| < 2^53)."""
    return (a.double() @ w.double().t()).float()


def _gelu(h: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU in the TPU kernel's order of operations."""
    return h * 0.5 * (1.0 + torch.erf(h * 0.7071067811865476))


def fused_mlp_block_i8_plain(x, ln_s, ln_b, w1q, w1s, b1, w2q, w2s, b2):
    """x (B, N, D) -> x + MLP(LN(x)) in x's dtype, the rounding points of
    ``_mlp_kernel_i8`` (:100-116): fp32 LN, row-quantized h, h1 =
    acc * hs * w1s + b1 and the GELU in fp32, row-quantized h1 over all of
    its columns, y = acc2 * h1s * w2s + b2, then x + y in x's dtype."""
    B, N, D = x.shape
    h = layer_norm(x.float(), ln_s, ln_b, 1e-6).reshape(B * N, D)
    hq, hs = quant_rows(h)
    h1 = _gelu(_i8_mm(hq, w1q) * hs * w1s.float() + b1.float())
    h1q, h1s = quant_rows(h1)
    y = _i8_mm(h1q, w2q) * h1s * w2s.float() + b2.float()
    return x + y.reshape(B, N, D).to(x.dtype)


def fused_attention_block_i8_plain(x, ln_s, ln_b, wqkvq, wqkvs, bqkv, wprojq,
                                   wprojs, bproj, heads: int, scale: float):
    """x (B, N, D) -> x + proj(MHSA(LN(x))) in x's dtype, the rounding
    points of ``_attn_kernel_i8`` (:168-209): fp32 LN, row-quantized h,
    qkv = acc * wqkvs * hs + bqkv (the weight scale first) in x's dtype,
    the attention core with an fp32 output, row-quantized o over all D,
    y = acc2 * os * wprojs + bproj (the token scale first), x + y."""
    B, N, D = x.shape
    dt = x.dtype
    h = layer_norm(x.float(), ln_s, ln_b, 1e-6).reshape(B * N, D)
    hq, hs = quant_rows(h)
    qkv = (_i8_mm(hq, wqkvq) * wqkvs.float() * hs + bqkv.float()).to(dt)
    o = attn_core_plain(qkv.reshape(B, N, 3 * D), heads, scale,
                        out_dtype=torch.float32)
    oq, os_ = quant_rows(o.reshape(B * N, D))
    y = _i8_mm(oq, wprojq) * os_ * wprojs.float() + bproj.float()
    return x + y.reshape(B, N, D).to(dt)


def _refuse_grad(x: torch.Tensor, what: str) -> None:
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(f"{what} is inference-only (no backward, as in "
                           "the JAX package): run it under torch.no_grad() "
                           "or on an x that does not require a gradient")


def _attn_chain(entry, fused, x, ln_s, ln_b, wqkvq, wqkvs, bqkv, wprojq,
                wprojs, bproj, heads, scale, *flag):
    """K10 through its C entry ``entry`` (``flag``: the route entry's), with
    the int8 rows and scales as scratch unless ``fused`` (the three
    launches need none), and the bf16 qkv and fp32 attention output."""
    B, N, D = x.shape
    _check(B, N, D, heads, "K10", None)
    launch.require(x, torch.bfloat16, "x")
    launch.require(wqkvq, torch.int8, "wqkvq", (3 * D, D))
    launch.require(wprojq, torch.int8, "wprojq", (D, D))
    M, dev = B * N, x.device
    scratch = ([None] * 2 if fused else [
        torch.empty(M, D, dtype=torch.int8, device=dev),
        torch.empty(M, dtype=torch.float32, device=dev)])
    out = torch.empty_like(x)
    launch.call(entry, dev, x,
                launch.vec(ln_s, D, "ln_s"), launch.vec(ln_b, D, "ln_b"),
                wqkvq, launch.vec(wqkvs, 3 * D, "wqkvs"),
                launch.vec(bqkv, 3 * D, "bqkv"), wprojq,
                launch.vec(wprojs, D, "wprojs"), launch.vec(bproj, D, "bproj"),
                *scratch,
                torch.empty(M, 3 * D, dtype=torch.bfloat16, device=dev),
                torch.empty(M, D, dtype=torch.float32, device=dev),
                out, B, N, D, heads, scale, *flag)
    return out


def _attn_cuda(x, ln_s, ln_b, wqkvq, wqkvs, bqkv, wprojq, wprojs, bproj,
               heads, scale):
    B, N, D = x.shape
    out = _attn_chain("mfv_fused_attention_block_i8", _k10_fused(B * N, D),
                      x, ln_s, ln_b, wqkvq, wqkvs, bqkv, wprojq, wprojs,
                      bproj, heads, scale)
    LAUNCHES["fused_attention_block_i8"] += 1
    return out


def fused_attention_block_i8_route(x, ln_s, ln_b, wqkvq, wqkvs, bqkv, wprojq,
                                   wprojs, bproj, heads: int, scale: float,
                                   fused: bool):
    """K10 on the route ``fused`` names (the three launches on the
    quantizing GEMMs, or the five with quant_rows before the plain int8
    wgmma core) at any M, on CUDA tensors (csrc/fused_int8.cu's
    ``mfv_fused_attention_block_i8_route``): for the card's checks of both
    routes and the timing that sets I8Q_FUSED_WORK. No op calls it, and it
    counts no launch."""
    D = x.shape[-1]
    if fused and min(p.stages for p in _qa_plans(1, D, 1)) < 2:
        raise ValueError(f"K10's quantizing GEMM does not fit D={D}")
    return _attn_chain("mfv_fused_attention_block_i8_route", fused, x, ln_s,
                       ln_b, wqkvq, wqkvs, bqkv, wprojq, wprojs, bproj, heads,
                       scale, int(fused))


def fused_attention_block_i8_mma(x, ln_s, ln_b, wqkvq, wqkvs, bqkv, wprojq,
                                 wprojs, bproj, heads: int, scale: float):
    """The chain K10 ran before its redesign (csrc/fused_int8.cu's
    ``mfv_fused_attention_block_i8_mma``: LN + quantize, gemm_i8.cuh's
    ``mma.sync`` qkv GEMM, attn_core.cuh's or attn_long.cuh's core with an
    fp32 output, quantize o, the proj GEMM + residual), on CUDA tensors:
    the comparator the card's checks hold K10 against bit for bit. No op
    calls it, and it counts no launch."""
    return _attn_chain("mfv_fused_attention_block_i8_mma", False, x, ln_s,
                       ln_b, wqkvq, wqkvs, bqkv, wprojq, wprojs, bproj, heads,
                       scale)


def _mlp_chain(entry, tail, x, ln_s, ln_b, w1q, w1s, b1, w2q, w2s, b2,
               *flag):
    """K11 through its C entry ``entry`` (``flag``: the route entry's),
    with the four launches' scratch unless ``tail(M, D, Hd)`` says the
    entry takes the tail, which needs none."""
    B, N, D = x.shape
    Hd = w1q.shape[0]
    launch.require(x, torch.bfloat16, "x")
    launch.require(w1q, torch.int8, "w1q", (Hd, D))
    launch.require(w2q, torch.int8, "w2q", (D, Hd))
    M, dev = B * N, x.device
    scratch = ([None] * 4 if tail(M, D, Hd) else [
        torch.empty(M, D, dtype=torch.int8, device=dev),
        torch.empty(M, Hd, dtype=torch.float32, device=dev),
        torch.empty(M, Hd, dtype=torch.int8, device=dev),
        torch.empty(M, dtype=torch.float32, device=dev)])
    out = torch.empty_like(x)
    launch.call(entry, dev, x,
                launch.vec(ln_s, D, "ln_s"), launch.vec(ln_b, D, "ln_b"),
                w1q, launch.vec(w1s, Hd, "w1s"), launch.vec(b1, Hd, "b1"),
                w2q, launch.vec(w2s, D, "w2s"), launch.vec(b2, D, "b2"),
                *scratch, out, M, D, Hd, *flag)
    return out


def _mlp_cuda(x, ln_s, ln_b, w1q, w1s, b1, w2q, w2s, b2):
    out = _mlp_chain("mfv_fused_mlp_block_i8",
                     lambda M, D, Hd: _plan(D, Hd, M).route == "tail",
                     x, ln_s, ln_b, w1q, w1s, b1, w2q, w2s, b2)
    LAUNCHES["fused_mlp_block_i8"] += 1
    return out


def fused_mlp_block_i8_route(x, ln_s, ln_b, w1q, w1s, b1, w2q, w2s, b2,
                             tail: bool):
    """K11 on the route ``tail`` names (the tail, D of 128-384, or the four
    launches on the int8 wgmma core) at any M, on CUDA tensors
    (csrc/fused_int8.cu's ``mfv_fused_mlp_block_i8_route``): for the card's
    checks of both routes and the timing that sets I8T_TAIL_ROWS. No op
    calls it, and it counts no launch."""
    D, Hd = x.shape[-1], w1q.shape[0]
    _plan(D, Hd, 0)
    if tail and D not in I8T_WIDTHS:
        raise ValueError(f"K11's tail takes D in {I8T_WIDTHS}; got D={D}")
    return _mlp_chain("mfv_fused_mlp_block_i8_route", lambda *_: tail, x,
                      ln_s, ln_b, w1q, w1s, b1, w2q, w2s, b2, int(tail))


def fused_mlp_block_i8_mma(x, ln_s, ln_b, w1q, w1s, b1, w2q, w2s, b2):
    """The chain K11 ran before its redesign (csrc/fused_int8.cu's
    ``mfv_fused_mlp_block_i8_mma``: LN + quantize, gemm_i8.cuh's
    ``mma.sync`` fc1 + GELU into fp32 h1, quantize h1, fc2 + residual), on
    CUDA tensors: the comparator the card's checks hold K11 against bit
    for bit. No op calls it, and it counts no launch."""
    _plan(x.shape[-1], w1q.shape[0], 0)
    return _mlp_chain("mfv_fused_mlp_block_i8_mma", lambda *_: False, x,
                      ln_s, ln_b, w1q, w1s, b1, w2q, w2s, b2)


def fused_attention_block_i8(x, ln_s, ln_b, wqkvq, wqkvs, bqkv, wprojq,
                             wprojs, bproj, heads: int, scale: float,
                             plain: bool = False):
    """K10. CPU tensors (and ``plain=True``) take the plain version; CUDA
    tensors the kernels (bf16 x, head_dim 32/64/128, D % 128 == 0, any N)
    or a ValueError."""
    _refuse_grad(x, "fused_attention_block_i8")
    args = (x, ln_s, ln_b, wqkvq, wqkvs, bqkv, wprojq, wprojs, bproj, heads,
            scale)
    if plain or not x.is_cuda:
        return fused_attention_block_i8_plain(*args)
    return _attn_cuda(*args)


def fused_attention_block_dequant(x, ln_s, ln_b, wqkvq, wqkvs, bqkv, wprojq,
                                  wprojs, bproj, heads: int, scale: float,
                                  plain: bool = False):
    """The attention half of an int8 block where ``w8a8_attention`` is
    False: K9 on the dequantized weights and the fp32 biases (W8A16), as
    ``mfvit_tpu/nn/vit.py:358-371`` runs it; JAX's XLA fallback after it
    (:372-382) is the same math. Takes K10's arguments."""
    return fused_attention_block_large(
        x, ln_s, ln_b, dequant_w(wqkvq, wqkvs), bqkv,
        dequant_w(wprojq, wprojs), bproj, heads, scale, plain=plain)


def fused_mlp_block_i8(x, ln_s, ln_b, w1q, w1s, b1, w2q, w2s, b2,
                       plain: bool = False):
    """K11. CPU tensors (and ``plain=True``) take the plain version; CUDA
    tensors the kernels (bf16 x, D and hidden % 128 == 0) or a
    ValueError."""
    _refuse_grad(x, "fused_mlp_block_i8")
    args = (x, ln_s, ln_b, w1q, w1s, b1, w2q, w2s, b2)
    if plain or not x.is_cuda:
        return fused_mlp_block_i8_plain(*args)
    return _mlp_cuda(*args)
