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

On a CUDA tensor each op launches its kernels (csrc/fused_int8.cu over
csrc/gemm_i8.cuh, and csrc/attn_core.cuh or, past 256 tokens,
csrc/attn_long.cuh) on bf16 x or raises; on a CPU tensor (or with
``plain=True``) it runs the plain version below, which rounds where the TPU
kernels do and is the reference the kernels are held to on the card. The
ops have no backward, as in JAX: an x that requires a gradient under grad
mode raises.

Which attention half an int8 block runs decides its result, so the port
takes the JAX package's route (``w8a8_attention``): K10 where it holds,
else ``fused_attention_block_dequant``, K9 on the dequantized weights
(W8A16), as ``mfvit_tpu/nn/vit.py:351-382`` does on the chip.
"""
from __future__ import annotations

import torch

from mfvit_tpu_torch.nn.layers import layer_norm
from mfvit_tpu_torch.ops import launch
from mfvit_tpu_torch.ops.fused_attn import (_check, attn_core_plain,
                                            fused_attention_block_large)

LAUNCHES = {"fused_attention_block_i8": 0, "fused_mlp_block_i8": 0}


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


def _attn_cuda(x, ln_s, ln_b, wqkvq, wqkvs, bqkv, wprojq, wprojs, bproj,
               heads, scale):
    B, N, D = x.shape
    _check(B, N, D, heads, "K10", None)
    launch.require(x, torch.bfloat16, "x")
    launch.require(wqkvq, torch.int8, "wqkvq", (3 * D, D))
    launch.require(wprojq, torch.int8, "wprojq", (D, D))
    M, dev = B * N, x.device
    out = torch.empty_like(x)
    launch.call("mfv_fused_attention_block_i8", dev, x,
                launch.vec(ln_s, D, "ln_s"), launch.vec(ln_b, D, "ln_b"),
                wqkvq, launch.vec(wqkvs, 3 * D, "wqkvs"),
                launch.vec(bqkv, 3 * D, "bqkv"), wprojq,
                launch.vec(wprojs, D, "wprojs"), launch.vec(bproj, D, "bproj"),
                torch.empty(M, D, dtype=torch.int8, device=dev),
                torch.empty(M, dtype=torch.float32, device=dev),
                torch.empty(M, 3 * D, dtype=torch.bfloat16, device=dev),
                torch.empty(M, D, dtype=torch.float32, device=dev),
                out, B, N, D, heads, scale)
    LAUNCHES["fused_attention_block_i8"] += 1
    return out


def _mlp_cuda(x, ln_s, ln_b, w1q, w1s, b1, w2q, w2s, b2):
    B, N, D = x.shape
    Hd = w1q.shape[0]
    if D % 128 or Hd % 128:
        raise ValueError(f"the K11 kernels take D % 128 == 0 and hidden % "
                         f"128 == 0; got D={D}, hidden={Hd}")
    launch.require(x, torch.bfloat16, "x")
    launch.require(w1q, torch.int8, "w1q", (Hd, D))
    launch.require(w2q, torch.int8, "w2q", (D, Hd))
    M, dev = B * N, x.device
    out = torch.empty_like(x)
    launch.call("mfv_fused_mlp_block_i8", dev, x,
                launch.vec(ln_s, D, "ln_s"), launch.vec(ln_b, D, "ln_b"),
                w1q, launch.vec(w1s, Hd, "w1s"), launch.vec(b1, Hd, "b1"),
                w2q, launch.vec(w2s, D, "w2s"), launch.vec(b2, D, "b2"),
                torch.empty(M, D, dtype=torch.int8, device=dev),
                torch.empty(M, Hd, dtype=torch.float32, device=dev),
                torch.empty(M, Hd, dtype=torch.int8, device=dev),
                torch.empty(M, dtype=torch.float32, device=dev),
                out, M, D, Hd)
    LAUNCHES["fused_mlp_block_i8"] += 1
    return out


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
