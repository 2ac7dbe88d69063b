"""``--attn-backend xla``: the JAX package's XLA route in eager PyTorch.

JAX takes ``attn_backend`` in every entry point (``None | auto | pallas |
xla``, ``mfvit_tpu/cli/common.py:62``). ``pallas`` runs its Pallas kernels;
``auto`` (and ``None``) resolves to ``pallas`` on a TPU and ``xla``
elsewhere (``mfvit_tpu/ops/attention.py::_resolve`` :47-55). The port's
platform is the card, so its ``auto`` (and ``None`` and ``pallas``) takes
the port's own kernels, with their plain versions for CPU tensors: what
the port runs without the flag.

``xla`` runs, on the device the run uses and under autograd, the math
JAX's ViT and fusion head run when no Pallas kernel does:

- each block unfused (``mfvit_tpu/nn/vit.py:404-411`` and the non-Pallas
  MLP branch): LayerNorm, the qkv linear, multi-head attention on the
  packed qkv with fp32 scores and softmax (``mhsa_from_packed``'s XLA
  route, :410-418, the math of ``mhsa_reference`` :64-72), the proj linear
  and the residual; LayerNorm, fc1, the exact GELU, fc2 and the residual;
  the model's final LayerNorm after the blocks;
- for an int8 serving tree (``--int8``), the same on the weights
  dequantized (``vit.py:372-392``); for a ``quantize_vit_params`` tree,
  the W8A8 linears of ``ops/quant.py`` around this attention;
- the CA fusion head's full-sequence ``encode``
  (``mfvit_tpu/models/fusion.py:143-150``), which ``models.fusion.Fusion``
  runs for depths other than 1 too.

Linears round as JAX's ``layers.linear`` (:48-50): the product in the
activations' dtype, then the bias cast to it added. This is a route of its
own, JAX's XLA counterpart: no kernel wrapper falls back to it, and
nothing takes it unless the flag says ``xla``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from mfvit_tpu_torch.nn.layers import bmm_f32, layer_norm
from mfvit_tpu_torch.ops import quant
from mfvit_tpu_torch.ops.fused_int8 import dequant_w

ATTN_BACKENDS = (None, "auto", "pallas", "xla")


def takes_xla(attn_backend) -> bool:
    """Whether ``attn_backend`` asks for the XLA route; an unknown name
    raises, as JAX's ``set_default_backend`` does."""
    if attn_backend not in ATTN_BACKENDS:
        raise ValueError(f"unknown attention backend {attn_backend!r} (one "
                         f"of {ATTN_BACKENDS})")
    return attn_backend == "xla"


def describe(attn_backend) -> str:
    """The line a CLI prints first: which route its blocks run."""
    if takes_xla(attn_backend):
        return ("=> attention route: xla (JAX's XLA route in eager torch: "
                "unfused blocks, fp32 softmax; no kernel of the port)")
    return (f"=> attention route: the port's kernels (--attn-backend "
            f"{attn_backend or 'auto'}; their plain versions on the CPU)")


def _linear(x, w, b):
    y = F.linear(x, w.to(x.dtype))
    return y if b is None else y + b.to(x.dtype)


def mhsa(qkv: torch.Tensor, heads: int, scale: float) -> torch.Tensor:
    """Packed qkv (B, N, 3D) -> (B, N, D): the scores as fp32 sums of the
    products (``preferred_element_type=f32``: cuBLAS's fp32-output GEMM on
    the card, ``nn.layers.bmm_f32``) times ``scale``, the softmax in fp32
    cast to v's dtype, then P·V in that dtype."""
    B, N, three_d = qkv.shape
    dh = three_d // (3 * heads)
    q, k, v = (t.reshape(B, N, heads, dh).transpose(1, 2)
               .reshape(B * heads, N, dh) for t in qkv.chunk(3, -1))
    s = bmm_f32(q, k.transpose(-1, -2)) * scale
    p = torch.softmax(s, -1).to(v.dtype)
    return (p @ v).reshape(B, heads, N, dh).transpose(1, 2).reshape(
        B, N, heads * dh)


def attention_block(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, heads: int,
                    scale: float) -> torch.Tensor:
    """x + proj(MHSA(qkv(LN1(x)))) in x's dtype; torch (out, in)
    weights."""
    qkv = _linear(layer_norm(x, ln_s, ln_b, 1e-6), wqkv, bqkv)
    return x + _linear(mhsa(qkv, heads, scale), wproj, bproj)


def mlp_block(x, ln_s, ln_b, w1, b1, w2, b2) -> torch.Tensor:
    """x + fc2(GELU(fc1(LN2(x)))) in x's dtype, JAX's exact GELU."""
    h = _linear(layer_norm(x, ln_s, ln_b, 1e-6), w1, b1)
    return x + _linear(quant.gelu_exact(h), w2, b2)


def attention_block_dequant(x, ln_s, ln_b, wqkv_q, wqkv_s, bqkv, wproj_q,
                            wproj_s, bproj, heads: int, scale: float):
    """``attention_block`` on int8 weights dequantized to fp32."""
    return attention_block(x, ln_s, ln_b, dequant_w(wqkv_q, wqkv_s), bqkv,
                           dequant_w(wproj_q, wproj_s), bproj, heads, scale)


def mlp_block_dequant(x, ln_s, ln_b, w1_q, w1_s, b1, w2_q, w2_s, b2):
    """``mlp_block`` on int8 weights dequantized to fp32."""
    return mlp_block(x, ln_s, ln_b, dequant_w(w1_q, w1_s), b1,
                     dequant_w(w2_q, w2_s), b2)


def quant_attention_block(x, ln_s, ln_b, wqkv_q, wqkv_s, bqkv, wproj_q,
                          wproj_s, bproj, heads: int, scale: float):
    """A ``quantize_vit_params`` block's attention half: the W8A8 linears
    of ``ops/quant.py`` around ``mhsa``."""
    qkv = quant.quantized_linear(wqkv_q, wqkv_s,
                                 layer_norm(x, ln_s, ln_b, 1e-6), bqkv)
    return x + quant.quantized_linear(wproj_q, wproj_s,
                                      mhsa(qkv, heads, scale), bproj)
