"""The XLA-level W8A8 path, the port of ``mfvit_tpu/ops/quant.py``: int8
weights with one fp32 scale per output channel, activations quantized per
row on the fly, int32 products (inference only).

- ``quantize_weight`` (:23) is ``fused_int8.quantize_weight_cols``, the same
  math on the torch (out, in) layout; ``quantize_vit_params`` (:57) is
  ``nn.vit.quantize_vit_params``, since it rewrites a module.
- ``quantized_linear`` (:31) is the linear of every quantized layer. In JAX
  its int8 product is an XLA ``dot_general`` outside any Pallas kernel, so
  it is a library product here too: ``torch._int_mm`` (cuBLASLt, int8 x
  int8 -> int32) on a CUDA tensor, the exact float64 product of
  ``fused_int8._i8_mm`` on the CPU. A shape ``_int_mm`` does not take
  raises.
- ``quant_attention_block`` and ``quant_mlp_block`` are the two halves of a
  block of a quantized tree as ``mfvit_tpu/nn/vit.py`` runs them
  (:405-410, :433): LayerNorm -> W8A8 qkv -> MHSA on the packed qkv
  (``attention.mhsa_from_packed``: K12 on the card) -> W8A8 proj + the
  residual; LayerNorm -> W8A8 fc1 -> exact GELU in x's dtype -> W8A8 fc2 +
  the residual.
"""
from __future__ import annotations

import torch

from mfvit_tpu_torch.nn.layers import layer_norm
from mfvit_tpu_torch.ops import attention
from mfvit_tpu_torch.ops.fused_int8 import _i8_mm, _refuse_grad, quant_rows


def _int_mm_cuda(xq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) . int8 (N, K)^T -> int32 (M, N) on the card."""
    M, K = xq.shape
    if M <= 16 or K % 8 or q.shape[0] % 8:
        raise ValueError(f"torch._int_mm takes M > 16 and K, N multiples of "
                         f"8; got M={M}, K={K}, N={q.shape[0]}")
    return torch._int_mm(xq, q.t())


def quantized_linear(q: torch.Tensor, s: torch.Tensor, x: torch.Tensor,
                     bias: torch.Tensor | None = None) -> torch.Tensor:
    """W8A8 linear: x (..., in) in any float dtype, q int8 (out, in), s fp32
    (out,) -> (..., out) in x's dtype. Per-row activation scales amax / 127
    of x in fp32 (``fused_int8.quant_rows``), the exact int32 product, then
    acc * xs * s and + bias in fp32, as JAX's (:37-47)."""
    _refuse_grad(x, "quantized_linear")
    lead = x.shape[:-1]
    xq, xs = quant_rows(x.float().reshape(-1, x.shape[-1]))
    acc = (_int_mm_cuda(xq, q).float() if x.is_cuda
           else _i8_mm(xq, q))
    y = acc * xs * s.float()
    if bias is not None:
        y = y + bias.float()
    return y.reshape(*lead, -1).to(x.dtype)


def gelu_exact(h: torch.Tensor) -> torch.Tensor:
    """JAX's exact GELU, 0.5 * x * erfc(-x * sqrt(1/2)), each step in h's
    dtype with the constant rounded to it (``jax.nn.gelu(approximate=
    False)``). Not ``F.gelu``, which rounds once: in bf16 its output sits a
    rounding away from JAX's, enough to flip fc2's activation codes and
    move the quantized MF-ViT CA forward past rel 2e-2 of JAX's at 288 px."""
    c = torch.tensor(0.5 ** 0.5, dtype=h.dtype).item()
    return 0.5 * h * torch.erfc(-h * c)


def quant_attention_block(x, ln_s, ln_b, wqkv_q, wqkv_s, bqkv, wproj_q,
                          wproj_s, bproj, heads: int, scale: float,
                          plain: bool = False) -> torch.Tensor:
    """x + proj(MHSA(LN(x))) with W8A8 qkv and proj, in x's dtype; the
    MHSA is K12 (its plain version with ``plain=True`` or on the CPU)."""
    h = layer_norm(x, ln_s, ln_b, 1e-6)
    qkv = quantized_linear(wqkv_q, wqkv_s, h, bqkv)
    o = attention.mhsa_from_packed(qkv, heads, scale, plain=plain)
    return x + quantized_linear(wproj_q, wproj_s, o, bproj)


def quant_mlp_block(x, ln_s, ln_b, w1_q, w1_s, b1, w2_q, w2_s,
                    b2) -> torch.Tensor:
    """x + fc2(GELU(fc1(LN(x)))) with W8A8 fc1 and fc2, in x's dtype (no
    kernel: eager, as JAX runs it)."""
    h = quantized_linear(w1_q, w1_s, layer_norm(x, ln_s, ln_b, 1e-6), b1)
    return x + quantized_linear(w2_q, w2_s, gelu_exact(h), b2)
