"""K2 and K3: the MLP half of a ViT block.

- K2 ``fused_mlp_block``: x + fc2(GELU(fc1(LN(x)))); replaces
  ``mfvit_tpu/ops/fused_mlp.py::fused_mlp_block`` (Pallas ``_mlp_kernel``
  :62).
- K3 ``fused_mlp_block_final_ln``: LN_final(x + MLP(LN(x))) with the sum
  kept in fp32 into the epilogue LayerNorm; replaces
  ``fused_mlp_block_final_ln`` (Pallas ``_mlp_kernel_final`` :137). The
  port folds the final LayerNorm into the last block at every width.

On a CUDA tensor each runs the LayerNorm row statistics and two
``gemm_ln`` kernels (csrc/fused_mlp.cu over csrc/gemm_ln.cuh): LN prologue
+ fc1 + bias + exact-erf GELU (bf16 hidden), then fc2 + bias with the bf16
residual add (K2), or with the fp32 residual written out in fp32 and a
row LayerNorm kernel after it (K3). Unlike the TPU kernel, the (M, 4D)
hidden activation (and K3's fp32 sum) make one round trip through device
memory. On a CPU tensor they run the
plain versions below, the reference the kernels are held to on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from mfvit_tpu_torch.nn.layers import layer_norm, linear_f32
from mfvit_tpu_torch.ops import launch

LAUNCHES = {"fused_mlp_block": 0, "fused_mlp_block_final_ln": 0}


def _hidden(x, ln_s, ln_b, w1, b1):
    h = layer_norm(x, ln_s, ln_b, 1e-6)
    return F.gelu(linear_f32(h, w1, b1)).to(x.dtype)


def fused_mlp_block_plain(x, ln_s, ln_b, w1, b1, w2, b2) -> torch.Tensor:
    """x (B, N, D) -> x + MLP(LN(x)) in x's dtype; w1 (4D, D), w2 (D, 4D)."""
    dt = x.dtype
    h = _hidden(x, ln_s, ln_b, w1, b1)
    return x + F.linear(h, w2.to(dt), b2.to(dt))


def fused_mlp_block_final_ln_plain(x, ln_s, ln_b, w1, b1, w2, b2, final_s,
                                   final_b) -> torch.Tensor:
    h = _hidden(x, ln_s, ln_b, w1, b1)
    o = x.float() + linear_f32(h, w2, b2)
    return layer_norm(o, final_s, final_b, 1e-6).to(x.dtype)


def _mlp_cuda(x, ln_s, ln_b, w1, b1, w2, b2, final=None):
    B, N, D = x.shape
    Hd = w1.shape[0]
    if D % 128 or Hd % 128:
        raise ValueError(f"the K2/K3 kernels take D % 128 == 0 and "
                         f"hidden % 128 == 0; got D={D}, hidden={Hd}")
    bf16 = torch.bfloat16
    launch.require(x, bf16, "x")
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


def fused_mlp_block(x, ln_s, ln_b, w1, b1, w2, b2) -> torch.Tensor:
    """K2. CPU tensors take the plain version; CUDA tensors the kernels."""
    if not x.is_cuda:
        return fused_mlp_block_plain(x, ln_s, ln_b, w1, b1, w2, b2)
    out = _mlp_cuda(x, ln_s, ln_b, w1, b1, w2, b2)
    LAUNCHES["fused_mlp_block"] += 1
    return out


def fused_mlp_block_final_ln(x, ln_s, ln_b, w1, b1, w2, b2, final_s,
                             final_b) -> torch.Tensor:
    """K3. CPU tensors take the plain version; CUDA tensors the kernels."""
    if not x.is_cuda:
        return fused_mlp_block_final_ln_plain(x, ln_s, ln_b, w1, b1, w2, b2,
                                              final_s, final_b)
    out = _mlp_cuda(x, ln_s, ln_b, w1, b1, w2, b2, final=(final_s, final_b))
    LAUNCHES["fused_mlp_block_final_ln"] += 1
    return out
