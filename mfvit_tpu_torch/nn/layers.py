"""NN primitives: linear, LayerNorm with fp32 statistics, the exact-erf GELU
MLP, and the initialisers the modules' ``reset_parameters`` use.

Parameters live in fp32 ``nn.Module``s; compute runs in the dtype of the
activations (bf16 on the GPU by default) with LayerNorm statistics and
softmax in fp32, as in ``mfvit_tpu/nn/layers.py``. The functions take the
module holding the parameters, as the JAX ones take a parameter dict.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator):
    """Normal truncated at +-2 std (timm ``trunc_normal_``, as
    ``mfvit_tpu/nn/init.py::trunc_normal``)."""
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics taken from x cast
    to fp32; the result is cast back to x's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return y.to(x.dtype)


def layernorm(p: nn.LayerNorm, x: torch.Tensor, eps: float = 1e-6):
    """eps=1e-6 for the ViT blocks and the fusion model's outer norms; the
    fusion PreNorm asks for 1e-5."""
    return layer_norm(x, p.weight, p.bias, eps)


def linear_f32(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """x @ w^T (+ b) with fp32 sums and an fp32 result, for x and w in the
    working dtype: the products of its values, as ``preferred_element_type
    =f32`` gives in JAX and as the kernels keep their accumulators. On CUDA
    this is cuBLAS's fp32-output GEMM; elsewhere the operands are upcast."""
    if x.is_cuda and x.dtype != torch.float32:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w.to(x.dtype).t(),
                     out_dtype=torch.float32).reshape(*x.shape[:-1], -1)
    else:
        y = x.float() @ w.to(x.dtype).float().t()
    return y if b is None else y + b.float()


def linear(p: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """x @ W^T + b in x's dtype (the weights are cast to it)."""
    b = None if p.bias is None else p.bias.to(x.dtype)
    return F.linear(x, p.weight.to(x.dtype), b)


class Mlp(nn.Module):
    """Linear -> exact-erf GELU -> Linear (timm ViT MLP)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for fc in (self.fc1, self.fc2):
            trunc_normal_(fc.weight, 0.02, generator)
            nn.init.zeros_(fc.bias)


def mlp(p: Mlp, x: torch.Tensor) -> torch.Tensor:
    return linear(p.fc2, F.gelu(linear(p.fc1, x)))
