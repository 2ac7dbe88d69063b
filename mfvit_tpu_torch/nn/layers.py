"""NN primitives: linear, LayerNorm and BatchNorm with fp32 statistics, the
exact-erf GELU MLP, and the initialisers the modules' ``reset_parameters``
use.

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


def batch_norm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor, *,
               training: bool, momentum: float = 0.1) -> torch.Tensor:
    """BatchNorm over every axis but the channels (axis 1) with fp32
    statistics taken from x cast to fp32, the result cast back to x's
    dtype (``mfvit_tpu/nn/resnet.py::_bn`` :88). ``training`` normalises
    with the batch statistics (the biased variance) and moves the running
    ones by 0.1 (the unbiased variance), torch's rule and JAX's
    ``momentum=0.9`` (``momentum=0`` leaves them as they are);
    otherwise the running statistics normalise."""
    return F.batch_norm(x.float(), bn.running_mean, bn.running_var,
                        bn.weight, bn.bias, training, momentum,
                        bn.eps).to(x.dtype)


def layernorm(p: nn.LayerNorm, x: torch.Tensor, eps: float = 1e-6):
    """eps=1e-6 for the ViT blocks and the fusion model's outer norms; the
    fusion PreNorm asks for 1e-5."""
    return layer_norm(x, p.weight, p.bias, eps)


class _MmF32(torch.autograd.Function):
    """a @ b on CUDA with fp32 sums and an fp32 result (cuBLAS's
    fp32-output GEMM, which autograd does not differentiate); the backward
    multiplies in the operands' dtype, as ``a @ b``'s does."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return (g @ b.t() if ctx.needs_input_grad[0] else None,
                a.t() @ g if ctx.needs_input_grad[1] else None)


def linear_f32(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """x @ w^T (+ b) with fp32 sums and an fp32 result, for x and w in the
    working dtype: the products of its values, as ``preferred_element_type
    =f32`` gives in JAX and as the kernels keep their accumulators. On CUDA
    this is cuBLAS's fp32-output GEMM (differentiable); elsewhere the
    operands are upcast."""
    if x.is_cuda and x.dtype != torch.float32:
        y = _MmF32.apply(x.reshape(-1, x.shape[-1]),
                         w.to(x.dtype).t()).reshape(*x.shape[:-1], -1)
    else:
        y = x.float() @ w.to(x.dtype).float().t()
    return y if b is None else y + b.float()


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for 2-D operands in the working dtype, with fp32 sums and an
    fp32 result (the ``preferred_element_type=f32`` products of the TPU
    backward kernels)."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def layer_norm_stats(x: torch.Tensor, eps: float = 1e-6):
    """(xhat, 1/std) of x in fp32, the recompute every backward starts
    from."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    inv = torch.rsqrt((xf - mean).square().mean(-1, keepdim=True) + eps)
    return (xf - mean) * inv, inv


def layer_norm_bwd(dy: torch.Tensor, xhat: torch.Tensor, inv: torch.Tensor,
                   scale: torch.Tensor):
    """LayerNorm backward in fp32 over the last axis: (dx, dscale, dbias)
    for y = xhat * scale + bias, the parameter gradients summed over every
    leading axis (fused_attn.py:475-480 in the JAX package)."""
    lead = tuple(range(dy.dim() - 1))
    dxhat = dy * scale.float()
    dx = inv * (dxhat - dxhat.mean(-1, keepdim=True)
                - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return dx, (dy * xhat).sum(lead), dy.sum(lead)


def linear(p: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """x @ W^T + b in x's dtype (the weights are cast to it): the product
    is rounded to x's dtype, then the bias, cast to it, is added and the
    sum rounded again, as ``mfvit_tpu/nn/layers.py::linear`` (:48-50)."""
    y = F.linear(x, p.weight.to(x.dtype))
    return y if p.bias is None else y + p.bias.to(x.dtype)


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
