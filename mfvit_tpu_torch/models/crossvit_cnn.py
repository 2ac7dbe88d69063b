"""The single-image ViT + CNN cross-attention head, the port of
``mfvit_tpu/models/crossvit_cnn.py`` (reference ``model/crossvit.py``):
the ViT CLS (small stream) projected into the CNN width (``f_sl``), one
PreNorm 1-query cross-attention over the CNN feature-map tokens with an
inner width of heads x dim_head (bias-free ``to_qkv``, ``to_out`` with a
bias), projected back (``g_ls``), then LayerNorm + Linear.

Module names are the JAX tree's (``encoders.{e}.layers.{l}.f_sl``,
``g_ls``, ``norm``, ``to_qkv``, ``to_out``; ``head_norm``, ``head``). The
JAX package computes the head in XLA; here it is plain PyTorch on both
devices, its attention ``ops.attention.cross_attention_1q``. Python API
only, as in JAX.
"""
from __future__ import annotations

import torch
from torch import nn

from mfvit_tpu_torch.nn.layers import layernorm, linear, trunc_normal_
from mfvit_tpu_torch.nn.resnet import ResNet
from mfvit_tpu_torch.nn.vit import ViT
from mfvit_tpu_torch.ops.attention import cross_attention_1q


class Layer(nn.Module):
    def __init__(self, small_dim: int, large_dim: int, inner: int):
        super().__init__()
        self.f_sl = nn.Linear(small_dim, large_dim)
        self.g_ls = nn.Linear(large_dim, small_dim)
        self.norm = nn.LayerNorm(large_dim, eps=1e-5)  # the PreNorm LN
        self.to_qkv = nn.Linear(large_dim, inner * 3, bias=False)
        self.to_out = nn.Linear(inner, large_dim)


class Encoder(nn.Module):
    def __init__(self, depth: int, *dims):
        super().__init__()
        self.layers = nn.ModuleList(Layer(*dims) for _ in range(depth))


class CrossViTCNN(nn.Module):
    """Built on the CPU from ``generator`` (seed 0 when omitted), then
    moved to ``device``."""

    def __init__(self, *, small_dim: int = 384, large_dim: int = 512,
                 heads: int = 3, dim_head: int = 64,
                 cross_attn_depth: int = 1, multi_scale_enc_depth: int = 1,
                 num_classes: int = 3, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.encoders = nn.ModuleList(
            Encoder(cross_attn_depth, small_dim, large_dim, heads * dim_head)
            for _ in range(multi_scale_enc_depth))
        self.head_norm = nn.LayerNorm(small_dim, eps=1e-5)
        self.head = nn.Linear(small_dim, num_classes)
        self.reset_parameters(generator or torch.Generator().manual_seed(0))
        if device is not None:
            self.to(device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """``init`` of the JAX package: trunc-normal 0.02 Linear weights,
        zero biases, unit LayerNorms."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                trunc_normal_(m.weight, 0.02, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()

    def forward(self, vit_tokens, cnn_featmap) -> torch.Tensor:
        return apply(self, vit_tokens, cnn_featmap)


def _ca_1q(layer: Layer, x: torch.Tensor, heads: int, dim_head: int):
    """PreNorm + 1-query cross-attention with the inner projection width;
    x (B, N, C) with the query at position 0 -> (B, 1, C)."""
    B, N, _ = x.shape
    inner = heads * dim_head
    qkv = linear(layer.to_qkv, layernorm(layer.norm, x, eps=1e-5))

    def heads_split(t):
        return t.reshape(B, t.shape[1], heads, dim_head).transpose(1, 2)

    o = cross_attention_1q(heads_split(qkv[:, 0:1, :inner]),
                           heads_split(qkv[:, :, inner:2 * inner]),
                           heads_split(qkv[:, :, 2 * inner:]),
                           scale=dim_head ** -0.5)
    return linear(layer.to_out, o.transpose(1, 2).reshape(B, 1, inner))


def apply(model: CrossViTCNN, vit_tokens: torch.Tensor,
          cnn_featmap: torch.Tensor) -> torch.Tensor:
    """vit_tokens (B, N, small), cnn_featmap (B, h, w, large) -> logits
    (B, num_classes) fp32.

    The reference quirk is kept: layers do not chain. Every layer re-reads
    the original ViT CLS and only the last one's output reaches the
    logits, so with ``cross_attn_depth > 1`` the others are dead compute
    (``tests/test_alt_fusion.py::test_depth2_only_last_layer_reaches_output``
    pins it in JAX)."""
    B, h, w, C = cnn_featmap.shape
    xl = cnn_featmap.reshape(B, h * w, C)
    cal_out = None
    for enc in model.encoders:
        for layer in enc.layers:
            cal_q = linear(layer.f_sl, vit_tokens[:, 0:1])  # (B, 1, large)
            cal = cal_q + _ca_1q(layer, torch.cat([cal_q, xl], 1),
                                 model.heads, model.dim_head)
            cal_out = linear(layer.g_ls, cal)               # (B, 1, small)
    x = layernorm(model.head_norm, cal_out[:, 0].float(), eps=1e-5)
    return linear(model.head, x)


def fused_forward(vit: ViT, cnn: ResNet, fus: CrossViTCNN,
                  img: torch.Tensor, *,
                  compute_dtype: torch.dtype = torch.bfloat16,
                  reference: bool = False) -> torch.Tensor:
    """Both backbones and the head on one NHWC image batch: the ViT's
    post-norm tokens (K1-K3 on CUDA; ``reference`` their plain versions)
    and the CNN's last feature map (B, H/32, W/32, C) -> logits."""
    tokens, _ = vit(img, compute_dtype=compute_dtype, return_features=True,
                    reference=reference)
    featmap = cnn(img, compute_dtype=compute_dtype, return_featmap=True)
    return apply(fus, tokens, featmap)
