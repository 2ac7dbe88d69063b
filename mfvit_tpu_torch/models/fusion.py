"""MF-ViT CA: cross-attention fusion of two ViT token streams, the port of
``mfvit_tpu/models/fusion.py`` with the same replicated reference quirks:

- per cross-attention layer and direction: PreNorm(LayerNorm eps 1e-5) ->
  CrossAttention (bias-free wq/wk/wv, out proj with bias) where only the
  normed CLS row is the query; the residual adds the UN-normed CLS; then
  the [fused CLS, own patches] sequence passes a LayerNorm(eps 1e-6);
- with ``multi_scale_enc_depth > 1`` every encoder runs on the ORIGINAL
  token streams and only the last output is kept;
- outer residual ``tokens + encoder(tokens)``, CLS pool, bare Linear heads
  summed;
- init: trunc_normal(0.02) on every Linear weight, zero biases.

Module names follow the reference ``Fus_CrossViT`` state dict (the names
``mfvit_tpu/exp/checkpoint.py::fusion_params_to_torch`` emits). The
depth-1 head (one encoder of one layer, the reference default) runs K4
(``ops.fused_fusion``) at any batch size and head_dim; other depths run
the general ``encode``, as the JAX package routes them to XLA, and so
does every depth under ``attn_backend="xla"``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mfvit_tpu_torch.nn import xla_route
from mfvit_tpu_torch.nn.layers import layernorm, linear, trunc_normal_
from mfvit_tpu_torch.nn.vit import ViT
from mfvit_tpu_torch.ops import fused_fusion
from mfvit_tpu_torch.ops.attention import cross_attention_1q


class CrossAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.wq = nn.Linear(dim, dim, bias=False)
        self.wk = nn.Linear(dim, dim, bias=False)
        self.wv = nn.Linear(dim, dim, bias=False)
        self.proj = nn.Linear(dim, dim)


class PreNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.fn = CrossAttention(dim)


class Encoder(nn.Module):
    """``cross_attn_layers[l]`` = [PreNorm(CA) 's' (CXR CLS over Enh
    patches), LayerNorm n_l, PreNorm(CA) 'l' (Enh CLS over CXR patches),
    LayerNorm n_s] — the reference ModuleList order."""

    def __init__(self, dim: int, depth: int):
        super().__init__()
        self.cross_attn_layers = nn.ModuleList(
            nn.ModuleList([PreNorm(dim), nn.LayerNorm(dim, eps=1e-6),
                           PreNorm(dim), nn.LayerNorm(dim, eps=1e-6)])
            for _ in range(depth))


class Fusion(nn.Module):
    """Built on the CPU from ``generator`` (seed 0 when omitted), then moved
    to ``device``."""

    def __init__(self, num_classes: int = 3, dim: int = 384, heads: int = 3,
                 cross_attn_depth: int = 1, multi_scale_enc_depth: int = 1,
                 *, device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.heads = heads
        self.multi_scale_transformers = nn.ModuleList(
            Encoder(dim, cross_attn_depth)
            for _ in range(multi_scale_enc_depth))
        self.mlp_head_cxr = nn.Sequential(nn.Linear(dim, num_classes))
        self.mlp_head_enh = nn.Sequential(nn.Linear(dim, num_classes))
        self.reset_parameters(generator or torch.Generator().manual_seed(0))
        if device is not None:
            self.to(device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, nn.Linear):
                trunc_normal_(m.weight, 0.02, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()

    def forward(self, cxr_tokens, enh_tokens, *, reference: bool = False,
                attn_backend: str | None = None):
        """Tokens (B, N, D) -> summed dual-head logits (B, num_classes) fp32.
        ``reference`` runs K4's plain version; ``attn_backend="xla"`` the
        full-sequence ``encode`` at every depth, as JAX's XLA route
        (``nn.xla_route``)."""
        encs = self.multi_scale_transformers
        if (len(encs) == 1 and len(encs[0].cross_attn_layers) == 1
                and not xla_route.takes_xla(attn_backend)):
            flat = fused_fusion.flatten_layer(encs[0].cross_attn_layers[0],
                                              cxr_tokens.dtype)
            fn = (fused_fusion.fused_fusion_cls_plain if reference
                  else fused_fusion.fused_fusion_cls)
            cxr_cls, enh_cls = fn(cxr_tokens, enh_tokens, flat, self.heads)
        else:
            cxr_ca, enh_ca = encode(self, cxr_tokens, enh_tokens)
            cxr_cls = (cxr_tokens + cxr_ca)[:, 0].float()
            enh_cls = (enh_tokens + enh_ca)[:, 0].float()
        h_c, h_e = self.mlp_head_cxr[0], self.mlp_head_enh[0]
        return (F.linear(cxr_cls, h_c.weight, h_c.bias)
                + F.linear(enh_cls, h_e.weight, h_e.bias))


def _cross_attn_block(pre: PreNorm, x: torch.Tensor, heads: int):
    """PreNorm + 1-query CrossAttention; x (B, N, C) with the query CLS at
    position 0 -> (B, 1, C)."""
    B, N, C = x.shape
    d = C // heads
    ca = pre.fn
    xn = layernorm(pre.norm, x, eps=1e-5)
    q = linear(ca.wq, xn[:, :1]).reshape(B, 1, heads, d).transpose(1, 2)
    k = linear(ca.wk, xn).reshape(B, N, heads, d).transpose(1, 2)
    v = linear(ca.wv, xn).reshape(B, N, heads, d).transpose(1, 2)
    o = cross_attention_1q(q, k, v, scale=d ** -0.5)
    return linear(ca.proj, o.transpose(1, 2).reshape(B, 1, C))


def encode(fus: Fusion, cxr_tokens, enh_tokens):
    """The multi-scale cross-attention encoder stack -> (cxr_ca, enh_ca)
    full token sequences (B, N, C)."""
    cxr_ca = enh_ca = None
    for enc in fus.multi_scale_transformers:
        xs, xl = cxr_tokens, enh_tokens  # each encoder sees the originals
        for ca_s, ln_l, ca_l, ln_s in enc.cross_attn_layers:
            s_cls, s_patch = xs[:, :1], xs[:, 1:]
            l_cls, l_patch = xl[:, :1], xl[:, 1:]
            cal = l_cls + _cross_attn_block(
                ca_l, torch.cat([l_cls, s_patch], 1), fus.heads)
            xl_new = layernorm(ln_l, torch.cat([cal, l_patch], 1), eps=1e-6)
            cal = s_cls + _cross_attn_block(
                ca_s, torch.cat([s_cls, l_patch], 1), fus.heads)
            xs_new = layernorm(ln_s, torch.cat([cal, s_patch], 1), eps=1e-6)
            xs, xl = xs_new, xl_new
        cxr_ca, enh_ca = xs, xl
    return cxr_ca, enh_ca


def fused_forward(vit_cxr: ViT, vit_enh: ViT, fus: Fusion, img_cxr, img_enh,
                  *, compute_dtype: torch.dtype = torch.bfloat16,
                  reference: bool = False, remat: bool = False,
                  attn_backend: str | None = None):
    """The MF-ViT CA forward: one pass per ViT branch giving both tokens
    and branch logits, then the fusion head. Returns (fused, logits_cxr,
    logits_enh); the decision logits are their sum. ``remat`` recomputes
    the branches' blocks in the backward; ``attn_backend="xla"`` runs
    JAX's XLA route in the branches and the head."""
    kw = dict(compute_dtype=compute_dtype, return_features=True,
              reference=reference, remat=remat, attn_backend=attn_backend)
    cxr_tokens, logits_cxr = vit_cxr(img_cxr, **kw)
    enh_tokens, logits_enh = vit_enh(img_enh, **kw)
    fused = fus(cxr_tokens, enh_tokens, reference=reference,
                attn_backend=attn_backend)
    return fused, logits_cxr, logits_enh
