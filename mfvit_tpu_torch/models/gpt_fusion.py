"""The TransFuser-style joint-sequence GPT fusion head, the port of
``mfvit_tpu/models/gpt_fusion.py`` (reference ``model/fuseattention.py``):
both streams' tokens concatenated into one sequence, a learned joint
position embedding (zeros at init), ``n_layer`` blocks of LN -> biased
q/k/v self-attention -> LN -> ReLU MLP, a final LayerNorm, the output
split back and added onto each stream, then the CLS rows (ViT) or the
ReLU'd global means of the anchor grids (ResNet) summed into one Linear
head.

Module names follow the reference ``GPT`` (``pos_emb``,
``blocks.{i}.ln1``/``ln2``, ``attn.query``/``key``/``value``/``proj``,
``mlp.0``/``mlp.2``, ``ln_f``) with ``head`` for the TransFuser Linear.
The JAX package computes the head in XLA, with no Pallas kernel, so here
it is plain PyTorch on both devices: ``torch.matmul`` products and
``torch.softmax``, with the score products summed in fp32 as
``preferred_element_type=float32`` gives them (``nn.layers.bmm_f32``: on
CUDA cuBLAS's fp32-output GEMM of the bf16 operands on the tensor cores).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from mfvit_tpu_torch.nn.layers import bmm_f32, layernorm, linear


@dataclasses.dataclass(frozen=True)
class GPTFusionConfig:
    """The GPT fields of the reference GlobalConfig (``config/config.py``
    'vit' preset; ``config_res18.py`` for 'res')."""
    arch: str = "vit"        # 'vit' | 'res'
    n_embd: int = 384        # 512 for res18
    n_head: int = 4
    block_exp: int = 3
    n_layer: int = 8
    vert_anchors: int = 14   # 7 for res18
    horz_anchors: int = 14
    seq_len: int = 1
    n_views: int = 1
    use_pos_embed: bool = True

    @property
    def joint_len(self) -> int:
        base = ((self.n_views + 1) * self.seq_len * self.vert_anchors
                * self.horz_anchors)
        # ViT streams carry their CLS tokens: +2
        return base + 2 if self.arch == "vit" else base


VIT_CONFIG = GPTFusionConfig()
RES18_CONFIG = GPTFusionConfig(arch="res", n_embd=512, vert_anchors=7,
                               horz_anchors=7)


class SelfAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d)
        self.value = nn.Linear(d, d)
        self.proj = nn.Linear(d, d)


class Block(nn.Module):
    def __init__(self, d: int, block_exp: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(d, eps=1e-5)
        self.ln2 = nn.LayerNorm(d, eps=1e-5)
        self.attn = SelfAttention(d)
        self.mlp = nn.Sequential(nn.Linear(d, block_exp * d), nn.ReLU(),
                                 nn.Linear(block_exp * d, d))


class GPTFusion(nn.Module):
    """``TransFuser``: the GPT and its Linear head. Built on the CPU from
    ``generator`` (seed 0 when omitted), then moved to ``device``."""

    def __init__(self, cfg: GPTFusionConfig = VIT_CONFIG,
                 num_classes: int = 3, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        d = cfg.n_embd
        self.pos_emb = (nn.Parameter(torch.zeros(1, cfg.joint_len, d))
                        if cfg.use_pos_embed else None)
        self.blocks = nn.ModuleList(Block(d, cfg.block_exp)
                                    for _ in range(cfg.n_layer))
        self.ln_f = nn.LayerNorm(d, eps=1e-5)
        self.head = nn.Linear(d, num_classes)
        self.reset_parameters(generator or torch.Generator().manual_seed(0))
        if device is not None:
            self.to(device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """``init`` of the JAX package: every Linear weight N(0, 0.02),
        zero biases, unit LayerNorms, a zero ``pos_emb``."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.normal_(m.weight, std=0.02, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()
        if self.pos_emb is not None:
            nn.init.zeros_(self.pos_emb)

    def forward(self, cxr_features, enh_features, *,
                reference: bool = False,
                attn_backend: str | None = None) -> torch.Tensor:
        """The TransFuser forward -> logits (B, num_classes) fp32. The head
        has no kernel, so ``reference`` (the plain path of the branch
        kernels) and ``attn_backend`` (JAX's GPT head takes none) change
        nothing here."""
        return apply(self, cxr_features, enh_features)


def _self_attention(attn: SelfAttention, x: torch.Tensor,
                    n_head: int) -> torch.Tensor:
    B, T, C = x.shape
    hd = C // n_head

    def split(t):  # (B * n_head, T, hd)
        return t.reshape(B, T, n_head, hd).transpose(1, 2).reshape(-1, T, hd)

    q, k, v = (split(linear(p, x))
               for p in (attn.query, attn.key, attn.value))
    att = bmm_f32(q, k.mT) * hd ** -0.5
    att = torch.softmax(att, -1).to(v.dtype)
    y = torch.matmul(att, v).reshape(B, n_head, T, hd).transpose(1, 2)
    return linear(attn.proj, y.reshape(B, T, C))


def gpt_apply(gpt: GPTFusion, joint: torch.Tensor) -> torch.Tensor:
    """The GPT over the joint token sequence (B, L, C) -> (B, L, C)."""
    x = joint
    if gpt.pos_emb is not None:
        x = x + gpt.pos_emb.to(x.dtype)
    for blk in gpt.blocks:
        x = x + _self_attention(blk.attn, layernorm(blk.ln1, x, eps=1e-5),
                                gpt.cfg.n_head)
        h = linear(blk.mlp[0], layernorm(blk.ln2, x, eps=1e-5))
        x = x + linear(blk.mlp[2], F.relu(h))
    return layernorm(gpt.ln_f, x, eps=1e-5)


def encode_vit(gpt: GPTFusion, cxr_tokens: torch.Tensor,
               enh_tokens: torch.Tensor) -> torch.Tensor:
    """ViT streams: the GPT over both, its output added onto each stream,
    the two CLS rows summed -> (B, C)."""
    N = cxr_tokens.shape[1]
    out = gpt_apply(gpt, torch.cat([cxr_tokens, enh_tokens], 1))
    return (cxr_tokens[:, 0] + out[:, 0]) + (enh_tokens[:, 0] + out[:, N])


def encode_res(gpt: GPTFusion, cxr_map: torch.Tensor,
               enh_map: torch.Tensor) -> torch.Tensor:
    """ResNet maps (B, H, W, C): each average-pooled onto the anchor grid,
    the GPT over both grids, its output added back, ReLU, the global mean,
    the two streams summed -> (B, C)."""
    B, H, W, C = cxr_map.shape
    va, ha = gpt.cfg.vert_anchors, gpt.cfg.horz_anchors

    def pool_anchors(x):  # H and W divide by the anchors
        return x.reshape(B, va, H // va, ha, W // ha, C).mean((2, 4))

    cxr_t = pool_anchors(cxr_map).reshape(B, va * ha, C)
    enh_t = pool_anchors(enh_map).reshape(B, va * ha, C)
    out = gpt_apply(gpt, torch.cat([cxr_t, enh_t], 1))
    cxr = F.relu(cxr_t + out[:, :va * ha]).mean(1)
    enh = F.relu(enh_t + out[:, va * ha:]).mean(1)
    return cxr + enh


def apply(gpt: GPTFusion, cxr_features: torch.Tensor,
          enh_features: torch.Tensor) -> torch.Tensor:
    """Token streams (ViT) or feature maps (ResNet) -> logits (B,
    num_classes), the head on the fused row in fp32."""
    encode = encode_vit if gpt.cfg.arch == "vit" else encode_res
    return linear(gpt.head, encode(gpt, cxr_features, enh_features).float())
