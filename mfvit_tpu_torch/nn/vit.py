"""ViT backbone (MoCo-v3 flavour), the port of ``mfvit_tpu/nn/vit.py``.

Same contract: NHWC images, the stride-16 patch conv as one GEMM over
patchified pixels, CLS token, fixed 2-D sin-cos (or learned) position
embedding, pre-norm blocks, final LayerNorm, optional classifier head, and
``return_features=True`` returning (tokens, logits) from one pass.

Module and parameter names follow MoCo-v3 ``vits.py`` / timm, the names
``mfvit_tpu/exp/checkpoint.py::params_to_torch_vit`` emits, so a converted
JAX tree loads with ``load_state_dict(strict=True)``.

Every block runs K1 (``ops.fused_attn``) and K2 (``ops.fused_mlp``) except
the last, which runs K3 with the model's final LayerNorm in its epilogue,
at every width. That per-block plan is computed once, when the model is
built (``block_plan``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from mfvit_tpu_torch.nn import posembed
from mfvit_tpu_torch.nn.layers import Mlp, trunc_normal_
from mfvit_tpu_torch.ops import fused_attn, fused_mlp


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    name: str = "vit_small"
    img_size: int = 224
    patch: int = 16
    dim: int = 384
    depth: int = 12
    heads: int = 12
    mlp_ratio: int = 4
    learned_pos: bool = False  # MoCo-v3 uses fixed sincos; *_ori learns it
    conv_stem: bool = False    # MoCo-v3 vit_conv_*: 4x(conv3x3 s2+BN+ReLU)+1x1
    qkv_bias: bool = True      # vit_conv_* sets qkv_bias=False

    @property
    def grid(self) -> int:
        return self.img_size // self.patch

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads


CONFIGS = {
    "vit_small": ViTConfig("vit_small", dim=384, depth=12, heads=12),
    "vit_base": ViTConfig("vit_base", dim=768, depth=12, heads=12),
    "vit_small_ori": ViTConfig("vit_small_ori", dim=384, depth=12, heads=6,
                               learned_pos=True),
    "vit_base_ori": ViTConfig("vit_base_ori", dim=768, depth=12, heads=12,
                              learned_pos=True),
    "vit_conv_small": ViTConfig("vit_conv_small", dim=384, depth=11,
                                heads=12, conv_stem=True, qkv_bias=False),
    "vit_conv_base": ViTConfig("vit_conv_base", dim=768, depth=11,
                               heads=12, conv_stem=True, qkv_bias=False),
}


def get_config(name: str, img_size: int = 224) -> ViTConfig:
    cfg = CONFIGS[name]
    if img_size != cfg.img_size:
        cfg = dataclasses.replace(cfg, img_size=img_size)
    return cfg


# ------------------------------------------------------------ block plan

@dataclasses.dataclass(frozen=True)
class BlockOps:
    attn: Callable
    mlp: Callable
    final_ln: bool  # the MLP op applies the model's final LayerNorm too


def block_plan(depth: int, reference: bool = False) -> tuple:
    """The ops each block runs: the kernel Functions (K1/K5, K2/K7,
    K3/K7). ``reference=True`` gives the same Functions over the plain
    PyTorch versions, forward and backward, on any device: the reference
    the kernels are held to."""
    attn = functools.partial(fused_attn.fused_attention_block,
                             plain=reference)
    mid = functools.partial(fused_mlp.fused_mlp_block, plain=reference)
    last = functools.partial(fused_mlp.fused_mlp_block_final_ln,
                             plain=reference)
    return tuple(BlockOps(attn, last, True) if i == depth - 1
                 else BlockOps(attn, mid, False) for i in range(depth))


# ---------------------------------------------------------------- modules

def patchify(imgs: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, N, patch*patch*C), row-major patches with
    (ph, pw, c) feature order inside each patch."""
    B, H, W, C = imgs.shape
    gh, gw = H // patch, W // patch
    x = imgs.reshape(B, gh, patch, gw, patch, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, gh * gw, patch * patch * C)


def patch_embed(proj: nn.Conv2d, imgs: torch.Tensor, patch: int):
    """The stride-``patch`` conv as one GEMM over patchified NHWC pixels;
    the conv weight (D, C, P, P) is read in (ph, pw, c) order."""
    D = proj.weight.shape[0]
    w = proj.weight.permute(0, 2, 3, 1).reshape(D, -1).to(imgs.dtype)
    return F.linear(patchify(imgs, patch), w, proj.bias.to(imgs.dtype))


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, in_chans: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, dim, patch, patch)


class Attention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class Block(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, hidden)


class ViT(nn.Module):
    """Built on the CPU, initialised from ``generator`` (a CPU
    ``torch.Generator``; seed 0 when omitted) and then moved to
    ``device``."""

    def __init__(self, cfg: ViTConfig, num_classes: int = 0, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if cfg.conv_stem or not cfg.qkv_bias:
            raise NotImplementedError(
                f"{cfg.name}: the ConvStem archs are not ported yet "
                "(ROADMAP.md, modules to port: nn/vit.py ConvStem)")
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg.patch, 3, cfg.dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.dim))
        if cfg.learned_pos:
            self.pos_embed = nn.Parameter(torch.zeros(1, cfg.seq_len, cfg.dim))
        else:
            # MoCo-v3 keeps the fixed table in its state dict too
            self.register_buffer("pos_embed",
                                 posembed.sincos_2d(cfg.grid, cfg.grid, cfg.dim))
        self.blocks = nn.ModuleList(
            Block(cfg.dim, cfg.dim * cfg.mlp_ratio) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(cfg.dim, eps=1e-6)
        self.head = nn.Linear(cfg.dim, num_classes) if num_classes > 0 else None
        self.plans = {False: block_plan(cfg.depth),
                      True: block_plan(cfg.depth, reference=True)}
        self.reset_parameters(generator or torch.Generator().manual_seed(0))
        if device is not None:
            self.to(device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """MoCo-v3 ViT init (``mfvit_tpu/nn/vit.py::init``): patch projection
        and qkv xavier-uniform over the per-matrix fans, CLS N(0, 1e-6),
        learned position embedding and the other linears trunc-normal 0.02,
        classifier head N(0, 0.01), zero biases, unit LN scales."""
        cfg = self.cfg
        w = self.patch_embed.proj.weight
        lim = (6.0 / (w[0].numel() + cfg.dim)) ** 0.5
        nn.init.uniform_(w, -lim, lim, generator=generator)
        nn.init.zeros_(self.patch_embed.proj.bias)
        nn.init.normal_(self.cls_token, std=1e-6, generator=generator)
        if cfg.learned_pos:
            trunc_normal_(self.pos_embed, 0.02, generator)
        qkv_lim = (6.0 / (2 * cfg.dim)) ** 0.5
        for blk in self.blocks:
            nn.init.uniform_(blk.attn.qkv.weight, -qkv_lim, qkv_lim,
                             generator=generator)
            nn.init.zeros_(blk.attn.qkv.bias)
            trunc_normal_(blk.attn.proj.weight, 0.02, generator)
            nn.init.zeros_(blk.attn.proj.bias)
            blk.mlp.reset_parameters(generator)
            for ln in (blk.norm1, blk.norm2):
                ln.reset_parameters()
        self.norm.reset_parameters()
        if self.head is not None:
            nn.init.normal_(self.head.weight, std=0.01, generator=generator)
            nn.init.zeros_(self.head.bias)

    def _block(self, x, blk: Block, ops: BlockOps) -> torch.Tensor:
        """One block through its ops, on the fp32 parameters: the ops cast
        them to x's dtype and return fp32 gradients."""
        a, m = blk.attn, blk.mlp
        x = ops.attn(x, blk.norm1.weight, blk.norm1.bias, a.qkv.weight,
                     a.qkv.bias, a.proj.weight, a.proj.bias, self.cfg.heads,
                     self.cfg.head_dim ** -0.5)
        args = (x, blk.norm2.weight, blk.norm2.bias, m.fc1.weight, m.fc1.bias,
                m.fc2.weight, m.fc2.bias)
        if ops.final_ln:
            return ops.mlp(*args, self.norm.weight, self.norm.bias)
        return ops.mlp(*args)

    def forward(self, imgs: torch.Tensor, *,
                compute_dtype: torch.dtype = torch.bfloat16,
                return_features: bool = False, reference: bool = False,
                remat: bool = False):
        """imgs (B, H, W, C) -> logits (B, num_classes) fp32, or the CLS
        embedding without a head; with ``return_features`` also the
        post-norm tokens (B, N+1, dim) in ``compute_dtype``. ``reference``
        runs the plain PyTorch versions of the kernels. ``remat``
        recomputes each block in the backward
        (``torch.utils.checkpoint``, the port of ``jax.checkpoint`` at
        ``mfvit_tpu/nn/vit.py:443-444``); a block's forward kernels then
        run twice per training step."""
        cfg = self.cfg
        if imgs.is_cuda and cfg.img_size > 224:
            raise NotImplementedError(
                f"img_size {cfg.img_size} > 224 needs the query-blocked "
                "attention kernel K9 on CUDA (ROADMAP.md)")
        dt = compute_dtype
        B = imgs.shape[0]
        x = patch_embed(self.patch_embed.proj, imgs.to(dt), cfg.patch)
        cls = self.cls_token.to(dt).expand(B, 1, cfg.dim)
        x = torch.cat([cls, x], 1)
        x = (x.float() + self.pos_embed).to(dt)
        for blk, ops in zip(self.blocks, self.plans[reference]):
            if remat and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(
                    self._block, x, blk, ops, use_reentrant=False)
            else:
                x = self._block(x, blk, ops)
        tokens = x  # the final LayerNorm ran in the last block's K3
        cls_out = tokens[:, 0].float()
        out = (F.linear(cls_out, self.head.weight, self.head.bias)
               if self.head is not None else cls_out)
        return (tokens, out) if return_features else out
