"""ViT backbone (MoCo-v3 flavour), the port of ``mfvit_tpu/nn/vit.py``.

Same contract: NHWC images, the stride-16 patch conv as one GEMM over
patchified pixels, CLS token, fixed 2-D sin-cos (or learned) position
embedding, pre-norm blocks, final LayerNorm, optional classifier head, and
``return_features=True`` returning (tokens, logits) from one pass. The
ConvStem archs (``vit_conv_small``, ``vit_conv_base``) replace the patch
conv by MoCo-v3's stem (``mfvit_tpu/nn/vit.py::_conv_stem``, :209): four
bias-free 3x3 stride-2 convolutions, each with a BatchNorm and a ReLU, then
a 1x1 convolution with a bias; their qkv has no bias, and the ops get a
zero one, as JAX passes K1 (:397-398). ``stop_grad_conv1`` gives the plain
patch projection a zero gradient, as ``jax.lax.stop_gradient`` does
(:263): the optimizers then still apply their weight decay to it.

Module and parameter names follow MoCo-v3 ``vits.py`` / timm, the names
``mfvit_tpu/exp/checkpoint.py::params_to_torch_vit`` emits, so a converted
JAX tree loads with ``load_state_dict(strict=True)``.

Every block runs an attention half (``ops.fused_attn``) and K2
(``ops.fused_mlp``) except the last, which runs K3 with the model's final
LayerNorm in its epilogue, at every width. The attention half is K1 up to
256 tokens (img_size 224 at patch 16 is 197) and K9, its long-sequence
form, past that (img_size 384 is 577 tokens). That per-block plan is
computed once, when the model is built (``block_plan``).
``quantize_vit_for_serving`` turns a model into the int8 serving form,
whose blocks run K11 (``ops.fused_int8``) and, for the attention half, K10
or K9 on the dequantized weights by the JAX package's rule, and whose final
LayerNorm runs after the blocks. ``quantize_vit_params`` turns it into the
XLA-level W8A8 form of ``mfvit_tpu/ops/quant.py``: the patch projection and
every block linear quantized, blocks of eager W8A8 linears around K12
(``ops.quant``), the final LayerNorm after the blocks.

The port does not copy the JAX package's TPU memory gates
(``mfvit_tpu/nn/vit.py:299-310``): where JAX picks its K1, K9 or XLA
attention by what fits a v5e's VMEM, the port picks by the sequence
length alone. So two configurations run other code than in JAX, with the
same math and other bf16 rounding: vit_base@384, where neither Pallas
kernel fits and JAX runs XLA attention, runs K9 here; and 256 < N where
K1 still fits on the TPU (img_size 288, N = 325, at vit_small) runs K9
here, whose backward is the fp32 recompute instead of K5. And at D > 512
(vit_base, vit_base_ori) the last block runs K3, which keeps x +
MLP(LN(x)) in fp32 into the final LayerNorm, where JAX runs K2, rounding
that sum to bf16, and then the final LayerNorm after the blocks
(:411-423); the bf16 tokens differ by that one rounding
(``tests/test_torch_port_faults.py`` holds them within 1e-2 of JAX's at
D=768).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from mfvit_tpu_torch.nn import posembed, xla_route
from mfvit_tpu_torch.nn.layers import (Mlp, batch_norm, layer_norm,
                                       linear_f32, trunc_normal_)
from mfvit_tpu_torch.ops import fused_attn, fused_int8, fused_mlp, quant


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


# the longest sequence K1 takes; longer ones run K9
K1_MAX_TOKENS = 256


PLAN_MODES = ("bf16", "int8", "quant")


def block_plan(cfg: ViTConfig, reference: bool = False,
               mode: str = "bf16", xla: bool = False) -> tuple:
    """The ops each block of ``cfg`` runs, by ``mode``: ``bf16``, the
    kernel Functions (K1/K5 up to ``K1_MAX_TOKENS`` tokens, else K9 with
    its fp32-recompute backward; K2/K7, K3/K7); ``int8`` (the serving form
    of ``quantize_vit_for_serving``), the inference-only ops on every
    block: K10, or K9 on the dequantized weights where
    ``fused_int8.w8a8_attention`` says JAX takes that route, and K11;
    ``quant`` (``quantize_vit_params``), the XLA-level W8A8 halves of
    ``ops.quant`` (K12 at any N, as JAX's ``use_large_attn`` covers only
    unquantized blocks). In both quantized forms the final LayerNorm runs
    after the blocks, as JAX's ``final_ln_done`` is False for such a tree.
    ``reference=True`` gives the same ops over the plain PyTorch versions,
    on any device: the reference the kernels are held to. ``xla=True``
    gives JAX's XLA route for ``mode`` (``nn.xla_route``: no kernel; the
    int8 form's weights dequantized, the quant form's W8A8 linears), the
    final LayerNorm after the blocks."""
    if mode not in PLAN_MODES:
        raise ValueError(f"block_plan: mode {mode!r} is not one of "
                         f"{PLAN_MODES}")
    if xla:
        ops = {"bf16": BlockOps(xla_route.attention_block,
                                xla_route.mlp_block, False),
               "int8": BlockOps(xla_route.attention_block_dequant,
                                xla_route.mlp_block_dequant, False),
               "quant": BlockOps(xla_route.quant_attention_block,
                                 quant.quant_mlp_block, False)}[mode]
        return (ops,) * cfg.depth
    if mode == "quant":
        ops = BlockOps(functools.partial(quant.quant_attention_block,
                                         plain=reference),
                       quant.quant_mlp_block, False)
        return (ops,) * cfg.depth
    if mode == "int8":
        attn = (fused_int8.fused_attention_block_i8
                if fused_int8.w8a8_attention(cfg.seq_len, cfg.dim, cfg.heads)
                else fused_int8.fused_attention_block_dequant)
        ops = BlockOps(
            functools.partial(attn, plain=reference),
            functools.partial(fused_int8.fused_mlp_block_i8, plain=reference),
            False)
        return (ops,) * cfg.depth
    attn = functools.partial(
        fused_attn.fused_attention_block if cfg.seq_len <= K1_MAX_TOKENS
        else fused_attn.fused_attention_block_large, plain=reference)
    mid = functools.partial(fused_mlp.fused_mlp_block, plain=reference)
    last = functools.partial(fused_mlp.fused_mlp_block_final_ln,
                             plain=reference)
    return tuple(BlockOps(attn, last, True) if i == cfg.depth - 1
                 else BlockOps(attn, mid, False) for i in range(cfg.depth))


def plans(cfg: ViTConfig, mode: str = "bf16") -> dict:
    """A model's plans by route: False the kernels, True their plain
    versions, "xla" JAX's XLA route (``block_plan``)."""
    return {False: block_plan(cfg, mode=mode),
            True: block_plan(cfg, reference=True, mode=mode),
            "xla": block_plan(cfg, mode=mode, xla=True)}


# ---------------------------------------------------------------- modules

def patchify(imgs: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, N, patch*patch*C), row-major patches with
    (ph, pw, c) feature order inside each patch."""
    B, H, W, C = imgs.shape
    gh, gw = H // patch, W // patch
    x = imgs.reshape(B, gh, patch, gw, patch, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, gh * gw, patch * patch * C)


class _ZeroGrad(torch.autograd.Function):
    """The identity with a zero gradient: ``jax.lax.stop_gradient`` as an
    optimizer sees it, a gradient of zeros and not none."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g)


def patch_embed(proj: nn.Conv2d, imgs: torch.Tensor, patch: int,
                stop_grad: bool = False):
    """The stride-``patch`` conv as one GEMM over patchified NHWC pixels;
    the conv weight (D, C, P, P) is read in (ph, pw, c) order. The fp32
    sums take the fp32 bias and are rounded once to the images' dtype, as
    ``mfvit_tpu/nn/vit.py::patch_embed`` (:203-205) does. ``stop_grad``
    gives the weight and bias zero gradients."""
    w, b = proj.weight, proj.bias
    if stop_grad:
        w, b = _ZeroGrad.apply(w), _ZeroGrad.apply(b)
    D = w.shape[0]
    w = w.permute(0, 2, 3, 1).reshape(D, -1)
    return linear_f32(patchify(imgs, patch), w, b).to(imgs.dtype)


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, in_chans: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, dim, patch, patch)


class ConvStem(nn.Module):
    """MoCo-v3 ``vits.py`` ConvStem under its names: ``proj`` is
    conv3x3/s2 (no bias), BatchNorm2d, ReLU four times (widths dim/8,
    dim/4, dim/2, dim), then a 1x1 conv with a bias (index 12)."""

    def __init__(self, in_chans: int, dim: int):
        super().__init__()
        layers, cin, cout = [], in_chans, dim // 8
        for _ in range(4):
            layers += [nn.Conv2d(cin, cout, 3, 2, 1, bias=False),
                       nn.BatchNorm2d(cout), nn.ReLU()]
            cin, cout = cout, cout * 2
        layers.append(nn.Conv2d(cin, dim, 1))
        self.proj = nn.Sequential(*layers)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """He fan-out normal convolutions, unit BatchNorms, a zero bias
        (``mfvit_tpu/nn/vit.py::init`` :114-140)."""
        for i in range(4):
            conv, bn = self.proj[3 * i], self.proj[3 * i + 1]
            nn.init.normal_(conv.weight, std=(2.0 / (9 * conv.out_channels))
                            ** 0.5, generator=generator)
            bn.reset_parameters()
        last = self.proj[12]
        nn.init.normal_(last.weight, std=(2.0 / last.out_channels) ** 0.5,
                        generator=generator)
        nn.init.zeros_(last.bias)


def conv_stem(stem: ConvStem, imgs: torch.Tensor, *,
              bn_training: bool = False) -> torch.Tensor:
    """NHWC images -> (B, H/16 * W/16, dim) tokens in the images' dtype,
    as ``mfvit_tpu/nn/vit.py::_conv_stem``: each convolution's fp32 sums
    rounded to that dtype, the BatchNorms as ``batch_norm`` (batch
    statistics under ``bn_training``), the 1x1 conv's bias added in the
    images' dtype."""
    dt = imgs.dtype
    x = imgs.permute(0, 3, 1, 2)
    seq = stem.proj
    for i in range(4):
        conv, bn = seq[3 * i], seq[3 * i + 1]
        x = F.conv2d(x, conv.weight.to(dt), stride=2, padding=1)
        x = F.relu(batch_norm(bn, x, training=bn_training))
    x = F.conv2d(x, seq[12].weight.to(dt)) + seq[12].bias.to(dt)[:, None,
                                                                  None]
    return x.flatten(2).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, dim: int, qkv_bias: bool = True):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)


class Int8Linear(nn.Module):
    """A linear quantized for serving: int8 codes ``q`` (out, in), one fp32
    scale per output channel ``s`` and the fp32 ``bias``, as buffers, from
    an fp32 weight (out, in) and bias."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor | None):
        super().__init__()
        q, s = fused_int8.quantize_weight_cols(weight.detach())
        self.register_buffer("q", q)
        self.register_buffer("s", s)
        self.register_buffer("bias", _bias_or_zeros(weight, bias)
                             .detach().float().clone())


def _bias_or_zeros(weight: torch.Tensor, bias):
    """A linear's bias, or zeros for a bias-free one (the ConvStem archs'
    qkv), which the block ops take as JAX's kernels do."""
    if bias is not None:
        return bias
    return torch.zeros(weight.shape[0], dtype=torch.float32,
                       device=weight.device)


def _linear_params(lin) -> tuple:
    """What a block op takes for one linear: (weight, bias) of an fp32
    Linear, (q, s, bias) of an ``Int8Linear``."""
    if isinstance(lin, Int8Linear):
        return lin.q, lin.s, lin.bias
    return lin.weight, _bias_or_zeros(lin.weight, lin.bias)


class Block(nn.Module):
    def __init__(self, dim: int, hidden: int, qkv_bias: bool = True):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, hidden)


class ViT(nn.Module):
    """Built on the CPU, initialised from ``generator`` (a CPU
    ``torch.Generator``; seed 0 when omitted) and then moved to
    ``device``. ``in_chans=4`` takes the stacked CXR-gray + enhanced input
    (``mfvit_tpu/nn/vit.py::init(..., in_chans)``)."""

    def __init__(self, cfg: ViTConfig, num_classes: int = 0, *,
                 in_chans: int = 3, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = (ConvStem(in_chans, cfg.dim) if cfg.conv_stem
                            else PatchEmbed(cfg.patch, in_chans, cfg.dim))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.dim))
        if cfg.learned_pos:
            self.pos_embed = nn.Parameter(torch.zeros(1, cfg.seq_len, cfg.dim))
        else:
            # MoCo-v3 keeps the fixed table in its state dict too
            self.register_buffer("pos_embed",
                                 posembed.sincos_2d(cfg.grid, cfg.grid, cfg.dim))
        self.blocks = nn.ModuleList(
            Block(cfg.dim, cfg.dim * cfg.mlp_ratio, cfg.qkv_bias)
            for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(cfg.dim, eps=1e-6)
        self.head = nn.Linear(cfg.dim, num_classes) if num_classes > 0 else None
        self.plans = plans(cfg)
        self.reset_parameters(generator or torch.Generator().manual_seed(0))
        if device is not None:
            self.to(device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """MoCo-v3 ViT init (``mfvit_tpu/nn/vit.py::init``): patch projection
        and qkv xavier-uniform over the per-matrix fans, CLS N(0, 1e-6),
        learned position embedding and the other linears trunc-normal 0.02,
        classifier head N(0, 0.01), zero biases, unit LN scales; a ConvStem
        as ``ConvStem.reset_parameters``."""
        cfg = self.cfg
        if cfg.conv_stem:
            self.patch_embed.reset_parameters(generator)
        else:
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
            if blk.attn.qkv.bias is not None:
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
        x = ops.attn(x, blk.norm1.weight, blk.norm1.bias,
                     *_linear_params(a.qkv), *_linear_params(a.proj),
                     self.cfg.heads, self.cfg.head_dim ** -0.5)
        args = (x, blk.norm2.weight, blk.norm2.bias, *_linear_params(m.fc1),
                *_linear_params(m.fc2))
        if ops.final_ln:
            return ops.mlp(*args, self.norm.weight, self.norm.bias)
        return ops.mlp(*args)

    def forward(self, imgs: torch.Tensor, *,
                compute_dtype: torch.dtype = torch.bfloat16,
                return_features: bool = False, reference: bool = False,
                remat: bool = False, stop_grad_conv1: bool = False,
                bn_training: bool = False, attn_backend: str | None = None):
        """imgs (B, H, W, C) -> logits (B, num_classes) fp32, or the CLS
        embedding without a head; with ``return_features`` also the
        post-norm tokens (B, N+1, dim) in ``compute_dtype``. ``reference``
        runs the plain PyTorch versions of the kernels. ``remat``
        recomputes each block in the backward
        (``torch.utils.checkpoint``, the port of ``jax.checkpoint`` at
        ``mfvit_tpu/nn/vit.py:443-444``); a block's forward kernels then
        run twice per training step. ``stop_grad_conv1`` gives the plain
        patch projection zero gradients (a ConvStem trains whole, as in
        JAX); ``bn_training`` runs a ConvStem's BatchNorms on batch
        statistics and moves their running ones (MoCo's towers), else on
        the running ones. ``attn_backend="xla"`` runs JAX's XLA route
        (``nn.xla_route``) instead of the kernels or their plain versions;
        ``None``, ``"auto"`` and ``"pallas"`` change nothing."""
        cfg = self.cfg
        dt = compute_dtype
        B = imgs.shape[0]
        proj = self.patch_embed.proj
        if cfg.conv_stem:
            x = conv_stem(self.patch_embed, imgs.to(dt),
                          bn_training=bn_training)
        elif isinstance(proj, Int8Linear):  # quantize_vit_params
            x = quant.quantized_linear(proj.q, proj.s,
                                       patchify(imgs.to(dt), cfg.patch),
                                       proj.bias)
        else:
            x = patch_embed(proj, imgs.to(dt), cfg.patch,
                            stop_grad=stop_grad_conv1)
        cls = self.cls_token.to(dt).expand(B, 1, cfg.dim)
        x = torch.cat([cls, x], 1)
        x = (x.float() + self.pos_embed).to(dt)
        plan = self.plans["xla" if xla_route.takes_xla(attn_backend)
                          else reference]
        for blk, ops in zip(self.blocks, plan):
            if remat and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(
                    self._block, x, blk, ops, use_reentrant=False)
            else:
                x = self._block(x, blk, ops)
        # the final LayerNorm ran in the last block's K3, unless quantized
        tokens = (x if plan[-1].final_ln
                  else layer_norm(x, self.norm.weight, self.norm.bias, 1e-6))
        cls_out = tokens[:, 0].float()
        out = (F.linear(cls_out, self.head.weight, self.head.bias)
               if self.head is not None else cls_out)
        return (tokens, out) if return_features else out


def quantize_vit_for_serving(model: ViT) -> ViT:
    """Turn ``model`` (in place) into the int8 W8A8 serving form, the port
    of ``mfvit_tpu/ops/fused_int8.py::quantize_vit_for_serving`` (:273):
    each block's qkv, proj, fc1 and fc2 become ``Int8Linear`` buffers and
    its plan runs K11 and, for the attention half, K10 or K9 on the
    dequantized weights (``block_plan``); the patch embedding, LayerNorms,
    CLS, position table and the fp32 head stay exact. Returns the model."""
    _quantize_blocks(model)
    model.plans = plans(model.cfg, "int8")
    return model


def _quantize_blocks(model: ViT) -> None:
    for blk in model.blocks:
        a, m = blk.attn, blk.mlp
        a.qkv, a.proj, m.fc1, m.fc2 = (Int8Linear(lin.weight, lin.bias)
                                       for lin in (a.qkv, a.proj, m.fc1,
                                                   m.fc2))


def quantize_vit_params(model: ViT) -> ViT:
    """Turn ``model`` (in place) into the XLA-level W8A8 form, the port of
    ``mfvit_tpu/ops/quant.py::quantize_vit_params`` (:57): the patch
    projection, in the JAX (P*P*C, D) layout's (ph, pw, c) order so that
    its GEMM runs on ``patchify(imgs)`` (a ConvStem stays exact, as in
    JAX), and each block's qkv, proj, fc1 and fc2 become ``Int8Linear``
    buffers; the plan runs
    ``ops.quant``'s W8A8 halves around K12 (``block_plan``); LayerNorms,
    CLS, the position table and the fp32 head stay exact. Inference only.
    Returns the model."""
    if not model.cfg.conv_stem:
        proj = model.patch_embed.proj
        D = proj.weight.shape[0]
        model.patch_embed.proj = Int8Linear(
            proj.weight.permute(0, 2, 3, 1).reshape(D, -1), proj.bias)
    _quantize_blocks(model)
    model.plans = plans(model.cfg, "quant")
    return model
