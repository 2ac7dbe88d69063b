"""MoCo pretraining, the port of ``mfvit_tpu/ssl/moco.py``: the v3 tower
structure with the v2 queue loss (the objective the pretrain CLI runs), the
v3 symmetric loss, and the v2-classic heads.

``MoCo`` holds the base tower (a ViT or ResNet encoder and its projector),
the momentum tower (a copy of it that moves only by the EMA), the predictor
and, as buffers, the L2-normalised negative queue (dim x K, fp32) and its
pointer. The projector and predictor are ``nn.Sequential`` stacks numbered
as the reference's ``_build_mlp`` (Linear, BatchNorm1d, ReLU per hidden
layer, then Linear and an affine-free BatchNorm1d; Linear with a bias and
ReLU and no BatchNorm for v2-classic), so their state-dict keys are the
``.pth.tar``'s (``mfvit_tpu/exp/checkpoint.py::_mlp_params_to_torch_seq``,
:393). They run in fp32 on the encoders' fp32 features, their BatchNorms
always on batch statistics (``mfvit_tpu/nn/layers.py::batchnorm`` with
``training=True``), moving the running ones under ``no_grad`` too, as the
reference's key pass does.

A step (``make_pretrain_step``) keeps JAX's order: the EMA of the momentum
tower's parameters first (its BatchNorm statistics stay its own), the
query pass under autograd, the key pass under ``no_grad`` with batch
statistics, the loss, the backward and the optimizer step over the base
tower and the predictor, then the ring enqueue of the keys. Each ViT block
runs K1, K2 or K3 forward in both towers and K5, K7 backward in the query
tower. ``l_neg``, a (B, dim) x (dim, K) product, is an XLA einsum in JAX and
``torch.matmul`` here.
"""
from __future__ import annotations

import copy
import dataclasses
import itertools
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from mfvit_tpu_torch.nn import resnet as resnet_mod
from mfvit_tpu_torch.nn import vit as vit_mod
from mfvit_tpu_torch.nn.layers import batch_norm, trunc_normal_


@dataclasses.dataclass(frozen=True)
class MoCoConfig:
    dim: int = 256            # output embedding dim (pretrain --moco-dim)
    mlp_dim: int = 4096       # projector/predictor hidden dim
    K: int = 65536            # queue length
    T: float = 0.2            # temperature
    m: float = 0.99           # base EMA momentum (--moco-m)
    loss: str = "v2_queue"    # 'v2_queue' | 'v3_symmetric'
    predictor_on_keys: bool = True
    stop_grad_conv1: bool = True
    projector_layers: int = 3
    predictor_layers: int = 2
    projector_bn: bool = True
    predictor_last_bn: bool = True
    use_predictor: bool = True

    @staticmethod
    def resnet(**kw) -> "MoCoConfig":
        kw.setdefault("projector_layers", 2)
        kw.setdefault("predictor_last_bn", False)
        kw.setdefault("stop_grad_conv1", False)
        return MoCoConfig(**kw)

    @staticmethod
    def v2_classic(mlp: bool = True, **kw) -> "MoCoConfig":
        """The original MoCo-v2: dim 128, T 0.07, m 0.999, an optional
        two-layer BN-free head with biases, no predictor."""
        kw.setdefault("dim", 128)
        kw.setdefault("T", 0.07)
        kw.setdefault("m", 0.999)
        kw.setdefault("projector_layers", 2 if mlp else 1)
        kw.setdefault("projector_bn", False)
        kw.setdefault("use_predictor", False)
        kw.setdefault("predictor_on_keys", False)
        kw.setdefault("stop_grad_conv1", False)
        return MoCoConfig(**kw)


# ---------------------------------------------------------- MLP (BN-ReLU)

def mlp_stack(num_layers: int, in_dim: int, mlp_dim: int, out_dim: int, *,
              last_bn: bool = True, use_bn: bool = True,
              generator: torch.Generator) -> nn.Sequential:
    """The reference ``_build_mlp`` numbering; linears trunc-normal 0.02
    with zero biases (``linear_init(dist="trunc_normal", bias=not
    use_bn)``), unit BatchNorms."""
    layers = []
    for i in range(num_layers):
        d1 = in_dim if i == 0 else mlp_dim
        d2 = out_dim if i == num_layers - 1 else mlp_dim
        lin = nn.Linear(d1, d2, bias=not use_bn)
        with torch.no_grad():
            trunc_normal_(lin.weight, 0.02, generator)
            if lin.bias is not None:
                nn.init.zeros_(lin.bias)
        layers.append(lin)
        if i < num_layers - 1:
            layers += [nn.BatchNorm1d(d2), nn.ReLU()] if use_bn \
                else [nn.ReLU()]
        elif last_bn and use_bn:
            layers.append(nn.BatchNorm1d(d2, affine=False))
    return nn.Sequential(*layers)


def mlp_apply(seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """The stack on fp32 features, every BatchNorm on batch statistics."""
    x = x.float()
    for layer in seq:
        if isinstance(layer, nn.Linear):
            x = F.linear(x, layer.weight, layer.bias)
        elif isinstance(layer, nn.BatchNorm1d):
            x = batch_norm(layer, x, training=True)
        else:
            x = F.relu(x)
    return x


# ----------------------------------------------------------------- model

class Tower(nn.Module):
    def __init__(self, encoder: nn.Module, projector: nn.Sequential):
        super().__init__()
        self.encoder = encoder
        self.projector = projector


def backbone(cfg, generator: torch.Generator, in_chans: int = 3
             ) -> nn.Module:
    """A ViT or ResNet encoder taking ``in_chans`` input channels."""
    if isinstance(cfg, vit_mod.ViTConfig):
        return vit_mod.ViT(cfg, in_chans=in_chans, generator=generator)
    if cfg.in_chans != in_chans:
        cfg = dataclasses.replace(cfg, in_chans=in_chans)
    return resnet_mod.ResNet(cfg, generator=generator)


def backbone_dim(cfg) -> int:
    return cfg.dim if isinstance(cfg, vit_mod.ViTConfig) else cfg.out_dim


class MoCo(nn.Module):
    """The MoCo state as one module (``mfvit_tpu/ssl/moco.py::init``):
    ``base`` and ``momentum`` towers (the momentum tower a copy of the
    base, frozen to autograd), ``predictor`` (empty without one), and the
    ``queue`` (dim, K), L2-normalised per column, with ``queue_ptr``.
    Built on the CPU from ``generator`` (seed 0 when omitted).
    ``in_chans=4`` gives the encoders the stacked CXR-gray + enhanced
    input (builder_4ch)."""

    def __init__(self, cfg: MoCoConfig, backbone_cfg, *, in_chans: int = 3,
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.cfg, self.backbone_cfg = cfg, backbone_cfg
        self.in_chans = in_chans
        encoder = backbone(backbone_cfg, gen, in_chans)
        projector = mlp_stack(cfg.projector_layers, backbone_dim(backbone_cfg),
                              cfg.mlp_dim, cfg.dim, use_bn=cfg.projector_bn,
                              generator=gen)
        self.base = Tower(encoder, projector)
        self.momentum = copy.deepcopy(self.base).requires_grad_(False)
        self.predictor = (mlp_stack(cfg.predictor_layers, cfg.dim,
                                    cfg.mlp_dim, cfg.dim,
                                    last_bn=cfg.predictor_last_bn,
                                    use_bn=cfg.projector_bn, generator=gen)
                          if cfg.use_predictor else nn.Sequential())
        queue = torch.randn(cfg.dim, cfg.K, generator=gen)
        self.register_buffer("queue",
                             queue / queue.norm(dim=0, keepdim=True))
        self.register_buffer("queue_ptr", torch.zeros((), dtype=torch.long))

    def trainable(self):
        """(name, parameter) of the base tower and the predictor: what the
        optimizer steps."""
        return itertools.chain(self.base.named_parameters(prefix="base"),
                               self.predictor.named_parameters(
                                   prefix="predictor"))

    @torch.no_grad()
    def ema_update(self, m: float) -> None:
        """momentum <- m * momentum + (1 - m) * base over the parameters
        only: BatchNorm running statistics are buffers and stay the
        momentum tower's own (``_ema_update``, :228)."""
        mom = list(self.momentum.parameters())
        torch._foreach_mul_(mom, m)
        torch._foreach_add_(mom, list(self.base.parameters()), alpha=1.0 - m)

    @torch.no_grad()
    def enqueue(self, keys: torch.Tensor) -> None:
        """Write the (B, dim) keys into the ring at ``queue_ptr`` and
        advance it by B mod K, on the device without a host sync (K % B
        == 0 keeps the slice inside the queue)."""
        B = keys.shape[0]
        idx = self.queue_ptr + torch.arange(B, device=keys.device)
        self.queue.index_copy_(1, idx, keys.t().to(self.queue.dtype))
        self.queue_ptr.add_(B).remainder_(self.cfg.K)


def encode(tower: Tower, imgs: torch.Tensor, backbone_cfg, *,
           compute_dtype: torch.dtype, stop_grad_conv1: bool = False,
           remat: bool = False, reference: bool = False,
           attn_backend: str | None = None) -> torch.Tensor:
    """Encoder features in training mode (a ConvStem's and a ResNet's
    BatchNorms on batch statistics), then the projector (``_encode``).
    ``attn_backend="xla"`` runs a ViT's blocks on JAX's XLA route."""
    if isinstance(backbone_cfg, vit_mod.ViTConfig):
        feats = tower.encoder(imgs, compute_dtype=compute_dtype,
                              reference=reference, remat=remat,
                              stop_grad_conv1=stop_grad_conv1,
                              bn_training=True, attn_backend=attn_backend)
    else:
        feats = tower.encoder(imgs, compute_dtype=compute_dtype,
                              training=True, remat=remat)
    return mlp_apply(tower.projector, feats)


def l2norm(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x.float(), dim=-1, keepdim=True)


def forward_v2_queue(model: MoCo, im_q, im_k, m: float, *,
                     compute_dtype=torch.bfloat16, remat: bool = False,
                     reference: bool = False,
                     attn_backend: str | None = None):
    """The v2 queue loss (``forward_v2_queue``, :261) -> (loss, keys). The
    caller enqueues the keys after the backward, which needs the queue as
    this pass read it."""
    cfg, bcfg = model.cfg, model.backbone_cfg
    B = im_k.shape[0]
    if cfg.K % B != 0:
        raise ValueError(
            f"queue length K={cfg.K} must be divisible by the global key "
            f"batch ({B}); the ring enqueue assumes K % batch == 0")
    kw = dict(compute_dtype=compute_dtype, reference=reference,
              attn_backend=attn_backend)
    model.ema_update(m)
    zq = encode(model.base, im_q, bcfg, stop_grad_conv1=cfg.stop_grad_conv1,
                remat=remat, **kw)
    q = l2norm(mlp_apply(model.predictor, zq))
    with torch.no_grad():
        zk = encode(model.momentum, im_k, bcfg, **kw)
        if cfg.predictor_on_keys:
            # the predictor's BatchNorm statistics move a second time
            zk = mlp_apply(model.predictor, zk)
        k = l2norm(zk)
    l_pos = (q * k).sum(-1, keepdim=True)
    l_neg = q @ model.queue
    logits = torch.cat([l_pos, l_neg], 1) / cfg.T
    labels = torch.zeros(B, dtype=torch.long, device=logits.device)
    return F.cross_entropy(logits, labels), k


def contrastive_v3(q: torch.Tensor, k: torch.Tensor, T: float):
    """One half of the symmetric loss (``_contrastive_v3``, :337):
    in-batch negatives, the diagonal positive, scaled by 2T."""
    q, k = l2norm(q), l2norm(k).detach()
    logits = q @ k.t() / T
    labels = torch.arange(q.shape[0], device=q.device)
    return F.cross_entropy(logits, labels) * (2.0 * T)


def forward_v3_symmetric(model: MoCo, x1, x2, m: float, *,
                         compute_dtype=torch.bfloat16, remat: bool = False,
                         reference: bool = False,
                         attn_backend: str | None = None):
    """ctr(q1, k2) + ctr(q2, k1) (``forward_v3_symmetric``, :356) ->
    (loss, None): both views through both towers, the queue unused."""
    cfg, bcfg = model.cfg, model.backbone_cfg
    kw = dict(compute_dtype=compute_dtype, reference=reference,
              attn_backend=attn_backend)
    model.ema_update(m)
    q1, q2 = (mlp_apply(model.predictor, encode(
        model.base, x, bcfg, stop_grad_conv1=cfg.stop_grad_conv1,
        remat=remat, **kw)) for x in (x1, x2))
    with torch.no_grad():
        k1, k2 = (encode(model.momentum, x, bcfg, **kw) for x in (x1, x2))
    loss = contrastive_v3(q1, k2, cfg.T) + contrastive_v3(q2, k1, cfg.T)
    return loss, None


LOSSES = {"v2_queue": forward_v2_queue, "v3_symmetric": forward_v3_symmetric}


def make_pretrain_step(cfg: MoCoConfig, *,
                       compute_dtype: torch.dtype = torch.bfloat16,
                       remat: bool = False, reference: bool = False,
                       attn_backend: str | None = None) -> Callable:
    """``step(model, opt, im_q, im_k, m) -> loss`` (detached, on the
    device, unsynchronised): the forward of ``cfg.loss``, the backward, one
    step of ``opt`` (a ``train.optim.Scheduled`` over ``model.
    trainable()``), then the enqueue. ``remat`` recomputes the query
    pass's blocks in the backward; ``reference`` runs the plain versions
    of the kernels, ``attn_backend="xla"`` JAX's XLA route."""
    if cfg.loss not in LOSSES:
        raise ValueError(f"unknown loss {cfg.loss!r}")
    fwd = LOSSES[cfg.loss]

    def step(model: MoCo, opt, im_q, im_k, m: float):
        loss, keys = fwd(model, im_q, im_k, m, compute_dtype=compute_dtype,
                         remat=remat, reference=reference,
                         attn_backend=attn_backend)
        opt.zero_grad()
        loss.backward()
        opt.step()
        if keys is not None:
            model.enqueue(keys)
        return loss.detach()

    return step

