"""ResNet-18/34/50, the MoCo arms of the port of ``mfvit_tpu/nn/resnet.py``.

Modules and parameter names are torchvision's (``conv1``, ``bn1``,
``layer{1..4}.{b}.conv{1,2[,3]}``/``bn*``, ``downsample.0``/``.1``,
``fc``), so a torchvision state dict loads as it is (``--pretrained-arms``,
``exp/checkpoint.py::load_resnet_arms``). The images are NHWC, as JAX's;
each convolution's fp32 sums are rounded to the compute dtype, each
BatchNorm takes fp32 statistics (``nn.layers.batch_norm``), the stride of a
bottleneck sits on its 3x3 convolution (torchvision v1.5), and the
features are the fp32 mean over the last map. The convolutions are
``torch.nn.functional.conv2d``: they are XLA convolutions in JAX, not
Pallas kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from mfvit_tpu_torch.nn.layers import batch_norm


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    name: str = "resnet18"
    block: str = "basic"              # basic | bottleneck
    layers: Sequence[int] = (2, 2, 2, 2)
    width: int = 64
    in_chans: int = 3

    @property
    def expansion(self) -> int:
        return 1 if self.block == "basic" else 4

    @property
    def out_dim(self) -> int:
        return self.width * 8 * self.expansion


CONFIGS = {
    "resnet18": ResNetConfig("resnet18", "basic", (2, 2, 2, 2)),
    "resnet34": ResNetConfig("resnet34", "basic", (3, 4, 6, 3)),
    "resnet50": ResNetConfig("resnet50", "bottleneck", (3, 4, 6, 3)),
}


def get_config(name: str, in_chans: int = 3) -> ResNetConfig:
    cfg = CONFIGS[name]
    if in_chans != 3:
        cfg = dataclasses.replace(cfg, in_chans=in_chans)
    return cfg


def _conv(conv: nn.Conv2d, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Symmetric (k - 1) // 2 padding, torch's and JAX's ``_conv``'s."""
    k = conv.weight.shape[-1]
    return F.conv2d(x, conv.weight.to(x.dtype), stride=stride,
                    padding=(k - 1) // 2)


class Block(nn.Module):
    """A basic (two 3x3) or bottleneck (1x1, 3x3, 1x1) residual block."""

    def __init__(self, kind: str, cin: int, cout: int, stride: int):
        super().__init__()
        self.kind, self.stride = kind, stride
        if kind == "basic":
            shapes, out_c = [(cin, cout, 3), (cout, cout, 3)], cout
        else:
            out_c = cout * 4
            shapes = [(cin, cout, 1), (cout, cout, 3), (cout, out_c, 1)]
        for i, (a, b, k) in enumerate(shapes, 1):
            setattr(self, f"conv{i}", nn.Conv2d(a, b, k, bias=False))
            setattr(self, f"bn{i}", nn.BatchNorm2d(b))
        self.n = len(shapes)
        self.downsample = (nn.Sequential(nn.Conv2d(cin, out_c, 1, bias=False),
                                         nn.BatchNorm2d(out_c))
                           if stride != 1 or cin != out_c else None)

    def forward(self, x: torch.Tensor, training: bool,
                momentum: float = 0.1) -> torch.Tensor:
        h = x
        # the stride: the first conv of a basic block, the 3x3 of a
        # bottleneck
        at = 1 if self.kind == "basic" else 2
        for i in range(1, self.n + 1):
            h = _conv(getattr(self, f"conv{i}"), h,
                      self.stride if i == at else 1)
            h = batch_norm(getattr(self, f"bn{i}"), h, training=training,
                           momentum=momentum)
            if i < self.n:
                h = F.relu(h)
        identity = x
        if self.downsample is not None:
            identity = batch_norm(self.downsample[1],
                                  _conv(self.downsample[0], x, self.stride),
                                  training=training, momentum=momentum)
        return F.relu(h + identity)


def _once(blk: Block):
    """``blk`` for ``checkpoint``: the first call (the forward) moves the
    running statistics, the recompute in the backward does not."""
    calls = []

    def run(x, training):
        calls.append(None)
        return blk(x, training, 0.1 if len(calls) == 1 else 0.0)

    return run


class ResNet(nn.Module):
    """Built on the CPU from ``generator`` (a CPU ``torch.Generator``;
    seed 0 when omitted), with torchvision's init: He fan-out normal
    convolutions, unit BatchNorms, a N(0, 0.01) head."""

    def __init__(self, cfg: ResNetConfig, num_classes: int = 0, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.conv1 = nn.Conv2d(cfg.in_chans, cfg.width, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(cfg.width)
        cin = cfg.width
        for stage, nblocks in enumerate(cfg.layers):
            cout = cfg.width * 2 ** stage
            blocks = []
            for b in range(nblocks):
                blocks.append(Block(cfg.block, cin, cout,
                                    2 if stage > 0 and b == 0 else 1))
                cin = cout * cfg.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.fc = nn.Linear(cfg.out_dim, num_classes) if num_classes else None
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                fan_out = mod.out_channels * mod.weight[0, 0].numel()
                nn.init.normal_(mod.weight, std=(2.0 / fan_out) ** 0.5,
                                generator=generator)
            elif isinstance(mod, nn.BatchNorm2d):
                mod.reset_parameters()
        if self.fc is not None:
            nn.init.normal_(self.fc.weight, std=0.01, generator=generator)
            nn.init.zeros_(self.fc.bias)

    def forward(self, imgs: torch.Tensor, *,
                compute_dtype: torch.dtype = torch.bfloat16,
                training: bool = False, remat: bool = False) -> torch.Tensor:
        """NHWC images -> the fp32 pooled features (B, out_dim), or the
        logits with a head. ``training`` normalises with batch statistics
        and moves the running ones; ``remat`` recomputes each residual
        block in the backward, where its BatchNorms leave the running
        statistics as the forward left them (JAX's ``jax.checkpoint`` is
        pure)."""
        x = imgs.to(compute_dtype).permute(0, 3, 1, 2)
        x = _conv(self.conv1, x, 2)
        x = F.relu(batch_norm(self.bn1, x, training=training))
        x = F.max_pool2d(x, 3, 2, 1)
        for stage in range(len(self.cfg.layers)):
            for blk in getattr(self, f"layer{stage + 1}"):
                if remat and torch.is_grad_enabled():
                    x = torch.utils.checkpoint.checkpoint(
                        _once(blk), x, training, use_reentrant=False)
                else:
                    x = blk(x, training)
        feat = x.float().mean((2, 3))
        return feat if self.fc is None else self.fc(feat)
