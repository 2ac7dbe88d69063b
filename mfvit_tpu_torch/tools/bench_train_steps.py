"""Training-step rates on device-resident synthetic batches, the port of
``tools/bench_train_steps.py``.

    python -m mfvit_tpu_torch.tools.bench_train_steps \\
        [ft fusion fusion_lp moco vit_base] [--device cuda]

The setups are JAX's (:51-116), each built from seeded
``torch.Generator``s, images N(0, 1) in bf16 at 224 px, labels 0:

- ``ft``: the vit_small classifier step (``train.steps.
  make_classifier_steps``), B=256, SGD 0.01 with momentum 0.9 (per step
  K1 12, K2 11, K3 1 forward, K5 12, K7 12 backward);
- ``fusion``: the MF-ViT CA step (``make_fusion_steps``), B=256 pairs,
  Adam 1e-4, the whole network trained (K1 24, K2 22, K3 2, K4 1, K5 24,
  K7 24);
- ``fusion_lp``: the same with ``freeze_backbones`` and only the branch
  heads and the fusion head trainable (JAX's ``head_only_mask`` per
  branch, :72-79): the forward alone in the branches (no K5 or K7);
- ``moco``: the MoCo v2-queue step (``ssl.moco.make_pretrain_step``) on
  ``MoCoConfig()`` (the queue of 65,536), AdamW 1.5e-4 with weight decay
  0.1, m = 0.99 (JAX :86-101; not the LARS step of the pretrain CLI), B=256
  (K1 24, K2 22, K3 2 over both towers, K5 12, K7 12);
- ``vit_base``: the classifier step at vit_base, B=64.

Each runs 2 warm-up steps with the loss fetched, then 12 steps with the
loss fetched one step behind (``card.lag_seconds``, JAX :28-48), and
prints ms a step and images (pairs) a second. ``--device cpu`` runs the
plain versions (a smoke test, not a measurement of any device).
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Callable

import torch
from torch import nn

from mfvit_tpu_torch.cli import common
from mfvit_tpu_torch.models import fusion
from mfvit_tpu_torch.nn import vit
from mfvit_tpu_torch.ssl import moco
from mfvit_tpu_torch.tools import card
from mfvit_tpu_torch.train import optim, steps

WHICH = ("ft", "fusion", "fusion_lp", "moco", "vit_base")
ITERS, WARMUP = 12, 2


@dataclasses.dataclass
class Setup:
    """One timed step: ``run()`` takes one step on ``batch`` and returns
    its loss (on the device); ``model`` and ``opt`` are what it steps."""
    name: str
    model: nn.Module
    opt: optim.Scheduled
    step: Callable
    batch: tuple

    def run(self) -> torch.Tensor:
        return self.step(self.model, self.opt, *self.batch)


def _images(B: int, cfg, device, seed: int, dt: torch.dtype):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B, cfg.img_size, cfg.img_size, 3,
                       generator=g).to(dt).to(device)


def _loss_only(step):
    return lambda *a: step(*a)[0]


def setup_ft(device, arch: str = "vit_small", B: int = 256, *, cfg=None,
             dt: torch.dtype = torch.bfloat16) -> Setup:
    cfg = cfg or vit.get_config(arch)
    model = vit.ViT(cfg, 3, generator=torch.Generator().manual_seed(0)
                    ).to(device)
    opt = optim.build_optimizer("sgd", model.named_parameters(), 0.01,
                                momentum=0.9)
    train_step, _ = steps.make_classifier_steps(compute_dtype=dt)
    batch = (_images(B, cfg, device, 1, dt),
             torch.zeros(B, dtype=torch.long, device=device))
    return Setup(arch, model, opt, _loss_only(train_step), batch)


def lp_mask(named_params) -> dict:
    """JAX's fusion_lp mask (:72-79): each branch's ``head_only_mask``,
    the whole fusion head."""
    return {name: name.startswith("fus.") or name.split(".")[1] == "head"
            for name, _ in named_params}


def setup_fusion(device, B: int = 256, freeze: bool = False, *, cfg=None,
                 dt: torch.dtype = torch.bfloat16) -> Setup:
    cfg = cfg or vit.get_config("vit_small")
    g = [torch.Generator().manual_seed(i) for i in range(3)]
    models = nn.ModuleDict({
        "cxr": vit.ViT(cfg, 3, generator=g[0]),
        "enh": vit.ViT(cfg, 3, generator=g[1]),
        "fus": fusion.Fusion(3, cfg.dim, 3, generator=g[2]),  # JAX's heads
    }).to(device)
    mask = lp_mask(models.named_parameters()) if freeze else None
    opt = optim.build_optimizer("adam", models.named_parameters(), 1e-4,
                                trainable_mask=mask)
    train_step, _ = steps.make_fusion_steps(compute_dtype=dt,
                                            freeze_backbones=freeze)
    img = _images(B, cfg, device, 1, dt)
    batch = (img, img, torch.zeros(B, dtype=torch.long, device=device))
    return Setup("fusion_lp" if freeze else "fusion", models, opt,
                 _loss_only(train_step), batch)


def setup_moco(device, B: int = 256, *, cfg=None, mcfg=None,
               dt: torch.dtype = torch.bfloat16) -> Setup:
    cfg = cfg or vit.get_config("vit_small")
    mcfg = mcfg or moco.MoCoConfig()  # the v2 queue, K=65536
    model = moco.MoCo(mcfg, cfg, generator=torch.Generator().manual_seed(0)
                      ).to(device)
    opt = optim.build_optimizer("adamw", model.trainable(), 1.5e-4,
                                weight_decay=0.1)
    step = moco.make_pretrain_step(mcfg, compute_dtype=dt)
    batch = (_images(B, cfg, device, 1, dt), _images(B, cfg, device, 2, dt),
             0.99)
    return Setup("moco", model, opt, step, batch)


def setups(which, device) -> list:
    make = {"ft": lambda: setup_ft(device),
            "fusion": lambda: setup_fusion(device),
            "fusion_lp": lambda: setup_fusion(device, freeze=True),
            "moco": lambda: setup_moco(device),
            "vit_base": lambda: setup_ft(device, "vit_base", 64)}
    return [make[w] for w in WHICH if w in which]


def timeit(s: Setup, iters: int = ITERS, warmup: int = WARMUP) -> dict:
    """{"ms_per_step", "per_sec"} of ``s``, printed as JAX prints it."""
    sec = card.lag_seconds(s.run, iters, warmup)
    b = s.batch[0].shape[0]
    print(f"{s.name:10s} {sec * 1000:7.1f} ms/step  {b / sec:7.0f} "
          "img|pairs/s", flush=True)
    return {"ms_per_step": sec * 1e3, "per_sec": b / sec}


def run(device, which=WHICH, iters: int = ITERS,
        warmup: int = WARMUP) -> dict:
    """{setup name: timeit's row}, the setups built one at a time and
    freed before the next."""
    out = {}
    for make in setups(which, device):
        s = make()
        out[s.name] = timeit(s, iters, warmup)
        del s
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("mfvit-torch-bench-train-steps")
    p.add_argument("which", nargs="*", metavar="{" + ",".join(WHICH) + "}",
                   help="the setups to time (default: all)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises where CUDA is missing")
    return p


def main(argv=None) -> dict:
    p = build_parser()
    args = p.parse_args(argv)
    unknown = sorted(set(args.which) - set(WHICH))
    if unknown:
        p.error(f"unknown setups {unknown}; choose from {list(WHICH)}")
    device = common.resolve_device(args.device)
    card.note(device)
    return run(device, args.which or WHICH)


if __name__ == "__main__":
    main()
