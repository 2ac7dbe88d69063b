"""CLI plumbing shared by the entry points (the flags ``infer`` uses, from
``mfvit_tpu/cli/common.py``), plus ``--device``."""
from __future__ import annotations

import argparse

import torch

from mfvit_tpu_torch.data import datasets, host_transforms as ht, pipeline
from mfvit_tpu_torch.nn import vit as vit_mod


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("-a", "--arch", default="vit_small",
                   choices=sorted(vit_mod.CONFIGS) + ["vit_test"])
    p.add_argument("-j", "--workers", default=8, type=int)
    p.add_argument("-b", "--batch-size", default=16, type=int)
    p.add_argument("--img-size", dest="img_size", type=int, default=224)
    p.add_argument("--crop", dest="crop", type=int, default=224)
    p.add_argument("--maintain-ratio", dest="maintain_ratio",
                   action="store_true")
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises where CUDA is missing")


def get_vit_arch(args) -> vit_mod.ViTConfig:
    """The network input size is the post-crop size (the eval transform
    resizes to --img-size, then center-crops to --crop)."""
    input_size = args.crop or args.img_size
    if args.arch == "vit_test":  # tiny config for smoke tests
        return vit_mod.ViTConfig("vit_test", img_size=input_size, patch=16,
                                 dim=32, depth=2, heads=2)
    return vit_mod.get_config(args.arch, input_size)


def compute_dtype(args) -> torch.dtype:
    return torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available here "
                           "(pass --device cpu to run the plain versions)")
    return device


def make_paired_eval_loader(args, manifest_path: str) -> pipeline.BatchLoader:
    """CXR ('data') + enhanced ('Train_Mix') eval canvases in manifest
    order, the final batch wrap-padded."""
    tf = ht.CanvasTransform(img_size=args.img_size, crop=args.crop,
                            maintain_ratio=args.maintain_ratio)
    ds = datasets.CovidPairedDataset(manifest_path, tf)
    return pipeline.BatchLoader(ds, args.batch_size,
                                num_workers=args.workers)
