"""Convert the JAX package's orbax checkpoints into the port's torch files.

    python -m mfvit_tpu_torch.tools.convert_orbax SRC DST --kind serving \\
        -a vit_small [--crop 224] [--fusion-arch gpt --gpt-layers 8]
    python -m mfvit_tpu_torch.tools.convert_orbax SRC DST --kind branch \\
        -a vit_small
    python -m mfvit_tpu_torch.tools.convert_orbax SRC DST --kind pretrain \\
        -a vit_small --optimizer lars [--moco-dim 256 --moco-mlp-dim 4096 \\
        --moco-k 65536 ...]

Run it on the host that wrote the checkpoint: orbax writes through
``tensorstore``, so that host has it, and this tool needs only it, torch
and numpy (no JAX, no orbax). Then move DST to the host with the card.

- ``serving``: JAX ``fuse``'s ``model_best`` ``{'cxr', 'enh', 'fus'}`` ->
  a ``save_serving`` file, which ``infer --checkpoint`` reads (the same
  ``--fusion-arch``, ``--gpt-layers`` and depths as JAX ``infer``'s);
- ``branch``: JAX ``finetune``'s ``model_best`` (a ViT tree with its head)
  -> a ViT state dict file, which ``fuse --pretrained-cxr`` and
  ``--pretrained-enh`` read;
- ``pretrain``: JAX ``pretrain``'s ``checkpoint_{epoch:04d}`` (state,
  optimizer state, epoch) or ``checkpoint_best_loss`` (state, epoch) -> a
  ``save_pretrain_checkpoint`` file, which ``pretrain --resume`` (given an
  optimizer state) and ``finetune --pretrained`` read. ``--optimizer`` and
  the MoCo flags are those of the JAX run; the resumed run takes its
  hyperparameters from its own flags, as optax's state holds none.

Each kind loads what it wrote into the model its flags build (strictly),
as JAX's ``restore(like=...)`` checks the tree, and fails on a mismatch.
It uses ``exp/orbax_io.py``, the weight bridges of ``exp/checkpoint.py``
and ``train.optim.opt_state_from_jax`` and nothing else of the port's
training code.
"""
from __future__ import annotations

import argparse

import torch

from mfvit_tpu_torch.cli import common, pretrain
from mfvit_tpu_torch.exp import checkpoint as ckpt_mod
from mfvit_tpu_torch.exp import orbax_io
from mfvit_tpu_torch.nn import resnet as resnet_mod
from mfvit_tpu_torch.nn import vit as vit_mod
from mfvit_tpu_torch.ssl import moco
from mfvit_tpu_torch.train import optim


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("mfvit-torch-convert-orbax")
    p.add_argument("src", help="the JAX orbax checkpoint directory")
    p.add_argument("dst", help="the torch file to write")
    p.add_argument("--kind", required=True, choices=orbax_io.KINDS)
    p.add_argument("-a", "--arch", default="vit_small",
                   choices=sorted(vit_mod.CONFIGS) + sorted(resnet_mod.CONFIGS)
                   + ["vit_test"])
    p.add_argument("--img-size", dest="img_size", type=int, default=224)
    p.add_argument("--crop", dest="crop", type=int, default=224)
    p.add_argument("--in-chans", dest="in_chans", type=int, default=3,
                   choices=[3, 4])
    p.add_argument("--optimizer", default="lars",
                   choices=["lars", "adamw", "adam", "sgd"],
                   help="the JAX pretrain run's optimizer (--kind pretrain)")
    common.add_fusion_args(p)
    pretrain.add_moco_args(p)
    return p


def convert_serving(args) -> None:
    cfg = common.get_vit_arch(args)
    ck = ckpt_mod.load_serving(args.src, cfg, args.fusion_arch)
    for k in ("cxr", "enh"):
        vit_mod.ViT(cfg, args.num_classes).load_state_dict(ck[k],
                                                           strict=True)
    common.fusion_head(args, cfg).load_state_dict(ck["fus"], strict=True)
    ckpt_mod.save_serving(args.dst, ck["cxr"], ck["enh"], ck["fus"])


def convert_branch(args) -> None:
    cfg = common.get_vit_arch(args)
    sd = ckpt_mod.vit_state_from_jax(orbax_io.read_tree(args.src, "branch"),
                                     cfg)
    vit_mod.ViT(cfg, args.num_classes).load_state_dict(sd, strict=True)
    torch.save(sd, args.dst)


def convert_pretrain(args) -> None:
    model = moco.MoCo(pretrain.moco_config(args), common.get_arch(args),
                      in_chans=args.in_chans)
    opt = optim.build_optimizer(args.optimizer, model.trainable(), 0.0)
    ck = ckpt_mod.load_pretrain_checkpoint(args.src, model, opt)
    model.load_state_dict(ck["state"], strict=True)
    if "opt_state" in ck:
        opt.load_state_dict(ck["opt_state"])
    ckpt_mod.save_pretrain_checkpoint(
        args.dst, model, epoch=ck["epoch"],
        opt=opt if "opt_state" in ck else None)


CONVERT = {"serving": convert_serving, "branch": convert_branch,
           "pretrain": convert_pretrain}


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)
    CONVERT[args.kind](args)
    print(f"=> {args.src} -> {args.dst} ({args.kind})")
    return args.dst


if __name__ == "__main__":
    main()
