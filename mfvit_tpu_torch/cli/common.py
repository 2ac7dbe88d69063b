"""CLI plumbing shared by the entry points (the flags ``infer``,
``finetune``, ``fuse`` and ``pretrain`` use, from
``mfvit_tpu/cli/common.py``), plus ``--device``: the streaming training
feeds (one flavour, MoCo's two views, paired, or the 4-channel stacked
input), MoCo's host-transformed feeds (the BYOL stacks, the cross-modal
pairs), and the eval runner."""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from mfvit_tpu_torch.data import datasets, device_aug, host_transforms as ht
from mfvit_tpu_torch.data import pipeline
from mfvit_tpu_torch.models import fusion, gpt_fusion
from mfvit_tpu_torch.nn import resnet as resnet_mod
from mfvit_tpu_torch.nn import vit as vit_mod
from mfvit_tpu_torch.train.evaluator import Evaluator


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("-a", "--arch", default="vit_small",
                   choices=sorted(vit_mod.CONFIGS) + sorted(resnet_mod.CONFIGS)
                   + ["vit_test"])
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


def add_train_args(p: argparse.ArgumentParser) -> None:
    """The training flags of ``mfvit_tpu/cli/common.py::add_common_args``
    that ``finetune`` reads, same names and defaults."""
    p.add_argument("--epochs", default=100, type=int)
    p.add_argument("--start-epoch", default=0, type=int)
    p.add_argument("--lr", "--learning-rate", default=0.6, type=float,
                   dest="lr")
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--wd", "--weight-decay", default=1e-6, type=float,
                   dest="weight_decay")
    p.add_argument("-p", "--print-freq", default=10, type=int)
    p.add_argument("--seed", default=None, type=int)
    p.add_argument("--exp-name", dest="exp_name", type=str, default="exp")
    p.add_argument("--storage-root", type=str, default=None,
                   help="experiment storage root (MFVIT_STORAGE_ROOT)")
    p.add_argument("--rotate", dest="rotate", default=10, type=float,
                   nargs="?", const=1.0,
                   help="rotation degrees; bare flag = +-1 degree (the "
                        "reference finetune bool quirk)")
    p.add_argument("--cos", action="store_true")
    p.add_argument("--schedule", default=[12, 18, 24], nargs="*", type=int)
    p.add_argument("--covid-ds", dest="covid_ds", type=str,
                   default="create_covid_dataset",
                   help="folder with split manifests + val_ds/test_ds")
    p.add_argument("--semi-ratios", nargs="*", type=float, default=[1.0],
                   help="labeled fractions")
    p.add_argument("--draws", type=int, default=None,
                   help="override #draws per ratio")
    p.add_argument("--remat", action="store_true",
                   help="recompute the transformer blocks in the backward "
                        "(torch.utils.checkpoint)")
    p.add_argument("--resume", default="", type=str)
    p.add_argument("--aug-setting", default="chexpert",
                   choices=["moco_v1", "moco_v2", "chexpert", "aug1", "aug2"])
    p.add_argument("--crop-min", dest="crop_min", default=0.08, type=float)
    p.add_argument("--in-chans", dest="in_chans", type=int, default=3,
                   choices=[3, 4],
                   help="4 = stacked CXR-gray + Enh input (pretrain "
                        "only)")


def get_arch(args):
    """The backbone config of ``-a``: a ``ViTConfig``, or a
    ``ResNetConfig`` for the ResNet MoCo arms. The network input size is
    the post-crop size (the eval transform resizes to --img-size, then
    center-crops to --crop)."""
    if args.arch.startswith("resnet"):
        return resnet_mod.get_config(args.arch,
                                     in_chans=getattr(args, "in_chans", 3))
    input_size = args.crop or args.img_size
    if args.arch == "vit_test":  # tiny config for smoke tests
        return vit_mod.ViTConfig("vit_test", img_size=input_size, patch=16,
                                 dim=32, depth=2, heads=2)
    return vit_mod.get_config(args.arch, input_size)


def get_vit_arch(args) -> vit_mod.ViTConfig:
    """ViT-only entry points (``finetune``, ``fuse``, ``infer``), as in
    JAX: ResNet arms and ``--in-chans 4`` are pretrain-only."""
    if args.arch.startswith("resnet"):
        raise SystemExit(f"-a {args.arch}: resnet backbones are "
                         "pretrain-only (the reference finetune/fusion "
                         "mains are ViT-only)")
    if getattr(args, "in_chans", 3) != 3:
        raise SystemExit("--in-chans 4 is a pretrain-only variant; "
                         "finetune/fuse/infer are 3-channel")
    return get_arch(args)


def gpt_fusion_cfg(args, cfg) -> gpt_fusion.GPTFusionConfig:
    """The GPT fusion config matched to the ViT branches
    (``mfvit_tpu/cli/common.py:275-286``), one construction shared by
    ``fuse`` and ``infer``: width ``cfg.dim``, ``--gpt-layers`` blocks and
    anchors on the patch grid, so a ``--fusion-arch gpt`` checkpoint
    loads into the head it was trained with."""
    return dataclasses.replace(gpt_fusion.VIT_CONFIG, n_embd=cfg.dim,
                               n_layer=args.gpt_layers,
                               vert_anchors=cfg.grid, horz_anchors=cfg.grid)


def fusion_head(args, cfg, generator=None) -> torch.nn.Module:
    """The fusion head of ``--fusion-arch``, as ``fuse`` trains it and
    ``infer`` serves it: the CA ``Fusion`` or the ``GPTFusion`` of
    ``gpt_fusion_cfg``."""
    if args.fusion_arch == "gpt":
        return gpt_fusion.GPTFusion(gpt_fusion_cfg(args, cfg),
                                    args.num_classes, generator=generator)
    return fusion.Fusion(args.num_classes, cfg.dim, args.fusion_heads,
                         args.cross_attn_depth, args.multi_scale_enc_depth,
                         generator=generator)


def compute_dtype(args) -> torch.dtype:
    return torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available here "
                           "(pass --device cpu to run the plain versions)")
    return device


def make_paired_loader(args, manifest_path: str, *, training: bool = False,
                       seed: int = 0) -> pipeline.BatchLoader:
    """(CXR ('data'), enhanced ('Train_Mix'), label) canvases over a COVID
    manifest. Eval (the default): center crops in manifest order, the final
    batch wrap-padded. ``training``: each branch gets its own host
    transform, seeded ``seed`` and ``seed + 1`` as in
    ``mfvit_tpu/cli/common.py::make_covid_loader`` (:507-512, :527-529),
    fully augmented in the reference order (flip -> rotate -> crop),
    shuffled per epoch, the last short batch dropped."""
    def tf(seed_off: int) -> ht.CanvasTransform:
        aug = (dict(training=True, rotate_deg=float(args.rotate),
                    seed=seed + seed_off) if training else {})
        return ht.CanvasTransform(img_size=args.img_size, crop=args.crop,
                                  maintain_ratio=args.maintain_ratio, **aug)
    ds = datasets.CovidPairedDataset(manifest_path, tf(0),
                                     tf(1) if training else None)
    return pipeline.BatchLoader(ds, args.batch_size, shuffle=training,
                                seed=seed, drop_last=training,
                                num_workers=args.workers)


def make_covid_loader(args, manifest_path: str, folder: str, *,
                      training: bool, ssl_two_views: bool = False,
                      fourch: bool = False,
                      seed: int = 0) -> pipeline.BatchLoader:
    """Single-flavour canvases over a COVID manifest (the streaming feed of
    ``mfvit_tpu/cli/common.py::make_covid_loader`` :475-560 with its
    defaults ``--aug-device``, ``--aug-order reference``): training
    canvases come fully augmented from the host in the reference order
    (flip -> rotate -> crop), shuffled per epoch, the last short batch
    dropped; eval canvases are center crops in manifest order, the last
    batch padded. ``ssl_two_views``: (q, k, label), two independently
    augmented canvases of each image (:513-523). ``fourch``: the stacked
    4-channel canvases of each row's ``folder`` and 'Train_Mix' images
    (:517-526)."""
    tf = ht.CanvasTransform(img_size=args.img_size, crop=args.crop,
                            maintain_ratio=args.maintain_ratio,
                            training=training,
                            rotate_deg=float(args.rotate), seed=seed)
    if fourch:
        kind = (datasets.Covid4chTwoCropsDataset if ssl_two_views
                else datasets.Covid4chDataset)
        ds = kind(manifest_path, tf, folder_cxr=folder)
    else:
        kind = (datasets.CovidTwoCropsDataset if ssl_two_views
                else datasets.CovidDataset)
        ds = kind(folder, manifest_path, tf)
    return pipeline.BatchLoader(ds, args.batch_size, shuffle=training,
                                seed=seed, drop_last=training,
                                num_workers=args.workers)


BYOL_VARIANT = {"moco_v1": "aug1", "aug1": "aug1",
                "moco_v2": "aug2", "aug2": "aug2"}


def make_ssl_two_crops_loader(args, manifest_path: str, folder: str, *,
                              seed: int = 0) -> pipeline.BatchLoader:
    """MoCo's host-transformed two-view feed for the BYOL
    ``--aug-setting``s (``mfvit_tpu/cli/common.py:151``): (q, k, label),
    two independent draws of the aug1 (``moco_v1``) or aug2 (``moco_v2``)
    stack per image, normalised float32 HWC."""
    tf = ht.ByolTransform(img_size=args.img_size, crop_min=args.crop_min,
                          variant=BYOL_VARIANT[args.aug_setting], seed=seed)
    ds = datasets.CovidTwoCropsDataset(folder, manifest_path, tf)
    return pipeline.BatchLoader(ds, args.batch_size, shuffle=True, seed=seed,
                                drop_last=True, num_workers=args.workers)


def make_enh_cxr_ssl_loader(args, manifest_path: str, *,
                            seed: int = 0) -> pipeline.BatchLoader:
    """MoCo's cross-modal feed (``--pairing enh_cxr``,
    ``mfvit_tpu/cli/common.py:166``): (q, k, label) with q the enhanced
    view and k the CXR view, each through its own full host stack and
    normalisation (seeds ``seed`` for 'data', ``seed + 1`` for
    'Train_Mix'); ``--per-enh`` < 1 swaps the query for the CXR at that
    rate. Normalised float32 HWC: the flavour is chosen per sample."""
    def tf(img_type: str, seed_off: int) -> ht.ChexpertTransform:
        return ht.ChexpertTransform(
            img_size=args.img_size, crop=args.crop, img_type=img_type,
            training=True, maintain_ratio=args.maintain_ratio,
            rotate_deg=float(args.rotate), seed=seed + seed_off)
    ds = datasets.CovidEnhCxrDataset(manifest_path, tf("data", 0),
                                     tf("Train_Mix", 1),
                                     per_enh=getattr(args, "per_enh", 1.0),
                                     seed=seed)
    return pipeline.BatchLoader(ds, args.batch_size, shuffle=True, seed=seed,
                                drop_last=True, num_workers=args.workers)


def stream_train_view(args, canv: torch.Tensor, img_type: str):
    """The device half of one streaming training batch: the host already
    augmented the canvases, so only the normalisation remains."""
    return device_aug.augment_batch(canv, img_type=img_type,
                                    out_dtype=compute_dtype(args))


def stream_train_two_views(args, canv_q: torch.Tensor,
                           canv_k: torch.Tensor, img_type: str):
    """The two-view twin of ``stream_train_view``
    (``mfvit_tpu/cli/common.py:325``): both canvases arrive augmented,
    each is normalised."""
    return (stream_train_view(args, canv_q, img_type),
            stream_train_view(args, canv_k, img_type))


def make_eval_runner(args, img_types, forward, device) -> Evaluator:
    """The eval loop of the CLIs: each image field of a batch normalised
    on ``device`` for its flavour, ``forward(*imgs) -> logits``, the
    padded tail trimmed, AUC and top-1 on the host."""
    dt = compute_dtype(args)

    def batch_forward(batch):
        *imgs, labels = batch
        xs = [device_aug.augment_batch(torch.from_numpy(img).to(device),
                                       img_type=flavor, out_dtype=dt)
              for img, flavor in zip(imgs, img_types)]
        return forward(*xs).float().cpu().numpy(), np.asarray(labels)

    return Evaluator(batch_forward, metric_names=["auc", "acc"])


def make_param_evaluate(args, img_types, eval_step, device):
    """``evaluate(model, loader, *, n_total) -> Evaluator result`` over
    ``eval_step(model, *imgs) -> logits``, the runner built once."""
    cell = {"model": None}
    runner = make_eval_runner(
        args, img_types, lambda *xs: eval_step(cell["model"], *xs), device)

    def evaluate(model, loader, *, n_total: int):
        cell["model"] = model
        return runner.evaluate(loader, n_total=n_total)

    return evaluate
