"""CLI plumbing shared by the entry points (the flags ``infer``,
``finetune``, ``fuse`` and ``pretrain`` use, from
``mfvit_tpu/cli/common.py``), plus ``--device``: the device canvas stores
(``--device-store-mb``, train and eval, under one budget) and the views
drawn from them, the streaming training feeds (one flavour, MoCo's two
views, paired, or the 4-channel stacked input; host-augmented in the
reference order, host-cropped under ``--aug-order crop-first``, or the
full host stack under ``--aug-host``), MoCo's host-transformed feeds (the
BYOL stacks, the cross-modal pairs), the decode cache
(``--canvas-cache-mb``) and the eval runner; and the multi-process plumbing
of ``mfvit_tpu/cli/common.py:555-760`` (``add_dist_args``,
``maybe_init_distributed``, ``setup_mesh``, ``primary_process_prints_only``
and ``--mesh-devices``) over ``parallel/dist.py``."""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Optional

import numpy as np
import torch

from mfvit_tpu_torch.data import datasets, device_aug, device_store
from mfvit_tpu_torch.data import host_transforms as ht
from mfvit_tpu_torch.data import pipeline
from mfvit_tpu_torch.models import fusion, gpt_fusion
from mfvit_tpu_torch.nn import resnet as resnet_mod
from mfvit_tpu_torch.nn import vit as vit_mod
from mfvit_tpu_torch.nn import xla_route
from mfvit_tpu_torch.parallel import dist
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
    p.add_argument("--attn-backend", default=None,
                   choices=list(xla_route.ATTN_BACKENDS),
                   help="attention backend, JAX's choices: unset, auto and "
                        "pallas run the port's own kernels (JAX's auto "
                        "picks Pallas only on a TPU; the card is the "
                        "port's platform, so its auto picks the port's "
                        "kernels), their plain versions on the CPU; xla "
                        "runs JAX's XLA route in eager torch ops (unfused "
                        "blocks, fp32 softmax, the fusion head's "
                        "full-sequence encode), no kernel")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises where CUDA is missing")
    p.add_argument("--aug-device", action="store_true", default=True,
                   help="device-fused augmentation (default)")
    p.add_argument("--aug-host", dest="aug_device", action="store_false",
                   help="full host-side torchvision-parity augmentation")
    p.add_argument("--aug-order", default="reference",
                   choices=["reference", "crop-first"],
                   help="training aug order for the streaming device feed:"
                        " 'reference' = flip->rotate->crop on the host;"
                        " 'crop-first' = a host crop, then flip and rotation"
                        " of the crop on the device (the ablation)")
    p.add_argument("--canvas-cache-mb", type=int, default=4096,
                   help="RAM budget for the decode+resize canvas cache "
                        "(epoch >= 2 skips PNG decode); 0 disables")
    p.add_argument("--no-canvas-cache", dest="canvas_cache",
                   action="store_false", default=True,
                   help="disable the host decode+resize cache")
    p.add_argument("--device-store-mb", type=int, default=2048,
                   help="total device-memory budget shared by all "
                        "device-resident canvas stores of a run (train + "
                        "val + test); epochs then run host-free after a "
                        "one-time fill. 0 disables. Training store: "
                        "device-aug square-resize (no --maintain-ratio) "
                        "runs, sharded over the ranks when there are several;"
                        " eval stores: any resize policy")
    p.add_argument("--mesh-devices", type=int, default=None,
                   help="#devices of the data axis (default: the most "
                        "visible cards that divide the batch). In one "
                        "process N > 1 spawns N ranks on cuda:0..N-1 (gloo "
                        "ranks under --device cpu) for the training CLIs, "
                        "and N replicas for infer; under a process group it "
                        "must be the world size")


def add_dist_args(p: argparse.ArgumentParser) -> None:
    """The rendezvous flags of a multi-process run
    (``mfvit_tpu/cli/common.py:563-578``): start the same command in every
    process, each with its own ``--dist-process-id``, or under torchrun
    with ``--distributed`` alone (``env://``)."""
    p.add_argument("--dist-coordinator", default=None, type=str,
                   help="rendezvous address host:port (omit under torchrun, "
                        "whose environment gives it)")
    p.add_argument("--dist-num-processes", default=None, type=int)
    p.add_argument("--dist-process-id", default=None, type=int)
    p.add_argument("--distributed", action="store_true",
                   help="join a torch.distributed process group (implied "
                        "by any other --dist-* flag)")


def maybe_init_distributed(args) -> bool:
    """Join the process group when any rendezvous flag is set
    (``mfvit_tpu/cli/common.py:581-596``), on NCCL for ``--device cuda`` and
    gloo for ``--device cpu``, and silence ``print`` on every rank but 0.
    Returns True when the group came up; a failed rendezvous raises."""
    if not (args.distributed or args.dist_coordinator is not None
            or args.dist_num_processes is not None
            or args.dist_process_id is not None):
        return False
    dist.init_distributed(args.dist_coordinator,
                          num_processes=args.dist_num_processes,
                          process_id=args.dist_process_id,
                          device_type=torch.device(args.device).type)
    primary_process_prints_only()
    return True


def setup_mesh(args) -> int:
    """The number of devices of the data axis (``mfvit_tpu/cli/common.py::
    setup_mesh``, :599-636). Under a process group: its world size, which
    ``--mesh-devices`` must equal. In one process: ``--mesh-devices``, or
    the largest count of visible cards that divides the batch (1 under
    ``--device cpu``). Above 1 the global batch must divide evenly."""
    if dist.world() > 1:
        n = dist.world()
        if args.mesh_devices not in (None, n):
            raise SystemExit(f"--mesh-devices {args.mesh_devices} under {n} "
                             "processes: the data axis must span all "
                             f"{n} ranks")
        dist.assert_divisible(args.batch_size, n)
        return n
    if args.mesh_devices is None:
        avail = (torch.cuda.device_count()
                 if torch.device(args.device).type == "cuda"
                 and torch.cuda.is_available() else 1)
        n = next(d for d in range(max(avail, 1), 0, -1)
                 if args.batch_size % d == 0)
    else:
        n = args.mesh_devices
    if n > 1:
        dist.assert_divisible(args.batch_size, n)
    return n


def primary_process_prints_only() -> None:
    """Silence ``print`` on every rank but 0, as the reference does for its
    DDP workers (pretrain main :220-223); files are gated on
    ``exp.storage.is_primary``."""
    import builtins
    if dist.world() > 1 and dist.rank() != 0:
        builtins.print = lambda *a, **k: None


def maybe_spawn(args, module: str, argv) -> Optional[list]:
    """A training CLI's ``--mesh-devices N`` > 1 in one process: ``module``'s
    ``main`` over ``argv`` on N spawned ranks (``dist.spawn_ranks``).
    Returns rank 0's result once every rank returned the same, or None
    where this process runs the training itself (one device, or a rank of
    a group)."""
    n = setup_mesh(args)
    if n == 1 or dist.active():
        return None
    outs = dist.spawn_ranks(module, sys.argv[1:] if argv is None else argv,
                            n, torch.device(args.device).type)
    for r, out in enumerate(outs[1:], 1):
        if repr(out) != repr(outs[0]):
            raise RuntimeError(f"rank {r} returned other results than rank "
                               f"0: {out!r} against {outs[0]!r}")
    print(f"=> {n} ranks returned the same results")
    return outs[0]


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


def add_fusion_args(p: argparse.ArgumentParser) -> None:
    """The fusion head's flags of ``fuse`` and ``infer`` (and the
    converter's ``serving`` kind), which a checkpoint's head must match."""
    p.add_argument("--fusion-arch", default="ca", choices=["ca", "gpt"],
                   help="fusion head: 'ca' = MF-ViT CA CLS cross-attention; "
                        "'gpt' = TransFuser-style joint-sequence GPT; a "
                        "checkpoint's must match")
    p.add_argument("--gpt-layers", type=int, default=8,
                   help="GPT fusion depth (GlobalConfig n_layer)")
    p.add_argument("--fusion-heads", type=int, default=3)
    p.add_argument("--cross-attn-depth", type=int, default=1)
    p.add_argument("--multi-scale-enc-depth", type=int, default=1)
    p.add_argument("--num-classes", type=int, default=3)


def print_route(args) -> None:
    """A run's first line: which attention route ``--attn-backend`` takes
    (``nn.xla_route.describe``)."""
    print(xla_route.describe(args.attn_backend), flush=True)


def resolve_device(name: str) -> torch.device:
    """``--device``; under a process group this rank's device."""
    if dist.active():
        return dist.device()
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available here "
                           "(pass --device cpu to run the plain versions)")
    return device


def device_aug_on(args) -> bool:
    """False under ``--aug-host`` (namespaces without the flag: True)."""
    return getattr(args, "aug_device", True)


def host_reference_aug(args) -> bool:
    """True when the streaming training feed augments on the host in the
    reference order (the default); False under ``--aug-order
    crop-first``."""
    return getattr(args, "aug_order", "reference") == "reference"


def decode_cache(args, maintain_ratio: bool):
    """The run's shared decode + resize cache of one resize policy, or None
    under ``--no-canvas-cache`` or ``--canvas-cache-mb 0``."""
    mb = getattr(args, "canvas_cache_mb", 0)
    if getattr(args, "canvas_cache", True) and mb > 0:
        return ht.shared_decode_cache(args.img_size, maintain_ratio,
                                      mb << 20)
    return None


def _canvas_tf(args, training: bool, seed: int) -> ht.CanvasTransform:
    """The streaming feed's canvas transform: in training the reference
    order on the host, or under ``--aug-order crop-first`` the random crop
    alone (the device flips and rotates it)."""
    host_ref = training and host_reference_aug(args)
    return ht.CanvasTransform(
        img_size=args.img_size, crop=args.crop, training=training,
        maintain_ratio=args.maintain_ratio,
        rotate_deg=float(args.rotate) if host_ref else 0.0, hflip=host_ref,
        seed=seed)


def _host_tf(args, img_type: str, training: bool,
             seed: int) -> ht.ChexpertTransform:
    """``--aug-host``'s full host stack: normalised float32 HWC (eval
    takes no ``--rotate``: ``infer`` has none)."""
    return ht.ChexpertTransform(
        img_size=args.img_size, crop=args.crop, img_type=img_type,
        training=training, maintain_ratio=args.maintain_ratio,
        rotate_deg=float(args.rotate) if training else 0.0, seed=seed)


def make_paired_loader(args, manifest_path: str, *, training: bool = False,
                       seed: int = 0) -> pipeline.BatchLoader:
    """(CXR ('data'), enhanced ('Train_Mix'), label) over a COVID manifest
    (``mfvit_tpu/cli/common.py::make_covid_loader`` with ``paired``). Eval
    (the default): center crops in manifest order, the final batch
    wrap-padded. ``training``: each branch gets its own host transform,
    seeded ``seed`` and ``seed + 1``, shuffled per epoch, the last short
    batch dropped. uint8 canvases, or under ``--aug-host`` each branch's
    full host stack, normalised with its flavour."""
    decode = decode_cache(args, args.maintain_ratio)
    if device_aug_on(args):
        tfs = [_canvas_tf(args, training, seed + off) for off in (0, 1)]
    else:
        tfs = [_host_tf(args, flavor, training, seed + off)
               for off, flavor in enumerate(("data", "Train_Mix"))]
    ds = datasets.CovidPairedDataset(manifest_path, *tfs, decode=decode)
    return pipeline.BatchLoader(ds, args.batch_size, shuffle=training,
                                seed=seed, drop_last=training,
                                num_workers=args.workers)


def make_covid_loader(args, manifest_path: str, folder: str, *,
                      training: bool, ssl_two_views: bool = False,
                      fourch: bool = False,
                      seed: int = 0) -> pipeline.BatchLoader:
    """Single-flavour canvases over a COVID manifest (the streaming feed of
    ``mfvit_tpu/cli/common.py::make_covid_loader`` :475-560): training
    canvases come augmented from the host in the reference order (flip ->
    rotate -> crop; under ``--aug-order crop-first`` only cropped),
    shuffled per epoch, the last short batch dropped; eval canvases are
    center crops in manifest order, the last batch padded.
    ``ssl_two_views``: (q, k, label), two independent draws of each image
    (:513-523). ``fourch``: the stacked 4-channel canvases of each row's
    ``folder`` and 'Train_Mix' images (:517-526). ``--aug-host``: the full
    host stack, normalised float32 (:533-556)."""
    decode = decode_cache(args, args.maintain_ratio)
    if device_aug_on(args):
        tf = _canvas_tf(args, training, seed)
        if fourch:
            kind = (datasets.Covid4chTwoCropsDataset if ssl_two_views
                    else datasets.Covid4chDataset)
            ds = kind(manifest_path, tf, folder_cxr=folder, decode=decode)
        else:
            kind = (datasets.CovidTwoCropsDataset if ssl_two_views
                    else datasets.CovidDataset)
            ds = kind(folder, manifest_path, tf, decode=decode)
    else:
        if fourch:
            raise ValueError("--in-chans 4 requires the device-aug path "
                             "(the reference has no host transform stack "
                             "for the 4ch variant either — no main invokes "
                             "builder_4ch)")
        kind = (datasets.CovidTwoCropsDataset if ssl_two_views
                else datasets.CovidDataset)
        ds = kind(folder, manifest_path, _host_tf(args, folder, training,
                                                  seed), decode=decode)
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
    ds = datasets.CovidEnhCxrDataset(
        manifest_path, _host_tf(args, "data", True, seed),
        _host_tf(args, "Train_Mix", True, seed + 1),
        per_enh=getattr(args, "per_enh", 1.0), seed=seed,
        decode=decode_cache(args, args.maintain_ratio))
    return pipeline.BatchLoader(ds, args.batch_size, shuffle=True, seed=seed,
                                drop_last=True, num_workers=args.workers)


class StoreBudget:
    """One device-memory budget (``--device-store-mb``) for every store
    resident at once in a run (train, val and test). A draw's train store
    returns its reservation when the draw ends (``release_store``)."""

    def __init__(self, mb: int):
        self.left = mb << 20

    def reserve(self, nbytes: int) -> bool:
        if nbytes > self.left:
            return False
        self.left -= nbytes
        return True

    def release(self, nbytes: int) -> None:
        self.left += nbytes


def _store_nbytes(n: int, side: int, chans: int, ranks: int = 1) -> int:
    """Device bytes a store of ``n`` samples pins on this rank: the uint8
    canvases and an int64 label each, of the samples padded by wrapping to
    a multiple of ``ranks`` and split evenly over them
    (``mfvit_tpu/cli/common.py:214-229``)."""
    padded = n + (-n % ranks)
    return padded // ranks * (side * side * chans + 8)


def release_store(store) -> None:
    """Return a draw's store reservation to its budget (no-op on None)."""
    res = getattr(store, "budget_reservation", None)
    if res is not None:
        budget, nbytes = res
        budget.release(nbytes)
        store.budget_reservation = None


def store_batch_iter(store, loader, device):
    """A training epoch's feed: the store's index vectors, or the
    streaming loader's batches moved to ``device`` one step ahead."""
    if store is not None:
        return store.iter_index_batches()
    return pipeline.device_prefetch(iter(loader), device)


def lazy_eval_stores(args, val_man: str, test_man: str, folder: str, *,
                     device, paired: bool = False,
                     budget: StoreBudget = None):
    """``get() -> (val store, test store)``, each None where not built:
    built on first use and kept for the whole (ratio, draw) grid (the eval
    canvases do not depend on the draw). Callers reserve the draw's train
    store first, so the hot loop keeps the store when the budget is
    short."""
    cache = {}

    def get():
        if "v" not in cache:
            cache["v"], cache["s"] = (
                maybe_eval_device_store(args, man, folder, paired=paired,
                                        budget=budget, device=device)
                for man in (val_man, test_man))
        return cache["v"], cache["s"]

    return get


def stream_train_view(args, canv: torch.Tensor, img_type: str,
                      generator: torch.Generator = None):
    """The device half of one streaming training batch. Reference order
    (the default): the host already augmented the canvases, so only the
    normalisation remains. ``--aug-order crop-first``: flip and rotation
    of the host crop, drawn from ``generator`` for the global batch."""
    if host_reference_aug(args):
        return device_aug.augment_batch(canv, img_type=img_type,
                                        out_dtype=compute_dtype(args))
    return device_aug.augment_batch(canv, img_type=img_type, training=True,
                                    rotate_deg=float(args.rotate),
                                    out_dtype=compute_dtype(args),
                                    generator=generator, world=dist.world(),
                                    rank=dist.rank())


def stream_train_two_views(args, canv_q: torch.Tensor,
                           canv_k: torch.Tensor, img_type: str,
                           generator: torch.Generator = None):
    """The two-view twin of ``stream_train_view``
    (``mfvit_tpu/cli/common.py:325``): each canvas arrives augmented (or,
    crop-first, cropped) on its own, q's view first."""
    return (stream_train_view(args, canv_q, img_type, generator),
            stream_train_view(args, canv_k, img_type, generator))


def _train_crop(args) -> int:
    return min(args.crop or args.img_size, args.img_size)


def device_train_view(args, generator: torch.Generator,
                      canv: torch.Tensor, img_type: str):
    """One reference-order training view (flip -> rotate about the full
    canvas center -> random crop -> normalise) of store canvases, drawn
    for the global batch."""
    return device_aug.augment_train_canvas(
        generator, canv, crop=_train_crop(args), img_type=img_type,
        rotate_deg=float(args.rotate), out_dtype=compute_dtype(args),
        world=dist.world(), rank=dist.rank())


def device_train_two_views(args, generator: torch.Generator,
                           canv: torch.Tensor, img_type: str):
    """Two independent reference-order views of each store canvas
    (TwoCropsTransform on the store paths), drawn for the global batch."""
    return device_aug.augment_two_views_canvas(
        generator, canv, crop=_train_crop(args), img_type=img_type,
        rotate_deg=float(args.rotate), out_dtype=compute_dtype(args),
        world=dist.world(), rank=dist.rank())


def maybe_device_store(args, manifest_path: str, folder: str, *, device,
                       fourch: bool = False, paired: bool = False,
                       seed: int = 0, budget: StoreBudget = None):
    """The training store of one draw, or None where it does not apply:
    ``--aug-host``, ``--maintain-ratio`` (the canvases must be square
    before the crop), ``--device-store-mb 0``, or a split over the budget
    (which prints so and streams)."""
    if (not device_aug_on(args) or args.maintain_ratio
            or getattr(args, "device_store_mb", 0) <= 0):
        return None
    chans = 4 if fourch else (6 if paired else 3)  # paired: 2 flavours
    fill_tf = ht.CanvasTransform(img_size=args.img_size, training=False,
                                 maintain_ratio=False, seed=seed)
    decode = decode_cache(args, False)
    if fourch:
        ds = datasets.Covid4chDataset(manifest_path, fill_tf,
                                      folder_cxr=folder, decode=decode)
    elif paired:
        ds = datasets.CovidPairedDataset(manifest_path, fill_tf, fill_tf,
                                         folder_cxr=folder, decode=decode)
    else:
        ds = datasets.CovidDataset(folder, manifest_path, fill_tf,
                                   decode=decode)
    if budget is None:
        budget = StoreBudget(args.device_store_mb)
    nbytes = _store_nbytes(len(ds), args.img_size, chans, dist.world())
    if not budget.reserve(nbytes):
        print("=> device canvas store: does not fit --device-store-mb "
              "budget; streaming feed for this draw")
        return None
    store = device_store.fill_from_dataset(
        ds, batch_size=args.batch_size, seed=seed, num_workers=args.workers,
        device=device)
    store.budget_reservation = (budget, nbytes)
    print(f"=> device canvas store: {store.n} samples "
          f"({store.nbytes >> 20} MB) resident in HBM; "
          "epochs run host-free")
    return store


def maybe_eval_device_store(args, manifest_path: str, folder: str, *,
                            device, paired: bool = False, seed: int = 0,
                            budget: StoreBudget = None):
    """The eval twin of ``maybe_device_store``: center-cropped canvases in
    manifest order, the final batch wrap-padded (the evaluator trims it
    with ``len(store.ds)``); any resize policy. Off under more than one
    rank, as in JAX (:424-447): a store of the whole split on every rank
    would enter each sample once a rank into the gathered eval batch;
    the streaming eval feed takes each rank's rows."""
    if not device_aug_on(args) or getattr(args, "device_store_mb", 0) <= 0:
        return None
    if dist.world() > 1:
        print("=> eval device canvas store: disabled on multi-process "
              "runs; streaming eval feed")
        return None
    fill_tf = ht.CanvasTransform(img_size=args.img_size, crop=args.crop,
                                 training=False,
                                 maintain_ratio=args.maintain_ratio,
                                 seed=seed)
    decode = decode_cache(args, args.maintain_ratio)
    if paired:
        ds = datasets.CovidPairedDataset(manifest_path, fill_tf, fill_tf,
                                         folder_cxr=folder, decode=decode)
    else:
        ds = datasets.CovidDataset(folder, manifest_path, fill_tf,
                                   decode=decode)
    side = args.crop or args.img_size
    if budget is None:
        budget = StoreBudget(args.device_store_mb)
    if not budget.reserve(_store_nbytes(len(ds), side, 6 if paired else 3)):
        print("=> eval device canvas store: does not fit "
              "--device-store-mb budget; streaming eval feed")
        return None
    store = device_store.fill_from_dataset(
        ds, batch_size=args.batch_size, seed=seed, shuffle=False,
        drop_last=False, num_workers=args.workers, device=device, world=1,
        rank=0)
    print(f"=> eval device canvas store: {store.n} samples "
          f"({store.nbytes >> 20} MB) resident")
    return store


def make_eval_runner(args, img_types, forward, device) -> Evaluator:
    """The eval loop of the CLIs: each image field of a batch on
    ``device`` -- an eval store's batches are there already -- normalised
    for its flavour (``--aug-host`` batches are normalised host floats,
    only cast), ``forward(*imgs) -> logits``, the padded tail trimmed, AUC
    and top-1 on the host. Under a process group each rank runs its row
    block of every batch and the logits and labels are all-gathered
    (``mfvit_tpu/cli/common.py:671-730``), so every rank computes the same
    metrics and takes the same best-val decisions."""
    dt = compute_dtype(args)

    def batch_forward(batch):
        *imgs, labels = batch
        xs = []
        for img, flavor in zip(imgs, img_types):
            x = torch.as_tensor(img).to(device)
            xs.append(device_aug.augment_batch(x, img_type=flavor,
                                               out_dtype=dt)
                      if device_aug_on(args) else x.to(dt))
        logits = dist.all_gather_rows(forward(*xs).float())
        labels = torch.as_tensor(labels)
        if dist.world() > 1:
            labels = dist.all_gather_rows(labels.to(device))
        return logits.cpu().numpy(), labels.cpu().numpy()

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
