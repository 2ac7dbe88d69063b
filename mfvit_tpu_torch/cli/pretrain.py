"""MoCo pretraining entry point, the port of ``mfvit_tpu/cli/pretrain.py``:
per (ratio, draw) a fresh MoCo state (v3 structure; the v2 queue loss by
default, ``--loss v3_symmetric`` for the symmetric one) over the unlabeled
split, LARS/AdamW/Adam/SGD with the per-step cosine LR and its warmup
(``--cos``), the cosine momentum ramp (``--moco-m-cos``), two augmented
views per image, the smallest-epoch-loss checkpoint and one every
``--save-epoch`` epochs (with the optimizer state, for ``--resume``), and
``--export-torch``'s reference ``.pth.tar``, which ``finetune
--pretrained`` reads.

    python -m mfvit_tpu_torch.cli.pretrain -a vit_small -b 256 --cos \\
        --optimizer lars --lr 0.6 --epochs 100 --warmup-epochs 10 \\
        --stop-grad-conv1 --moco-m-cos --moco-t 0.2 \\
        --covid-ds create_covid_dataset --export-torch [--device cuda]

The inputs: the canvases of ``--folder`` (the default ``--aug-setting
chexpert``) or of the stacked CXR-gray + Enh image (``--in-chans 4``,
normalised as ``4ch``), or the host-transformed float views of the BYOL
stacks (``--aug-setting moco_v1|moco_v2|aug1|aug2`` with ``--crop-min``),
of the cross-modal pairs (``--pairing enh_cxr``: q the enhanced image, k
the CXR, ``--per-enh`` the rate of enhanced queries) and of ``--aug-host``
(the full host stack twice), which go to the device as float32 and are
cast there. The canvases, by default (square resize), are decoded once
into the device canvas store, and each step gathers its images there and
draws q's flip, rotation and crop, then k's, from the (draw, epoch)
generator of ``data/device_aug.py``; ``--maintain-ratio``,
``--device-store-mb 0`` or a split over the budget stream two
host-augmented canvases per image (host-cropped under ``--aug-order
crop-first``).

On CUDA every block of both towers runs K1 and K2 (K3 on the last)
forward and the query tower's K5 and K7 backward, whatever the input; a
ResNet arm (``-a resnet18/34/50``, ``--pretrained-arms``) runs no kernel
of the port. ``--resume`` takes the port's own ``checkpoint_{epoch:04d}``
file or the JAX package's orbax directory of that name (its state,
optimizer state and epoch; ``exp/orbax_io.py`` reads it where
``tensorstore`` is importable, else ``tools/convert_orbax.py --kind
pretrain`` on the host that wrote it gives the file), and starts at the
next epoch. Not ported yet, and refused with a message (ROADMAP.md
section 1): ``--distributed`` (item 6), TensorBoard (item 8).
"""
from __future__ import annotations

import argparse
import math

import torch

from mfvit_tpu_torch.cli import common
from mfvit_tpu_torch.data import device_aug
from mfvit_tpu_torch.data import manifest as mf
from mfvit_tpu_torch.exp import checkpoint as ckpt_mod
from mfvit_tpu_torch.exp import harness, storage
from mfvit_tpu_torch.ssl import moco
from mfvit_tpu_torch.train import metrics, optim, profiler


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("mfvit-torch-pretrain")
    common.add_common_args(p)
    common.add_train_args(p)
    p.add_argument("--optimizer", default="lars",
                   choices=["lars", "adamw", "adam", "sgd"])
    p.add_argument("--warmup-epochs", default=10, type=int)
    p.add_argument("--moco-m-cos", action="store_true")
    add_moco_args(p)
    p.add_argument("--folder", default="data")
    p.add_argument("--pairing", default="same", choices=["same", "enh_cxr"],
                   help="enh_cxr: cross-modal q=Enh / k=CXR views")
    p.add_argument("--per-enh", dest="per_enh", type=float, default=1.0,
                   help="P(q is the Enh image) for --pairing enh_cxr")
    p.add_argument("--save-epoch", type=int, default=30)
    p.add_argument("--pretrained-arms", dest="pretrained_arms", default="",
                   type=str,
                   help="local torchvision resnet state dict for BOTH MoCo "
                        "towers' encoders; resnet archs only")
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--export-torch", action="store_true",
                   help="also write the reference-layout .pth.tar "
                        "(module.base_encoder.* + projector head) that "
                        "finetune --pretrained reads (ViT archs)")
    p.set_defaults(epochs=100, lr=0.6, batch_size=16)
    return p


def add_moco_args(p: argparse.ArgumentParser) -> None:
    """The MoCo model's flags (``moco_config``), which ``pretrain`` and the
    converter's ``pretrain`` kind read."""
    p.add_argument("--moco-dim", default=256, type=int)
    p.add_argument("--moco-mlp-dim", default=4096, type=int)
    p.add_argument("--moco-m", default=0.99, type=float)
    p.add_argument("--moco-t", default=1.0, type=float)
    p.add_argument("--moco-k", default=65536, type=int,
                   help="queue length (v2 loss)")
    p.add_argument("--stop-grad-conv1", dest="stop_grad_conv1",
                   action="store_true")
    p.add_argument("--loss", default="v2_queue",
                   choices=["v2_queue", "v3_symmetric"])
    p.add_argument("--no-predictor-on-keys", dest="predictor_on_keys",
                   action="store_false",
                   help="no predictor on the keys (the reference's "
                        "noprediction_q variant)")


def moco_config(args) -> moco.MoCoConfig:
    kw = dict(dim=args.moco_dim, mlp_dim=args.moco_mlp_dim, K=args.moco_k,
              T=args.moco_t, m=args.moco_m, loss=args.loss,
              predictor_on_keys=args.predictor_on_keys)
    if args.arch.startswith("resnet"):
        return moco.MoCoConfig.resnet(**kw)
    return moco.MoCoConfig(stop_grad_conv1=args.stop_grad_conv1, **kw)


def train_one_draw_fn(args, backbone_cfg, device):
    dt = common.compute_dtype(args)
    store_budget = common.StoreBudget(args.device_store_mb)

    def train_one_draw(ratio, draw, sub_folder):
        cfg = moco_config(args)
        # pretraining reads the UNLABELED split at fractional ratios
        man = (mf.split_manifest_path(args.covid_ds, 1, 0)
               if float(ratio) == 1.0 else
               mf.split_manifest_path(args.covid_ds, ratio, draw,
                                      labeled=False))
        tl, host_transformed = make_loader(args, man, draw)
        img_type = "4ch" if args.in_chans == 4 else args.folder
        store = None
        if not host_transformed:
            store = common.maybe_device_store(
                args, man, args.folder, fourch=args.in_chans == 4,
                seed=draw, budget=store_budget, device=device)
        if store is not None:
            tl = store
        steps_per_epoch = max(len(tl), 1)
        if cfg.loss == "v2_queue" and cfg.K % args.batch_size != 0:
            raise ValueError(
                f"K={cfg.K} must be divisible by batch {args.batch_size}")
        init_lr = optim.scaled_init_lr(args.lr, args.batch_size,
                                       cos=args.cos, entry="pretrain")
        sched = (optim.pretrain_cosine_lr(init_lr, args.epochs,
                                          args.warmup_epochs,
                                          steps_per_epoch)
                 if args.cos else
                 optim.finetune_lr(init_lr, args.epochs, cos=False,
                                   schedule=args.schedule,
                                   steps_per_epoch=steps_per_epoch))
        seed = args.seed if args.seed is not None else 0
        model = moco.MoCo(cfg, backbone_cfg, in_chans=args.in_chans,
                          generator=torch.Generator()
                          .manual_seed(seed * 1000 + draw))
        if args.pretrained_arms:
            ckpt_mod.load_resnet_arms(model, args.pretrained_arms)
            print(f"=> MoCo arms initialized from {args.pretrained_arms}")
        model.to(device)
        opt = optim.build_optimizer(args.optimizer, model.trainable(), sched,
                                    weight_decay=args.weight_decay,
                                    momentum=args.momentum)
        step = moco.make_pretrain_step(cfg, compute_dtype=dt,
                                       remat=args.remat,
                                       attn_backend=args.attn_backend)

        start_epoch = args.start_epoch
        if args.resume:
            ck = ckpt_mod.load_pretrain_checkpoint(args.resume, model, opt)
            if "opt_state" not in ck:
                raise ValueError(f"--resume {args.resume}: no optimizer "
                                 "state (resume from a "
                                 "checkpoint_{epoch:04d}, not "
                                 "checkpoint_best_loss)")
            model.load_state_dict(ck["state"])
            opt.load_state_dict(ck["opt_state"])
            start_epoch = ck["epoch"] + 1
            print(f"=> resumed from {args.resume} at epoch {start_epoch}")

        best_loss = math.inf
        result = harness.DrawResult(ratio, draw)
        losses = result.extra["train_losses"] = []
        ep_loss = metrics.AverageMeter("Loss", ":.4e")

        def record(val, n, idx):
            ep_loss.update(val, n)
            losses.append(val)

        for epoch in range(start_epoch, args.epochs):
            gen = device_aug.epoch_generator(seed, draw, epoch, device)
            tl.set_epoch(epoch)
            ep_loss = metrics.AverageMeter("Loss", ":.4e")
            timer = profiler.StepTimer(steps_per_epoch,
                                       prefix=f"Epoch: [{epoch}]",
                                       extra_meters=[ep_loss])
            fetch = metrics.DeferredFetch(record)
            for i, batch in enumerate(common.store_batch_iter(store, tl,
                                                              device)):
                timer.data_ready()
                m = (optim.moco_momentum(epoch + i / steps_per_epoch,
                                         args.moco_m, args.epochs)
                     if args.moco_m_cos else args.moco_m)
                if store is not None:
                    canv, _labels = store.gather(batch)
                    q, k = common.device_train_two_views(args, gen, canv,
                                                         img_type)
                elif host_transformed:
                    q, k = batch[0].to(dt), batch[1].to(dt)
                else:
                    q, k = common.stream_train_two_views(
                        args, batch[0], batch[1], img_type, gen)
                loss = step(model, opt, q, k, m)
                # one-step-lagged fetch: no host sync per step
                fetch.push(loss, int(q.shape[0]), i, sync=(i == 0))
                timer.step_done(i, args.print_freq)
            fetch.flush()
            print(f"[ratio {ratio} draw {draw}] epoch {epoch}: "
                  f"loss {ep_loss.avg:.4f}")
            if ep_loss.avg < best_loss:
                best_loss = ep_loss.avg
                ckpt_mod.save_pretrain_checkpoint(
                    str(sub_folder / "checkpoint_best_loss"), model,
                    epoch=epoch)
            if epoch == args.epochs - 1 or (epoch + 1) % args.save_epoch == 0:
                ckpt_mod.save_pretrain_checkpoint(
                    str(sub_folder / f"checkpoint_{epoch:04d}"), model,
                    epoch=epoch, opt=opt)
        if args.export_torch:
            if args.arch.startswith("resnet"):
                print("--export-torch: resnet towers have no vits.py "
                      "layout; skipping torch export")
            elif storage.is_primary():
                ckpt_mod.save_moco_torch_checkpoint(
                    str(sub_folder / "checkpoint_torch.pth.tar"), model,
                    epoch=args.epochs - 1, arch=args.arch)
        result.extra["final_loss"] = ep_loss.avg
        result.extra["best_loss"] = best_loss
        common.release_store(store)
        return result

    return train_one_draw


def make_loader(args, man: str, draw: int):
    """The streaming feed of one draw and whether its views arrive
    host-transformed (float: BYOL, ``enh_cxr``, ``--aug-host``) rather than
    as canvases, by JAX's branches (``mfvit_tpu/cli/pretrain.py:108-131``)
    and with its errors."""
    byol = args.aug_setting in common.BYOL_VARIANT
    fourch = args.in_chans == 4
    if args.pairing == "enh_cxr":
        if fourch or byol:
            raise ValueError("--pairing enh_cxr is a 3-channel "
                             "chexpert-stack variant")
        return common.make_enh_cxr_ssl_loader(args, man, seed=draw), True
    if byol:
        if fourch:
            raise ValueError("--in-chans 4 requires --aug-setting "
                             "chexpert (device-aug canvases)")
        return common.make_ssl_two_crops_loader(args, man, args.folder,
                                                seed=draw), True
    return (common.make_covid_loader(args, man, args.folder, training=True,
                                     ssl_two_views=True, fourch=fourch,
                                     seed=draw),
            not common.device_aug_on(args))


def check_ported(args) -> None:
    """Refuse, before any work, what this port does not run yet."""
    if args.distributed:
        raise SystemExit("--distributed is not ported yet (ROADMAP.md "
                         "section 1, item 6)")


def main(argv=None):
    args = build_parser().parse_args(argv)
    check_ported(args)
    common.print_route(args)
    device = common.resolve_device(args.device)
    backbone_cfg = common.get_arch(args)
    if args.export_torch and (getattr(backbone_cfg, "conv_stem", False)
                              or not getattr(backbone_cfg, "qkv_bias", True)
                              or args.in_chans != 3):
        # fail fast, as JAX's main: the export writes the plain vits.py
        # layout, and finding out after the whole grid would waste it
        raise SystemExit(
            f"--export-torch does not support -a {args.arch} "
            f"--in-chans {args.in_chans}: the torch export writes the "
            "plain 3-channel vits.py layout (no conv-stem, biased qkv) "
            "the reference finetune surgery loads. Drop --export-torch "
            "or use a vit_small/vit_base/_ori arch with --in-chans 3.")
    if args.pretrained_arms and not args.arch.startswith("resnet"):
        raise SystemExit("--pretrained-arms is resnet-only; ViT "
                         "pretraining starts from scratch")
    folder = storage.get_storage_folder(args.exp_name, "moco",
                                        root=args.storage_root)
    harness.snapshot_args(folder, args)
    iterations = ({mf.ratio_tag(r): args.draws for r in args.semi_ratios}
                  if args.draws else None)
    ratios = [mf.ratio_tag(r) for r in args.semi_ratios]
    return harness.run_draws(folder, ratios,
                             train_one_draw_fn(args, backbone_cfg, device),
                             iterations=iterations)


if __name__ == "__main__":
    main()
