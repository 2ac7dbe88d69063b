"""MF-ViT fusion training, the port of ``mfvit_tpu/cli/fuse.py``: two
ViT branches loaded from their fine-tuned checkpoints, the CLS
cross-attention fusion head (or, under ``--fusion-arch gpt``, the
TransFuser-style joint-sequence GPT head of ``--gpt-layers`` blocks),
decision logits fused + cxr + enh, the LP freeze of both branches
(bodies and heads) unless ``--semi-supervised``, the per-epoch cosine or
milestone LR, val AUC every epoch, the best-val-AUC ``model_best`` with
test AUC/acc on each improvement, a paired CXR + enhanced dataset indexed
jointly, and the LP frozen-branch check.

    python -m mfvit_tpu_torch.cli.fuse -a vit_small -b 32 --lr 1.5e-4 \\
        --cos --epochs 25 --maintain-ratio --covid-ds create_covid_dataset \\
        --pretrained-cxr cxr/model_best --pretrained-enh enh/model_best \\
        [--semi-supervised] [--fusion-arch gpt [--gpt-layers 8]]
        [--device cuda]

On CUDA both branches run K1/K2/K3 forward and the CA head K4 (the GPT
head is plain PyTorch, as it is XLA in JAX); under LP the branches run
without autograd, so only the head's backward runs (K4's plain
recompute); ``--semi-supervised`` trains everything through K5 and K7 as
well. The ``model_best`` of each draw (``mfvit_ca/train_{ratio}_{draw}``,
both heads) is the flat state dict of the ``nn.ModuleDict({"cxr", "enh",
"fus"})``, which ``cli/infer.py --checkpoint`` serves as it is (with the
same ``--fusion-arch`` and ``--gpt-layers``).

The feed is JAX's: by default (square resize) each draw's pairs are
decoded once into the paired device canvas store, and a step gathers both
flavours there, then draws the CXR view and then the enhanced view from
the (draw, epoch) generator of ``data/device_aug.py``; val and test run
from paired eval stores. ``--maintain-ratio``, ``--device-store-mb 0`` or
a split over the budget stream host-augmented canvases (host-cropped
under ``--aug-order crop-first``); ``--aug-host`` streams the full host
stack's floats. ``--pretrained-*`` also take JAX ``finetune``'s orbax
``model_best`` directories (``exp/orbax_io.py``; where ``tensorstore`` is
missing, the file ``tools/convert_orbax.py --kind branch`` writes on the
host that wrote them). ``--attn-backend xla`` runs JAX's XLA route
(``nn/xla_route.py``) in the branches and the CA head, no kernel.

Data parallel over ranks as ``finetune`` (``--dist-*``, torchrun's
``--distributed``, or ``--mesh-devices N`` in one process; ``-b`` the
global batch, rank 0 the writer), with TensorBoard scalars per draw
where tensorboardX imports.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import torch
from torch import nn

from mfvit_tpu_torch.cli import common
from mfvit_tpu_torch.data import device_aug
from mfvit_tpu_torch.data import manifest as mf
from mfvit_tpu_torch.exp import checkpoint as ckpt_mod
from mfvit_tpu_torch.exp import harness, orbax_io, storage
from mfvit_tpu_torch.nn.vit import ViT
from mfvit_tpu_torch.parallel import dist
from mfvit_tpu_torch.train import metrics, optim, profiler, steps

BRANCHES = ("cxr", "enh")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("mfvit-torch-fuse")
    common.add_common_args(p)
    common.add_train_args(p)
    p.add_argument("--optimizer", default="adam",
                   choices=["sgd", "adam", "adamw"])
    p.add_argument("--pretrained-cxr", default="", type=str,
                   help="fine-tuned CXR-branch checkpoint (.pth, .pth.tar, "
                        ".pt, the port's finetune model_best or JAX's "
                        "orbax model_best dir); may contain "
                        "{ratio}/{draw} placeholders")
    p.add_argument("--pretrained-enh", default="", type=str)
    p.add_argument("--semi-supervised", dest="semi_supervised",
                   action="store_true",
                   help="train the branches too (default: only the head)")
    common.add_fusion_args(p)
    common.add_dist_args(p)
    p.set_defaults(epochs=25, lr=1.5e-4, batch_size=32)
    return p


def fusion_trainable_mask(named_params) -> dict:
    """{parameter name: trainable} over the ``nn.ModuleDict`` of the three
    models: only ``fus.*`` trains. The reference fusion main builds its
    optimizer from the Fus_CrossViT's parameters alone; the branch ViTs,
    bodies and heads, never reach it (``mfvit_tpu/cli/fuse.py:64-79``).
    Their heads still add their logits to the decision logits."""
    return {name: name.split(".")[0] == "fus" for name, _ in named_params}


def load_branch(path: str, cfg, ratio, draw) -> Optional[dict]:
    """The state dict of one branch's checkpoint (``{ratio}``/``{draw}``
    placeholders filled), or None without a path: a ``.pth``,
    ``.pth.tar``, ``.pt`` or the port's own ``finetune`` ``model_best``
    file, or a directory, JAX ``finetune``'s orbax ``model_best`` (the ViT
    tree with its head; ``mfvit_tpu/cli/fuse.py::load_branch`` :84-96)
    read by ``exp/orbax_io.py``."""
    if not path:
        return None
    path = path.format(ratio=ratio, draw=draw)
    if os.path.isdir(path):
        return ckpt_mod.vit_state_from_jax(
            orbax_io.read_tree(path, "branch"), cfg)
    return ckpt_mod.load_vit_state(path, cfg)


def build_models(args, cfg, draw: int) -> nn.ModuleDict:
    """Both branches (from their checkpoints where given) and a fresh
    fusion head, initialised from a generator seeded by ``--seed`` and the
    draw, on the CPU."""
    seed = args.seed if args.seed is not None else 0
    gen = torch.Generator().manual_seed(seed * 1000 + draw)
    return nn.ModuleDict({
        "cxr": ViT(cfg, args.num_classes, generator=gen),
        "enh": ViT(cfg, args.num_classes, generator=gen),
        "fus": common.fusion_head(args, cfg, gen)})


def train_one_draw_fn(args, cfg, device):
    val_man, test_man = mf.eval_manifest_paths(args.covid_ds)
    dt = common.compute_dtype(args)
    store_budget = common.StoreBudget(args.device_store_mb)
    get_eval_stores = common.lazy_eval_stores(
        args, val_man, test_man, "data", paired=True, device=device,
        budget=store_budget)

    def train_one_draw(ratio, draw, sub_folder, writer):
        models = build_models(args, cfg, draw)
        for b, path in zip(BRANCHES, (args.pretrained_cxr,
                                      args.pretrained_enh)):
            sd = load_branch(path, cfg, ratio, draw)
            if sd is not None:
                models[b].load_state_dict(sd, strict=True)
        models.to(device)
        dist.broadcast_state(models)
        mask, snapshot = None, None
        if not args.semi_supervised:
            mask = fusion_trainable_mask(models.named_parameters())
            snapshot = {k: v.detach().cpu().clone()
                        for k, v in models.state_dict().items()
                        if k.split(".")[0] in BRANCHES}

        train_man = (mf.split_manifest_path(args.covid_ds, ratio, draw)
                     if float(ratio) != 1.0 else
                     mf.split_manifest_path(args.covid_ds, 1, 0))
        tl = common.make_paired_loader(args, train_man, training=True,
                                       seed=draw)
        vl = common.make_paired_loader(args, val_man)
        sl = common.make_paired_loader(args, test_man)
        store = common.maybe_device_store(args, train_man, "data",
                                          paired=True, seed=draw,
                                          budget=store_budget, device=device)
        if store is not None:
            tl = store
        ev, es = get_eval_stores()
        vl, sl = ev or vl, es or sl
        steps_per_epoch = max(len(tl), 1)
        init_lr = optim.scaled_init_lr(args.lr, args.batch_size,
                                       cos=args.cos, entry="fusion")
        sched = optim.finetune_lr(init_lr, args.epochs, cos=args.cos,
                                  schedule=args.schedule,
                                  steps_per_epoch=steps_per_epoch)
        opt = optim.build_optimizer(args.optimizer, models.named_parameters(),
                                    sched, weight_decay=args.weight_decay,
                                    momentum=args.momentum,
                                    trainable_mask=mask)
        train_step, eval_step = steps.make_fusion_steps(
            compute_dtype=dt, freeze_backbones=not args.semi_supervised,
            remat=args.remat, fusion_arch=args.fusion_arch,
            attn_backend=args.attn_backend)

        best = ckpt_mod.BestKeeper(sub_folder)
        result = harness.DrawResult(ratio, draw)
        # every step's loss, and the batches the eval phases ran
        losses = result.extra["train_losses"] = []
        result.extra["eval_batches"] = 0
        n_val, n_test = len(vl.ds), len(sl.ds)
        base = common.make_param_evaluate(args, ["data", "Train_Mix"],
                                          eval_step, device)

        def evaluate(loader, n_total: int) -> tuple:
            result.extra["eval_batches"] += len(loader)
            res = base(models, loader, n_total=n_total)
            return res["auc"], res["acc"]

        def record(val, n, idx):
            ep_loss.update(val, n)
            losses.append(val)

        seed = args.seed if args.seed is not None else 0
        for epoch in range(args.start_epoch, args.epochs):
            gen = device_aug.epoch_generator(seed, draw, epoch, device)
            tl.set_epoch(epoch)
            models.train()
            ep_loss = metrics.AverageMeter("Loss", ":.4e")
            timer = profiler.StepTimer(steps_per_epoch,
                                       prefix=f"Epoch: [{epoch}]",
                                       extra_meters=[ep_loss])
            fetch = metrics.DeferredFetch(record)
            for i, batch in enumerate(common.store_batch_iter(store, tl,
                                                              device)):
                timer.data_ready()
                if store is not None:
                    cxr, enh, y = store.gather(batch)
                    xc, xe = (common.device_train_view(args, gen, c, flavor)
                              for c, flavor in ((cxr, "data"),
                                                (enh, "Train_Mix")))
                elif common.device_aug_on(args):
                    cxr, enh, y = batch
                    xc, xe = (common.stream_train_view(args, c, flavor, gen)
                              for c, flavor in ((cxr, "data"),
                                                (enh, "Train_Mix")))
                else:
                    xc, xe, y = batch[0].to(dt), batch[1].to(dt), batch[2]
                loss, _ = train_step(models, opt, xc, xe, y)
                # one-step-lagged fetch: no host sync per step
                fetch.push(loss, int(y.shape[0]) * dist.world(), i,
                           sync=(i == 0))
                timer.step_done(i, args.print_freq)
            fetch.flush()
            models.eval()
            val_auc, val_acc = evaluate(vl, n_val)
            if writer is not None:
                writer.add_scalar("train/loss", ep_loss.avg, epoch)
                writer.add_scalar("val/auc", val_auc, epoch)
                writer.add_scalar("val/acc", val_acc, epoch)
            print(f"[ratio {ratio} draw {draw}] epoch {epoch}: "
                  f"loss {ep_loss.avg:.4f} val auc {val_auc:.4f} "
                  f"acc {val_acc:.4f}")
            if best.update(val_auc, models.state_dict()):
                result.test_auc, result.test_acc = evaluate(sl, n_test)

        # the frozen branches, bodies and heads, must be bit-identical to
        # the loaded checkpoints after LP (fusion main :1013-1040)
        if snapshot is not None:
            harness.verify_frozen(models.state_dict(), snapshot)
            print("=> fusion sanity check passed.")
        common.release_store(store)
        return result

    return train_one_draw


def main(argv=None):
    args = build_parser().parse_args(argv)
    common.maybe_init_distributed(args)
    if args.resume:
        raise SystemExit("--resume is not implemented for fuse "
                         "(the reference's resume path is dead code too); "
                         "restart the draw or load via --pretrained")
    spawned = common.maybe_spawn(args, "mfvit_tpu_torch.cli.fuse", argv)
    if spawned is not None:
        return spawned
    common.print_route(args)
    device = common.resolve_device(args.device)
    cfg = common.get_vit_arch(args)
    folder = storage.get_storage_folder(args.exp_name, "mfvit_ca",
                                        root=args.storage_root)
    harness.snapshot_args(folder, args)
    iterations = ({r: args.draws for r in args.semi_ratios}
                  if args.draws else None)
    ratios = [mf.ratio_tag(r) for r in args.semi_ratios]
    results = harness.run_draws(folder, ratios,
                                train_one_draw_fn(args, cfg, device),
                                iterations=iterations)
    for r in results:
        print(f"ratio {r.ratio} draw {r.draw}: "
              f"test auc {r.test_auc:.4f} acc {r.test_acc:.4f}")
    return results


if __name__ == "__main__":
    main()
