"""Linear-probe / full-finetune entry point, the port of
``mfvit_tpu/cli/finetune.py``: per (ratio, draw) a fresh ViT with a new
N(0, 0.01) head, the optional MoCo ``.pth.tar`` surgery, the LP freeze of
all but the head unless ``--semi-supervised`` (FT), SGD/Adam/AdamW/LARS
with the per-epoch cosine or milestone LR, train and val every epoch, test
on val-AUC (and val-ACC) improvement with best-AUC and best-ACC
checkpoints, and the LP frozen-backbone sanity check.

    python -m mfvit_tpu_torch.cli.finetune -a vit_small --semi-supervised \\
        --covid-ds create_covid_dataset --pretrained moco.pth.tar \\
        -b 16 --epochs 90 --lr 3 --cos [--device cuda]

On CUDA every block runs K1/K2/K3 forward and, under FT, K5/K7 backward;
past 256 tokens (``--img-size 384 --crop 384``) K9 replaces K1, and its
backward is the fp32 recompute of the JAX package, in plain PyTorch.

The feed is JAX's. By default (``--device-store-mb 2048``, square
resize) each draw decodes its split once into the device canvas store and
a step gathers its batch there, then draws the view on the device (flip,
rotation about the full canvas, crop) from the (draw, epoch) generator of
``data/device_aug.py``; val and test run from eval stores. With
``--maintain-ratio``, ``--device-store-mb 0`` or a split over the budget
the host streams canvases augmented in the reference order (only cropped
under ``--aug-order crop-first``, the device then flips and rotates);
``--aug-host`` streams the full host stack's floats. ``--pretrained``
takes a MoCo ``.pth.tar``, a JAX orbax directory (``exp/orbax_io.py``;
where ``tensorstore`` is missing, the file ``tools/convert_orbax.py
--kind pretrain`` writes on the host that wrote it) or the port's own
pretrain checkpoint. ``--attn-backend xla`` trains on JAX's XLA route
(``nn/xla_route.py``), no kernel.

Data parallel over ranks (``parallel/dist.py``): the same command in each
process with ``--dist-coordinator host:port --dist-num-processes N
--dist-process-id i`` (or ``--distributed`` under torchrun), or
``--mesh-devices N`` in one process, which spawns N ranks on cuda:0..N-1.
``-b`` stays the global batch; each rank takes its row block of it, the
gradients are averaged and the eval logits gathered, and rank 0 writes
the experiment folder. Each draw writes TensorBoard scalars (train/val/test)
where tensorboardX imports, and the run draws the LR schedule into
``lr.jpg`` where matplotlib does.
"""
from __future__ import annotations

import argparse
import os

import torch

from mfvit_tpu_torch.cli import common
from mfvit_tpu_torch.data import device_aug
from mfvit_tpu_torch.data import manifest as mf
from mfvit_tpu_torch.exp import checkpoint as ckpt_mod
from mfvit_tpu_torch.exp import harness, orbax_io, storage
from mfvit_tpu_torch.nn import vit as vit_mod
from mfvit_tpu_torch.parallel import dist
from mfvit_tpu_torch.train import metrics, optim, profiler, steps


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("mfvit-torch-finetune")
    common.add_common_args(p)
    common.add_train_args(p)
    p.add_argument("--optimizer", default="sgd",
                   choices=["sgd", "adam", "adamw", "lars"])
    p.add_argument("--pretrained", default="", type=str,
                   help="MoCo checkpoint: .pth.tar via the torch surgery, "
                        "a JAX orbax dir, or the port's pretrain "
                        "checkpoint file")
    p.add_argument("--semi-supervised", dest="semi_supervised",
                   action="store_true",
                   help="full finetune (train the whole backbone)")
    p.add_argument("--folder", default="data",
                   help="image flavor folder (data | Train_Mix)")
    p.add_argument("--num-classes", type=int, default=3)
    common.add_dist_args(p)
    p.set_defaults(epochs=90, lr=3.0, batch_size=16)
    return p


def load_backbone(args, cfg):
    """The pretrained backbone's ``nn.vit.ViT`` state dict without a head,
    or None, as ``mfvit_tpu/cli/finetune.py::load_backbone`` (:54-68)
    takes it: a ``.pth``/``.pth.tar``/``.pt`` through the MoCo surgery; a
    JAX orbax directory (``exp/orbax_io.py``), a bare encoder tree or a
    pretrain checkpoint whose ``state.base.encoder`` is taken; or the
    port's own file of either kind (``pretrain``'s ``checkpoint_*``, whose
    ``base.encoder.`` entries are taken, or a ViT state dict). Any head
    is dropped: the draw gets a fresh one."""
    path = args.pretrained
    if not path:
        return None
    if path.endswith((".pth", ".pth.tar", ".pt")):
        return ckpt_mod.load_moco_pretrained_backbone(path, cfg)
    if os.path.isdir(path):
        tree = orbax_io.read_tree(path, "pretrain")
        if isinstance(tree, dict) and "state" in tree:
            tree = tree["state"]
        if isinstance(tree, dict) and "base" in tree:
            tree = tree["base"]["encoder"]
        sd = ckpt_mod.vit_state_from_jax(tree, cfg)
    else:
        sd = ckpt_mod.load_pretrain_checkpoint(path)
        if "state" in sd:
            sd = ckpt_mod.strip_prefix(sd["state"], "base.encoder.")
    return {k: v for k, v in sd.items() if not k.startswith("head.")}


def make_evaluate(eval_step, args, device):
    """``evaluate(model, loader, *, n_total) -> (auc, acc, loss, logits,
    labels)``: the eval runner plus the eval CE loss of each phase."""
    base = common.make_param_evaluate(args, [args.folder], eval_step, device)

    def evaluate(model, loader, *, n_total: int):
        res = base(model, loader, n_total=n_total)
        logits, labels = res["logits"], res["labels"]
        logp = torch.log_softmax(torch.from_numpy(logits).float(), -1)
        loss = float(-logp.gather(1, torch.from_numpy(labels).long()[:, None])
                     .mean())
        return res["auc"], res["acc"], loss, logits, labels

    return evaluate


def train_one_draw_fn(args, cfg, device):
    val_man, test_man = mf.eval_manifest_paths(args.covid_ds)
    dt = common.compute_dtype(args)
    # one device budget for every store of the run; the train store of a
    # draw reserves first, the eval stores are built once on first use
    store_budget = common.StoreBudget(args.device_store_mb)
    get_eval_stores = common.lazy_eval_stores(
        args, val_man, test_man, args.folder, device=device,
        budget=store_budget)

    def train_one_draw(ratio, draw, sub_folder, writer):
        seed = args.seed if args.seed is not None else 0
        gen = torch.Generator().manual_seed(seed * 1000 + draw)
        model = vit_mod.ViT(cfg, args.num_classes, generator=gen)
        backbone = load_backbone(args, cfg)
        if backbone is not None:
            missing, unexpected = model.load_state_dict(backbone,
                                                        strict=False)
            if set(missing) != {"head.weight", "head.bias"} or unexpected:
                raise ValueError(f"MoCo surgery: missing {missing}, "
                                 f"unexpected {unexpected}")
        model.to(device)
        dist.broadcast_state(model)
        mask, snapshot = None, None
        if not args.semi_supervised:
            mask = optim.head_only_mask(model.named_parameters())
            snapshot = {k: v.detach().cpu().clone()
                        for k, v in model.state_dict().items()}

        train_man = (mf.split_manifest_path(args.covid_ds, ratio, draw)
                     if float(ratio) != 1.0 else
                     mf.split_manifest_path(args.covid_ds, 1, 0))
        tl = common.make_covid_loader(args, train_man, args.folder,
                                      training=True, seed=draw)
        vl = common.make_covid_loader(args, val_man, args.folder,
                                      training=False)
        sl = common.make_covid_loader(args, test_man, args.folder,
                                      training=False)
        store = common.maybe_device_store(args, train_man, args.folder,
                                          seed=draw, budget=store_budget,
                                          device=device)
        if store is not None:
            tl = store
        ev, es = get_eval_stores()
        vl, sl = ev or vl, es or sl
        steps_per_epoch = max(len(tl), 1)
        init_lr = optim.scaled_init_lr(args.lr, args.batch_size,
                                       cos=args.cos, entry="finetune")
        sched = optim.finetune_lr(init_lr, args.epochs, cos=args.cos,
                                  schedule=args.schedule,
                                  steps_per_epoch=steps_per_epoch)
        opt = optim.build_optimizer(args.optimizer, model.named_parameters(),
                                    sched, weight_decay=args.weight_decay,
                                    momentum=args.momentum,
                                    trainable_mask=mask)
        train_step, eval_step = steps.make_classifier_steps(
            compute_dtype=dt, remat=args.remat,
            attn_backend=args.attn_backend)

        best = ckpt_mod.BestKeeper(sub_folder)
        best_acc = ckpt_mod.BestKeeper(storage.get_storage_sub_folder(
            sub_folder.parent, ratio, draw, acc=True))
        result = harness.DrawResult(ratio, draw)
        # every step's loss, and the batches the eval phases ran
        losses = result.extra["train_losses"] = []
        result.extra["eval_batches"] = 0
        n_val, n_test = len(vl.ds), len(sl.ds)
        evaluate_all = make_evaluate(eval_step, args, device)

        def evaluate(model, loader, *, n_total: int):
            result.extra["eval_batches"] += len(loader)
            return evaluate_all(model, loader, n_total=n_total)

        def record(val, n, idx):
            ep_loss.update(val, n)
            losses.append(val)

        for epoch in range(args.start_epoch, args.epochs):
            gen = device_aug.epoch_generator(seed, draw, epoch, device)
            tl.set_epoch(epoch)
            model.train()
            ep_loss = metrics.AverageMeter("Loss", ":.4e")
            timer = profiler.StepTimer(steps_per_epoch,
                                       prefix=f"Epoch: [{epoch}]",
                                       extra_meters=[ep_loss])
            fetch = metrics.DeferredFetch(record)
            for i, batch in enumerate(common.store_batch_iter(store, tl,
                                                              device)):
                timer.data_ready()
                if store is not None:
                    canv, y = store.gather(batch)
                    x = common.device_train_view(args, gen, canv,
                                                 args.folder)
                elif common.device_aug_on(args):
                    canv, y = batch
                    x = common.stream_train_view(args, canv, args.folder,
                                                 gen)
                else:
                    x, y = batch[0].to(dt), batch[1]
                loss, _ = train_step(model, opt, x, y)
                # one-step-lagged fetch: no host sync per step
                fetch.push(loss, int(y.shape[0]) * dist.world(), i,
                           sync=(i == 0))
                timer.step_done(i, args.print_freq)
            fetch.flush()
            model.eval()
            val_auc, val_acc, val_loss, _, _ = evaluate(model, vl,
                                                        n_total=n_val)
            if writer is not None:
                writer.add_scalar("train/loss", ep_loss.avg, epoch)
                writer.add_scalar("val/auc", val_auc, epoch)
                writer.add_scalar("val/acc", val_acc, epoch)
                writer.add_scalar("val/loss", val_loss, epoch)
            print(f"[ratio {ratio} draw {draw}] epoch {epoch}: "
                  f"train loss {ep_loss.avg:.4f} val auc {val_auc:.4f} "
                  f"acc {val_acc:.4f}")
            result.extra["final_train_loss"] = ep_loss.avg
            state = model.state_dict()
            if best.update(val_auc, state):
                t_auc, t_acc, _, _, _ = evaluate(model, sl, n_total=n_test)
                result.test_auc = t_auc
                result.extra["test_acc_at_best_auc"] = t_acc
                if writer is not None:
                    writer.add_scalar("test/all_test_auc", t_auc, epoch)
                    writer.add_scalar("test/auc", t_auc, epoch)
            if best_acc.update(val_acc, state, save_last=False):
                a_auc, a_acc, _, _, _ = evaluate(model, sl, n_total=n_test)
                result.test_acc = a_acc
                result.extra["test_auc_at_best_acc"] = a_auc
                if writer is not None:
                    writer.add_scalar("test/all_test_acc", a_acc, epoch)

        if snapshot is not None:
            harness.verify_frozen(model.state_dict(), snapshot)
            print("=> sanity check passed.")
        common.release_store(store)
        return result

    return train_one_draw


def draw_lr(args, folder) -> None:
    """``lr.jpg``: the per-epoch LR of the schedule
    (``mfvit_tpu/cli/finetune.py:296-316``), skipped with a message where
    matplotlib is missing or fails."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        init_lr = optim.scaled_init_lr(args.lr, args.batch_size,
                                       cos=args.cos, entry="finetune")
        sched = optim.finetune_lr(init_lr, args.epochs, cos=args.cos,
                                  schedule=args.schedule, steps_per_epoch=1)
        plt.figure()
        plt.plot([float(sched(e)) for e in range(args.epochs)])
        plt.xlabel("epoch")
        plt.ylabel("lr")
        plt.savefig(str(folder / "lr.jpg"))
        plt.close()
    except Exception as e:  # plotting is best-effort, as in JAX
        print(f"lr.jpg skipped: {e}")


def main(argv=None):
    args = build_parser().parse_args(argv)
    common.maybe_init_distributed(args)
    if args.resume:
        raise SystemExit("--resume is not implemented for finetune "
                         "(the reference's resume path is dead code too); "
                         "restart the draw or load via --pretrained")
    spawned = common.maybe_spawn(args, "mfvit_tpu_torch.cli.finetune", argv)
    if spawned is not None:
        return spawned
    common.print_route(args)
    device = common.resolve_device(args.device)
    cfg = common.get_vit_arch(args)
    exp_type = "finetune" if args.semi_supervised else "linear_probe"
    folder = storage.get_storage_folder(args.exp_name, exp_type,
                                        root=args.storage_root)
    harness.snapshot_args(folder, args)
    iterations = ({r: args.draws for r in args.semi_ratios}
                  if args.draws else None)
    ratios = [mf.ratio_tag(r) for r in args.semi_ratios]
    results = harness.run_draws(folder, ratios,
                                train_one_draw_fn(args, cfg, device),
                                iterations=iterations)
    if storage.is_primary():
        draw_lr(args, folder)
    for r in results:
        print(f"ratio {r.ratio} draw {r.draw}: "
              f"test auc {r.test_auc:.4f} acc {r.test_acc:.4f}")
    return results


if __name__ == "__main__":
    main()
