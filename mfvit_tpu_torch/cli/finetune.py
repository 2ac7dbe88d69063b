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
Not ported yet (ROADMAP.md): the device canvas store (this behaves as the
JAX CLI with ``--device-store-mb 0``), ``--aug-order crop-first``,
``--attn-backend``, the canvas cache, the distributed flags, TensorBoard
and ``lr.jpg``; ``--pretrained`` takes ``.pth.tar`` files only.
"""
from __future__ import annotations

import argparse

import torch

from mfvit_tpu_torch.cli import common
from mfvit_tpu_torch.data import manifest as mf
from mfvit_tpu_torch.exp import checkpoint as ckpt_mod
from mfvit_tpu_torch.exp import harness, storage
from mfvit_tpu_torch.nn import vit as vit_mod
from mfvit_tpu_torch.train import metrics, optim, profiler, steps


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("mfvit-torch-finetune")
    common.add_common_args(p)
    common.add_train_args(p)
    p.add_argument("--optimizer", default="sgd",
                   choices=["sgd", "adam", "adamw", "lars"])
    p.add_argument("--pretrained", default="", type=str,
                   help="MoCo checkpoint (.pth.tar)")
    p.add_argument("--semi-supervised", dest="semi_supervised",
                   action="store_true",
                   help="full finetune (train the whole backbone)")
    p.add_argument("--folder", default="data",
                   help="image flavor folder (data | Train_Mix)")
    p.add_argument("--num-classes", type=int, default=3)
    p.set_defaults(epochs=90, lr=3.0, batch_size=16)
    return p


def load_backbone(args, cfg):
    """The MoCo base encoder's state dict (no head), or None."""
    if not args.pretrained:
        return None
    if not args.pretrained.endswith((".pth", ".pth.tar", ".pt")):
        raise SystemExit(f"--pretrained {args.pretrained}: the port reads "
                         "MoCo .pth.tar checkpoints only (orbax is not "
                         "ported)")
    return ckpt_mod.load_moco_pretrained_backbone(args.pretrained, cfg)


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

    def train_one_draw(ratio, draw, sub_folder):
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
            compute_dtype=dt, remat=args.remat)

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
            tl.set_epoch(epoch)
            model.train()
            ep_loss = metrics.AverageMeter("Loss", ":.4e")
            timer = profiler.StepTimer(steps_per_epoch,
                                       prefix=f"Epoch: [{epoch}]",
                                       extra_meters=[ep_loss])
            fetch = metrics.DeferredFetch(record)
            for i, (canv, labels) in enumerate(tl):
                timer.data_ready()
                x = common.stream_train_view(
                    args, torch.from_numpy(canv).to(device), args.folder)
                y = torch.from_numpy(labels).to(device)
                loss, _ = train_step(model, opt, x, y)
                # one-step-lagged fetch: no host sync per step
                fetch.push(loss, int(y.shape[0]), i, sync=(i == 0))
                timer.step_done(i, args.print_freq)
            fetch.flush()
            model.eval()
            val_auc, val_acc, _, _, _ = evaluate(model, vl, n_total=n_val)
            print(f"[ratio {ratio} draw {draw}] epoch {epoch}: "
                  f"train loss {ep_loss.avg:.4f} val auc {val_auc:.4f} "
                  f"acc {val_acc:.4f}")
            result.extra["final_train_loss"] = ep_loss.avg
            state = model.state_dict()
            if best.update(val_auc, state):
                t_auc, t_acc, _, _, _ = evaluate(model, sl, n_total=n_test)
                result.test_auc = t_auc
                result.extra["test_acc_at_best_auc"] = t_acc
            if best_acc.update(val_acc, state, save_last=False):
                a_auc, a_acc, _, _, _ = evaluate(model, sl, n_total=n_test)
                result.test_acc = a_acc
                result.extra["test_auc_at_best_acc"] = a_auc

        if snapshot is not None:
            harness.verify_frozen(model.state_dict(), snapshot)
            print("=> sanity check passed.")
        return result

    return train_one_draw


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.resume:
        raise SystemExit("--resume is not implemented for finetune "
                         "(the reference's resume path is dead code too); "
                         "restart the draw or load via --pretrained")
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
    for r in results:
        print(f"ratio {r.ratio} draw {r.draw}: "
              f"test auc {r.test_auc:.4f} acc {r.test_acc:.4f}")
    return results


if __name__ == "__main__":
    main()
