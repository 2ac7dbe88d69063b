"""MF-ViT CA fusion training, the port of ``mfvit_tpu/cli/fuse.py``: two
ViT branches loaded from their fine-tuned checkpoints, the CLS
cross-attention fusion head, decision logits fused + cxr + enh, the LP
freeze of both branches (bodies and heads) unless ``--semi-supervised``,
the per-epoch cosine or milestone LR, val AUC every epoch, the best-val-AUC
``model_best`` with test AUC/acc on each improvement, a paired CXR +
enhanced dataset indexed jointly, and the LP frozen-branch check.

    python -m mfvit_tpu_torch.cli.fuse -a vit_small -b 32 --lr 1.5e-4 \\
        --cos --epochs 25 --maintain-ratio --covid-ds create_covid_dataset \\
        --pretrained-cxr cxr/model_best --pretrained-enh enh/model_best \\
        [--semi-supervised] [--device cuda]

On CUDA both branches run K1/K2/K3 forward and the head K4; under LP the
branches run without autograd, so only K4's plain recompute runs backward;
``--semi-supervised`` trains everything through K5 and K7 as well. The
``model_best`` of each draw (``mfvit_ca/train_{ratio}_{draw}``) is the
flat state dict of the ``nn.ModuleDict({"cxr", "enh", "fus"})``, which
``cli/infer.py --checkpoint`` serves as it is.

Not ported yet (ROADMAP.md): the device canvas store (this behaves as the
JAX CLI with ``--device-store-mb 0``), ``--fusion-arch gpt`` (the
alternative-heads slice), orbax ``--pretrained-*`` directories,
``--attn-backend``, the canvas cache, the distributed flags and
TensorBoard.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import torch
from torch import nn

from mfvit_tpu_torch.cli import common
from mfvit_tpu_torch.data import manifest as mf
from mfvit_tpu_torch.exp import checkpoint as ckpt_mod
from mfvit_tpu_torch.exp import harness, storage
from mfvit_tpu_torch.models.fusion import Fusion
from mfvit_tpu_torch.nn.vit import ViT
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
                        ".pt or the port's finetune model_best); may "
                        "contain {ratio}/{draw} placeholders")
    p.add_argument("--pretrained-enh", default="", type=str)
    p.add_argument("--semi-supervised", dest="semi_supervised",
                   action="store_true",
                   help="train the branches too (default: only the head)")
    p.add_argument("--fusion-arch", default="ca", choices=["ca", "gpt"],
                   help="fusion head: 'ca' = MF-ViT CA CLS cross-attention")
    p.add_argument("--fusion-heads", type=int, default=3)
    p.add_argument("--cross-attn-depth", type=int, default=1)
    p.add_argument("--multi-scale-enc-depth", type=int, default=1)
    p.add_argument("--num-classes", type=int, default=3)
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
    placeholders filled), or None without a path. An orbax directory (the
    JAX package's checkpoints) raises SystemExit."""
    if not path:
        return None
    path = path.format(ratio=ratio, draw=draw)
    if os.path.isdir(path):
        raise SystemExit(
            f"{path}: an orbax checkpoint directory; the port reads .pth, "
            ".pth.tar, .pt files and its own finetune model_best (an orbax "
            "reader is ROADMAP.md section 1, item 4)")
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
        "fus": Fusion(args.num_classes, cfg.dim, args.fusion_heads,
                      args.cross_attn_depth, args.multi_scale_enc_depth,
                      generator=gen)})


def train_one_draw_fn(args, cfg, device):
    val_man, test_man = mf.eval_manifest_paths(args.covid_ds)
    dt = common.compute_dtype(args)

    def train_one_draw(ratio, draw, sub_folder):
        models = build_models(args, cfg, draw)
        for b, path in zip(BRANCHES, (args.pretrained_cxr,
                                      args.pretrained_enh)):
            sd = load_branch(path, cfg, ratio, draw)
            if sd is not None:
                models[b].load_state_dict(sd, strict=True)
        models.to(device)
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
            remat=args.remat)

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

        for epoch in range(args.start_epoch, args.epochs):
            tl.set_epoch(epoch)
            models.train()
            ep_loss = metrics.AverageMeter("Loss", ":.4e")
            timer = profiler.StepTimer(steps_per_epoch,
                                       prefix=f"Epoch: [{epoch}]",
                                       extra_meters=[ep_loss])
            fetch = metrics.DeferredFetch(record)
            for i, (cxr, enh, labels) in enumerate(tl):
                timer.data_ready()
                xc, xe = (common.stream_train_view(
                    args, torch.from_numpy(c).to(device), flavor)
                    for c, flavor in ((cxr, "data"), (enh, "Train_Mix")))
                y = torch.from_numpy(labels).to(device)
                loss, _ = train_step(models, opt, xc, xe, y)
                # one-step-lagged fetch: no host sync per step
                fetch.push(loss, int(y.shape[0]), i, sync=(i == 0))
                timer.step_done(i, args.print_freq)
            fetch.flush()
            models.eval()
            val_auc, val_acc = evaluate(vl, n_val)
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
        return result

    return train_one_draw


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.resume:
        raise SystemExit("--resume is not implemented for fuse "
                         "(the reference's resume path is dead code too); "
                         "restart the draw or load via --pretrained")
    if args.fusion_arch != "ca":
        raise SystemExit(f"--fusion-arch {args.fusion_arch}: the port has "
                         "the MF-ViT CA head only; the GPT head comes with "
                         "the alternative-heads slice (ROADMAP.md section "
                         "1, item 7)")
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
