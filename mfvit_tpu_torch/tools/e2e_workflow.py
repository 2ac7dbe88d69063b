"""The whole workflow end to end without jax, the twin of
``tools/e2e_workflow.py``: synthetic class-separable paired images, MoCo
pretraining with ``--export-torch``, LP ``finetune --pretrained`` on its
``checkpoint_torch.pth.tar``, ``fuse`` with both branches from the LP
``model_best``, then ``infer`` on fuse's ``model_best``. Each stage runs
through its CLI's ``main(argv)``; the checkpoints pass from stage to stage
as files.

    python -m mfvit_tpu_torch.tools.e2e_workflow [--root DIR] \\
        [--device cuda] [-a vit_small] [--img-size 224]

On the CPU: ``--device cpu -a vit_test --img-size 32 --compute-dtype
float32 --fusion-heads 2``. Prints and returns ``infer``'s output
(``metrics``: AUC, top-1, precision, recall, F1). JAX's second half, the
same stages through its device canvas store, waits for that store
(ROADMAP.md section 1, item 5).
"""
from __future__ import annotations

import argparse
import glob
import os
import tempfile

import numpy as np

N_IMAGES = 32  # 16 train, 8 val, 8 test


def write_dataset(root: str, img_size: int, seed: int = 0) -> str:
    """32 synthetic pairs (a 'data' and a 'Train_Mix' image each) whose
    first channel carries the class (i % 3), a little larger than
    ``img_size`` and not square; manifests 1_labeled_train_0.txt (16),
    val_ds.txt (8) and test_ds.txt (8). Returns the manifest folder."""
    import cv2

    from mfvit_tpu_torch.data.manifest import write_covid_manifest
    images, cds = os.path.join(root, "images"), os.path.join(root, "cds")
    for folder in ("data", "Train_Mix"):
        os.makedirs(os.path.join(images, folder), exist_ok=True)
    os.makedirs(cds, exist_ok=True)
    rng = np.random.default_rng(seed)
    names = [f"img_{i}.png" for i in range(N_IMAGES)]
    labels = [i % 3 for i in range(N_IMAGES)]
    shape = (img_size + img_size // 14, img_size + img_size // 6, 3)
    for fn, label in zip(names, labels):
        for folder in ("data", "Train_Mix"):
            img = rng.integers(0, 255, shape, np.uint8)
            img[:, :, 0] = np.clip(img[:, :, 0] * 0.2 + label * 80, 0, 255)
            cv2.imwrite(os.path.join(images, folder, fn), img)
    for fname, sl in (("1_labeled_train_0.txt", slice(0, 16)),
                      ("val_ds.txt", slice(16, 24)),
                      ("test_ds.txt", slice(24, 32))):
        write_covid_manifest(os.path.join(cds, fname), images, names[sl],
                             labels[sl])
    return cds


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("mfvit-torch-e2e-workflow")
    p.add_argument("--root", default=None,
                   help="working folder (a new temporary one by default)")
    p.add_argument("--device", default="cuda")
    p.add_argument("-a", "--arch", default="vit_small")
    p.add_argument("--img-size", dest="img_size", type=int, default=224)
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--fusion-heads", type=int, default=3)
    return p


def _one(pattern: str) -> str:
    found = glob.glob(pattern)
    if len(found) != 1:
        raise RuntimeError(f"expected one {pattern}, found {found}")
    return found[0]


def main(argv=None) -> dict:
    from mfvit_tpu_torch.cli import finetune, fuse, infer, pretrain

    args = build_parser().parse_args(argv)
    root = args.root or tempfile.mkdtemp(prefix="e2e_covid_")
    cds = write_dataset(root, args.img_size)
    model = ["-a", args.arch, "--img-size", str(args.img_size), "--crop",
             str(args.img_size), "--maintain-ratio", "-j", "4", "--device",
             args.device, "--compute-dtype", args.compute_dtype]
    common = model + ["--seed", "0", "--covid-ds", cds, "--semi-ratios", "1"]
    heads = ["--fusion-heads", str(args.fusion_heads)]

    print("=== pretrain (MoCo v2 queue, 1 epoch, --export-torch) ===")
    pretrain.main(common + [
        "--storage-root", os.path.join(root, "pre"), "-b", "16", "--epochs",
        "1", "--warmup-epochs", "0", "--cos", "--lr", "1.5e-4",
        "--optimizer", "adamw", "--wd", "0.1", "--moco-dim", "64",
        "--moco-mlp-dim", "256", "--moco-k", "64", "--moco-t", "0.2",
        "--moco-m-cos", "--stop-grad-conv1", "--save-epoch", "1",
        "--export-torch"])
    moco_ck = _one(os.path.join(root, "pre", "*", "train_1_0",
                                "checkpoint_torch.pth.tar"))

    print("=== LP finetune from the MoCo export (2 epochs) ===")
    (res,) = finetune.main(common + [
        "--storage-root", os.path.join(root, "lp"), "-b", "16", "--epochs",
        "2", "--cos", "--lr", "0.3", "--optimizer", "sgd", "--pretrained",
        moco_ck])
    print("LP test auc", res.test_auc)
    lp_ck = _one(os.path.join(root, "lp", "*", "train_1_0", "model_best"))

    print("=== MF-ViT CA fuse (2 epochs, both branches from the LP "
          "model_best) ===")
    (res,) = fuse.main(common + heads + [
        "--storage-root", os.path.join(root, "fuse"), "-b", "16",
        "--epochs", "2", "--cos", "--lr", "1e-3", "--pretrained-cxr", lp_ck,
        "--pretrained-enh", lp_ck])
    print("fuse test auc", res.test_auc)
    fuse_ck = _one(os.path.join(root, "fuse", "*", "train_1_0",
                                "model_best"))

    print("=== infer ===")
    out = infer.main(model + heads + [
        "--checkpoint", fuse_ck, "--manifest",
        os.path.join(cds, "test_ds.txt"), "--output",
        os.path.join(root, "preds.json"), "-b", "8"])
    print("E2E OK:", out["metrics"])
    return out


if __name__ == "__main__":
    main()
