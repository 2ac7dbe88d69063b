"""Fine-tuning under both augmentation feeds on a synthetic set, the port
of ``tools/aug_order_study.py``.

    python -m mfvit_tpu_torch.tools.aug_order_study [out_root] \\
        [--device cuda]

It writes JAX's synthetic set: 144 PNGs of 96 x 104 (``make_img``, JAX
:31-56: three classes of oriented stripes in low contrast over uniform
noise, with a border band where the stripes are stronger, all drawn from
``np.random.default_rng(0)``) and JAX's three manifests (96 train, 24
val, 24 test, :64-71). Then, for each mode (``--aug-device``, then
``--aug-host``) and each seed in ``range(AUG_STUDY_SEEDS)`` (3 unless
the environment sets it), it runs ``mfvit_tpu_torch.cli.finetune.main``
with JAX's arguments (:81-90: vit_test at 64 px cropped to 48, fp32,
``--attn-backend xla``, full fine-tuning, 20 epochs of cosine SGD at LR
0.02 and B=16, rotations of up to 10 degrees) and ``--device``, and
reports test AUC and ACC per seed, their means and spreads per mode, and
writes them to ``aug_order_study.json`` under ``out_root`` (a new
temporary directory unless given). ``--attn-backend xla`` runs JAX's XLA
route, so the study launches no kernel, as in JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import cv2
import numpy as np

from mfvit_tpu_torch.cli import common, finetune
from mfvit_tpu_torch.data import manifest as mf
from mfvit_tpu_torch.tools import card

N = 144  # 96 train / 24 val / 24 test
EPOCHS = 20
MODES = ("aug-device", "aug-host")


def make_img(label: int, r: np.random.Generator) -> np.ndarray:
    """One 96 x 104 image of class ``label`` drawn from ``r`` (JAX
    :31-56, draw for draw): uniform noise in [40, 216), the class's
    stripes (8 px, horizontal, vertical or diagonal) 14 brighter, and 25
    brighter again inside an 8 px border band."""
    img = r.integers(40, 216, (96, 104, 3), np.uint8)
    yy, xx = np.mgrid[0:96, 0:104]
    if label == 0:
        stripe = ((yy // 8) % 2 == 0)
    elif label == 1:
        stripe = ((xx // 8) % 2 == 0)
    else:
        stripe = (((yy + xx) // 8) % 2 == 0)
    img[stripe] = np.minimum(img[stripe].astype(np.int16) + 14,
                             255).astype(np.uint8)
    band = np.zeros((96, 104), bool)
    band[:8] = band[-8:] = True
    band[:, :8] = band[:, -8:] = True
    img[band & stripe] = np.minimum(
        img[band & stripe].astype(np.int16) + 25, 255).astype(np.uint8)
    return img


def write_set(root: str) -> None:
    """The images under ``root/images/data``, the manifests under
    ``root/cds``."""
    os.makedirs(f"{root}/images/data", exist_ok=True)
    os.makedirs(f"{root}/cds", exist_ok=True)
    rng = np.random.default_rng(0)
    names, labels = [], []
    for i in range(N):
        label = i % 3
        fn = f"img_{i}.png"
        cv2.imwrite(f"{root}/images/data/{fn}", make_img(label, rng))
        names.append(fn)
        labels.append(label)
    for man, sl in (("1_labeled_train_0.txt", slice(0, 96)),
                    ("val_ds.txt", slice(96, 120)),
                    ("test_ds.txt", slice(120, N))):
        mf.write_covid_manifest(f"{root}/cds/{man}", f"{root}/images",
                                names[sl], labels[sl])


def finetune_argv(root: str, mode: str, seed: int, device: str) -> list:
    """JAX's arguments (:81-90) and ``--device``."""
    out = f"{root}/exp_{mode}_{seed}"
    return [
        "-a", "vit_test", "--img-size", "64", "--crop", "48",
        "--compute-dtype", "float32", "--attn-backend", "xla",
        "-j", "4", "--seed", str(seed), f"--{mode}",
        "--covid-ds", f"{root}/cds", "--storage-root", out,
        "--exp-name", f"augstudy_{mode}_{seed}",
        "--semi-supervised",
        "-b", "16", "--epochs", str(EPOCHS), "--cos", "--lr", "0.02",
        "--optimizer", "sgd", "--rotate", "10",
        "--semi-ratios", "1", "--device", device]


def seeds() -> range:
    return range(int(os.environ.get("AUG_STUDY_SEEDS", "3")))


def run(device: str, root: str = None) -> dict:
    """{mode: {"per_seed", "auc_mean", "auc_std", "acc_mean",
    "acc_std"}}, written to ``root/aug_order_study.json``."""
    root = root or tempfile.mkdtemp(prefix="augstudy_")
    write_set(root)
    results = {}
    for mode in MODES:
        per_seed = []
        for seed in seeds():
            res = finetune.main(finetune_argv(root, mode, seed, device))
            per_seed.append({"seed": seed, "test_auc": res[0].test_auc,
                             "test_acc": res[0].test_acc})
            print(f"[{mode} seed {seed}] test AUC {res[0].test_auc:.4f} "
                  f"ACC {res[0].test_acc:.4f}", flush=True)
        aucs = [d["test_auc"] for d in per_seed]
        accs = [d["test_acc"] for d in per_seed]
        results[mode] = {
            "per_seed": per_seed,
            "auc_mean": float(np.mean(aucs)), "auc_std": float(np.std(aucs)),
            "acc_mean": float(np.mean(accs)), "acc_std": float(np.std(accs)),
        }
    print(json.dumps(results, indent=2))
    with open(f"{root}/aug_order_study.json", "w") as f:
        json.dump(results, f, indent=2)
    print(f"results at {root}/aug_order_study.json")
    return results


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("mfvit-torch-aug-order-study")
    p.add_argument("out_root", nargs="?", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises where CUDA is missing")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = common.resolve_device(args.device)
    card.note(device)
    return run(str(device), args.out_root)


if __name__ == "__main__":
    main()
