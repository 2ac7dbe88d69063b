"""Generate the semi-supervised split manifests (``create_covid_dataset``)
without jax, the twin of ``tools/make_splits.py``: the same flags, and the
same files byte for byte from the same master manifest and seed. Per
(ratio, draw) a stratified labeled subset of the train pool and its
unlabeled complement, with disjoint val and test splits.

    python -m mfvit_tpu_torch.tools.make_splits --master all.txt \\
        --out create_covid_dataset --ratios 0.1 0.3 1 --draws 5 \\
        --val-frac 0.1 --test-frac 0.2 --seed 0
"""
from __future__ import annotations

import argparse
import os
from collections import defaultdict

import numpy as np

from mfvit_tpu_torch.data import manifest as mf


def write_lines(path: str, lines) -> None:
    with open(path, "w") as f:
        f.writelines(lines)


def main(argv=None):
    p = argparse.ArgumentParser("mfvit-torch-make-splits")
    p.add_argument("--master", required=True,
                   help="master manifest (reference line format)")
    p.add_argument("--out", required=True)
    p.add_argument("--ratios", nargs="+", type=float, default=[0.1, 0.3, 1])
    p.add_argument("--draws", type=int, default=5)
    p.add_argument("--val-frac", type=float, default=0.1)
    p.add_argument("--test-frac", type=float, default=0.2)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    with open(args.master) as f:
        lines = [ln for ln in f if ln.strip()]
    labels = np.array([int(float(ln.rstrip("\n").split(" ")[-2]))
                       for ln in lines])
    n = len(lines)
    order = np.random.default_rng(args.seed).permutation(n)
    n_test = int(n * args.test_frac)
    n_val = int(n * args.val_frac)
    test_idx, val_idx = order[:n_test], order[n_test:n_test + n_val]
    train_idx = order[n_test + n_val:]

    os.makedirs(args.out, exist_ok=True)
    write_lines(os.path.join(args.out, "test_ds.txt"),
                [lines[i] for i in test_idx])
    write_lines(os.path.join(args.out, "val_ds.txt"),
                [lines[i] for i in val_idx])

    by_class = defaultdict(list)
    for i in train_idx:
        by_class[labels[i]].append(i)

    for ratio in args.ratios:
        for d in range(1 if ratio == 1 else args.draws):
            # float hashes do not depend on PYTHONHASHSEED
            drng = np.random.default_rng(args.seed + 1000 * d
                                         + hash(ratio) % 997)
            labeled = []
            for idxs in by_class.values():
                take = max(1, int(round(len(idxs) * ratio)))
                labeled.extend(drng.choice(idxs, take, replace=False))
            labeled = sorted(labeled)
            unlabeled = sorted(set(train_idx) - set(labeled))
            write_lines(mf.split_manifest_path(args.out, ratio, d),
                        [lines[i] for i in labeled])
            write_lines(mf.split_manifest_path(args.out, ratio, d,
                                               labeled=False),
                        [lines[i] for i in (unlabeled or labeled)])
            print(f"ratio {ratio} draw {d}: {len(labeled)} labeled / "
                  f"{len(unlabeled)} unlabeled")
    print(f"val {n_val} / test {n_test} / train pool {len(train_idx)}")


if __name__ == "__main__":
    main()
