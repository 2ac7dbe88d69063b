"""COVID manifest parsing and writing (the serving subset of
``mfvit_tpu/data/manifest.py``): space-separated lines
``<idx> <root> <filename> <label> <extra>``; ``path = join(root, folder,
filename)`` where ``folder`` selects the flavour (``data`` = original CXR,
``Train_Mix`` = enhanced) and ``label = fields[-2]``."""
from __future__ import annotations

import dataclasses
import os
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass
class Manifest:
    """Resolved image paths and integer labels; for paired flavours
    ``paths`` is the CXR path and ``paths_alt`` the enhanced one."""

    paths: List[str]
    labels: np.ndarray  # (N,) int32
    paths_alt: List[str] = dataclasses.field(default_factory=list)

    def __len__(self) -> int:
        return len(self.paths)


def parse_covid(img_csv: str, folder: str) -> Manifest:
    paths, labels = [], []
    with open(img_csv) as f:
        for line in f:
            fields = line.rstrip("\n").split(" ")
            if len(fields) < 3:
                continue
            paths.append(os.path.join(fields[1], folder, fields[2]))
            labels.append(int(float(fields[-2])))
    return Manifest(paths, np.asarray(labels, np.int32))


def parse_covid_paired(img_csv: str) -> Manifest:
    """One manifest -> both flavours ('data', 'Train_Mix'), jointly
    indexed."""
    cxr = parse_covid(img_csv, "data")
    enh = parse_covid(img_csv, "Train_Mix")
    return Manifest(cxr.paths, cxr.labels, paths_alt=enh.paths)


def write_covid_manifest(path: str, data_root: str, filenames: Sequence[str],
                         labels: Sequence[int]) -> None:
    with open(path, "w") as f:
        for i, (fn, lb) in enumerate(zip(filenames, labels)):
            f.write(f"{i} {data_root} {fn} {lb} .\n")
