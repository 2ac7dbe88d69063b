"""Manifest parsing and writing, and the split-manifest naming of the
5-draws harness (the port of ``mfvit_tpu/data/manifest.py``):

- COVID manifests: space-separated lines
  ``<idx> <root> <filename> <label> <extra>``; ``path = join(root,
  folder, filename)`` where ``folder`` selects the flavour (``data`` =
  original CXR, ``Train_Mix`` = enhanced) and ``label = fields[-2]``.
- CheXpert CSVs: a header row, the disease column looked up by name, the
  label remap ``CHEXPERT_LABEL_MAP``; ``path = join(folder, fields[1])``."""
from __future__ import annotations

import dataclasses
import os
from typing import List, Sequence

import numpy as np

CHEXPERT_LABEL_MAP = {"1.0": "1", "": "0", "0.0": "0", "-1.0": "1"}


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


def parse_covid_paired(img_csv: str, folder_cxr: str = "data",
                       folder_enh: str = "Train_Mix") -> Manifest:
    """One manifest -> both flavours, jointly indexed."""
    cxr = parse_covid(img_csv, folder_cxr)
    enh = parse_covid(img_csv, folder_enh)
    return Manifest(cxr.paths, cxr.labels, paths_alt=enh.paths)


def parse_chexpert(img_csv: str, folder: str, disease_name: str) -> Manifest:
    """A CheXpert-style CSV: the header names the disease column; CRLF
    line ends are stripped and short lines skipped."""
    paths, labels = [], []
    with open(img_csv) as f:
        header = f.readline().rstrip("\r\n").split(",")
        idx = [i for i, h in enumerate(header) if h == disease_name]
        if not idx:
            raise ValueError(f"disease {disease_name!r} not in header {header}")
        col = idx[0]
        for line in f:
            fields = line.rstrip("\r\n").split(",")
            if len(fields) <= max(col, 1):
                continue
            paths.append(os.path.join(folder, fields[1]))
            labels.append(int(CHEXPERT_LABEL_MAP[fields[col]]))
    return Manifest(paths, np.asarray(labels, np.int32))


def split_manifest_path(root: str, ratio: float, draw: int, *,
                        labeled: bool = True) -> str:
    """``{ratio}_{labeled|unlabeled}_train_{draw}.txt`` under ``root``, the
    ratio formatted as the reference writes it (``ratio_tag``)."""
    kind = "labeled" if labeled else "unlabeled"
    return os.path.join(root, f"{ratio_tag(ratio)}_{kind}_train_{draw}.txt")


def ratio_tag(ratio: float):
    """Integral ratios print as ints (``train_1_0``), fractional verbatim
    (``0.1_labeled_train_0.txt``)."""
    return int(ratio) if float(ratio) == int(ratio) else ratio


def eval_manifest_paths(root: str) -> tuple:
    return os.path.join(root, "val_ds.txt"), os.path.join(root, "test_ds.txt")


def write_covid_manifest(path: str, data_root: str, filenames: Sequence[str],
                         labels: Sequence[int]) -> None:
    with open(path, "w") as f:
        for i, (fn, lb) in enumerate(zip(filenames, labels)):
            f.write(f"{i} {data_root} {fn} {lb} .\n")
