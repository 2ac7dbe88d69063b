"""``CovidPairedDataset``: jointly indexed CXR + enhanced pairs, the port of
``mfvit_tpu/data/datasets.py::CovidPairedDataset`` (pairing by sample index,
by construction)."""
from __future__ import annotations

from typing import Callable

import numpy as np

from mfvit_tpu_torch.data.host_transforms import decode_bgr
from mfvit_tpu_torch.data.manifest import parse_covid_paired


class CovidPairedDataset:
    """(img_cxr, img_enh, label) per index: the 'data' and 'Train_Mix'
    images of one manifest row, each decoded and put through
    ``transform`` (the eval transform has no random draws)."""

    def __init__(self, img_csv: str,
                 transform: Callable[[np.ndarray], np.ndarray]):
        self.manifest = parse_covid_paired(img_csv)
        self.transform = transform

    def __len__(self):
        return len(self.manifest)

    def __getitem__(self, idx: int):
        return (self.transform(decode_bgr(self.manifest.paths[idx])),
                self.transform(decode_bgr(self.manifest.paths_alt[idx])),
                self.manifest.labels[idx])
