"""COVID datasets, the port of ``mfvit_tpu/data/datasets.py``'s
``CovidDataset`` (one flavour, ``(image, label)``), ``CovidTwoCropsDataset``
(MoCo's two views of one image) and ``CovidPairedDataset`` (CXR + enhanced
pairs by sample index). A seeded transform gets the per-sample context
(epoch, index[, view]), so its draws do not depend on the loader's worker
count; ``BatchLoader`` calls ``set_epoch``."""
from __future__ import annotations

from typing import Callable

import numpy as np

from mfvit_tpu_torch.data.host_transforms import decode_bgr
from mfvit_tpu_torch.data.manifest import parse_covid, parse_covid_paired


def _apply_tf(tf: Callable, img: np.ndarray, ctx):
    """A seeded transform gets the (epoch, index) context; others do not."""
    if getattr(tf, "seed", None) is not None:
        return tf(img, ctx)
    return tf(img)


class _EpochMixin:
    _epoch: int = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch


class CovidDataset(_EpochMixin):
    """(image, label) of one flavour folder (``data`` or ``Train_Mix``)."""

    def __init__(self, folder: str, img_csv: str,
                 transform: Callable[[np.ndarray], np.ndarray]):
        self.manifest = parse_covid(img_csv, folder)
        self.transform = transform

    def __len__(self):
        return len(self.manifest)

    def __getitem__(self, idx: int):
        img = decode_bgr(self.manifest.paths[idx])
        return (_apply_tf(self.transform, img, (self._epoch, idx)),
                self.manifest.labels[idx])


class CovidTwoCropsDataset(CovidDataset):
    """(q, k, label): the same decoded image through the transform twice,
    with the contexts (epoch, index, 0) and (epoch, index, 1), so the two
    views draw their flips, angles and crops independently
    (``mfvit_tpu/data/datasets.py:84``, TwoCropsTransform)."""

    def __getitem__(self, idx: int):
        img = decode_bgr(self.manifest.paths[idx])
        return (_apply_tf(self.transform, img, (self._epoch, idx, 0)),
                _apply_tf(self.transform, img, (self._epoch, idx, 1)),
                self.manifest.labels[idx])


class CovidPairedDataset(_EpochMixin):
    """(img_cxr, img_enh, label) per index: the 'data' and 'Train_Mix'
    images of one manifest row, each decoded and put through its own
    transform (``transform_enh`` defaults to ``transform``). Training gives
    each branch its own seeded transform, so the two draw their flips,
    angles and crops independently, as the JAX package's do."""

    def __init__(self, img_csv: str,
                 transform: Callable[[np.ndarray], np.ndarray],
                 transform_enh: Callable[[np.ndarray], np.ndarray] | None
                 = None):
        self.manifest = parse_covid_paired(img_csv)
        self.transform = transform
        self.transform_enh = transform_enh or transform

    def __len__(self):
        return len(self.manifest)

    def __getitem__(self, idx: int):
        ctx = (self._epoch, idx)
        return (_apply_tf(self.transform,
                          decode_bgr(self.manifest.paths[idx]), ctx),
                _apply_tf(self.transform_enh,
                          decode_bgr(self.manifest.paths_alt[idx]), ctx),
                self.manifest.labels[idx])
