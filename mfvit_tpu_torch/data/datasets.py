"""The datasets of ``mfvit_tpu/data/datasets.py``: ``CovidDataset`` (one
flavour, ``(image, label)``), ``CovidTwoCropsDataset`` (MoCo's two views
of one image), ``CovidPairedDataset`` (CXR + enhanced pairs by sample
index), the 4-channel stacked input (``Covid4chDataset``,
``Covid4chTwoCropsDataset``), the cross-modal MoCo pairs
(``CovidEnhCxrDataset``) and the CheXpert CSV datasets
(``ChexpertDataset``, ``ChexpertTwoCropsDataset``,
``ChexpertMixDataset``). A seeded transform gets the per-sample context
(epoch, index[, view]), so its draws do not depend on the loader's worker
count; ``BatchLoader`` calls ``set_epoch``. The mix decisions draw from
the same context salted with ``_MIX_SALT``. ``decode`` (default
``decode_bgr``) reads a path; a ``host_transforms.DecodeResizeCache``
there serves the decoded, resized image from RAM after the first epoch."""
from __future__ import annotations

import random
from typing import Callable, Optional

import numpy as np

from mfvit_tpu_torch.data.host_transforms import _rng_for, decode_bgr
from mfvit_tpu_torch.data.manifest import (parse_chexpert, parse_covid,
                                           parse_covid_paired)

# separates a dataset's mix decision from its transforms' streams, which
# use (epoch, idx[, view]): without it the query transform's first draw
# (its flip) would be the mix draw itself, so at per_enh=0.5 a CXR query
# would never flip
_MIX_SALT = 0x6D6978  # "mix"


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
                 transform: Callable[[np.ndarray], np.ndarray],
                 decode: Optional[Callable[[str], np.ndarray]] = None):
        self.manifest = parse_covid(img_csv, folder)
        self.transform = transform
        self.decode = decode or decode_bgr

    def __len__(self):
        return len(self.manifest)

    def __getitem__(self, idx: int):
        img = self.decode(self.manifest.paths[idx])
        return (_apply_tf(self.transform, img, (self._epoch, idx)),
                self.manifest.labels[idx])


class CovidTwoCropsDataset(CovidDataset):
    """(q, k, label): the same decoded image through the transform twice,
    with the contexts (epoch, index, 0) and (epoch, index, 1), so the two
    views draw their flips, angles and crops independently
    (``mfvit_tpu/data/datasets.py:84``, TwoCropsTransform)."""

    def __getitem__(self, idx: int):
        img = self.decode(self.manifest.paths[idx])
        return (_apply_tf(self.transform, img, (self._epoch, idx, 0)),
                _apply_tf(self.transform, img, (self._epoch, idx, 1)),
                self.manifest.labels[idx])


class CovidPairedDataset(_EpochMixin):
    """(img_cxr, img_enh, label) per index: the ``folder_cxr`` and
    ``folder_enh`` images of one manifest row, each decoded and put
    through its own transform (``transform_enh`` defaults to
    ``transform``). Training gives each branch its own seeded transform,
    so the two draw their flips, angles and crops independently, as the
    JAX package's do."""

    def __init__(self, img_csv: str,
                 transform: Callable[[np.ndarray], np.ndarray],
                 transform_enh: Callable[[np.ndarray], np.ndarray] | None
                 = None, folder_cxr: str = "data",
                 folder_enh: str = "Train_Mix",
                 decode: Optional[Callable[[str], np.ndarray]] = None):
        self.manifest = parse_covid_paired(img_csv, folder_cxr, folder_enh)
        self.transform = transform
        self.transform_enh = transform_enh or transform
        self.decode = decode or decode_bgr

    def __len__(self):
        return len(self.manifest)

    def __getitem__(self, idx: int):
        ctx = (self._epoch, idx)
        return (_apply_tf(self.transform,
                          self.decode(self.manifest.paths[idx]), ctx),
                _apply_tf(self.transform_enh,
                          self.decode(self.manifest.paths_alt[idx]), ctx),
                self.manifest.labels[idx])


def _stack_4ch(cxr: np.ndarray, enh: np.ndarray) -> np.ndarray:
    """The CXR's R channel (BGR order) and the enhanced B, G and R."""
    return np.concatenate((cxr, enh), axis=2)[:, :, 2:]


class Covid4chDataset(_EpochMixin):
    """(image, label) of the stacked CXR-gray + enhanced input, 4
    channels (the reference's ``Dataset_covid_4ch``)."""

    def __init__(self, img_csv: str, transform: Callable, *,
                 folder_cxr: str = "data", folder_enh: str = "Train_Mix",
                 decode: Optional[Callable[[str], np.ndarray]] = None):
        self.manifest = parse_covid_paired(img_csv, folder_cxr, folder_enh)
        self.transform = transform
        self.decode = decode or decode_bgr

    def __len__(self):
        return len(self.manifest)

    def _stacked(self, idx: int) -> np.ndarray:
        return _stack_4ch(self.decode(self.manifest.paths[idx]),
                          self.decode(self.manifest.paths_alt[idx]))

    def __getitem__(self, idx: int):
        return (_apply_tf(self.transform, self._stacked(idx),
                          (self._epoch, idx)),
                self.manifest.labels[idx])


class Covid4chTwoCropsDataset(Covid4chDataset):
    """(q, k, label): the stacked image through the transform twice, with
    the contexts (epoch, index, 0) and (epoch, index, 1)."""

    def __getitem__(self, idx: int):
        img = self._stacked(idx)
        return (_apply_tf(self.transform, img, (self._epoch, idx, 0)),
                _apply_tf(self.transform, img, (self._epoch, idx, 1)),
                self.manifest.labels[idx])


class CovidEnhCxrDataset(_EpochMixin):
    """(q, k, label) of the cross-modal pairing: q the enhanced image
    through ``transform_enh``, k the CXR through ``transform_cxr``
    (``Dataset_covid_LEnh_RCXR_2norms``). With ``per_enh`` < 1 the query
    is the CXR through ``transform_cxr`` with probability 1 - per_enh
    (the mix variant)."""

    def __init__(self, img_csv: str, transform_cxr: Callable,
                 transform_enh: Callable, per_enh: float = 1.0,
                 seed: Optional[int] = 0, *, folder_cxr: str = "data",
                 folder_enh: str = "Train_Mix",
                 decode: Optional[Callable[[str], np.ndarray]] = None):
        self.manifest = parse_covid_paired(img_csv, folder_cxr, folder_enh)
        self.transform_cxr = transform_cxr
        self.transform_enh = transform_enh
        self.per_enh = per_enh
        self.seed = seed
        self._rng = random.Random(seed)
        self.decode = decode or decode_bgr

    def __len__(self):
        return len(self.manifest)

    def __getitem__(self, idx: int):
        ctx = (self._epoch, idx)
        r = _rng_for(self.seed, self._rng, ctx + (_MIX_SALT,))
        cxr = self.decode(self.manifest.paths[idx])
        if self.per_enh >= 1.0 or r.random() <= self.per_enh:
            q = _apply_tf(self.transform_enh,
                          self.decode(self.manifest.paths_alt[idx]), ctx)
        else:
            q = _apply_tf(self.transform_cxr, cxr, ctx)
        k = _apply_tf(self.transform_cxr, cxr, ctx + (1,))
        return q, k, self.manifest.labels[idx]


class ChexpertDataset(_EpochMixin):
    """(image, label) of a CheXpert CSV, the label from the
    ``disease_name`` column."""

    def __init__(self, folder: str, img_csv: str, transform: Callable,
                 disease_name: str):
        self.manifest = parse_chexpert(img_csv, folder, disease_name)
        self.transform = transform

    def __len__(self):
        return len(self.manifest)

    def __getitem__(self, idx: int):
        img = decode_bgr(self.manifest.paths[idx])
        return (_apply_tf(self.transform, img, (self._epoch, idx)),
                self.manifest.labels[idx])


class ChexpertTwoCropsDataset(ChexpertDataset):
    """(q, k, label): the reference ``Dataset``'s own contract, the
    transform twice on one image."""

    def __getitem__(self, idx: int):
        img = decode_bgr(self.manifest.paths[idx])
        return (_apply_tf(self.transform, img, (self._epoch, idx, 0)),
                _apply_tf(self.transform, img, (self._epoch, idx, 1)),
                self.manifest.labels[idx])


class ChexpertMixDataset(_EpochMixin):
    """(q, k, label) over paired CheXpert CXR / enhanced images.
    ``mode='norm1'`` (``Dataset_Mix_norm1``): both views from the enhanced
    image with probability ``per_enh``, else from the CXR, both through
    ``transform_cxr``. ``mode='mix'`` (``Dataset_Mix``): with probability
    1 - per_enh both views from the CXR, else q from the CXR and k from
    the enhanced image through ``transform_enh``."""

    def __init__(self, folder_cxr: str, folder_enh: str, img_csv: str,
                 transform_cxr: Callable, transform_enh: Callable,
                 disease_name: str, per_enh: float, mode: str = "mix",
                 seed: Optional[int] = 0):
        self.m_cxr = parse_chexpert(img_csv, folder_cxr, disease_name)
        self.m_enh = parse_chexpert(img_csv, folder_enh, disease_name)
        self.transform_cxr = transform_cxr
        self.transform_enh = transform_enh
        self.per_enh = per_enh
        self.mode = mode
        self.seed = seed
        self._rng = random.Random(seed)

    def __len__(self):
        return len(self.m_cxr)

    def __getitem__(self, idx: int):
        ctx = (self._epoch, idx)
        r = _rng_for(self.seed, self._rng, ctx + (_MIX_SALT,))
        if self.mode == "norm1":
            src = self.m_enh if r.random() <= self.per_enh else self.m_cxr
            img = decode_bgr(src.paths[idx])
            q = _apply_tf(self.transform_cxr, img, ctx)
            k = _apply_tf(self.transform_cxr, img, ctx + (1,))
        else:
            cxr = decode_bgr(self.m_cxr.paths[idx])
            if r.random() < 1.0 - self.per_enh:
                k_img, k_tf = cxr, self.transform_cxr
            else:
                k_img = decode_bgr(self.m_enh.paths[idx])
                k_tf = self.transform_enh
            q = _apply_tf(self.transform_cxr, cxr, ctx)
            k = _apply_tf(k_tf, k_img, ctx + (1,))
        return q, k, self.m_cxr.labels[idx]
