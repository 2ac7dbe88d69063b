"""The device-resident canvas store, the single-device half of
``mfvit_tpu/data/device_store.py``: each image of a split is decoded and
resized once (``fill_from_dataset``) into a uint8 (N, S, S, C) table in
device memory (a tuple of two for the paired CXR + enhanced feed) beside
an int64 label vector, and every epoch after that draws shuffled batches
by a gather on the device, followed by the device augmentation
(``data/device_aug.py``). Only the index vector of a step crosses to the
device, from pinned memory and without blocking.

The shuffle is ``np.random.default_rng(seed + epoch)``, as
``BatchLoader``'s; a short final batch is filled by wrapping and tiling the
epoch's order. The fill needs fixed-size canvases: the square resize (no
``--maintain-ratio``) for the training store, the center crop for the eval
stores. The sharded form over several devices waits for DDP (ROADMAP.md
section 1, item 6)."""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np
import torch

_SHARDED = ("a sharded device canvas store (mesh) is not ported yet "
            "(ROADMAP.md section 1, item 6)")


class _SizedView:
    """Stands in for ``loader.ds`` where code asks ``len(loader.ds)``."""

    def __init__(self, n: int):
        self._n = n

    def __len__(self) -> int:
        return self._n


class DeviceCanvasStore:
    """uint8 canvases and (N,) labels on one device. ``canvases`` is one
    (N, S, S, C) tensor or a tuple of them; iterating yields ``(canv,
    label)`` or ``(canv_a, canv_b, label)`` batches on the device, and
    ``iter_index_batches`` the index vectors alone."""

    def __init__(self, canvases, labels: torch.Tensor, *, batch_size: int,
                 seed: int = 0, drop_last: bool = True, shuffle: bool = True,
                 num_samples: Optional[int] = None, mesh=None):
        if mesh is not None:
            raise NotImplementedError(_SHARDED)
        multi = isinstance(canvases, (tuple, list))
        self._canvs = tuple(canvases) if multi else (canvases,)
        self.canvases = self._canvs if multi else canvases
        self.labels = labels
        self.device = labels.device
        self.n = int(self._canvs[0].shape[0])
        self.bs = batch_size
        self.seed = seed
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.num_samples = num_samples if num_samples is not None else self.n
        self.ds = _SizedView(self.num_samples)
        self.epoch = 0

    def __len__(self) -> int:
        return (self.n // self.bs if self.drop_last
                else -(-self.n // self.bs))

    @property
    def nbytes(self) -> int:
        return sum(c.numel() * c.element_size() for c in self._canvs)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def index_batches(self, epoch: int) -> list:
        """The host (int32) index vectors of ``epoch``, in order."""
        idx = np.arange(self.n)
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        stop = self.n - (self.n % self.bs if self.drop_last else 0)
        out = []
        for s in range(0, stop, self.bs):
            chunk = idx[s:s + self.bs]
            if len(chunk) < self.bs:
                # wrap-and-tile, as BatchLoader pads (also when the whole
                # split is smaller than one batch)
                reps = -(-(self.bs - len(chunk)) // max(self.n, 1))
                chunk = np.concatenate(
                    [chunk, np.tile(idx, reps)[: self.bs - len(chunk)]])
            out.append(chunk.astype(np.int32))
        return out

    def iter_index_batches(self) -> Iterator[torch.Tensor]:
        """The index vectors of ``self.epoch`` (then the epoch advances)
        on the device: the only host-to-device copy of a step, 4 bytes a
        sample, from pinned memory without blocking."""
        epoch, self.epoch = self.epoch, self.epoch + 1
        pin = self.device.type == "cuda"
        for chunk in self.index_batches(epoch):
            host = torch.from_numpy(chunk)
            if pin:
                host = host.pin_memory()
            yield host.to(self.device, non_blocking=pin)

    def gather(self, idx: torch.Tensor) -> tuple:
        """(canv..., labels) rows ``idx`` of the table, on the device."""
        return tuple(c.index_select(0, idx) for c in self._canvs) + (
            self.labels.index_select(0, idx),)

    def __iter__(self):
        for idx in self.iter_index_batches():
            yield self.gather(idx)


def fill_from_dataset(ds, *, batch_size: int, device, seed: int = 0,
                      num_workers: int = 8, drop_last: bool = True,
                      shuffle: bool = True, mesh=None) -> DeviceCanvasStore:
    """One threaded host pass over ``ds`` into a ``DeviceCanvasStore`` on
    ``device``. ``ds[i]`` must give fixed-size uint8 canvases and a label
    (a deterministic transform, such as an eval ``CanvasTransform``): the
    per-epoch flips, rotations and crops are drawn on the device."""
    if mesh is not None:
        raise NotImplementedError(_SHARDED)
    with ThreadPoolExecutor(num_workers) as pool:
        samples = list(pool.map(ds.__getitem__, range(len(ds))))
    n_canv = len(samples[0]) - 1
    canvs = []
    for j in range(n_canv):
        c = np.stack([s[j] for s in samples])
        if c.dtype != np.uint8:
            raise ValueError("device store expects uint8 canvases (got "
                             f"{c.dtype}); host-transformed float paths "
                             "must stream")
        canvs.append(torch.from_numpy(c).to(device))
    labels = torch.from_numpy(
        np.asarray([s[-1] for s in samples], np.int64)).to(device)
    return DeviceCanvasStore(
        canvs[0] if n_canv == 1 else tuple(canvs), labels,
        batch_size=batch_size, seed=seed, drop_last=drop_last,
        shuffle=shuffle, num_samples=len(ds))
