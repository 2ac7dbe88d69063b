"""The device-resident canvas store, the port of
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
stores.

Under a process group of W ranks the store is sharded as JAX's is over a
W-device mesh (``_iter_sharded``, ``_make_sharded_gather``,
``fill_from_dataset(mesh=)``, :143-240): the rows are padded by wrapping to
a multiple of W, rank r decodes and holds only its contiguous block of
them, and each epoch it shuffles that block with
``np.random.default_rng((seed, epoch, r))`` and gathers its B/W rows a
step from it, with no communication. Each sample is seen once an epoch;
a batch holds B/W rows of every block."""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np
import torch

from mfvit_tpu_torch.parallel import dist


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
    ``iter_index_batches`` the index vectors alone.

    Sharded (``world`` > 1): the tensors hold rank ``rank``'s block of a
    table of ``world`` equal blocks, ``batch_size`` is the global batch
    and a batch is this rank's B/W rows of it; the indices are local to
    the block."""

    def __init__(self, canvases, labels: torch.Tensor, *, batch_size: int,
                 seed: int = 0, drop_last: bool = True, shuffle: bool = True,
                 num_samples: Optional[int] = None, world: int = 1,
                 rank: int = 0):
        multi = isinstance(canvases, (tuple, list))
        self._canvs = tuple(canvases) if multi else (canvases,)
        self.canvases = self._canvs if multi else canvases
        self.labels = labels
        self.device = labels.device
        self.world, self.rank = world, rank
        self.m = int(self._canvs[0].shape[0])  # rows held here
        self.n = self.m * world  # rows of the whole (padded) table
        self.bs = batch_size
        if world > 1 and batch_size % world:
            raise ValueError(f"sharded store needs the batch ({batch_size}) "
                             f"divisible by the ranks ({world})")
        self.local_bs = batch_size // world
        self.seed = seed
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.num_samples = num_samples if num_samples is not None else self.n
        self.ds = _SizedView(self.num_samples)
        self.epoch = 0

    def __len__(self) -> int:
        return (self.m // self.local_bs if self.drop_last
                else -(-self.m // self.local_bs))

    @property
    def nbytes(self) -> int:
        return sum(c.numel() * c.element_size() for c in self._canvs)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def index_batches(self, epoch: int) -> list:
        """The host (int32) index vectors of ``epoch``, in order: the
        global order of ``seed + epoch``, or sharded this rank's order of
        its block from ``(seed, epoch, rank)``."""
        m, bs = self.m, self.local_bs
        if self.world > 1:
            idx = (np.random.default_rng((self.seed, epoch, self.rank))
                   .permutation(m) if self.shuffle else np.arange(m))
        else:
            idx = np.arange(m)
            if self.shuffle:
                np.random.default_rng(self.seed + epoch).shuffle(idx)
        stop = m - (m % bs if self.drop_last else 0)
        out = []
        for s in range(0, stop, bs):
            chunk = idx[s:s + bs]
            if len(chunk) < bs:
                # wrap-and-tile, as BatchLoader pads (also when the whole
                # split is smaller than one batch)
                reps = -(-(bs - len(chunk)) // max(m, 1))
                chunk = np.concatenate(
                    [chunk, np.tile(idx, reps)[: bs - len(chunk)]])
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
                      shuffle: bool = True, world: Optional[int] = None,
                      rank: Optional[int] = None) -> DeviceCanvasStore:
    """One threaded host pass over ``ds`` into a ``DeviceCanvasStore`` on
    ``device``. ``ds[i]`` must give fixed-size uint8 canvases and a label
    (a deterministic transform, such as an eval ``CanvasTransform``): the
    per-epoch flips, rotations and crops are drawn on the device.

    ``world`` and ``rank`` default to the process group's. With more than
    one rank the rows are padded by wrapping to a multiple of ``world``
    and this rank decodes only its block (``dist.local_row_block``)."""
    world = dist.world() if world is None else world
    rank = dist.rank() if rank is None else rank
    rows = list(range(len(ds)))
    if world > 1 and len(rows) % world:
        rows = rows + rows[: world - len(rows) % world]
    lo, hi = dist.local_row_block(len(rows), world, rank)
    with ThreadPoolExecutor(num_workers) as pool:
        samples = list(pool.map(ds.__getitem__, rows[lo:hi]))
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
        shuffle=shuffle, num_samples=len(ds), world=world, rank=rank)
