"""Host batch assembly, ``BatchLoader`` (the single-process subset of
``mfvit_tpu/data/pipeline.py``). Worker threads decode (cv2 and PIL release
the GIL) and a bounded queue keeps a few batches ready. Training loaders
shuffle with ``seed + epoch`` and drop the last short batch; eval loaders
keep the order and pad the last short batch by wrapping (``pad_final``) so
every batch has the same shape; the caller trims with ``len(loader.ds)``."""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence

import numpy as np


def _collate(samples: Sequence) -> tuple:
    """Stack a list of per-sample tuples field-wise."""
    return tuple(np.stack(f) for f in zip(*samples))


class BatchLoader:
    """Batches of ``dataset``: in index order with the last batch padded
    (the defaults, for eval), or with ``shuffle`` (epoch e shuffles with
    ``seed + e``) and ``drop_last`` for training."""

    PREFETCH = 3  # batches kept ready ahead of the consumer

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False,
                 num_workers: int = 8):
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.ds)
        return n // self.bs if self.drop_last else -(-n // self.bs)

    def set_epoch(self, epoch: int) -> None:
        """Pin the epoch of the next iteration's shuffle and augmentation
        context, so a run started at epoch E replays the draws of E."""
        self.epoch = epoch

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return idx

    def _batches(self) -> list:
        idx = self._epoch_indices()
        out = []
        for s in range(0, len(idx), self.bs):
            chunk = idx[s:s + self.bs]
            if len(chunk) < self.bs:
                if self.drop_last:
                    break
                # wrap-and-tile: fills the batch even when the dataset is
                # smaller than batch_size
                reps = -(-(self.bs - len(chunk)) // len(idx))
                chunk = np.concatenate(
                    [chunk, np.tile(idx, reps)[: self.bs - len(chunk)]])
            out.append(chunk)
        return out

    def __iter__(self) -> Iterator:
        batches = self._batches()
        if hasattr(self.ds, "set_epoch"):
            self.ds.set_epoch(self.epoch)
        self.epoch += 1
        q: queue.Queue = queue.Queue(maxsize=self.PREFETCH)
        stop = threading.Event()

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in batches:
                        if stop.is_set():
                            return
                        q.put(_collate(list(pool.map(self.ds.__getitem__,
                                                     b))))
                q.put(None)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                # a dead producer without a sentinel would block q.get()
                # forever; the consumer re-raises it
                q.put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while t.is_alive():  # drain so the producer can exit
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(timeout=0.1)
