"""Host batch assembly for serving: ``BatchLoader`` in eval order (the
serving subset of ``mfvit_tpu/data/pipeline.py``). Worker threads decode
(cv2 and PIL release the GIL), a bounded queue keeps a few batches ready,
and the last short batch is padded by wrapping (``pad_final`` in the JAX
package) so every batch has the same shape; the caller trims with
``len(loader.ds)``."""
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
    """Batches of ``dataset`` in index order."""

    PREFETCH = 3  # batches kept ready ahead of the consumer

    def __init__(self, dataset, batch_size: int, *, num_workers: int = 8):
        self.ds = dataset
        self.bs = batch_size
        self.num_workers = num_workers

    def __len__(self) -> int:
        return -(-len(self.ds) // self.bs)

    def _batches(self) -> list:
        idx = np.arange(len(self.ds))
        out = []
        for s in range(0, len(idx), self.bs):
            chunk = idx[s:s + self.bs]
            if len(chunk) < self.bs:
                # wrap-and-tile: fills the batch even when the dataset is
                # smaller than batch_size
                reps = -(-(self.bs - len(chunk)) // len(idx))
                chunk = np.concatenate(
                    [chunk, np.tile(idx, reps)[: self.bs - len(chunk)]])
            out.append(chunk)
        return out

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.PREFETCH)
        stop = threading.Event()

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in self._batches():
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
