"""Host batch assembly, ``BatchLoader``, the port of
``mfvit_tpu/data/pipeline.py``. Worker threads decode (cv2 and PIL release
the GIL) and a bounded queue keeps a few batches ready. Training loaders
shuffle with ``seed + epoch`` and drop the last short batch; eval loaders
keep the order and pad the last short batch by wrapping (``pad_final``) so
every batch has the same shape; the caller trims with ``len(loader.ds)``.
Under a process group each rank decodes only its row block of every
global batch (the ``DistributedSampler`` contract).
``device_prefetch`` moves the batches to the card one step ahead, from
pinned memory on a side CUDA stream."""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from mfvit_tpu_torch.parallel import dist


def _collate(samples: Sequence) -> tuple:
    """Stack a list of per-sample tuples field-wise."""
    return tuple(np.stack(f) for f in zip(*samples))


class BatchLoader:
    """Batches of ``dataset``: in index order with the last batch padded
    (the defaults, for eval), or with ``shuffle`` (epoch e shuffles with
    ``seed + e``) and ``drop_last`` for training.

    ``batch_size`` is the global batch. Of ``process_count`` ranks, rank
    ``process_index`` yields rows [i B/P, (i + 1) B/P) of each global
    batch, which every rank computes alike (``mfvit_tpu/data/pipeline.py``
    :40-80, :122-127): the ranks' blocks in rank order are the
    one-process batch. Both default to the process group's (one process
    outside a group)."""

    PREFETCH = 3  # batches kept ready ahead of the consumer

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False,
                 num_workers: int = 8, process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.epoch = 0
        if process_count is None:
            process_count = dist.world()
        if process_index is None:
            process_index = dist.rank() if process_count > 1 else 0
        if batch_size % process_count:
            raise ValueError(f"batch {batch_size} not divisible by "
                             f"process_count {process_count}")
        self.process_index, self.process_count = process_index, process_count

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
            if self.process_count > 1:
                # sliced after the global batching, so the blocks make up
                # the one-process batch
                local = self.bs // self.process_count
                chunk = chunk[self.process_index * local:
                              (self.process_index + 1) * local]
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


def device_prefetch(it: Iterator, device) -> Iterator:
    """The batches of ``it`` (tuples of numpy arrays) as tuples of tensors
    on ``device``. On CUDA each batch is pinned and copied on a side stream
    one step ahead of its use; the consumer's stream waits on the copy's
    event and the tensors are recorded on it, so the caching allocator
    does not reuse their memory early. On the CPU the arrays pass through
    as tensors that share their memory."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in it:
            yield tuple(torch.from_numpy(np.asarray(x)) for x in batch)
        return
    side = torch.cuda.Stream(device)
    pending = []

    def put(batch):
        host = [torch.from_numpy(np.asarray(x)).pin_memory() for x in batch]
        with torch.cuda.stream(side):
            out = tuple(h.to(device, non_blocking=True) for h in host)
            ev = torch.cuda.Event()
            ev.record(side)
        return out, ev

    def take():
        out, ev = pending.pop(0)
        cur = torch.cuda.current_stream(device)
        cur.wait_event(ev)
        for t in out:
            t.record_stream(cur)
        return out

    for batch in it:
        pending.append(put(batch))
        if len(pending) == 2:
            yield take()
    while pending:
        yield take()
