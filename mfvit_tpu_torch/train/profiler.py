"""``StepTimer``, the port of ``mfvit_tpu/train/profiler.py:23``: data-wait
and step wall-clock meters with the reference hot loops' display contract
(the same printed lines)."""
from __future__ import annotations

import time

from mfvit_tpu_torch.train.metrics import AverageMeter, ProgressMeter


class StepTimer:
    """Tracks data-wait and step wall-clock like the reference's
    batch_time/data_time meters."""

    def __init__(self, num_batches: int, prefix: str = "",
                 extra_meters=()):
        self.batch_time = AverageMeter("Time", ":6.3f")
        self.data_time = AverageMeter("Data", ":6.3f")
        self.progress = ProgressMeter(
            num_batches,
            [self.batch_time, self.data_time, *extra_meters],
            prefix=prefix)
        self._end = time.time()

    def data_ready(self):
        self.data_time.update(time.time() - self._end)

    def step_done(self, i: int, print_freq: int = 0):
        self.batch_time.update(time.time() - self._end)
        self._end = time.time()
        if print_freq and i % print_freq == 0:
            self.progress.display(i)
