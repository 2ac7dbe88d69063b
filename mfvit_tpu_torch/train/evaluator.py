"""Metric-driven evaluation loop, the port's own copy of
``mfvit_tpu/train/evaluator.py``: ``Evaluator`` walks a loader, runs a
forward, accumulates (logits, labels) on the host and computes a metric
dict."""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np

from mfvit_tpu_torch.train import metrics as metrics_mod

METRIC_FNS: Dict[str, Callable] = {
    "auc": lambda lg, lb: metrics_mod.macro_ovr_auc(lg, lb, lg.shape[-1]),
    "acc": metrics_mod.top1_acc,
}


class Evaluator:
    """Accumulate (logits, labels) over a loader and compute the requested
    metrics. ``forward(batch) -> (logits, labels)`` adapts the batch
    layout; ``n_total`` trims padded final batches."""

    def __init__(self, forward: Callable,
                 metric_names: Iterable[str] = ("auc", "acc")):
        self.forward = forward
        self.metric_names = list(metric_names)

    def evaluate(self, loader, n_total: Optional[int] = None) -> Dict[str, Any]:
        logits_all: List[np.ndarray] = []
        labels_all: List[np.ndarray] = []
        seen = 0
        for batch in loader:
            logits, labels = self.forward(batch)
            logits = np.asarray(logits)
            labels = np.asarray(labels)
            if n_total is not None:
                take = min(len(logits), n_total - seen)
                logits, labels = logits[:take], labels[:take]
                seen += take
            logits_all.append(logits)
            labels_all.append(labels)
        if not logits_all:
            raise ValueError(
                "Evaluator got an empty loader (0 batches) — check the "
                "val/test manifest paths")
        logits, labels = np.concatenate(logits_all), np.concatenate(labels_all)
        results = {name: METRIC_FNS[name](logits, labels)
                   for name in self.metric_names}
        results["n"] = len(labels)
        results["logits"] = logits
        results["labels"] = labels
        return results
