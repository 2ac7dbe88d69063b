"""Metrics and meters, the port's own copy of ``mfvit_tpu/train/metrics.py``
(numpy only): macro one-vs-rest ROC-AUC on raw logits, top-1 and top-k
accuracy, macro precision/recall/F1, and the reference's AverageMeter /
ProgressMeter display contract."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def binary_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """ROC-AUC for one binary problem. Equivalent to sklearn
    ``auc(roc_curve(labels, scores))`` (trapezoid over the ROC staircase;
    equal to the Mann-Whitney U statistic)."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels)
    if np.isnan(scores).any():
        # NaN comparisons are all False, which would silently yield a
        # plausible-looking 0.0 for diverged (NaN-logit) models; sklearn
        # raises here — propagate NaN so divergence stays visible
        return float("nan")
    pos = scores[labels == 1]
    neg = scores[labels != 1]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    # Mann-Whitney with tie correction via average ranks.
    all_s = np.concatenate([pos, neg])
    order = np.argsort(all_s, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(all_s) + 1)
    # average ranks for ties
    sorted_s = all_s[order]
    i = 0
    while i < len(sorted_s):
        j = i
        while j + 1 < len(sorted_s) and sorted_s[j + 1] == sorted_s[i]:
            j += 1
        if j > i:
            avg = (i + j + 2) / 2.0
            ranks[order[i:j + 1]] = avg
        i = j + 1
    r_pos = ranks[: len(pos)].sum()
    u = r_pos - len(pos) * (len(pos) + 1) / 2.0
    return float(u / (len(pos) * len(neg)))


def macro_ovr_auc(logits: np.ndarray, labels: np.ndarray,
                  num_classes: int = 3) -> float:
    """Macro-average one-vs-rest AUC over classes, on raw logits —
    the reference's 3-class metric (finetune :737-745)."""
    aucs = []
    for c in range(num_classes):
        aucs.append(binary_auc(logits[:, c], (labels == c).astype(np.int32)))
    if np.all(np.isnan(aucs)):
        # all per-class AUCs undefined (e.g. diverged NaN logits) — the
        # macro average is NaN by design; skip nanmean's empty-slice warn
        return float("nan")
    return float(np.nanmean(aucs))


def top1_acc(logits: np.ndarray, labels: np.ndarray) -> float:
    return float((logits.argmax(-1) == labels).mean())


def topk_acc(logits: np.ndarray, labels: np.ndarray, k: int = 1) -> float:
    """evaluator.py:60-64."""
    topk = np.argsort(-logits, axis=-1)[:, :k]
    return float((topk == labels[:, None]).any(-1).mean())


def precision_recall_f1(logits: np.ndarray, labels: np.ndarray,
                        num_classes: int = 3) -> Dict[str, float]:
    """Macro precision/recall/F1 over the argmax predictions, a class with
    no predictions (or no labels) counting 0 (the reference README's
    metrics)."""
    pred = logits.argmax(-1)
    ps, rs, fs = [], [], []
    for c in range(num_classes):
        tp = np.sum((pred == c) & (labels == c))
        fp = np.sum((pred == c) & (labels != c))
        fn = np.sum((pred != c) & (labels == c))
        p = tp / (tp + fp) if tp + fp else 0.0
        r = tp / (tp + fn) if tp + fn else 0.0
        f = 2 * p * r / (p + r) if p + r else 0.0
        ps.append(p)
        rs.append(r)
        fs.append(f)
    return {"precision": float(np.mean(ps)), "recall": float(np.mean(rs)),
            "f1": float(np.mean(fs))}


class DeferredFetch:
    """One-step-lagged device-scalar fetch for training hot loops.

    ``float(loss)`` forces a device sync every step; the reference pays
    the equivalent CUDA sync via ``loss.item()`` (pretrain main :540).
    Deferring the fetch one iteration keeps the host enqueueing step i+1
    while the card runs step i. The display/meter consequently lags one
    step (``sync=True`` on step 0 keeps the first progress line real).
    Call ``flush()`` after the loop so the final step is counted."""

    def __init__(self, sink):
        self._pending = None
        self._sink = sink  # sink(value: float, n: int, idx: int)

    def push(self, scalar, n: int, idx: int, sync: bool = False) -> None:
        self.flush()
        if sync:
            self._sink(float(scalar), n, idx)
        else:
            self._pending = (scalar, n, idx)

    def flush(self) -> None:
        if self._pending is not None:
            s, n, idx = self._pending
            self._pending = None
            self._sink(float(s), n, idx)


class AverageMeter:
    """Running average meter (meters.py:3-37 / pretrain main :567-589)."""

    def __init__(self, name: str, fmt: str = ":f"):
        self.name, self.fmt = name, fmt
        self.reset()

    def reset(self):
        self.val = self.avg = self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __str__(self):
        fmtstr = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        # the reference newline-terminates the 'Loss' meter specifically
        # (meters.py:32-37) — replicated for log-format parity
        if self.name == "Loss":
            fmtstr += "\n"
        return fmtstr.format(name=self.name, val=self.val, avg=self.avg)


class ProgressMeter:
    """Batch progress printer (meters.py:40-58)."""

    def __init__(self, num_batches: int, meters: Sequence[AverageMeter],
                 prefix: str = ""):
        self.fmt = self._batch_fmtstr(num_batches)
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int):
        entries = [self.prefix + self.fmt.format(batch)]
        entries += [str(m) for m in self.meters]
        print("\t".join(entries))

    @staticmethod
    def _batch_fmtstr(num_batches: int) -> str:
        num_digits = len(str(num_batches // 1))
        fmt = "{:" + str(num_digits) + "d}"
        return "[" + fmt + "/" + fmt.format(num_batches) + "]"
