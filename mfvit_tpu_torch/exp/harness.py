"""Semi-supervised 5-draws experiment harness, the port of
``mfvit_tpu/exp/harness.py``: for each labeled fraction run its draws, each
with its own split manifest, checkpoint subfolder and TensorBoard writer;
collect per-(ratio, draw) test AUC/ACC and write them after every draw
(pickles and JSON); the ``commandline_args.txt`` snapshot; and the LP
``verify_frozen`` check. Every file is rank 0's."""
from __future__ import annotations

import json
import os
import pickle
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from mfvit_tpu_torch.exp import storage

# The reference's draw-count table (finetune :242-256): 5 draws per
# fractional ratio, a single draw at ratio 1.
DEFAULT_SEMI_ITERATIONS = {
    0.0005: 5, 0.00075: 5, 0.0009: 5, 0.001: 5, 0.0025: 5, 0.005: 5,
    0.01: 5, 0.1: 5, 0.2: 5, 0.3: 5, 0.5: 5, 0.7: 5, 0.9: 5, 1: 1,
}


def draws_for(ratio, table: Optional[Dict] = None) -> int:
    table = table or DEFAULT_SEMI_ITERATIONS
    return table.get(ratio, table.get(float(ratio), 5))


def snapshot_args(folder: Path, args: Any) -> None:
    """``commandline_args.txt`` JSON dump of the full config namespace,
    written by the primary process."""
    if not storage.is_primary():
        return
    d = vars(args) if hasattr(args, "__dict__") else dict(args)
    with open(Path(folder) / "commandline_args.txt", "w") as f:
        json.dump({k: repr(v) if not isinstance(
            v, (int, float, str, bool, list, type(None))) else v
            for k, v in d.items()}, f, indent=2)


@dataclass
class DrawResult:
    ratio: Any
    draw: int
    test_auc: float = float("nan")
    test_acc: float = float("nan")
    extra: Dict[str, Any] = field(default_factory=dict)


def summary_writer_cls():
    """``tensorboardX.SummaryWriter``, or None where it is not installed
    (then no run writes TensorBoard events, as in JAX)."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter


def run_draws(exp_folder: Path, ratios: Sequence, train_one_draw: Callable,
              *, iterations: Optional[Dict] = None,
              tb_prefix: str = "tb_train_val_test") -> List[DrawResult]:
    """Run the ratio x draw grid (``mfvit_tpu/exp/harness.py:65-104``).

    ``train_one_draw(ratio, draw, sub_folder, writer) -> DrawResult`` does
    the actual training and evaluation; ``writer`` is the draw's
    ``tensorboardX.SummaryWriter`` under ``{tb_prefix}_{ratio}_{draw}``,
    on rank 0 where tensorboardX imports, else None. Returns all results
    and pickles the AUC/ACC matrices next to the experiment folder
    (finetune :641-644), JSON alongside."""
    results: List[DrawResult] = []
    all_auc, all_acc = [], []
    primary = storage.is_primary()
    writer_cls = summary_writer_cls() if primary else None

    def dump():
        # written after EVERY draw (and in the crash path): a failure in
        # draw N must not discard days of completed-draw metrics.
        if not primary:
            return
        with open(Path(exp_folder) / "all_test_auc.pickle", "wb") as f:
            pickle.dump(all_auc, f)
        with open(Path(exp_folder) / "all_test_acc.pickle", "wb") as f:
            pickle.dump(all_acc, f)
        with open(Path(exp_folder) / "results.json", "w") as f:
            json.dump([{"ratio": r.ratio, "draw": r.draw,
                        "test_auc": r.test_auc, "test_acc": r.test_acc,
                        **r.extra} for r in results],
                      f, indent=2, default=float)

    try:
        for s in ratios:
            ratio_auc, ratio_acc = [], []
            all_auc.append(ratio_auc)
            all_acc.append(ratio_acc)
            for it in range(draws_for(s, iterations)):
                sub = storage.get_storage_sub_folder(exp_folder, s, it)
                writer = None
                if writer_cls is not None:
                    writer = writer_cls(os.path.join(exp_folder,
                                                     f"{tb_prefix}_{s}_{it}"))
                try:
                    res = train_one_draw(s, it, sub, writer)
                finally:
                    if writer is not None:
                        writer.close()
                results.append(res)
                ratio_auc.append(res.test_auc)
                ratio_acc.append(res.test_acc)
                dump()
    finally:
        dump()
    return results


def verify_frozen(state: dict, snapshot: dict) -> None:
    """Raise ValueError unless every non-head entry of ``state`` (a state
    dict) is bit-identical to ``snapshot``: the reference's post-LP
    ``sanity_check``, a regression test for optimizer leakage through a
    bad trainable mask. Only the top-level ``head.`` entries are exempt."""
    for name, v in snapshot.items():
        if name.split(".")[0] == "head":
            continue
        if name not in state:
            raise ValueError(f"sanity check failed: frozen weight {name} "
                             "is missing from the live parameters")
        if not torch.equal(state[name].detach().cpu(), v.detach().cpu()):
            raise ValueError(f"sanity check failed: frozen weight {name} "
                             "changed during training")
