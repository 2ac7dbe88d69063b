"""Experiment storage layout, the port of ``mfvit_tpu/exp/storage.py``:
``{exp_name}_{exp_type}_{YYYYmmdd-HHMMSS}[_SLURM{jobid}]`` under a storage
root, with per-(ratio, draw) subfolders ``train_{ratio}_{iteration}`` and
the best-accuracy twin ``train_{ratio}_{iteration}_acc``. One process
writes (multi-process training is not ported yet)."""
from __future__ import annotations

import datetime
import os
from pathlib import Path

DEFAULT_ROOT = os.environ.get("MFVIT_STORAGE_ROOT", "self-learning/logdir")


def is_primary() -> bool:
    """True when this process writes shared experiment artifacts: rank 0
    of an initialised ``torch.distributed`` group, or the only process."""
    import torch.distributed as dist
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def get_storage_folder(exp_name: str, exp_type: str,
                       root: str | None = None) -> Path:
    jobid = os.environ.get("SLURM_JOB_ID")
    datestr = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    fname = f"{exp_name}_{exp_type}_{datestr}"
    if jobid is not None:
        fname += f"_SLURM{jobid}"
    base = Path(root or DEFAULT_ROOT) / fname
    path = base
    for k in range(1, 1000):
        try:
            os.makedirs(path)
            break
        except FileExistsError:
            # second-granularity timestamps collide when runs start
            # back to back: suffix instead of failing
            path = Path(f"{base}_{k}")
    print(f"Experiment storage is at {path}")
    return path


def get_storage_sub_folder(fname: Path, ratio, iteration: int,
                           acc: bool = False) -> Path:
    suffix = "_acc" if acc else ""
    path = Path(fname) / f"train_{ratio}_{iteration}{suffix}"
    os.makedirs(path, exist_ok=True)
    return path
