"""``--remat``'s activation memory against the step rate, the port of
``tools/bench_remat.py``.

    python -m mfvit_tpu_torch.tools.bench_remat [arch] [B] [reversed] \\
        [--device cuda]

The classifier step (``train.steps.make_classifier_steps``) of ``arch``
(vit_base unless given) at B (256 unless given), SGD 0.01 with momentum
0.9, once without and once with ``remat`` (``reversed``: with first), each
from a copy of the same seeded weights, on the same images N(0, 1) in
bf16 and labels drawn by ``np.random.default_rng(0)`` (JAX :21-38). Each
runs 4 warm-up steps with the loss fetched, then 10 steps with the loss
fetched one step behind, and prints the memory reading and images/s (JAX
:48-67).

The memory reading: JAX reads XLA's compile-time ``temp_size_in_bytes``
(activations and workspace, :45-46), which torch does not have. The port
reads the peak of ``torch.cuda.max_memory_allocated`` over the last
warm-up step, after ``reset_peak_memory_stats``, less
``memory_allocated`` before it: what the step allocates above the
weights, gradients and optimizer state it starts with, its activations
and workspace, printed as "step peak above its start". The port's
``remat`` is ``torch.utils.checkpoint`` per block (``nn/vit.py``), so
each block's forward kernels run again in the backward: per step K1 24,
K2 22, K3 2 under ``remat`` against K1 12, K2 11, K3 1 without, K5 12 and
K7 12 in both. The JAX docstring's downgrade to XLA attention at vit_base
B >= 128 (:5-8) is a TPU compile gate the port does not have: its
reading runs the kernels. ``--device cpu`` runs the plain versions and
reads no memory (a smoke test, not a measurement of any device).
"""
from __future__ import annotations

import argparse
import copy

import numpy as np
import torch

from mfvit_tpu_torch.cli import common
from mfvit_tpu_torch.nn import vit
from mfvit_tpu_torch.tools import card
from mfvit_tpu_torch.train import optim, steps

WARMUP, ITERS = 4, 10
MiB = 2 ** 20


def inputs(cfg: vit.ViTConfig, B: int, device,
           dt: torch.dtype = torch.bfloat16) -> tuple:
    g = torch.Generator().manual_seed(1)
    imgs = torch.randn(B, cfg.img_size, cfg.img_size, 3, generator=g)
    labels = torch.from_numpy(np.random.default_rng(0).integers(0, 3, B))
    return imgs.to(dt).to(device), labels.to(device)


def make_step(model: vit.ViT, remat: bool,
              dt: torch.dtype = torch.bfloat16):
    """``call() -> loss``'s factory: ``call(imgs, labels)`` takes one SGD
    step of ``model`` (its own optimizer) with or without ``remat``."""
    opt = optim.build_optimizer("sgd", model.named_parameters(), 0.01,
                                momentum=0.9)
    train_step, _ = steps.make_classifier_steps(compute_dtype=dt,
                                                remat=remat)
    return lambda imgs, labels: train_step(model, opt, imgs, labels)[0]


def step_peak_bytes(call, device) -> int:
    """Bytes the step allocates at its peak above what it starts with."""
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device)
    card.fetch(call())
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_allocated(device) - before


def run_one(model: vit.ViT, imgs, labels, remat: bool, device,
            iters: int = ITERS, warmup: int = WARMUP) -> dict:
    """{"remat", "step_peak_mib" (None on the CPU), "img_s",
    "ms_per_step"}, printed."""
    step = make_step(model, remat)
    call = lambda: step(imgs, labels)  # noqa: E731
    for _ in range(warmup - 1):
        card.fetch(call())
    if torch.device(device).type == "cuda":
        peak = step_peak_bytes(call, device) / MiB
    else:
        card.fetch(call())
        peak = None
    sec = card.lag_seconds(call, iters, 0)
    B = imgs.shape[0]
    mem = f"{peak:.0f} MiB" if peak is not None else "not read on the CPU"
    print(f"{model.cfg.name} B={B} remat={remat}: step peak above its "
          f"start {mem}, {B / sec:.0f} img/s ({sec * 1e3:.1f} ms/step)",
          flush=True)
    return {"remat": remat, "step_peak_mib": peak, "img_s": B / sec,
            "ms_per_step": sec * 1e3}


def run(device, arch: str = "vit_base", batch: int = 256,
        reversed_order: bool = False, iters: int = ITERS,
        warmup: int = WARMUP, model: vit.ViT = None) -> list:
    """Both settings, each on a copy of one seeded model."""
    base = model if model is not None else vit.ViT(
        vit.get_config(arch), 3, generator=torch.Generator().manual_seed(0))
    imgs, labels = inputs(base.cfg, batch, device)
    rows = []
    for remat in ((True, False) if reversed_order else (False, True)):
        m = copy.deepcopy(base).to(device)
        rows.append(run_one(m, imgs, labels, remat, device, iters, warmup))
        del m
    return rows


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("mfvit-torch-bench-remat")
    p.add_argument("arch", nargs="?", default="vit_base",
                   choices=sorted(vit.CONFIGS))
    p.add_argument("batch", nargs="?", type=int, default=256)
    p.add_argument("order", nargs="?", choices=("reversed",))
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises where CUDA is missing")
    return p


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    device = common.resolve_device(args.device)
    card.note(device)
    return run(device, args.arch, args.batch, args.order == "reversed")


if __name__ == "__main__":
    main()
