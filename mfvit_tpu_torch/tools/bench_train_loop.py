"""The fine-tuning loop's rate with real PNG decode in it, on five feeds,
the port of ``tools/bench_train_loop.py``.

    python -m mfvit_tpu_torch.tools.bench_train_loop [--device cuda]

512 PNGs of 240 x 260 (uint8 noise from ``np.random.default_rng(0)``,
labels i % 3) go to a temporary directory with their manifest (JAX
:31-41). The step is the vit_small classifier step in bf16 with SGD 0.01
(``train.steps.make_classifier_steps``; per step K1 12, K2 11, K3 1, K5
12, K7 12), B=256, 12 steps a feed; the first two warm up, the last ten
are timed with the loss fetched one step behind, as the CLIs fetch it
(JAX :62-98). JAX's count takes in the last warm-up's batch as well
(:89-94: 11 batches over the time of 10 steps); the port counts the ten
batches it times. The views (a flip and a rotation of up to 10 degrees) are
drawn on the device from a ``torch.Generator`` (``data/device_aug.py``),
not a JAX key. The feeds, in JAX's order:

1. ``BatchLoader`` (8 workers decoding, ``CanvasTransform(224,
   maintain_ratio=True)``'s training crop) through ``pipeline.
   device_prefetch`` (pinned, copied on a side stream a step ahead), then
   ``device_aug.augment_batch``;
2. the same loader with a synchronous copy each step;
3. feed 1 with ``DecodeResizeCache(224, maintain_ratio=True)`` (epochs
   after the first skip the decode);
4. the device canvas store: ``device_store.fill_from_dataset`` once (its
   seconds printed), then each step's batch gathered on the device and
   augmented as in 1;
5. the store step of the training CLIs (``cli/common``'s store feed, as
   ``cli/finetune`` runs it): the index vector in, then gather, the view
   (``device_aug.augment_train_canvas``, the canvas's full 224 crop) and
   the step. JAX's "single-dispatch" loop (:127-170) is one jitted
   program of those three; the port launches them in turn.

It prints each feed's images/s and its ratio to feed 1 (JAX :101-174).
``--device cpu`` runs the plain versions (a smoke test, not a measurement
of any device).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import cv2
import numpy as np
import torch

from mfvit_tpu_torch.cli import common
from mfvit_tpu_torch.data import datasets, device_aug, device_store
from mfvit_tpu_torch.data import host_transforms as ht
from mfvit_tpu_torch.data import manifest as mf
from mfvit_tpu_torch.data import pipeline
from mfvit_tpu_torch.nn import vit
from mfvit_tpu_torch.tools import card
from mfvit_tpu_torch.train import optim, steps

B = 256
N_IMGS = 512
STEPS = 12
WARMUP_STEPS = 2
WORKERS = 8
SRC_HW = (240, 260)
FEEDS = ("prefetch", "sync", "cache", "store", "store_step")


def write_images(root: str, n: int = N_IMGS, hw=SRC_HW) -> str:
    """``n`` noise PNGs and their manifest under ``root``; the manifest's
    path (JAX :31-41)."""
    os.makedirs(f"{root}/images/data", exist_ok=True)
    rng = np.random.default_rng(0)
    names, labels = [], []
    for i in range(n):
        fn = f"img_{i}.png"
        cv2.imwrite(f"{root}/images/data/{fn}",
                    rng.integers(0, 255, (*hw, 3), np.uint8))
        names.append(fn)
        labels.append(i % 3)
    mf.write_covid_manifest(f"{root}/man.txt", f"{root}/images", names,
                            labels)
    return f"{root}/man.txt"


class Loop:
    """The model, its optimizer and the loop of JAX's ``run`` over any
    feed."""

    def __init__(self, device, man: str, *, cfg: vit.ViTConfig = None,
                 batch: int = B, n_steps: int = STEPS,
                 workers: int = WORKERS, dt: torch.dtype = torch.bfloat16):
        self.device, self.man, self.dt = device, man, dt
        self.cfg = cfg or vit.get_config("vit_small")
        self.B, self.n_steps, self.workers = batch, n_steps, workers
        self.model = vit.ViT(self.cfg, 3,
                             generator=torch.Generator().manual_seed(0)
                             ).to(device)
        self.opt = optim.build_optimizer("sgd", self.model.named_parameters(),
                                         0.01)
        self.train_step, _ = steps.make_classifier_steps(compute_dtype=dt)
        self.gen = torch.Generator(device=device).manual_seed(1)

    def loader(self, decode=None) -> pipeline.BatchLoader:
        tf = ht.CanvasTransform(img_size=self.cfg.img_size, training=True,
                                maintain_ratio=True, seed=0)
        ds = datasets.CovidDataset("data", self.man, tf, decode=decode)
        return pipeline.BatchLoader(ds, self.B, shuffle=True, seed=0,
                                    drop_last=True,
                                    num_workers=self.workers)

    def fill_store(self) -> tuple:
        """(the store, the fill's seconds) (JAX :116-122)."""
        tf = ht.CanvasTransform(img_size=self.cfg.img_size, training=False,
                                maintain_ratio=False, seed=0)
        ds = datasets.CovidDataset("data", self.man, tf)
        t0 = time.perf_counter()
        store = device_store.fill_from_dataset(
            ds, batch_size=self.B, device=self.device, seed=0,
            num_workers=self.workers)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return store, time.perf_counter() - t0

    def _view(self, canv):
        return device_aug.augment_batch(
            canv, img_type="data", training=True, rotate_deg=10.0,
            out_dtype=self.dt, generator=self.gen)

    def _store_view(self, canv):
        return device_aug.augment_train_canvas(
            self.gen, canv, crop=self.cfg.img_size, img_type="data",
            rotate_deg=10.0, out_dtype=self.dt)

    def batches(self, feed: str, source):
        """Endless (x, labels) on the device of ``feed`` from ``source``
        (a loader or a store)."""
        while True:
            if feed in ("prefetch", "cache"):
                for canv, lab in pipeline.device_prefetch(iter(source),
                                                          self.device):
                    yield self._view(canv), lab
            elif feed == "sync":
                for canv, lab in source:
                    yield (self._view(torch.as_tensor(canv).to(self.device)),
                           torch.as_tensor(lab).to(self.device))
            elif feed == "store":
                for canv, lab in source:
                    yield self._view(canv), lab
            else:  # store_step
                for idx in source.iter_index_batches():
                    canv, lab = source.gather(idx)
                    yield self._store_view(canv), lab

    def run(self, feed: str, source) -> float:
        """images/s of the timed steps (JAX :62-98)."""
        n, t0, pending = 0, None, None
        it = self.batches(feed, source)
        for done in range(1, self.n_steps + 1):
            x, lab = next(it)
            loss, _ = self.train_step(self.model, self.opt, x, lab)
            if pending is not None:
                card.fetch(pending)
            pending = loss
            n += self.B
            if done == WARMUP_STEPS:
                card.fetch(pending)
                pending, t0, n = None, time.perf_counter(), 0
        card.fetch(pending)
        it.close()
        return n / (time.perf_counter() - t0)


def run(device, *, n_imgs: int = N_IMGS, batch: int = B,
        n_steps: int = STEPS, cfg: vit.ViTConfig = None, hw=SRC_HW,
        workers: int = WORKERS) -> dict:
    """{feed: images/s, "fill_s": the store's fill seconds}, printed."""
    device = torch.device(device)
    with tempfile.TemporaryDirectory(prefix="bench_train_") as tmp:
        man = write_images(tmp, n_imgs, hw)
        loop = Loop(device, man, cfg=cfg, batch=batch, n_steps=n_steps,
                    workers=workers)
        size = loop.cfg.img_size
        out = {"prefetch": loop.run("prefetch", loop.loader())}
        print(f"train loop WITH device_prefetch: {out['prefetch']:.0f} img/s")
        out["sync"] = loop.run("sync", loop.loader())
        print(f"train loop synchronous H2D:      {out['sync']:.0f} img/s")
        print(f"speedup: {out['prefetch'] / out['sync']:.3f}x")
        out["cache"] = loop.run("cache", loop.loader(
            ht.DecodeResizeCache(size, maintain_ratio=True)))
        print(f"train loop prefetch + canvas cache: {out['cache']:.0f} "
              "img/s")
        print(f"cache speedup over uncached: "
              f"{out['cache'] / out['prefetch']:.3f}x")
        store, out["fill_s"] = loop.fill_store()
        print(f"device store fill (one pass incl. H2D): {out['fill_s']:.1f}s"
              f" for {n_imgs} imgs")
        out["store"] = loop.run("store", store)
        print(f"train loop device-resident store:  {out['store']:.0f} img/s")
        print(f"store speedup over host feed: "
              f"{out['store'] / out['prefetch']:.2f}x")
        out["store_step"] = loop.run("store_step", store)
        print(f"train loop store step (index in, gather, view, step): "
              f"{out['store_step']:.0f} img/s")
        print(f"store step speedup over host feed: "
              f"{out['store_step'] / out['prefetch']:.2f}x")
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("mfvit-torch-bench-train-loop")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises where CUDA is missing")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = common.resolve_device(args.device)
    card.note(device)
    return run(device)


if __name__ == "__main__":
    main()
