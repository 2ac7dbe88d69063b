"""Host-side decode, resize, crop and training augmentation (the canvas
subset of ``mfvit_tpu/data/host_transforms.py``): cv2 decode in BGR order,
torchvision ``Resize`` semantics through PIL bilinear, ``CenterCrop`` with
zero padding, and the canvas producer feeding the device normalisation.
Its training branch draws flip, rotation and crop from a seeded
``random.Random`` per (seed, epoch, index) in the reference order, so the
training canvases are bit-identical to the JAX package's."""
from __future__ import annotations

import dataclasses
import random
from typing import Optional

import cv2
import numpy as np
from PIL import Image


def decode_bgr(path: str) -> np.ndarray:
    """cv2 decode -> uint8 HWC, BGR order (reference loader.py:124)."""
    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(f"cv2 could not decode {path!r}")
    return img


def resize_shorter(img: np.ndarray, size: int) -> np.ndarray:
    """torchvision ``Resize(int)``: the SHORTER side to ``size``."""
    h, w = img.shape[:2]
    if h <= w:
        nh, nw = size, max(1, int(size * w / h))
    else:
        nh, nw = max(1, int(size * h / w)), size
    if (nh, nw) == (h, w):
        return img
    return np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR))


def resize_square(img: np.ndarray, size: int) -> np.ndarray:
    """torchvision ``Resize((size, size))``."""
    if img.shape[:2] == (size, size):
        return img
    return np.asarray(Image.fromarray(img).resize((size, size),
                                                  Image.BILINEAR))


def center_crop(img: np.ndarray, ch: int, cw: int) -> np.ndarray:
    """torchvision CenterCrop, zero-padding an undersized image first."""
    h, w = img.shape[:2]
    if ch > h or cw > w:
        pt = max(0, (ch - h) // 2)
        pl_ = max(0, (cw - w) // 2)
        pad = np.zeros((max(h, ch) + (ch - h) % 2 if ch > h else h,
                        max(w, cw) + (cw - w) % 2 if cw > w else w,
                        img.shape[2]), img.dtype)
        pad[pt:pt + h, pl_:pl_ + w] = img
        img, (h, w) = pad, pad.shape[:2]
    top = int(round((h - ch) / 2.0))
    left = int(round((w - cw) / 2.0))
    return img[top:top + ch, left:left + cw]


def _rng_for(seed, shared_rng: random.Random, ctx):
    """Per-sample RNG: with a seed and a context (the loader's (epoch,
    index)) the draws depend only on (seed, ctx), whatever the worker
    count; otherwise the shared sequential RNG."""
    if seed is None or ctx is None:
        return shared_rng
    # int-tuple hashes do not depend on PYTHONHASHSEED
    return random.Random(hash((seed,) + tuple(ctx)))


def rotate(img: np.ndarray, angle_deg: float) -> np.ndarray:
    """torchvision RandomRotation's application: NEAREST, expand=False,
    about the center, zero fill."""
    return np.asarray(
        Image.fromarray(img).rotate(angle_deg, resample=Image.NEAREST))


def rotate_crop_window(img: np.ndarray, angle_deg: float, top: int,
                       left: int, ch: int, cw: int) -> np.ndarray:
    """Rotate the full image about its center (PIL NEAREST, zero fill),
    then take the (ch, cw) window at (top, left)."""
    return rotate(np.ascontiguousarray(img), angle_deg)[top:top + ch,
                                                        left:left + cw]


@dataclasses.dataclass
class CanvasTransform:
    """Canvas: resize (shorter side, or square without ``maintain_ratio``)
    to ``img_size``, then crop to ``crop`` (``img_size`` when 0) -> uint8
    HWC. Eval takes the center crop. Training runs the reference order
    horizontal flip -> rotation by up to ``rotate_deg`` about the full
    canvas -> random crop, with the draws (flip, angle, top, left) of the
    torchvision stack. Normalisation is not done here."""

    img_size: int = 224
    crop: int = 0
    maintain_ratio: bool = True
    training: bool = False
    rotate_deg: float = 0.0
    seed: Optional[int] = None

    def __post_init__(self):
        self._rng = random.Random(self.seed)
        if not self.crop:
            self.crop = self.img_size
        if self.training and self.crop > self.img_size:
            raise ValueError(f"crop ({self.crop}) > img_size "
                             f"({self.img_size}) cannot be satisfied by "
                             "the training RandomCrop")

    def __call__(self, img: np.ndarray, ctx=None) -> np.ndarray:
        r = _rng_for(self.seed, self._rng, ctx)
        s, c = self.img_size, self.crop
        img = (resize_shorter(img, s) if self.maintain_ratio
               else resize_square(img, s))
        if self.training:
            if r.random() < 0.5:
                img = img[:, ::-1]
            deg = float(self.rotate_deg)
            angle = r.uniform(-deg, deg) if deg else 0.0
            h, w = img.shape[:2]
            if c > h or c > w:
                raise ValueError(f"CanvasTransform: crop {c} > canvas "
                                 f"({h}, {w})")
            top = r.randint(0, h - c) if h > c else 0
            left = r.randint(0, w - c) if w > c else 0
            if angle:
                img = rotate_crop_window(img, angle, top, left, c, c)
            else:
                img = img[top:top + c, left:left + c]
        else:
            img = center_crop(img, c, c)
        return np.ascontiguousarray(img)
