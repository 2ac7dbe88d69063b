"""Host-side decode, resize and crop (the eval subset of
``mfvit_tpu/data/host_transforms.py``): cv2 decode in BGR order, torchvision
``Resize`` semantics through PIL bilinear, ``CenterCrop`` with zero
padding, and the eval canvas producer feeding the device normalisation."""
from __future__ import annotations

import dataclasses

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


@dataclasses.dataclass
class CanvasTransform:
    """Eval canvas: resize (shorter side, or square without
    ``maintain_ratio``) to ``img_size``, then center-crop to ``crop``
    (``img_size`` when 0) -> uint8 HWC. Flip, rotation and normalisation
    are not done here."""

    img_size: int = 224
    crop: int = 0
    maintain_ratio: bool = True

    def __call__(self, img: np.ndarray) -> np.ndarray:
        s = self.img_size
        img = (resize_shorter(img, s) if self.maintain_ratio
               else resize_square(img, s))
        c = self.crop or s
        return np.ascontiguousarray(center_crop(img, c, c))
