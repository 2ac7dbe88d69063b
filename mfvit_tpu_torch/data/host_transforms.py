"""Host-side decode, resize, crop and training augmentation (the port of
``mfvit_tpu/data/host_transforms.py`` without its decode cache): cv2
decode in BGR order, torchvision ``Resize`` semantics through PIL
bilinear, ``CenterCrop`` with zero padding, the canvas producer feeding
the device normalisation (``CanvasTransform``), and the full host stacks
that return normalised float32 HWC images: the reference's CheXpert stack
(``ChexpertTransform``), the BYOL ``aug1``/``aug2`` stacks
(``ByolTransform``: RandomResizedCrop, ColorJitter, grayscale, Gaussian
blur, solarize, flip) and ``MoCoV3Transform``. Each draws from a seeded
``random.Random`` per (seed, epoch, index[, view]) in the JAX package's
order, so their outputs are bit-identical to its."""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Optional

import cv2
import numpy as np
from PIL import Image, ImageEnhance, ImageFilter, ImageOps

from mfvit_tpu_torch.data.constants import norm_stats


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


def random_crop(img: np.ndarray, ch: int, cw: int,
                rng: random.Random) -> np.ndarray:
    """torchvision RandomCrop, which raises on an undersized image."""
    h, w = img.shape[:2]
    if ch > h or cw > w:
        raise ValueError(f"random_crop: requested ({ch}, {cw}) from a "
                         f"({h}, {w}) image")
    top = rng.randint(0, h - ch) if h > ch else 0
    left = rng.randint(0, w - cw) if w > cw else 0
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
    then take the (ch, cw) window at (top, left). Channel counts PIL has
    no mode for rotate one channel at a time."""
    c = img.shape[2] if img.ndim == 3 else 1
    if c not in (1, 3, 4):
        full = np.stack([rotate(np.ascontiguousarray(img[..., i]), angle_deg)
                         for i in range(c)], axis=-1)
    else:
        full = rotate(np.ascontiguousarray(img), angle_deg)
    return full[top:top + ch, left:left + cw]


def to_float_chw_free(img: np.ndarray, mean, std) -> np.ndarray:
    """ToTensor + Normalize, kept HWC float32."""
    x = img.astype(np.float32) / 255.0
    return (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


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


@dataclasses.dataclass
class ChexpertTransform:
    """The reference's full host stack (``get_transform_type``): resize
    (shorter side, or square without ``maintain_ratio``), then in training
    flip (``hflip``), rotation by up to ``rotate_deg`` and a random crop,
    in eval a center crop; normalised with ``img_type``'s statistics
    unless ``normalize`` is off."""

    img_size: int = 224
    crop: int = 224
    img_type: str = "data"
    training: bool = False
    maintain_ratio: bool = True
    rotate_deg: float = 10.0
    hflip: bool = True
    seed: Optional[int] = None
    normalize: bool = True

    def __post_init__(self):
        self._rng = random.Random(self.seed)
        self.mean, self.std = norm_stats(self.img_type)
        if self.training and self.crop > self.img_size:
            raise ValueError(f"crop ({self.crop}) > img_size "
                             f"({self.img_size}) cannot be satisfied by "
                             "the training RandomCrop")

    def __call__(self, img: np.ndarray, ctx=None) -> np.ndarray:
        r = _rng_for(self.seed, self._rng, ctx)
        img = (resize_shorter(img, self.img_size) if self.maintain_ratio
               else resize_square(img, self.img_size))
        if self.training:
            if self.hflip and r.random() < 0.5:
                img = img[:, ::-1]
            deg = float(self.rotate_deg)
            if deg:
                img = rotate(img, r.uniform(-deg, deg))
            if self.crop:
                img = random_crop(img, self.crop, self.crop, r)
        elif self.crop:
            img = center_crop(img, self.crop, self.crop)
        if self.normalize:
            return to_float_chw_free(img, self.mean, self.std)
        return np.ascontiguousarray(img)


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def random_resized_crop(img: np.ndarray, size: int, rng: random.Random,
                        scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)) -> np.ndarray:
    """torchvision RandomResizedCrop: up to ten draws of an area and a
    log-uniform aspect, else a center crop at the nearest allowed aspect;
    then a bilinear resize to (size, size)."""
    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target = area * rng.uniform(*scale)
        log_r = (math.log(ratio[0]), math.log(ratio[1]))
        ar = math.exp(rng.uniform(*log_r))
        cw = int(round(math.sqrt(target * ar)))
        ch = int(round(math.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            top = rng.randint(0, h - ch)
            left = rng.randint(0, w - cw)
            crop = img[top:top + ch, left:left + cw]
            return np.asarray(Image.fromarray(crop).resize(
                (size, size), Image.BILINEAR))
    in_r = w / h
    if in_r < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_r > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    crop = center_crop(img, ch, cw)
    return np.asarray(Image.fromarray(crop).resize((size, size),
                                                   Image.BILINEAR))


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """SimCLR GaussianBlur (PIL's filter with radius sigma)."""
    return np.asarray(Image.fromarray(img).filter(
        ImageFilter.GaussianBlur(radius=sigma)))


def solarize(img: np.ndarray, threshold: int = 128) -> np.ndarray:
    """BYOL Solarize (PIL's)."""
    return np.asarray(ImageOps.solarize(Image.fromarray(img), threshold))


def color_jitter(img: np.ndarray, rng: random.Random, brightness=0.4,
                 contrast=0.4, saturation=0.2, hue=0.1) -> np.ndarray:
    """torchvision ColorJitter(0.4, 0.4, 0.2, 0.1): one factor per
    property, drawn in that order, then the four applied in a shuffled
    order; the hue shift through PIL's HSV."""
    pil = Image.fromarray(img)
    ops = []
    if brightness:
        f = rng.uniform(max(0, 1 - brightness), 1 + brightness)
        ops.append(lambda im, f=f: ImageEnhance.Brightness(im).enhance(f))
    if contrast:
        f = rng.uniform(max(0, 1 - contrast), 1 + contrast)
        ops.append(lambda im, f=f: ImageEnhance.Contrast(im).enhance(f))
    if saturation:
        f = rng.uniform(max(0, 1 - saturation), 1 + saturation)
        ops.append(lambda im, f=f: ImageEnhance.Color(im).enhance(f))
    if hue:
        f = rng.uniform(-hue, hue)

        def hue_shift(im, f=f):
            hsv = np.asarray(im.convert("HSV")).copy()
            hsv[:, :, 0] = (hsv[:, :, 0].astype(np.int16)
                            + int(f * 255)) % 256
            return Image.fromarray(hsv, "HSV").convert("RGB")
        ops.append(hue_shift)
    rng.shuffle(ops)
    for op in ops:
        pil = op(pil)
    return np.asarray(pil)


@dataclasses.dataclass
class ByolTransform:
    """The reference's BYOL stacks, ``aug1`` and ``aug2``:
    RandomResizedCrop(img_size, (crop_min, 1)), ColorJitter (p 0.8),
    grayscale (p 0.2), Gaussian blur (p 1.0 in aug1, 0.1 in aug2),
    solarize (p 0.2, aug2 only), a flip, ImageNet normalisation; drawn in
    that order."""

    img_size: int = 224
    crop_min: float = 0.08
    variant: str = "aug1"  # aug1 | aug2
    seed: Optional[int] = None
    normalize: bool = True

    def __post_init__(self):
        self._rng = random.Random(self.seed)

    def __call__(self, img: np.ndarray, ctx=None) -> np.ndarray:
        r = _rng_for(self.seed, self._rng, ctx)
        img = random_resized_crop(img, self.img_size, r,
                                  scale=(self.crop_min, 1.0))
        if r.random() < 0.8:
            img = color_jitter(img, r)
        if r.random() < 0.2:
            gray = np.asarray(Image.fromarray(img).convert("L"))
            img = np.stack([gray] * 3, -1)
        blur_p = 1.0 if self.variant == "aug1" else 0.1
        if r.random() < blur_p:
            img = gaussian_blur(img, r.uniform(0.1, 2.0))
        if self.variant == "aug2" and r.random() < 0.2:
            img = solarize(img)
        if r.random() < 0.5:
            img = img[:, ::-1]
        if self.normalize:
            return to_float_chw_free(img, IMAGENET_MEAN, IMAGENET_STD)
        return np.ascontiguousarray(img)


@dataclasses.dataclass
class MoCoV3Transform:
    """``get_transform_type_mocov3``: in training RandomResizedCrop(
    img_size, (crop_min, 1)), a flip and a rotation; in eval a resize to
    256 and a center crop; ``img_type``'s normalisation."""

    img_size: int = 224
    crop: int = 224
    img_type: str = "data"
    training: bool = True
    crop_min: float = 0.08
    rotate_deg: float = 10.0
    maintain_ratio: bool = True
    seed: Optional[int] = None

    def __post_init__(self):
        self._rng = random.Random(self.seed)
        self.mean, self.std = norm_stats(self.img_type)

    def __call__(self, img: np.ndarray, ctx=None) -> np.ndarray:
        r = _rng_for(self.seed, self._rng, ctx)
        if self.training:
            img = random_resized_crop(img, self.img_size, r,
                                      scale=(self.crop_min, 1.0))
            if r.random() < 0.5:
                img = img[:, ::-1]
            if self.rotate_deg:
                img = rotate(img, r.uniform(-self.rotate_deg,
                                            self.rotate_deg))
        else:
            img = (resize_shorter(img, 256) if self.maintain_ratio
                   else resize_square(img, 256))
            if self.crop:
                img = center_crop(img, self.crop, self.crop)
        return to_float_chw_free(img, self.mean, self.std)
