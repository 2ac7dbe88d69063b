"""Batched augmentation on the device, the port of
``mfvit_tpu/data/device_aug.py``: uint8 NHWC canvases -> random horizontal
flip, random rotation about the full canvas center (nearest sampling, zero
fill: PIL ``Image.rotate``, counter-clockwise for a positive angle), random
crop -> /255 -> per-flavour normalisation -> cast, in plain PyTorch tensor
ops (XLA in JAX, no Pallas kernel). The flip, rotation and crop are one
gather of the uint8 canvas (JAX flips the float image first; a gather
moves values, so the bits are the same) and the normalisation one lookup
per value and channel (``_normalize``).

Each random function is split in two: a draw (``draw_canvas_view``,
``draw_batch_view``) that takes an explicit ``torch.Generator`` on the
batch's device and returns a ``ViewDraws`` (the flip mask, the angles in
degrees, the crop tops and lefts), and a pure view function of the
canvases and those draws (``canvas_view``, ``batch_view``). A view draws,
in this order: the flips (``torch.rand < 0.5``, with ``hflip``), the
angles (``uniform_(-rotate_deg, rotate_deg)``, with a rotation), the tops,
then the lefts (``torch.randint(0, H - crop + 1)``: both ends included).
Two views draw q's, then k's. The CPU tests feed JAX's own draws into the
view functions, which then equal JAX's bit for bit.

The training CLIs seed one generator per (draw, epoch), ``epoch_generator``:
``torch.Generator(device).manual_seed(int(np.random.SeedSequence([seed,
draw, epoch]).generate_state(1)[0]))`` with ``seed`` the ``--seed`` (0 when
unset), and every step draws its views from it in a fixed order. A run
started at ``--start-epoch E`` so draws, at epoch E, the views of an
uninterrupted run. CUDA's generator (Philox) and the CPU's (Mersenne
Twister) give different draws for one seed."""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from mfvit_tpu_torch.data.constants import norm_stats

_DEG2RAD = np.float32(np.pi / 180)  # jnp.deg2rad's fp32 constant


def epoch_generator(seed: int, draw: int, epoch: int,
                    device) -> torch.Generator:
    """The generator of one (draw, epoch) on ``device``."""
    state = int(np.random.SeedSequence([seed, draw, epoch])
                .generate_state(1)[0])
    return torch.Generator(device=torch.device(device)).manual_seed(state)


@dataclasses.dataclass
class ViewDraws:
    """One view's draws for a batch of B, on the batch's device: ``flip``
    (B,) bool or None (no flip), ``deg`` (B,) float32 degrees or None (no
    rotation), ``tops`` and ``lefts`` (B,) integer crop corners or None
    (no crop)."""

    flip: Optional[torch.Tensor] = None
    deg: Optional[torch.Tensor] = None
    tops: Optional[torch.Tensor] = None
    lefts: Optional[torch.Tensor] = None

    def rank_rows(self, b: int, rank: int) -> "ViewDraws":
        """Rank ``rank``'s block of ``b`` rows of the global batch's
        draws."""
        lo, hi = rank * b, (rank + 1) * b
        return ViewDraws(*(None if t is None else t[lo:hi] for t in
                           (self.flip, self.deg, self.tops, self.lefts)))


def _draw_flip_deg(gen: torch.Generator, B: int, rotate_deg: float,
                   hflip: bool) -> ViewDraws:
    dev = gen.device
    flip = (torch.rand(B, generator=gen, device=dev) < 0.5 if hflip
            else None)
    deg = (torch.empty(B, device=dev).uniform_(-rotate_deg, rotate_deg,
                                               generator=gen)
           if rotate_deg else None)
    return ViewDraws(flip, deg)


def draw_crop(gen: torch.Generator, B: int, H: int, W: int,
              crop: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform crop corners, tops in [0, H - crop] and lefts in
    [0, W - crop], both ends included (torchvision RandomCrop)."""
    if crop > H or crop > W:
        raise ValueError(f"random_crop_batch: crop {crop} > canvas "
                         f"({H}, {W})")
    dev = gen.device
    tops = torch.randint(0, H - crop + 1, (B,), generator=gen, device=dev)
    lefts = torch.randint(0, W - crop + 1, (B,), generator=gen, device=dev)
    return tops, lefts


def draw_canvas_view(gen: torch.Generator, shape, *, crop: int,
                     rotate_deg: float = 10.0,
                     hflip: bool = True) -> ViewDraws:
    """The draws of ``augment_train_canvas`` for canvases of ``shape``
    (B, H, W, C)."""
    B, H, W, _ = shape
    if crop > H or crop > W:
        raise ValueError(f"augment_train_canvas: crop {crop} > canvas "
                         f"({H}, {W})")
    d = _draw_flip_deg(gen, B, rotate_deg, hflip)
    d.tops, d.lefts = draw_crop(gen, B, H, W, crop)
    return d


def draw_batch_view(gen: torch.Generator, B: int, *,
                    rotate_deg: float = 10.0,
                    hflip: bool = True) -> ViewDraws:
    """The draws of ``augment_batch(training=True)``: flip and angle, no
    crop."""
    return _draw_flip_deg(gen, B, rotate_deg, hflip)


def _rotated_window_gather(imgs: torch.Tensor, angles_rad: torch.Tensor,
                           tops: torch.Tensor, lefts: torch.Tensor,
                           out_h: int, out_w: int,
                           flip: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The (out_h, out_w) window at (top, left) of each image rotated
    about its full-canvas center (nearest sampling, zero fill), in JAX's
    fp32 arithmetic: ``src_x = cos * xx - sin * yy + cx`` and ``src_y = sin
    * xx + cos * yy + cy``, rounded half to even, the zero fill applied
    after the clipped gather. ``flip`` (B,) samples the horizontally
    flipped image instead (column W - 1 - x), as flipping first would.
    Any dtype: the gather moves values and does no arithmetic on them.

    imgs: (B, H, W, C); angles_rad, tops, lefts: (B,)."""
    B, H, W, C = imgs.shape
    dev, f32 = imgs.device, torch.float32
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    yy = (torch.arange(out_h, dtype=f32, device=dev)[None, :, None]
          + tops.to(f32)[:, None, None] - cy)
    xx = (torch.arange(out_w, dtype=f32, device=dev)[None, None, :]
          + lefts.to(f32)[:, None, None] - cx)
    cos = torch.cos(angles_rad)[:, None, None]
    sin = torch.sin(angles_rad)[:, None, None]
    src_x = cos * xx - sin * yy + cx
    src_y = sin * xx + cos * yy + cy
    ix = torch.round(src_x).to(torch.int32)
    iy = torch.round(src_y).to(torch.int32)
    valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
    ix = ix.clamp(0, W - 1)
    iy = iy.clamp(0, H - 1)
    if flip is not None:
        ix = torch.where(flip[:, None, None], W - 1 - ix, ix)
    lin = (iy.long() * W + ix
           + torch.arange(B, device=dev)[:, None, None] * (H * W))
    out = imgs.reshape(B * H * W, C).index_select(0, lin.reshape(-1))
    out = out.reshape(B, out_h, out_w, C)
    return torch.where(valid[..., None], out,
                       torch.zeros((), dtype=imgs.dtype, device=dev))


def _rotate_nearest(imgs: torch.Tensor, angles_rad: torch.Tensor,
                    flip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-frame rotation about the image center: the zero-offset
    window."""
    B, H, W, _ = imgs.shape
    zeros = torch.zeros(B, dtype=torch.int64, device=imgs.device)
    return _rotated_window_gather(imgs, angles_rad, zeros, zeros, H, W,
                                  flip)


def random_crop_batch(canvases: torch.Tensor, tops: torch.Tensor,
                      lefts: torch.Tensor, crop: int,
                      flip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (crop, crop) window at (top, left) of each canvas (of the
    flipped canvas where ``flip``); ``draw_crop`` draws the corners."""
    B, H, W, _ = canvases.shape
    if crop > H or crop > W:
        raise ValueError(f"random_crop_batch: crop {crop} > canvas "
                         f"({H}, {W})")
    dev = canvases.device
    span = torch.arange(crop, device=dev)
    rows = tops.long()[:, None] + span
    cols = lefts.long()[:, None] + span
    if flip is not None:
        cols = torch.where(flip[:, None], W - 1 - cols, cols)
    b = torch.arange(B, device=dev)[:, None, None]
    return canvases[b, rows[:, :, None], cols[:, None, :]]


def _rotate_crop_nearest(imgs: torch.Tensor, angles_rad: torch.Tensor,
                         tops: torch.Tensor, lefts: torch.Tensor, crop: int,
                         flip: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Rotate the full canvas about its center (zero fill), then crop the
    (crop, crop) window at (top, left), in one gather over the window's
    source coordinates: the reference order at the cost of a crop."""
    return _rotated_window_gather(imgs, angles_rad, tops, lefts, crop, crop,
                                  flip)


@functools.lru_cache(maxsize=None)
def _norm_table(img_type: str, out_dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """(256, C) normalised value of each uint8 value and channel, in JAX's
    arithmetic: XLA compiles ``x / 255 - mean`` over ``std`` to
    ``fma(x, 1/255, -mean) * (1/std)`` in fp32 (one rounding for the fma:
    exact here in fp64, then rounded), then the cast. Kept per (flavour,
    dtype, device): made once, so no step copies it to the device."""
    mean, std = (np.asarray(v, np.float32) for v in norm_stats(img_type))
    inv255 = np.float32(1) / np.float32(255)
    v = np.arange(256, dtype=np.float64)[:, None]
    fma = (v * np.float64(inv255) - mean.astype(np.float64))
    table = fma.astype(np.float32) * (np.float32(1) / std)
    return torch.from_numpy(table).to(device=device, dtype=out_dtype)


def _normalize(canvases: torch.Tensor, img_type: str,
               out_dtype: torch.dtype) -> torch.Tensor:
    """uint8 canvases -> (x / 255 - mean) / std per flavour, in
    ``out_dtype``: one lookup in ``_norm_table``. The flips, rotations and
    crops before it move uint8 values only (the zero fill is the value
    0), so normalising after them gives what normalising first would."""
    table = _norm_table(img_type, out_dtype, canvases.device)
    C = canvases.shape[-1]
    if table.shape[1] != C:
        raise ValueError(f"{img_type!r} normalises {table.shape[1]} "
                         f"channels, the canvases have {C}")
    idx = (canvases.to(torch.int32) * C
           + torch.arange(C, dtype=torch.int32, device=canvases.device))
    return table.reshape(-1).index_select(0, idx.reshape(-1)).reshape(
        canvases.shape)


def _radians(deg: torch.Tensor) -> torch.Tensor:
    """fp32 degrees times the fp32 constant, as ``jnp.deg2rad``; a Python
    scalar (exact in fp32), so no copy to the device."""
    return deg.float() * float(_DEG2RAD)


def canvas_view(canvases: torch.Tensor, draws: ViewDraws, *, crop: int,
                img_type: str = "data",
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The pure view of ``augment_train_canvas``: flip -> rotate about the
    full canvas center -> crop, as one gather of the uint8 canvases, then
    the normalisation."""
    B, H, W, _ = canvases.shape
    if crop > H or crop > W:
        raise ValueError(f"augment_train_canvas: crop {crop} > canvas "
                         f"({H}, {W})")
    if draws.deg is not None:
        x = _rotate_crop_nearest(canvases, _radians(draws.deg), draws.tops,
                                 draws.lefts, crop, draws.flip)
    else:
        x = random_crop_batch(canvases, draws.tops, draws.lefts, crop,
                              draws.flip)
    return _normalize(x, img_type, out_dtype)


def batch_view(canvases: torch.Tensor, draws: ViewDraws, *,
               img_type: str = "data",
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The pure view of ``augment_batch(training=True)``: flip -> full-
    frame rotation -> normalise."""
    x = canvases
    if draws.deg is not None:
        x = _rotate_nearest(x, _radians(draws.deg), draws.flip)
    elif draws.flip is not None:
        x = torch.where(draws.flip[:, None, None, None], x.flip(2), x)
    return _normalize(x, img_type, out_dtype)


def augment_train_canvas(gen: torch.Generator, canvases: torch.Tensor, *,
                         crop: int, img_type: str = "data",
                         rotate_deg: float = 10.0, hflip: bool = True,
                         out_dtype: torch.dtype = torch.float32,
                         world: int = 1, rank: int = 0) -> torch.Tensor:
    """Reference-order training view of full canvases resident on the
    device (the store paths): HFlip -> RandomRotation about the full
    canvas center -> RandomCrop -> normalise (image_transform.py:58-63).
    Under ``world`` ranks ``canvases`` are rank ``rank``'s block of the
    global batch: the draws are made for the global batch, as JAX draws a
    view over the whole sharded batch, and the block's rows taken."""
    b = canvases.shape[0]
    draws = draw_canvas_view(gen, (b * world, *canvases.shape[1:]),
                             crop=crop, rotate_deg=rotate_deg, hflip=hflip)
    return canvas_view(canvases, draws.rank_rows(b, rank), crop=crop,
                       img_type=img_type, out_dtype=out_dtype)


def augment_two_views_canvas(gen: torch.Generator, canvases: torch.Tensor,
                             *, crop: int, img_type: str = "data",
                             rotate_deg: float = 10.0, hflip: bool = True,
                             out_dtype: torch.dtype = torch.float32,
                             world: int = 1, rank: int = 0):
    """Two independent reference-order views (q, k) of one resident
    canvas (TwoCropsTransform over the whole stack): each view draws its
    own flip, rotation and crop, q's first."""
    kw = dict(crop=crop, img_type=img_type, rotate_deg=rotate_deg,
              hflip=hflip, out_dtype=out_dtype, world=world, rank=rank)
    q = augment_train_canvas(gen, canvases, **kw)
    k = augment_train_canvas(gen, canvases, **kw)
    return q, k


def augment_batch(canvases: torch.Tensor, *, img_type: str = "data",
                  training: bool = False, rotate_deg: float = 10.0,
                  hflip: bool = True, out_dtype: torch.dtype = torch.float32,
                  generator: Optional[torch.Generator] = None,
                  world: int = 1, rank: int = 0) -> torch.Tensor:
    """uint8 (B, S, S, C) canvases on any device -> normalised (B, S, S, C)
    in ``out_dtype`` on the same device. Eval (the default): normalise
    only. ``training``: a random flip (p 0.5) and a rotation by
    U(-rotate_deg, rotate_deg) of the whole canvas, drawn from
    ``generator`` for the global batch of ``world`` blocks (as
    ``augment_train_canvas``), then normalise."""
    if not training:
        return _normalize(canvases, img_type, out_dtype)
    b = canvases.shape[0]
    draws = draw_batch_view(generator, b * world, rotate_deg=rotate_deg,
                            hflip=hflip)
    return batch_view(canvases, draws.rank_rows(b, rank), img_type=img_type,
                      out_dtype=out_dtype)


def augment_two_views(gen: torch.Generator, canvases: torch.Tensor,
                      canvases_k: Optional[torch.Tensor] = None, *,
                      img_type: str = "data", rotate_deg: float = 10.0,
                      hflip: bool = True,
                      out_dtype: torch.dtype = torch.float32):
    """MoCo's q/k views of already cropped canvases (the crop-first
    streaming feed): each view its own flip and rotation, q's first.
    ``canvases_k`` are k's own crops; without them both views share one
    crop."""
    ck = canvases if canvases_k is None else canvases_k
    kw = dict(img_type=img_type, training=True, rotate_deg=rotate_deg,
              hflip=hflip, out_dtype=out_dtype, generator=gen)
    return augment_batch(canvases, **kw), augment_batch(ck, **kw)
