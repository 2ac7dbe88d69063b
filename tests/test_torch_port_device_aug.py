"""The port's device augmentation (``mfvit_tpu_torch/data/device_aug.py``)
on the CPU against the JAX package's, given JAX's own draws: a torch
generator cannot reproduce ``jax.random``'s bits, so each test replays
JAX's key splits and its ``bernoulli``, ``randint`` and ``uniform``, and
feeds the result to the port's pure view functions.

Tolerance: equal bit for bit. One source of difference is stated, not
hidden: torch's fp32 ``cos``/``sin`` and XLA's differ in the last bit for
about one angle in twenty, and a one-ulp change of a source coordinate can
move it across a .5 rounding tie. ``assert_view_equal`` therefore asserts
every pixel equal, except pixels of an image whose two libms disagree on
that angle's cos or sin AND whose exact source coordinate lies within
``TIE`` of a tie; it prints how many such pixels there are and bounds them
by ``TIE_PIXELS``. Against PIL's ``Image.rotate`` (the host's
``rotate_crop_window``) JAX's gather itself is not exact: at 10 degrees a
few pixels near a .5 tie (within ``PIL_TIE``) fall the other way, since
PIL maps coordinates in its own arithmetic. There the port must differ
from PIL at exactly JAX's pixels. Then the draws themselves: their
ranges, both ends included, the flip rate, the seeded replay and the
per-epoch generator."""
import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from mfvit_tpu.data import device_aug as jaug
from mfvit_tpu_torch.data import device_aug as aug
from mfvit_tpu_torch.data import host_transforms as ht

TIE = 1e-4  # |exact source coordinate - (k + 0.5)|, in pixels
TIE_PIXELS = 8  # differing pixels allowed per call, each within TIE
PIL_TIE = 1e-3  # the gather against PIL's arithmetic


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _tie_distance(deg, top, left, y, x, H, W):
    """The pixel's exact (fp64) source coordinates' distance to .5 ties."""
    rad = np.float64(deg) * np.pi / 180
    yy, xx = y + top - (H - 1) / 2, x + left - (W - 1) / 2
    sx = np.cos(rad) * xx - np.sin(rad) * yy + (W - 1) / 2
    sy = np.sin(rad) * xx + np.cos(rad) * yy + (H - 1) / 2
    return min(abs(sx - np.floor(sx) - 0.5), abs(sy - np.floor(sy) - 0.5))


def assert_view_equal(got, want, deg=None, tops=None, lefts=None, H=0, W=0):
    """``got`` == ``want`` bit for bit, but for the stated trig ties."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    diff = (got != want).any(-1)
    if not diff.any():
        return
    assert deg is not None, f"{diff.sum()} pixels differ without a rotation"
    rad = np.asarray(jnp.deg2rad(jnp.asarray(deg, jnp.float32)))
    trig_differs = ((np.asarray(jnp.cos(rad)) != torch.cos(_t(rad)).numpy())
                    | (np.asarray(jnp.sin(rad))
                       != torch.sin(_t(rad)).numpy()))
    B = got.shape[0]
    tops = np.zeros(B, int) if tops is None else np.asarray(tops)
    lefts = np.zeros(B, int) if lefts is None else np.asarray(lefts)
    where = np.argwhere(diff)
    for b, y, x in where:
        assert trig_differs[b], f"image {b} differs at ({y}, {x})"
        dist = _tie_distance(deg[b], tops[b], lefts[b], y, x, H, W)
        assert dist < TIE, f"image {b} ({y}, {x}): {dist} from a tie"
    print(f"{len(where)} pixels differ, each on a cos/sin last-bit "
          f"difference within {TIE} of a tie")
    assert len(where) <= TIE_PIXELS


def jax_canvas_draws(key, B, H, W, crop, rotate_deg, hflip):
    """``augment_train_canvas``'s draws, JAX's splits and order."""
    kf, kr, ky, kx = jax.random.split(key, 4)
    flip = jax.random.bernoulli(kf, 0.5, (B,)) if hflip else None
    tops = jax.random.randint(ky, (B,), 0, H - crop + 1)
    lefts = jax.random.randint(kx, (B,), 0, W - crop + 1)
    deg = (jax.random.uniform(kr, (B,), minval=-rotate_deg,
                              maxval=rotate_deg) if rotate_deg else None)
    return aug.ViewDraws(_t(flip), _t(deg), _t(tops), _t(lefts))


def jax_batch_draws(key, B, rotate_deg, hflip):
    """``augment_batch(training=True)``'s draws."""
    kf, kr = jax.random.split(key)
    flip = jax.random.bernoulli(kf, 0.5, (B,)) if hflip else None
    deg = (jax.random.uniform(kr, (B,), minval=-rotate_deg,
                              maxval=rotate_deg) if rotate_deg else None)
    return aug.ViewDraws(_t(flip), _t(deg))


def _canvases(seed, B, H, C):
    return np.random.default_rng(seed).integers(0, 256, (B, H, H, C),
                                                dtype=np.uint8)


CHANNELS = {"data": 3, "Train_Mix": 3, "4ch": 4}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("H,crop", [(40, 32), (32, 32)])
def test_rotated_window_gather_matches_jax(channels, H, crop):
    """The shared rotation core at angles 0, +-10 and 37 degrees (and 12
    drawn ones), crop < canvas and crop = canvas, 1, 3 and 4 channels."""
    rng = np.random.default_rng(channels * 100 + H)
    B = 16
    imgs = rng.integers(0, 256, (B, H, H, channels)).astype(np.float32)
    deg = rng.uniform(-10, 10, B).astype(np.float32)
    deg[:4] = [0, 10, -10, 37]
    tops = rng.integers(0, H - crop + 1, B)
    lefts = rng.integers(0, H - crop + 1, B)
    want = jaug._rotated_window_gather(
        jnp.asarray(imgs), jnp.deg2rad(jnp.asarray(deg)),
        jnp.asarray(tops), jnp.asarray(lefts), crop, crop)
    got = aug._rotated_window_gather(
        torch.from_numpy(imgs), aug._radians(torch.from_numpy(deg)),
        torch.from_numpy(tops), torch.from_numpy(lefts), crop, crop)
    assert_view_equal(got, want, deg, tops, lefts, H, H)
    # on uint8, which the training views gather, the same values
    got8 = aug._rotated_window_gather(
        torch.from_numpy(imgs.astype(np.uint8)),
        aug._radians(torch.from_numpy(deg)), torch.from_numpy(tops),
        torch.from_numpy(lefts), crop, crop)
    assert_view_equal(got8.float(), want, deg, tops, lefts, H, H)


@pytest.mark.parametrize("angle", [0.0, 7.5, 10.0, -10.0, 37.0])
def test_rotated_window_matches_host_rotate_crop_window(angle):
    """The device gather against the host's ``rotate_crop_window`` (PIL
    ``Image.rotate``, NEAREST, then the slice) at 64 x 64, a 40 x 40
    window, 3 channels, and the full frame against PIL: equal but where
    JAX's gather differs from PIL too (at most ``TIE_PIXELS``, each within
    ``PIL_TIE`` of a tie)."""
    img = np.random.default_rng(3).integers(0, 255, (64, 64, 3), np.uint8)
    top, left, crop = 5, 17, 40
    deg = torch.tensor([angle], dtype=torch.float32)
    jrad = jnp.deg2rad(jnp.asarray([angle], jnp.float32))
    jimg = jnp.asarray(img, jnp.float32)[None]
    cases = (
        (ht.rotate_crop_window(img, angle, top, left, crop, crop),
         aug._rotate_crop_nearest(torch.from_numpy(img)[None],
                                  aug._radians(deg), torch.tensor([top]),
                                  torch.tensor([left]), crop)[0],
         jaug._rotate_crop_nearest(jimg, jrad, jnp.asarray([top]),
                                   jnp.asarray([left]), crop)[0],
         top, left),
        (np.asarray(Image.fromarray(img).rotate(angle,
                                                resample=Image.NEAREST)),
         aug._rotate_nearest(torch.from_numpy(img)[None],
                             aug._radians(deg))[0],
         jaug._rotate_nearest(jimg, jrad)[0], 0, 0))
    for pil, got, want, t, l in cases:
        assert_view_equal(got[None].float(), want[None], [angle], [t], [l],
                          64, 64)
        off = (got.numpy() != pil).any(-1)
        np.testing.assert_array_equal(
            off, (np.asarray(want) != pil.astype(np.float32)).any(-1))
        assert off.sum() <= TIE_PIXELS
        for y, x in np.argwhere(off):
            assert _tie_distance(angle, t, l, y, x, 64, 64) < PIL_TIE


@pytest.mark.parametrize("img_type", sorted(CHANNELS))
@pytest.mark.parametrize("rotate_deg", [0.0, 10.0])
@pytest.mark.parametrize("hflip", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_augment_train_canvas_matches_jax(img_type, rotate_deg, hflip,
                                          dtype):
    """The store's view, 40 -> 32 and 32 -> 32, given JAX's draws; and the
    two-view form, q's draws from the first split key, k's from the
    second."""
    jdt, tdt = DTYPES[dtype]
    C = CHANNELS[img_type]
    for H, crop, seed in ((40, 32, 1), (32, 32, 2)):
        canv = _canvases(seed, 16, H, C)
        key = jax.random.PRNGKey(seed)
        want = jaug.augment_train_canvas(
            key, jnp.asarray(canv), crop=crop, img_type=img_type,
            rotate_deg=rotate_deg, hflip=hflip, out_dtype=jdt)
        d = jax_canvas_draws(key, 16, H, H, crop, rotate_deg, hflip)
        got = aug.canvas_view(torch.from_numpy(canv), d, crop=crop,
                              img_type=img_type, out_dtype=tdt)
        assert got.dtype == tdt and got.shape == (16, crop, crop, C)
        assert_view_equal(got.float(), want.astype(jnp.float32), d.deg,
                          d.tops, d.lefts, H, H)
        jq, jk = jaug.augment_two_views_canvas(
            key, jnp.asarray(canv), crop=crop, img_type=img_type,
            rotate_deg=rotate_deg, hflip=hflip, out_dtype=jdt)
        for sub, jv in zip(jax.random.split(key), (jq, jk)):
            d = jax_canvas_draws(sub, 16, H, H, crop, rotate_deg, hflip)
            got = aug.canvas_view(torch.from_numpy(canv), d, crop=crop,
                                  img_type=img_type, out_dtype=tdt)
            assert_view_equal(got.float(), jv.astype(jnp.float32), d.deg,
                              d.tops, d.lefts, H, H)


@pytest.mark.parametrize("img_type", sorted(CHANNELS))
@pytest.mark.parametrize("rotate_deg", [0.0, 10.0])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_augment_batch_training_and_two_views_match_jax(img_type,
                                                        rotate_deg, dtype):
    """``augment_batch(training=True)`` (the crop-first feed's view) and
    ``augment_two_views`` on two crops, given JAX's draws."""
    jdt, tdt = DTYPES[dtype]
    C = CHANNELS[img_type]
    cq, ck = _canvases(3, 16, 32, C), _canvases(4, 16, 32, C)
    key = jax.random.PRNGKey(5)
    want = jaug.augment_batch(key, jnp.asarray(cq), img_type=img_type,
                              training=True, rotate_deg=rotate_deg,
                              out_dtype=jdt)
    d = jax_batch_draws(key, 16, rotate_deg, True)
    got = aug.batch_view(torch.from_numpy(cq), d, img_type=img_type,
                         out_dtype=tdt)
    assert_view_equal(got.float(), want.astype(jnp.float32), d.deg, None,
                      None, 32, 32)
    jq, jk = jaug.augment_two_views(key, jnp.asarray(cq), jnp.asarray(ck),
                                    img_type=img_type,
                                    rotate_deg=rotate_deg, out_dtype=jdt)
    for sub, canv, jv in zip(jax.random.split(key), (cq, ck), (jq, jk)):
        d = jax_batch_draws(sub, 16, rotate_deg, True)
        got = aug.batch_view(torch.from_numpy(canv), d, img_type=img_type,
                             out_dtype=tdt)
        assert_view_equal(got.float(), jv.astype(jnp.float32), d.deg, None,
                          None, 32, 32)


@pytest.mark.parametrize("img_type", sorted(CHANNELS))
def test_eval_normalisation_matches_jax_bit_for_bit(img_type):
    """Every uint8 value in every channel: XLA's fma(x, 1/255, -mean) *
    (1/std), which the port tabulates."""
    C = CHANNELS[img_type]
    canv = np.broadcast_to(np.arange(256, dtype=np.uint8)[None, :, None,
                                                          None],
                           (2, 256, 4, C)).copy()
    for jdt, tdt in DTYPES.values():
        want = jaug.augment_batch(jax.random.PRNGKey(0), jnp.asarray(canv),
                                  img_type=img_type, training=False,
                                  out_dtype=jdt)
        got = aug.augment_batch(torch.from_numpy(canv), img_type=img_type,
                                out_dtype=tdt)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
    with pytest.raises(ValueError, match="normalises 3 channels"):
        aug.augment_batch(torch.zeros(1, 2, 2, 4, dtype=torch.uint8))


def test_draw_ranges_rates_and_replay():
    """tops and lefts cover [0, H - crop] with both ends hit, flips come
    at about half, angles spread over [-10, 10), and one seed replays the
    same draws; a view draws flip, angle, top, left in that order."""
    gen = aug.epoch_generator(0, 0, 0, "cpu")
    d = aug.draw_canvas_view(gen, (4096, 40, 36, 3), crop=32)
    assert d.tops.min() == 0 and d.tops.max() == 8
    assert d.lefts.min() == 0 and d.lefts.max() == 4
    assert set(d.tops.tolist()) == set(range(9))
    assert 0.45 < d.flip.float().mean() < 0.55
    assert d.deg.min() >= -10 and d.deg.max() < 10
    assert d.deg.min() < -9.9 and d.deg.max() > 9.9
    again = aug.draw_canvas_view(aug.epoch_generator(0, 0, 0, "cpu"),
                                 (4096, 40, 36, 3), crop=32)
    for a, b in zip(vars(d).values(), vars(again).values()):
        assert torch.equal(a, b)
    g = aug.epoch_generator(0, 0, 0, "cpu")
    flip = torch.rand(4096, generator=g) < 0.5
    deg = torch.empty(4096).uniform_(-10, 10, generator=g)
    assert torch.equal(flip, d.flip) and torch.equal(deg, d.deg)
    none = aug.draw_canvas_view(aug.epoch_generator(0, 0, 0, "cpu"),
                                (8, 32, 32, 3), crop=32, rotate_deg=0,
                                hflip=False)
    assert none.flip is None and none.deg is None
    assert not none.tops.any() and not none.lefts.any()
    with pytest.raises(ValueError, match="crop 40 > canvas"):
        aug.draw_canvas_view(gen, (2, 32, 32, 3), crop=40)


def test_epoch_generator_is_a_function_of_seed_draw_and_epoch():
    """Epoch E's generator is the same whether a run started at 0 or at E
    (each (seed, draw, epoch) seeds its own), and differs across each of
    the three."""
    def views(seed, draw, epoch):
        return aug.draw_canvas_view(aug.epoch_generator(seed, draw, epoch,
                                                        "cpu"),
                                    (64, 40, 40, 3), crop=32).deg

    straight = [views(0, 1, e) for e in range(3)]
    resumed = [views(0, 1, e) for e in range(2, 3)]
    assert torch.equal(straight[2], resumed[0])
    for other in (views(1, 1, 2), views(0, 2, 2), straight[1]):
        assert not torch.equal(other, straight[2])
    state = np.random.SeedSequence([0, 1, 2]).generate_state(1)[0]
    assert torch.equal(aug.epoch_generator(0, 1, 2, "cpu").get_state(),
                       torch.Generator().manual_seed(int(state)).get_state())


@pytest.mark.parametrize("view", ["train_canvas", "two_views_canvas",
                                  "batch_training"])
def test_rank_blocks_are_rows_of_the_global_view(view):
    """Under ``world`` ranks each view function draws for the global batch
    and returns its rank's rows: the blocks of two ranks, each from the
    (draw, epoch) generator, concatenate to the one-rank view of the
    whole batch bit for bit, as JAX draws one view over a sharded batch."""
    canv = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (8, 40, 40, 3), dtype=np.uint8))

    def run(x, **kw):
        gen = aug.epoch_generator(0, 1, 2, "cpu")
        if view == "train_canvas":
            return (aug.augment_train_canvas(gen, x, crop=32, **kw),)
        if view == "two_views_canvas":
            return aug.augment_two_views_canvas(gen, x, crop=32, **kw)
        return (aug.augment_batch(x, training=True, generator=gen, **kw),)

    whole = run(canv)
    blocks = [run(canv[r * 4:(r + 1) * 4], world=2, rank=r)
              for r in range(2)]
    for i, want in enumerate(whole):
        assert torch.equal(torch.cat([b[i] for b in blocks]), want)
