"""The rest of MoCo pretraining's inputs on the CPU against the JAX
package: the host transform stacks (``ChexpertTransform``,
``ByolTransform``, ``MoCoV3Transform`` and their parts), the 4-channel,
cross-modal and CheXpert datasets, the loaders ``pretrain`` builds for
``--in-chans 4``, the BYOL ``--aug-setting``s and ``--pairing enh_cxr``,
the 4-channel models, the ``pretrain`` CLI under each new input, and the
jax-free e2e workflow.

Tolerances: transforms, datasets, manifests and loader batches are equal
bit for bit (the same ``random.Random`` draws in the same order, the same
PIL and numpy calls). The normalised 4-channel views agree to 1e-6 (fp32
arithmetic in another order). The 4-channel models take the bars of
``test_conv_stem_archs_match_jax``: features within atol 1e-4 in fp32, the
moved BatchNorm statistics within 1e-5. JAX runs with the canvas cache off,
the device-aug streaming feed and no device store (its
``--device-store-mb 0``)."""
import argparse
import os
import random

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfvit_tpu.cli import common as jcommon
from mfvit_tpu.data import datasets as jds
from mfvit_tpu.data import host_transforms as jht
from mfvit_tpu.data import manifest as jmf
from mfvit_tpu.exp import checkpoint as jckpt
from mfvit_tpu.nn import resnet as jresnet
from mfvit_tpu.nn import vit as jvit
from mfvit_tpu.ssl import moco as jmoco
from mfvit_tpu_torch.cli import common, pretrain
from mfvit_tpu_torch.data import datasets as pds
from mfvit_tpu_torch.data import host_transforms as pht
from mfvit_tpu_torch.data import manifest as pmf
from mfvit_tpu_torch.exp import checkpoint
from mfvit_tpu_torch.nn import resnet, vit
from mfvit_tpu_torch.ssl import moco
from mfvit_tpu_torch.tools import e2e_workflow

N = 24
DISEASE = "Edema"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _equal(a, b):
    assert type(a) is type(b) or isinstance(a, np.ndarray)
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """24 pairs of non-square images (64 x 72), the 'data' and
    'Train_Mix' image of a pair different, all in the ratio-1 train
    manifest; the same images as a CheXpert layout ('cxr', 'enh' folders)
    under a CRLF CSV whose disease column holds every label form, with a
    short line."""
    root = tmp_path_factory.mktemp("moco_inputs")
    images, man = root / "images", root / "create_covid_dataset"
    os.makedirs(man)
    rng = np.random.default_rng(0)
    names = [f"img_{i}.png" for i in range(N)]
    for folder, alias in (("data", "cxr"), ("Train_Mix", "enh")):
        os.makedirs(images / folder)
        os.makedirs(root / alias)
        for fn in names:
            img = rng.integers(0, 255, (64, 72, 3), np.uint8)
            cv2.imwrite(str(images / folder / fn), img)
            cv2.imwrite(str(root / alias / fn), img)
    pmf.write_covid_manifest(str(man / "1_labeled_train_0.txt"),
                             str(images), names, [i % 3 for i in range(N)])
    forms = ["1.0", "", "0.0", "-1.0"]
    with open(root / "chexpert.csv", "w", newline="") as f:
        f.write("Idx,Path,Sex,Edema\r\n")
        for i, fn in enumerate(names):
            f.write(f"{i},{fn},F,{forms[i % 4]}\r\n")
        f.write("short\r\n")
    return root


def _man(root):
    return str(root / "create_covid_dataset" / "1_labeled_train_0.txt")


# ------------------------------------------------------------ transforms

def _images():
    """Two ordinary images and one of extreme aspect (4 x 400), on which
    every RandomResizedCrop draw misses and the center fallback runs."""
    rng = np.random.default_rng(5)
    return [rng.integers(0, 255, s, np.uint8)
            for s in ((40, 52, 3), (52, 40, 3), (4, 400, 3))]


TRANSFORMS = {
    **{f"chexpert_train_{'ratio' if mr else 'square'}_rot{rot}":
       (lambda ht, mr=mr, rot=rot: ht.ChexpertTransform(
           img_size=32, crop=28, training=True, maintain_ratio=mr,
           rotate_deg=rot, seed=3))
       for mr in (True, False) for rot in (0, 10)},
    **{f"chexpert_eval_{'ratio' if mr else 'square'}":
       (lambda ht, mr=mr: ht.ChexpertTransform(
           img_size=32, crop=28, img_type="Train_Mix", maintain_ratio=mr,
           seed=3)) for mr in (True, False)},
    "chexpert_train_canvas_no_flip": lambda ht: ht.ChexpertTransform(
        img_size=32, crop=32, training=True, hflip=False, normalize=False,
        seed=4),
    **{f"byol_{v}_crop_min{cm}":
       (lambda ht, v=v, cm=cm: ht.ByolTransform(img_size=32, crop_min=cm,
                                                variant=v, seed=5))
       for v in ("aug1", "aug2") for cm in (0.08, 0.2)},
    "byol_aug2_unnormalised": lambda ht: ht.ByolTransform(
        img_size=32, variant="aug2", seed=6, normalize=False),
    **{f"mocov3_train_crop_min{cm}_rot{rot}":
       (lambda ht, cm=cm, rot=rot: ht.MoCoV3Transform(
           img_size=32, crop=28, crop_min=cm, rotate_deg=rot, seed=7))
       for cm, rot in ((0.08, 10), (0.2, 0))},
    **{f"mocov3_eval_{'ratio' if mr else 'square'}":
       (lambda ht, mr=mr: ht.MoCoV3Transform(
           img_size=32, crop=28, training=False, maintain_ratio=mr, seed=7))
       for mr in (True, False)},
}


@pytest.mark.parametrize("case", sorted(TRANSFORMS))
def test_transforms_match_jax(case):
    """Every context kind: the shared sequential stream (no context), and
    the per-sample (epoch, index[, view]) streams."""
    jt, pt = TRANSFORMS[case](jht), TRANSFORMS[case](pht)
    ctxs = [None, None] + [(e, i) for e in (0, 1) for i in range(3)] + [
        (0, 2, 1)]
    for ctx in ctxs:
        for img in _images():
            want, got = jt(img, ctx), pt(img, ctx)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=str(ctx))


def test_chexpert_transform_refuses_a_crop_past_the_resize():
    for ht in (jht, pht):
        with pytest.raises(ValueError, match="cannot be satisfied"):
            ht.ChexpertTransform(img_size=32, crop=48, training=True)
    with pytest.raises(ValueError, match="random_crop"):
        pht.random_crop(np.zeros((8, 8, 3), np.uint8), 9, 4,
                        random.Random(0))


def test_random_resized_crop_falls_back_to_the_center_as_jax():
    img = _images()[2]  # 4 x 400: no draw of area >= 0.08 fits its height
    for seed in range(4):
        want = jht.random_resized_crop(img, 16, random.Random(seed))
        got = pht.random_resized_crop(img, 16, random.Random(seed))
        np.testing.assert_array_equal(got, want)
    # the fallback: aspect 100 > 4/3, so a (4, round(4 * 4 / 3)) center crop
    crop = pht.center_crop(img, 4, 5)
    fallback = pht.resize_square(np.ascontiguousarray(crop), 16)
    np.testing.assert_array_equal(got, fallback)
    ordinary = _images()[0]
    for scale in ((0.08, 1.0), (0.2, 1.0)):
        r1, r2 = random.Random(1), random.Random(1)
        np.testing.assert_array_equal(
            pht.random_resized_crop(ordinary, 24, r1, scale=scale),
            jht.random_resized_crop(ordinary, 24, r2, scale=scale))
        assert r1.random() == r2.random()  # the same number of draws


def test_jitter_blur_solarize_match_jax():
    img = _images()[0]
    for seed in range(6):
        r1, r2 = random.Random(seed), random.Random(seed)
        np.testing.assert_array_equal(pht.color_jitter(img, r1),
                                      jht.color_jitter(img, r2))
        assert r1.random() == r2.random()
    for sigma in (0.1, 1.3):
        np.testing.assert_array_equal(pht.gaussian_blur(img, sigma),
                                      jht.gaussian_blur(img, sigma))
    np.testing.assert_array_equal(pht.solarize(img), jht.solarize(img))
    np.testing.assert_array_equal(
        pht.to_float_chw_free(img, pht.IMAGENET_MEAN, pht.IMAGENET_STD),
        jht.to_float_chw_free(img, jht.IMAGENET_MEAN, jht.IMAGENET_STD))


# -------------------------------------------------------------- manifests

def test_parse_chexpert_matches_jax(root):
    for folder in ("cxr", "enh"):
        want = jmf.parse_chexpert(str(root / "chexpert.csv"), str(root / folder),
                                  DISEASE)
        got = pmf.parse_chexpert(str(root / "chexpert.csv"), str(root / folder),
                                 DISEASE)
        assert got.paths == want.paths and len(got) == N  # short line skipped
        np.testing.assert_array_equal(got.labels, want.labels)
        assert got.labels.dtype == np.int32
    assert list(got.labels[:4]) == [1, 0, 0, 1]
    assert pmf.CHEXPERT_LABEL_MAP == jmf.CHEXPERT_LABEL_MAP
    for mf in (jmf, pmf):
        with pytest.raises(ValueError, match="Pneumonia"):
            mf.parse_chexpert(str(root / "chexpert.csv"), str(root),
                              "Pneumonia")


def test_parse_covid_paired_takes_jax_folders(root):
    for folders in ((), ("cxr", "enh")):
        want = jmf.parse_covid_paired(_man(root), *folders)
        got = pmf.parse_covid_paired(_man(root), *folders)
        assert (got.paths, got.paths_alt) == (want.paths, want.paths_alt)
        np.testing.assert_array_equal(got.labels, want.labels)


# --------------------------------------------------------------- datasets

def _chex_tf(ht, img_type, seed):
    return ht.ChexpertTransform(img_size=32, crop=28, img_type=img_type,
                                training=True, rotate_deg=10.0, seed=seed)


def _canvas(ht, seed):
    kw = {} if ht is pht else {"hflip": True}
    return ht.CanvasTransform(img_size=40, crop=32, training=True,
                              rotate_deg=10.0, seed=seed, **kw)


def _datasets(m, ht, root, case):
    man, csv = _man(root), str(root / "chexpert.csv")
    cxr, enh = str(root / "cxr"), str(root / "enh")
    kind, _, arg = case.partition(":")
    if kind in ("4ch", "4ch_two"):
        cls = m.Covid4chDataset if kind == "4ch" else m.Covid4chTwoCropsDataset
        return cls(man, _canvas(ht, 2), folder_cxr="data")
    if kind == "enh_cxr":
        return m.CovidEnhCxrDataset(man, _chex_tf(ht, "data", 0),
                                    _chex_tf(ht, "Train_Mix", 1),
                                    per_enh=float(arg), seed=4)
    if kind in ("chexpert", "chexpert_two"):
        cls = (m.ChexpertDataset if kind == "chexpert"
               else m.ChexpertTwoCropsDataset)
        return cls(cxr, csv, _chex_tf(ht, "CheXpert-v1.0-small", 3), DISEASE)
    mode, per = arg.split("_")
    return m.ChexpertMixDataset(cxr, enh, csv,
                                _chex_tf(ht, "CheXpert-v1.0-small", 5),
                                _chex_tf(ht, "CheXpert_Enh", 6), DISEASE,
                                per_enh=float(per), mode=mode, seed=9)


DATASETS = (["4ch", "4ch_two", "enh_cxr:1.0", "enh_cxr:0.5", "chexpert",
             "chexpert_two"]
            + [f"mix:{mode}_{p}" for mode in ("mix", "norm1")
               for p in ("0.3", "0.7")])


@pytest.mark.parametrize("case", DATASETS)
def test_datasets_match_jax(root, case):
    jd, pd = _datasets(jds, jht, root, case), _datasets(pds, pht, root, case)
    assert len(jd) == len(pd) == N
    for epoch in (0, 1):
        jd.set_epoch(epoch)
        pd.set_epoch(epoch)
        for i in range(N):
            _equal(pd[i], jd[i])
    if case.startswith("4ch"):
        assert pd[0][0].shape[-1] == 4


def test_4ch_stacks_the_cxr_red_channel_and_the_enh_image(root):
    """np.concatenate((cxr, enh), 2)[:, :, 2:]: the CXR's R (BGR order),
    then the enhanced B, G and R."""
    ds = pds.Covid4chDataset(_man(root), lambda img: img)
    cxr = cv2.imread(ds.manifest.paths[3])
    enh = cv2.imread(ds.manifest.paths_alt[3])
    img, label = ds[3]
    np.testing.assert_array_equal(img[..., 0], cxr[..., 2])
    np.testing.assert_array_equal(img[..., 1:], enh)
    assert label == 0


@pytest.mark.parametrize("per_enh", [0.5, 0.7])
def test_enh_cxr_mix_takes_both_queries(root, per_enh):
    """The salted mix decision: at per_enh < 1 some queries are the
    enhanced image through its stack, the others the CXR through its own,
    and the CXR query still flips (the draw is not the flip's)."""
    tfc, tfe = _chex_tf(pht, "data", 0), _chex_tf(pht, "Train_Mix", 1)
    ds = pds.CovidEnhCxrDataset(_man(root), tfc, tfe, per_enh=per_enh, seed=4)
    enh_q = []
    for i in range(N):
        q, _, _ = ds[i]
        cxr = cv2.imread(ds.manifest.paths[i])
        enh = cv2.imread(ds.manifest.paths_alt[i])
        is_enh = np.array_equal(q, tfe(enh, (0, i)))
        assert is_enh != np.array_equal(q, tfc(cxr, (0, i)))
        enh_q.append(is_enh)
    assert 0 < sum(enh_q) < N
    flips = [random.Random(hash((0, 0, i))).random() < 0.5
             for i in range(N) if not enh_q[i]]
    assert any(flips)


# ---------------------------------------------------------------- loaders

def _args(**kw):
    a = argparse.Namespace(img_size=40, crop=32, maintain_ratio=False,
                           batch_size=8, workers=2, rotate=10.0,
                           compute_dtype="float32", aug_setting="chexpert",
                           crop_min=0.08, per_enh=1.0, in_chans=3)
    vars(a).update(kw)
    return a, argparse.Namespace(**vars(a), aug_device=True,
                                 canvas_cache=False, canvas_cache_mb=0,
                                 device_store_mb=0)


def _same_epochs(jl, pl, n_batches=3):
    assert len(jl) == len(pl) == n_batches
    out = []
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        jb, pb = list(jl), list(pl)
        assert len(jb) == len(pb) == n_batches
        for j, p in zip(jb, pb):
            _equal(tuple(p), tuple(j))
        out.append(pb)
    return out


@pytest.mark.parametrize("two_views", [False, True])
def test_fourch_loader_batches_match_jax(root, two_views):
    a, ja = _args(maintain_ratio=two_views, in_chans=4)
    jl = jcommon.make_covid_loader(ja, _man(root), "data", training=True,
                                   fourch=True, ssl_two_views=two_views,
                                   seed=1)
    pl = common.make_covid_loader(a, _man(root), "data", training=True,
                                  fourch=True, ssl_two_views=two_views,
                                  seed=1)
    epochs = _same_epochs(jl, pl)
    assert epochs[0][0][0].shape == (8, 32, 32, 4)
    assert epochs[0][0][0].dtype == np.uint8


@pytest.mark.parametrize("setting,crop_min", [("moco_v1", 0.08),
                                              ("moco_v2", 0.2),
                                              ("aug1", 0.2),
                                              ("aug2", 0.08)])
def test_byol_loader_batches_match_jax(root, setting, crop_min):
    a, ja = _args(img_size=32, aug_setting=setting, crop_min=crop_min)
    jl = jcommon.make_ssl_two_crops_loader(ja, _man(root), "data", seed=2)
    pl = common.make_ssl_two_crops_loader(a, _man(root), "data", seed=2)
    q = _same_epochs(jl, pl)[0][0][0]
    assert q.shape == (8, 32, 32, 3) and q.dtype == np.float32


def test_enh_cxr_loader_batches_match_jax(root):
    a, ja = _args(per_enh=0.7, maintain_ratio=True)
    jl = jcommon.make_enh_cxr_ssl_loader(ja, _man(root), seed=3)
    pl = common.make_enh_cxr_ssl_loader(a, _man(root), seed=3)
    q = _same_epochs(jl, pl)[1][2][0]
    assert q.shape == (8, 32, 32, 3) and q.dtype == np.float32


def test_4ch_views_normalised_as_jax(root):
    a, ja = _args(in_chans=4)
    pl = common.make_covid_loader(a, _man(root), "data", training=True,
                                  fourch=True, ssl_two_views=True, seed=1)
    cq, ck, _ = next(iter(pl))
    jq, jk = jcommon.stream_train_two_views(
        ja, jax.random.PRNGKey(0), jnp.asarray(cq), jnp.asarray(ck), "4ch")
    q, k = common.stream_train_two_views(a, torch.from_numpy(cq),
                                         torch.from_numpy(ck), "4ch")
    for got, want in ((q, jq), (k, jk)):
        assert got.shape == (8, 32, 32, 4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


# ----------------------------------------------------------------- models

@pytest.mark.parametrize("name", ["vit_test", "vit_conv_small"])
def test_4ch_vit_archs_match_jax(name):
    """vit_test and vit_conv_small (full widths) with 4 input channels,
    32 px: the patch weight (D, 4, P, P) from JAX's (P*P*4, D) in its
    (ph, pw, c) order, or the stem's first conv with 4 inputs; the
    forward with running and with batch statistics."""
    jcfg = (jvit.ViTConfig("vit_test", img_size=32, patch=16, dim=32,
                           depth=2, heads=2) if name == "vit_test"
            else jvit.get_config(name, 32))
    jp = jvit.init(jax.random.PRNGKey(7), jcfg, num_classes=3, in_chans=4)
    cfg = vit.ViTConfig(**{f: getattr(jcfg, f) for f in
                           vit.ViTConfig.__dataclass_fields__})
    model = vit.ViT(cfg, 3, in_chans=4)
    model.load_state_dict(checkpoint.vit_state_from_jax(_np(jp), cfg),
                          strict=True)
    first = ("patch_embed.proj.0.weight" if cfg.conv_stem
             else "patch_embed.proj.weight")
    assert model.state_dict()[first].shape[1] == 4
    if not cfg.conv_stem:
        w = np.asarray(jp["patch"]["w"])  # (16 * 16 * 4, D)
        np.testing.assert_array_equal(
            model.patch_embed.proj.weight[:, 1, 0, 2].detach().numpy(),
            w[(0 * 16 + 2) * 4 + 1])
    img = np.random.default_rng(8).standard_normal((2, 32, 32, 4)).astype(
        np.float32)
    for bn_training in (False, True) if cfg.conv_stem else (False,):
        kw = {"bn_training": True} if bn_training else {}
        want = jvit.apply(jp, jnp.asarray(img), jcfg,
                          compute_dtype=jnp.float32, attn_backend="xla", **kw)
        if bn_training:
            want, new_patch = want
        with torch.no_grad():
            got = model(torch.from_numpy(img), compute_dtype=torch.float32,
                        bn_training=bn_training)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    if cfg.conv_stem:
        moved = checkpoint.vit_state_from_jax(_np(dict(jp, patch=new_patch)),
                                              cfg)
        for k, v in model.state_dict().items():
            if k.startswith("patch_embed"):
                np.testing.assert_allclose(v.numpy(), moved[k].numpy(),
                                           atol=1e-5, err_msg=k)


def test_resnet18_4ch_matches_jax():
    """ResNet-18 with a 4-channel stem at 32 px, B=8 as the MoCo
    trajectories run it: the features with running and with batch
    statistics (the last BatchNorm over 8 values at 1 x 1 differs from
    JAX's by up to 8e-5 at 3 channels as at 4)."""
    jcfg = jresnet.get_config("resnet18", in_chans=4)
    jp = jresnet.init(jax.random.PRNGKey(3), jcfg)
    cfg = resnet.get_config("resnet18", in_chans=4)
    assert cfg.in_chans == 4 and resnet.get_config("resnet18").in_chans == 3
    model = resnet.ResNet(cfg)
    model.load_state_dict(checkpoint.resnet_state_from_jax(_np(jp), cfg),
                          strict=True)
    assert model.conv1.weight.shape == (64, 4, 7, 7)
    img = np.random.default_rng(9).standard_normal((8, 32, 32, 4)).astype(
        np.float32)
    for training in (False, True):
        want, _ = jresnet.apply(jp, jnp.asarray(img), jcfg, training=training,
                                compute_dtype=jnp.float32)
        with torch.no_grad():
            got = model(torch.from_numpy(img), compute_dtype=torch.float32,
                        training=training)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_resnet_arms_keep_a_fresh_4ch_stem(tmp_path):
    """--pretrained-arms with --in-chans 4: every torchvision weight but
    ``conv1`` (3-channel) into both towers; the fresh 4-channel stem
    stays, as JAX keeps its initialised one."""
    src = resnet.ResNet(resnet.get_config("resnet18"), 10,
                        generator=torch.Generator().manual_seed(3))
    path = str(tmp_path / "resnet18.pth")
    torch.save(src.state_dict(), path)
    jm = jmoco.MoCoConfig.resnet(dim=8, mlp_dim=16, K=32)
    jcfg = jresnet.get_config("resnet18", in_chans=4)
    jstate = jmoco.init(jax.random.PRNGKey(0), jm, jcfg, in_chans=4)
    jgraft = jckpt.resnet_arms_from_torchvision(jstate, path, jcfg)
    pm = moco.MoCoConfig.resnet(dim=8, mlp_dim=16, K=32)
    model = moco.MoCo(pm, resnet.get_config("resnet18"), in_chans=4)
    model.load_state_dict(checkpoint.moco_state_from_jax(
        _np(jstate), pm, resnet.get_config("resnet18", in_chans=4)))
    checkpoint.load_resnet_arms(model, path)
    want = checkpoint.moco_state_from_jax(
        _np(jgraft), pm, resnet.get_config("resnet18", in_chans=4))
    for k, v in model.state_dict().items():
        if ".encoder." in k and not k.endswith("num_batches_tracked"):
            assert torch.equal(v, want[k]), k
    assert model.base.encoder.conv1.weight.shape == (64, 4, 7, 7)
    np.testing.assert_array_equal(
        model.base.encoder.conv1.weight.detach().numpy(),
        checkpoint.resnet_state_from_jax(
            _np(jstate["base"]["encoder"]), jcfg)["conv1.weight"].numpy())


# -------------------------------------------------------------------- CLI

FLAGS = ["-a", "vit_test", "--img-size", "32", "--crop", "32",
         "--compute-dtype", "float32", "-j", "2", "--seed", "0", "-b", "8",
         "--cos", "--lr", "0.3", "--warmup-epochs", "1", "--moco-dim", "8",
         "--moco-mlp-dim", "16", "--moco-k", "32", "--moco-t", "0.2",
         "--moco-m-cos", "--semi-ratios", "1", "-p", "1", "--device", "cpu"]


def _run(root, tag, extra):
    out = root / tag
    (res,) = pretrain.main(FLAGS + ["--covid-ds", str(
        root / "create_covid_dataset"), "--storage-root", str(out)] + extra)
    return res, next(out.iterdir()) / "train_1_0"


CLI_CASES = {
    "in_chans_4": ["--in-chans", "4", "--epochs", "2"],
    "moco_v2": ["--aug-setting", "moco_v2", "--crop-min", "0.2", "--epochs",
                "2"],
    "aug1": ["--aug-setting", "aug1", "--epochs", "2"],
    "enh_cxr": ["--pairing", "enh_cxr", "--per-enh", "0.7", "--epochs", "2"],
    # with a hidden width of 16, an image's predictor hidden row after
    # BatchNorm and ReLU can be all zero for the ResNet heads (no bias), so
    # its query is zero and its L2 norm divides by zero: JAX's _l2norm as
    # this port's, at 3 channels as at 4 (ROADMAP.md section 3); this case
    # takes a hidden width of 256
    "resnet18_in_chans_4": ["-a", "resnet18", "--in-chans", "4", "--epochs",
                            "1", "--moco-mlp-dim", "256"],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_pretrain_cli_runs_the_new_inputs(root, case):
    extra = CLI_CASES[case]
    res, sub = _run(root, case, extra)
    epochs = int(extra[extra.index("--epochs") + 1])
    losses = res.extra["train_losses"]
    assert len(losses) == 3 * epochs  # 24 images at B=8
    assert all(np.isfinite(losses))
    last = f"checkpoint_{epochs - 1:04d}"
    for name in ("checkpoint_best_loss", last):
        assert (sub / name).exists(), name
    state = torch.load(sub / last, weights_only=True)["state"]
    assert int(state["queue_ptr"]) == 8 * 3 * epochs % 32
    first = {"in_chans_4": "base.encoder.patch_embed.proj.weight",
             "resnet18_in_chans_4": "base.encoder.conv1.weight"}.get(
                 case, "base.encoder.patch_embed.proj.weight")
    assert state[first].shape[1] == (4 if "in_chans_4" in case else 3)


def test_pretrain_enh_cxr_resume_is_bit_exact(root):
    extra = ["--pairing", "enh_cxr", "--per-enh", "0.7", "--epochs", "2"]
    _, straight = _run(root, "enh_straight", extra)
    _, first = _run(root, "enh_first", extra + ["--save-epoch", "1"])
    _, second = _run(root, "enh_second", extra + [
        "--resume", str(first / "checkpoint_0000")])
    want = torch.load(straight / "checkpoint_0001", weights_only=True)
    got = torch.load(second / "checkpoint_0001", weights_only=True)
    assert got["epoch"] == want["epoch"] == 1
    for k, v in want["state"].items():
        assert torch.equal(got["state"][k], v), k


@pytest.mark.parametrize("extra,msg", [
    (["--pairing", "enh_cxr", "--in-chans", "4"],
     "--pairing enh_cxr is a 3-channel chexpert-stack variant"),
    (["--pairing", "enh_cxr", "--aug-setting", "aug2"],
     "--pairing enh_cxr is a 3-channel chexpert-stack variant"),
    (["--in-chans", "4", "--aug-setting", "moco_v1"],
     r"--in-chans 4 requires --aug-setting chexpert \(device-aug "
     r"canvases\)")])
def test_pretrain_raises_jax_errors(root, extra, msg):
    with pytest.raises(ValueError, match=msg):
        _run(root, "invalid", ["--epochs", "1"] + extra)


def test_pretrain_export_refuses_4_channels(root):
    for arch in ("vit_test", "resnet18"):
        with pytest.raises(SystemExit, match=r"--export-torch does not "
                           r"support -a \w+ --in-chans 4"):
            _run(root, "refused_export", ["--epochs", "1", "-a", arch,
                                          "--in-chans", "4",
                                          "--export-torch"])


def test_e2e_workflow_reaches_infer_metrics(tmp_path):
    out = e2e_workflow.main(["--root", str(tmp_path), "--device", "cpu",
                             "-a", "vit_test", "--img-size", "32",
                             "--compute-dtype", "float32", "--fusion-heads",
                             "2"])
    assert out["n"] == 8
    assert set(out["metrics"]) >= {"auc", "top1", "precision", "recall",
                                   "f1"}
    assert all(np.isfinite(v) for v in out["metrics"].values())
    assert os.path.exists(tmp_path / "preds.json")


def test_finetune_and_fuse_refuse_4_channels(root):
    """``--in-chans 4`` stays pretrain-only, as in JAX's get_vit_arch."""
    from mfvit_tpu_torch.cli import finetune, fuse
    for main in (finetune.main, fuse.main):
        with pytest.raises(SystemExit, match="pretrain-only"):
            main(["-a", "vit_test", "--in-chans", "4", "--device", "cpu",
                  "--covid-ds", str(root / "create_covid_dataset"),
                  "--storage-root", str(root / "refused_vit")])
