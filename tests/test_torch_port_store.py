"""The port's data path on the CPU against the JAX package's: the device
canvas store (``mfvit_tpu_torch/data/device_store.py``: its table,
labels and index batches, the eval stores), the store budget and its
messages, the decode cache, the pinned prefetch, the ``--aug-host`` and
``--aug-order crop-first`` feeds, the training CLIs at their default
flags (which now train from the store, as JAX's do), ``infer
--aug-host`` and the jax-free ``tools/make_splits``.

Tolerances: tables, labels, index batches, host canvases, host floats,
messages and split files are equal bit for bit (byte for byte); the CLI
runs hold their step plans (the progress lines, epochs x steps) and store
notices against JAX's; eval metrics through the eval store equal the
streaming eval's exactly (the same canvases and weights); ``infer
--aug-host`` holds JAX's logits to 1e-4, as ``test_torch_port_infer.py``
holds the default path."""
import argparse
import filecmp
import importlib.util
import os
import re

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfvit_tpu.cli import common as jcommon
from mfvit_tpu.cli import finetune as jfinetune
from mfvit_tpu.cli import fuse as jfuse
from mfvit_tpu.cli import infer as jinfer
from mfvit_tpu.cli import pretrain as jpretrain
from mfvit_tpu.data import datasets as jds
from mfvit_tpu.data import device_store as jstore
from mfvit_tpu.data import host_transforms as jht
from mfvit_tpu.exp import checkpoint as jckpt
from mfvit_tpu.models import fusion as jfusion
from mfvit_tpu.nn import vit as jvit
from mfvit_tpu_torch.cli import common, finetune, fuse, infer, pretrain
from mfvit_tpu_torch.data import datasets, device_aug, device_store
from mfvit_tpu_torch.data import host_transforms as ht
from mfvit_tpu_torch.data import manifest, pipeline
from mfvit_tpu_torch.exp import checkpoint
from mfvit_tpu_torch.nn import vit
from mfvit_tpu_torch.train import steps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 24  # 16 train, 4 val, 4 test
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """24 synthetic pairs ('data' and 'Train_Mix', 44 x 52, BGR, the first
    channel carrying the class) in the ``--covid-ds`` layout."""
    root = tmp_path_factory.mktemp("store")
    images, cds = root / "images", root / "create_covid_dataset"
    for folder in ("data", "Train_Mix"):
        os.makedirs(images / folder)
    os.makedirs(cds)
    rng = np.random.default_rng(0)
    names = [f"img_{i}.png" for i in range(N)]
    labels = [i % 3 for i in range(N)]
    for fn, label in zip(names, labels):
        for folder in ("data", "Train_Mix"):
            img = rng.integers(0, 255, (44, 52, 3), np.uint8)
            img[:, :, 0] = np.clip(img[:, :, 0] * 0.2 + label * 80, 0, 255)
            cv2.imwrite(str(images / folder / fn), img)
    for fname, sl in (("1_labeled_train_0.txt", slice(0, 16)),
                      ("val_ds.txt", slice(16, 20)),
                      ("test_ds.txt", slice(20, 24))):
        manifest.write_covid_manifest(str(cds / fname), str(images),
                                      names[sl], labels[sl])
    return root


def _man(root, name="1_labeled_train_0.txt"):
    return str(root / "create_covid_dataset" / name)


def _args(**kw):
    """(port namespace, JAX namespace) of the data flags at their CLI
    defaults, 40 -> 32 px."""
    a = argparse.Namespace(img_size=40, crop=32, maintain_ratio=False,
                           batch_size=8, workers=2, rotate=10.0,
                           compute_dtype="float32", folder="data",
                           aug_device=True,
                           aug_order="reference", canvas_cache=False,
                           canvas_cache_mb=0, device_store_mb=2048)
    vars(a).update(kw)
    return a, argparse.Namespace(**vars(a))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      and x.dtype == torch.bfloat16 else x)


def _equal_batches(jb, pb):
    assert len(jb) == len(pb)
    for j, p in zip(jb, pb):
        assert len(j) == len(p)
        for x, y in zip(j, p):
            np.testing.assert_array_equal(_np(y), np.asarray(x))


# ------------------------------------------------------------------ store

def _fill_datasets(m, ht_mod, root, kind):
    tf = ht_mod.CanvasTransform(img_size=40, training=False,
                                maintain_ratio=False, seed=0)
    if kind == "single":
        return m.CovidDataset("data", _man(root), tf)
    if kind == "paired":
        return m.CovidPairedDataset(_man(root), tf, tf, folder_cxr="data")
    return m.Covid4chDataset(_man(root), tf, folder_cxr="data")


@pytest.mark.parametrize("kind", ["single", "paired", "4ch"])
def test_fill_from_dataset_matches_jax(root, kind):
    """The table (one, two or 4-channel canvases) and the labels."""
    js = jstore.fill_from_dataset(_fill_datasets(jds, jht, root, kind),
                                  batch_size=8, seed=3, num_workers=2)
    ps = device_store.fill_from_dataset(
        _fill_datasets(datasets, ht, root, kind), batch_size=8, seed=3,
        num_workers=2, device=CPU)
    jc = js.canvases if isinstance(js.canvases, tuple) else (js.canvases,)
    pc = ps.canvases if isinstance(ps.canvases, tuple) else (ps.canvases,)
    assert len(jc) == len(pc) == (2 if kind == "paired" else 1)
    for j, p in zip(jc, pc):
        assert p.dtype == torch.uint8
        assert p.shape == (16, 40, 40, 4 if kind == "4ch" else 3)
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    assert ps.labels.dtype == torch.int64
    np.testing.assert_array_equal(ps.labels.numpy(), np.asarray(js.labels))
    assert len(ps) == len(js) == 2 and ps.nbytes == js.nbytes
    assert len(ps.ds) == 16


@pytest.mark.parametrize("n,bs,drop_last,shuffle", [
    (20, 8, True, True),    # shuffled, the short tail dropped
    (20, 6, False, True),   # n % bs != 0, the tail wrap-padded
    (5, 8, False, True),    # n < bs: the wrap-and-tile pad
    (20, 8, False, False),  # the eval order
])
def test_index_batches_match_jax(n, bs, drop_last, shuffle):
    """Three epochs of index vectors, then the gathered batches."""
    table = np.random.default_rng(1).integers(0, 256, (n, 2, 2, 3),
                                              dtype=np.uint8)
    labels = np.arange(n) % 3
    kw = dict(batch_size=bs, seed=7, drop_last=drop_last, shuffle=shuffle)
    js = jstore.DeviceCanvasStore(jnp.asarray(table), jnp.asarray(labels),
                                  **kw)
    ps = device_store.DeviceCanvasStore(torch.from_numpy(table),
                                        torch.from_numpy(labels), **kw)
    assert len(ps) == len(js)
    for epoch in (0, 1, 2):
        js.set_epoch(epoch)
        ps.set_epoch(epoch)
        want = [np.asarray(i) for i in js.iter_index_batches()]
        got = [i.numpy() for i in ps.iter_index_batches()]
        assert len(got) == len(want) == len(js)
        for g, w in zip(got, want):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)
    js.set_epoch(1)
    ps.set_epoch(1)
    _equal_batches(list(js), list(ps))
    # sharded over two ranks: the rows padded by wrapping to an even
    # count, each rank holding its contiguous block
    rows = list(range(n)) + list(range(n % 2))
    shards = [device_store.fill_from_dataset(
        list(zip(table, labels)), batch_size=bs, device="cpu", world=2,
        rank=r, num_workers=1, **{k: kw[k] for k in ("seed", "drop_last",
                                                     "shuffle")})
        for r in range(2)]
    np.testing.assert_array_equal(
        torch.cat([s.canvases for s in shards]).numpy(), table[rows])
    np.testing.assert_array_equal(
        torch.cat([s.labels for s in shards]).numpy(), labels[rows])
    assert all(len(s.ds) == n for s in shards)


@pytest.mark.parametrize("paired,maintain_ratio", [(False, False),
                                                   (True, True)])
def test_eval_store_matches_jax_and_the_streaming_eval(root, paired,
                                                       maintain_ratio):
    """The eval store against JAX's and against the port's streaming eval
    loader (center crops in manifest order, the tail wrap-padded); any
    resize policy."""
    a, ja = _args(batch_size=3, maintain_ratio=maintain_ratio)
    man = _man(root, "val_ds.txt")
    js = jcommon.maybe_eval_device_store(ja, man, "data", paired=paired)
    ps = common.maybe_eval_device_store(a, man, "data", paired=paired,
                                        device=CPU)
    assert len(ps) == len(js) == 2 and len(ps.ds) == 4
    _equal_batches(list(js), list(ps))
    loader = (common.make_paired_loader(a, man) if paired else
              common.make_covid_loader(a, man, "data", training=False))
    _equal_batches(list(loader), list(ps))


def test_store_budget_numbers_and_messages(root, capsys):
    """``StoreBudget``, ``_store_nbytes`` and ``release_store`` give JAX's
    numbers; the train store reserves first, and an eval store the budget
    cannot hold prints JAX's message word for word and streams; a train
    store over the budget, the same."""
    for n, side, chans in ((16, 40, 3), (7, 224, 6), (1, 224, 4)):
        assert (common._store_nbytes(n, side, chans)
                == jcommon._store_nbytes(n, side, chans, 1))
    assert common._store_nbytes(1, 224, 3) == 150_536
    for chans, fits in ((3, 14_265), (6, 7_132), (4, 10_699)):
        assert (2048 << 20) // common._store_nbytes(1, 224, chans) == fits
    # 16 train canvases of 40 x 40 x 3 and 4 val crops of 32 x 32 x 3
    train = common._store_nbytes(16, 40, 3)
    mb = -(-train // (1 << 20))
    outs = []
    for c, dev in ((jcommon, {}), (common, {"device": CPU})):
        a = _args(device_store_mb=mb)[0]
        budget = c.StoreBudget(mb)
        store = c.maybe_device_store(a, _man(root), "data", seed=0,
                                     budget=budget, **dev)
        assert store is not None and budget.left == (mb << 20) - train
        budget.left = common._store_nbytes(4, 32, 3) - 1
        assert c.maybe_eval_device_store(a, _man(root, "val_ds.txt"),
                                         "data", budget=budget,
                                         **dev) is None
        budget.left = train - 1
        assert c.maybe_device_store(a, _man(root), "data", budget=budget,
                                    **dev) is None
        c.release_store(store)
        assert budget.left == 2 * train - 1
        c.release_store(store)  # released once only
        c.release_store(None)
        assert budget.left == 2 * train - 1
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert outs[1].splitlines() == [
        "=> device canvas store: 16 samples (0 MB) resident in HBM; "
        "epochs run host-free",
        "=> eval device canvas store: does not fit --device-store-mb "
        "budget; streaming eval feed",
        "=> device canvas store: does not fit --device-store-mb budget; "
        "streaming feed for this draw"]
    for off in ({"aug_device": False}, {"maintain_ratio": True},
                {"device_store_mb": 0}):
        a = _args(**off)[0]
        assert common.maybe_device_store(a, _man(root), "data",
                                         device=CPU) is None


# ----------------------------------------------------------- decode cache

def test_decode_cache_hits_budget_and_sharing(root):
    path = str(root / "images" / "data" / "img_0.png")
    cache = ht.DecodeResizeCache(40, maintain_ratio=False,
                                 limit_bytes=40 * 40 * 3)
    first = cache(path)
    assert first is cache(path)  # a hit returns the cached array
    assert not first.flags.writeable and cache.nbytes == 40 * 40 * 3
    np.testing.assert_array_equal(
        first, jht.DecodeResizeCache(40, maintain_ratio=False)(path))
    other = str(root / "images" / "data" / "img_1.png")
    assert cache(other) is not cache(other)  # over the budget: not kept
    assert cache.nbytes == 40 * 40 * 3
    shared = ht.shared_decode_cache(40, False, 1 << 20)
    assert shared is ht.shared_decode_cache(40, False, 1 << 20)
    assert shared is not ht.shared_decode_cache(40, True, 1 << 20)
    assert shared is not ht.shared_decode_cache(48, False, 1 << 20)
    np.testing.assert_array_equal(
        ht.DecodeResizeCache(40, maintain_ratio=True)(path),
        jht.DecodeResizeCache(40, maintain_ratio=True)(path))


@pytest.mark.parametrize("maintain_ratio", [False, True])
def test_loader_with_the_cache_equals_one_without(root, maintain_ratio):
    """Two epochs of the training feed and the eval feed, with the cache
    and without, and against JAX's with its cache."""
    a, ja = _args(maintain_ratio=maintain_ratio)
    cached, jcached = _args(maintain_ratio=maintain_ratio,
                            canvas_cache=True, canvas_cache_mb=64)
    for training, man in ((True, _man(root)),
                          (False, _man(root, "val_ds.txt"))):
        plain = common.make_covid_loader(a, man, "data", training=training,
                                         seed=1)
        fast = common.make_covid_loader(cached, man, "data",
                                        training=training, seed=1)
        jfast = jcommon.make_covid_loader(jcached, man, "data",
                                          training=training, seed=1)
        assert isinstance(fast.ds.decode, ht.DecodeResizeCache)
        for epoch in (0, 1):
            for ld in (plain, fast, jfast):
                ld.set_epoch(epoch)
            want = list(plain)
            _equal_batches(want, list(fast))
            _equal_batches(list(jfast), want)
        assert fast.ds.decode.nbytes > 0


def test_prefetch_keeps_order_and_values():
    batches = [(np.full((2, 3), i, np.uint8), np.arange(2) + i)
               for i in range(5)]
    out = list(pipeline.device_prefetch(iter(batches), CPU))
    assert len(out) == 5
    for (x, y), (px, py) in zip(batches, out):
        assert isinstance(px, torch.Tensor) and isinstance(py, torch.Tensor)
        np.testing.assert_array_equal(px.numpy(), x)
        np.testing.assert_array_equal(py.numpy(), y)


# ------------------------------------------------------- aug-host, crop-first

@pytest.mark.parametrize("kind", ["single", "two_views", "paired"])
def test_aug_host_feeds_match_jax(root, kind):
    """``--aug-host``: the full host stack's normalised floats, training
    (two epochs) and eval, bit for bit."""
    a, ja = _args(aug_device=False, crop=28, img_size=32)
    for training, man in ((True, _man(root)),
                          (False, _man(root, "val_ds.txt"))):
        if kind == "paired":
            pl = common.make_paired_loader(a, man, training=training,
                                           seed=2)
        else:
            if kind == "two_views" and not training:
                continue
            pl = common.make_covid_loader(a, man, "data", training=training,
                                          ssl_two_views=kind == "two_views",
                                          seed=2)
        jl = jcommon.make_covid_loader(ja, man, "data", training=training,
                                       paired=kind == "paired",
                                       ssl_two_views=kind == "two_views",
                                       seed=2)
        for epoch in (0, 1):
            jl.set_epoch(epoch)
            pl.set_epoch(epoch)
            pb = list(pl)
            assert pb[0][0].dtype == np.float32
            assert pb[0][0].shape == (8, 28, 28, 3)
            _equal_batches(list(jl), pb)
    with pytest.raises(ValueError) as got:
        common.make_covid_loader(a, _man(root), "data", training=True,
                                 fourch=True)
    with pytest.raises(ValueError) as want:
        jcommon.make_covid_loader(ja, _man(root), "data", training=True,
                                  fourch=True)
    assert str(got.value) == str(want.value)


def _jax_batch_view(key, canv, img_type, rotate_deg=10.0):
    kf, kr = jax.random.split(key)
    B = canv.shape[0]
    return device_aug.ViewDraws(
        torch.from_numpy(np.array(jax.random.bernoulli(kf, 0.5, (B,)))),
        torch.from_numpy(np.array(jax.random.uniform(
            kr, (B,), minval=-rotate_deg, maxval=rotate_deg))))


@pytest.mark.parametrize("kind", ["single", "two_views", "paired"])
def test_crop_first_matches_jax(root, kind):
    """``--aug-order crop-first``: the host canvases (a random crop, no
    flip, no rotation) equal JAX's, and the device view of them equals
    JAX's ``stream_train_view`` given JAX's draws."""
    a, ja = _args(aug_order="crop-first")
    if kind == "paired":
        pl = common.make_paired_loader(a, _man(root), training=True, seed=4)
    else:
        pl = common.make_covid_loader(a, _man(root), "data", training=True,
                                      ssl_two_views=kind == "two_views",
                                      seed=4)
    jl = jcommon.make_covid_loader(ja, _man(root), "data", training=True,
                                   paired=kind == "paired",
                                   ssl_two_views=kind == "two_views",
                                   seed=4)
    pb = list(pl)
    _equal_batches(list(jl), pb)
    canv = pb[0][0]
    assert canv.dtype == np.uint8 and canv.shape == (8, 32, 32, 3)
    key = jax.random.PRNGKey(9)
    if kind == "two_views":
        jq, jk = jcommon.stream_train_two_views(
            ja, key, jnp.asarray(pb[0][0]), jnp.asarray(pb[0][1]), "data")
        wants = zip(jax.random.split(key), pb[0][:2], (jq, jk))
    else:
        want = jcommon.stream_train_view(ja, key, jnp.asarray(canv), "data")
        wants = [(key, canv, want)]
    for k, c, want in wants:
        d = _jax_batch_view(k, c, "data")
        got = device_aug.batch_view(torch.from_numpy(c), d, img_type="data")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the CLI helper draws from its generator, in the stated order
    g = device_aug.epoch_generator(0, 0, 0, "cpu")
    got = common.stream_train_view(a, torch.from_numpy(canv), "data", g)
    d = device_aug.draw_batch_view(device_aug.epoch_generator(0, 0, 0, "cpu"),
                                   8, rotate_deg=10.0)
    np.testing.assert_array_equal(
        got.numpy(), device_aug.batch_view(torch.from_numpy(canv), d).numpy())


# ------------------------------------------------------------------- CLIs

PROGRESS = re.compile(r"^(Epoch: \[\d+\]\[\s*\d+/\d+\])", re.M)
NOTICE = re.compile(r"^=> (?:eval )?device canvas store: .*$", re.M)
SIZE = ["-a", "vit_test", "--img-size", "40", "--crop", "32",
        "--compute-dtype", "float32", "-j", "2", "--seed", "0", "-b", "8",
        "--epochs", "2", "--semi-ratios", "1", "-p", "1"]
MOCO = ["--cos", "--lr", "0.3", "--warmup-epochs", "1", "--moco-dim", "8",
        "--moco-mlp-dim", "16", "--moco-k", "32", "--moco-t", "0.2"]
CLI_CASES = {  # port module, JAX module, flags, store notices
    "finetune": (finetune, jfinetune, ["--lr", "0.1", "--semi-supervised"],
                 3),
    "fuse_ca": (fuse, jfuse, ["--lr", "1e-3", "--fusion-heads", "2"], 3),
    "fuse_gpt": (fuse, jfuse, ["--lr", "1e-3", "--fusion-arch", "gpt",
                               "--gpt-layers", "1"], 3),
    "pretrain": (pretrain, jpretrain, MOCO, 1),
    "pretrain_4ch": (pretrain, jpretrain, MOCO + ["--in-chans", "4"], 1),
}


DATA_DESTS = ("aug_device", "aug_order", "canvas_cache_mb", "canvas_cache",
              "device_store_mb")


@pytest.mark.parametrize("name", ["finetune", "fuse", "pretrain", "infer"])
def test_data_flags_parse_as_jax(name):
    """``--aug-host``, ``--aug-order``, ``--canvas-cache-mb``,
    ``--no-canvas-cache`` and ``--device-store-mb``: each CLI's parser
    gives JAX's values, at the defaults and set."""
    port = {"finetune": finetune, "fuse": fuse, "pretrain": pretrain,
            "infer": infer}[name]
    jmod = {"finetune": jfinetune, "fuse": jfuse, "pretrain": jpretrain,
            "infer": jinfer}[name]
    base = (["--checkpoint", "c", "--manifest", "m"] if name == "infer"
            else [])
    for argv in ([], ["--aug-host", "--aug-order", "crop-first",
                      "--canvas-cache-mb", "7", "--no-canvas-cache",
                      "--device-store-mb", "5"]):
        got = port.build_parser().parse_args(base + argv)
        want = jmod.build_parser().parse_args(base + argv)
        assert ({k: getattr(got, k) for k in DATA_DESTS}
                == {k: getattr(want, k) for k in DATA_DESTS})


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_default_flags_train_from_the_store_as_jax(root, case, capsys):
    """Each training CLI at its default flags (square resize, 40 -> 32):
    the store notices (train, then val and test where it evaluates) and
    the progress lines (epochs x steps) of JAX's store run."""
    port, jmod, extra, n_notices = CLI_CASES[case]
    ds = ["--covid-ds", str(root / "create_covid_dataset")]
    jmod.main(SIZE + extra + ds + ["--attn-backend", "xla",
                                   "--storage-root", str(root / f"j_{case}")])
    jout = capsys.readouterr().out
    (res,) = port.main(SIZE + extra + ds + [
        "--device", "cpu", "--storage-root", str(root / f"p_{case}")])
    out = capsys.readouterr().out
    want = PROGRESS.findall(jout)
    assert len(want) == 4  # 16 images at B=8, 2 epochs
    assert PROGRESS.findall(out) == want
    notices = NOTICE.findall(out)
    assert notices == NOTICE.findall(jout) and len(notices) == n_notices
    assert notices[0] == ("=> device canvas store: 16 samples (0 MB) "
                          "resident in HBM; epochs run host-free")
    losses = res.extra["train_losses"]
    assert len(losses) == 4 and all(np.isfinite(losses))


def test_cli_aug_host_matches_jax_step_plan(root, capsys):
    """``finetune --aug-host``: no store, the host floats; JAX's step plan
    and no store notice, on both sides."""
    ds = ["--covid-ds", str(root / "create_covid_dataset"), "--aug-host",
          "--lr", "0.1"]
    jfinetune.main(SIZE + ds + ["--attn-backend", "xla", "--storage-root",
                                str(root / "j_host")])
    jout = capsys.readouterr().out
    (res,) = finetune.main(SIZE + ds + ["--device", "cpu", "--storage-root",
                                        str(root / "p_host")])
    out = capsys.readouterr().out
    assert PROGRESS.findall(out) == PROGRESS.findall(jout)
    assert not NOTICE.findall(out) and not NOTICE.findall(jout)
    assert len(res.extra["train_losses"]) == 4


def test_eval_store_metrics_equal_the_streaming_eval(root):
    """The same weights evaluated through the eval store and through the
    streaming eval loader: the same logits, AUC and top-1."""
    a, _ = _args(batch_size=3)
    cfg = vit.ViTConfig("vit_test", img_size=32, patch=16, dim=32, depth=2,
                        heads=2)
    model = vit.ViT(cfg, 3, generator=torch.Generator().manual_seed(0))
    model.eval()
    _, eval_step = steps.make_classifier_steps(compute_dtype=torch.float32)
    evaluate = finetune.make_evaluate(eval_step, a, CPU)
    for name in ("val_ds.txt", "test_ds.txt"):
        man = _man(root, name)
        store = common.maybe_eval_device_store(a, man, "data", device=CPU)
        loader = common.make_covid_loader(a, man, "data", training=False)
        got = evaluate(model, store, n_total=len(store.ds))
        want = evaluate(model, loader, n_total=len(loader.ds))
        np.testing.assert_array_equal(got[3], want[3])
        assert got[:3] == want[:3]


def test_infer_aug_host_matches_jax(root, tmp_path):
    """``infer --aug-host`` (host-normalised floats, cast on the device)
    against JAX's, on the same weights."""
    flags = ["-a", "vit_test", "--img-size", "32", "--crop", "32",
             "--maintain-ratio", "--compute-dtype", "float32", "-j", "2",
             "--fusion-heads", "2", "--aug-host", "-b", "3"]
    man = _man(root, "val_ds.txt")
    cfg = jvit.ViTConfig("vit_test", img_size=32, patch=16, dim=32, depth=2,
                         heads=2)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(11), 3)
    tree = {"cxr": jvit.init(k1, cfg, num_classes=3),
            "enh": jvit.init(k2, cfg, num_classes=3),
            "fus": jfusion.init(k3, num_classes=3, dim=32, heads=2)}
    jckpt.save(str(tmp_path / "jax_ckpt"), tree)
    want = jinfer.main(flags + [
        "--attn-backend", "xla", "--checkpoint", str(tmp_path / "jax_ckpt"),
        "--manifest", man, "--output", str(tmp_path / "jax.json")])
    np_tree = jax.tree.map(np.asarray, tree)
    pcfg = vit.ViTConfig("vit_test", img_size=32, patch=16, dim=32, depth=2,
                         heads=2)
    checkpoint.save_serving(
        str(tmp_path / "port.pt"),
        checkpoint.vit_state_from_jax(np_tree["cxr"], pcfg),
        checkpoint.vit_state_from_jax(np_tree["enh"], pcfg),
        checkpoint.fusion_state_from_jax(np_tree["fus"]))
    got = infer.main(flags + [
        "--device", "cpu", "--checkpoint", str(tmp_path / "port.pt"),
        "--manifest", man, "--output", str(tmp_path / "port.json"),
        "--report-throughput"])
    assert got["n"] == want["n"] == 4
    np.testing.assert_allclose(np.asarray(got["logits"]),
                               np.asarray(want["logits"]), atol=1e-4)
    assert got["predictions"] == want["predictions"]
    default = infer.main([f for f in flags if f != "--aug-host"] + [
        "--device", "cpu", "--checkpoint", str(tmp_path / "port.pt"),
        "--manifest", man, "--output", str(tmp_path / "default.json")])
    # the host stack and the device normalisation see the same pixels
    np.testing.assert_allclose(np.asarray(default["logits"]),
                               np.asarray(got["logits"]), atol=1e-4)


# ------------------------------------------------------------ make_splits

def test_make_splits_twin_writes_the_jax_tools_files(tmp_path):
    """The jax-free twin and ``tools/make_splits.py`` on one seeded master
    manifest: the same files, byte for byte."""
    from mfvit_tpu_torch.tools import make_splits
    spec = importlib.util.spec_from_file_location(
        "jax_make_splits", os.path.join(ROOT, "tools", "make_splits.py"))
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    rng = np.random.default_rng(5)
    master = tmp_path / "all.txt"
    names = [f"img_{i}.png" for i in range(60)]
    manifest.write_covid_manifest(str(master), str(tmp_path / "images"),
                                  names, list(rng.integers(0, 3, 60)))
    argv = ["--master", str(master), "--ratios", "0.1", "0.3", "1",
            "--draws", "3", "--val-frac", "0.1", "--test-frac", "0.2",
            "--seed", "4"]
    jtool.main(argv + ["--out", str(tmp_path / "jax")])
    make_splits.main(argv + ["--out", str(tmp_path / "port")])
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port"))
    assert len(files) == 2 + 2 * (3 + 3 + 1)
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "jax", tmp_path / "port", files, shallow=False)
    assert match == files and not mismatch and not errors
