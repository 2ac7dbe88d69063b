"""The port's fine-tuning slice on the CPU against the JAX package: the fp32
train-step trajectory, the training batches, the MoCo ``.pth.tar``
surgery and the ``finetune`` CLI.

Tolerances: the trajectory runs in fp32 on both sides (the port's plain
versions against JAX with ``attn_backend="xla"``), so losses agree to
rtol 1e-5 and parameters to atol 1e-5 after 10 SGD steps (sums in another
order). Batches, checkpoints and the CLI's step plan are exact."""
import argparse
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
from mfvit_tpu.exp import checkpoint as jckpt
from mfvit_tpu.nn import vit as jvit
from mfvit_tpu.ssl import moco as jmoco
from mfvit_tpu.train import optim as joptim
from mfvit_tpu.train import steps as jsteps
from mfvit_tpu_torch.cli import common, finetune
from mfvit_tpu_torch.data import manifest
from mfvit_tpu_torch.exp import checkpoint
from mfvit_tpu_torch.nn import vit
from mfvit_tpu_torch.train import optim, steps

TINY = dict(img_size=32, patch=16, dim=32, depth=2, heads=2)


@pytest.fixture(scope="module")
def covid_root(tmp_path_factory):
    """tests/test_cli.py's synthetic dataset: 24 images over 3 classes; 16
    train, 4 val, 4 test."""
    root = tmp_path_factory.mktemp("covid")
    data_root, man_root = root / "images", root / "create_covid_dataset"
    os.makedirs(man_root)
    rng = np.random.default_rng(0)
    for folder in ("data", "Train_Mix"):
        os.makedirs(data_root / folder)
    names, labels = [], []
    for i in range(24):
        fn, label = f"img_{i}.png", i % 3
        for folder in ("data", "Train_Mix"):
            img = rng.integers(0, 255, (64, 72, 3), np.uint8)
            img[:, :, 0] = np.clip(img[:, :, 0] * 0.2 + label * 80, 0, 255)
            cv2.imwrite(str(data_root / folder / fn), img)
        names.append(fn)
        labels.append(label)
    for fname, sl in (("1_labeled_train_0.txt", slice(0, 16)),
                      ("val_ds.txt", slice(16, 20)),
                      ("test_ds.txt", slice(20, 24))):
        manifest.write_covid_manifest(str(man_root / fname), str(data_root),
                                      names[sl], labels[sl])
    return root


def test_classifier_step_trajectory_matches_jax():
    cfg = jvit.ViTConfig("vit_test", **TINY)
    pcfg = vit.ViTConfig("vit_test", **TINY)
    tree = jax.tree.map(np.asarray,
                        jvit.init(jax.random.PRNGKey(3), cfg, num_classes=3))
    model = vit.ViT(pcfg, 3)
    model.load_state_dict(checkpoint.vit_state_from_jax(tree, pcfg),
                          strict=True)
    jsched = joptim.finetune_lr(0.05, 2, cos=True, steps_per_epoch=5)
    tx = joptim.build_optimizer("sgd", jsched, weight_decay=1e-4,
                                momentum=0.9)
    jstep, _ = jsteps.make_classifier_steps(cfg, tx,
                                            compute_dtype=jnp.float32,
                                            attn_backend="xla")
    params = jax.tree.map(jnp.asarray, tree)
    state = tx.init(params)
    opt = optim.build_optimizer(
        "sgd", model.named_parameters(),
        optim.finetune_lr(0.05, 2, cos=True, steps_per_epoch=5),
        weight_decay=1e-4, momentum=0.9)
    step, _ = steps.make_classifier_steps(compute_dtype=torch.float32)
    rng = np.random.default_rng(4)
    for _ in range(10):
        imgs = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
        labels = rng.integers(0, 3, 4)
        params, state, jloss, _ = jstep(params, state, jnp.asarray(imgs),
                                        jnp.asarray(labels))
        loss, _ = step(model, opt, torch.from_numpy(imgs),
                       torch.from_numpy(labels))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = checkpoint.vit_state_from_jax(jax.tree.map(np.asarray, params),
                                         pcfg)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5,
                                   err_msg=k)


def _loader_args():
    return argparse.Namespace(img_size=32, crop=32, maintain_ratio=True,
                              batch_size=4, workers=2, rotate=10.0,
                              compute_dtype="float32")


def test_training_batches_match_jax(covid_root):
    """Epochs 0 and 1 of the training feed: the same shuffle, flips,
    rotations and crops, bit for bit, and the same normalised views."""
    man = str(covid_root / "create_covid_dataset" / "1_labeled_train_0.txt")
    a = _loader_args()
    ja = argparse.Namespace(**vars(a), aug_device=True, canvas_cache=False,
                            canvas_cache_mb=0)
    jl = jcommon.make_covid_loader(ja, man, "data", training=True, seed=1)
    pl = common.make_covid_loader(a, man, "data", training=True, seed=1)
    assert len(jl) == len(pl) == 4
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        jb, pb = list(jl), list(pl)
        assert len(jb) == len(pb) == 4
        for j, p in zip(jb, pb):
            for x, y in zip(j, p):
                np.testing.assert_array_equal(x, y)
    want = jcommon.stream_train_view(ja, jax.random.PRNGKey(0),
                                     jnp.asarray(pb[0][0]), "data")
    got = common.stream_train_view(a, torch.from_numpy(pb[0][0]), "data")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_moco_backbone_matches_jax_surgery(tmp_path):
    cfg = jvit.ViTConfig("tiny", img_size=32, patch=8, dim=32, depth=2,
                         heads=2)
    pcfg = vit.ViTConfig("tiny", img_size=32, patch=8, dim=32, depth=2,
                         heads=2)
    mcfg = jmoco.MoCoConfig(dim=8, mlp_dim=16, K=32, T=0.2,
                            stop_grad_conv1=False)
    path = str(tmp_path / "moco.pth.tar")
    jckpt.save_moco_torch_checkpoint(
        path, jmoco.init(jax.random.PRNGKey(2), mcfg, cfg), cfg)
    want = checkpoint.vit_state_from_jax(
        jax.tree.map(np.asarray, jckpt.load_moco_pretrained_backbone(
            path, cfg)), pcfg)
    got = checkpoint.load_moco_pretrained_backbone(path, pcfg)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    missing, unexpected = vit.ViT(pcfg, 3).load_state_dict(got, strict=False)
    assert set(missing) == {"head.weight", "head.bias"} and not unexpected


PROGRESS = re.compile(r"^(Epoch: \[\d+\]\[\s*\d+/\d+\])", re.M)
FLAGS = ["-a", "vit_test", "--img-size", "32", "--crop", "32",
         "--maintain-ratio", "--compute-dtype", "float32", "-j", "2",
         "--seed", "0", "-b", "8", "--epochs", "2", "--cos", "--lr", "0.1",
         "--semi-ratios", "1", "-p", "1"]


def test_finetune_cli_matches_jax_step_plan(covid_root, capsys):
    """FT and LP through the port's CLI on the CPU: the same progress
    lines (epochs x steps) as the JAX CLI at --device-store-mb 0, the
    checkpoints written, and the LP frozen-backbone check."""
    ds = str(covid_root / "create_covid_dataset")
    jfinetune.main(FLAGS + ["--attn-backend", "xla", "--device-store-mb",
                            "0", "--covid-ds", ds, "--storage-root",
                            str(covid_root / "jax_lp")])
    want = PROGRESS.findall(capsys.readouterr().out)
    assert len(want) == 4  # 16 images at B=8, 2 epochs
    for mode in ("lp", "ft"):
        root = covid_root / f"port_{mode}"
        extra = ["--semi-supervised"] if mode == "ft" else []
        (res,) = finetune.main(FLAGS + extra + [
            "--covid-ds", ds, "--storage-root", str(root), "--device",
            "cpu", "--device-store-mb", "0"])
        out = capsys.readouterr().out
        assert PROGRESS.findall(out) == want
        assert len(res.extra["train_losses"]) == 4
        assert all(np.isfinite(res.extra["train_losses"]))
        assert np.isfinite(res.test_auc) and 0 <= res.test_acc <= 1
        exp = next(root.iterdir())
        assert (exp / "train_1_0" / "model_best").exists()
        assert (exp / "train_1_0_acc" / "model_best").exists()
        assert (exp / "results.json").exists()
        assert ("=> sanity check passed." in out) == (mode == "lp")


def test_finetune_cuda_request_without_cuda_raises(covid_root):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        finetune.main(FLAGS + ["--covid-ds", str(covid_root)])
