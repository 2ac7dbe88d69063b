"""The port's fusion-training slice (``cli/fuse``) on the CPU against the
JAX package: the fp32 train-step trajectories (also with ``--remat``), the
paired training batches, ``load_branch``, the ``fuse`` CLI and ``infer`` on
its ``model_best``.

Tolerances: the trajectories run in fp32 on both sides (the port's plain
versions against JAX with ``attn_backend="xla"``), so losses agree to
rtol 1e-5 and parameters to atol 1e-5 after 6 Adam steps (sums in
another order), but for the key slice of each qkv bias: its gradient is
zero up to rounding, which Adam's normalisation turns into steps of
either sign; after LP the branch parameters are unchanged bit for bit.
Batches, loaded checkpoints and the CLI's step plan are exact; ``infer``
on ``model_best`` gives the eval step's logits on the same file to rtol
1e-6 (fp32)."""
import argparse
import json
import os
import re

import cv2
import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from mfvit_tpu.cli import common as jcommon
from mfvit_tpu.cli import fuse as jfuse
from mfvit_tpu.exp import checkpoint as jckpt
from mfvit_tpu.models import fusion as jfusion
from mfvit_tpu.nn import vit as jvit
from mfvit_tpu.train import optim as joptim
from mfvit_tpu.train import steps as jsteps
from mfvit_tpu_torch.cli import common, fuse, infer
from mfvit_tpu_torch.data import manifest
from mfvit_tpu_torch.exp import checkpoint
from mfvit_tpu_torch.models import fusion
from mfvit_tpu_torch.nn import vit
from mfvit_tpu_torch.train import optim, steps

TINY = dict(img_size=32, patch=16, dim=32, depth=2, heads=2)
FHEADS = 2


@pytest.fixture(scope="module")
def covid_root(tmp_path_factory):
    """24 image pairs over 3 classes, the 'data' and 'Train_Mix' images of
    a pair different: 16 train, 4 val, 4 test."""
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


def _jax_params(seed):
    cfg = jvit.ViTConfig("vit_test", **TINY)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    return cfg, {"cxr": jvit.init(k1, cfg, num_classes=3),
                 "enh": jvit.init(k2, cfg, num_classes=3),
                 "fus": jfusion.init(k3, num_classes=3, dim=cfg.dim,
                                     heads=FHEADS)}


def _port_models(tree, pcfg):
    tree = jax.tree.map(np.asarray, tree)
    models = nn.ModuleDict({"cxr": vit.ViT(pcfg, 3), "enh": vit.ViT(pcfg, 3),
                            "fus": fusion.Fusion(3, pcfg.dim, FHEADS)})
    for b in ("cxr", "enh"):
        models[b].load_state_dict(checkpoint.vit_state_from_jax(tree[b], pcfg),
                                  strict=True)
    models["fus"].load_state_dict(checkpoint.fusion_state_from_jax(
        tree["fus"]), strict=True)
    return models


@pytest.mark.parametrize("semi,remat", [
    pytest.param(False, False, id="False"),
    pytest.param(True, False, id="True"),
    pytest.param(True, True, id="True-remat")])
def test_fusion_step_trajectory_matches_jax(semi, remat, monkeypatch):
    """LP, --semi-supervised, and --semi-supervised with --remat (the
    branches' blocks recomputed in the backward, on both sides)."""
    rematted = []
    checkpoint_fn = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda *a, **k: rematted.append(1)
                        or checkpoint_fn(*a, **k))
    cfg, params = _jax_params(3)
    pcfg = vit.ViTConfig("vit_test", **TINY)
    models = _port_models(params, pcfg)
    before = {k: v.clone() for k, v in models.state_dict().items()}
    jmask = None if semi else jfuse.fusion_trainable_mask(params)
    tx = joptim.build_optimizer(
        "adam", joptim.finetune_lr(1e-3, 2, cos=True, steps_per_epoch=3),
        trainable_mask=jmask)
    jstep, _ = jsteps.make_fusion_steps(
        cfg, tx, heads=FHEADS, compute_dtype=jnp.float32, attn_backend="xla",
        freeze_backbones=not semi, remat=remat)
    state = tx.init(params)
    mask = None if semi else fuse.fusion_trainable_mask(
        models.named_parameters())
    opt = optim.build_optimizer(
        "adam", models.named_parameters(),
        optim.finetune_lr(1e-3, 2, cos=True, steps_per_epoch=3),
        trainable_mask=mask)
    step, _ = steps.make_fusion_steps(compute_dtype=torch.float32,
                                      freeze_backbones=not semi, remat=remat)
    rng = np.random.default_rng(4)
    for _ in range(6):
        xc, xe = (rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
                  for _ in range(2))
        labels = rng.integers(0, 3, 4)
        params, state, jloss, jout = jstep(params, state, jnp.asarray(xc),
                                           jnp.asarray(xe),
                                           jnp.asarray(labels))
        loss, out = step(models, opt, torch.from_numpy(xc),
                         torch.from_numpy(xe), torch.from_numpy(labels))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                                   atol=1e-5)
    want = _port_models(params, pcfg).state_dict()
    for k, v in models.state_dict().items():
        if not semi and not k.startswith("fus."):
            assert torch.equal(v, before[k]), k
        v, w = v.numpy(), want[k].numpy()
        if k.endswith("attn.qkv.bias"):
            # the key bias has a zero gradient (the softmax ignores it), so
            # Adam steps on the rounding noise of both sides: skip it
            d = pcfg.dim
            v, w = np.delete(v, np.s_[d:2 * d]), np.delete(w, np.s_[d:2 * d])
        np.testing.assert_allclose(v, w, atol=1e-5, err_msg=k)
    assert bool(rematted) == remat
    moved = [k for k, v in models.state_dict().items()
             if not torch.equal(v, before[k])]
    assert any(k.startswith("fus.") for k in moved)
    assert any(k.startswith("cxr.blocks.") for k in moved) == semi


def _loader_args():
    return argparse.Namespace(img_size=32, crop=32, maintain_ratio=True,
                              batch_size=4, workers=2, rotate=10.0,
                              compute_dtype="float32")


def test_paired_training_batches_match_jax(covid_root):
    """Epochs 0 and 1 of the paired training feed: the same shuffle, and
    per branch the same flips, rotations and crops, bit for bit."""
    man = str(covid_root / "create_covid_dataset" / "1_labeled_train_0.txt")
    a = _loader_args()
    ja = argparse.Namespace(**vars(a), aug_device=True, canvas_cache=False,
                            canvas_cache_mb=0)
    jl = jcommon.make_covid_loader(ja, man, "data", training=True,
                                   paired=True, seed=2)
    pl = common.make_paired_loader(a, man, training=True, seed=2)
    assert len(jl) == len(pl) == 4
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        jb, pb = list(jl), list(pl)
        assert len(jb) == len(pb) == 4
        for j, p in zip(jb, pb):
            assert len(p) == 3
            for x, y in zip(j, p):
                np.testing.assert_array_equal(x, y)
    # the branches draw their augmentations independently
    assert not np.array_equal(pb[0][0], pb[0][1])


def test_load_branch_matches_jax(tmp_path):
    cfg = jvit.ViTConfig("vit_test", **TINY)
    pcfg = vit.ViTConfig("vit_test", **TINY)
    jp = jvit.init(jax.random.PRNGKey(5), cfg, num_classes=3)
    sd = jckpt.params_to_torch_vit(jp, cfg)
    torch.save({"state_dict": {f"module.{k}": torch.from_numpy(np.array(v))
                               for k, v in sd.items()}},
               tmp_path / "cxr_1_0.pth.tar")
    path = str(tmp_path / "cxr_{ratio}_{draw}.pth.tar")
    want = checkpoint.vit_state_from_jax(
        jax.tree.map(np.asarray, jfuse.load_branch(path, cfg, 1, 0)), pcfg)
    got = fuse.load_branch(path, pcfg, 1, 0)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    vit.ViT(pcfg, 3).load_state_dict(got, strict=True)
    assert fuse.load_branch("", pcfg, 1, 0) is None
    with pytest.raises(SystemExit, match="orbax"):
        fuse.load_branch(str(tmp_path), pcfg, 1, 0)


PROGRESS = re.compile(r"^(Epoch: \[\d+\]\[\s*\d+/\d+\])", re.M)
FLAGS = ["-a", "vit_test", "--img-size", "32", "--crop", "32",
         "--maintain-ratio", "--compute-dtype", "float32", "-j", "2",
         "--seed", "0", "-b", "8", "--epochs", "2", "--cos", "--lr", "1e-3",
         "--semi-ratios", "1", "-p", "1", "--fusion-heads", str(FHEADS)]


def test_fuse_cli_matches_jax_step_plan_and_infer_serves_it(covid_root,
                                                            capsys):
    """LP and --semi-supervised through the port's CLI on the CPU, the
    branches from the port's own ViT files: the same progress lines
    (epochs x steps) as the JAX CLI at --device-store-mb 0, model_best
    written, the sanity-check line under LP only; then ``infer`` serves
    that model_best as it is."""
    ds = str(covid_root / "create_covid_dataset")
    jfuse.main(FLAGS + ["--attn-backend", "xla", "--device-store-mb", "0",
                        "--covid-ds", ds, "--storage-root",
                        str(covid_root / "jax_fuse")])
    want = PROGRESS.findall(capsys.readouterr().out)
    assert len(want) == 4  # 16 pairs at B=8, 2 epochs
    pcfg = vit.ViTConfig("vit_test", **TINY)
    branches = []
    for b, seed in (("cxr", 1), ("enh", 2)):
        m = vit.ViT(pcfg, 3, generator=torch.Generator().manual_seed(seed))
        path = covid_root / f"{b}_model_best"  # a finetune model_best
        torch.save(m.state_dict(), path)
        branches += [f"--pretrained-{b}", str(path)]
    for mode in ("lp", "semi"):
        root = covid_root / f"port_{mode}"
        extra = ["--semi-supervised"] if mode == "semi" else []
        (res,) = fuse.main(FLAGS + extra + branches + [
            "--covid-ds", ds, "--storage-root", str(root), "--device",
            "cpu", "--device-store-mb", "0"])
        out = capsys.readouterr().out
        assert PROGRESS.findall(out) == want
        assert len(res.extra["train_losses"]) == 4
        assert all(np.isfinite(res.extra["train_losses"]))
        assert np.isfinite(res.test_auc) and 0 <= res.test_acc <= 1
        exp = next(root.iterdir())
        assert "mfvit_ca" in exp.name
        best = exp / "train_1_0" / "model_best"
        assert best.exists()
        assert ("=> fusion sanity check passed." in out) == (mode == "lp")

    # infer serves the last run's model_best with no conversion step
    man = str(covid_root / "create_covid_dataset" / "val_ds.txt")
    pred = str(covid_root / "pred.json")
    got = infer.main(["-a", "vit_test", "--img-size", "32", "--crop", "32",
                      "--maintain-ratio", "--compute-dtype", "float32",
                      "--fusion-heads", str(FHEADS), "-b", "4", "-j", "2",
                      "--device", "cpu", "--checkpoint", str(best),
                      "--manifest", man, "--output", pred])
    ck = checkpoint.load_serving(str(best), pcfg)
    models = nn.ModuleDict({"cxr": vit.ViT(pcfg, 3), "enh": vit.ViT(pcfg, 3),
                            "fus": fusion.Fusion(3, pcfg.dim, FHEADS)})
    for k, m in models.items():
        m.load_state_dict(ck[k], strict=True)
    _, eval_step = steps.make_fusion_steps(compute_dtype=torch.float32)
    args = infer.build_parser().parse_args(
        ["--checkpoint", str(best), "--manifest", man, "-a", "vit_test",
         "--img-size", "32", "--crop", "32", "--maintain-ratio", "-b", "4",
         "-j", "2", "--compute-dtype", "float32"])
    batch = next(iter(common.make_paired_loader(args, man)))
    xs = infer.prepare(batch, torch.device("cpu"), torch.float32)
    np.testing.assert_allclose(np.asarray(got["logits"]),
                               eval_step(models, *xs).numpy(), rtol=1e-6,
                               atol=1e-6)
    assert json.load(open(pred))["n"] == 4


def test_fuse_refuses_resume_and_cuda_without_cuda(covid_root):
    ds = str(covid_root / "create_covid_dataset")
    with pytest.raises(SystemExit, match="--resume is not implemented"):
        fuse.main(FLAGS + ["--resume", "x", "--covid-ds", ds])
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fuse.main(FLAGS + ["--covid-ds", ds])
