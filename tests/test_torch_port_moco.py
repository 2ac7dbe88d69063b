"""The port's MoCo pretraining slice on the CPU against the JAX package:
``ssl/moco.py``'s step trajectories, the schedules, the two-view training
batches, the ``.pth.tar`` export, the ConvStem and ResNet towers, and the
``pretrain`` CLI (its export read by ``finetune``, its resume).

Tolerances: the trajectories run in fp32 on both sides (the port's plain
versions against JAX with ``attn_backend="xla"``, JAX's weights through
``moco_state_from_jax``), five LARS steps (peak LR 0.01, wd 1e-4) with the
warmup-cosine LR and the cosine momentum ramp: each loss within rtol 1e-5;
parameters, BatchNorm running statistics and the queue within 1e-5 plus
1e-5 of the largest distance the entry moved over the run (sums in another
order err in proportion to the updates; the second term is for the
v2-classic head's biases, which move by about 20 because its L2-normalised
output scales their plain LARS gradients by 1 / ||z||); ``queue_ptr``
exact. The ResNet-18 towers (20 BatchNorms over 8 images of 32 px) take
1e-4 in place of the first 1e-5. Under ``stop_grad_conv1`` the patch
weight, which no gradient reaches, is held to JAX's at rtol 1e-6 after
five steps at LR 1, and to the shrink LARS's formula gives at rtol 2e-5.
The LR schedules agree to 1e-7 (JAX rounds LRs of up to 0.3 to fp32), the
momentum ramp to rtol 1e-12. Batches, the export's keys and values, and a
resumed run (bit for bit against an uninterrupted one) are exact."""
import argparse
import os

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfvit_tpu.cli import common as jcommon
from mfvit_tpu.exp import checkpoint as jckpt
from mfvit_tpu.nn import resnet as jresnet
from mfvit_tpu.nn import vit as jvit
from mfvit_tpu.ssl import moco as jmoco
from mfvit_tpu.train import optim as joptim
from mfvit_tpu_torch.cli import common, finetune, pretrain
from mfvit_tpu_torch.data import manifest
from mfvit_tpu_torch.exp import checkpoint
from mfvit_tpu_torch.nn import resnet, vit
from mfvit_tpu_torch.ssl import moco
from mfvit_tpu_torch.train import optim

TINY = dict(img_size=32, patch=16, dim=32, depth=2, heads=2)
# vit_conv_small's structure (ConvStem, bias-free qkv) at the tiny widths
TINY_CONV = dict(TINY, conv_stem=True, qkv_bias=False)
MOCO = dict(dim=8, mlp_dim=16, K=32, T=0.2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(jcfg):
    """The port's config of a JAX ViT or ResNet config."""
    if isinstance(jcfg, jvit.ViTConfig):
        return vit.ViTConfig(**{f: getattr(jcfg, f) for f in
                                vit.ViTConfig.__dataclass_fields__})
    return resnet.get_config(jcfg.name)


def _port_moco(jstate, jm, jbcfg, in_chans=3):
    pm = moco.MoCoConfig(**{f: getattr(jm, f) for f in
                            moco.MoCoConfig.__dataclass_fields__})
    pb = _cfgs(jbcfg)
    model = moco.MoCo(pm, pb, in_chans=in_chans)
    model.load_state_dict(checkpoint.moco_state_from_jax(_np(jstate), pm, pb),
                          strict=True)
    return model, pm, pb


def _trajectory(jm, jbcfg, *, steps=5, B=8, lr=0.01, wd=1e-4, remat=False,
                seed=0, optimizer="lars", in_chans=3):
    """``steps`` MoCo steps of JAX and of the port from the same state and
    batches of ``in_chans``-channel images; returns (jax state, port
    model, losses (jax, port))."""
    state = jmoco.init(jax.random.PRNGKey(seed), jm, jbcfg, in_chans=in_chans)
    model, pm, pb = _port_moco(state, jm, jbcfg, in_chans)
    model.init_state = {k: v.clone() for k, v in model.state_dict().items()}
    jsched = joptim.pretrain_cosine_lr(lr, 2, 1, 3)
    tx = joptim.build_optimizer(optimizer, jsched, weight_decay=wd,
                                momentum=0.9)
    jstep = jax.jit(jmoco.make_pretrain_step(
        jm, jbcfg, tx, compute_dtype=jnp.float32, remat=remat,
        attn_backend="xla"))
    opt_state = tx.init({"base": state["base"],
                         "predictor": state["predictor"]})
    opt = optim.build_optimizer(optimizer, model.trainable(),
                                optim.pretrain_cosine_lr(lr, 2, 1, 3),
                                weight_decay=wd, momentum=0.9)
    pstep = moco.make_pretrain_step(pm, compute_dtype=torch.float32,
                                    remat=remat)
    rng = np.random.default_rng(seed + 1)
    losses = []
    for i in range(steps):
        q, k = (rng.standard_normal((B, 32, 32, in_chans)).astype(np.float32)
                for _ in range(2))
        m = optim.moco_momentum(i / 3, 0.99, 2)
        state, opt_state, jloss = jstep(state, opt_state, jnp.asarray(q),
                                        jnp.asarray(k), jnp.float32(m))
        ploss = pstep(model, opt, torch.from_numpy(q), torch.from_numpy(k),
                      m)
        losses.append((float(jloss), ploss.item()))
    return state, model, losses, pm, pb


def _hold(state, model, pm, pb, losses, atol=1e-5):
    for jl, pl in losses:
        np.testing.assert_allclose(pl, jl, rtol=1e-5)
    want = checkpoint.moco_state_from_jax(_np(state), pm, pb)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        if k == "queue_ptr" or k.endswith("num_batches_tracked"):
            assert torch.equal(v, want[k]), k
        else:
            moved = (want[k] - model.init_state[k]).abs().max().item()
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       atol=atol + 1e-5 * moved, rtol=0,
                                       err_msg=k)


# (MoCo config, input channels); "4ch" is the stacked CXR-gray + Enh
# input of --in-chans 4 under the default v2 queue loss
LOSS_CASES = {
    "v2_queue": (jmoco.MoCoConfig(**MOCO), 3),
    "v2_queue_noprediction_q": (jmoco.MoCoConfig(predictor_on_keys=False,
                                                 **MOCO), 3),
    "v3_symmetric": (jmoco.MoCoConfig(loss="v3_symmetric", **MOCO), 3),
    "v2_classic": (jmoco.MoCoConfig.v2_classic(dim=8, mlp_dim=16, K=32), 3),
    "4ch": (jmoco.MoCoConfig(**MOCO), 4),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_step_trajectory_matches_jax(case):
    jbcfg = jvit.ViTConfig("vit_test", **TINY)
    jm, in_chans = LOSS_CASES[case]
    state, model, losses, pm, pb = _trajectory(jm, jbcfg, in_chans=in_chans)
    assert model.base.encoder.patch_embed.proj.weight.shape[1] == in_chans
    _hold(state, model, pm, pb, losses)
    if case != "v3_symmetric":
        assert int(model.queue_ptr) == (5 * 8) % 32


def test_stop_grad_conv1_moves_the_patch_weight_as_jax_lars_does():
    """JAX's LARS forms dp = g + wd * p for every 2-D leaf whatever g is,
    so under stop_grad_conv1 (g = 0) the patch weight still shrinks by
    lr * trust * p each step; its bias (1-D, plain gradient 0) stays. The
    port hands the patch projection a zero gradient, not none, to move it
    the same way."""
    jm = jmoco.MoCoConfig(stop_grad_conv1=True, **MOCO)
    jbcfg = jvit.ViTConfig("vit_test", **TINY)
    init = jmoco.init(jax.random.PRNGKey(0), jm, jbcfg)
    w0 = np.asarray(init["base"]["encoder"]["patch"]["w"])
    # the patch weight's path does not depend on the rest of the model:
    # dp = wd * p, scaled to trust * ||p||, so a large LR is safe for it
    state, model, _, pm, pb = _trajectory(jm, jbcfg, lr=1.0)
    jw = np.asarray(state["base"]["encoder"]["patch"]["w"])
    # LR 0, 1/3, 2/3, 1, cos(pi/3); mu_t = sum 0.9^j * 1e-3 * p
    shrink = sum(lr * 1e-3 * sum(0.9 ** j for j in range(t + 1))
                 for t, lr in enumerate((0, 1 / 3, 2 / 3, 1, 0.75)))
    np.testing.assert_allclose(jw / w0, 1 - shrink, rtol=2e-5)
    want = checkpoint.moco_state_from_jax(_np(state), pm, pb)
    got = model.state_dict()
    for k in ("base.encoder.patch_embed.proj.weight",
              "base.encoder.patch_embed.proj.bias"):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-6, err_msg=k)
    assert not got["base.encoder.patch_embed.proj.bias"].any()


def test_last_bn_is_affine_free_and_the_ema_leaves_bn_stats_alone():
    """JAX's test_moco.py :181 and :189 on the port."""
    model = moco.MoCo(moco.MoCoConfig(**MOCO),
                      vit.ViTConfig("vit_test", **TINY))
    last = model.base.projector[-1]
    assert isinstance(last, torch.nn.BatchNorm1d) and not last.affine
    assert [n for n, _ in last.named_parameters()] == []
    with torch.no_grad():
        model.base.projector[1].running_mean += 5.0
        model.base.projector[0].weight.mul_(3.0)
    mean0 = model.momentum.projector[1].running_mean.clone()
    w_m = model.momentum.projector[0].weight.clone()
    w_b = model.base.projector[0].weight.clone()
    model.ema_update(0.5)
    torch.testing.assert_close(model.momentum.projector[0].weight,
                               0.5 * w_m + 0.5 * w_b)
    assert torch.equal(model.momentum.projector[1].running_mean, mean0)


def test_indivisible_batch_raises_and_leaves_the_state():
    model = moco.MoCo(moco.MoCoConfig(**MOCO),
                      vit.ViTConfig("vit_test", **TINY))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = optim.build_optimizer("lars", model.trainable(), 0.1)
    step = moco.make_pretrain_step(model.cfg, compute_dtype=torch.float32)
    imgs = torch.ones(3, 32, 32, 3)  # K=32, 32 % 3 != 0
    with pytest.raises(ValueError, match="divisible"):
        step(model, opt, imgs, imgs, 0.99)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_conv_stem_moco_step_matches_jax():
    jbcfg = jvit.ViTConfig("vit_test", **TINY_CONV)
    state, model, losses, pm, pb = _trajectory(jmoco.MoCoConfig(**MOCO),
                                               jbcfg, steps=3)
    _hold(state, model, pm, pb, losses)


def test_remat_moco_step_matches_jax():
    state, model, losses, pm, pb = _trajectory(
        jmoco.MoCoConfig(**MOCO), jvit.ViTConfig("vit_test", **TINY),
        steps=3, remat=True)
    _hold(state, model, pm, pb, losses)


@pytest.mark.parametrize("remat", [False, True])
def test_resnet18_moco_step_matches_jax(remat):
    """MoCoConfig.resnet towers (2-layer projector, no last BN in the
    predictor) on ResNet-18 at its full widths, 32 px; with remat the
    recompute must not move the BatchNorm statistics a second time."""
    jm = jmoco.MoCoConfig.resnet(dim=8, mlp_dim=16, K=32, T=0.2)
    state, model, losses, pm, pb = _trajectory(
        jm, jresnet.get_config("resnet18"), steps=2, remat=remat)
    _hold(state, model, pm, pb, losses, atol=1e-4)


def test_resnet_arms_load_a_torchvision_file(tmp_path):
    """--pretrained-arms: a torchvision-layout file (seeded weights, an
    fc) into both towers, as ``resnet_arms_from_torchvision`` grafts it."""
    net = resnet.ResNet(resnet.get_config("resnet18"), 10,
                        generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        net.bn1.running_mean.add_(0.5)
    path = str(tmp_path / "resnet18.pth")
    torch.save(net.state_dict(), path)
    jm = jmoco.MoCoConfig.resnet(**MOCO)
    jstate = jckpt.resnet_arms_from_torchvision(
        jmoco.init(jax.random.PRNGKey(0), jm, jresnet.get_config("resnet18")),
        path, jresnet.get_config("resnet18"))
    model, pm, pb = _port_moco(jstate, jm, jresnet.get_config("resnet18"))
    fresh = moco.MoCo(pm, pb)
    checkpoint.load_resnet_arms(fresh, path)
    want = model.state_dict()
    for k, v in fresh.state_dict().items():
        if ".encoder." in k and not k.endswith("num_batches_tracked"):
            assert torch.equal(v, want[k]), k
    torch.save({"conv1.weight": net.conv1.weight}, path)
    with pytest.raises(ValueError, match="torchvision"):
        checkpoint.load_resnet_arms(fresh, path)


def test_schedules_match_jax():
    jsched = joptim.pretrain_cosine_lr(0.3, 5, 2, 7)
    psched = optim.pretrain_cosine_lr(0.3, 5, 2, 7)
    for s in range(0, 40):
        np.testing.assert_allclose(psched(s), float(jsched(s)), rtol=0,
                                   atol=1e-7)
    same = optim.pretrain_cosine_lr(0.3, 2, 2, 4)  # epochs == warmup
    assert all(np.isfinite(same(s)) for s in range(12))
    for e in np.linspace(0, 5, 23):
        np.testing.assert_allclose(optim.moco_momentum(e, 0.99, 5),
                                   joptim.moco_momentum(e, 0.99, 5),
                                   rtol=1e-12)


def test_export_matches_jax_key_for_key(tmp_path):
    jm = jmoco.MoCoConfig(**MOCO)
    jbcfg = jvit.ViTConfig("vit_test", **TINY)
    jstate = jmoco.init(jax.random.PRNGKey(4), jm, jbcfg)
    jstate["queue_ptr"] = jnp.asarray(16, jnp.int32)
    model, _, pcfg = _port_moco(jstate, jm, jbcfg)
    want_path, got_path = str(tmp_path / "jax.pth.tar"), str(
        tmp_path / "port.pth.tar")
    jckpt.save_moco_torch_checkpoint(want_path, _np(jstate), jbcfg, epoch=3,
                                     arch="vit_test")
    checkpoint.save_moco_torch_checkpoint(got_path, model, epoch=3,
                                          arch="vit_test")
    want = torch.load(want_path, weights_only=False)
    got = torch.load(got_path, weights_only=False)
    assert (got["epoch"], got["arch"]) == (want["epoch"], want["arch"])
    assert set(got["state_dict"]) == set(want["state_dict"])
    for k, v in want["state_dict"].items():
        g = got["state_dict"][k]
        assert g.dtype == v.dtype and g.shape == v.shape, k
        np.testing.assert_array_equal(g.numpy(), v.numpy(), err_msg=k)
    back = checkpoint.load_moco_pretrained_backbone(got_path, pcfg)
    for k, v in back.items():
        assert torch.equal(v, model.base.encoder.state_dict()[k]), k


# ------------------------------------------------------------- data, CLI

@pytest.fixture(scope="module")
def covid_root(tmp_path_factory):
    """24 synthetic images, non-square (64 x 72) so that resize_square and
    resize_shorter differ: all in the ratio-1 train manifest."""
    root = tmp_path_factory.mktemp("covid_moco")
    data_root, man_root = root / "images", root / "create_covid_dataset"
    os.makedirs(man_root)
    os.makedirs(data_root / "data")
    rng = np.random.default_rng(0)
    names = [f"img_{i}.png" for i in range(24)]
    for fn in names:
        cv2.imwrite(str(data_root / "data" / fn),
                    rng.integers(0, 255, (64, 72, 3), np.uint8))
    labels = [i % 3 for i in range(24)]
    for fname, sl in (("1_labeled_train_0.txt", slice(0, 24)),
                      ("val_ds.txt", slice(0, 8)),
                      ("test_ds.txt", slice(8, 16))):
        manifest.write_covid_manifest(str(man_root / fname), str(data_root),
                                      names[sl], labels[sl])
    return root


@pytest.mark.parametrize("maintain_ratio", [False, True])
def test_two_view_batches_match_jax(covid_root, maintain_ratio):
    """Epochs 0 and 1 of the two-view feed, bit for bit, at the CLI
    default square resize and at --maintain-ratio, and the views
    normalised as JAX's streaming feed does."""
    man = str(covid_root / "create_covid_dataset" / "1_labeled_train_0.txt")
    a = argparse.Namespace(img_size=40, crop=32, maintain_ratio=maintain_ratio,
                           batch_size=8, workers=2, rotate=10.0,
                           compute_dtype="float32")
    ja = argparse.Namespace(**vars(a), aug_device=True, canvas_cache=False,
                            canvas_cache_mb=0)
    jl = jcommon.make_covid_loader(ja, man, "data", training=True,
                                   ssl_two_views=True, seed=1)
    pl = common.make_covid_loader(a, man, "data", training=True,
                                  ssl_two_views=True, seed=1)
    assert len(jl) == len(pl) == 3
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        jb, pb = list(jl), list(pl)
        assert len(jb) == len(pb) == 3
        for j, p in zip(jb, pb):
            assert len(j) == len(p) == 3
            for x, y in zip(j, p):
                np.testing.assert_array_equal(x, y)
        assert not np.array_equal(pb[0][0], pb[0][1])  # two views
    jq, jk = jcommon.stream_train_two_views(
        ja, jax.random.PRNGKey(0), jnp.asarray(pb[0][0]),
        jnp.asarray(pb[0][1]), "data")
    q, k = common.stream_train_two_views(a, torch.from_numpy(pb[0][0]),
                                         torch.from_numpy(pb[0][1]), "data")
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), rtol=1e-6,
                               atol=1e-6)


FLAGS = ["-a", "vit_test", "--img-size", "32", "--crop", "32",
         "--compute-dtype", "float32", "-j", "2", "--seed", "0", "-b", "8",
         "--cos", "--lr", "0.3", "--warmup-epochs", "1", "--moco-dim", "8",
         "--moco-mlp-dim", "16", "--moco-k", "32", "--moco-t", "0.2",
         "--moco-m-cos", "--stop-grad-conv1", "--semi-ratios", "1", "-p",
         "1", "--device", "cpu"]


def _run(covid_root, tag, extra):
    root = covid_root / tag
    (res,) = pretrain.main(FLAGS + ["--covid-ds", str(
        covid_root / "create_covid_dataset"), "--storage-root", str(root)]
        + extra)
    return res, next(root.iterdir()) / "train_1_0"


def test_pretrain_cli_exports_what_finetune_loads(covid_root):
    res, sub = _run(covid_root, "cli", ["--epochs", "2", "--export-torch",
                                        "--save-epoch", "1"])
    assert len(res.extra["train_losses"]) == 6  # 24 images at B=8, 2 epochs
    assert all(np.isfinite(res.extra["train_losses"]))
    for name in ("checkpoint_best_loss", "checkpoint_0000",
                 "checkpoint_0001", "checkpoint_torch.pth.tar"):
        assert (sub / name).exists(), name
    ck = torch.load(sub / "checkpoint_0001", weights_only=True)
    assert ck["epoch"] == 1 and int(ck["state"]["queue_ptr"]) == 48 % 32
    (ft,) = finetune.main(
        ["-a", "vit_test", "--img-size", "32", "--crop", "32",
         "--compute-dtype", "float32", "-j", "2", "-b", "8", "--epochs",
         "1", "--semi-ratios", "1", "--device", "cpu", "--covid-ds",
         str(covid_root / "create_covid_dataset"), "--storage-root",
         str(covid_root / "ft"), "--pretrained",
         str(sub / "checkpoint_torch.pth.tar")])
    assert np.isfinite(ft.extra["final_train_loss"])


def test_pretrain_resume_is_bit_exact(covid_root):
    _, straight = _run(covid_root, "straight", ["--epochs", "2"])
    _, first = _run(covid_root, "first", ["--epochs", "2", "--save-epoch",
                                          "1"])
    # the first run's epoch-0 checkpoint, then the second epoch
    _, second = _run(covid_root, "second", [
        "--epochs", "2", "--resume", str(first / "checkpoint_0000")])
    want = torch.load(straight / "checkpoint_0001", weights_only=True)
    got = torch.load(second / "checkpoint_0001", weights_only=True)
    assert got["epoch"] == want["epoch"] == 1
    for k, v in want["state"].items():
        assert torch.equal(got["state"][k], v), k
    assert got["opt_state"]["count"] == want["opt_state"]["count"] == 6


def test_finetune_takes_a_conv_stem_arch(covid_root):
    """vit_conv_small at its full widths through ``finetune`` (FT, one
    epoch at 32 px): the stem's BatchNorms on their running statistics, the
    bias-free qkv given zero biases by the block ops."""
    (res,) = finetune.main(
        ["-a", "vit_conv_small", "--img-size", "32", "--crop", "32",
         "--compute-dtype", "float32", "-j", "2", "-b", "8", "--epochs",
         "1", "--semi-ratios", "1", "--semi-supervised", "--device", "cpu",
         "--lr", "0.01", "--covid-ds", str(covid_root /
                                            "create_covid_dataset"),
         "--storage-root", str(covid_root / "ft_conv")])
    assert len(res.extra["train_losses"]) == 3
    assert all(np.isfinite(res.extra["train_losses"]))


def test_pretrain_refuses_what_is_not_ported(covid_root, tmp_path):
    for extra, msg in ((["--distributed"], "item 6"),
                       (["--resume", str(tmp_path)], "orbax"),
                       (["-a", "vit_conv_small", "--export-torch"],
                        "export-torch")):
        with pytest.raises(SystemExit, match=msg):
            _run(covid_root, "refused", ["--epochs", "1"] + extra)


def test_pretrain_cuda_request_without_cuda_raises(covid_root):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pretrain.main(FLAGS[:-2] + ["--covid-ds", str(covid_root)])
