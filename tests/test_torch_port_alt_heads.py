"""The port's alternative fusion heads on the CPU against the JAX package:
the joint-sequence GPT head (``models/gpt_fusion``), the ViT + CNN
cross-attention head (``models/crossvit_cnn``), the GPT fusion train step,
and ``fuse``/``infer --fusion-arch gpt``.

Every tree is built by the JAX package's ``init`` and carried across by
the new weight bridges, after noise (numpy seed) on every leaf of the
heads and on the branch biases, so that no zero ``pos_emb``, bias or unit
LayerNorm hides a wrong mapping.

Tolerances: ``gpt_apply`` in fp32 at rtol 1e-4, atol 1e-5 (the bar of
``tests/test_alt_fusion.py``'s reference test) and in bf16 at a relative
Frobenius error of 1e-2; the heads' fp32 logits at rtol 1e-5, atol 1e-6
(the ResNet's convolutions in ``fused_forward`` at rtol 1e-4, atol 1e-5);
the train-step trajectories at the bars of
``test_torch_port_fuse.py::test_fusion_step_trajectory_matches_jax``
(under SGD: see the test);
``infer`` on ``model_best`` equal to the eval step to rtol 1e-6 (fp32).
"""
import dataclasses
import os

import cv2
import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from mfvit_tpu.cli import fuse as jfuse
from mfvit_tpu.models import crossvit_cnn as jcv
from mfvit_tpu.models import gpt_fusion as jgpt
from mfvit_tpu.nn import resnet as jresnet
from mfvit_tpu.nn import vit as jvit
from mfvit_tpu.train import optim as joptim
from mfvit_tpu.train import steps as jsteps
from mfvit_tpu_torch.cli import common, fuse, infer
from mfvit_tpu_torch.data import manifest
from mfvit_tpu_torch.exp import checkpoint
from mfvit_tpu_torch.models import crossvit_cnn, gpt_fusion
from mfvit_tpu_torch.nn import resnet, vit
from mfvit_tpu_torch.train import optim, steps

TINY = dict(img_size=32, patch=16, dim=32, depth=2, heads=2)


def _noisy(tree, seed, only_biases=False, std=0.05):
    """numpy copies of ``tree``'s leaves with N(0, std) added (to the
    Linear biases "b" alone with ``only_biases``)."""
    rng = np.random.default_rng(seed)

    def f(path, x):
        x = np.array(x, np.float32)
        if only_biases and getattr(path[-1], "key", None) != "b":
            return x
        return x + rng.normal(0, std, x.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, tree)


def _gpt_pair(jcfg, seed, num_classes=3, std=0.05):
    """A JAX GPT tree (noisy) and the port's head loaded from it."""
    tree = _noisy(jgpt.init(jax.random.PRNGKey(seed), jcfg, num_classes),
                  seed, std=std)
    model = gpt_fusion.GPTFusion(
        gpt_fusion.GPTFusionConfig(**dataclasses.asdict(jcfg)), num_classes)
    model.load_state_dict(checkpoint.gpt_fusion_state_from_jax(tree),
                          strict=True)
    return tree, model


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _fro(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_init_matches_jax_names_shapes_and_rule():
    """The default heads: the state dict under JAX's tree mapped by the
    bridges (the reference GPT's names), the init rule of JAX's ``init``."""
    jt = jgpt.init(jax.random.PRNGKey(0), jgpt.VIT_CONFIG)
    want = checkpoint.gpt_fusion_state_from_jax(jax.tree.map(np.asarray, jt))
    m = gpt_fusion.GPTFusion(generator=torch.Generator().manual_seed(1))
    sd = m.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert "blocks.7.attn.query.weight" in sd and "blocks.7.mlp.2.bias" in sd
    assert sd["pos_emb"].shape == (1, 394, 384) and not sd["pos_emb"].any()
    w = torch.cat([sd[k].flatten() for k in sd
                   if k.endswith("weight") and "ln" not in k])
    assert abs(w.std().item() - 0.02) < 1e-3
    assert all(not sd[k].any() for k in sd
               if k.endswith("bias") and "ln" not in k)
    assert all(torch.equal(sd[k], torch.ones_like(sd[k])) for k in sd
               if "ln" in k and k.endswith("weight"))

    jt = jcv.init(jax.random.PRNGKey(0), cross_attn_depth=2)
    want = checkpoint.crossvit_cnn_state_from_jax(
        jax.tree.map(np.asarray, jt))
    m = crossvit_cnn.CrossViTCNN(cross_attn_depth=2)
    assert {k: tuple(v.shape) for k, v in m.state_dict().items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert "encoders.0.layers.1.to_qkv.bias" not in want


def test_reference_configs_joint_len():
    assert gpt_fusion.VIT_CONFIG.joint_len == 394 == jgpt.VIT_CONFIG.joint_len
    assert gpt_fusion.RES18_CONFIG.joint_len == 98
    assert gpt_fusion.RES18_CONFIG.n_embd == 512
    assert (dataclasses.asdict(gpt_fusion.RES18_CONFIG)
            == dataclasses.asdict(jgpt.RES18_CONFIG))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpt_apply_matches_jax(dtype):
    jcfg = jgpt.GPTFusionConfig(n_embd=32, n_head=2, n_layer=2,
                                vert_anchors=4, horz_anchors=4)
    # weights of 0.2, so that the softmax is far from uniform
    tree, model = _gpt_pair(jcfg, 11, std=0.2)
    joint = np.random.default_rng(12).normal(
        size=(2, jcfg.joint_len, 32)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jgpt.gpt_apply(_j(tree), jnp.asarray(joint, jd), jcfg)
                      .astype(jnp.float32))
    with torch.no_grad():
        got = gpt_fusion.gpt_apply(model, torch.from_numpy(joint).to(td))
    assert got.dtype == td
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    else:
        assert _fro(got.float(), want) <= 1e-2


@pytest.mark.parametrize("arch", ["vit", "res"])
def test_gpt_fusion_logits_match_jax(arch):
    """``apply`` on token streams (ViT: anchors^2 + 1 tokens each) and on
    feature maps (ResNet: 4 x 4 maps pooled onto 2 x 2 anchors)."""
    jcfg = jgpt.GPTFusionConfig(arch=arch, n_embd=32, n_head=4, n_layer=2,
                                vert_anchors=2, horz_anchors=2)
    tree, model = _gpt_pair(jcfg, 13)
    rng = np.random.default_rng(14)
    shape = (3, 5, 32) if arch == "vit" else (3, 4, 4, 32)
    cxr, enh = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    want = np.asarray(jgpt.apply(_j(tree), jnp.asarray(cxr), jnp.asarray(enh),
                                 jcfg))
    with torch.no_grad():
        got = model(torch.from_numpy(cxr), torch.from_numpy(enh))
    assert got.dtype == torch.float32 and got.shape == (3, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


CV = dict(small_dim=32, large_dim=64, heads=2, dim_head=8)


def _crossvit_pair(seed, depth=1, **kw):
    kw = dict(CV, **kw)
    tree = _noisy(jcv.init(jax.random.PRNGKey(seed), cross_attn_depth=depth,
                           **kw), seed)
    model = crossvit_cnn.CrossViTCNN(cross_attn_depth=depth, **kw)
    model.load_state_dict(checkpoint.crossvit_cnn_state_from_jax(tree),
                          strict=True)
    return tree, model


@pytest.mark.parametrize("depth", [1, 2])
def test_crossvit_cnn_apply_matches_jax(depth):
    tree, model = _crossvit_pair(15, depth)
    rng = np.random.default_rng(16)
    tokens = rng.normal(size=(2, 5, 32)).astype(np.float32)
    fmap = rng.normal(size=(2, 2, 2, 64)).astype(np.float32)
    want = np.asarray(jcv.apply(_j(tree), jnp.asarray(tokens),
                                jnp.asarray(fmap), heads=2, dim_head=8))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens), torch.from_numpy(fmap))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_crossvit_cnn_depth2_only_last_layer_reaches_output():
    """The kept reference quirk, as ``tests/test_alt_fusion.py::
    test_depth2_only_last_layer_reaches_output`` pins it in JAX: layer 0
    changes nothing and gets no gradient, layer 1 gets one."""
    _, model = _crossvit_pair(17, depth=2)
    rng = np.random.default_rng(18)
    tokens = torch.from_numpy(rng.normal(size=(2, 5, 32)).astype(np.float32))
    fmap = torch.from_numpy(rng.normal(size=(2, 2, 2, 64)).astype(np.float32))
    base = model(tokens, fmap)
    (base ** 2).sum().backward()
    l0, l1 = model.encoders[0].layers
    assert all(p.grad is None or not p.grad.any() for p in l0.parameters())
    assert l1.f_sl.weight.grad.abs().sum() > 0
    with torch.no_grad():
        l0.f_sl.weight += 7.0
        assert torch.equal(model(tokens, fmap), base.detach())


def test_crossvit_cnn_fused_forward_matches_jax():
    """vit_test at 64 px (17 tokens) and resnet18 (a 2 x 2 x 512 map)
    through both backbones and the head (3 heads of 64), fp32."""
    jv_cfg = jvit.ViTConfig("vit_test", **dict(TINY, img_size=64))
    pv_cfg = vit.ViTConfig("vit_test", **dict(TINY, img_size=64))
    r_cfg = jresnet.get_config("resnet18")
    k1, k2 = jax.random.split(jax.random.PRNGKey(19))
    jv = _noisy(jvit.init(k1, jv_cfg, num_classes=3), 20, only_biases=True)
    jr = jax.tree.map(np.asarray, jresnet.init(k2, r_cfg))
    # JAX's fused_forward applies the head at its default 3 heads of 64
    tree, fus = _crossvit_pair(21, large_dim=512, heads=3, dim_head=64)
    img = np.random.default_rng(22).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    want = np.asarray(jcv.fused_forward(
        _j(jv), _j(jr), _j(tree), jnp.asarray(img), jv_cfg, r_cfg,
        compute_dtype=jnp.float32, attn_backend="xla"))
    pv = vit.ViT(pv_cfg, 3)
    pv.load_state_dict(checkpoint.vit_state_from_jax(jv, pv_cfg), strict=True)
    pr = resnet.ResNet(resnet.get_config("resnet18"))
    pr.load_state_dict(checkpoint.resnet_state_from_jax(jr, r_cfg),
                       strict=True)
    pr.eval()
    with torch.no_grad():
        fmap = pr(torch.from_numpy(img), compute_dtype=torch.float32,
                  return_featmap=True)
        got = crossvit_cnn.fused_forward(pv, pr, fus, torch.from_numpy(img),
                                         compute_dtype=torch.float32)
    assert fmap.shape == (2, 2, 2, 512)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def _fusion_pair(seed, jgcfg):
    """JAX {cxr, enh, fus} trees (the branches' biases and the whole GPT
    head noisy) and the port's ``nn.ModuleDict`` loaded from them."""
    jcfg = jvit.ViTConfig("vit_test", **TINY)
    pcfg = vit.ViTConfig("vit_test", **TINY)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    params = {"cxr": _noisy(jvit.init(k1, jcfg, num_classes=3), seed + 1,
                            only_biases=True),
              "enh": _noisy(jvit.init(k2, jcfg, num_classes=3), seed + 2,
                            only_biases=True),
              "fus": _noisy(jgpt.init(k3, jgcfg, num_classes=3), seed + 3)}
    models = nn.ModuleDict({
        "cxr": vit.ViT(pcfg, 3), "enh": vit.ViT(pcfg, 3),
        "fus": gpt_fusion.GPTFusion(gpt_fusion.GPTFusionConfig(
            **dataclasses.asdict(jgcfg)), 3)})
    for b in ("cxr", "enh"):
        models[b].load_state_dict(
            checkpoint.vit_state_from_jax(params[b], pcfg), strict=True)
    models["fus"].load_state_dict(
        checkpoint.gpt_fusion_state_from_jax(params["fus"]), strict=True)
    return jcfg, _j(params), models


# the GPT head of common.gpt_fusion_cfg at vit_test (D 32, grid 2), 2 blocks
JGCFG = dataclasses.replace(jgpt.VIT_CONFIG, n_embd=32, n_layer=2,
                            vert_anchors=2, horz_anchors=2)


@pytest.mark.parametrize("semi,remat", [
    pytest.param(False, False, id="LP"),
    pytest.param(True, False, id="semi"),
    pytest.param(True, True, id="semi-remat")])
def test_gpt_fusion_step_trajectory_matches_jax(semi, remat, monkeypatch):
    """Three steps of ``make_fusion_steps(fusion_arch="gpt")`` in fp32
    against JAX's, under ``fuse --optimizer sgd`` (momentum 0.9, lr 0.05,
    cosine): the losses, the decision logits and every parameter after
    the last step, the key biases included. SGD's steps are linear in the
    gradients. Adam's are not: it divides each gradient by its own size,
    so an element whose gradient is a cancellation at rounding level (here
    one patch weight at 5.6e-8, 7 % apart between two fp32 summation
    orders) steps by amounts that differ by more than the bar, as the key
    biases do. Under LP the branches are unchanged bit for bit; ``remat``
    recomputes the branches' blocks, on both sides."""
    rematted = []
    checkpoint_fn = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda *a, **k: rematted.append(1)
                        or checkpoint_fn(*a, **k))
    jcfg, params, models = _fusion_pair(30, JGCFG)
    before = {k: v.clone() for k, v in models.state_dict().items()}
    sched = dict(cos=True, steps_per_epoch=3)
    tx = joptim.build_optimizer(
        "sgd", joptim.finetune_lr(0.05, 2, **sched),
        trainable_mask=None if semi else jfuse.fusion_trainable_mask(params))
    jstep, _ = jsteps.make_fusion_steps(
        jcfg, tx, compute_dtype=jnp.float32, attn_backend="xla",
        freeze_backbones=not semi, fusion_arch="gpt", gpt_cfg=JGCFG,
        remat=remat)
    state = tx.init(params)
    opt = optim.build_optimizer(
        "sgd", models.named_parameters(), optim.finetune_lr(0.05, 2, **sched),
        trainable_mask=None if semi else fuse.fusion_trainable_mask(
            models.named_parameters()))
    step, _ = steps.make_fusion_steps(
        compute_dtype=torch.float32, freeze_backbones=not semi, remat=remat,
        fusion_arch="gpt")
    rng = np.random.default_rng(31)
    for _ in range(3):
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
    _, _, want = _fusion_pair(30, JGCFG)
    for b in ("cxr", "enh"):
        want[b].load_state_dict(checkpoint.vit_state_from_jax(
            jax.tree.map(np.asarray, params[b]), want[b].cfg))
    want["fus"].load_state_dict(checkpoint.gpt_fusion_state_from_jax(
        jax.tree.map(np.asarray, params["fus"])))
    want = want.state_dict()
    for k, v in models.state_dict().items():
        if not semi and not k.startswith("fus."):
            assert torch.equal(v, before[k]), k
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5,
                                   err_msg=k)
    assert bool(rematted) == remat
    moved = [k for k, v in models.state_dict().items()
             if not torch.equal(v, before[k])]
    assert "fus.pos_emb" in moved
    assert any(k.startswith("cxr.blocks.") for k in moved) == semi


def test_unknown_fusion_arch_raises():
    with pytest.raises(ValueError, match="unknown fusion_arch 'xyz'"):
        steps.make_fusion_steps(fusion_arch="xyz")
    with pytest.raises(ValueError, match="unknown fusion_arch 'xyz'"):
        steps.make_fusion_forward(fusion_arch="xyz")


@pytest.fixture(scope="module")
def covid_root(tmp_path_factory):
    """24 image pairs over 3 classes: 16 train, 4 val, 4 test."""
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


SIZE = ["-a", "vit_test", "--img-size", "32", "--crop", "32",
        "--maintain-ratio", "--compute-dtype", "float32", "-j", "2"]
GPT = ["--fusion-arch", "gpt", "--gpt-layers", "1"]


def test_fuse_gpt_cli_and_infer_serves_its_model_best(covid_root, capsys):
    """``fuse --fusion-arch gpt --gpt-layers 1`` LP and --semi-supervised
    on the CPU (16 pairs at B=8, 2 epochs), the branches from the port's
    own ViT files; then ``infer --fusion-arch gpt`` serves the last
    run's model_best as it is, equal to the eval step on it. The same
    file refuses another input size (its learned joint table) and
    ``--int8``."""
    ds = str(covid_root / "create_covid_dataset")
    pcfg = vit.ViTConfig("vit_test", **TINY)
    branches = []
    for b, seed in (("cxr", 1), ("enh", 2)):
        m = vit.ViT(pcfg, 3, generator=torch.Generator().manual_seed(seed))
        path = covid_root / f"{b}_model_best"
        torch.save(m.state_dict(), path)
        branches += [f"--pretrained-{b}", str(path)]
    train = SIZE + GPT + ["--seed", "0", "-b", "8", "--epochs", "2", "--cos",
                          "--lr", "1e-3", "--semi-ratios", "1", "-p", "1",
                          "--covid-ds", ds, "--device", "cpu"] + branches
    for mode in ("lp", "semi"):
        root = covid_root / f"gpt_{mode}"
        extra = ["--semi-supervised"] if mode == "semi" else []
        (res,) = fuse.main(train + extra + ["--storage-root", str(root)])
        out = capsys.readouterr().out
        assert len(res.extra["train_losses"]) == 4
        assert all(np.isfinite(res.extra["train_losses"]))
        assert np.isfinite(res.test_auc) and 0 <= res.test_acc <= 1
        assert ("=> fusion sanity check passed." in out) == (mode == "lp")
        best = next(root.iterdir()) / "train_1_0" / "model_best"
        sd = torch.load(best, weights_only=True)
        assert sd["fus.pos_emb"].shape == (1, 10, 32)
        assert sd["fus.pos_emb"].any()  # trained away from its zero init
        assert not any(k.startswith("fus.blocks.1.") for k in sd)

    man = str(covid_root / "create_covid_dataset" / "val_ds.txt")
    serve = SIZE + GPT + ["-b", "4", "--device", "cpu", "--checkpoint",
                          str(best), "--manifest", man]
    got = infer.main(serve + ["--output", str(covid_root / "pred.json")])
    args = infer.build_parser().parse_args(serve)
    models = nn.ModuleDict(infer.load_models(args, pcfg, torch.device("cpu")))
    assert isinstance(models["fus"], gpt_fusion.GPTFusion)
    _, eval_step = steps.make_fusion_steps(compute_dtype=torch.float32,
                                           fusion_arch="gpt")
    batch = next(iter(common.make_paired_loader(args, man)))
    xs = infer.prepare(batch, torch.device("cpu"), torch.float32)
    np.testing.assert_allclose(np.asarray(got["logits"]),
                               eval_step(models, *xs).numpy(), rtol=1e-6,
                               atol=1e-6)
    assert got["n"] == 4 and "metrics" in got

    with pytest.raises(ValueError, match="10 tokens; 48 px gives 20"):
        infer.main(serve + ["--img-size", "48", "--crop", "48"])
    with pytest.raises(SystemExit, match="wired for the CA fusion path only"):
        infer.main(serve + ["--int8"])
