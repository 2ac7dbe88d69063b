"""Checkpoint interop and the rest of ``infer`` on the CPU, against the JAX
package: ``exp/orbax_io.read_tree`` against ``mfvit_tpu.exp.checkpoint.
restore`` on trees JAX's ``save`` writes, the four CLIs on JAX's orbax
directories (``infer --checkpoint``, ``finetune --pretrained``, ``fuse
--pretrained-*``, ``pretrain --resume`` under each optimizer), the
converter's files, the refusals without ``tensorstore``, the reference
``Fus_CrossViT`` ``.pth.tar`` and ``--attn-backend xla``.

Tolerances: ``read_tree`` equals ``restore`` bit for bit, in structure
and dtype; a converter's file equals the directory's load bit for bit.
``infer`` on a directory against JAX's ``infer`` on it: logits atol 1e-4
and identical predictions (``test_torch_port_infer.py``'s bar); ``--int8``
against JAX's K10/K11 path in interpret mode, the same. A resumed MoCo
step against JAX's from the same restored state, optimizer state and
batch: the loss within rtol 1e-5, every entry within 1e-5 plus 1e-5 of
how far the run moved it (``test_torch_port_moco.py``'s bar; Adam's and
AdamW's fp32 bias correction in optax stays far inside it at one step),
but for the entries whose gradient is zero in exact arithmetic (the key
third of each qkv bias, the softmax being shift-invariant along the keys;
the encoder's final LayerNorm bias, ahead of the projector's BatchNorm):
under Adam and AdamW their second moments are rounding noise (below
1e-16), which Adam divides by its own root, so they are held within twice
the LR, the most one step moves them. The ResNet-18 arm's resumed step
takes 2e-4 in place of the first 1e-5 and an atol of 1e-4 on the loss
(its test says why: JAX's BatchNorm variance cancels digits).
The XLA route in fp32: ViT tokens and logits, the fusion head and one SGD
step within atol 1e-5 of JAX's ``attn_backend="xla"``; the reference
fusion head's logits within atol 1e-5 of JAX's head on
``torch_fusion_to_params``."""
import argparse
import os
import re
import sys

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
from mfvit_tpu.exp import checkpoint as jckpt
from mfvit_tpu.models import fusion as jfusion
from mfvit_tpu.models import gpt_fusion as jgpt
from mfvit_tpu.nn import resnet as jresnet
from mfvit_tpu.nn import vit as jvit
from mfvit_tpu.ops import fused_int8 as jfi8
from mfvit_tpu.ops import quant as jquant
from mfvit_tpu.ssl import moco as jmoco
from mfvit_tpu.train import optim as joptim
from mfvit_tpu.train import steps as jsteps
from mfvit_tpu_torch.cli import common, finetune, fuse, infer, pretrain
from mfvit_tpu_torch.data import manifest
from mfvit_tpu_torch.exp import checkpoint, orbax_io
from mfvit_tpu_torch.models import fusion
from mfvit_tpu_torch.nn import resnet, vit, xla_route
from mfvit_tpu_torch.ssl import moco
from mfvit_tpu_torch.tools import convert_orbax
from mfvit_tpu_torch.train import optim, steps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(img_size=32, patch=16, dim=32, depth=2, heads=2)
JCFG = jvit.ViTConfig("vit_test", **TINY)
PCFG = vit.ViTConfig("vit_test", **TINY)
RCFG = jresnet.get_config("resnet18")
MOCO = dict(dim=8, mlp_dim=16, K=32, T=0.2)
MOCO_FLAGS = ["--moco-dim", "8", "--moco-mlp-dim", "16", "--moco-k", "32",
              "--moco-t", "0.2"]
SIZE = ["-a", "vit_test", "--img-size", "32", "--crop", "32",
        "--maintain-ratio", "--compute-dtype", "float32", "-j", "2"]
PORT_FLAGS = SIZE + ["--fusion-heads", "2"]
JAX_FLAGS = PORT_FLAGS + ["--attn-backend", "xla", "--seed", "0"]
GPT = ["--fusion-arch", "gpt", "--gpt-layers", "1"]
OPTIMIZERS = ("lars", "adamw", "adam", "sgd")
LR, WD, B = 0.01, 1e-4, 8
D = TINY["dim"]
NOISE_NU = 1e-16  # Adam's second moment of a gradient of rounding noise


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _noisy(tree, seed):
    """Non-zero biases and LayerNorms: no entry equal to its init (numpy
    leaves, so that a donating JAX step copies them)."""
    leaves, treedef = jax.tree.flatten(tree)
    rng = np.random.default_rng(seed)
    return jax.tree.unflatten(treedef, [
        np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x)).astype(
            np.float32) if np.asarray(x).dtype == np.float32
        else np.asarray(x) for x in leaves])


def _serving_tree(arch: str, seed: int):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    fus = (jgpt.init(k3, _gpt_cfg(), num_classes=3) if arch == "gpt"
           else jfusion.init(k3, num_classes=3, dim=32, heads=2))
    return _noisy({"cxr": jvit.init(k1, JCFG, num_classes=3),
                   "enh": jvit.init(k2, JCFG, num_classes=3), "fus": fus},
                  seed)


def _gpt_cfg():
    return jcommon.gpt_fusion_cfg(argparse.Namespace(gpt_layers=1), JCFG)


def _moco_tx(name):
    return joptim.build_optimizer(name, joptim.pretrain_cosine_lr(LR, 2, 1, 3),
                                  weight_decay=WD, momentum=0.9)


def _views(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, 32, 32, 3)).astype(np.float32)
            for _ in range(2)]


@pytest.fixture(scope="module")
def jdirs(tmp_path_factory):
    """The trees JAX's ``save`` writes: a ViT ``model_best`` (with its
    head), CA and GPT ``fuse`` ``model_best``s, a MoCo
    ``checkpoint_0000`` under each optimizer and one of ``pretrain -a
    resnet18`` (two JAX steps in, so every moment is non-zero; with the
    jitted step that made it, for the resume tests), a
    ``checkpoint_best_loss`` and a bf16 leaf."""
    root = tmp_path_factory.mktemp("jax_ckpts")
    out = {"root": root}

    def save(name, tree):
        out[name] = str(root / name)
        jckpt.save(out[name], tree)

    save("vit", _noisy(jvit.init(jax.random.PRNGKey(3), JCFG, 3), 3))
    save("ca", _serving_tree("ca", 4))
    save("gpt", _serving_tree("gpt", 5))
    jm = jmoco.MoCoConfig(**MOCO)
    for name in OPTIMIZERS:
        state = jmoco.init(jax.random.PRNGKey(6), jm, JCFG)
        tx = _moco_tx(name)
        step = jax.jit(jmoco.make_pretrain_step(
            jm, JCFG, tx, compute_dtype=jnp.float32, attn_backend="xla"))
        opt_state = tx.init({"base": state["base"],
                             "predictor": state["predictor"]})
        for i in range(2):
            q, k = _views(i)
            state, opt_state, _ = step(state, opt_state, jnp.asarray(q),
                                       jnp.asarray(k), jnp.float32(0.99))
        save(f"moco_{name}", {"state": state, "opt_state": opt_state,
                              "epoch": jnp.asarray(0, jnp.int32)})
        out[f"step_{name}"] = step
    # pretrain -a resnet18: MoCoConfig.resnet towers, the default LARS
    jr = jmoco.MoCoConfig.resnet(**MOCO)
    state_r = jmoco.init(jax.random.PRNGKey(7), jr, RCFG)
    tx = _moco_tx("lars")
    step = jax.jit(jmoco.make_pretrain_step(
        jr, RCFG, tx, compute_dtype=jnp.float32, attn_backend="xla"))
    opt_state = tx.init({"base": state_r["base"],
                         "predictor": state_r["predictor"]})
    for i in range(2):
        q, k = _views(i)
        state_r, opt_state, _ = step(state_r, opt_state, jnp.asarray(q),
                                     jnp.asarray(k), jnp.float32(0.99))
    save("moco_resnet18", {"state": state_r, "opt_state": opt_state,
                           "epoch": jnp.asarray(0, jnp.int32)})
    out["step_resnet18"] = step
    save("best_loss", {"state": state, "epoch": 1})
    save("bf16", {"w": jnp.arange(12, dtype=jnp.bfloat16).reshape(3, 4) / 7,
                  "e": {}, "n": None, "l": [jnp.ones(2), []]})
    return out


def _same(got, want, path=""):
    """Equal structure, types, dtypes and bytes."""
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif want is not None:
        assert (got.dtype, got.shape) == (want.dtype, want.shape), path
        assert got.tobytes() == want.tobytes(), path


@pytest.mark.parametrize("name", ["vit", "ca", "gpt", "moco_lars",
                                  "moco_adamw", "moco_adam", "moco_sgd",
                                  "best_loss", "bf16"])
def test_read_tree_equals_jax_restore(jdirs, name):
    got = orbax_io.read_tree(jdirs[name])
    _same(got, jckpt.restore(jdirs[name]))
    if name == "bf16":
        w = orbax_io.to_torch(got["w"])
        assert w.dtype == torch.bfloat16
        assert w.float().numpy().tobytes() == np.asarray(
            got["w"], np.float32).tobytes()


def test_chip_smoke_writes_orbax_layout(tmp_path, monkeypatch):
    """``chip_smoke.write_orbax_tree``, the tree its interop phase reads
    where ``tensorstore`` is importable: JAX's ``restore`` and
    ``read_tree`` read it as written; without tensorstore it writes only
    ``_METADATA``, on which ``infer`` then names the converter."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    tree = {"cxr": {"cls": np.ones((1, 1, 4), np.float32),
                    "blocks": [{"w": np.arange(6, dtype=np.float32)
                                .reshape(2, 3)}, {"w": np.zeros((2, 3),
                                                                np.float32)}]},
            "epoch": np.asarray(3, np.int32), "empty": {}}
    path = str(tmp_path / "written")
    assert smoke.write_orbax_tree(path, tree)
    _same(orbax_io.read_tree(path), tree)
    _same(jckpt.restore(path), tree)
    assert smoke._tree_equal(orbax_io.read_tree(path), tree)
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    assert not smoke.write_orbax_tree(str(tmp_path / "meta_only"), tree)
    with pytest.raises(SystemExit, match="convert_orbax"):
        orbax_io.read_tree(str(tmp_path / "meta_only"))


def test_read_tree_without_ocdbt_and_zarr3(tmp_path):
    """orbax's other layouts: no OCDBT (a folder per array), zarr3."""
    import orbax.checkpoint as ocp
    tree = {"a": np.arange(6, dtype=np.float32).reshape(3, 2),
            "l": [np.ones(2, np.int32), {"x": np.zeros(1)}]}
    for ocdbt, zarr3 in ((False, False), (True, True), (False, True)):
        path = str(tmp_path / f"{ocdbt}_{zarr3}")
        with ocp.PyTreeCheckpointer(use_ocdbt=ocdbt, use_zarr3=zarr3) as ck:
            ck.save(path, tree)
        meta = orbax_io.read_metadata(path)
        assert (meta["use_ocdbt"], meta["use_zarr3"]) == (ocdbt, zarr3)
        _same(orbax_io.read_tree(path), jckpt.restore(path))


@pytest.fixture(scope="module")
def covid_root(tmp_path_factory):
    """16 image pairs over 3 classes ('data' and 'Train_Mix'): 8 train, 4
    val, 4 test."""
    root = tmp_path_factory.mktemp("covid_interop")
    data_root, man_root = root / "images", root / "create_covid_dataset"
    os.makedirs(man_root)
    rng = np.random.default_rng(0)
    names = [f"img_{i}.png" for i in range(16)]
    for folder in ("data", "Train_Mix"):
        os.makedirs(data_root / folder)
        for fn in names:
            cv2.imwrite(str(data_root / folder / fn),
                        rng.integers(0, 255, (64, 72, 3), np.uint8))
    labels = [i % 3 for i in range(16)]
    for fname, sl in (("1_labeled_train_0.txt", slice(0, 8)),
                      ("val_ds.txt", slice(8, 12)),
                      ("test_ds.txt", slice(12, 16))):
        manifest.write_covid_manifest(str(man_root / fname), str(data_root),
                                      names[sl], labels[sl])
    return root


INFER_CASES = {"ca": ("ca", []), "ca_xla": ("ca", ["--attn-backend", "xla"]),
               "gpt": ("gpt", GPT),
               "ca_int8_xla": ("ca", ["--int8", "--attn-backend", "xla"])}


@pytest.mark.parametrize("case", sorted(INFER_CASES))
def test_infer_on_a_jax_dir_matches_jax_infer(jdirs, covid_root, tmp_path,
                                              case, capsys):
    """``infer --checkpoint <JAX fuse model_best>`` against JAX's ``infer``
    on the same directory (JAX on its XLA route): the plain versions of
    the kernels, the XLA route, the GPT head, and ``--int8`` on the XLA
    route (JAX's dequantized route)."""
    arch, extra = INFER_CASES[case]
    man = str(covid_root / "create_covid_dataset" / "val_ds.txt")
    common_argv = ["--checkpoint", jdirs[arch], "--manifest", man, "-b", "3"]
    jextra = [a for a in extra if a not in ("--attn-backend", "xla")]
    want = jinfer.main(JAX_FLAGS + jextra + common_argv + [
        "--output", str(tmp_path / "jax.json")])
    capsys.readouterr()
    got = infer.main(PORT_FLAGS + extra + common_argv + [
        "--output", str(tmp_path / "port.json"), "--device", "cpu"])
    route = capsys.readouterr().out.splitlines()[0]
    assert route == xla_route.describe("xla" if "xla" in extra else None)
    assert got["n"] == want["n"] == 4
    np.testing.assert_allclose(np.asarray(got["logits"]),
                               np.asarray(want["logits"]), atol=1e-4)
    assert got["predictions"] == want["predictions"]


def test_infer_int8_on_a_jax_dir_matches_jax_kernel_path(jdirs, covid_root,
                                                        tmp_path):
    """``infer --int8`` (K10/K11's plain versions) on the directory
    against JAX's ``make_fusion_forward`` on its restored tree quantized,
    K10/K11 in interpret mode, on the same normalised batches."""
    man = str(covid_root / "create_covid_dataset" / "val_ds.txt")
    argv = PORT_FLAGS + ["--checkpoint", jdirs["ca"], "--manifest", man,
                         "--output", str(tmp_path / "port.json"), "-b", "3",
                         "--device", "cpu", "--int8"]
    got = infer.main(argv)
    tree = jckpt.restore(jdirs["ca"])
    jq = dict(tree, cxr=jfi8.quantize_vit_for_serving(tree["cxr"]),
              enh=jfi8.quantize_vit_for_serving(tree["enh"]))
    fwd = jsteps.make_fusion_forward(JCFG, heads=2, compute_dtype=jnp.float32,
                                     attn_backend="pallas_interpret")
    args = infer.build_parser().parse_args(argv)
    want = np.concatenate([
        np.asarray(sum(fwd(jq, *(jnp.asarray(x.numpy()) for x in
                                 infer.prepare(b, "cpu", torch.float32)))))
        for b in common.make_paired_loader(args, man)])[:got["n"]]
    np.testing.assert_allclose(np.asarray(got["logits"]), want, atol=1e-4)
    assert got["predictions"] == want.argmax(-1).tolist()


def test_serving_dir_refuses_another_head(jdirs):
    with pytest.raises(ValueError, match="GPT head; this run has "
                                         "--fusion-arch ca"):
        checkpoint.load_serving(jdirs["gpt"], PCFG)
    with pytest.raises(ValueError, match="keys cxr/enh/fus"):
        checkpoint.load_serving(jdirs["vit"], PCFG)


def _equal_sd(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_finetune_and_fuse_load_jax_dirs_as_jax(jdirs, tmp_path):
    """``finetune --pretrained`` (a pretrain checkpoint, a best-loss one,
    a bare ViT tree) and ``fuse --pretrained-*`` (a ViT ``model_best``,
    ``{ratio}``/``{draw}`` filled) on directories: the weights JAX's
    ``load_backbone`` and ``load_branch`` give, through the bridge."""
    for name in ("moco_lars", "best_loss", "vit"):
        jb = jfinetune.load_backbone(argparse.Namespace(
            pretrained=jdirs[name]), JCFG)
        want = {k: v for k, v in
                checkpoint.vit_state_from_jax(_np(jb), PCFG).items()
                if not k.startswith("head.")}
        _equal_sd(finetune.load_backbone(argparse.Namespace(
            pretrained=jdirs[name]), PCFG), want)
    jckpt.save(str(tmp_path / "cxr_1_0"), jckpt.restore(jdirs["vit"]))
    path = str(tmp_path / "cxr_{ratio}_{draw}")
    jb = jfuse.load_branch(path, JCFG, 1, 0)
    got = fuse.load_branch(path, PCFG, 1, 0)
    _equal_sd(got, checkpoint.vit_state_from_jax(_np(jb), PCFG))
    vit.ViT(PCFG, 3).load_state_dict(got, strict=True)


def _port_moco(name):
    model = moco.MoCo(moco.MoCoConfig(**MOCO), PCFG)
    opt = optim.build_optimizer(name, model.trainable(),
                                optim.pretrain_cosine_lr(LR, 2, 1, 3),
                                weight_decay=WD, momentum=0.9)
    return model, opt


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_resumed_moco_step_matches_jax(jdirs, name):
    """The state and optimizer state of a JAX ``checkpoint_0000`` through
    ``load_pretrain_checkpoint``, then one step on a third batch on both
    sides (JAX's from its own restore)."""
    model, opt = _port_moco(name)
    ck = checkpoint.load_pretrain_checkpoint(jdirs[f"moco_{name}"], model,
                                             opt)
    model.load_state_dict(ck["state"], strict=True)
    opt.load_state_dict(ck["opt_state"])
    assert ck["epoch"] == 0 and opt.count == 2
    before = {k: v.clone() for k, v in model.state_dict().items()}
    # JAX's pretrain --resume: restore into the templates of this run
    st = jmoco.init(jax.random.PRNGKey(0), jmoco.MoCoConfig(**MOCO), JCFG)
    like = {"state": st, "opt_state": _moco_tx(name).init(
        {"base": st["base"], "predictor": st["predictor"]}),
        "epoch": jnp.zeros((), jnp.int32)}
    restored = jckpt.restore(jdirs[f"moco_{name}"], like=like)
    state, opt_state = restored["state"], restored["opt_state"]
    q, k = _views(2)
    state, _, jloss = jdirs[f"step_{name}"](state, opt_state, jnp.asarray(q),
                                            jnp.asarray(k), jnp.float32(0.99))
    step = moco.make_pretrain_step(model.cfg, compute_dtype=torch.float32)
    ploss = step(model, opt, torch.from_numpy(q), torch.from_numpy(k), 0.99)
    np.testing.assert_allclose(ploss.item(), float(jloss), rtol=1e-5)
    want = checkpoint.moco_state_from_jax(_np(state), model.cfg, PCFG)
    # entries whose gradient is zero in exact arithmetic keep second
    # moments of rounding noise, which Adam divides by their own root
    params = [p for g in opt.opt.param_groups for p in g["params"]]
    noise = ({n: opt.opt.state[p]["exp_avg_sq"] < NOISE_NU
              for n, p in zip(opt.names, params)}
             if name.startswith("adam") else {})
    for key, v in model.state_dict().items():
        w = want[key]
        if key == "queue_ptr" or key.endswith("num_batches_tracked"):
            assert torch.equal(v, w), key
            continue
        if key in noise and noise[key].any():
            m = noise[key]
            np.testing.assert_allclose(v[m].numpy(), w[m].numpy(), rtol=0,
                                       atol=2 * LR, err_msg=key)
            v, w, before[key] = v[~m], w[~m], before[key][~m]
            if not v.numel():
                continue
        moved = (w - before[key]).abs().max().item()
        np.testing.assert_allclose(v.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 + 1e-5 * moved, err_msg=key)
    if noise:  # the key third of each qkv bias, the encoder's final LN bias
        assert noise["base.encoder.blocks.0.attn.qkv.bias"][D:2 * D].all()
        assert noise["base.encoder.norm.bias"].all()


def test_resumed_resnet18_moco_step_matches_jax(jdirs):
    """The ResNet-18 arm (``pretrain -a resnet18``: ``MoCoConfig.resnet``
    towers, LARS) from JAX's ``checkpoint_0000`` through
    ``load_pretrain_checkpoint``, then one step on a third batch on both
    sides; held as the ViT arm is, but at twice ``test_torch_port_moco.
    py``'s ResNet-18 bar (2e-4 in place of the first 1e-5; the loss within
    rtol 1e-5 plus 1e-4). JAX's BatchNorm variance is E[x^2] - E[x]^2,
    which cancels digits where a channel's mean is many standard
    deviations, the port's the centred sum; the difference grows with the
    steps: an uninterrupted run from JAX's init reads 1.015e-4 on layer2's
    BatchNorm biases at its third step (this step) and 4.7e-6 with JAX's
    formula put into the port, and the forward alone on JAX's resumed
    state reads 1.4e-6 to 2.2e-5 relative in the loss over six batches,
    this one the highest."""
    mcfg = moco.MoCoConfig.resnet(**MOCO)
    model = moco.MoCo(mcfg, resnet.get_config("resnet18"))
    opt = optim.build_optimizer("lars", model.trainable(),
                                optim.pretrain_cosine_lr(LR, 2, 1, 3),
                                weight_decay=WD, momentum=0.9)
    ck = checkpoint.load_pretrain_checkpoint(jdirs["moco_resnet18"], model,
                                             opt)
    model.load_state_dict(ck["state"], strict=True)
    opt.load_state_dict(ck["opt_state"])
    assert ck["epoch"] == 0 and opt.count == 2
    assert int(model.queue_ptr) == 2 * B % MOCO["K"]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    st = jmoco.init(jax.random.PRNGKey(0), jmoco.MoCoConfig.resnet(**MOCO),
                    RCFG)
    like = {"state": st, "opt_state": _moco_tx("lars").init(
        {"base": st["base"], "predictor": st["predictor"]}),
        "epoch": jnp.zeros((), jnp.int32)}
    restored = jckpt.restore(jdirs["moco_resnet18"], like=like)
    q, k = _views(2)
    state, _, jloss = jdirs["step_resnet18"](
        restored["state"], restored["opt_state"], jnp.asarray(q),
        jnp.asarray(k), jnp.float32(0.99))
    step = moco.make_pretrain_step(mcfg, compute_dtype=torch.float32)
    ploss = step(model, opt, torch.from_numpy(q), torch.from_numpy(k), 0.99)
    np.testing.assert_allclose(ploss.item(), float(jloss), rtol=1e-5,
                               atol=1e-4)
    want = checkpoint.moco_state_from_jax(_np(state), mcfg,
                                          model.backbone_cfg)
    assert set(want) == set(model.state_dict())
    for key, v in model.state_dict().items():
        w = want[key]
        if key == "queue_ptr" or key.endswith("num_batches_tracked"):
            assert torch.equal(v, w), key
            continue
        moved = (w - before[key]).abs().max().item()
        np.testing.assert_allclose(v.numpy(), w.numpy(), rtol=0,
                                   atol=2e-4 + 1e-5 * moved, err_msg=key)


def test_pretrain_cli_resumes_a_jax_dir(jdirs, covid_root, capsys):
    """``pretrain --resume <JAX checkpoint_0000>`` starts where JAX's
    would (epoch + 1) and runs the rest; a best-loss directory (no
    optimizer state) and a directory of another optimizer's state are
    refused."""
    ds = str(covid_root / "create_covid_dataset")
    argv = SIZE + MOCO_FLAGS + [
        "--covid-ds", ds, "-b", "8", "--epochs", "2", "--cos", "--lr",
        str(LR), "--wd", str(WD), "--warmup-epochs", "1", "--device", "cpu",
        "--semi-ratios", "1", "--storage-root", str(covid_root / "resume")]
    want = int(jckpt.restore(jdirs["moco_lars"])["epoch"]) + 1
    (res,) = pretrain.main(argv + ["--resume", jdirs["moco_lars"]])
    out = capsys.readouterr().out
    assert re.findall(r"resumed from .* at epoch (\d+)", out) == [str(want)]
    assert len(res.extra["train_losses"]) == 1  # epoch 1 only, one step
    assert np.isfinite(res.extra["train_losses"]).all()
    with pytest.raises(ValueError, match="no optimizer state"):
        pretrain.main(argv + ["--resume", jdirs["best_loss"]])
    with pytest.raises(ValueError, match="not an optax adamw state"):
        pretrain.main(argv + ["--optimizer", "adamw", "--resume",
                              jdirs["moco_adam"]])


def test_convert_orbax_files_equal_the_dirs(jdirs, tmp_path):
    """Each kind's file, read as the CLI reads it, gives what the
    directory gives, bit for bit."""
    def convert(src, kind, *flags):
        dst = str(tmp_path / f"{kind}_{os.path.basename(src)}")
        assert convert_orbax.main([src, dst, "--kind", kind, "-a",
                                   "vit_test", "--img-size", "32", "--crop",
                                   "32", *flags]) == dst
        return dst

    for arch, flags in (("ca", ["--fusion-heads", "2"]), ("gpt", GPT)):
        f = convert(jdirs[arch], "serving", *flags)
        got = checkpoint.load_serving(f, PCFG)
        want = checkpoint.load_serving(jdirs[arch], PCFG,
                                       "gpt" if arch == "gpt" else "ca")
        for k in checkpoint.SERVING_KEYS:
            _equal_sd(got[k], want[k])
    f = convert(jdirs["vit"], "branch")
    _equal_sd(fuse.load_branch(f, PCFG, 1, 0),
              fuse.load_branch(jdirs["vit"], PCFG, 1, 0))
    for name in ("moco_adamw", "best_loss"):
        f = convert(jdirs[name], "pretrain", "--optimizer", "adamw",
                    *MOCO_FLAGS)
        model, opt = _port_moco("adamw")
        want = checkpoint.load_pretrain_checkpoint(jdirs[name], model, opt)
        got = checkpoint.load_pretrain_checkpoint(f)
        assert got["epoch"] == want["epoch"]
        _equal_sd(got["state"], want["state"])
        assert ("opt_state" in got) == ("opt_state" in want) == (
            name != "best_loss")
        if "opt_state" in want:
            assert got["opt_state"]["count"] == want["opt_state"]["count"]
            gs, ws = got["opt_state"]["opt"]["state"], want["opt_state"][
                "opt"]["state"]
            assert sorted(gs) == sorted(ws)
            for i in ws:
                _equal_sd(gs[i], ws[i])
        args = argparse.Namespace(pretrained=f)
        _equal_sd(finetune.load_backbone(args, PCFG), finetune.load_backbone(
            argparse.Namespace(pretrained=jdirs[name]), PCFG))


def test_without_tensorstore_the_clis_name_the_converter(jdirs, covid_root,
                                                         monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    ds = str(covid_root / "create_covid_dataset")
    train = SIZE + ["--covid-ds", ds, "-b", "8", "--epochs", "1",
                    "--device", "cpu", "--semi-ratios", "1",
                    "--storage-root", str(covid_root / "refused")]
    runs = (
        (infer.main, PORT_FLAGS + ["--checkpoint", jdirs["ca"], "--manifest",
                                   os.path.join(ds, "val_ds.txt"),
                                   "--device", "cpu"], "ca", "serving"),
        (finetune.main, train + ["--pretrained", jdirs["moco_lars"]],
         "moco_lars", "pretrain"),
        (fuse.main, train + ["--pretrained-cxr", jdirs["vit"]], "vit",
         "branch"),
        (pretrain.main, train + MOCO_FLAGS + ["--resume", jdirs["moco_lars"]],
         "moco_lars", "pretrain"))
    for main, argv, name, kind in runs:
        with pytest.raises(SystemExit) as e:
            main(argv)
        msg = str(e.value)
        assert jdirs[name] in msg and "no tensorstore" in msg, msg
        assert (f"python -m mfvit_tpu_torch.tools.convert_orbax "
                f"{jdirs[name]} <file> --kind {kind}") in msg, msg


@pytest.mark.parametrize("prefix", ["", "module."])
def test_load_reference_fusion_matches_jax(tmp_path, prefix):
    """A reference ``Fus_CrossViT`` head's ``.pth.tar`` (from JAX's
    ``fusion_params_to_torch``, depth 2 x 2): the port's head loaded from
    it gives the logits of JAX's head on ``torch_fusion_to_params``; a
    missing or an extra entry raises, naming it."""
    jp = _noisy(jfusion.init(jax.random.PRNGKey(7), num_classes=3, dim=32,
                             heads=2, cross_attn_depth=2,
                             multi_scale_enc_depth=2), 7)
    sd = jckpt.fusion_params_to_torch(jp)
    path = str(tmp_path / "fus.pth.tar")
    torch.save({"state_dict": {prefix + k: torch.from_numpy(np.array(v))
                               for k, v in sd.items()}}, path)
    fus = fusion.Fusion(3, 32, 2, 2, 2)
    checkpoint.load_reference_fusion(path, fus)
    rng = np.random.default_rng(8)
    tc, te = (rng.standard_normal((3, 5, 32)).astype(np.float32)
              for _ in range(2))
    want = jfusion.apply(jckpt.torch_fusion_to_params(sd, 2, 2),
                         jnp.asarray(tc), jnp.asarray(te), 2,
                         attn_backend="xla")
    with torch.no_grad():
        got = fus(torch.from_numpy(tc), torch.from_numpy(te))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    key = "multi_scale_transformers.1.cross_attn_layers.0.2.fn.wk.weight"
    for edit, name in (("drop", key), ("add", "mlp_head_cxr.1.weight")):
        bad = {prefix + k: torch.from_numpy(np.array(v))
               for k, v in sd.items() if not (edit == "drop" and k == key)}
        if edit == "add":
            bad[prefix + name] = torch.zeros(3, 3)
        torch.save(bad, path)
        with pytest.raises(ValueError, match=re.escape(name)):
            checkpoint.load_reference_fusion(path, fusion.Fusion(3, 32, 2,
                                                                 2, 2))


def _port_vit(tree, mode):
    bridge = {"bf16": checkpoint.vit_state_from_jax,
              "int8": checkpoint.vit_int8_state_from_jax,
              "quant": checkpoint.vit_quant_state_from_jax}[mode]
    m = vit.ViT(PCFG, 3)
    if mode == "int8":
        vit.quantize_vit_for_serving(m)
    elif mode == "quant":
        vit.quantize_vit_params(m)
    m.load_state_dict(bridge(_np(tree), PCFG), strict=True)
    return m.eval()


@pytest.mark.parametrize("mode", ["bf16", "int8", "quant"])
def test_xla_route_vit_matches_jax(mode):
    """A ViT (its fp32 weights, the int8 serving tree, the W8A8 tree)
    under ``attn_backend="xla"`` against JAX's on the same tree, fp32:
    the plan takes only the XLA route's functions."""
    tree = _noisy(jvit.init(jax.random.PRNGKey(9), JCFG, 3), 9)
    tree = {"bf16": lambda t: t, "int8": jfi8.quantize_vit_for_serving,
            "quant": jquant.quantize_vit_params}[mode](tree)
    m = _port_vit(tree, mode)
    mods = {o.attn.__module__ for o in m.plans["xla"]} | {
        o.mlp.__module__ for o in m.plans["xla"]}
    assert mods <= {"mfvit_tpu_torch.nn.xla_route",
                    "mfvit_tpu_torch.ops.quant"}
    assert not any(o.final_ln for o in m.plans["xla"])
    x = np.random.default_rng(10).standard_normal((3, 32, 32, 3)).astype(
        np.float32)
    jt, jl = jvit.apply(tree, jnp.asarray(x), JCFG, compute_dtype=jnp.float32,
                        attn_backend="xla", return_features=True)
    with torch.no_grad():
        pt, pl = m(torch.from_numpy(x), compute_dtype=torch.float32,
                   return_features=True, attn_backend="xla")
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), atol=1e-5)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-5)


def test_xla_route_fusion_head_matches_jax():
    """The depth-1 CA head under ``attn_backend="xla"``: the full-sequence
    ``encode`` (no K4 or its plain version) against JAX's XLA route."""
    jp = _noisy(jfusion.init(jax.random.PRNGKey(11), num_classes=3, dim=32,
                             heads=2), 11)
    fus = fusion.Fusion(3, 32, 2)
    fus.load_state_dict(checkpoint.fusion_state_from_jax(_np(jp)))
    rng = np.random.default_rng(12)
    tc, te = (rng.standard_normal((3, 5, 32)).astype(np.float32)
              for _ in range(2))
    want = jfusion.apply(jp, jnp.asarray(tc), jnp.asarray(te), 2,
                         attn_backend="xla")
    calls = []
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(fusion.fused_fusion, "fused_fusion_cls_plain",
                   lambda *a: calls.append(a))
        got = fus(torch.from_numpy(tc), torch.from_numpy(te),
                  attn_backend="xla")
    assert not calls
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_xla_route_finetune_step_matches_jax(jdirs, covid_root, capsys):
    """One FT step (SGD with weight decay) on JAX's XLA route against the
    port's under ``attn_backend="xla"``, fp32: the loss and every
    parameter within atol 1e-5; then ``finetune --attn-backend xla
    --pretrained <JAX pretrain dir>`` runs, its first line naming the
    route."""
    tree = _noisy(jvit.init(jax.random.PRNGKey(13), JCFG, 3), 13)
    tx = joptim.build_optimizer("sgd", 0.1, weight_decay=WD, momentum=0.9)
    jstep, _ = jsteps.make_classifier_steps(JCFG, tx,
                                            compute_dtype=jnp.float32,
                                            attn_backend="xla")
    rng = np.random.default_rng(14)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    y = np.array([0, 1, 2, 1])
    m = vit.ViT(PCFG, 3)
    m.load_state_dict(checkpoint.vit_state_from_jax(_np(tree), PCFG))
    opt = optim.build_optimizer("sgd", m.named_parameters(), 0.1,
                                weight_decay=WD, momentum=0.9)
    pstep, _ = steps.make_classifier_steps(compute_dtype=torch.float32,
                                           attn_backend="xla")
    params, _, jloss, _ = jstep(jax.tree.map(jnp.asarray, tree),
                                tx.init(tree), jnp.asarray(x),
                                jnp.asarray(y))
    ploss, _ = pstep(m, opt, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(ploss.item(), float(jloss), rtol=1e-6)
    want = checkpoint.vit_state_from_jax(_np(params), PCFG)
    for k, v in m.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5,
                                   err_msg=k)

    (res,) = finetune.main(SIZE + [
        "--covid-ds", str(covid_root / "create_covid_dataset"), "-b", "8",
        "--epochs", "1", "--semi-ratios", "1", "--semi-supervised",
        "--device", "cpu", "--attn-backend", "xla", "--lr", "0.01",
        "--pretrained", jdirs["moco_sgd"], "--storage-root",
        str(covid_root / "ft_xla")])
    assert capsys.readouterr().out.splitlines()[0] == xla_route.describe(
        "xla")
    assert len(res.extra["train_losses"]) == 1
    assert np.isfinite(res.extra["train_losses"]).all()


def test_attn_backend_choices_are_jax():
    p, jp = argparse.ArgumentParser(), argparse.ArgumentParser()
    common.add_common_args(p)
    jcommon.add_common_args(jp)
    act = {a.dest: a for a in p._actions}["attn_backend"]
    jact = {a.dest: a for a in jp._actions}["attn_backend"]
    assert act.choices == jact.choices and act.default == jact.default
    with pytest.raises(ValueError, match="unknown attention backend"):
        xla_route.takes_xla("pallas_interpret")


def _jax_processes(worker: str, extra, n: int = 2, timeout: float = 240,
                   retries: int = 1) -> list:
    """n JAX processes of ``tests/<worker>`` rendezvousing on a fresh port
    of 127.0.0.1 (``tests/test_parallel.py::_spawn_dist_workers``): their
    outputs. A timeout is retried once with a new port, then fails with
    the outputs; a worker that exits non-zero fails with its output."""
    import socket
    import subprocess

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.path.join(ROOT, "tests")]))
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    seen = []
    for _ in range(retries + 1):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            addr = f"127.0.0.1:{s.getsockname()[1]}"
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", worker), str(i),
             str(n), addr] + list(extra), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env) for i in range(n)]
        try:
            outs = [p.communicate(timeout=timeout)[0] for p in procs]
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            seen.append([p.communicate()[0] for p in procs])
            continue
        for p, out in zip(procs, outs):
            assert p.returncode == 0, out
        return outs
    pytest.fail(f"{worker}: timed out twice:\n{seen}")


def _leaves(tree, path=()):
    """{path: leaf} of nested dicts and sequences."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {path: tree}
    out = {}
    for k, v in items:
        out.update(_leaves(v, path + (str(k),)))
    return out


def test_read_tree_of_a_two_process_jax_save(tmp_path):
    """Two JAX processes (2 CPU devices each) save one tree through
    ``mfvit_tpu.exp.checkpoint.save``: ``read_tree`` gives every leaf back
    equal in dtype and bits to the known values, the rows that process 1
    wrote (``ocdbt.process_1``) included. JAX's own target-less
    ``restore`` refuses that directory in one process, so the values are
    the known ones, not its restore."""
    import _torch_orbax_save_worker as worker

    path = str(tmp_path / "ckpt")
    outs = _jax_processes("_torch_orbax_save_worker.py", [path])
    assert all(f"SAVED {i}" in out for i, out in enumerate(outs))
    assert os.path.isdir(os.path.join(path, "ocdbt.process_1"))
    want = _leaves(_np(worker.known_tree()))
    got = _leaves(orbax_io.read_tree(path))
    assert set(got) == set(want)
    assert int(got[("step",)]) == want[("step",)] == 7
    del got[("step",)], want[("step",)]
    for k, w in want.items():
        g = np.asarray(got[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k
    np.testing.assert_array_equal(got[("rows",)][2:],
                                  np.arange(12, 24).reshape(2, 6) * 0.5)


# The bf16 XLA route against JAX's, on ROADMAP.md section 3's setup (the
# MF-ViT CA forward, vit_small at 224 px, B=4, seeded weights plus 0.02
# noise): the decision logits' rel (max |diff| / max |ref|) to JAX's fp32
# XLA route may be at most XLA_BF16_MULTIPLE times JAX's own bf16 rel;
# the re-anchor measured 1.440e-2 against 1.437e-2.
XLA_BF16_MULTIPLE = 1.25


def test_xla_route_bf16_within_jax_own_bf16_distance():
    """The port's bf16 ``--attn-backend xla`` logits are as far from JAX's
    fp32 XLA route as JAX's own bf16 ones (within XLA_BF16_MULTIPLE), and
    both wrong attentions of ``chip_smoke.xla_controls`` (the scores
    unscaled; the scale squared) fail that bar."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    jcfg = jvit.get_config("vit_small", 224)
    pcfg = vit.get_config("vit_small", 224)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(21), 3)
    rng = np.random.default_rng(21)
    tree = jax.tree.map(
        lambda x: np.asarray(x) + 0.02 * rng.standard_normal(
            np.shape(x)).astype(np.float32),
        {"cxr": jvit.init(k1, jcfg, num_classes=3),
         "enh": jvit.init(k2, jcfg, num_classes=3),
         "fus": jfusion.init(k3, num_classes=3, dim=384, heads=3)})
    xc, xe = (rng.standard_normal((4, 224, 224, 3)).astype(np.float32)
              for _ in range(2))

    def jax_logits(dt):
        fwd = jsteps.make_fusion_forward(jcfg, heads=3, compute_dtype=dt,
                                         attn_backend="xla")
        return np.asarray(sum(jax.jit(fwd)(tree, jnp.asarray(xc),
                                           jnp.asarray(xe))), np.float32)

    ref, jbf16 = jax_logits(jnp.float32), jax_logits(jnp.bfloat16)
    models = {"cxr": vit.ViT(pcfg, 3), "enh": vit.ViT(pcfg, 3),
              "fus": fusion.Fusion(3, 384, 3)}
    for b in ("cxr", "enh"):
        models[b].load_state_dict(checkpoint.vit_state_from_jax(tree[b], pcfg))
    models["fus"].load_state_dict(checkpoint.fusion_state_from_jax(
        tree["fus"]))
    fwd = steps.make_fusion_forward(compute_dtype=torch.bfloat16,
                                    attn_backend="xla")

    def rel(out):
        return float(np.abs(out - ref).max() / np.abs(ref).max())

    def port():
        return sum(fwd(models, torch.from_numpy(xc),
                       torch.from_numpy(xe))).float().numpy()

    own = rel(jbf16)
    got = rel(port())
    assert got <= XLA_BF16_MULTIPLE * own, (got, own)
    for name, wrong in chip_smoke.xla_controls(xla_route).items():
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(xla_route, "mhsa", wrong)
            bad = rel(port())
        assert bad > XLA_BF16_MULTIPLE * own, (name, bad, own)
