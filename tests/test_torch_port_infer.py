"""The port's serving entry point on the CPU: the data path and the infer
CLI (with its label metrics) against the JAX package's on one synthetic
paired manifest, plus the package boundary (no jax import) and the device
contract."""
import argparse
import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfvit_tpu.cli import common as jcommon
from mfvit_tpu.cli import infer as jinfer
from mfvit_tpu.data import device_aug as jaug
from mfvit_tpu.exp import checkpoint as jckpt
from mfvit_tpu.models import fusion as jfusion
from mfvit_tpu.nn import vit as jvit
from mfvit_tpu.train import metrics as jmetrics
from mfvit_tpu_torch.cli import common, infer
from mfvit_tpu_torch.data import device_aug, manifest
from mfvit_tpu_torch.exp import checkpoint
from mfvit_tpu_torch.train import metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PAIRS = 8
# tests/test_cli.py's COMMON flags, minus the JAX-only ones
PORT_FLAGS = ["-a", "vit_test", "--img-size", "32", "--crop", "32",
              "--maintain-ratio", "--compute-dtype", "float32", "-j", "2",
              "--fusion-heads", "2"]
JAX_FLAGS = PORT_FLAGS + ["--attn-backend", "xla", "--seed", "0"]


@pytest.fixture(scope="module")
def paired(tmp_path_factory):
    """8 synthetic CXR/enhanced pairs (64 x 72, BGR) and their manifest."""
    root = tmp_path_factory.mktemp("paired")
    rng = np.random.default_rng(0)
    for folder in ("data", "Train_Mix"):
        os.makedirs(root / "images" / folder)
    names = [f"img_{i}.png" for i in range(N_PAIRS)]
    for fn in names:
        for folder in ("data", "Train_Mix"):
            cv2.imwrite(str(root / "images" / folder / fn),
                        rng.integers(0, 255, (64, 72, 3), np.uint8))
    man = str(root / "paired.txt")
    manifest.write_covid_manifest(man, str(root / "images"), names,
                                  [i % 3 for i in range(N_PAIRS)])
    return root, man


def _loader_args(batch_size):
    return argparse.Namespace(img_size=32, crop=32, maintain_ratio=True,
                              batch_size=batch_size, workers=2)


def test_eval_batches_match_jax(paired):
    _, man = paired
    a = _loader_args(3)
    ja = argparse.Namespace(**vars(a), aug_device=True, canvas_cache=False,
                            canvas_cache_mb=0, rotate=10.0)
    jl = jcommon.make_covid_loader(ja, man, "data", training=False,
                                   paired=True)
    pl = common.make_paired_loader(a, man)
    jb, pb = list(jl), list(pl)
    assert len(jb) == len(pb) == 3  # 8 pairs at B=3: the last one padded
    for j, p in zip(jb, pb):
        for x, y in zip(j, p):
            np.testing.assert_array_equal(x, y)
    for canv, flavor in zip(pb[0][:2], ("data", "Train_Mix")):
        want = jaug.augment_batch(jax.random.PRNGKey(0), jnp.asarray(canv),
                                  img_type=flavor, training=False)
        got = device_aug.augment_batch(torch.from_numpy(canv),
                                       img_type=flavor)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


def test_infer_cli_matches_jax(paired, tmp_path):
    _, man = paired
    cfg = jvit.ViTConfig("vit_test", img_size=32, patch=16, dim=32, depth=2,
                         heads=2)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(11), 3)
    tree = {"cxr": jvit.init(k1, cfg, num_classes=3),
            "enh": jvit.init(k2, cfg, num_classes=3),
            "fus": jfusion.init(k3, num_classes=3, dim=32, heads=2)}
    jckpt.save(str(tmp_path / "jax_ckpt"), tree)
    want = jinfer.main(JAX_FLAGS + [
        "--checkpoint", str(tmp_path / "jax_ckpt"), "--manifest", man,
        "--output", str(tmp_path / "jax.json"), "-b", "4"])

    np_tree = jax.tree.map(np.asarray, tree)
    pcfg = common.get_vit_arch(argparse.Namespace(arch="vit_test", crop=32,
                                                  img_size=32))
    checkpoint.save_serving(
        str(tmp_path / "port.pt"),
        checkpoint.vit_state_from_jax(np_tree["cxr"], pcfg),
        checkpoint.vit_state_from_jax(np_tree["enh"], pcfg),
        checkpoint.fusion_state_from_jax(np_tree["fus"]))
    out = str(tmp_path / "port.json")
    got = infer.main(PORT_FLAGS + [
        "--checkpoint", str(tmp_path / "port.pt"), "--manifest", man,
        "--output", out, "-b", "3", "--device", "cpu",
        "--report-throughput"])
    assert got["n"] == want["n"] == N_PAIRS
    np.testing.assert_allclose(np.asarray(got["logits"]),
                               np.asarray(want["logits"]), atol=1e-4)
    assert got["predictions"] == want["predictions"]
    # every label is >= 0: both write the same metrics block
    assert set(got["metrics"]) == set(want["metrics"]) == {
        "auc", "top1", "precision", "recall", "f1"}
    for k, v in want["metrics"].items():
        assert got["metrics"][k] == pytest.approx(v, abs=1e-9), k
    with open(out) as f:
        written = json.load(f)
    assert written["logits"] == got["logits"]
    assert written["metrics"] == got["metrics"]
    assert written["pairs_per_sec"] > 0 and written["pairs_per_sec_e2e"] > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_label_metrics_match_jax(seed):
    """The port's copies of ``topk_acc`` and ``precision_recall_f1``
    against the JAX package's, including a class that is never
    predicted."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((40, 3)).astype(np.float32)
    logits[:, 2] -= 10 * seed  # seed 1: class 2 is never predicted
    labels = rng.integers(0, 3, 40)
    assert (metrics.precision_recall_f1(logits, labels, 3)
            == jmetrics.precision_recall_f1(logits, labels, 3))
    for k in (1, 2, 3):
        assert (metrics.topk_acc(logits, labels, k)
                == jmetrics.topk_acc(logits, labels, k))


def test_infer_cuda_request_without_cuda_raises(paired, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        infer.main(PORT_FLAGS + ["--checkpoint", str(tmp_path / "none.pt"),
                                 "--manifest", paired[1]])


def test_serving_checkpoint_rejects_other_files(tmp_path):
    torch.save({"cxr": {}}, tmp_path / "bad.pt")
    with pytest.raises(ValueError, match="cxr/enh/fus"):
        checkpoint.load_serving(str(tmp_path / "bad.pt"))


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import mfvit_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "mfvit_tpu_torch.__path__, 'mfvit_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert len(mods) > 30, mods\n"
        "assert 'mfvit_tpu_torch.cli.finetune' in mods, mods\n"
        "assert 'mfvit_tpu_torch.train.optim' in mods, mods\n"
        "assert 'mfvit_tpu_torch.cli.pretrain' in mods, mods\n"
        "assert 'mfvit_tpu_torch.ssl.moco' in mods, mods\n"
        "assert 'mfvit_tpu_torch.tools.e2e_workflow' in mods, mods\n"
        "assert 'mfvit_tpu_torch.models.gpt_fusion' in mods, mods\n"
        "assert 'mfvit_tpu_torch.models.crossvit_cnn' in mods, mods\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('mfvit_tpu.') or m == 'mfvit_tpu']\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
