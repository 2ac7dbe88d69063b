"""The port's multi-process data parallelism on the CPU (gloo ranks, fp32,
the kernels' plain versions, vit_test-size models) against the JAX
package's device mesh and against the port's one-process run.

- Two ranks of ``make_classifier_steps`` (3 SGD steps, global batch 16)
  equal JAX's steps on ``pmesh.make_mesh(2)`` and the port's one-process
  steps within ``tests/test_parallel.py:112-114``'s rtol 2e-5 / atol 2e-6,
  the two ranks' parameters equal bit for bit.
- Two ranks of the MoCo v2-queue and v3-symmetric steps (2 SGD steps,
  global batch 8) on the ConvStem tiny config and a ResNet-18 arm at 32 px
  equal ``pmesh.make_moco_parallel_step`` on a 2-device mesh within
  :182-186's rtol 4e-4 / atol 2e-6 (loss, parameters, BatchNorm running
  statistics and queue; ``queue_ptr`` exact), widened for each tensor by
  twice the distance between JAX's own one-device and two-device steps
  (the BatchNorms over 4-8 images magnify fp32 rounding: a ResNet-18's
  stem weight ends 4.7e-4 apart between JAX's two runs), or, where a
  ReLU or max-pool tie flips under rounding, the tensor's update within
  1e-2 relative Frobenius error (``_hold_moco_entry``); the ranks
  bit-equal.
- ``BatchLoader``'s process slices and the sharded store's per-rank index
  batches equal the one-process batches and JAX's ``_iter_sharded``.
- ``finetune``, ``fuse`` and ``pretrain`` under ``--mesh-devices 2
  --device cpu``: rank 0 alone writes the experiment folder, both ranks
  return the same results, and ``results.json`` equals a one-process run
  of the same seed within the first tolerance; ``pretrain --resume`` under
  two ranks continues its run bit for bit; TensorBoard scalars and
  ``lr.jpg``; ``infer --mesh-devices 2`` equals N=1 bit for bit.
- The refusals.

Spawned ranks take a fresh port per attempt, one thread each, a timeout
of their own, and fail with their output."""
import json
import os
import shlex
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfvit_tpu.data import device_store as jstore
from mfvit_tpu.nn import resnet as jresnet
from mfvit_tpu.nn import vit as jvit
from mfvit_tpu.parallel import mesh as pmesh
from mfvit_tpu.ssl import moco as jmoco
from mfvit_tpu.train import optim as joptim
from mfvit_tpu.train import steps as jsteps
from mfvit_tpu_torch.cli import common, finetune, fuse, infer, pretrain
from mfvit_tpu_torch.data import device_store, manifest, pipeline
from mfvit_tpu_torch.exp import checkpoint
from mfvit_tpu_torch.models import fusion
from mfvit_tpu_torch.nn import resnet, vit
from mfvit_tpu_torch.ssl import moco
from mfvit_tpu_torch.train import optim, steps

HERE = Path(__file__).parent
REPO = HERE.parent
TINY = dict(img_size=32, patch=16, dim=32, depth=2, heads=2)
TINY_CONV = dict(TINY, conv_stem=True, qkv_bias=False)
MOCO = dict(dim=8, mlp_dim=16, K=32, T=0.2)
STEP_TOL = dict(rtol=2e-5, atol=2e-6)  # tests/test_parallel.py:112-114
MOCO_TOL = dict(rtol=4e-4, atol=2e-6)  # tests/test_parallel.py:182-186
CLASSIFIER_LR, MOCO_LR = 0.05, 0.1
MOCO_CASES = {"conv_v2": ("conv", "v2_queue"),
              "conv_v3": ("conv", "v3_symmetric"),
              "resnet18_v2": ("resnet18", "v2_queue"),
              "resnet18_v3": ("resnet18", "v3_symmetric")}


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO), str(HERE)]))
    for k in ("XLA_FLAGS", "JAX_PLATFORMS"):
        env.pop(k, None)
    return env


class _Run:
    """A command in the background with a timeout of its own: ``output()``
    waits, retries once after a timeout (the command picks a fresh port),
    and fails the test with the command's output."""

    def __init__(self, argv, timeout: float, retries: int = 1):
        self.argv, self.timeout, self.retries = argv, timeout, retries
        self.text = None
        self._start()

    def _start(self):
        self.log = tempfile.TemporaryFile(mode="w+")
        self.proc = subprocess.Popen(self.argv, stdout=self.log,
                                     stderr=subprocess.STDOUT, text=True,
                                     env=_env(), cwd=str(REPO))
        self.t0 = time.monotonic()

    def _read(self) -> str:
        self.log.seek(0)
        return self.log.read()

    def output(self) -> str:
        while self.text is None:
            left = self.timeout - (time.monotonic() - self.t0)
            try:
                rc = self.proc.wait(timeout=max(left, 1))
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
                if self.retries:
                    self.retries -= 1
                    self._start()
                    continue
                pytest.fail(f"{' '.join(self.argv)} timed out after "
                            f"{self.timeout} s:\n{self._read()}")
            if rc != 0:
                pytest.fail(f"{' '.join(self.argv)} exited {rc}:\n"
                            f"{self._read()}")
            self.text = self._read()
        return self.text


def _spawn_ranks(root, n: int = 2, timeout: float = 150,
                 retries: int = 1) -> list:
    """``tests/_torch_ddp_worker.py`` on n ranks over a fresh port; their
    outputs. A timeout is retried once, then fails with the outputs."""
    outs = []
    for _ in range(retries + 1):
        with __import__("socket").socket() as s:
            s.bind(("127.0.0.1", 0))
            addr = f"127.0.0.1:{s.getsockname()[1]}"
        runs = [_Run([sys.executable, str(HERE / "_torch_ddp_worker.py"),
                      str(r), str(n), addr, str(root)], timeout, retries=0)
                for r in range(n)]
        try:
            return [run.output() for run in runs]
        except pytest.fail.Exception as e:
            outs.append(str(e))
            for run in runs:
                run.proc.kill()
            if "timed out" not in str(e):
                raise
    pytest.fail("the two ranks timed out twice:\n" + "\n".join(outs))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_vit_cfg(jcfg):
    return vit.ViTConfig(**{f: getattr(jcfg, f) for f in
                            vit.ViTConfig.__dataclass_fields__})


# --------------------------------------------------------- the step runs

def _moco_case(name):
    arm, loss = MOCO_CASES[name]
    if arm == "conv":
        jb = jvit.ViTConfig("tiny_conv", **TINY_CONV)
        jm = jmoco.MoCoConfig(loss=loss, **MOCO)
        pb, backbone = _port_vit_cfg(jb), ("vit", dict(name="tiny_conv",
                                                       **TINY_CONV))
    else:
        jb = jresnet.get_config(arm)
        jm = jmoco.MoCoConfig.resnet(loss=loss, **MOCO)
        pb, backbone = resnet.get_config(arm), ("resnet", arm)
    pm = moco.MoCoConfig(**{f: getattr(jm, f) for f in
                            moco.MoCoConfig.__dataclass_fields__})
    return jm, jb, pm, pb, backbone


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    """The scenarios' JAX states and global batches, and the two ranks'
    results: (scenarios, [rank 0, rank 1])."""
    root = tmp_path_factory.mktemp("ddp_steps")
    rng = np.random.default_rng(0)
    jcfg = jvit.ViTConfig("tiny", **TINY)
    params = jvit.init(jax.random.PRNGKey(0), jcfg, num_classes=3)
    scen = {"classifier": dict(
        kind="classifier", cfg=dict(name="tiny", **TINY), classes=3,
        lr=CLASSIFIER_LR, steps=3, jax=_np(params),
        state=checkpoint.vit_state_from_jax(_np(params), _port_vit_cfg(jcfg)),
        imgs=rng.standard_normal((16, 32, 32, 3)).astype(np.float32),
        labels=np.arange(16) % 3)}
    for i, name in enumerate(MOCO_CASES):
        jm, jb, pm, pb, backbone = _moco_case(name)
        state = jmoco.init(jax.random.PRNGKey(i + 1), jm, jb)
        scen[name] = dict(
            kind="moco", moco=dataclass_dict(pm), backbone=backbone,
            lr=MOCO_LR, m=0.99, jax=_np(state),
            state=checkpoint.moco_state_from_jax(_np(state), pm, pb),
            q=rng.standard_normal((2, 8, 32, 32, 3)).astype(np.float32),
            k=rng.standard_normal((2, 8, 32, 32, 3)).astype(np.float32))
    torch.save({k: {f: v for f, v in sc.items() if f != "jax"}
                for k, sc in scen.items()}, root / "scenarios.pt")
    outs = _spawn_ranks(root)
    for r, out in enumerate(outs):
        assert f"RANK {r} DONE" in out, out
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    return scen, ranks


def dataclass_dict(cfg) -> dict:
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


def _ranks_equal(ranks, name):
    a, b = (r[name]["state"] for r in ranks)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), f"{name}: ranks differ at {k}"
    assert ranks[0][name]["losses"] == ranks[1][name]["losses"]


def test_two_rank_classifier_steps_match_jax_mesh_and_one_process(step_runs):
    scen, ranks = step_runs
    sc = scen["classifier"]
    _ranks_equal(ranks, "classifier")
    got = ranks[0]["classifier"]

    # JAX: replicated parameters, the batch sharded over a 2-device mesh
    jcfg = jvit.ViTConfig("tiny", **TINY)
    tx = joptim.build_optimizer("sgd", CLASSIFIER_LR)
    train_step, _ = jsteps.make_classifier_steps(
        jcfg, tx, compute_dtype=jnp.float32, attn_backend="xla")
    mesh = pmesh.make_mesh(2)
    p = pmesh.replicate(jax.tree.map(jnp.asarray, sc["jax"]), mesh)
    s = pmesh.replicate(tx.init(jax.tree.map(jnp.asarray, sc["jax"])), mesh)
    imgs = pmesh.shard_batch(jnp.asarray(sc["imgs"]), mesh)
    labels = pmesh.shard_batch(jnp.asarray(sc["labels"]), mesh)
    jlosses = []
    for _ in range(3):
        p, s, loss, _ = train_step(p, s, imgs, labels)
        jlosses.append(float(loss))
    want = checkpoint.vit_state_from_jax(_np(p), _port_vit_cfg(jcfg))

    # the port in one process on the whole global batch
    model = vit.ViT(_port_vit_cfg(jcfg), 3)
    model.load_state_dict(sc["state"])
    opt = optim.build_optimizer("sgd", model.named_parameters(),
                                CLASSIFIER_LR)
    pstep, _ = steps.make_classifier_steps(compute_dtype=torch.float32)
    one = [pstep(model, opt, torch.from_numpy(sc["imgs"]),
                 torch.from_numpy(sc["labels"]))[0].item()
           for _ in range(3)]

    np.testing.assert_allclose(got["losses"], jlosses, **STEP_TOL)
    np.testing.assert_allclose(got["losses"], one, **STEP_TOL)
    for k, v in got["state"].items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                   err_msg=k, **STEP_TOL)
        np.testing.assert_allclose(v.numpy(), model.state_dict()[k].numpy(),
                                   err_msg=k, **STEP_TOL)


def _jax_moco(sc, jm, jb, pm, pb, n: int):
    """JAX's MoCo steps on the scenario's batches, on one device or a mesh
    of ``n``: (the port's state dict of the end state, the losses)."""
    tx = joptim.build_optimizer("sgd", MOCO_LR)
    state = jax.tree.map(jnp.asarray, sc["jax"])
    opt_state = tx.init({"base": state["base"],
                         "predictor": state["predictor"]})
    if n == 1:
        step = jax.jit(jmoco.make_pretrain_step(
            jm, jb, tx, compute_dtype=jnp.float32, attn_backend="xla"))
        put = jnp.asarray
    else:
        mesh = pmesh.make_mesh(n)
        step = pmesh.make_moco_parallel_step(jm, jb, tx, mesh,
                                             compute_dtype=jnp.float32,
                                             attn_backend="xla")
        state = pmesh.replicate(state, mesh)
        opt_state = pmesh.replicate(opt_state, mesh)

        def put(x):
            return pmesh.shard_batch(jnp.asarray(x), mesh)
    losses = []
    for q, k in zip(sc["q"], sc["k"]):
        state, opt_state, loss = step(state, opt_state, put(q), put(k),
                                      jnp.float32(sc["m"]))
        losses.append(float(loss))
    return checkpoint.moco_state_from_jax(_np(state), pm, pb), losses


def _hold_moco_entry(k, got, want, one, init):
    """``got`` within MOCO_TOL of JAX's mesh ``want``, atol widened by twice
    JAX's own one-device-to-mesh distance (``one``); else the tensor's
    update from ``init`` within 1e-2 relative Frobenius error of JAX's, or
    twice JAX's own. A ReLU or max-pool decision near a tie flips under
    rounding: 1e-6 of relative noise on the input moves a ResNet-18
    layer3 gradient by up to 4% (measured on the CPU, one process)."""
    spread = (one - want).abs().max().item()
    if np.allclose(got.numpy(), want.numpy(), rtol=MOCO_TOL["rtol"],
                   atol=MOCO_TOL["atol"] + 2 * spread):
        return
    upd = (want - init).norm().item()
    rel = (got - want).norm().item() / upd
    own = (one - want).norm().item() / upd
    assert rel <= max(1e-2, 2 * own), (k, rel, own)


@pytest.mark.parametrize("name", list(MOCO_CASES))
def test_two_rank_moco_steps_match_jax_mesh(step_runs, name):
    """The keys all-gathered into the queue, v3's rank-offset positives,
    the BatchNorms of the heads, the ConvStem and the ResNet arm on the
    global batch's statistics, the loss and gradients averaged."""
    scen, ranks = step_runs
    sc = scen[name]
    _ranks_equal(ranks, name)
    got = ranks[0][name]
    jm, jb, pm, pb, _ = _moco_case(name)
    want, jlosses = _jax_moco(sc, jm, jb, pm, pb, 2)
    one, _ = _jax_moco(sc, jm, jb, pm, pb, 1)
    np.testing.assert_allclose(got["losses"], jlosses, **MOCO_TOL)
    assert set(got["state"]) == set(want)
    for k, v in got["state"].items():
        if k == "queue_ptr" or k.endswith("num_batches_tracked"):
            assert torch.equal(v, want[k]), k
        else:
            _hold_moco_entry(k, v, want[k], one[k], sc["state"][k])
    if jm.loss == "v2_queue":
        assert int(got["state"]["queue_ptr"]) == 16  # two global batches


def test_ranks_refuse_what_jax_refuses(step_runs):
    """Under a group of two: --mesh-devices 3, a global batch of 9, and a
    queue of 12 behind a global key batch of 8 (4 a rank)."""
    _, ranks = step_runs
    for r in ranks:
        ref = r["refusals"]
        assert "--mesh-devices 3 under 2 processes" in ref["mesh_devices"]
        assert "global batch 9 not divisible" in ref["batch"]
        assert "K=12 must be divisible by the global key batch (8)" \
            in ref["queue"]


# ----------------------------------------------------- the data on ranks

class _Rows:
    """Row i: a (2, 2, 3) uint8 canvas holding i, and the label i."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((2, 2, 3), i, np.uint8), i


def test_batchloader_process_slices_reassemble_global_batch():
    ds = _Rows(21)
    kw = dict(shuffle=True, seed=3, drop_last=True, num_workers=1)
    whole = pipeline.BatchLoader(ds, 8, **kw)
    parts = [pipeline.BatchLoader(ds, 8, process_index=p, process_count=2,
                                  **kw) for p in range(2)]
    for loader in [whole] + parts:
        loader.set_epoch(5)
    n = 0
    for gbatch, b0, b1 in zip(iter(whole), *map(iter, parts)):
        for gf, f0, f1 in zip(gbatch, b0, b1):
            np.testing.assert_array_equal(gf, np.concatenate([f0, f1]))
        n += 1
    assert n == len(whole) == 2
    # eval loaders: the padded last batch splits the same way
    ev = [pipeline.BatchLoader(ds, 8, process_index=p, process_count=2,
                               num_workers=1) for p in range(2)]
    full = list(pipeline.BatchLoader(ds, 8, num_workers=1))
    for gbatch, b0, b1 in zip(full, *map(iter, ev)):
        np.testing.assert_array_equal(gbatch[1], np.concatenate([b0[1],
                                                                 b1[1]]))
    with pytest.raises(ValueError, match="not divisible by process_count"):
        pipeline.BatchLoader(ds, 9, process_count=2)


@pytest.mark.parametrize("n,drop_last", [(10, True), (11, True),
                                         (11, False), (5, False)])
def test_sharded_store_index_batches_match_jax(n, drop_last):
    """Each rank's local index vectors for two epochs equal the local
    indices JAX's ``_iter_sharded`` gathers on a 2-device mesh (an odd
    split wrap-padded, a short last batch wrap-tiled)."""
    bs, seed = 4, 7
    mesh = pmesh.make_mesh(2)
    js = jstore.fill_from_dataset(_Rows(n), batch_size=bs, seed=seed,
                                  num_workers=1, drop_last=drop_last,
                                  mesh=mesh)
    ps = [device_store.fill_from_dataset(
        _Rows(n), batch_size=bs, device="cpu", seed=seed, num_workers=1,
        drop_last=drop_last, world=2, rank=r) for r in range(2)]
    assert all(len(p) == len(js) for p in ps)
    m = ps[0].m
    for epoch in (0, 1):
        js.set_epoch(epoch)
        jbatches = [np.asarray(b[-1]) for b in js]
        for r, p in enumerate(ps):
            block = list(p.labels.numpy())  # this rank's rows, in order
            assert block == [i % n for i in range(r * m, (r + 1) * m)]
            got = p.index_batches(epoch)
            want = [[block.index(lab) for lab in b[r * 2:(r + 1) * 2]]
                    for b in jbatches]
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.dtype == np.int32
                np.testing.assert_array_equal(g, w)


def test_store_bytes_charge_each_rank_its_block():
    """``_store_nbytes`` charges a rank its wrap-padded block only
    (``mfvit_tpu/cli/common.py:214-229``)."""
    row = 8 * 8 * 3 + 8
    assert common._store_nbytes(11, 8, 3) == 11 * row
    assert common._store_nbytes(11, 8, 3, 2) == 6 * row
    assert common._store_nbytes(12, 8, 3, 4) == 3 * row


# ------------------------------------------------------------ the CLIs

@pytest.fixture(scope="module")
def covid(tmp_path_factory):
    """34 images over 3 classes with a weak class signal (16 train, 9 val,
    9 test: eval spans two batches of 8 with a padded tail)."""
    root = tmp_path_factory.mktemp("ddp_covid")
    data_root, man_root = root / "images", root / "create_covid_dataset"
    os.makedirs(man_root)
    rng = np.random.default_rng(0)
    for folder in ("data", "Train_Mix"):
        os.makedirs(data_root / folder)
    names, labels = [], []
    for i in range(34):
        fn, label = f"img_{i}.png", i % 3
        for folder in ("data", "Train_Mix"):
            img = rng.integers(0, 255, (40, 40, 3), np.uint8)
            img[:, :, 0] = np.clip(img[:, :, 0] * 0.9 + label * 12, 0, 255)
            cv2.imwrite(str(data_root / folder / fn), img)
        names.append(fn)
        labels.append(label)
    for fname, sl in (("1_labeled_train_0.txt", slice(0, 16)),
                      ("val_ds.txt", slice(16, 25)),
                      ("test_ds.txt", slice(25, 34))):
        manifest.write_covid_manifest(str(man_root / fname), str(data_root),
                                      names[sl], labels[sl])
    return man_root


COMMON = ["-a", "vit_test", "--compute-dtype", "float32", "-j", "2",
          "--seed", "0", "-b", "8", "--epochs", "2", "--semi-ratios", "1",
          "-p", "1", "--device", "cpu"]
STREAM = ["--img-size", "32", "--crop", "32", "--device-store-mb", "0"]
CLIS = {
    "finetune": COMMON + STREAM + ["--semi-supervised", "--cos",
                                   "--lr", "0.1"],
    "fuse": COMMON + STREAM + ["--semi-supervised", "--fusion-heads", "2"],
    "pretrain": COMMON + STREAM + ["--moco-dim", "8", "--moco-mlp-dim", "16",
                                   "--moco-k", "32", "--cos",
                                   "--warmup-epochs", "1", "--lr", "0.1"],
}
# pretrain on the sharded store (40 px canvases, 32 px crops), then resumed
STORE_PRETRAIN = COMMON + ["--img-size", "40", "--crop", "32", "--moco-dim",
                           "8", "--moco-mlp-dim", "16", "--moco-k", "32",
                           "--cos", "--warmup-epochs", "1", "--lr", "0.1",
                           "--save-epoch", "1"]
MODULES = {"finetune": finetune, "fuse": fuse, "pretrain": pretrain}


def _cli(module, argv, timeout=240):
    return _Run([sys.executable, "-m", f"mfvit_tpu_torch.cli.{module}"]
                + argv, timeout)


@pytest.fixture(scope="module", autouse=True)
def cli_runs(covid, tmp_path_factory):
    """Each CLI under --mesh-devices 2 in a process of its own, all
    started at once when the module starts (they run beside the step
    tests): {name: (storage root, run)}."""
    root = tmp_path_factory.mktemp("ddp_cli")
    ds = ["--covid-ds", str(covid)]
    runs = {}
    for name, argv in CLIS.items():
        runs[name] = (root / name, _cli(name, argv + ds + [
            "--mesh-devices", "2", "--storage-root", str(root / name)]))
    # on the store, then resumed from its first checkpoint, in turn
    cmd = [sys.executable, "-m", "mfvit_tpu_torch.cli.pretrain",
           *STORE_PRETRAIN, *ds, "--mesh-devices", "2", "--storage-root"]
    first = shlex.join(cmd + [str(root / "store")])
    resumed = shlex.join(cmd + [str(root / "resumed"), "--resume"])
    ck = shlex.quote(str(root / "store")) + "/*/train_1_0/checkpoint_0000"
    runs["store"] = (root, _Run(["sh", "-c", f"{first} && echo RESUMING && "
                                 f"{resumed} $(ls -d {ck})"], 300,
                                retries=0))
    return runs


def _exp(storage_root: Path) -> Path:
    (exp,) = storage_root.iterdir()  # one experiment folder
    return exp


def _files(exp: Path) -> set:
    """The experiment folder's entries, the TensorBoard event files by
    their folder (their names hold the host and the time)."""
    return {str(p.relative_to(exp).parent if "tfevents" in p.name
                else p.relative_to(exp)) for p in exp.rglob("*")}


def _hold_results(got, want):
    assert len(got) == len(want) == 1
    g, w = got[0], want[0]
    assert set(g) == set(w)
    for k in g:
        np.testing.assert_allclose(np.asarray(g[k], float),
                                   np.asarray(w[k], float), err_msg=k,
                                   **STEP_TOL)


@pytest.mark.parametrize("name", list(CLIS))
def test_cli_two_ranks_match_one_process(cli_runs, covid, tmp_path, name):
    """``--mesh-devices 2 --device cpu``: both ranks return the same
    results (the parent checks and says so), rank 0 alone writes one
    experiment folder with the one-process run's files, and its
    results.json equals the one-process run's."""
    storage_root, run = cli_runs[name]
    out = run.output()
    assert "=> 2 ranks returned the same results" in out
    exp = _exp(storage_root)
    one = MODULES[name].main(CLIS[name] + [
        "--covid-ds", str(covid), "--storage-root", str(tmp_path)])
    exp1 = _exp(tmp_path)
    assert _files(exp) == _files(exp1)
    _hold_results(json.loads((exp / "results.json").read_text()),
                  json.loads((exp1 / "results.json").read_text()))
    assert one[0].draw == 0
    if name != "pretrain":
        assert np.isfinite(one[0].test_auc)


def _scalars(folder: Path) -> dict:
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)
    acc = EventAccumulator(str(folder))
    acc.Reload()
    return {tag: [e.value for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def test_tensorboard_and_lr_jpg_on_rank_zero(cli_runs):
    """finetune's train/val/test scalars and lr.jpg, fuse's train/val
    scalars, pretrain's loss every --print-freq step, one event file each
    (rank 0's)."""
    tags = {"finetune": {"train/loss", "val/auc", "val/acc", "val/loss",
                         "test/auc", "test/all_test_auc",
                         "test/all_test_acc"},
            "fuse": {"train/loss", "val/auc", "val/acc"},
            "pretrain": {"pretrain/loss"}}
    prefix = {"pretrain": "tb_pretrain_1_0"}
    for name, want in tags.items():
        storage_root, run = cli_runs[name]
        run.output()
        exp = _exp(storage_root)
        tb = exp / prefix.get(name, "tb_train_val_test_1_0")
        assert len(list(tb.iterdir())) == 1
        got = _scalars(tb)
        assert set(got) == want
        losses = json.loads((exp / "results.json").read_text())[0][
            "train_losses"]
        if name == "pretrain":  # -p 1: every step's loss
            np.testing.assert_allclose(got["pretrain/loss"], losses,
                                       rtol=1e-6)
        else:
            assert len(got["train/loss"]) == len(got["val/auc"]) == 2
    assert (_exp(cli_runs["finetune"][0]) / "lr.jpg").exists()
    assert not (_exp(cli_runs["fuse"][0]) / "lr.jpg").exists()


def test_pretrain_resume_under_two_ranks_on_the_sharded_store(cli_runs):
    """Two ranks on the sharded store save checkpoint_0000 and _0001; two
    ranks resumed from checkpoint_0000 run epoch 1 as the whole run did."""
    root, run = cli_runs["store"]
    first, out = run.output().split("RESUMING")
    assert "=> device canvas store: 16 samples" in first
    exp = _exp(root / "store")
    full = json.loads((exp / "results.json").read_text())[0]
    resumed_root = root / "resumed"
    assert "=> resumed from" in out and "at epoch 1" in out
    resumed = json.loads((_exp(resumed_root) / "results.json")
                         .read_text())[0]
    assert resumed["train_losses"] == full["train_losses"][2:]
    assert resumed["final_loss"] == full["final_loss"]
    a = checkpoint.load_pretrain_checkpoint(
        str(exp / "train_1_0" / "checkpoint_0001"))
    b = checkpoint.load_pretrain_checkpoint(
        str(_exp(resumed_root) / "train_1_0" / "checkpoint_0001"))
    for k, v in a["state"].items():
        assert torch.equal(v, b["state"][k]), k


def test_infer_mesh_devices_splits_rows(covid, tmp_path):
    """Two replicas, each a row block of every batch: ``split_forward``
    gives the one replica's logits of each block bit for bit, and the CLI
    the one replica's logits of the whole batch within 1e-5 (on this CPU
    MKL's fp32 GEMM of the patch embedding, K = 768, rounds differently at
    8 rows than at 16, by 4.6e-5 in sums of 768 products)."""
    cfg = vit.ViTConfig("vit_test", **{**TINY, "depth": 2})
    gen = torch.Generator().manual_seed(5)
    sds = [vit.ViT(cfg, 3, generator=gen).state_dict() for _ in range(2)]
    head = fusion.Fusion(3, cfg.dim, 2, 1, 1, generator=gen).state_dict()
    ck = str(tmp_path / "serving.pt")
    checkpoint.save_serving(ck, *sds, head)
    man = str(covid / "test_ds.txt")
    flags = ["-a", "vit_test", "--img-size", "32", "--crop", "32",
             "--compute-dtype", "float32", "--fusion-heads", "2", "-b", "4",
             "-j", "2", "--device", "cpu", "--checkpoint", ck,
             "--manifest", man]
    one = infer.main(flags + ["--output", str(tmp_path / "1.json")])
    two = infer.main(flags + ["--output", str(tmp_path / "2.json"),
                              "--mesh-devices", "2"])
    assert one["n"] == two["n"] == 9
    np.testing.assert_allclose(two["logits"], one["logits"], rtol=1e-5,
                               atol=1e-6)
    # the split itself: block i through replica i on device i, in order
    models = [{k: vit.ViT(cfg, 3) for k in ("cxr", "enh")} for _ in range(2)]
    for m in models:
        m["fus"] = fusion.Fusion(3, cfg.dim, 2, 1, 1)
        for k, sd in zip(("cxr", "enh", "fus"), (*sds, head)):
            m[k].load_state_dict(sd)
            m[k].eval()
    fwd = steps.make_fusion_forward(compute_dtype=torch.float32)

    def decision(ms, xc, xe):
        return sum(fwd(ms, xc, xe))

    xc, xe = torch.randn(2, 4, 32, 32, 3).unbind(0)
    split = infer.split_forward(decision, models, [torch.device("cpu")] * 2)
    want = torch.cat([decision(models[0], xc[:2], xe[:2]),
                      decision(models[0], xc[2:], xe[2:])])
    assert torch.equal(split(xc, xe), want)
    with pytest.raises(ValueError, match="not divisible"):
        infer.main(flags + ["--mesh-devices", "3"])


def test_cli_refusals_in_one_process(covid):
    """A global batch the ranks do not divide, and --device cuda where
    there is no card, before any rank starts."""
    argv = CLIS["finetune"] + ["--covid-ds", str(covid)]
    with pytest.raises(ValueError, match="global batch 8 not divisible"):
        finetune.main(argv + ["--mesh-devices", "3"])
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    cuda = [a if a != "cpu" else "cuda" for a in argv]
    with pytest.raises(SystemExit, match="0 CUDA devices"):
        finetune.main(cuda + ["--mesh-devices", "2"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pretrain.main(CLIS["pretrain"] + [
            "--covid-ds", str(covid), "--device", "cuda",
            "--dist-coordinator", "127.0.0.1:1", "--dist-num-processes",
            "2", "--dist-process-id", "0"])
