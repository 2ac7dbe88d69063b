"""The MoCo and data tools of the port's ``tools/`` (``profile_moco``,
``bench_train_loop``, ``aug_order_study``) on the CPU, where they run the
plain versions, against the JAX tools' own functions.

The JAX side is ``tools/profile_moco.py`` and ``tools/aug_order_study.py``
as they are, read by ``_torch_tools_jax.load``: ``profile_moco``'s
pieces (``fwd_q``, ``fwd_k``, ``qloss``, the EMA's lambda, ``einsum_body``,
``enqueue_body``) with its module-level ``tx``, ``fixed_k``, ``gp0``,
``q_fixed``, ``queue_c`` and ``keys_t``, on an injected tiny state
(vit_test's 32 px, patch 16, depth 2, 2 heads at width 48; the MoCo heads
of ``test_torch_port_moco.py``) and ``DT = float32``; ``aug_order_study``'s
``make_img`` and the argument list of its ``finetune.main`` call. The
port's MoCo takes JAX's state through ``moco_state_from_jax``.

Tolerances (fp32): the query and key embeddings (unit rows) within atol
1e-5; the InfoNCE value and the queue cross-entropy within rtol 1e-5 (the
MoCo tests' loss bar); each gradient within 1e-4 of its largest entry
(sums in another order; the stop-grad patch weight's is 0 on both
sides), but the entries whose gradient is zero in exact arithmetic (the
key third of each qkv bias, the encoder's final LayerNorm bias), which
are rounding noise below 1e-6 on both sides; the EMA within rtol 1e-6,
atol 1e-7 (one fp32 multiply-add, (1 - m) rounded either way); the enqueued queue and
pointer exact. The image set is JAX's bit for bit, the argument list
JAX's plus ``--device``."""
import ast
import functools
import json
import math
import os

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfvit_tpu.data import manifest as jmf
from mfvit_tpu.nn import vit as jvit
from mfvit_tpu.ssl import moco as jmoco
from mfvit_tpu_torch.exp import checkpoint
from mfvit_tpu_torch.nn import vit
from mfvit_tpu_torch.ssl import moco
from mfvit_tpu_torch.tools import (aug_order_study, bench_train_loop, card,
                                   profile_moco)

from _torch_tools_jax import assigns, calls, expr, load, parse

TINY = dict(img_size=32, patch=16, dim=48, depth=2, heads=2)
JCFG = jvit.ViTConfig("vit_test", **TINY)
PCFG = vit.ViTConfig("vit_test", **TINY)
MOCO = dict(dim=8, mlp_dim=16, K=32, T=0.2)
B = 4
D = TINY["dim"]
ZERO_GRAD = 1e-6  # rounding noise of a gradient zero in exact arithmetic


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def moco_pieces():
    """(JAX's namespace of the tool, the state, the port's ``Pieces`` on
    the same state, images and fixed rows)."""
    jm = jmoco.MoCoConfig(**MOCO)
    state = _np(jmoco.init(jax.random.PRNGKey(0), jm, JCFG))
    ns = load("profile_moco.py",
              defs={"fwd_q", "fwd_k", "qloss", "einsum_body",
                    "enqueue_body"},
              stmts=assigns("tx", "fixed_k", "gp0", "q_fixed", "queue_c",
                            "keys_t"),
              inject={"B": B, "cfg": JCFG, "mcfg": jm, "DT": jnp.float32,
                      "state": state, "m": jnp.float32(0.99)})
    pm = moco.MoCoConfig(**MOCO)
    model = moco.MoCo(pm, PCFG)
    model.load_state_dict(checkpoint.moco_state_from_jax(state, pm, PCFG),
                          strict=True)
    pc = profile_moco.Pieces("cpu", B, cfg=PCFG, mcfg=pm, dt=torch.float32,
                             model=model)
    rng = np.random.default_rng(7)
    imq, imk = (rng.standard_normal((B, 32, 32, 3)).astype(np.float32)
                for _ in range(2))
    pc.imq, pc.imk = torch.from_numpy(imq), torch.from_numpy(imk)
    pc.fixed_k = torch.from_numpy(np.array(ns["fixed_k"]))
    pc.q_fixed = torch.from_numpy(np.array(ns["q_fixed"]))
    return ns, state, pc, imq, imk


@pytest.mark.parametrize("piece", ["fwd_q", "fwd_k"])
def test_profile_moco_forwards_match_jax(moco_pieces, piece):
    ns, _, pc, imq, imk = moco_pieces
    want = np.asarray(ns[piece](jnp.asarray(imq if piece == "fwd_q"
                                            else imk)))
    got = getattr(pc, piece)()
    assert got.shape == (B, MOCO["dim"])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_profile_moco_qloss_and_gradients_match_jax(moco_pieces):
    ns, state, pc, imq, _ = moco_pieces
    loss, grads = jax.jit(jax.value_and_grad(ns["qloss"]))(
        ns["gp0"], jnp.asarray(imq), jnp.asarray(state["queue"]))
    tree = {"base": {"encoder": grads["enc"], "projector": grads["proj"]},
            "predictor": grads["pred"]}
    want = checkpoint.moco_moments_from_jax(_np(tree), pc.mcfg, PCFG)
    ploss, pgrads = pc.loss_and_grads()
    np.testing.assert_allclose(ploss.item(), float(loss), rtol=1e-5)
    names = [n for n, _ in pc.model.trainable()]
    assert len(names) == len(pgrads)
    for name, g in zip(names, pgrads):
        w = want[name].numpy()
        g = np.zeros_like(w) if g is None else g.numpy()
        if name.endswith("attn.qkv.bias") or name == "base.encoder.norm.bias":
            # zero in exact arithmetic: the key third of the qkv bias (the
            # softmax is shift-invariant along the keys), the final LN
            # bias (ahead of the projector's BatchNorm); rounding noise
            zero = (np.s_[D:2 * D] if name.endswith("qkv.bias")
                    else np.s_[:])
            for a in (g, w):
                assert np.abs(a[zero]).max() < ZERO_GRAD, name
                a[zero] = 0.0
        scale = np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)
    patch = names.index("base.encoder.patch_embed.proj.weight")
    assert not pgrads[patch].any()  # stop-grad conv1
    fwd_bwd = pc.fwd_bwd()
    np.testing.assert_allclose(fwd_bwd.item(), float(loss), rtol=1e-5)


def test_profile_moco_ema_matches_jax(moco_pieces):
    """The port's ``ema`` piece against the lambda JAX chains (:171-174),
    at its first iteration (m exactly 0.99)."""
    ns, state, _, _, _ = moco_pieces
    call = next(c for c in calls(parse("profile_moco.py"), "chained")
                if c.args[0].value == "ema")
    body = expr(call.args[1], ns)
    new = _np(body(jnp.int32(0), jax.tree.map(jnp.asarray,
                                              state["momentum"])))
    pm = moco.MoCoConfig(**MOCO)
    model = moco.MoCo(pm, PCFG)
    model.load_state_dict(checkpoint.moco_state_from_jax(state, pm, PCFG),
                          strict=True)
    pc = profile_moco.Pieces("cpu", B, cfg=PCFG, mcfg=pm, dt=torch.float32,
                             model=model)
    pc.ema()
    want = checkpoint.moco_state_from_jax(dict(state, momentum=new), pm,
                                          PCFG)
    moved = 0
    for k, v in model.state_dict().items():
        if k.startswith("momentum.") and v.is_floating_point():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
            moved += int(not torch.equal(
                v, checkpoint.moco_state_from_jax(state, pm, PCFG)[k]))
    assert moved


def test_profile_moco_queue_pieces_match_jax(moco_pieces):
    """``einsum`` (:182-187) and ``enqueue`` (:196-199)."""
    ns, state, pc, _, _ = moco_pieces
    want = float(ns["einsum_body"](0, jnp.zeros(())))
    got = profile_moco.queue_ce(pc.q_fixed, pc.fixed_k, pc.model.queue,
                                MOCO["T"])
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)
    assert pc.einsum().item() == got.item()
    queue, ptr = ns["enqueue_body"](0, (jnp.asarray(state["queue"]),
                                        jnp.zeros((), jnp.int32)))
    before = pc.model.queue.clone()
    pc.enqueue()
    np.testing.assert_array_equal(pc.model.queue.numpy(), np.asarray(queue))
    assert int(pc.model.queue_ptr) == int(ptr) == B
    assert not torch.equal(pc.model.queue, before)


def test_profile_moco_main_runs_small(monkeypatch, capsys):
    pm = moco.MoCoConfig(**MOCO)
    monkeypatch.setattr(profile_moco, "run", functools.partial(
        profile_moco.run, iters=2, warmup=1, r=3, r_short=2,
        pieces=profile_moco.Pieces("cpu", 2, cfg=PCFG, mcfg=pm,
                                   dt=torch.float32)))
    res = profile_moco.main(["2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.splitlines()[0] == card.CPU_NOTE
    assert tuple(res) == (profile_moco.LAGGED + profile_moco.CHAINED
                          + ("bound",))
    assert all(math.isfinite(v) and v > 0 for v in res.values())
    assert "structural bound" in out


def test_bench_train_loop_main_runs_small(monkeypatch, capsys):
    """All five feeds reach their steps; the store's fill is timed."""
    monkeypatch.setattr(bench_train_loop, "run", functools.partial(
        bench_train_loop.run, n_imgs=8, batch=4, n_steps=4, cfg=PCFG,
        hw=(36, 40), workers=2))
    res = bench_train_loop.main(["--device", "cpu"])
    assert tuple(res) == bench_train_loop.FEEDS[:3] + ("fill_s",) + \
        bench_train_loop.FEEDS[3:]
    assert all(math.isfinite(v) and v > 0 for v in res.values())


# ------------------------------------------------------- aug-order study

def test_aug_study_images_are_jax_bit_for_bit(tmp_path):
    """``make_img`` on ``default_rng(0)`` draw for draw, the written PNGs
    and the three manifests JAX's ``write_covid_manifest`` would write."""
    ns = load("aug_order_study.py", defs={"make_img"})
    jr, pr = np.random.default_rng(0), np.random.default_rng(0)
    want = [ns["make_img"](i % 3, jr) for i in range(aug_order_study.N)]
    got = [aug_order_study.make_img(i % 3, pr) for i in range(
        aug_order_study.N)]
    for w, g in zip(want, got):
        assert g.dtype == np.uint8 and np.array_equal(w, g)
    root = str(tmp_path)
    aug_order_study.write_set(root)
    for i in (0, 1, 2, 143):
        img = cv2.imread(f"{root}/images/data/img_{i}.png", cv2.IMREAD_COLOR)
        assert np.array_equal(img, want[i])
    names = [f"img_{i}.png" for i in range(144)]
    labels = [i % 3 for i in range(144)]
    for man, sl in (("1_labeled_train_0.txt", slice(0, 96)),
                    ("val_ds.txt", slice(96, 120)),
                    ("test_ds.txt", slice(120, 144))):
        jmf.write_covid_manifest(str(tmp_path / man), f"{root}/images",
                                 names[sl], labels[sl])
        assert open(f"{root}/cds/{man}").read() == \
            open(tmp_path / man).read()


def test_aug_study_argv_is_jax_plus_device():
    tree = parse("aug_order_study.py")
    (call,) = calls(tree, "finetune.main")
    (out,) = [n for n in ast.walk(tree) if isinstance(n, ast.Assign)
              and getattr(n.targets[0], "id", None) == "out"]
    for mode in aug_order_study.MODES:
        for seed in (0, 2):
            ns = {"root": "/r", "mode": mode, "seed": seed}
            ns["out"] = expr(out.value, ns)
            want = expr(call.args[0], ns)
            got = aug_order_study.finetune_argv("/r", mode, seed, "cpu")
            assert got == want + ["--device", "cpu"]


def test_aug_study_runs_one_seed_at_two_epochs(monkeypatch, tmp_path,
                                               capsys):
    monkeypatch.setattr(aug_order_study, "EPOCHS", 2)
    monkeypatch.setenv("AUG_STUDY_SEEDS", "1")
    res = aug_order_study.main([str(tmp_path), "--device", "cpu"])
    assert tuple(res) == aug_order_study.MODES
    for mode, r in res.items():
        assert sorted(r) == ["acc_mean", "acc_std", "auc_mean", "auc_std",
                             "per_seed"]
        assert [d["seed"] for d in r["per_seed"]] == [0]
        assert math.isfinite(r["auc_mean"]) and 0 <= r["acc_mean"] <= 1
    with open(tmp_path / "aug_order_study.json") as f:
        assert json.load(f) == res
    assert os.path.isdir(tmp_path / "exp_aug-host_0")
