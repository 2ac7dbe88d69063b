"""The training-step tools of the port's ``tools/`` (``bench_train_steps``,
``bench_remat``) on the CPU, where they run the plain versions, against
the JAX tools' own setups.

The JAX side is ``tools/bench_train_steps.py`` and
``tools/bench_remat.py`` as they are, read by ``_torch_tools_jax.load``:
``bench_ft``, ``bench_fusion`` and ``bench_moco`` run with a ``timeit``
that only keeps the step and its state, ``bench_remat``'s ``tx`` and
``labels`` and the step of its loop, with the JAX modules' configs
replaced by the tiny one (vit_test's 32 px, patch 16, depth 2, 2 heads,
at width 48 so that the CA head's 3 heads divide it; the MoCo heads of
``test_torch_port_moco.py``) and ``compute_dtype=float32`` fixed. The
port's setups take the same initial trees through the weight bridges;
both sides then take one step on the same numpy batch.

Tolerances, the model tests' for these steps in fp32: the loss within
rtol 1e-5, every state entry within 1e-5 plus 1e-5 of how far the step
moved it (``test_torch_port_moco.py``), but entries whose gradient is
zero in exact arithmetic under Adam and AdamW (the key third of each
qkv bias and the like): their second moments are rounding noise (below
1e-16), which Adam divides by its own root, so they are held within twice
the LR, as ``test_torch_port_interop.py`` holds them. The step with
``remat`` equals the step without it bit for bit."""
import ast
import functools
import inspect
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfvit_tpu.models import fusion as jfusion
from mfvit_tpu.nn import vit as jvit
from mfvit_tpu.ssl import moco as jmoco
from mfvit_tpu.train import steps as jsteps
from mfvit_tpu_torch.exp import checkpoint
from mfvit_tpu_torch.nn import vit
from mfvit_tpu_torch.ssl import moco
from mfvit_tpu_torch.tools import bench_remat, bench_train_steps

from _torch_tools_jax import Proxy, assigns, expr, load, parse

TINY = dict(img_size=32, patch=16, dim=48, depth=2, heads=2)
JCFG = jvit.ViTConfig("vit_test", **TINY)
PCFG = vit.ViTConfig("vit_test", **TINY)
MOCO = dict(dim=8, mlp_dim=16, K=32)
F32 = dict(compute_dtype=jnp.float32)
B = 4
NOISE_NU = 1e-16  # Adam's second moment of a gradient of rounding noise
LR = {"ft": 0.01, "fusion": 1e-4, "fusion_lp": 1e-4, "moco": 1.5e-4,
      "vit_base": 0.01}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_setups() -> dict:
    """{setup: (jitted step, state args)} of JAX's tool at the tiny
    sizes."""
    captured = {}
    ns = load("bench_train_steps.py",
              defs={"bench_ft", "bench_fusion", "bench_moco"}, inject={
                  "timeit": lambda name, step, state, batch: captured.update(
                      {name: (step, state)}),
                  "vit": Proxy(jvit, get_config=lambda name: JCFG),
                  "fusion": Proxy(jfusion, init=functools.partial(
                      jfusion.init, dim=JCFG.dim)),
                  "steps": Proxy(
                      jsteps,
                      make_classifier_steps=functools.partial(
                          jsteps.make_classifier_steps, **F32),
                      make_fusion_steps=functools.partial(
                          jsteps.make_fusion_steps, **F32)),
                  "moco": Proxy(
                      jmoco, MoCoConfig=lambda: jmoco.MoCoConfig(**MOCO),
                      make_pretrain_step=functools.partial(
                          jmoco.make_pretrain_step, **F32))})
    ns["bench_ft"](B=B)
    ns["bench_fusion"](B=B)
    ns["bench_fusion"](B=B, freeze=True)
    ns["bench_moco"](B=B)
    return captured


@pytest.fixture(scope="module")
def jax_setups():
    return _jax_setups()


def _port_setup(name: str):
    f32 = dict(cfg=PCFG, dt=torch.float32)
    if name in ("ft", "vit_base"):
        return bench_train_steps.setup_ft("cpu", "vit_small", B, **f32)
    if name in ("fusion", "fusion_lp"):
        return bench_train_steps.setup_fusion("cpu", B, name == "fusion_lp",
                                              **f32)
    return bench_train_steps.setup_moco(
        "cpu", B, mcfg=moco.MoCoConfig(**MOCO), **f32)


def _state(name: str, tree) -> dict:
    """JAX's trainable tree (the MoCo state) as the port's state dict."""
    tree = _np(tree)
    if name == "moco":
        return checkpoint.moco_state_from_jax(
            tree, moco.MoCoConfig(**MOCO), PCFG)
    if name.startswith("fusion"):
        out = {f"fus.{k}": v for k, v in
               checkpoint.fusion_state_from_jax(tree["fus"]).items()}
        for b in ("cxr", "enh"):
            out.update({f"{b}.{k}": v for k, v in
                        checkpoint.vit_state_from_jax(tree[b], PCFG).items()})
        return out
    return checkpoint.vit_state_from_jax(tree, PCFG)


def _batch(name: str, seed: int = 5):
    rng = np.random.default_rng(seed)
    x = [rng.standard_normal((B, 32, 32, 3)).astype(np.float32)
         for _ in range(2)]
    y = rng.integers(0, 3, B)
    if name == "moco":
        return (x[0], x[1]), (x[0], x[1], 0.99)
    if name.startswith("fusion"):
        return (x[0], x[1], y), (x[0], x[1], y)
    return (x[0], y), (x[0], y)


def hold(model, want: dict, before: dict, opt, lr: float) -> None:
    noise = {}
    if opt.name.startswith("adam"):
        for n, p in zip(opt.names, opt.params()):
            noise[n] = opt.opt.state[p]["exp_avg_sq"] < NOISE_NU
    for k, v in model.state_dict().items():
        w = want[k]
        if k == "queue_ptr" or k.endswith("num_batches_tracked"):
            assert torch.equal(v, w), k
            continue
        b = before[k]
        if k in noise and noise[k].any():
            m = noise[k]
            np.testing.assert_allclose(v[m].numpy(), w[m].numpy(), rtol=0,
                                       atol=2 * lr, err_msg=k)
            v, w, b = v[~m], w[~m], b[~m]
            if not v.numel():
                continue
        moved = (w - b).abs().max().item()
        np.testing.assert_allclose(v.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 + 1e-5 * moved, err_msg=k)


@pytest.mark.parametrize("name", ["ft", "fusion", "fusion_lp", "moco"])
def test_train_step_setup_matches_jax(jax_setups, name):
    """One step of each setup from the same state and batch."""
    jstep, jstate = jax_setups["vit_small" if name == "ft" else name]
    s = _port_setup(name)
    start = _state(name, jstate[0])
    s.model.load_state_dict(start, strict=True)
    before = {k: v.clone() for k, v in s.model.state_dict().items()}
    jb, pb = _batch(name)
    out = jstep(*jstate, *(jnp.asarray(a) if isinstance(a, np.ndarray)
                           else a for a in jb))
    jloss = out[2]
    loss = s.step(s.model, s.opt, *(torch.from_numpy(a)
                                     if isinstance(a, np.ndarray) else a
                                     for a in pb))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    hold(s.model, _state(name, out[0]), before, s.opt, LR[name])
    moved = [k for k, v in s.model.state_dict().items()
             if not torch.equal(v, before[k])]
    if name == "fusion_lp":  # JAX's LP mask: the branch heads train too
        assert {k.split(".")[0] for k in moved} == {"cxr", "enh", "fus"}
        assert all(k.split(".")[0] == "fus" or k.split(".")[1] == "head"
                   for k in moved)
    else:
        assert any("blocks.0." in k for k in moved)


def _main_block(name: str) -> dict:
    """{choice: (function, args, keywords)} of the ``__main__`` block."""
    tree = parse(name)
    main = next(n for n in tree.body if isinstance(n, ast.If))
    out = {}
    for n in main.body:
        if isinstance(n, ast.If):
            call = n.body[0].value
            out[n.test.left.value] = (
                call.func.id, [expr(a, {}) for a in call.args],
                {k.arg: expr(k.value, {}) for k in call.keywords})
    return out


def test_setups_follow_the_jax_main_block(monkeypatch):
    """Each choice builds the setup that JAX's ``__main__`` block
    (:104-116) calls, with the same arguments once both sides' defaults
    are applied (the port's setups take the device first, and their
    keyword-only sizes for the tests)."""
    want = _main_block("bench_train_steps.py")
    assert tuple(want) == bench_train_steps.WHICH
    ns = load("bench_train_steps.py",
              defs={"bench_ft", "bench_fusion", "bench_moco"})
    seen = []
    for fn in ("setup_ft", "setup_fusion", "setup_moco"):
        real = getattr(bench_train_steps, fn)
        monkeypatch.setattr(bench_train_steps, fn,
                            lambda *a, real=real, **k: seen.append(
                                (real, a, k)))
    for make in bench_train_steps.setups(bench_train_steps.WHICH, "cpu"):
        make()
    assert len(seen) == len(want)
    for (jfn, jargs, jkw), (real, pargs, pkw) in zip(want.values(), seen):
        assert real.__name__ == jfn.replace("bench_", "setup_")
        j = inspect.signature(ns[jfn]).bind(*jargs, **jkw)
        j.apply_defaults()
        p = inspect.signature(real).bind(*pargs, **pkw)
        p.apply_defaults()
        assert {k: p.arguments[k] for k in j.arguments} == j.arguments


def test_bench_train_steps_main_runs_small(monkeypatch, capsys):
    monkeypatch.setattr(
        bench_train_steps, "setups", lambda which, device: [
            functools.partial(_port_setup, w) for w in
            bench_train_steps.WHICH if w in which])
    res = bench_train_steps.main(["ft", "moco", "--device", "cpu"])
    assert sorted(res) == ["moco", "vit_small"]
    assert all(sorted(r) == ["ms_per_step", "per_sec"] for r in res.values())
    with pytest.raises(SystemExit):
        bench_train_steps.main(["nope", "--device", "cpu"])


# -------------------------------------------------------------- remat

@pytest.fixture(scope="module")
def jax_remat():
    """bench_remat's ``tx``, ``labels`` and, per setting, the step its
    loop builds (:30-36)."""
    ns = load("bench_remat.py", stmts=assigns("tx", "labels"), inject={
        "cfg": JCFG, "B": B, "steps": Proxy(
            jsteps, make_classifier_steps=functools.partial(
                jsteps.make_classifier_steps, **F32))})
    loop = next(n for n in parse("bench_remat.py").body
                if isinstance(n, ast.For))
    build = ast.Module(body=[loop.body[0]], type_ignores=[])
    made = {}
    for remat in (False, True):
        ns["remat"] = remat
        exec(compile(build, "bench_remat.py", "exec"), ns)
        made[remat] = ns["train_step"]
    return ns, made


def test_remat_steps_match_jax_and_each_other(jax_remat):
    ns, made = jax_remat
    params = _np(jvit.init(jax.random.PRNGKey(0), JCFG, num_classes=3))
    imgs = np.random.default_rng(2).standard_normal(
        (B, 32, 32, 3)).astype(np.float32)
    labels = np.asarray(ns["labels"])
    _, port_labels = bench_remat.inputs(PCFG, B, "cpu")
    np.testing.assert_array_equal(port_labels.numpy(), labels)
    start = checkpoint.vit_state_from_jax(_np(params), PCFG)
    got = {}
    for remat in (False, True):
        fresh = jax.tree.map(jnp.asarray, _np(params))  # the step donates
        p, _, jloss, _ = made[remat](fresh, ns["tx"].init(fresh),
                                     jnp.asarray(imgs), jnp.asarray(labels))
        model = vit.ViT(PCFG, 3)
        model.load_state_dict(start, strict=True)
        loss = bench_remat.make_step(model, remat, torch.float32)(
            torch.from_numpy(imgs), port_labels)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        hold(model, checkpoint.vit_state_from_jax(_np(p), PCFG), start,
             types.SimpleNamespace(name="sgd"), 0.01)
        got[remat] = (loss, model.state_dict())
    assert torch.equal(got[False][0], got[True][0])
    for k, v in got[False][1].items():
        assert torch.equal(v, got[True][1][k]), k


def test_remat_recomputes_the_blocks(monkeypatch):
    """Under ``remat`` each block runs through ``torch.utils.checkpoint``
    (its forward again in the backward); without, never."""
    calls = []
    real = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    imgs, labels = bench_remat.inputs(PCFG, 2, "cpu", torch.float32)
    for remat in (False, True):
        calls.clear()
        bench_remat.make_step(vit.ViT(PCFG, 3), remat, torch.float32)(
            imgs, labels)
        assert len(calls) == (PCFG.depth if remat else 0)


def test_bench_remat_main_runs_small(monkeypatch, capsys):
    monkeypatch.setattr(bench_remat, "run", functools.partial(
        bench_remat.run, iters=2, warmup=2, model=vit.ViT(PCFG, 3)))
    rows = bench_remat.main(["vit_small", "2", "reversed", "--device",
                             "cpu"])
    assert [r["remat"] for r in rows] == [True, False]
    assert all(sorted(r) == ["img_s", "ms_per_step", "remat",
                             "step_peak_mib"] for r in rows)
    assert rows[0]["step_peak_mib"] is None  # not read on the CPU
    assert "step peak above its start" in capsys.readouterr().out
