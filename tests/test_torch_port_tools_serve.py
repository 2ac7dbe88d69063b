"""The serving tools of the port's ``tools/`` (``bench_latency``,
``profile_fwd``, ``bench_vitbase_int8``) on the CPU, where they run the
plain versions, against the JAX tools' own functions; every new tool's
imports and default device.

The JAX side is ``tools/bench_latency.py``, ``tools/profile_fwd.py`` and
``tools/bench_vitbase_int8.py`` as they are, read by
``_torch_tools_jax.load``: their imports, the functions they time, and
injected globals (JAX-initialised trees, the tiny config, the images, and
the JAX modules with ``compute_dtype=float32`` fixed). The port's models
take the same trees through the weight bridges. The config is vit_test's
(32 px, patch 16, depth 2, 2 heads) at width 48, so that the CA head's 3
heads (the tools' default) divide it.

Tolerances, as the model tests hold the same functions in fp32: the
request's decision logits and the five ablation variants within atol
1e-4 of JAX's (``test_torch_port_model.py``: the fused forward against
JAX, sums in another order), the stem sums within rtol 1e-5; the int8
tool's logits, bf16 and int8, within atol 1e-4 of JAX's with the
Pallas kernels in interpret mode (``test_torch_port_int8.py``'s bar for
the whole int8 ViT), its top-1 equal and its agreement the same."""
import ast
import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from mfvit_tpu.models import fusion as jfusion
from mfvit_tpu.nn import vit as jvit
from mfvit_tpu.ops import fused_attn as jfa
from mfvit_tpu.ops import fused_mlp as jfm
from mfvit_tpu_torch.exp import checkpoint
from mfvit_tpu_torch.models import fusion
from mfvit_tpu_torch.nn import vit
from mfvit_tpu_torch.tools import (aug_order_study, bench_latency,
                                   bench_remat, bench_train_loop,
                                   bench_train_steps, bench_vitbase_int8,
                                   card, profile_fwd, profile_moco)

from _torch_tools_jax import Proxy, assigns, load, nested_def

TINY = dict(img_size=32, patch=16, dim=48, depth=2, heads=2)
JCFG = jvit.ViTConfig("vit_test", **TINY)
PCFG = vit.ViTConfig("vit_test", **TINY)
F32 = dict(compute_dtype=jnp.float32)
B = 3
NEW_TOOLS = (bench_latency, profile_fwd, bench_train_steps, profile_moco,
             bench_vitbase_int8, bench_remat, bench_train_loop,
             aug_order_study)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_vit(jp):
    m = vit.ViT(PCFG, 3)
    m.load_state_dict(checkpoint.vit_state_from_jax(_np(jp), PCFG),
                      strict=True)
    return m.eval()


@pytest.fixture(scope="module")
def slice_():
    """JAX's three trees (a key split three ways, as the tools split
    theirs), the port's models on them, and numpy images."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    jc, je = (jvit.init(k, JCFG, num_classes=3) for k in (k1, k2))
    jf = jfusion.init(k3, num_classes=3, dim=JCFG.dim)
    fus = fusion.Fusion(3, PCFG.dim, 3)
    fus.load_state_dict(checkpoint.fusion_state_from_jax(_np(jf)),
                        strict=True)
    models = nn.ModuleDict({"cxr": _port_vit(jc), "enh": _port_vit(je),
                            "fus": fus.eval()})
    img = np.random.default_rng(1).standard_normal((B, 32, 32, 3)).astype(
        np.float32)
    return jc, je, jf, models, img


def test_latency_request_matches_jax(slice_):
    """``bench_latency``'s request, ``fused + lc + le``, against JAX's
    ``fwd`` (:34-37)."""
    jc, je, jf, models, img = slice_
    ns = load("bench_latency.py", inject={
        "cfg": JCFG, "fusion": Proxy(jfusion, fused_forward=functools.partial(
            jfusion.fused_forward, **F32))})
    fwd = nested_def("bench_latency.py", "main", "fwd", ns)
    want = np.asarray(fwd(jc, je, jf, jnp.asarray(img), jnp.asarray(img)))
    t = torch.from_numpy(img)
    got = bench_latency.serve_fn(torch.float32)(models, t, t)
    assert got.shape == (B, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.fixture(scope="module")
def jax_variants(slice_):
    """JAX's ``VARIANTS`` (:69-82) with its ``stem``, ``blocks`` and
    ``branch``: the kernels in interpret mode, fp32 throughout (the
    stem's bf16 cast through a ``jnp`` whose bfloat16 is float32)."""
    jc, je, jf, _, _ = slice_

    def interpret(op):
        return lambda *a: op(*a[:-1], True)  # the tool passes False

    ns = load("profile_fwd.py", defs={"stem", "blocks", "branch"},
              stmts=assigns("VARIANTS"), inject={
                  "B": B, "cfg": JCFG, "vp_c": jc, "vp_e": je, "fp": jf,
                  "jnp": Proxy(jnp, bfloat16=jnp.float32),
                  "vit": Proxy(jvit, apply=functools.partial(jvit.apply,
                                                             **F32)),
                  "fusion": Proxy(jfusion, fused_forward=functools.partial(
                      jfusion.fused_forward, **F32)),
                  "fused_attention_block": interpret(
                      jfa.fused_attention_block),
                  "fused_mlp_block": interpret(jfm.fused_mlp_block)})
    return ns["VARIANTS"]


@pytest.mark.parametrize("name", profile_fwd.NAMES)
def test_profile_fwd_variant_matches_jax(slice_, jax_variants, name):
    _, _, _, models, img = slice_
    want = np.asarray(jax_variants[name]()(jnp.asarray(img),
                                           jnp.asarray(img)))
    t = torch.from_numpy(img)
    got = profile_fwd.variants(models, PCFG, "cpu", torch.float32)[name](t, t)
    assert got.shape == want.shape
    if name == "stem_only":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_profile_fwd_nofinal_differs_from_branches(slice_):
    """The ablation cuts something: without the final LayerNorm the
    logits move."""
    _, _, _, models, img = slice_
    t = torch.from_numpy(img)
    fns = profile_fwd.variants(models, PCFG, "cpu", torch.float32)
    assert not torch.allclose(fns["nofinal"](t, t), fns["branches"](t, t),
                              atol=1e-4)


def test_vitbase_int8_forms_match_jax(slice_):
    """The tool's two forms and their agreement against JAX's ``run``
    (:19-30) on the same tree and images, with JAX's quantizer."""
    jc, _, _, _, img = slice_
    ns = load("bench_vitbase_int8.py", defs={"run"}, inject={
        "cfg": JCFG, "img": jnp.asarray(img), "B": B,
        "vit": Proxy(jvit, apply=functools.partial(
            jvit.apply, attn_backend="pallas_interpret", **F32))})
    a = ns["run"](jc, "bf16")
    b = ns["run"](ns["quantize_vit_for_serving"](jc), "int8")
    model = _port_vit(jc)
    t = torch.from_numpy(img)
    _, pa = bench_vitbase_int8.time_form(model, t, "fp32", 1, 1,
                                         torch.float32)
    vit.quantize_vit_for_serving(model)
    _, pb = bench_vitbase_int8.time_form(model, t, "int8", 1, 1,
                                         torch.float32)
    np.testing.assert_allclose(pa.numpy(), a, atol=1e-4)
    np.testing.assert_allclose(pb.numpy(), b, atol=1e-4)
    assert pa.argmax(-1).tolist() == a.argmax(-1).tolist()
    assert pb.argmax(-1).tolist() == b.argmax(-1).tolist()
    agree, drift = bench_vitbase_int8.agreement(pa, pb)
    assert agree == float((a.argmax(-1) == b.argmax(-1)).mean())
    np.testing.assert_allclose(drift, np.abs(a - b).max(), atol=1e-4)


# ------------------------------------------------------------ the mains

def _tiny(monkeypatch, tool, **kw):
    monkeypatch.setattr(tool, "run", functools.partial(tool.run, **kw))


def test_bench_latency_main_runs_small(monkeypatch, capsys):
    _tiny(monkeypatch, bench_latency, batches=(1, 2), requests=2, warmup=1,
          cfg=PCFG, models=bench_latency.make_models(PCFG, "cpu"))
    rows = bench_latency.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == card.CPU_NOTE
    assert [sorted(r) for r in rows] == [["batch", "median_ms", "p99_ms"]] * 2
    assert [r["batch"] for r in rows] == [1, 2]
    assert json.loads(out[-1]) == rows


def test_profile_fwd_main_runs_small(monkeypatch, capsys):
    _tiny(monkeypatch, profile_fwd, iters=2, warmup=1, cfg=PCFG,
          models=bench_latency.make_models(PCFG, "cpu"))
    res = profile_fwd.main(["2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert tuple(res) == profile_fwd.NAMES
    assert all(v > 0 for v in res.values())
    for line in ("fusion head :", "final LN x2 :", "stems x2    :",
                 "one branch  :"):
        assert line in out


def test_vitbase_int8_main_runs_small(monkeypatch, capsys):
    _tiny(monkeypatch, bench_vitbase_int8, batch=2, iters=1, warmup=1,
          model=bench_vitbase_int8.make_model("cpu", PCFG))
    res = bench_vitbase_int8.main(["--device", "cpu"])
    assert "top-1 agreement: " in capsys.readouterr().out
    assert 0.0 <= res["top1_agreement"] <= 1.0
    assert res["logits_int8"].shape == (2, 3)


# ------------------------------------------------- what every tool keeps

FORBIDDEN = ("jax", "mfvit_tpu", "tools")


def _imports(module) -> set:
    tree = ast.parse(Path(module.__file__).read_text())
    out = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            out |= {a.name for a in n.names}
        elif isinstance(n, ast.ImportFrom):
            out.add("." * n.level + (n.module or ""))
    return out


@pytest.mark.parametrize("tool", NEW_TOOLS + (card,),
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_the_tools_import_no_jax(tool):
    """No import of ``jax``, the JAX package or the JAX harness's tools,
    at any depth of the module."""
    for name in _imports(tool):
        assert name.split(".")[0] not in FORBIDDEN, (tool.__name__, name)
        assert not name.startswith("."), (tool.__name__, name)


@pytest.mark.parametrize("tool", NEW_TOOLS,
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_the_tools_default_to_the_card(tool):
    """``--device`` defaults to cuda, which raises without CUDA before
    any work."""
    assert tool.build_parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main([])


def test_card_line_is_silent_on_the_cpu(capsys):
    assert card.describe("cpu") is None
    assert capsys.readouterr().out == ""
