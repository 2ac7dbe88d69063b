"""``ops.span``, the port's hot path named on the profiler's timeline, and
``ops.build.BUILD``, what loading the kernel library cost.

With no profiler recording, a span is one shared null context and the
program calls nothing in the profiler. Under a CPU ``torch.profiler`` the
training steps and the served forward (the CLIs' test architecture,
``-a vit_test``, on the plain path) record their spans in the order and
nesting of ``train/steps.py``'s docstring, one ``mfv.step`` a step; and a
step's loss, logits and updated parameters are bit-identical with the
profiler on and off.
"""
from __future__ import annotations

import argparse
import ctypes
import types
from pathlib import Path

import pytest
import torch
from torch import nn
from torch.profiler import ProfilerActivity, profile

from mfvit_tpu_torch import ops
from mfvit_tpu_torch.cli import common
from mfvit_tpu_torch.models import fusion, gpt_fusion
from mfvit_tpu_torch.nn import vit
from mfvit_tpu_torch.ops import build
from mfvit_tpu_torch.train import optim, steps

IMG, B, K = 32, 4, 3
STEP = ("mfv.step", [("mfv.forward", []), ("mfv.loss", []),
                     ("mfv.backward", []), ("mfv.optim", [])])


def _models(head: str = "ca", seed: int = 0) -> nn.ModuleDict:
    cfg = common.get_vit_arch(argparse.Namespace(
        arch="vit_test", img_size=IMG, crop=None, in_chans=3))
    gen = torch.Generator().manual_seed(seed)
    fus = (fusion.Fusion(K, cfg.dim, 2, generator=gen) if head == "ca"
           else gpt_fusion.GPTFusion(common.gpt_fusion_cfg(
               argparse.Namespace(gpt_layers=1), cfg), K, generator=gen))
    return nn.ModuleDict({"cxr": vit.ViT(cfg, K, generator=gen),
                          "enh": vit.ViT(cfg, K, generator=gen),
                          "fus": fus})


def _batch(seed: int = 1) -> tuple:
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(B, IMG, IMG, 3, generator=gen),
            torch.randn(B, IMG, IMG, 3, generator=gen),
            torch.randint(0, K, (B,), generator=gen))


def _fusion_step(models, **kw):
    opt = optim.build_optimizer("adam", models.named_parameters(), 1e-3)
    train_step, _ = steps.make_fusion_steps(compute_dtype=torch.float32,
                                            **kw)
    return lambda: train_step(models, opt, *_batch())


def _tree(prof) -> list:
    """The ``mfv.*`` events of ``prof`` as nested (name, children) lists,
    each level in the order the spans opened."""
    evs = sorted((e for e in prof.events() if e.name.startswith("mfv.")),
                 key=lambda e: (e.time_range.start, -e.time_range.end))
    root, stack = [], []
    for e in evs:
        while stack and stack[-1][0].time_range.end < e.time_range.end:
            stack.pop()
        node = (e, [])
        (stack[-1][1] if stack else root).append(node)
        stack.append(node)

    def names(nodes):
        return [(e.name, names(kids)) for e, kids in nodes]

    return names(root)


def _traced(fn) -> tuple:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _tree(prof)


def test_span_is_the_shared_null_context_with_no_profiler():
    assert not torch.autograd._profiler_enabled()
    assert ops.span("mfv.step") is ops.span("mfv.forward") is ops._NO_SPAN
    with ops.span("mfv.step"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert ops.span("mfv.step") is not ops._NO_SPAN


def test_no_profiler_call_while_no_profiler_records(monkeypatch):
    """A training step and a served forward open no profiler event of
    their own unless a profiler records; under one, one a span, of the
    operators' kind (no user annotation, no device-side range)."""
    made = []
    real = torch._C._profiler._RecordFunctionFast

    def counted(name, *a):
        made.append(name)
        return real(name, *a)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counted)
    step = _fusion_step(_models())
    serve = steps.make_fusion_forward(compute_dtype=torch.float32)
    models = _models()
    step()
    serve(models, *_batch()[:2])
    assert made == []
    _traced(step)
    assert made == [s for s, _ in [STEP] + STEP[1]]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
    assert not [e.name for e in prof.events()
                if e.name.startswith("mfv.") and e.is_user_annotation]


def test_fusion_train_step_records_the_span_tree():
    step = _fusion_step(_models())
    _, tree = _traced(lambda: [step() for _ in range(2)])
    assert tree == [STEP, STEP]


@pytest.mark.parametrize("head, frozen", [("ca", True), ("gpt", False),
                                          ("gpt", True)])
def test_generic_route_records_the_branches(head, frozen):
    """The per-branch route (a frozen backbone or the GPT head) records
    the same tree as the fused one: the branches and the head run inside
    ``mfv.forward``, with no span of their own."""
    step = _fusion_step(_models(head), fusion_arch=head,
                        freeze_backbones=frozen)
    _, tree = _traced(step)
    assert tree == [STEP]


def test_classifier_train_step_records_the_span_tree():
    model = vit.ViT(common.get_vit_arch(argparse.Namespace(
        arch="vit_test", img_size=IMG, crop=None, in_chans=3)), K)
    opt = optim.build_optimizer("adam", model.named_parameters(), 1e-3)
    train_step, _ = steps.make_classifier_steps(compute_dtype=torch.float32)
    xc, _, y = _batch()
    _, tree = _traced(lambda: train_step(model, opt, xc, y))
    assert tree == [STEP]


@pytest.mark.parametrize("head", ["ca", "gpt"])
def test_served_forward_records_serve_and_its_children(head):
    models = _models(head)
    serve = steps.make_fusion_forward(compute_dtype=torch.float32,
                                      fusion_arch=head)
    xc, xe, _ = _batch()
    _, tree = _traced(lambda: [serve(models, xc, xe) for _ in range(3)])
    assert tree == [("mfv.serve", [])] * 3      # no span below it


def test_step_is_bit_identical_with_spans_on_and_off():
    runs = []
    for traced in (False, True):
        models = _models(seed=5)
        step = _fusion_step(models)
        if traced:
            (loss, out), tree = _traced(step)
            assert tree and tree[0][0] == "mfv.step"
        else:
            loss, out = step()
        runs.append((loss, out, [p.detach().clone()
                                 for p in models.parameters()]))
    (l0, o0, p0), (l1, o1, p1) = runs
    assert torch.equal(l0, l1) and torch.equal(o0, o1)
    assert len(p0) == len(p1) and all(map(torch.equal, p0, p1))


def test_library_load_is_counted_without_a_build(monkeypatch):
    """``lib()`` on a library already built: ``built`` stays 0, and the
    seconds of ``build()`` (a stub here) and of the load are kept."""
    bound = []

    class FakeLib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            bound.append(name)
            return fn

    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "BUILD",
                        {"built": 0, "build_s": 0.0, "load_s": 0.0})
    monkeypatch.setattr(build, "build", lambda: Path("/nonexistent/lib.so"))
    monkeypatch.setattr(ctypes, "CDLL", lambda path: FakeLib())
    got = build.lib()
    assert isinstance(got, FakeLib) and build.lib() is got
    assert set(build.SIGNATURES) <= set(bound)
    assert build.BUILD["built"] == 0
    assert build.BUILD["build_s"] >= 0.0 and build.BUILD["load_s"] > 0.0
