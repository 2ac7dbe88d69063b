"""A tiny benchmark beside the real one: the same files, harness and
reference, at sizes the CPU runs in seconds (the port's vit_test width)."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

DATA = Path(__file__).resolve().parents[1]
ROOT = DATA.parent

# the numbers' limits at this size; the bf16 plain path reads under a
# tenth of each at the seeds the tests use
TINY_LIMITS = {"t.serve": {"logit_max": 0.2, "batch_rms": 0.05},
               "t.train": {"logit_max": 0.2, "logit_rms": 0.05,
                           "grad_err": 0.6, "change_gap": 0.1,
                           "nonfinite_losses": 0}}


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    from perfbench import harness

    root = tmp_path_factory.mktemp("tiny")
    for d in ("configs", "traffic", "limits"):
        (root / d).mkdir()
    shutil.copytree(DATA / "metrics", root / "metrics")
    cfg = json.loads((DATA / "configs" / "mfvit_ca_s16.json").read_text())
    cfg.update(name="tiny", arch="vit_test", hidden_size=32,
               num_attention_heads=2, num_hidden_layers=2,
               intermediate_size=128, fusion_heads=2)
    (root / "configs" / "tiny.json").write_text(json.dumps(cfg))
    for name, src in (("tiny_serve", "serve224_b512"),
                      ("tiny_train", "fuse_ft224_b256")):
        t = json.loads((DATA / "traffic" / f"{src}.json").read_text())
        t.update(batch=8, img_size=32, trace_steps=2, ref_rows=4, warmup=1)
        (root / "traffic" / f"{name}.json").write_text(json.dumps(t))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"] = [
        {"name": "t.serve", "config": "tiny", "traffic": "tiny_serve",
         "chips": 1, "why": "tiny serving"},
        {"name": "t.train", "config": "tiny", "traffic": "tiny_train",
         "chips": 1, "why": "tiny training"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = (["t.train"] if any(".fuse" in w for w in
                                                 m["workloads"])
                              else ["t.serve"])
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    for cell, lim in TINY_LIMITS.items():
        (root / "limits" / f"{cell}.json").write_text(json.dumps(lim))
    return harness.Files(root / "BENCHMARK.json", root)
