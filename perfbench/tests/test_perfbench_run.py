"""A run's result line, at the tiny size on the CPU: exactly the keys the
contract asks for (``breakdown`` only when traced), the numbers compared
last; and the command refuses, printing no result, without a card."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("cell", ["t.serve", "t.train"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(tiny, cell, trace):
    r = harness.run_cell(cell, 2 ** 31 + 11, 0.3, trace,
                         device=torch.device("cpu"), files=tiny)
    err, line = harness.report(r)
    out = json.loads(line)
    want = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out) == want + (["breakdown"] if trace else []) + ["checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        out["device"])
    spec = tiny.spec()
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        # no device time on the CPU: the readers find nothing to read
        assert out["metrics"] == {}
    else:
        names = {m["name"] for m in spec["end_to_end"]
                 if cell in m.get("workloads", [cell])}
        assert set(out["metrics"]) == names
        assert all(v["value"] > 0 for v in out["metrics"].values())
    assert [e.split()[2] for e in err[1:]] == list(out["checks"])


def test_command_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                        "ca_s16.serve.b512", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "needs 1 CUDA device" in p.stderr


def test_command_fails_with_only_the_benchmark(tmp_path):
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                        "ca_s16.serve.b512", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
