"""A configuration, traffic mix or per-layer metric dropped into its
folder is found by its name, with no edit to the harness."""
import json

from perfbench import trace


def test_new_files_are_found_by_name(tiny):
    cfg = tiny.json("configs", "tiny")
    (tiny.data / "configs" / "tiny_wide.json").write_text(
        json.dumps(dict(cfg, name="tiny_wide", hidden_size=64)))
    tr = tiny.json("traffic", "tiny_serve")
    (tiny.data / "traffic" / "tiny_b4.json").write_text(
        json.dumps(dict(tr, batch=4)))
    (tiny.data / "metrics" / "dropped.metric.py").write_text(
        "def read(r):\n    return r.steps * 1.0, None\n")
    assert tiny.json("configs", "tiny_wide")["hidden_size"] == 64
    assert tiny.json("traffic", "tiny_b4")["batch"] == 4
    r = trace.Reading(1.0, 0.5, 0.5, {}, {}, 7, 28, 56.0, cfg, tr, [],
                      [])
    assert tiny.metric("dropped.metric").read(r) == (7.0, None)


def test_every_metric_file_reads_a_trace(tiny):
    """Each real reader takes a reading of its cell kind; with no device
    time it returns nothing."""
    spec = tiny.spec()
    for kind, traffic in (("t.serve", "tiny_serve"),
                          ("t.train", "tiny_train")):
        cfg, tr = tiny.json("configs", "tiny"), tiny.json("traffic", traffic)
        ops = ("_AttentionBlock", "_MlpBlock", "_MlpBlockFinalLN",
               "_FusionCls", "_AttentionBlockBackward", "_MlpBlockBackward",
               "_MlpBlockFinalLNBackward", "aten::mm")
        busy = trace.Reading(1.0, 0.9, 0.95, {k: 0.1 for k in ops},
                             {k: 4 for k in ops}, 2, 16, 20.0, cfg, tr,
                             [], [])
        idle = trace.Reading(1.0, 0.0, 0.0, {}, {}, 2, 16, 20.0, cfg, tr,
                             [], [])
        for m in spec["per_layer"]:
            if kind not in m["workloads"]:
                continue
            reader = tiny.metric(m["name"])
            value, _ = reader.read(busy)
            assert 0 < value < 100, (m["name"], value)
            assert reader.read(idle) is None
