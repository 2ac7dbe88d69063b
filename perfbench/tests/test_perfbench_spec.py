"""BENCHMARK.json keeps to the contract's names, units and keys, and
every file it names exists."""
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
               and not p.startswith("/") and ".." not in p
               for p in SPEC["paths"])


def test_names_units_and_entry_keys():
    names = []
    for section, keys in KEYS.items():
        for e in SPEC[section]:
            extra = {"workloads"} if section in ("end_to_end",
                                                 "per_layer") else set()
            assert keys <= set(e) <= keys | extra, e
            assert NAME.match(e["name"]), e["name"]
            names.append((section, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e and section in ("configs", "workloads",
                                          "per_layer"):
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for c in SPEC["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    metrics = [e["name"] for s in ("end_to_end", "per_layer")
               for e in SPEC[s]]
    assert len(set(metrics)) == len(metrics)


def test_metrics_sources_bounds_and_cells():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        assert set(m["workloads"]) <= set(
            e2e[m["moves"]].get("workloads", cells))
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        reports = [m for m in SPEC["end_to_end"]
                   if cell in m.get("workloads", cells)]
        assert len(reports) >= 2
        assert any(cell in m["workloads"] for m in SPEC["per_layer"])


def test_every_named_file_exists():
    data = ROOT / "perfbench"
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == \
            c["reduced"]
    for w in SPEC["workloads"]:
        assert (data / "traffic" / f"{w['traffic']}.json").is_file()
        assert (data / "limits" / f"{w['name']}.json").is_file()
    for m in SPEC["per_layer"]:
        assert (data / "metrics" / f"{m['name']}.py").is_file()
