"""Runs one cell of ``BENCHMARK.json``: everything is found by name.

- the cell (``workloads``) names its configuration and traffic mix;
- ``configs/<config>.json`` holds the configuration's sizes and names its
  plain reference, ``reference/<reference>.py``;
- ``traffic/<traffic>.json`` holds the mix's parameters and names its
  step kind, ``steps/<step>.py``, whose ``Session`` builds the system
  under test, warms it up, runs the window and compares;
- ``limits/<cell>.json`` holds the limit of each number compared (the
  step kind's other numbers are printed, not compared); ``failed``
  counts the step kind's units (pairs, steps) that ``attempted`` counts;
- each per-layer metric of ``BENCHMARK.json`` whose ``workloads`` list the
  cell is read by ``metrics/<metric>.py`` from the traced slice.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mfvit_tpu")


class Files:
    """Where a run finds the benchmark and its data files."""

    def __init__(self, bench: Path | None = None, data: Path = HERE):
        self.bench = bench or data.parent / "BENCHMARK.json"
        self.data = data

    def spec(self) -> dict:
        return json.loads(self.bench.read_text())

    def json(self, kind: str, name: str) -> dict:
        return json.loads((self.data / kind / f"{name}.json").read_text())

    def metric(self, name: str):
        path = self.data / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"perfbench_metric_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def cell_of(spec: dict, workload: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def forbidden_modules() -> list:
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    """``name, power.limit`` of the card, as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        return out[0] if out else "nvidia-smi gave nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device, files: Files = None, started: float = None) -> dict:
    """One run of ``workload``; returns the result line as a dict, with
    the numbers compared last under ``checks``. ``started`` is the
    ``time.perf_counter()`` reading of the process's start; set-up runs
    from there to the window's start."""
    files = files or Files()
    started = time.perf_counter() if started is None else started
    spec = files.spec()
    cell = cell_of(spec, workload)
    config = files.json("configs", cell["config"])
    traffic = files.json("traffic", cell["traffic"])
    limits = files.json("limits", workload)
    reference = importlib.import_module(
        f"perfbench.reference.{config['reference']}")
    step = importlib.import_module(f"perfbench.steps.{traffic['step']}")

    before = time.perf_counter() - started
    sess = step.Session(config, traffic, seed, device, reference)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - started
    setup_parts = {"start to session": before, **sess.marks}
    e2e = sess.window(seconds)
    metrics, device_info, breakdown = {}, {}, None
    if trace:
        from perfbench import trace as trace_mod
        reading = trace_mod.traced(sess.trace_slice, config, traffic,
                                   e2e[sess.RATE])
        for m in spec["per_layer"]:
            if workload not in m.get("workloads", [workload]):
                continue
            got = files.metric(m["name"]).read(reading)
            if got is not None:
                value, by = got
                metrics[m["name"]] = {"value": value, "unit": m["unit"],
                                      "bound_by": by}
        device_info = {"busy_s": reading.busy_s,
                       "window_s": reading.window_s}
        breakdown = {"device_ops": reading.device_ops,
                     "idle_gaps": reading.idle_gaps}
    else:
        e2e["setup_s"] = setup_s
        units = {m["name"]: m["unit"] for m in spec["end_to_end"]}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in e2e.items()
                   if k in units}
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    nums, failed, notes = sess.check(limits)
    checks = {k: {"value": nums[k], "limit": limits[k]} for k in limits}
    notes = dict(notes, not_compared={k: v for k, v in nums.items()
                                      if k not in limits})
    bad = [k for k, c in checks.items()
           if not (math.isfinite(c["value"]) and c["value"] <= c["limit"])]
    result = {"correct": not bad, "attempted": sess.attempted,
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda"
                         else device.type,
                         "kind": (torch.cuda.get_device_name(device)
                                  if device.type == "cuda" else "cpu"),
                         "count": int(cell["chips"]),
                         "memory_peak_bytes": int(peak), **device_info}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    notes = dict(notes, setup_s=setup_parts)
    if trace:
        notes = dict(notes, trace_cost=reading.cost(),
                     trace_op_s=reading.op_s,
                     trace_op_calls={k: reading.op_calls[k]
                                     for k in reading.op_s})
    result["notes"] = notes
    result["checks"] = checks
    return result


def main(args, started: float) -> int:
    """The command line's run: refuses without the cards the cell asks
    for, prints the numbers compared last on standard error, and the
    result as the last line of standard output."""
    files = Files()
    cell = cell_of(files.spec(), args.workload)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), device=torch.device("cuda", 0),
                      started=started)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    card = card_line()     # after the run, so that set-up does not pay it
    result["device"]["nvidia_smi"] = card
    err, line = report(result)
    err.insert(0, f"perfbench: {card}")
    print("\n".join(err), file=sys.stderr, flush=True)
    print(line, flush=True)
    return 0


def report(result: dict) -> tuple:
    """(lines for standard error, ending with each number compared beside
    its limit; the result's JSON line, ``checks`` its last key)."""
    result = dict(result)
    notes = result.pop("notes")
    checks = result.pop("checks")
    result["checks"] = checks
    err = [f"perfbench: notes {json.dumps(notes)}"]
    err += [f"perfbench: check {k} {c['value']!r} limit {c['limit']!r}"
            for k, c in checks.items()]
    return err, json.dumps(result)
