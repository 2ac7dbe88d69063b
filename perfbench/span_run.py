"""One traced run of a cell through the harness, with the port's spans
reduced (``spans.reduce``) over the same profiler window and read by the
span metrics beside the trace's own readings:

    python3 -m perfbench.span_run --workload <cell> --seed <n> \\
        --seconds <s> [--out FILE]

``trace.traced`` keeps its profiler to itself, so this run wraps it: the
profiler object is kept when its window closes, and the port's launches
(``ops.launch_counts()``) are read before and after the slice. This
module goes once ``trace.traced`` calls ``spans.extend`` itself and the
harness reads the span metrics: it is a second way to run a cell, kept
only until then. Prints the
harness's result line with, under ``spans``, the span metrics of the
cell's kind (``.serve`` or ``.train``) and the notes
``trace_idle_spans``, ``port_launches_per_step``, ``library_build`` and
``library_load`` (``ops.build.BUILD``), the spans' calls, host and device
seconds, and the profiler's events by kind.
"""
from __future__ import annotations

import collections
import json
import statistics
import sys
import time
from pathlib import Path
from unittest import mock

# the span metrics (``metrics/<name>.py``) and their units
METRICS = {"fwd_eager.device_pct.train": "%",
           "bwd_eager.device_pct.train": "%", "optim.device_pct.train": "%",
           "host.enqueue_ms.serve": "ms", "host.enqueue_ms.train": "ms",
           "kernels.step.serve": "kernels", "kernels.step.train": "kernels"}


def _kinds(prof) -> dict:
    """The profiler's events counted by kind: operators and spans (no
    linked correlation), runtime calls and device activities (linked) by
    name, kernels together."""
    from perfbench import spans

    out = collections.Counter()
    for e in prof.profiler.kineto_results.events():
        name, linked = e.name(), e.linked_correlation_id() > 0
        dev = e.device_type().name.lower()
        if dev == "cpu" and not linked:
            key = "cpu:span" if name.startswith(spans.PREFIX) else "cpu:op"
        elif dev != "cpu" and linked and not name.startswith(
                ("Memcpy", "Memset")):
            key = f"{dev}:kernel"
        else:
            key = f"{dev}:{'linked' if linked else 'unlinked'}:{name[:48]}"
        out[key] += 1
    return dict(out.most_common(40))


def run(workload: str, seed: int, seconds: float, device,
        files=None) -> dict:
    import torch

    from mfvit_tpu_torch import ops
    from mfvit_tpu_torch.ops import build
    from perfbench import harness, spans, trace

    files = files or harness.Files()
    kept = {}
    real_traced, real_profile = trace.traced, torch.profiler.profile

    class Kept(real_profile):
        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            kept["prof"] = self
            return out

    def traced(run_slice, *args):
        before = ops.launch_counts()
        reading = real_traced(run_slice, *args)
        after = ops.launch_counts()
        kept["reading"] = spans.extend(reading, kept["prof"], {
            k: after[k] - before[k] for k in after if after[k] > before[k]})
        return reading

    with mock.patch.object(torch.profiler, "profile", Kept), \
            mock.patch.object(trace, "traced", traced):
        result = harness.run_cell(workload, seed, seconds, True,
                                  device=device, files=files)
    r = kept["reading"]
    kind = ("train" if files.json("traffic", harness.cell_of(
        files.spec(), workload)["traffic"])["step"] == "fusion_train"
        else "serve")
    metrics = {}
    for name, unit in METRICS.items():
        got = (files.metric(name).read(r) if name.endswith(kind)
               else None)
        if got is not None:
            metrics[name] = {"value": got[0], "unit": unit}
    lib = getattr(build, "BUILD", {})
    result["spans"] = {
        "metrics": metrics,
        "notes": {
            "trace_idle_spans": r.idle_spans,
            "port_launches_per_step": {
                "total": sum(r.port_launches.values()) / r.steps,
                **{k: v / r.steps for k, v in r.port_launches.items()}},
            "library_build": {k: lib.get(k) for k in ("built", "build_s")},
            "library_load": lib.get("load_s"),
            "kernels": r.kernels, "steps": r.steps,
            "span_calls": r.span_calls,
            "span_host_ms_median": {k: 1e3 * statistics.median(v)
                                    for k, v in r.span_host_s.items()},
            "span_device_s": r.span_s, "span_total_device_s": r.span_total_s,
            "all_device_s": sum(r.op_s.values()),
            "events": _kinds(kept["prof"])}}
    return result


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", type=Path)
    args = p.parse_args(argv)
    from perfbench import run as run_mod
    run_mod._caches()
    import torch
    torch.set_num_threads(2)
    if not torch.cuda.is_available():
        print("perfbench.span_run: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    result = run(args.workload, args.seed, args.seconds,
                 torch.device("cuda", 0))
    result["spans"]["notes"]["run_s"] = time.perf_counter() - t0
    line = json.dumps(result)
    if args.out:
        with args.out.open("a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
